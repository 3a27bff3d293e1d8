"""Evaluator façade (reference python/paddle/fluid/evaluator.py); a copy
of ``paddle_tpu/evaluator.py``.

The reference deprecated this module in favor of fluid.metrics; its
classes are kept for script parity. ChunkEvaluator and EditDistance are
the host-side metric accumulators of ``metrics``. DetectionMAP
appends the ``detection_map`` op to the current program (evaluator.py:257
semantics) and averages the per-batch mAP host-side via update()."""

import numpy as np

from .metrics import ChunkEvaluator, EditDistance  # noqa: F401 (parity)

__all__ = ["ChunkEvaluator", "EditDistance", "DetectionMAP"]


class DetectionMAP:
    """Builds the mAP computation over detection results.

    Args mirror the reference (input [M, 6] det results, gt label/box);
    `self.metrics` holds the per-batch mAP Variable to fetch, and
    update(map_value)/eval() accumulate the running mean across batches.
    """

    def __init__(self, input, gt_label, gt_box=None, gt_difficult=None,
                 class_num=None, background_label=0, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version="11point"):
        from . import layers
        from .layers.layer_helper import LayerHelper

        # both AP versions are implemented ("11point" interpolated and
        # "integral" recall-delta); evaluate_difficult=False excludes
        # difficult ground truth VOC-style via the gt_difficult column;
        # class_num > 0 gives true per-class-averaged mAP (else AP is
        # class-pooled — see ops/detection_ops.py _detection_map)
        if ap_version not in ("11point", "integral"):
            raise ValueError(
                "DetectionMAP: ap_version must be '11point' or "
                "'integral', got %r" % (ap_version,))
        if not evaluate_difficult and gt_difficult is None:
            # same contract as layers.detection_map: excluding difficult
            # GT without the difficult flags would silently count them
            raise ValueError(
                "DetectionMAP: evaluate_difficult=False needs the "
                "gt_difficult ground-truth flag input")

        helper = LayerHelper("detection_map_eval")
        label = gt_label if gt_box is None else \
            layers.concat([gt_label, gt_box], axis=1)
        inputs = {"DetectRes": [input], "Label": [label]}
        if not evaluate_difficult and gt_difficult is not None:
            inputs["Difficult"] = [gt_difficult]
        m = helper.create_variable_for_type_inference("float32", shape=(1,))
        acc = helper.create_variable_for_type_inference("int64", shape=(1,))
        helper.append_op(
            type="detection_map",
            inputs=inputs,
            outputs={"MAP": [m], "AccumPosCount": [acc]},
            attrs={"overlap_threshold": overlap_threshold,
                   "ap_version": ap_version,
                   "class_num": int(class_num or 0),
                   "background_label": background_label,
                   "evaluate_difficult": evaluate_difficult})
        self.metrics = [m]
        self.reset()

    def reset(self, executor=None, reset_program=None):
        self._sum = 0.0
        self._n = 0

    def update(self, map_value):
        self._sum += float(np.asarray(map_value).reshape(-1)[0])
        self._n += 1

    def eval(self, executor=None, eval_program=None):
        if not self._n:
            raise ValueError("eval() before any update(); no batches seen")
        return np.array([self._sum / self._n], np.float32)
