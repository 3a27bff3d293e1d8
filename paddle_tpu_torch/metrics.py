"""Python-side metric accumulators (a copy of ``paddle_tpu/metrics.py``:
numpy only).

Reference parity: python/paddle/fluid/metrics.py (MetricBase, CompositeMetric,
Accuracy, ChunkEvaluator, EditDistance, DetectionMAP, Auc) — host-side
accumulation over fetched numpy values.
"""

import numpy as np

__all__ = ["MetricBase", "CompositeMetric", "Accuracy", "Precision", "Recall",
           "ChunkEvaluator", "EditDistance", "Auc"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for k, v in self.__dict__.items():
            if k.startswith("_"):
                continue
            if isinstance(v, (int, float)):
                setattr(self, k, 0 if isinstance(v, int) else 0.0)
            elif isinstance(v, (list, tuple)):
                setattr(self, k, [])
            elif isinstance(v, dict):
                setattr(self, k, {})

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        if not isinstance(metric, MetricBase):
            raise TypeError("metric must be a MetricBase")
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(value) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no data updated into Accuracy")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype(np.int64).reshape(-1)
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class ChunkEvaluator(MetricBase):
    """Accumulates chunk_eval op outputs → (precision, recall, f1)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(num_infer_chunks)
        self.num_label_chunks += int(num_label_chunks)
        self.num_correct_chunks += int(num_correct_chunks)

    def eval(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances, np.float64)
        self.instance_error += int(np.sum(distances != 0))
        self.total_distance += float(np.sum(distances))
        self.seq_num += int(seq_num)

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no data updated into EditDistance")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=200):
        super().__init__(name)
        self._curve = curve
        self._num_thresholds = num_thresholds
        self.tp_list = np.zeros((num_thresholds,))
        self.fn_list = np.zeros((num_thresholds,))
        self.tn_list = np.zeros((num_thresholds,))
        self.fp_list = np.zeros((num_thresholds,))

    def reset(self):
        n = self._num_thresholds
        self.tp_list = np.zeros((n,))
        self.fn_list = np.zeros((n,))
        self.tn_list = np.zeros((n,))
        self.fp_list = np.zeros((n,))

    def update(self, preds, labels):
        preds = np.asarray(preds)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        kepsilon = 1e-7
        thresholds = [(i + 1) * 1.0 / (self._num_thresholds - 1)
                      for i in range(self._num_thresholds - 2)]
        thresholds = [0.0 - kepsilon] + thresholds + [1.0 + kepsilon]
        for i, thresh in enumerate(thresholds):
            pos = preds >= thresh
            self.tp_list[i] += np.sum(pos & (labels > 0))
            self.fp_list[i] += np.sum(pos & (labels <= 0))
            self.fn_list[i] += np.sum(~pos & (labels > 0))
            self.tn_list[i] += np.sum(~pos & (labels <= 0))

    def eval(self):
        epsilon = 1e-6
        tpr = self.tp_list / (self.tp_list + self.fn_list + epsilon)
        fpr = self.fp_list / (self.fp_list + self.tn_list + epsilon)
        # trapezoid over decreasing thresholds
        auc = 0.0
        for i in range(self._num_thresholds - 1):
            auc += (fpr[i] - fpr[i + 1]) * (tpr[i] + tpr[i + 1]) / 2.0
        return abs(float(auc))
