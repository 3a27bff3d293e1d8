"""The op library's sweep on the card: one case (or a few) for each op
type the dense op library and the SelectedRows host ops added
(``run(device)``), for each op type the LoD, sequence, RNN and
control-flow slice added (``run(device, part="lod")``), for each
CRF, CTC and detection op type (``run(device, part="detection")``), and
for each op type of the parallel tier without a mesh (``run(device,
part="parallel")``: the collectives as identities, ``moe_ffn`` and
``pipeline_stack`` on their one-device paths), and for the two fused
ops (``run(device, part="fused")``),
each a one-op Program (or, for control flow, a small Program built by
the layers) run
through ``Executor(CUDAPlace(0))`` and through ``Executor(CPUPlace())``
on the same inputs, the card's outputs held against the CPU's at the
CPU sweep's tolerances (forward rtol 1e-5 / atol 1e-6; the gradients of
``calc_gradient`` where tests/test_torch_ops_sweep*.py and
tests/test_torch_sequence_ops.py check one, rtol 1e-4 / atol 1e-5). A
LoD input is a ``Seq`` (rows and their lengths), fed as a LoDTensor.

The random ops (``uniform_random_batch_size_like``,
``gaussian_random_batch_size_like``, ``nce``) draw from each device's
own generator: they are held by shape, dtype and range, and ``nce`` by
its Cost recomputed from its own SampleLabels. ``print`` and ``range``
read the host and ``delete_var`` only drops a name: they run, and their
outputs are held as the others'.

Used by ``chip_smoke.py`` (phases 11 (d), 14 (c), 15 (c), 16 (d) and
19 (a));
``run``
returns the op types held. On the CPU against itself it is the tests'
check that every case runs; tests/test_torch_sequence_ops.py holds
``lod_cases``, tests/test_torch_crf_ctc.py and
tests/test_torch_detection.py ``detection_cases`` against the JAX
package.
"""

import numpy as np

FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _r(seed, *shape, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _i(*vals):
    return np.array(vals, np.int32)


class Seq:
    """A LoD input of a case: ``data`` rows and the sequence
    ``lengths``."""

    def __init__(self, data, lengths):
        self.data = data
        self.lengths = list(lengths)


_UNARY = [
    ("logsigmoid", {}, (-2, 2), True),
    ("exp", {}, (-2, 2), True), ("tanh", {}, (-2, 2), True),
    ("tanh_shrink", {}, (-2, 2), True), ("rsqrt", {}, (0.5, 4), True),
    ("abs", {}, (0.3, 2), True), ("ceil", {}, (-2, 2), False),
    ("floor", {}, (-2, 2), False), ("cos", {}, (-2, 2), True),
    ("sin", {}, (-2, 2), True), ("round", {}, (-2, 2), False),
    ("reciprocal", {}, (0.5, 3), True), ("log", {}, (0.5, 4), True),
    ("softplus", {}, (-2, 2), True), ("softsign", {}, (0.2, 2), True),
    ("gelu", {}, (-2, 2), True), ("erf", {}, (-2, 2), True),
    ("silu", {}, (-2, 2), True),
    ("brelu", {"t_min": -0.5, "t_max": 0.8}, (-2, 2), False),
    ("leaky_relu", {"alpha": 0.1}, (-2, 2), True),
    ("soft_relu", {"threshold": 40.0}, (-2, 2), True),
    ("elu", {"alpha": 1.5}, (-2, 2), True),
    ("relu6", {"threshold": 6.0}, (0.2, 2), True),
    ("pow", {"factor": 3.0}, (0.5, 2), True),
    ("stanh", {"scale_a": 0.67, "scale_b": 1.7159}, (-2, 2), True),
    ("hard_shrink", {"threshold": 0.5}, (-2, 2), False),
    ("softshrink", {"lambda": 0.5}, (0.8, 2), True),
    ("thresholded_relu", {"threshold": 1.0}, (1.2, 2), True),
    ("hard_sigmoid", {"slope": 0.2, "offset": 0.5}, (-1.5, 1.5), False),
    ("swish", {"beta": 1.5}, (-2, 2), True), ("mish", {}, (-2, 2), True),
]


def cases():
    """[(op type, inputs, attrs, output slots, wrt slots)]."""
    out = []
    for k, (op, attrs, (lo, hi), grad) in enumerate(_UNARY):
        out.append((op, {"X": _r(k, 16, 33, lo=lo, hi=hi)}, attrs, ["Out"],
                    ["X"] if grad else []))
    x4 = _r(40, 2, 3, 4, 4, lo=-2, hi=2)
    out.append(("prelu", {"X": x4, "Alpha": _r(41, 3)}, {"mode": "channel"},
                ["Out"], ["X", "Alpha"]))
    a, b = np.round(_r(42, 4, 5, lo=0, hi=3)), np.round(_r(43, 4, 5, lo=0,
                                                              hi=3))
    for op in ("equal", "not_equal", "less_than", "less_equal",
               "greater_than", "greater_equal"):
        out.append((op, {"X": a, "Y": b}, {}, ["Out"], []))
    p, q = a > 1, b > 1
    for op in ("logical_and", "logical_or", "logical_xor"):
        out.append((op, {"X": p, "Y": q}, {}, ["Out"], []))
    out.append(("logical_not", {"X": p}, {}, ["Out"], []))
    x = _r(44, 3, 5, 7, lo=0.5, hi=2)
    for op in ("reduce_max", "reduce_min", "reduce_mean", "reduce_prod"):
        out.append((op, {"X": x}, {"dim": [1, 2], "keep_dim": True},
                    ["Out"], ["X"]))
    y = _r(45, 6, 9)
    out += [
        ("cumsum", {"X": y}, {"axis": 1, "exclusive": True,
                              "reverse": True}, ["Out"], ["X"]),
        ("l1_norm", {"X": y}, {}, ["Out"], ["X"]),
        ("squared_l2_norm", {"X": y}, {}, ["Out"], ["X"]),
        ("squared_l2_distance", {"X": y, "Y": _r(46, 6, 9)}, {},
         ["Out", "sub_result"], ["X", "Y"]),
        ("norm", {"X": y}, {"axis": 1}, ["Out", "Norm"], ["X"]),
        ("cos_sim", {"X": y, "Y": _r(47, 6, 9)}, {},
         ["Out", "XNorm", "YNorm"], ["X", "Y"]),
        ("bilinear_tensor_product", {"X": _r(48, 4, 5), "Y": _r(49, 4, 6),
                                     "Weight": _r(50, 3, 5, 6),
                                     "Bias": _r(51, 1, 3)}, {}, ["Out"],
         ["X", "Y", "Weight"]),
        ("arg_max", {"X": y}, {"axis": 1}, ["Out"], []),
        ("arg_min", {"X": y}, {"axis": 0}, ["Out"], []),
        ("minus", {"X": y, "Y": _r(52, 6, 9)}, {}, ["Out"], ["X", "Y"]),
        ("conv_shift", {"X": _r(53, 4, 9), "Y": _r(54, 4, 3)}, {}, ["Out"],
         ["X", "Y"]),
    ]
    t = _r(55, 5, 3)
    out += [
        ("fill_constant_batch_size_like", {"Input": t},
         {"shape": [1, 4], "value": 0.5}, ["Out"], []),
        ("fill_zeros_like", {"X": t}, {}, ["Out"], []),
        ("fill_any_like", {"X": t}, {"value": 2.5}, ["Out"], []),
        ("assign", {"X": t}, {}, ["Out"], ["X"]),
        ("concat", {"X": [t, _r(56, 5, 2)]}, {"axis": 1}, ["Out"], ["X"]),
        ("squeeze", {"X": _r(57, 2, 1, 3)}, {"axes": [1]}, ["Out"], ["X"]),
        ("unsqueeze", {"X": t}, {"axes": [0, 2]}, ["Out"], ["X"]),
        ("stack", {"X": [t, t * 2]}, {"axis": 1}, ["Y"], ["X"]),
        ("unstack", {"X": t}, {"axis": 1}, [("Y", 3)], []),
        ("gather", {"X": t, "Index": _i(4, 0, 4)}, {}, ["Out"], ["X"]),
        ("scatter", {"X": t, "Ids": _i(1, 3), "Updates": _r(58, 2, 3)},
         {"overwrite": False}, ["Out"], ["X"]),
        ("pad", {"X": t}, {"paddings": [1, 0, 0, 2], "pad_value": 9.0},
         ["Out"], ["X"]),
        ("pad_constant_like", {"X": _r(59, 7, 4), "Y": t}, {}, ["Out"], []),
        ("crop", {"X": t}, {"offsets": [1, 1], "shape": [3, 2]}, ["Out"],
         ["X"]),
        ("slice", {"Input": t}, {"axes": [0], "starts": [-4], "ends": [4]},
         ["Out"], ["Input"]),
        ("shape", {"Input": t}, {}, ["Out"], []),
        ("increment", {"X": _i(3)}, {"step": 2.0}, ["Out"], []),
        ("multiplex", {"X": [t, t * 3], "Ids": _i(1, 0, 1, 1, 0).reshape(
            5, 1)}, {}, ["Out"], []),
        ("is_empty", {"X": t}, {}, ["Out"], []),
        ("range", {"Start": np.array([1.5], np.float32),
                   "End": np.array([6.0], np.float32),
                   "Step": np.array([0.75], np.float32)}, {}, ["Out"], []),
        ("linspace", {}, {"start": -2.5, "stop": 3.0, "num": 12}, ["Out"],
         []),
        ("sequence_mask", {"X": _i(2, 4, 1, 0)}, {"maxlen": 5}, ["Y"], []),
        ("print", {"In": _r(60, 2, 2)}, {"message": "op_sweep print"},
         ["Out"], []),
        ("uniform_random_batch_size_like", {"Input": _r(61, 2000, 2)},
         {"shape": [1, 5], "min": -2.0, "max": 2.0}, ["Out"], []),
        ("gaussian_random_batch_size_like", {"Input": _r(62, 2000, 2)},
         {"shape": [1, 5], "mean": 1.0, "std": 2.0}, ["Out"], []),
    ]
    lab = (_r(63, 8, 1, lo=0, hi=1) > 0.5).astype(np.float32)
    out += [
        ("sigmoid_cross_entropy_with_logits",
         {"X": _r(64, 8, 3, lo=-3, hi=3), "Label": _r(65, 8, 3, lo=0, hi=1)},
         {}, ["Out"], ["X"]),
        ("hinge_loss", {"Logits": _r(66, 8, 1, lo=-2, hi=2),
                        "Labels": lab}, {}, ["Loss"], ["Logits"]),
        ("huber_loss", {"X": _r(67, 8, 1), "Y": _r(68, 8, 1, lo=0, hi=3)},
         {"delta": 1.0}, ["Out", "Residual"], ["X"]),
        ("log_loss", {"Predicted": _r(69, 8, 1, lo=0.1, hi=0.9),
                      "Labels": lab}, {}, ["Loss"], ["Predicted"]),
        ("smooth_l1_loss", {"X": _r(70, 8, 3), "Y": _r(71, 8, 3)},
         {"sigma": 2.0}, ["Out", "Diff"], ["X"]),
        ("rank_loss", {"Label": lab, "Left": _r(72, 8, 1),
                       "Right": _r(73, 8, 1)}, {}, ["Out"], ["Left"]),
        ("margin_rank_loss", {"Label": 2 * lab - 1, "X1": _r(74, 8, 1),
                              "X2": _r(75, 8, 1)}, {"margin": 0.1},
         ["Out", "Activated"], ["X1"]),
        ("modified_huber_loss", {"X": _r(76, 8, 1, lo=-2, hi=2), "Y": lab},
         {}, ["Out", "IntermediateVal"], ["X"]),
        ("nce", {"Input": _r(77, 8, 4), "Label": _i(*range(8)).reshape(
            8, 1) % 5, "Weight": _r(78, 5, 4), "Bias": _r(79, 5)},
         {"num_total_classes": 5, "num_neg_samples": 3},
         ["Cost", "SampleLogits", "SampleLabels"], []),
        ("log_softmax", {"X": _r(80, 4, 7, lo=-2, hi=2)}, {}, ["Out"],
         ["X"]),
        ("lrn", {"X": _r(81, 2, 6, 3, 3)}, {"n": 5, "alpha": 1e-2},
         ["Out", "MidOut"], ["X"]),
        ("maxout", {"X": _r(82, 2, 6, 3, 3)}, {"groups": 3}, ["Out"],
         ["X"]),
    ]
    img = _r(83, 2, 2, 6, 6)
    rois = np.array([[0, 0, 3, 3], [1, 2, 5, 5], [2.5, 1.5, 4.4, 5.6]],
                    np.float32)
    out += [
        ("conv3d", {"Input": _r(84, 1, 2, 5, 5, 5),
                    "Filter": _r(85, 3, 2, 2, 2, 2)},
         {"paddings": [1, 0, 1]}, ["Output"], ["Input", "Filter"]),
        ("depthwise_conv2d", {"Input": _r(86, 2, 3, 5, 5),
                              "Filter": _r(87, 6, 1, 3, 3)},
         {"paddings": [1, 1]}, ["Output"], ["Input", "Filter"]),
        ("conv2d_transpose", {"Input": _r(88, 2, 4, 3, 3),
                              "Filter": _r(89, 4, 2, 3, 3)},
         {"strides": [2, 2], "paddings": [1, 1], "output_size": [6, 6]},
         ["Output"], ["Input", "Filter"]),
        ("conv3d_transpose", {"Input": _r(90, 1, 2, 3, 3, 3),
                              "Filter": _r(91, 2, 3, 2, 2, 2)},
         {"strides": [2, 2, 2]}, ["Output"], ["Input", "Filter"]),
        ("pool3d", {"X": _r(92, 2, 2, 5, 5, 5)},
         {"pooling_type": "avg", "ksize": [2, 3, 2], "strides": [1, 2, 2],
          "paddings": [1, 0, 1]}, ["Out"], ["X"]),
        ("max_pool2d_with_index", {"X": img},
         {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]},
         ["Out", "Mask"], ["X"]),
        ("unpool", {"X": _r(93, 2, 2, 3, 3),
                    "Indices": (np.arange(9, dtype=np.int32) * 4 % 36)
                    .reshape(1, 1, 3, 3).repeat(2, 0).repeat(2, 1)},
         {"ksize": [2, 2], "strides": [2, 2]}, ["Out"], ["X"]),
        ("spp", {"X": _r(94, 2, 3, 5, 7)}, {"pyramid_height": 3},
         ["Out"], ["X"]),
        ("roi_pool", {"X": img, "ROIs": rois},
         {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.5},
         ["Out"], ["X"]),
        ("row_conv", {"X": _r(95, 6, 4), "Filter": _r(96, 3, 4)}, {},
         ["Out"], ["X", "Filter"]),
    ]
    rng = np.random.RandomState(97)
    p1 = rng.uniform(0, 1, 64).astype(np.float32)
    out += [
        ("auc", {"Out": np.stack([1 - p1, p1], 1),
                 "Label": (rng.uniform(0, 1, (64, 1)) < p1[:, None])
                 .astype(np.int32)}, {}, ["AUC"], []),
        ("precision_recall", {"Indices": rng.randint(0, 4, (20, 1))
                              .astype(np.int32),
                              "Labels": rng.randint(0, 4, (20, 1))
                              .astype(np.int32)}, {"class_number": 4},
         ["BatchMetrics", "AccumStatesInfo"], []),
        ("positive_negative_pair",
         {"Score": _r(98, 12, 1), "Label": np.round(_r(99, 12, 1, lo=0,
                                                       hi=2)),
          "QueryID": _i(*[0] * 4 + [1] * 4 + [2] * 4).reshape(12, 1)}, {},
         ["PositivePair", "NegativePair", "NeutralPair"], []),
    ]
    return out


def lod_cases():
    """[(op type, inputs, attrs, output slots, wrt slots)] of the one-op
    types the LoD, sequence and RNN slice added, and the LoD branches of
    roi_pool and row_conv. Lengths include an empty sequence, totals
    that the bucket pads, and ties in the MAX/MIN pools."""
    x = _r(200, 7, 3)                     # lengths 3, 0, 4: pads to 8
    ties = np.round(_r(201, 9, 2, lo=0, hi=2))
    out = []
    for ptype in ("SUM", "AVERAGE", "SQRT", "LAST", "FIRST"):
        out.append(("sequence_pool", {"X": Seq(x, [3, 0, 4])},
                    {"pooltype": ptype}, ["Out"], ["X"]))
    out += [
        ("sequence_pool", {"X": Seq(x, [3, 0, 4])}, {"pooltype": "MAX"},
         ["Out", "MaxIndex"], ["X"]),
        ("sequence_pool", {"X": Seq(ties, [4, 5])}, {"pooltype": "MAX"},
         ["Out", "MaxIndex"], ["X"]),
        ("sequence_pool", {"X": Seq(ties, [2, 0, 7])}, {"pooltype": "MIN"},
         ["Out"], ["X"]),
        ("sequence_first_step", {"X": Seq(x, [2, 5])}, {}, ["Out"], ["X"]),
        ("sequence_last_step", {"X": Seq(x, [2, 5])}, {}, ["Out"], ["X"]),
        ("sequence_concat", {"X": [Seq(_r(202, 3, 2), [1, 2]),
                                   Seq(_r(203, 4, 2), [2, 2])]}, {},
         ["Out"], ["X"]),
        ("sequence_expand", {"X": _r(204, 2, 3),
                             "Y": Seq(_r(205, 6, 1), [4, 2])}, {},
         ["Out"], ["X"]),
        ("sequence_expand", {"X": Seq(_r(206, 2, 3), [1, 1]),
                             "Y": Seq(_r(207, 5, 1), [2, 3])}, {},
         ["Out"], ["X"]),
        ("lod_reset", {"X": Seq(x[:6], [2, 4])}, {"target_lod": [0, 3, 6]},
         ["Out"], ["X"]),
        ("lod_reset", {"X": Seq(x[:6], [2, 4]),
                       "Y": Seq(_r(208, 6, 1), [1, 5])}, {}, ["Out"],
         ["X"]),
        ("lod_reset", {"X": Seq(x[:6], [2, 4]), "Y": _i(0, 4, 6)}, {},
         ["Out"], ["X"]),
        ("sequence_reshape", {"X": Seq(_r(209, 6, 6), [2, 4])},
         {"new_dim": 12}, ["Out"], ["X"]),
        ("sequence_slice", {"X": Seq(x, [3, 4]),
                            "Offset": _i(1, 0).reshape(2, 1),
                            "Length": _i(2, 3).reshape(2, 1)}, {},
         ["Out"], ["X"]),
        ("sequence_erase", {"X": Seq(_i(1, 2, 3, 2, 5, 7, 2).reshape(7, 1),
                                     [3, 4])}, {"tokens": [2, 7]}, ["Out"],
         []),
        ("sequence_conv", {"X": Seq(_r(210, 7, 2), [3, 4]),
                           "Filter": _r(211, 6, 5)},
         {"contextLength": 3, "contextStart": -1}, ["Out"],
         ["X", "Filter"]),
        ("sequence_pad", {"X": Seq(_r(212, 6, 3), [2, 4]),
                          "PadValue": np.array([-1.5], np.float32)},
         {"padded_length": 5}, ["Out", "Length"], ["X"]),
        ("sequence_unpad", {"X": _r(213, 3, 4, 2),
                            "Length": _i(2, 4, 1)}, {}, ["Out"], ["X"]),
        ("sequence_scatter", {"X": _r(214, 5, 2), "Ids": _i(0, 3, 1),
                              "Updates": _r(215, 3, 2)}, {}, ["Out"],
         ["X", "Updates"]),
        ("reorder_lod_tensor_by_rank", {"X": Seq(_r(216, 7, 2), [2, 5]),
                                        "RankTable": _i(2, 5)}, {},
         ["Out"], ["X"]),
        ("reorder_lod_tensor_by_rank", {"X": _r(217, 3, 2),
                                        "RankTable": _i(1, 4, 2)}, {},
         ["Out"], ["X"]),
        ("sequence_softmax", {"X": Seq(_r(218, 6, 1, lo=-2, hi=2),
                                       [3, 0, 3])}, {}, ["Out"], ["X"]),
        ("im2sequence", {"X": _r(219, 2, 3, 5, 5)},
         {"kernels": [2, 2], "strides": [2, 1], "paddings": [1, 0, 0, 1]},
         ["Out"], ["X"]),
        ("edit_distance", {"Hyps": _i(1, 2, 3, 4, 5, 6, 7, 8).reshape(2, 4),
                           "Refs": _i(1, 3, 3, 9, 5, 6, 8, 8).reshape(2, 4)},
         {"normalized": False}, ["Out", "SequenceNum"], []),
        ("edit_distance", {"Hyps": Seq(_i(1, 2, 3).reshape(3, 1), [3]),
                           "Refs": Seq(_i(1, 3).reshape(2, 1), [2])},
         {"normalized": True}, ["Out", "SequenceNum"], []),
        ("roi_pool", {"X": _r(220, 2, 2, 6, 6),
                      "ROIs": Seq(np.array([[0, 0, 3, 3], [1, 2, 5, 5],
                                            [2, 1, 4, 5]], np.float32),
                                  [1, 2])},
         {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0},
         ["Out"], ["X"]),
        ("row_conv", {"X": Seq(_r(221, 7, 4), [3, 4]),
                      "Filter": _r(222, 3, 4)}, {}, ["Out"],
         ["X", "Filter"]),
    ]
    d = 4
    xs = Seq(_r(223, 9, 4 * d), [3, 5, 1])
    for peep, rev in ((False, False), (True, False), (True, True)):
        out.append(("lstm", {"Input": xs, "Weight": _r(224, d, 4 * d),
                             "Bias": _r(225, 1, (7 if peep else 4) * d)},
                    {"use_peepholes": peep, "is_reverse": rev},
                    ["Hidden", "Cell"], ["Input", "Weight", "Bias"]))
    out += [
        ("lstm", {"Input": xs, "Weight": _r(226, d, 4 * d),
                  "Bias": _r(227, 1, 4 * d), "H0": _r(228, 3, d),
                  "C0": _r(229, 3, d)},
         {"use_peepholes": False, "gate_activation": "sigmoid",
          "cell_activation": "relu", "candidate_activation": "identity"},
         ["Hidden", "Cell"], ["Input", "Weight", "H0", "C0"]),
        ("lstmp", {"Input": xs, "Weight": _r(230, 3, 4 * d),
                   "ProjWeight": _r(231, d, 3), "Bias": _r(232, 1, 7 * d)},
         {"is_reverse": True}, ["Projection"],
         ["Input", "Weight", "ProjWeight", "Bias"]),
        ("gru", {"Input": Seq(_r(233, 9, 3 * d), [3, 5, 1]),
                 "Weight": _r(234, d, 3 * d), "Bias": _r(235, 1, 3 * d)},
         {}, ["Hidden"], ["Input", "Weight", "Bias"]),
        ("gru", {"Input": Seq(_r(236, 9, 3 * d), [3, 5, 1]),
                 "Weight": _r(237, d, 3 * d), "H0": _r(238, 3, d)},
         {"is_reverse": True, "origin_mode": True}, ["Hidden"],
         ["Input", "Weight", "H0"]),
        ("lstm_unit", {"X": _r(239, 3, 4 * d), "C_prev": _r(240, 3, d)},
         {"forget_bias": 0.5}, ["C", "H"], ["X", "C_prev"]),
        ("gru_unit", {"Input": _r(241, 3, 3 * d), "HiddenPrev": _r(242, 3, d),
                      "Weight": _r(243, d, 3 * d), "Bias": _r(244, 1, 3 * d)},
         {"activation": 2, "gate_activation": 1},
         ["Gate", "ResetHiddenPrev", "Hidden"], ["Input", "HiddenPrev",
                                                  "Weight"]),
        ("gru_unit", {"Input": _r(245, 3, 3 * d), "HiddenPrev": _r(246, 3, d),
                      "Weight": _r(247, d, 3 * d)},
         {"activation": "relu", "gate_activation": "sigmoid",
          "origin_mode": True}, ["Hidden"], ["Input", "HiddenPrev"]),
    ]
    return out


def _boxes(seed, *shape, scale=1.0):
    """[..., 4] boxes (xmin, ymin, xmax, ymax) with xmin < xmax and
    ymin < ymax, in [0, scale]."""
    c = np.sort(np.random.RandomState(seed).uniform(
        0, scale, shape + (2, 2)), axis=-2)
    return np.concatenate([c[..., 0, :], c[..., 1, :]], -1).astype(
        np.float32)


def _ints(seed, lo, hi, *shape):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(
        np.int32)


def detection_cases():
    """[(op type, inputs, attrs, output slots, wrt slots)] of the CRF,
    CTC and detection op types. LoD totals are no power of two (the
    bucket pads them), some sequences are empty, and rounded values give
    ties to the sorts, top-k's and argmaxes."""
    out = []
    d = 5
    em = Seq(_r(400, 11, d, lo=-2, hi=2), [3, 5, 1, 2])
    lab = Seq(_ints(401, 0, d, 11, 1), [3, 5, 1, 2])
    trans = _r(402, d + 2, d)
    out += [
        ("linear_chain_crf", {"Emission": em, "Label": lab,
                              "Transition": trans}, {},
         ["LogLikelihood", "Alpha", "EmissionExps", "TransitionExps"],
         ["Emission", "Transition"]),
        ("linear_chain_crf", {"Emission": Seq(em.data[:7], [4, 0, 3]),
                              "Label": Seq(lab.data[:7], [4, 0, 3]),
                              "Transition": trans}, {},
         ["LogLikelihood", "EmissionExps"], ["Emission", "Transition"]),
        ("crf_decoding", {"Emission": em, "Transition": trans}, {},
         ["ViterbiPath"], []),
        ("crf_decoding", {"Emission": Seq(np.round(em.data), em.lengths),
                          "Transition": np.round(trans),
                          "Label": lab}, {}, ["ViterbiPath"], []),
    ]
    logits = Seq(_r(403, 17, 6, lo=-2, hi=2), [6, 4, 7])
    labels = Seq(_ints(404, 1, 6, 6, 1), [2, 1, 3])
    out += [
        ("warpctc", {"Logits": logits, "Label": labels}, {"blank": 0},
         ["Loss", "WarpCTCGrad"], ["Logits"]),
        ("warpctc", {"Logits": logits, "Label": labels},
         {"blank": 0, "norm_by_times": True}, ["Loss"], ["Logits"]),
        # the second sequence cannot align: 3 repeated labels in 4 steps
        ("warpctc", {"Logits": Seq(logits.data[:9], [5, 4]),
                     "Label": Seq(np.array([[2], [3], [3], [3]], np.int32),
                                  [1, 3])}, {"blank": 0}, ["Loss"], []),
        ("warpctc", {"Logits": logits,
                     "Label": Seq(_ints(405, 0, 5, 6, 1), [2, 1, 3])},
         {"blank": 5}, ["Loss"], ["Logits"]),
    ]
    ids = Seq(_ints(406, 0, 4, 15, 1), [7, 5, 3])
    out += [
        ("ctc_align", {"Input": ids}, {"blank": 0, "merge_repeated": True},
         ["Output"], []),
        ("ctc_align", {"Input": ids}, {"blank": 2,
                                       "merge_repeated": False},
         ["Output"], []),
    ]
    inf = Seq(_ints(407, 0, 7, 15, 1), [5, 6, 4])
    lab_tags = Seq(np.where(np.random.RandomState(408).rand(15, 1) < 0.6,
                            inf.data, _ints(409, 0, 7, 15, 1)), [5, 6, 4])
    metrics = ["Precision", "Recall", "F1-Score", "NumInferChunks",
               "NumLabelChunks", "NumCorrectChunks"]
    out += [
        ("chunk_eval", {"Inference": inf, "Label": lab_tags},
         {"num_chunk_types": 3, "chunk_scheme": "IOB"}, metrics, []),
        ("chunk_eval", {"Inference": inf, "Label": lab_tags},
         {"num_chunk_types": 3, "chunk_scheme": "IOB",
          "excluded_chunk_types": [1]}, metrics, []),
        ("chunk_eval", {"Inference": inf, "Label": lab_tags},
         {"num_chunk_types": 4, "chunk_scheme": "plain"}, metrics, []),
    ]
    prior = _boxes(410, 6)
    pvar = np.full((6, 4), 0.1, np.float32)
    out += [
        ("iou_similarity", {"X": _boxes(411, 5), "Y": _boxes(412, 7)}, {},
         ["Out"], []),
        ("box_coder", {"PriorBox": prior, "PriorBoxVar": pvar,
                       "TargetBox": _boxes(413, 3)},
         {"code_type": "encode_center_size"}, ["OutputBox"],
         ["TargetBox"]),
        ("box_coder", {"PriorBox": prior, "PriorBoxVar": pvar,
                       "TargetBox": _r(414, 2, 6, 4)},
         {"code_type": "decode_center_size"}, ["OutputBox"],
         ["TargetBox"]),
        ("prior_box", {"Input": _r(415, 1, 2, 3, 4),
                       "Image": _r(416, 1, 3, 24, 32)},
         {"min_sizes": [4.0, 8.0], "max_sizes": [8.0, 16.0],
          "aspect_ratios": [2.0, 3.0], "flip": True, "clip": True},
         ["Boxes", "Variances"], []),
    ]
    dist = np.round(_r(417, 4, 6, lo=0, hi=1) * 4) / 4     # ties
    dist[2] = 0.0                                          # a row of zeros
    out += [
        ("bipartite_match", {"DistMat": dist}, {},
         ["ColToRowMatchIndices", "ColToRowMatchDist"], []),
        ("bipartite_match", {"DistMat": dist},
         {"match_type": "per_prediction", "dist_threshold": 0.3},
         ["ColToRowMatchIndices", "ColToRowMatchDist"], []),
        ("target_assign", {"X": _r(418, 4, 1, 3),
                           "MatchIndices": np.array([[0, -1, 3, 3, -1, 1]],
                                                    np.int32)},
         {"mismatch_value": 7.0}, ["Out", "OutWeight"], []),
        ("mine_hard_examples",
         {"ClsLoss": np.round(_r(419, 2, 8, lo=0, hi=2) * 2) / 2,
          "MatchIndices": np.array([[0, -1, -1, 1, -1, -1, -1, -1],
                                    [-1, -1, 2, -1, -1, -1, -1, -1]],
                                   np.int32)},
         {"neg_pos_ratio": 2.0}, ["NegIndices", "UpdatedMatchIndices"], []),
    ]
    nms_scores = np.round(_r(420, 2, 3, 8, lo=0, hi=1) * 4) / 4
    nms_boxes = _boxes(421, 2, 8)
    for attrs in ({"score_threshold": 0.1, "nms_threshold": 0.3,
                   "nms_top_k": 6, "keep_top_k": 10},
                  {"score_threshold": 0.2, "nms_threshold": 0.5,
                   "nms_top_k": -1, "keep_top_k": 20, "nms_eta": 0.7,
                   "background_label": 1},
                  {"score_threshold": 0.0, "nms_threshold": 0.4,
                   "keep_top_k": 5, "normalized": False}):
        out.append(("multiclass_nms",
                    {"BBoxes": nms_boxes * (10 if not attrs.get(
                        "normalized", True) else 1), "Scores": nms_scores},
                    attrs, ["Out"], []))
    det = np.concatenate([_ints(422, 0, 3, 7, 1).astype(np.float32),
                          np.round(_r(423, 7, 1, lo=0, hi=1) * 3) / 4
                          + 0.25, _boxes(424, 7)], axis=1)
    det[6, 1] = 0.0                                  # not a detection
    gt = np.concatenate([_ints(425, 0, 3, 5, 1).astype(np.float32),
                         np.zeros((5, 1), np.float32), _boxes(426, 5)],
                        axis=1)
    gt[:3, 0] = det[:3, 0]                           # three hits, ...
    gt[:3, 2:] = det[:3, 2:] + 0.01
    det[3] = det[0]                                  # ... a duplicate
    det[3, 1] = 0.5
    diff = np.array([[0], [1], [0], [0], [1]], np.float32)
    for attrs in ({"ap_version": "11point"},
                  {"ap_version": "integral"},
                  {"ap_version": "integral", "evaluate_difficult": False},
                  {"ap_version": "11point", "evaluate_difficult": False},
                  {"ap_version": "11point", "class_num": 3,
                   "overlap_threshold": 0.3}):
        inputs = {"DetectRes": det, "Label": gt}
        if "evaluate_difficult" in attrs:
            inputs["Difficult"] = diff
        out.append(("detection_map", inputs, attrs,
                     ["MAP", "AccumPosCount"], []))
    m, c = 12, 4
    ssd = {"Loc": _r(427, 3, m, 4), "Conf": _r(428, 3, m, c, lo=-2, hi=2),
           "GTBox": Seq(_boxes(429, 5), [2, 0, 3]),
           "GTLabel": Seq(_ints(430, 1, c, 5, 1), [2, 0, 3]),
           "PriorBox": _boxes(431, m), "PriorBoxVar": np.tile(
               np.array([0.1, 0.1, 0.2, 0.2], np.float32), (m, 1))}
    out += [
        ("ssd_loss", ssd, {"overlap_threshold": 0.3}, ["Loss"],
         ["Loc", "Conf"]),
        ("ssd_loss", ssd, {"overlap_threshold": 0.3, "neg_overlap": 0.2,
                           "normalize": False, "neg_pos_ratio": 1.0},
         ["Loss"], ["Loc", "Conf"]),
        ("ssd_loss", dict(ssd, GTBox=Seq(ssd["GTBox"].data[:3], [2, 0, 1]),
                          GTLabel=Seq(ssd["GTLabel"].data[:3], [2, 0, 1])),
         {"match_type": "bipartite"}, ["Loss"], ["Loc", "Conf"]),
        # no ground truth in the batch: the bucket's two zero rows only
        ("ssd_loss", dict(ssd, Loc=ssd["Loc"][:1], Conf=ssd["Conf"][:1],
                          GTBox=Seq(np.zeros((0, 4), np.float32), [0]),
                          GTLabel=Seq(np.zeros((0, 1), np.int32), [0])),
         {}, ["Loss"], []),
    ]
    return out


def parallel_cases():
    """[(op type, inputs, attrs, output slots, wrt slots)] of the parallel
    tier's op types, run without a mesh."""
    x = _r(500, 4, 6)
    out = [(t, {"X": x}, {}, ["Out"], [])
           for t in ("c_allreduce_sum", "c_allreduce_max", "c_allgather",
                     "c_reducescatter", "c_broadcast", "all_to_all",
                     "c_sync_comm_stream")]
    tok = _r(501, 2, 8, 16)
    out.append(("moe_ffn", {"X": tok, "GateW": _r(502, 16, 4),
                            "WUp": _r(503, 4, 16, 32, lo=-0.3, hi=0.3),
                            "WDown": _r(504, 4, 32, 16, lo=-0.3, hi=0.3)},
                {"capacity_factor": 1.25, "top_k": 2},
                ["Out", "AuxLoss", "Overflow"], ["X", "GateW"]))
    layers, d, f = 2, 16, 32
    stack = {"WQ": _r(505, layers, d, d, lo=-0.25, hi=0.25),
             "WK": _r(506, layers, d, d, lo=-0.25, hi=0.25),
             "WV": _r(507, layers, d, d, lo=-0.25, hi=0.25),
             "WO": _r(508, layers, d, d, lo=-0.25, hi=0.25),
             "LN1S": _r(509, layers, d, lo=0.5, hi=1.5),
             "LN1B": _r(510, layers, d, lo=-0.1, hi=0.1),
             "W1": _r(511, layers, d, f, lo=-0.25, hi=0.25),
             "B1": _r(512, layers, f, lo=-0.1, hi=0.1),
             "W2": _r(513, layers, f, d, lo=-0.2, hi=0.2),
             "B2": _r(514, layers, d, lo=-0.1, hi=0.1),
             "LN2S": _r(515, layers, d, lo=0.5, hi=1.5),
             "LN2B": _r(516, layers, d, lo=-0.1, hi=0.1)}
    out.append(("pipeline_stack", dict({"X": tok}, **stack),
                {"n_head": 2, "num_microbatches": 2}, ["Out"], ["X"]))
    return out


def fused_cases():
    """[(op type, inputs, attrs, output slots, wrt slots)] of the fused
    ops (``ops/fused.py``): a mul anchor with its bias and relu, a conv2d
    anchor with a channel bias and tanh, and a cast/scale pair."""
    return [
        ("fused_matmul_bias_act",
         {"X": _r(600, 3, 4, 8), "Y": _r(601, 8, 6), "Bias": _r(602, 6)},
         {"mm_type": "mul", "mm_attrs": {"x_num_col_dims": 2},
          "add_attrs": {"axis": -1}, "act_type": "relu", "act_attrs": {}},
         ["Out"], ["X", "Y", "Bias"]),
        ("fused_matmul_bias_act",
         {"X": _r(603, 2, 3, 6, 6), "Y": _r(604, 4, 3, 3, 3),
          "Bias": _r(605, 4)},
         {"mm_type": "conv2d",
          "mm_attrs": {"strides": [1, 1], "paddings": [1, 1]},
          "add_attrs": {"axis": 1}, "act_type": "tanh", "act_attrs": {}},
         ["Out"], ["X", "Y"]),
        ("fused_scale_cast", {"X": _r(606, 4, 5)},
         {"ops": [["cast", {"out_dtype": "float32"}],
                  ["scale", {"scale": 0.5, "bias": 1.0}]]},
         ["Out"], ["X"]),
    ]


def control_flow_programs(fluid):
    """[(name, program, startup or None, feed, fetch names)] of small
    Programs built by ``fluid``'s layers (either package's) that hold
    the control-flow op types: a StaticRNN (``recurrent``), a
    DynamicRNN over a LoD input (``recurrent`` with lengths, between
    ``sequence_pad`` and ``sequence_unpad``), a counting While with a
    ConditionalBlock after it, an IfElse (``select_rows_by_mask``), the
    tensor arrays, and ``lod_rank_table`` -> ``max_sequence_len``
    beside ``shrink_memory``."""
    L = fluid.layers
    progs = []

    def program(name, build, feed):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            fetch = [v.name for v in build()]
        progs.append((name, main, startup if startup.global_block().ops
                      else None, feed, fetch))

    def static_rnn():
        x = L.data("x", [3, 4], append_batch_size=False)
        x3 = L.reshape(x, [5, 3, 4])
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x3)
            h_prev = rnn.memory(shape=[-1, 4], batch_ref=x_t,
                                init_value=0.0)
            h = L.scale(h_prev, 0.5) + L.tanh(x_t)
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        return [rnn()]
    program("static_rnn", static_rnn, {"x": _r(300, 15, 4)})

    def dynamic_rnn():
        x = L.data("x", [5], lod_level=1)
        drnn = L.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x)
            h_prev = drnn.memory(shape=[5], value=0.0)
            h = L.scale(h_prev, 0.9) + L.sigmoid(x_t)
            drnn.update_memory(h_prev, h)
            drnn.output(h)
        return [drnn()]
    program("dynamic_rnn", dynamic_rnn,
            {"x": fluid.create_lod_tensor(_r(301, 6, 5), [[3, 1, 2]])})

    def while_cond():
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", 7)
        acc = L.fill_constant([1], "float32", 0.5)
        cond = L.less_than(i, limit)
        w = L.While(cond, loop_vars=[i, acc])
        with w.block():
            L.assign(acc * 1.5 + 1.0, acc)
            L.increment(i, value=1.0)
            L.less_than(i, limit, cond=cond)
        flag = L.less_than(L.fill_constant([1], "float32", 0.0), acc)
        out = L.fill_constant([1], "float32", -1.0)
        with L.ConditionalBlock([flag]).block():
            L.assign(acc * 2.0, out)
        return [i, acc, out]
    program("while_conditional_block", while_cond, {})

    def if_else():
        x = L.data("x", [2])
        limit = L.fill_constant([1], "float32", 0.5)
        mask = L.less_than(L.slice(x, axes=[1], starts=[0], ends=[1]),
                           limit)
        ie = L.IfElse(mask)
        with ie.true_block():
            ie.output(L.scale(ie.input(x), 10.0))
        with ie.false_block():
            ie.output(L.scale(ie.input(x), -1.0))
        return ie()
    program("if_else", if_else, {"x": _r(302, 6, 2, lo=0, hi=1)})

    def arrays():
        x = L.data("x", [3])
        i0 = L.fill_constant([1], "int64", 0)
        i2 = L.fill_constant([1], "int64", 2)
        arr = L.array_write(x, i0)
        L.array_write(L.scale(x, 3.0), i2, array=arr)
        return [L.array_read(arr, i2), L.array_length(arr), arr]
    program("tensor_arrays", arrays, {"x": _r(303, 2, 3)})

    def rank_table():
        x = L.data("x", [2], lod_level=1)
        table = L.lod_rank_table(x)
        return [table, L.max_sequence_len(table),
                L.reorder_lod_tensor_by_rank(x, table),
                L.shrink_memory(x, L.fill_constant([1], "int64", 0), table)]
    program("rank_table", rank_table,
            {"x": fluid.create_lod_tensor(_r(304, 7, 2), [[2, 5]])})
    return progs


def one_op_program(fluid, op_type, inputs, attrs, outs, wrt=()):
    """(program, feed, fetch names) of a one-op Program whose inputs are
    fed variables ``<slot>_<i>`` and whose outputs are
    ``out_<slot>_<i>``, then the gradients of ``wrt``. ``inputs``: slot
    -> array, or a list of arrays for a multi-var slot; ``outs``: output
    slots, one given as (slot, n) holding n vars. ``fluid`` is this
    package, or any package with its Program API."""
    prog = fluid.Program()
    blk = prog.global_block()
    feed, in_map = {}, {}
    for slot, val in inputs.items():
        vals = val if isinstance(val, list) else [val]
        names = []
        for i, a in enumerate(vals):
            nm = "%s_%d" % (slot.lower(), i)
            seq = a if isinstance(a, Seq) else None
            if seq is not None:
                a = seq.data
            blk.create_var(name=nm, shape=a.shape, dtype=str(a.dtype),
                           is_data=True, lod_level=int(seq is not None))
            feed[nm] = a if seq is None else \
                fluid.create_lod_tensor(a, [seq.lengths])
            names.append(nm)
        in_map[slot] = names
    out_map = {}
    for slot in outs:
        slot, n = slot if isinstance(slot, tuple) else (slot, 1)
        out_map[slot] = ["out_%s_%d" % (slot.lower(), i) for i in range(n)]
        for nm in out_map[slot]:
            blk.create_var(name=nm)
    blk.append_op(op_type, in_map, out_map, dict(attrs))
    fetch = [n for ns in out_map.values() for n in ns]
    if wrt:     # d sum(first output) / d each wrt input
        with fluid.program_guard(prog, fluid.Program()):
            grads = fluid.calc_gradient(blk.var(fetch[0]),
                                        [blk.var(in_map[s][0]) for s in wrt])
        fetch += [g.name for g in grads]
    return prog, feed, fetch


def _close(got, want, rtol, atol):
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if np.issubdtype(want.dtype, np.floating):
        return bool(np.allclose(got, want, rtol=rtol, atol=atol))
    return bool(np.array_equal(got, want))


def _hold_random(op_type, inputs, got, want):
    """Shape and dtype as the CPU's, values in range; ``nce``'s Cost
    from its own SampleLabels."""
    if any(g.shape != w.shape or g.dtype != w.dtype
           for g, w in zip(got, want)):
        return False
    v = got[0].astype(np.float64)
    if op_type == "uniform_random_batch_size_like":
        return bool(v.min() >= -2 and v.max() < 2 and abs(v.mean()) < 0.1)
    if op_type == "gaussian_random_batch_size_like":
        return bool(abs(v.mean() - 1) < 0.15 and abs(v.std() - 2) < 0.1)
    cost, logits, samples = got
    x, w, b = inputs["Input"], inputs["Weight"], inputs["Bias"]
    ref = np.einsum("bd,bkd->bk", x, w[samples]) + b[samples] - np.log(5.0)
    y = np.zeros_like(ref)
    y[:, 0] = 1
    per = np.maximum(ref, 0) - ref * y + np.log1p(np.exp(-np.abs(ref)))
    return bool(np.array_equal(samples[:, :1], inputs["Label"])
                and np.allclose(logits, ref, rtol=1e-5, atol=1e-5)
                and np.allclose(cost, per.sum(1, keepdims=True), rtol=1e-5,
                                atol=1e-5))


def _host_ops(fluid, device):
    """split_ids, split_selected_rows, merge_selected_rows and
    lookup_sparse_table on ``device`` against the CPU, exactly."""
    from ..core.selected_rows import SelectedRows
    prog = fluid.Program()
    blk = prog.global_block()
    for n in ("sr_in", "dup", "table"):
        blk.create_var(name=n, persistable=True, type="selected_rows")
    blk.create_var(name="ids", shape=(6, 1), dtype="int64", is_data=True)
    fetch = ["part0", "part1", "merged", "looked", "id0", "id1"]
    for n in fetch:
        blk.create_var(name=n)
    blk.append_op("split_selected_rows", {"X": ["sr_in"]},
                  {"Out": ["part0", "part1"]}, {"height_sections": [4, 5]})
    blk.append_op("merge_selected_rows", {"X": ["dup"]},
                  {"Out": ["merged"]}, {})
    blk.append_op("lookup_sparse_table", {"W": ["table"], "Ids": ["ids"]},
                  {"Out": ["looked"]}, {})
    blk.append_op("split_ids", {"Ids": ["ids"]}, {"Out": ["id0", "id1"]},
                  {})
    rng = np.random.RandomState(100)
    values = {"sr_in": ([1, 5, 6, 8], rng.randn(4, 3), 9),
              "dup": ([2, 2, 3, 0, 2], rng.randn(5, 3), 9),
              "table": ([3, 7, 5], rng.randn(3, 3), 10)}
    feed = {"ids": np.array([[7], [3], [9], [5], [0], [7]], np.int64)}
    res = []
    for place in (device, "cpu"):
        exe = fluid.Executor(fluid.CPUPlace() if place == "cpu"
                             else fluid.CUDAPlace(0))
        scope = fluid.Scope()
        for n, (rows, v, h) in values.items():
            scope.set(n, SelectedRows(np.asarray(rows, np.int64),
                                      v.astype(np.float32), h))
        out = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
        res.append([np.concatenate([o.numpy()[0].astype(np.float64)[:, None],
                                    o.numpy()[1]], axis=1)
                    if isinstance(o, SelectedRows) else o for o in out])
    # merging sums duplicates: the card's adds may round differently
    return all(_close(g, w, FWD_RTOL, FWD_ATOL)
               for g, w in zip(*res))


HOST_OPS = ("split_ids", "split_selected_rows", "merge_selected_rows",
            "lookup_sparse_table")


def run(device, part="library"):
    """Every case of ``part`` on ``device`` against the CPU: "library"
    (the dense op library and the SelectedRows host ops), "lod" (the
    LoD, sequence, RNN and control-flow op types), "detection" (the
    CRF, CTC and detection op types), "parallel" (the parallel tier's
    op types without a mesh) or "fused" (the fused ops). Returns (the op types
    held, the largest forward |difference| over the float outputs);
    raises AssertionError naming the first op that disagrees."""
    import paddle_tpu_torch as fluid
    if part == "lod":
        return _run_lod(fluid, device)
    if part == "detection":
        return _run_cases(fluid, device, detection_cases())
    if part == "parallel":
        return _run_cases(fluid, device, parallel_cases())
    if part == "fused":
        return _run_cases(fluid, device, fused_cases())
    held, worst = _run_cases(fluid, device, cases())
    assert _host_ops(fluid, device), \
        "op sweep: the SelectedRows host ops on %s disagree" % device
    held.update(HOST_OPS)
    held.add("delete_var")
    _delete_var(fluid, device)
    return held, worst


def _run_lod(fluid, device):
    held, worst = _run_cases(fluid, device, lod_cases())
    held -= {"roi_pool", "row_conv"}       # the library's, held there
    for name, main, startup, feed, fetch in control_flow_programs(fluid):
        res = []
        for place in (device, "cpu"):
            exe = fluid.Executor(fluid.CPUPlace() if place == "cpu"
                                 else fluid.CUDAPlace(0))
            scope = fluid.Scope()
            if startup is not None:
                exe.run(startup, scope=scope)
            res.append(exe.run(main, feed=feed, fetch_list=fetch,
                               scope=scope))
        assert all(_close(np.asarray(g), np.asarray(w), FWD_RTOL, FWD_ATOL)
                   for g, w in zip(*res)), \
            "op sweep: the %s program on %s disagrees with the CPU" % (
                name, device)
        held.update(op.type for blk in main.blocks for op in blk.ops
                    if op.type in _CONTROL_FLOW_OPS)
    return held, worst


_CONTROL_FLOW_OPS = frozenset([
    "recurrent", "while", "conditional_block", "select_rows_by_mask",
    "write_to_array", "read_from_array", "lod_array_length",
    "shrink_rnn_memory", "max_sequence_len", "lod_rank_table"])


def _run_cases(fluid, device, case_list):
    held = set()
    worst = 0.0
    for op_type, inputs, attrs, outs, wrt in case_list:
        prog, feed, fetch = one_op_program(fluid, op_type, inputs, attrs,
                                           outs, wrt)
        n_out = len(fetch) - len(wrt)
        res = []
        for place in (device, "cpu"):
            exe = fluid.Executor(fluid.CPUPlace() if place == "cpu"
                                 else fluid.CUDAPlace(0))
            res.append(exe.run(prog, feed=feed, fetch_list=fetch,
                               scope=fluid.Scope()))
        got, want = res
        if op_type in ("uniform_random_batch_size_like",
                       "gaussian_random_batch_size_like", "nce"):
            ok = _hold_random(op_type, inputs, got, want)
        else:
            ok = all(_close(g, w, FWD_RTOL, FWD_ATOL)
                     for g, w in zip(got[:n_out], want[:n_out])) and \
                all(_close(g, w, GRAD_RTOL, GRAD_ATOL)
                    for g, w in zip(got[n_out:], want[n_out:]))
            for g, w in zip(got[:n_out], want[:n_out]):
                if np.issubdtype(w.dtype, np.floating) and w.size:
                    # spp's corner bins may be all padding: -inf in both
                    diff = np.zeros(w.shape, np.float64)
                    np.subtract(g, w, out=diff, where=g != w)
                    worst = max(worst, float(np.abs(diff).max()))
        assert ok, "op sweep: %s on %s disagrees with the CPU" % (
            op_type, device)
        held.add(op_type)
    return held, worst


def _delete_var(fluid, device):
    """delete_var drops its input from the step: the rest runs."""
    prog = fluid.Program()
    blk = prog.global_block()
    blk.create_var(name="x", shape=(2, 2), dtype="float32", is_data=True)
    blk.create_var(name="y")
    blk.append_op("assign", {"X": ["x"]}, {"Out": ["y"]}, {})
    blk.append_op("delete_var", {"X": ["x"]}, {}, {})
    x = _r(101, 2, 2)
    exe = fluid.Executor(fluid.CPUPlace() if device == "cpu"
                         else fluid.CUDAPlace(0))
    y, = exe.run(prog, feed={"x": x}, fetch_list=["y"], scope=fluid.Scope())
    assert np.array_equal(y, x), "op sweep: delete_var on %s" % device
