"""The op library's sweep on the card: one case (or a few) for each op
type the dense op library and the SelectedRows host ops added, each a
one-op Program run through ``Executor(CUDAPlace(0))`` and through
``Executor(CPUPlace())`` on the same inputs, the card's outputs held
against the CPU's at the CPU sweep's tolerances (forward rtol 1e-5 /
atol 1e-6; the gradients of ``calc_gradient`` where
tests/test_torch_ops_sweep*.py checks one, rtol 1e-4 / atol 1e-5).

The random ops (``uniform_random_batch_size_like``,
``gaussian_random_batch_size_like``, ``nce``) draw from each device's
own generator: they are held by shape, dtype and range, and ``nce`` by
its Cost recomputed from its own SampleLabels. ``print`` and ``range``
read the host and ``delete_var`` only drops a name: they run, and their
outputs are held as the others'.

Used by ``chip_smoke.py`` (phase 14 (c)); ``run(device)`` returns the
op types held. On the CPU against itself it is the tests' check that
every case runs.
"""

import numpy as np

FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _r(seed, *shape, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _i(*vals):
    return np.array(vals, np.int32)


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
            blk.create_var(name=nm, shape=a.shape, dtype=str(a.dtype),
                           is_data=True)
            feed[nm] = a
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


def run(device):
    """Every case on ``device`` against the CPU. Returns (the op types
    held, the largest forward |difference| over the float outputs);
    raises AssertionError naming the first op that disagrees."""
    import paddle_tpu_torch as fluid
    held = set()
    worst = 0.0
    for op_type, inputs, attrs, outs, wrt in cases():
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
    assert _host_ops(fluid, device), \
        "op sweep: the SelectedRows host ops on %s disagree" % device
    held.update(HOST_OPS)
    held.add("delete_var")
    _delete_var(fluid, device)
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
