"""Op sweep of the PyTorch port, part 3: the convolution and pooling ops
(conv3d, depthwise_conv2d, the transposed convolutions, adaptive pool2d,
pool3d, max_pool2d_with_index, unpool, spp, roi_pool, row_conv) against
the JAX package (tests/torch_op_harness.py); the ``layers`` builders of
the ops added to the port, whose Program JSON must be the JAX package's
under ``unique_name.guard()``; the six learning-rate schedules over 5
steps; and the port's registry against the JAX package's."""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jregistry
from paddle_tpu_torch.core import registry as tregistry

from torch_op_harness import check, rand


# --------------------------------------------------------------------------
# convolutions
@pytest.mark.parametrize("attrs", [
    {"strides": [1, 1, 1], "paddings": [1, 0, 1]},
    {"strides": [2, 1, 2], "paddings": [0, 1, 0], "dilations": [1, 2, 1]},
], ids=["pad", "stride_dilation"])
def test_conv3d(attrs):
    check("conv3d", {"Input": rand(100, 1, 2, 5, 5, 5),
                     "Filter": rand(101, 3, 2, 2, 2, 2)}, attrs, ["Output"],
          wrt=["Input", "Filter"])


def test_conv3d_groups():
    check("conv3d", {"Input": rand(102, 2, 4, 3, 4, 4),
                     "Filter": rand(103, 4, 2, 1, 3, 3)},
          {"groups": 2, "paddings": [0, 1, 1]}, ["Output"],
          wrt=["Input", "Filter"])


def test_depthwise_conv2d():
    check("depthwise_conv2d", {"Input": rand(104, 2, 3, 5, 5),
                               "Filter": rand(105, 6, 1, 3, 3)},
          {"strides": [1, 1], "paddings": [1, 1], "groups": 3}, ["Output"],
          wrt=["Input", "Filter"])


@pytest.mark.parametrize("attrs", [
    {"strides": [2, 2], "paddings": [1, 1]},
    {"strides": [2, 2], "paddings": [1, 1], "output_size": [6, 6]},
    {"strides": [2, 2], "paddings": [1, 1], "output_size": [4, 4]},
    {"strides": [1, 1], "paddings": [0, 0], "dilations": [2, 2],
     "groups": 2},
], ids=["plain", "output_size_up", "output_size_down", "dilation_groups"])
def test_conv2d_transpose(attrs):
    check("conv2d_transpose", {"Input": rand(106, 2, 4, 3, 3),
                               "Filter": rand(107, 4, 2, 3, 3)},
          attrs, ["Output"], wrt=["Input", "Filter"])


def test_conv3d_transpose():
    check("conv3d_transpose", {"Input": rand(108, 1, 2, 3, 3, 3),
                               "Filter": rand(109, 2, 3, 2, 2, 2)},
          {"strides": [2, 2, 2], "paddings": [0, 1, 0]}, ["Output"],
          wrt=["Input", "Filter"])


# --------------------------------------------------------------------------
# pooling
@pytest.mark.parametrize("attrs", [
    {"pooling_type": "max", "ksize": [2, 2, 2], "strides": [2, 2, 2],
     "paddings": [1, 1, 1]},
    {"pooling_type": "avg", "ksize": [2, 3, 2], "strides": [1, 2, 2],
     "paddings": [1, 0, 1]},
    {"pooling_type": "avg", "ksize": [3, 3, 3], "strides": [2, 2, 2],
     "paddings": [1, 1, 1], "exclusive": False},
    {"pooling_type": "max", "ksize": [2, 2, 2], "strides": [2, 2, 2],
     "ceil_mode": True},
    {"pooling_type": "avg", "ksize": [1, 1, 1], "global_pooling": True},
    {"pooling_type": "avg", "ksize": [2, 3, 2], "adaptive": True},
    {"pooling_type": "max", "ksize": [3, 2, 4], "adaptive": True},
], ids=["max_pad", "avg_excl", "avg_incl", "max_ceil", "global",
        "adaptive_avg", "adaptive_max"])
def test_pool3d(attrs):
    check("pool3d", {"X": rand(110, 2, 2, 5, 5, 5)}, attrs, ["Out"],
          wrt=["X"])


@pytest.mark.parametrize("ptype", ["max", "avg"])
def test_adaptive_pool2d(ptype):
    check("pool2d", {"X": rand(111, 2, 3, 7, 5)},
          {"pooling_type": ptype, "ksize": [3, 2], "adaptive": True},
          ["Out"], wrt=["X"])


@pytest.mark.parametrize("attrs", [
    {"ksize": [2, 2], "strides": [2, 2]},
    {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]},
    {"ksize": [2, 2], "global_pooling": True},
], ids=["k2s2", "k3s2p1", "global"])
def test_max_pool2d_with_index(attrs):
    check("max_pool2d_with_index", {"X": rand(112, 2, 2, 5, 5)}, attrs,
          ["Out", "Mask"], wrt=["X"])


def test_max_pool2d_with_index_ties():
    """Integer-valued inputs tie often: the first cell of the window in
    row-major order wins, and the index is flat within each map."""
    x = np.floor(rand(113, 2, 3, 6, 6, lo=0, hi=3))
    out = check("max_pool2d_with_index", {"X": x},
                {"ksize": [3, 3], "strides": [3, 3]}, ["Out", "Mask"])
    mask = out["out_mask_0"]
    win = x[0, 0, :3, :3].reshape(-1)
    k = int(np.argmax(win))
    assert mask[0, 0, 0, 0] == (k // 3) * 6 + k % 3


def test_unpool():
    x = rand(114, 2, 2, 4, 4)
    res = check("max_pool2d_with_index", {"X": x},
                {"ksize": [2, 2], "strides": [2, 2]}, ["Out", "Mask"])
    check("unpool", {"X": res["out_out_0"], "Indices": res["out_mask_0"]},
          {"ksize": [2, 2], "strides": [2, 2]}, ["Out"], wrt=["X"])


@pytest.mark.parametrize("ptype", ["max", "avg"])
def test_spp(ptype):
    check("spp", {"X": rand(115, 2, 3, 5, 7)},
          {"pyramid_height": 3, "pooling_type": ptype}, ["Out"], wrt=["X"])


@pytest.mark.parametrize("scale,ph,pw", [(1.0, 2, 2), (0.5, 3, 2)])
def test_roi_pool(scale, ph, pw):
    """ROIs with fractional corners (rounded half to even once scaled),
    one a single cell, bins of one and of several cells."""
    rois = np.array([[0, 0, 3, 3], [1, 2, 6, 7], [2.5, 1.5, 4.4, 7.6],
                     [7, 7, 7, 7], [0, 0, 7, 7]], np.float32)
    check("roi_pool", {"X": rand(116, 1, 3, 8, 8), "ROIs": rois},
          {"pooled_height": ph, "pooled_width": pw,
           "spatial_scale": scale}, ["Out"], wrt=["X"])


def test_row_conv():
    check("row_conv", {"X": rand(117, 6, 4), "Filter": rand(118, 3, 4)}, {},
          ["Out"], wrt=["X", "Filter"])


# --------------------------------------------------------------------------
# layers builders: the same Program JSON in both packages
def _data(pkg, name, shape, dtype="float32"):
    return pkg.layers.data(name, shape, dtype=dtype)


BUILDERS = {
    "unary_ops": lambda P: [getattr(P.layers, n)(_data(P, "x", [4]))
                            for n in ("exp", "tanh", "log", "gelu", "mish",
                                      "softplus", "cumsum", "abs")],
    "unary_attrs": lambda P: [
        P.layers.leaky_relu(_data(P, "x", [4]), alpha=0.3),
        P.layers.brelu(_data(P, "y", [4]), t_min=1.0, t_max=2.0),
        P.layers.cumsum(_data(P, "z", [4]), axis=1, exclusive=True)],
    "compare_logical": lambda P: [
        P.layers.less_than(_data(P, "x", [4]), _data(P, "y", [4])),
        P.layers.logical_not(P.layers.equal(_data(P, "a", [4]),
                                            _data(P, "b", [4])))],
    "reductions": lambda P: [
        getattr(P.layers, n)(_data(P, "x", [3, 4]), dim=[1], keep_dim=True)
        for n in ("reduce_max", "reduce_min", "reduce_mean",
                  "reduce_prod")] + [P.layers.reduce_max(
                      _data(P, "y", [3]))],
    "tensor": lambda P: [
        P.layers.concat([_data(P, "x", [3]), _data(P, "y", [2])], axis=1),
        P.layers.gather(_data(P, "g", [3]),
                        _data(P, "i", [1], dtype="int32")),
        P.layers.argmax(_data(P, "a", [5]), axis=1),
        P.layers.argmin(_data(P, "b", [5]), axis=1),
        P.layers.slice(_data(P, "s", [6]), [1], [1], [4]),
        P.layers.fill_constant_batch_size_like(_data(P, "f", [2]), [1, 3],
                                               "float32", 0.5),
        P.layers.ones([2], "float32"), P.layers.zeros([2], "int32"),
        P.layers.increment(P.layers.fill_constant([1], "float32", 0.0),
                           in_place=False)],
    "scatter": lambda P: P.layers.scatter(
        _data(P, "x", [3]), _data(P, "i", [1], dtype="int32"),
        _data(P, "u", [3]), overwrite=False),
    "nn": lambda P: [
        P.layers.sigmoid_cross_entropy_with_logits(_data(P, "x", [1]),
                                                   _data(P, "y", [1])),
        P.layers.square_error_cost(_data(P, "p", [1]), _data(P, "q", [1])),
        P.layers.auc(_data(P, "pr", [2]), _data(P, "l", [1], "int64")),
        P.layers.l2_normalize(_data(P, "n", [4]), axis=1),
        P.layers.cos_sim(_data(P, "c1", [4]), _data(P, "c2", [4]))],
    "compat": lambda P: [
        P.layers.Print(_data(P, "x", [2]), message="m"),
        P.layers.mul(_data(P, "a", [3]), _data(P, "b", [3, 2])),
        P.layers.sum([_data(P, "s1", [2]), _data(P, "s2", [2])]),
        P.layers.pad(_data(P, "p", [2]), [0, 0, 1, 1]),
        P.layers.smooth_l1(_data(P, "sx", [3]), _data(P, "sy", [3])),
        P.layers.lrn(_data(P, "img", [6, 3, 3])),
        P.layers.uniform_random_batch_size_like(_data(P, "r", [2]), [1, 3]),
        P.layers.gaussian_random_batch_size_like(_data(P, "r2", [2]),
                                                 [1, 3]),
        P.layers.nce(_data(P, "e", [4]), _data(P, "lab", [1], "int64"),
                     num_total_classes=7, num_neg_samples=2)],
    "conv": lambda P: [
        P.layers.conv3d(_data(P, "v", [2, 4, 4, 4]), 3, 2),
        P.layers.conv2d_transpose(_data(P, "i", [2, 4, 4]), 3,
                                  filter_size=3, stride=2),
        P.layers.conv3d_transpose(_data(P, "v2", [2, 3, 3, 3]), 2,
                                  filter_size=2),
        P.layers.pool3d(_data(P, "v3", [2, 4, 4, 4]), pool_size=2,
                        pool_stride=2),
        P.layers.spp(_data(P, "i2", [2, 4, 4]), pyramid_height=2),
        P.layers.roi_pool(_data(P, "i3", [2, 4, 4]),
                          _data(P, "rois", [4]), 2, 2),
        P.layers.row_conv(_data(P, "seq", [4]), future_context_size=2)],
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builders_emit_the_jax_program(name):
    def program(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            BUILDERS[name](pkg)
        return main, startup
    (jm, js), (tm, ts) = program(jfluid), program(tfluid)
    assert tm.to_json() == jm.to_json()
    assert ts.to_json() == js.to_json()


# --------------------------------------------------------------------------
# learning-rate schedules
SCHEDULES = {
    "exponential_decay": lambda L: L.exponential_decay(0.1, 2, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(
        0.1, 2, 0.5, staircase=True),
    "natural_exp_decay": lambda L: L.natural_exp_decay(0.1, 3, 0.4),
    "inverse_time_decay": lambda L: L.inverse_time_decay(
        0.1, 2, 0.5, staircase=True),
    "polynomial_decay": lambda L: L.polynomial_decay(0.1, 3, 0.01,
                                                     power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(0.1, 2, cycle=True),
    "piecewise_decay": lambda L: L.piecewise_decay([1, 3], [0.3, 0.2, 0.1]),
    "noam_decay": lambda L: L.noam_decay(16, 2),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_five_steps(name):
    """The schedule's Program as the JAX package's, and its value over 5
    executed steps (the counter advances once a step)."""
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            lr = SCHEDULES[name](pkg.layers)
        return main, startup, lr
    jm, js, jlr = build(jfluid)
    tm, ts, tlr = build(tfluid)
    assert tm.to_json() == jm.to_json()
    assert ts.to_json() == js.to_json()
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    texe.run(ts, scope=tscope)
    got, want = [], []
    for _ in range(5):
        with jfluid.scope_guard(jscope):
            want.append(np.asarray(jexe.run(jm, fetch_list=[jlr])[0]))
        got.append(texe.run(tm, fetch_list=[tlr], scope=tscope)[0])
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-6)
    assert len({float(np.ravel(v)[0]) for v in got}) > 1 or \
        name == "piecewise_decay"


# --------------------------------------------------------------------------
# registry completeness: the port's op types are the JAX package's, less
# an explicit list, each with the ROADMAP.md queue 1 item it waits for
STILL_MISSING = {
    # the transform pipeline's fused ops (item 11)
    "fused_matmul_bias_act": 11, "fused_scale_cast": 11,
}


def test_registry_is_the_jax_one_less_the_listed():
    import paddle_tpu.distributed.ops  # noqa: F401  (registers its ops)
    import paddle_tpu.parallel.collective  # noqa: F401
    import paddle_tpu.transform.fusion  # noqa: F401
    jops = set(jregistry.registered_ops())
    tops = set(tregistry.registered_ops())
    assert tops <= jops, sorted(tops - jops)
    assert len(STILL_MISSING) == 2
    assert jops - tops == set(STILL_MISSING), (
        sorted((jops - tops) - set(STILL_MISSING)),
        sorted(set(STILL_MISSING) - (jops - tops)))
    assert len(tops) == 236


# the port's op types before the dense op library and the SelectedRows
# host ops were added
BEFORE = {
    "accuracy", "adadelta", "adagrad", "adam", "adamax", "assign_value",
    "average_accumulates", "batch_norm", "beam_search", "beam_search_decode",
    "cast", "clip", "clip_by_norm", "conv2d", "cross_entropy",
    "decayed_adagrad", "dropout", "elementwise_add", "elementwise_div",
    "elementwise_floordiv", "elementwise_max", "elementwise_min",
    "elementwise_mod", "elementwise_mul", "elementwise_pow",
    "elementwise_sub", "expand", "fill_constant", "ftrl", "gaussian_random",
    "label_smooth", "layer_norm", "lookup_table", "matmul", "mean",
    "momentum", "mul", "one_hot", "pool2d", "proximal_adagrad",
    "proximal_gd", "recompute_block", "reduce_sum", "relu", "reshape",
    "reshape2", "rmsprop", "scale", "sgd", "sigmoid", "sign", "softmax",
    "softmax_with_cross_entropy", "sp_attention", "split", "sqrt", "square",
    "sum", "top_k", "transpose", "transpose2", "truncated_gaussian_random",
    "uniform_random",
}


def test_card_sweep_covers_every_added_op_on_the_cpu():
    """``tools/op_sweep.py`` (chip_smoke.py phases 14 (c), 15 (c), 16 (d)
    and 19 (a)) holds one case or more of each of the 167 added op types:
    the 112 of the op library, the 32 of the LoD, sequence, RNN and
    control-flow slice, the 14 of CRF, CTC and detection and the 9 of the
    parallel tier; here it runs against the CPU itself, so every case
    must run and agree. The six wire ops need live servers: they are
    held by tests/test_torch_pserver.py and chip_smoke.py phase 20, not
    by the sweep."""
    from paddle_tpu_torch.tools import op_sweep
    held, worst = op_sweep.run("cpu")
    held_lod, worst_lod = op_sweep.run("cpu", part="lod")
    held_det, worst_det = op_sweep.run("cpu", part="detection")
    held_par, worst_par = op_sweep.run("cpu", part="parallel")
    wire = {"send", "send_barrier", "send_sparse", "recv", "prefetch",
            "listen_and_serv"}
    assert wire <= set(tregistry.registered_ops())
    added = set(tregistry.registered_ops()) - BEFORE - wire
    assert len(BEFORE) == 63 and len(added) == 167
    assert len(held) == 112 and len(held_lod) == 32 and len(held_det) == 14
    assert len(held_par) == 9
    every = held | held_lod | held_det | held_par
    assert every == added, (sorted(added - every), sorted(every - added))
    assert worst == 0.0 and worst_lod == 0.0 and worst_det == 0.0
    assert worst_par == 0.0
