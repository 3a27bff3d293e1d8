"""The fused ops (``paddle_tpu_torch/ops/fused.py``) against the unfused
chains in the port and against the JAX package.

Each case builds a small chain with the layers DSL (an fc, a conv, a
matmul with a bias, a cast/scale pair, ...), its mean as the loss and
``gradients`` of the loss with respect to every parameter; the fusion
pass (``transform.FusionPass``) rewrites the chain into the fused op.
Pinned, on numpy-seeded inputs and one startup scope:

  * the fused program computes the chain's output, loss and gradients
    BITWISE equal to the unfused program in the port (the fused op
    replays the component lowerings: the same torch calls in the same
    order, the same autograd graph);
  * the port's fused program agrees with the JAX package's fused
    program within rtol 1e-5 (forward and gradients), and both
    packages fuse the chain to the same Program JSON;
  * ``FUSABLE_ANCHORS`` and ``fusable_act_types()`` are the JAX
    package's.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.ops import fused as jfused
from paddle_tpu.transform import FusionPass as JFusion
from paddle_tpu.transform import PassManager as JPassManager
from paddle_tpu_torch.ops import fused as tfused
from paddle_tpu_torch.transform import FusionPass, PassManager


def _fc(act):
    def build(fluid):
        x = fluid.layers.data("x", [12])
        return fluid.layers.fc(x, 6, act=act), {"x": (5, 12)}
    return build


def _conv(act, depthwise=False):
    def build(fluid):
        x = fluid.layers.data("x", [4, 6, 6])
        if depthwise:
            out = fluid.layers.conv2d(x, num_filters=4, filter_size=3,
                                      padding=1, groups=4, act=act)
        else:
            out = fluid.layers.conv2d(x, num_filters=5, filter_size=3,
                                      padding=1, act=act)
        return out, {"x": (2, 4, 6, 6)}
    return build


def _matmul(fluid):
    x = fluid.layers.data("x", [3, 8])
    w = fluid.layers.create_parameter([8, 7], "float32", name="mm_w")
    b = fluid.layers.create_parameter([7], "float32", name="mm_b")
    mm = fluid.layers.matmul(x, w, alpha=0.5)
    return fluid.layers.tanh(fluid.layers.elementwise_add(mm, b)), \
        {"x": (2, 3, 8)}


def _scale_cast(fluid):
    x = fluid.layers.data("x", [6])
    h = fluid.layers.fc(x, 6, bias_attr=False)
    c = fluid.layers.cast(h, "float32")
    return fluid.layers.scale(c, 0.5, bias=1.0), {"x": (4, 6)}


CASES = {
    "fc": (_fc(None), "matmul_bias"),
    "fc_relu": (_fc("relu"), "matmul_bias_act"),
    "fc_softmax": (_fc("softmax"), "matmul_bias_act"),
    "fc_sigmoid": (_fc("sigmoid"), "matmul_bias_act"),
    "conv_relu": (_conv("relu"), "matmul_bias_act"),
    "conv": (_conv(None), "matmul_bias"),
    "depthwise_tanh": (_conv("tanh", depthwise=True), "matmul_bias_act"),
    "matmul_tanh": (_matmul, "matmul_bias_act"),
    "scale_cast": (_scale_cast, "scale_cast"),
}


def _staged(fluid, build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out, shapes = build(fluid)
        loss = fluid.layers.mean(out)
        params = [p for p in main.global_block().all_parameters()]
        grads = fluid.gradients(loss, params)
    fetch = [out.name, loss.name] + [g.name for g in grads]
    return main, startup, fetch, shapes


def _feed(shapes):
    rng = np.random.RandomState(7)
    return {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}


def _port_run(prog, fetch, init, feed):
    scope = tfluid.Scope()
    tfluid.load_numpy_state(scope, init, "cpu")
    return tfluid.Executor(tfluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=fetch, scope=scope)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_op_is_the_chain_bitwise_and_the_jax_one(case):
    build, pattern = CASES[case]
    tmain, _, fetch, shapes = _staged(tfluid, build)
    jmain, jstart, jfetch, _ = _staged(jfluid, build)
    assert tmain.to_json() == jmain.to_json()
    tres = PassManager([FusionPass()]).run(tmain, keep=fetch)
    jres = JPassManager([JFusion()]).run(jmain, keep=jfetch)
    assert tres.patterns[pattern] == 1, tres.patterns
    assert tres.program.to_json() == jres.program.to_json()
    fused_type = "fused_scale_cast" if pattern == "scale_cast" \
        else "fused_matmul_bias_act"
    assert fused_type in [op.type for op in
                          tres.program.global_block().ops]

    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
    init = {v.name: np.asarray(jscope.find_var(v.name))
            for v in jmain.list_vars()
            if v.persistable and jscope.find_var(v.name) is not None}
    feed = _feed(shapes)
    chain = _port_run(tmain, fetch, init, feed)
    fused = _port_run(tres.program, fetch, init, feed)
    for name, a, b in zip(fetch, chain, fused):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    with jfluid.scope_guard(jscope):
        want = jexe.run(jres.program, feed=feed, fetch_list=jfetch)
    for name, a, b in zip(fetch, fused, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_fusion_tables_are_the_jax_ones():
    assert tfused.FUSABLE_ANCHORS == jfused.FUSABLE_ANCHORS
    assert tfused.fusable_act_types() == jfused.fusable_act_types()
    assert tfused.FUSED_OP_TYPES == jfused.FUSED_OP_TYPES
