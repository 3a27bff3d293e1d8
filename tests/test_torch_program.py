"""The port's Program IR against the JAX package's.

Programs are the interchange between the two packages: the flagship
``transformer_lm`` built through each package's ``layers`` (packed and
unpacked, with ``SGD`` or ``Adam.minimize``) under ``unique_name.guard()``
must serialize to the same JSON, main and startup programs alike, and a
Program the JAX package serialized must load and run in the port.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import transformer as JT
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.models import transformer as TT

SMALL = dict(vocab_size=64, max_len=16, n_layer=2, n_head=2, d_model=32,
             d_inner=64)


def build(fluid, T, packed, opt="adam"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        avg_cost, _ = T.transformer_lm(packed=packed, **SMALL)
        if opt == "adam":
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
        else:
            fluid.optimizer.SGD(learning_rate=0.1).minimize(avg_cost)
    return main, startup, avg_cost


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_to_json_identical(packed, opt):
    jmain, jstart, _ = build(jfluid, JT, packed, opt)
    tmain, tstart, _ = build(tfluid, TT, packed, opt)
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    ops = [op.type for op in tmain.global_block().ops]
    assert (ops.count("sp_attention") == SMALL["n_layer"]) is packed
    assert ops.count("backward_marker") == 1
    assert ops.count(opt) == len(tmain.global_block().all_parameters()) - 1


def test_json_round_trip_is_stable():
    tmain, tstart, _ = build(tfluid, TT, True)
    for prog in (tmain, tstart):
        text = prog.to_json()
        assert tfluid.Program.from_json(text).to_json() == text


def test_packed_and_unpacked_share_their_state():
    """The two forms create the same persistable variables, so one
    startup scope serves both (chip_smoke.py compares them on the card
    from one scope)."""
    def state(prog):
        return sorted(v.name for v in prog.global_block().vars.values()
                      if v.persistable)
    pmain, pstart, _ = build(tfluid, TT, True)
    umain, ustart, _ = build(tfluid, TT, False)
    assert state(pmain) == state(umain)
    assert pstart.to_json() == ustart.to_json()


def test_jax_program_runs_on_the_port():
    """A JAX-built packed Adam program, loaded with the port's
    ``Program.from_json``, trains in the port exactly as the port's own
    build of the same model does."""
    jmain, jstart, javg = build(jfluid, JT, True)
    main = tfluid.Program.from_json(jmain.to_json())
    startup = tfluid.Program.from_json(jstart.to_json())
    own_main, _, own_avg = build(tfluid, TT, True)
    assert own_avg.name == javg.name
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    init = {n: scope.get_numpy(n) for n in scope.local_var_names()}
    assert "lm_word_emb" in init and len(init) > 10
    batch = JT.make_lm_batch(np.random.RandomState(0), 4, 16, 64)
    losses = {}
    for name, prog in (("loaded", main), ("own", own_main)):
        s = tfluid.Scope()
        tfluid.load_numpy_state(s, init, "cpu")
        losses[name] = [float(exe.run(prog, feed=batch,
                                      fetch_list=[javg.name], scope=s)[0])
                        for _ in range(2)]
    assert np.isfinite(losses["loaded"]).all()
    assert losses["loaded"] == losses["own"]
    assert losses["loaded"][1] < losses["loaded"][0]


def test_unregistered_op_raises_with_registry_size():
    prog = tfluid.Program()
    blk = prog.global_block()
    blk.create_var(name="x", shape=(2,), dtype="float32")
    blk.create_var(name="y", shape=(2,), dtype="float32")
    blk.append_op(type="frobnicate", inputs={"X": ["x"]},
                  outputs={"Out": ["y"]})
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(NotImplementedError,
                       match=r"'frobnicate'.*registered: \d+ ops"):
        exe.run(prog, feed={"x": np.ones(2, np.float32)},
                fetch_list=["y"], scope=tfluid.Scope())


def test_lowering_error_names_the_op():
    prog = tfluid.Program()
    with tfluid.program_guard(prog, tfluid.Program()):
        x = tfluid.layers.data("x", [6])
        tfluid.layers.reshape(x, [-1, 4])
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(EnforceError, match=r"lowering of op 'reshape'"):
        exe.run(prog, feed={"x": np.ones((1, 6), np.float32)},
                scope=tfluid.Scope())


def test_feeds_narrow_like_the_jax_package():
    """64-bit feeds run as 32-bit (the JAX package's runtime_dtype)."""
    prog = tfluid.Program()
    with tfluid.program_guard(prog, tfluid.Program()):
        x = tfluid.layers.data("x", [3], dtype="int64")
        y = tfluid.layers.scale(x, 2.0)
    out, = tfluid.Executor(tfluid.CPUPlace()).run(
        prog, feed={"x": np.arange(3, dtype=np.int64)[None]},
        fetch_list=[y], scope=tfluid.Scope(), return_numpy=False)
    assert isinstance(out, torch.Tensor)
    assert out.dtype == torch.float32 and out.tolist() == [[0., 2., 4.]]
    assert tfluid.core.program.runtime_dtype("int64") == "int32"
