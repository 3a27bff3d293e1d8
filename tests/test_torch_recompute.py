"""Rematerialization in the PyTorch port: ``layers.recompute`` regions and
``append_backward(checkpoint=True)``, mirroring tests/test_recompute.py.

The contract is the JAX package's: a region (or the checkpointed whole
forward) changes WHEN activations are computed, never what. Inside the
port that holds bitwise (one CPU thread: PyTorch reduces in thread order
otherwise). Against the JAX package, on the JAX startup scope copied in
with ``load_numpy_state``: the loss at rtol 1e-5 (the same fp32 ops
summed in another order) and the gradients at rtol 1e-4 / atol 1e-6, the
JAX package's own region-against-plain bounds; 3 Adam steps of the
flagship's flash configuration at 2e-4 of max(1, max|w|) per tensor,
the reference's multi-step bound (``__graft_entry__.py:154``). Everything
runs on the CPU; ``chip_smoke.py`` runs the full-width model on the card.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import transformer as JT
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.ops import flash_attention as TF
from paddle_tpu_torch.ops import parallel_ops as TP

CFG = dict(vocab_size=64, max_len=16, n_layer=2, n_head=4, d_model=32,
           d_inner=64)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(fluid, T, recompute=False, checkpoint=False, opt=None, **kw):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        cost, _ = T.transformer_lm(packed=True, recompute=recompute,
                                   **dict(CFG, **kw))
        if opt:
            fluid.optimizer.Adam(1e-3).minimize(cost)
            pg = []
        else:
            pg = fluid.append_backward(cost, checkpoint=checkpoint)
    return main, startup, cost, [g.name for _, g in pg]


def _jax_state(startup):
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
    return scope, {n: np.asarray(scope.find_var(n))
                   for n in scope.local_var_names()
                   if scope.find_var(n) is not None}


def _port_scope(state):
    scope = tfluid.Scope()
    tfluid.load_numpy_state(scope, state, "cpu")
    return scope


def _feed(seed=0):
    return TT.make_lm_batch(np.random.RandomState(seed), 4, 16, 64)


def _port_run(state, fetch, **kw):
    main, _, cost, _ = _build(tfluid, TT, **kw)
    return tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=_feed(), fetch_list=[cost.name] + fetch,
        scope=_port_scope(state))


@pytest.mark.parametrize("how", ["region", "checkpoint"])
def test_matches_plain_bitwise_and_jax(one_thread, how):
    kw = {"recompute": True} if how == "region" else {"checkpoint": True}
    jmain, jstart, jcost, grads = _build(jfluid, JT, **kw)
    jscope, state = _jax_state(jstart)
    fetch = [jcost.name] + grads
    with jfluid.scope_guard(jscope):
        ref = jfluid.Executor(jfluid.CPUPlace()).run(
            jmain, feed=_feed(), fetch_list=fetch)
    plain = _port_run(state, grads)
    got = _port_run(state, grads, **kw)
    assert len(got) == len(plain) == len(fetch) > 3
    for name, a, b in zip(fetch, got, plain):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), rtol=1e-5)
    for name, a, b in zip(fetch[1:], got[1:], ref[1:]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_flash_configuration_three_adam_steps_match_jax():
    """transformer_lm(packed=True, recompute=True, label_smooth_eps=0.1)
    with Adam(1e-3): 3 steps against the JAX package."""
    kw = dict(recompute=True, label_smooth_eps=0.1, opt="adam")
    jmain, jstart, jcost, _ = _build(jfluid, JT, **kw)
    tmain, _, tcost, _ = _build(tfluid, TT, **kw)
    jscope, state = _jax_state(jstart)
    tscope = _port_scope(state)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    for i in range(3):
        feed = _feed(10 + i)
        with jfluid.scope_guard(jscope):
            ref, = jexe.run(jmain, feed=feed, fetch_list=[jcost])
        got, = texe.run(tmain, feed=feed, fetch_list=[tcost], scope=tscope)
        assert abs(float(got) - float(ref)) <= 2e-4 * max(1.0, abs(ref))
    for n in state:
        jw = np.asarray(jscope.find_var(n))
        tw = tscope.get_numpy(n)
        assert np.abs(tw - jw).max() <= 2e-4 * max(1.0, np.abs(jw).max()), n


@pytest.mark.parametrize("kw", [
    dict(recompute=True, dropout_rate=0.1, label_smooth_eps=0.1),
    dict(recompute=True, label_smooth_eps=0.1),
    dict(dropout_rate=0.1, packed=False),
], ids=["all_three", "flash_config", "dropout_unpacked"])
def test_program_json_identical(kw):
    def build(fluid, T):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            cost, _ = T.transformer_lm(**dict(dict(CFG, packed=True), **kw))
            fluid.optimizer.Adam(1e-3).minimize(cost)
        return main, startup

    jmain, jstart = build(jfluid, JT)
    tmain, tstart = build(tfluid, TT)
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    if kw.get("recompute"):
        assert sum(op.type == "recompute_block"
                   for op in tmain.global_block().ops) == CFG["n_layer"]


def test_region_output_fetchable_and_checkpoint_intermediate_raises():
    """A region's terminal output (the last layer's) can be fetched; a
    forward intermediate under checkpoint=True cannot, as in the JAX
    package (only targets, persistables and optimizer reads survive)."""
    _, jstart, _, _ = _build(jfluid, JT)
    _, state = _jax_state(jstart)
    main, _, cost, grads = _build(tfluid, TT, recompute=True)
    last = main.global_block().ops
    region = [op for op in last if op.type == "recompute_block"][-1]
    terminal = [n for n in region.output("Out")
                if any(n in op.input_names for op in
                       last[last.index(region) + 1:])]
    assert terminal
    # a value no later op reads leaves the region when it is fetched
    inner = region.output("Out")[0]
    assert inner not in terminal
    exe = tfluid.Executor(tfluid.CPUPlace())
    out = exe.run(main, feed=_feed(), fetch_list=terminal + [inner],
                  scope=_port_scope(state))
    assert out[0].shape == (4, 16, CFG["d_model"])
    plain, _, _, _ = _build(tfluid, TT)
    ref = exe.run(plain, feed=_feed(), fetch_list=terminal + [inner],
                  scope=_port_scope(state))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)

    ckpt, _, _, _ = _build(tfluid, TT, checkpoint=True)
    with pytest.raises(KeyError, match="fetch var"):
        exe.run(ckpt, feed=_feed(), fetch_list=[inner],
                scope=_port_scope(state))


def test_flash_lowering_runs_twice_a_layer_under_recompute(monkeypatch):
    """The sp_attention lowering runs 2 x n_layer times a step with
    recompute regions (forward and recompute) and n_layer times without;
    on the CPU it takes the plain version, so it is counted by wrapping
    the flash entry point the lowering calls."""
    calls = []
    real = TF.flash_attention

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(TP, "flash_attention", counted)
    _, jstart, _, _ = _build(jfluid, JT, opt="adam")
    _, state = _jax_state(jstart)
    for recompute, want in ((True, 2), (False, 1)):
        calls.clear()
        main, _, cost, _ = _build(tfluid, TT, recompute=recompute,
                                  opt="adam")
        tfluid.Executor(tfluid.CPUPlace()).run(
            main, feed=_feed(), fetch_list=[cost],
            scope=_port_scope(state))
        assert len(calls) == want * CFG["n_layer"], (recompute, calls)
