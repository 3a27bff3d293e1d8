"""Megastep in the PyTorch port: ``Executor.run_steps`` and
``serving.Engine(megastep=K)`` against K sequential steps and against
the JAX package.

On the card both capture K step bodies into one CUDA graph and replay
it; on the CPU, where these tests run, the same bodies run in a loop
over the same static buffers (staged feeds, state tensors updated in
place, fetch rows copied out). So the contract pinned here is the one
the graph runs:

  * ``run_steps`` for K in {1, 2, 4} is bitwise equal to 4 sequential
    ``run()`` calls, in fetches and in every scope tensor (the LM with
    SGD and with Adam, ResNet-CIFAR-8 with ``fuse_conv_bn`` on), after
    ``tests/test_megastep.py``; and it matches the JAX package's
    ``run_steps(K=4)`` from the same copied scope at 2e-4 of max(1,
    max|w|) per tensor (the reference's multi-step bound,
    ``__graft_entry__.py:154``; fp32 summed in other orders);
  * ``Engine(megastep=4)`` gives the tokens of ``megastep=1``, of
    ``sequential_generate`` and of the JAX package's megastep engine;
  * the masked pool write leaves masked entries bitwise unchanged;
  * neither the engine's decode bodies (greedy and sampled, the
    speculative scoring step, the truncated drafter) nor a ``run_steps``
    body reads a device value back to the host (the calls that would
    are patched to raise), so a capture on the card cannot fail for
    that.
"""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import serving as jserving
from paddle_tpu.models import resnet as JR
from paddle_tpu.models import transformer as JT
from paddle_tpu.models.transformer_infer import (
    TransformerLMInfer as JaxLM, extract_params)
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import serving
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.models import resnet as TR
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.models.transformer_infer import TransformerLMInfer
from paddle_tpu_torch.ops import matmul_stats as TMS
from paddle_tpu_torch.ops import paged_attention as TPA
from paddle_tpu_torch.serving.spec import NgramDrafter

LM = dict(vocab_size=128, max_len=16, n_layer=2, n_head=2, d_model=64,
          d_inner=128)
STEPS = 4


def _lm(fluid, T, opt):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        avg, _ = T.transformer_lm(packed=True, **LM)
        if opt == "adam":
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg)
        else:
            fluid.optimizer.SGD(learning_rate=0.1).minimize(avg)
    feeds = [JT.make_lm_batch(np.random.RandomState(10 + i), 4, 16, 128)
             for i in range(STEPS)]
    return main, startup, [avg], feeds


def _cifar(fluid, R):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        build, make = R.zoo_spec()
        avg, acc = build()
    feeds = [make(np.random.RandomState(20 + i)) for i in range(STEPS)]
    return main, startup, [avg, acc], feeds


def _programs(model):
    """(port program, JAX program): (main, startup, fetch vars, feeds)."""
    if model == "cifar8_fused":
        return _cifar(tfluid, TR), _cifar(jfluid, JR)
    opt = model.split("_")[1]
    return _lm(tfluid, TT, opt), _lm(jfluid, JT, opt)


def _jax_start(startup):
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


def _weights(scope, names):
    return {n: scope.get_numpy(n) for n in names}


@pytest.fixture
def fused(monkeypatch):
    """fuse_conv_bn on, and the fused route's calls counted."""
    monkeypatch.setenv("PADDLE_TPU_FUSE_CONV_BN", "1")
    calls = []
    real = TMS.matmul_colstats

    def counted(*args):
        calls.append(1)
        return real(*args)
    monkeypatch.setattr(TMS, "matmul_colstats", counted)
    return calls


MODELS = ["lm_sgd", "lm_adam", "cifar8_fused"]


# -- Executor.run_steps ----------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("model", MODELS)
def test_run_steps_bitwise_equal_to_sequential(model, k, fused):
    (main, startup, fetch, feeds), _ = _programs(model)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope0 = tfluid.Scope()
    exe.run(startup, scope=scope0)
    init = {n: scope0.get_numpy(n) for n in scope0.local_var_names()
            if scope0.find_var(n) is not None}
    # a parameter fetched beside the losses: read after its update
    fetch = fetch + [main.global_block().all_parameters()[0].name]
    seq_scope = _port_scope(init)
    seq = [exe.run(main, feed=f, fetch_list=fetch, scope=seq_scope)
           for f in feeds]
    n_seq = len(fused)
    mega_scope = _port_scope(init)
    mega_exe = tfluid.Executor(tfluid.CPUPlace())
    got = []
    for i in range(0, STEPS, k):
        out = mega_exe.run_steps(main, feeds=feeds[i:i + k],
                                 fetch_list=fetch, scope=mega_scope)
        assert len(out) == k
        got += out
    assert mega_exe._rng_counter == STEPS
    assert mega_exe.stats["megastep_dispatches"] == STEPS // k
    for i, (a, b) in enumerate(zip(seq, got)):
        for x, y in zip(a, b):
            assert x.shape == y.shape and x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg="step %d" % i)
    w_seq, w_mega = _weights(seq_scope, init), _weights(mega_scope, init)
    for n in init:
        np.testing.assert_array_equal(w_mega[n], w_seq[n], err_msg=n)
    if model == "cifar8_fused":
        assert n_seq > 0 and len(fused) == 2 * n_seq   # the fused route


@pytest.mark.parametrize("model", MODELS)
def test_run_steps_matches_jax(model, fused):
    (tmain, _, tfetch, feeds), (jmain, jstart, jfetch, _) = \
        _programs(model)
    jscope, state = _jax_start(jstart)
    with jfluid.scope_guard(jscope):
        ref = jfluid.Executor(jfluid.CPUPlace()).run_steps(
            jmain, feeds=feeds, fetch_list=jfetch)
    tscope = _port_scope(state)
    got = tfluid.Executor(tfluid.CPUPlace()).run_steps(
        tmain, feeds=feeds, fetch_list=tfetch, scope=tscope)
    for i, (a, b) in enumerate(zip(got, ref)):
        loss, want = float(a[0]), float(np.asarray(b[0]))
        assert abs(loss - want) <= 2e-4 * max(1.0, abs(want)), (i, loss,
                                                                 want)
    names = state
    if model == "cifar8_fused":
        # weights and BN running statistics, as test_torch_resnet.py
        # holds them: a velocity is a raw gradient sum, where one ReLU
        # input within rounding of 0 in one package and not the other
        # moves a whole element's share (5.8e-4 after one step here,
        # through run() alike)
        names = [p.name for p in tmain.global_block().all_parameters()]
    for n in names:
        w, jw = tscope.get_numpy(n), np.asarray(jscope.find_var(n))
        scale = max(1.0, float(np.abs(jw).max()))
        assert float(np.abs(w - jw).max()) <= 2e-4 * scale, n


def _small():
    (main, startup, fetch, feeds), _ = _programs("lm_sgd")
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    return exe, main, startup, fetch, feeds, scope


def _odd_feeds(feeds):
    odd = dict(feeds[1])
    odd["src"] = odd["src"][:2]
    return [feeds[0], odd]


@pytest.mark.parametrize("case, match", [
    ("mixed signatures", "ONE step signature"),
    ("k mismatch", "k=3 but 2"),
    ("k < 1", "k >= 1"),
    ("pre-stacked without k", "k="),
    ("pre-stacked leading dim", "leading dim k=3"),
])
def test_run_steps_argument_checks(case, match):
    exe, main, _, fetch, feeds, scope = _small()
    args = {"mixed signatures": dict(feeds=_odd_feeds(feeds)),
            "k mismatch": dict(feeds=feeds[:2], k=3),
            "k < 1": dict(feeds=[]),
            "pre-stacked without k": dict(
                feeds={n: np.stack([f[n] for f in feeds[:2]])
                       for n in feeds[0]}),
            "pre-stacked leading dim": dict(
                feeds={n: np.stack([f[n] for f in feeds[:2]])
                       for n in feeds[0]}, k=3)}[case]
    counter = exe._rng_counter
    with pytest.raises(ValueError, match=match):
        exe.run_steps(main, fetch_list=fetch, scope=scope, **args)
    assert exe._rng_counter == counter


def test_run_steps_prestacked_equals_list():
    exe, main, startup, fetch, feeds, scope = _small()
    other = tfluid.Scope()
    exe.run(startup, scope=other)
    for n in scope.local_var_names():
        other.set(n, scope.find_var(n).clone())
    a = exe.run_steps(main, feeds=feeds[:2], fetch_list=fetch, scope=scope)
    b = exe.run_steps(main, feeds={n: np.stack([f[n] for f in feeds[:2]])
                                   for n in feeds[0]}, k=2,
                      fetch_list=fetch, scope=other)
    np.testing.assert_array_equal([x[0] for x in a], [x[0] for x in b])


@pytest.mark.parametrize("case", ["host op", "new persistables"])
def test_run_steps_refuses(case):
    exe, main, startup, fetch, feeds, scope = _small()
    if case == "host op":
        prog = tfluid.Program()
        prog.global_block().append_op(type="send", inputs={}, outputs={})
        with pytest.raises(NotImplementedError, match="host \\(IO\\) ops"):
            exe.run_steps(prog, feeds=[{}], scope=tfluid.Scope())
    else:
        with pytest.raises(ValueError, match="new persistable"):
            exe.run_steps(startup, feeds=[{}], scope=tfluid.Scope())


@pytest.mark.parametrize("window", [1, 2])
def test_run_steps_return_tensors_and_window(window):
    """return_numpy=False hands back tensors; the in-flight window holds
    at most ``megastep_inflight`` dispatches and does not change
    results."""
    vals = {}
    for w in (window, 3 - window):
        tflags.set_flag("megastep_inflight", w)
        try:
            exe, main, _, fetch, feeds, scope = _small()
            flat = []
            for i in range(0, STEPS, 2):
                out = exe.run_steps(main, feeds=feeds[i:i + 2],
                                    fetch_list=fetch, scope=scope,
                                    return_numpy=False)
                flat += [v for (v,) in out]
            assert len(exe._inflight) == min(w, 2)
            assert all(isinstance(v, torch.Tensor) for v in flat)
            vals[w] = [v.numpy() for v in flat]
        finally:
            tflags.set_flag("megastep_inflight", None)
    np.testing.assert_array_equal(vals[1], vals[2])


def test_run_steps_rebinds_scopes():
    """Two scopes take turns on one cached megastep, with run() calls
    between: each ends bitwise where its own sequential run() calls
    end (a scope tensor replaced since is copied in; the state is never
    shared)."""
    exe, main, startup, fetch, feeds, scope = _small()
    init = {n: scope.get_numpy(n) for n in scope.local_var_names()}
    ref_scope = _port_scope(init)
    for f in feeds:
        exe.run(main, feed=f, fetch_list=fetch, scope=ref_scope)
    a, b = _port_scope(init), _port_scope(init)
    exe.run_steps(main, feeds=feeds[:2], fetch_list=fetch, scope=a)
    exe.run_steps(main, feeds=feeds[:2], fetch_list=fetch, scope=b)
    exe.run(main, feed=feeds[2], fetch_list=fetch, scope=a)
    exe.run_steps(main, feeds=feeds[2:3], fetch_list=fetch, scope=b)
    exe.run(main, feed=feeds[3], fetch_list=fetch, scope=b)
    exe.run_steps(main, feeds=feeds[3:4], fetch_list=fetch, scope=a)
    assert len(exe._megasteps) == 2               # K = 2 and K = 1
    for s in (a, b):
        for n in init:
            np.testing.assert_array_equal(s.get_numpy(n),
                                          ref_scope.get_numpy(n),
                                          err_msg=n)


def test_run_steps_advances_rng_counter_by_k():
    """K draws of run_steps are the draws of K run() calls, and the run()
    after them draws as the (K+1)-th call would."""
    prog = tfluid.Program()
    prog.random_seed = 5
    blk = prog.global_block()
    blk.create_var(name="r", shape=[6], dtype="float32")
    blk.append_op(type="uniform_random", inputs={}, outputs={"Out": ["r"]},
                  attrs={"shape": [6], "min": -1.0, "max": 1.0,
                         "dtype": "float32"})
    seq_exe = tfluid.Executor(tfluid.CPUPlace())
    seq = [seq_exe.run(prog, fetch_list=["r"], scope=tfluid.Scope())[0]
           for _ in range(4)]
    exe = tfluid.Executor(tfluid.CPUPlace())
    got = [o[0] for o in exe.run_steps(prog, feeds=[{}] * 3,
                                       fetch_list=["r"],
                                       scope=tfluid.Scope())]
    assert exe._rng_counter == 3
    got.append(exe.run(prog, fetch_list=["r"], scope=tfluid.Scope())[0])
    np.testing.assert_array_equal(got, seq)
    assert not np.array_equal(seq[0], seq[1])


# -- Engine(megastep=K) ----------------------------------------------------

SV = dict(vocab=64, max_len=48, n_layer=2, n_head=2, d_model=32, d_inner=64)


@pytest.fixture(scope="module")
def lms():
    """(JAX model, port model) on one set of JAX-initialized weights,
    end_id 2 (natural EOS retirement)."""
    main, startup = jfluid.Program(), jfluid.Program()
    scope = jfluid.Scope()
    with jfluid.program_guard(main, startup), jfluid.scope_guard(scope):
        JT.transformer_lm(vocab_size=SV["vocab"], max_len=SV["max_len"],
                          n_layer=SV["n_layer"], n_head=SV["n_head"],
                          d_model=SV["d_model"], d_inner=SV["d_inner"])
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        stream = [(role, [np.asarray(a) for a in arrays])
                  for role, arrays in extract_params(main, scope)]
        jlm = JaxLM(main, scope, SV["n_layer"], SV["n_head"],
                    SV["d_model"], SV["max_len"])
    tlm = TransformerLMInfer.from_stream(
        stream, SV["n_layer"], SV["n_head"], SV["d_model"], SV["max_len"],
        device="cpu")
    return jlm, tlm


def _requests(seed, n):
    rng = np.random.default_rng(seed)
    return [([1] + rng.integers(3, SV["vocab"],
                                int(rng.integers(0, 12))).tolist(),
             int(rng.integers(5, 19))) for _ in range(n)]


def _serve(model, reqs, **kw):
    with serving.Engine(model, slots=2, prefill_chunk=4, device="cpu",
                        **kw) as eng:
        eng.warmup()
        out = eng.generate_many([p for p, _ in reqs], [m for _, m in reqs])
        return out, dict(eng.stats)


def test_engine_megastep_token_identical(lms):
    jlm, tlm = lms
    reqs = _requests(0, 6)
    one, s1 = _serve(tlm, reqs)
    four, s4 = _serve(tlm, reqs, megastep=4)
    with jserving.Engine(jlm, slots=2, prefill_chunk=4, megastep=4) as eng:
        eng.warmup()
        ref = eng.generate_many([p for p, _ in reqs], [m for _, m in reqs])
    seq = serving.sequential_generate(tlm, reqs)
    for i, (a, b, c, d) in enumerate(zip(four, one, ref, seq)):
        assert a[0] == b[0] == c[0] == d[0], i
        np.testing.assert_allclose(a[1], c[1], rtol=1e-4, atol=1e-4)
        assert a[1] == b[1]             # the same steps, in the same order
    assert s1["megastep_dispatches"] == 0
    assert s4["megastep_dispatches"] > 0
    assert s4["steps"] < s1["steps"]            # K steps per iteration
    assert s4["decode_steps"] == s1["decode_steps"]
    # a dispatch that drains early runs steps nobody consumes
    assert s4["decode_steps_run"] > s4["decode_steps"]
    assert s1["decode_steps_run"] == s1["decode_steps"]


def test_engine_megastep_k_choice(lms):
    """K only while no admission is queued and no slot is prefilling."""
    _, tlm = lms
    eng = serving.Engine(tlm, slots=2, device="cpu", megastep=4)
    eng.close()                     # the loop thread is gone: host logic
    assert eng._choose_k() == 4
    eng._queue.append(object())
    assert eng._choose_k() == 1
    eng._queue.clear()
    eng._recs[1] = {"live": False}
    assert eng._choose_k() == 1
    eng._recs[1] = {"live": True}
    assert eng._choose_k() == 4
    eng._recs[1] = None
    with serving.Engine(tlm, slots=2, device="cpu") as one:
        assert one._choose_k() == 1


# -- the masked pool write -------------------------------------------------

@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_masked_pool_write_leaves_pool_unchanged(lms, quant):
    """One decode step with two of four slots masked: every byte of the
    pool's blocks (codes and scales) is as it was, except the two live
    slots' write positions; the masked writes land in the trash
    block."""
    _, tlm = lms
    nb, bs = 12, 4
    state = tlm._init_paged_state(nb, bs, kv_quant=quant)
    gen = torch.Generator().manual_seed(0)
    for name, t in state.items():
        raw = t.view(torch.uint8) if t.dtype.itemsize == 1 else t
        if raw.dtype == torch.uint8:
            raw.copy_(torch.randint(0, 120, raw.shape, generator=gen,
                                    dtype=torch.uint8))
        else:
            raw.copy_(torch.rand(raw.shape, generator=gen) + 0.5)
    before = {n: t.clone() for n, t in state.items()}
    btab = torch.arange(nb, dtype=torch.int32).reshape(4, 3)
    pos = torch.tensor([5, 2, 9, 7])
    mask = torch.tensor([True, False, True, False])
    tok = torch.tensor([3, 4, 5, 6])
    tlm._step_logits_paged(tok, state, pos, btab, write_mask=mask,
                           block_kernel=True)
    live = {(int(btab[s, pos[s] // bs]), int(pos[s] % bs))
            for s in range(4) if mask[s]}
    assert len(live) == 2
    for name, t in state.items():
        a, b = t, before[name]
        if t.dtype.itemsize == 1:
            a, b = a.view(torch.uint8), b.view(torch.uint8)
        diff = a != b
        # [blocks, bs]: which (block, position) entries changed anywhere
        per_entry = diff.any(dim=(1, 2, 4) if t.dim() == 5 else (1, 2))
        changed = {(blk, off) for blk, off in
                   zip(*np.nonzero(per_entry[:nb].numpy()))}
        if name in ("pool_k", "pool_v"):
            assert changed == live, name
        else:
            assert changed <= live, name
        assert bool(per_entry[nb].any()), name      # the trash block


# -- no host reads inside the bodies ---------------------------------------

_GUARD = threading.local()


def _guarded(name, real):
    def call(*args, **kwargs):
        if getattr(_GUARD, "on", False):
            raise AssertionError(
                "%s inside a step body reads the card back to the host; a "
                "CUDA graph capture would fail on it" % name)
        return real(*args, **kwargs)
    return call


def _guarded_tensor(real):
    def call(*args, **kwargs):
        if getattr(_GUARD, "on", False) and kwargs.get("device") is not None:
            raise AssertionError(
                "torch.tensor(..., device=) inside a step body copies from "
                "pageable host memory; a CUDA graph capture would fail on "
                "it")
        return real(*args, **kwargs)
    return call


def _body(real):
    def call(*args, **kwargs):
        on = getattr(_GUARD, "on", False)
        _GUARD.on = True
        try:
            return real(*args, **kwargs)
        finally:
            _GUARD.on = on
    return call


def _exempt(real):
    """A kernel's plain stand-in: on the card the kernel launch takes
    its place (the paged wrapper's CPU branch reads ``nblk``)."""
    def call(*args, **kwargs):
        on = getattr(_GUARD, "on", False)
        _GUARD.on = False
        try:
            return real(*args, **kwargs)
        finally:
            _GUARD.on = on
    return call


@pytest.fixture
def no_host_reads(monkeypatch):
    for name in ("item", "cpu", "tolist", "numpy", "nonzero", "__bool__",
                 "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name,
                            _guarded("Tensor." + name,
                                     getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch, "nonzero",
                        _guarded("torch.nonzero", torch.nonzero))
    monkeypatch.setattr(torch, "tensor", _guarded_tensor(torch.tensor))
    monkeypatch.setattr(TPA, "paged_attention",
                        _exempt(TPA.paged_attention))
    return monkeypatch


def test_guard_catches_a_host_read(no_host_reads):
    with pytest.raises(AssertionError, match="Tensor.item"):
        _body(lambda: torch.ones(2).sum().item())()
    with pytest.raises(AssertionError, match="torch.nonzero"):
        _body(lambda: torch.nonzero(torch.ones(2)))()
    assert torch.ones(2).sum().item() == 2.0       # outside a body


def test_engine_decode_body_has_no_host_read(lms, no_host_reads):
    _, tlm = lms
    no_host_reads.setattr(serving.Engine, "_step_impl",
                          _body(serving.Engine._step_impl))
    no_host_reads.setattr(serving.Engine, "_megastep_impl",
                          _body(serving.Engine._megastep_impl))
    reqs = _requests(1, 3)
    out, stats = _serve(tlm, reqs, megastep=4)
    assert stats["megastep_dispatches"] > 0
    seq = serving.sequential_generate(tlm, reqs)
    assert [t for t, _ in out] == [t for t, _ in seq]


@pytest.mark.parametrize("drafter", ["ngram", "truncated"])
def test_engine_spec_and_sampled_bodies_have_no_host_read(lms, drafter,
                                                          no_host_reads):
    """The scoring step, the truncated drafter and the sampled decode
    step (alone and inside a megastep) read nothing back to the host,
    so a capture on the card cannot fail for that."""
    _, tlm = lms
    for name in ("_step_impl", "_megastep_impl", "_spec_step_impl",
                 "_draft_truncated_impl"):
        no_host_reads.setattr(serving.Engine, name,
                              _body(getattr(serving.Engine, name)))
    reqs = _requests(4, 4)
    samp = [dict(temperature=0.8, top_k=5, seed=i) for i in range(4)]
    with serving.Engine(tlm, slots=2, prefill_chunk=4, device="cpu",
                        megastep=4, speculative=True, spec_gamma=3,
                        spec_drafter=drafter) as eng:
        if drafter == "ngram":
            eng._drafter = NgramDrafter(max_n=3, min_n=1)
        eng.warmup(sampled=True)
        out = eng.generate_many([p for p, _ in reqs], [m for _, m in reqs])
        hs = [eng.submit(p, m, sampling=sp)
              for (p, m), sp in zip(reqs, samp)]
        drawn = [h.result(timeout=60) for h in hs]
        stats = dict(eng.stats)
    assert stats["spec_dispatches"] > 0
    assert (stats["spec_draft_steps"] > 0) == (drafter == "truncated")
    seq = serving.sequential_generate(tlm, reqs)
    assert [t for t, _ in out] == [t for t, _ in seq]
    assert all(len(t) >= 1 for t, _ in drawn)


@pytest.mark.parametrize("model", ["lm_adam", "cifar8_fused"])
def test_run_steps_body_has_no_host_read(model, fused, no_host_reads):
    (main, startup, fetch, feeds), _ = _programs(model)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    init = {n: scope.get_numpy(n) for n in scope.local_var_names()}
    no_host_reads.setattr(texecutor._Megastep, "_body",
                          _body(texecutor._Megastep._body))
    got = exe.run_steps(main, feeds=feeds[:2], fetch_list=fetch,
                        scope=scope)
    ref_scope = _port_scope(init)
    ref = [exe.run(main, feed=f, fetch_list=fetch, scope=ref_scope)
           for f in feeds[:2]]
    np.testing.assert_array_equal([g[0] for g in got], [r[0] for r in ref])
