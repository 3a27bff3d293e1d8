"""The RNN ops of the PyTorch port against the JAX package
(tests/test_control_flow_rnn.py's ground, on the CPU).

* ``lstm`` (with and without peepholes, forward and reverse, H0/C0 and
  other activations), ``lstmp``, ``gru`` (``origin_mode``, reverse, H0),
  ``lstm_unit`` and ``gru_unit`` on unequal lengths, as one-op Programs
  through both Executors (``tools/op_sweep.lod_cases``, the card sweep's
  cases): forward at rtol 1e-5 / atol 1e-6, the ``calc_gradient`` of
  every float input at rtol 1e-4 / atol 1e-5 (tests/torch_op_harness.py);
* ``_lstm_cell_plain`` against the JAX step body
  (paddle_tpu/ops/rnn_ops.py:111-131, written out in jnp here) and its
  ``jax.grad``: f32 values at rtol 1e-6 / atol 1e-6, gradients at rtol
  1e-5 / atol 1e-6 (one step: only rounding order differs);
* a stacked LSTM's second layer scans the feed's ``@MAXLEN`` steps, not
  the bucketed flat total;
* the benchmark's stacked dynamic LSTM (benchmarks/stacked_dynamic_lstm.py
  ``build``) at hidden 16, 3 layers: the port's builder emits its Program
  JSON, and 3 Adam steps from the JAX package's startup values give its
  losses and weights within 2e-4 of max(1, max|w|) per tensor, as does the
  book's GRU encoder-decoder (tests/book/test_rnn_encoder_decoder.py).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.ops import lstm_cell as LC
from paddle_tpu_torch.tools import op_sweep

from torch_op_harness import check

TOL = 2e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNN_OPS = ("lstm", "lstmp", "gru", "lstm_unit", "gru_unit")
CASES = [c for c in op_sweep.lod_cases() if c[0] in RNN_OPS]


@pytest.mark.parametrize("case", CASES, ids=[
    "%s-%d" % (c[0], i) for i, c in enumerate(CASES)])
def test_rnn_op_matches_jax(case):
    op_type, inputs, attrs, outs, wrt = case
    check(op_type, inputs, attrs, outs, wrt)


def test_rnn_cases_cover_every_rnn_op():
    assert {c[0] for c in CASES} == set(RNN_OPS)
    lstm = [c[2] for c in CASES if c[0] == "lstm"]
    assert any(a.get("use_peepholes") for a in lstm)
    assert any(a.get("is_reverse") for a in lstm)
    assert any(not a.get("use_peepholes", True) for a in lstm)


# --------------------------------------------------------------------------
_JACT = {0: lambda x: x, 1: jax.nn.sigmoid, 2: jnp.tanh, 3: jax.nn.relu}


def _jax_step(xt, hw, c, h, peep, lens, t, acts):
    """paddle_tpu/ops/rnn_ops.py:111-131 with gates = xt + h @ w + b
    given as xt + hw (the bias folded into xt)."""
    ga, ca, ha = (_JACT[a] for a in acts)
    gates = xt + hw
    gi, gf, gc, go = jnp.split(gates, 4, axis=-1)
    d = c.shape[-1]
    if peep is not None:
        gi = gi + c * peep[:d]
        gf = gf + c * peep[d:2 * d]
    i = ga(gi)
    f = ga(gf)
    c_new = f * c + i * ca(gc)
    if peep is not None:
        go = go + c_new * peep[2 * d:]
    h_new = ga(go) * ha(c_new)
    alive = (t < lens)[:, None]
    h_new = jnp.where(alive, h_new, h)
    c_new = jnp.where(alive, c_new, c)
    return h_new, c_new, jnp.where(alive, h_new, jnp.zeros_like(h_new))


@pytest.mark.parametrize("peep", [False, True])
@pytest.mark.parametrize("acts", [(1, 2, 2), (1, 3, 0), (2, 1, 2)])
def test_lstm_cell_plain_matches_the_jax_step(peep, acts):
    rng = np.random.RandomState(11)
    b, d, t = 6, 5, 3
    arrays = dict(xt=rng.randn(b, 4 * d), hw=rng.randn(b, 4 * d),
                  c=rng.randn(b, d), h=rng.randn(b, d),
                  peep=rng.randn(3 * d) if peep else None)
    arrays = {k: None if v is None else v.astype(np.float32)
              for k, v in arrays.items()}
    lens = np.array([1, 3, 4, 0, 7, 3], np.int32)    # rows 0, 1, 3 dead
    cot = [rng.randn(b, d).astype(np.float32) for _ in range(3)]
    names = [k for k, v in arrays.items() if v is not None]

    def jfun(*vals):
        kw = dict(zip(names, vals))
        outs = _jax_step(kw["xt"], kw["hw"], kw["c"], kw["h"],
                         kw.get("peep"), jnp.asarray(lens), t, acts)
        return sum(jnp.sum(o * w) for o, w in zip(outs, cot)), outs

    jvals = [jnp.asarray(arrays[k]) for k in names]
    (_, jouts), jgrads = jax.value_and_grad(
        jfun, argnums=tuple(range(len(names))), has_aux=True)(*jvals)
    tvals = {k: torch.tensor(arrays[k], requires_grad=True) for k in names}
    touts = LC._lstm_cell_plain(
        tvals["xt"], tvals["hw"], tvals["c"], tvals["h"], tvals.get("peep"),
        torch.from_numpy(lens), t, acts)
    total = sum(torch.sum(o * torch.from_numpy(w))
                for o, w in zip(touts, cot))
    tgrads = torch.autograd.grad(total, [tvals[k] for k in names])
    for o, w in zip(touts, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6)
    for k, g, w in zip(names, tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # a dead row passes its carry through and writes a zero output
    assert np.array_equal(touts[0].detach().numpy()[3], arrays["h"][3])
    assert not touts[2].detach().numpy()[0].any()


def test_lstm_cell_raises_off_cpu_and_cuda():
    x = torch.zeros(1, 2, 8, device="meta")
    w = torch.zeros(2, 8, device="meta")
    c = torch.zeros(2, 2, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        LC.lstm_scan(x, w, c, c, None, torch.zeros(2, dtype=torch.int32,
                                                   device="meta"), (1, 2, 2))


# --------------------------------------------------------------------------
def test_stacked_lstm_passes_the_maxlen_bound():
    """The second layer's input carries the feed's @MAXLEN (8 for a
    longest length of 5): its scan runs 8 steps, not the 16 bucketed
    rows (tests/test_control_flow_rnn.py:292's defect)."""
    from paddle_tpu_torch.core import executor as E
    from paddle_tpu_torch.core import registry
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        words = tfluid.layers.data("words", [1], dtype="int64", lod_level=1)
        emb = tfluid.layers.embedding(words, size=[20, 8])
        proj1 = tfluid.layers.fc(emb, 32)
        h1, _ = tfluid.layers.dynamic_lstm(proj1, size=32,
                                           use_peepholes=False)
        proj2 = tfluid.layers.fc(h1, 32)
        h2, _ = tfluid.layers.dynamic_lstm(proj2, size=32,
                                           use_peepholes=False)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    lens = [3, 5, 2, 4]
    ids = np.random.RandomState(0).randint(0, 20, (sum(lens), 1))
    arrays, static = E._normalize_feeds(
        {"words": tfluid.create_lod_tensor(ids.astype(np.int64), [lens])})
    assert static == {"words@MAXLEN": 8}
    assert arrays["words"].shape == (16, 1)
    env = {k: torch.from_numpy(np.asarray(v)).to(torch.int32)
           if np.asarray(v).dtype.kind == "i" else torch.from_numpy(v)
           for k, v in arrays.items()}
    env.update({n: scope.find_var(n) for n in scope.local_var_names()})
    calls = []
    real = LC._lstm_step_plain

    def counting(*args, **kwargs):
        calls.append(args[6])
        return real(*args, **kwargs)

    LC._lstm_step_plain = counting
    try:
        ctx = registry.LowerContext(env, torch.device("cpu"),
                                    block=main.global_block(),
                                    static_info=dict(static))
        with torch.no_grad():
            for op in main.global_block().ops:
                E._lower_op(ctx, op)
    finally:
        LC._lstm_step_plain = real
    assert ctx.static_info[h1.name + "@MAXLEN"] == 8
    assert ctx.static_info[proj2.name + "@MAXLEN"] == 8
    assert calls == list(range(8)) * 2          # two layers of 8 steps
    assert env[h2.name].shape[0] == 16


# --------------------------------------------------------------------------
def _benchmark_build():
    """benchmarks/stacked_dynamic_lstm.py's ``build`` (the JAX
    package's Program)."""
    bench = os.path.join(ROOT, "benchmarks")
    sys.path.insert(0, bench)
    try:
        spec = importlib.util.spec_from_file_location(
            "stacked_dynamic_lstm_bench",
            os.path.join(bench, "stacked_dynamic_lstm.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(bench)
    return mod.build


def stacked_lstm(fluid, vocab, hidden, stacked, classes=2):
    """The benchmark's Program in ``fluid``'s layers: embedding, then
    ``stacked`` layers of fc to 4 hidden and dynamic_lstm (no
    peepholes), max sequence pool, fc softmax, cross-entropy, Adam 1e-3.
    chip_smoke.py builds the same."""
    L = fluid.layers
    words = L.data("words", [1], dtype="int64", lod_level=1)
    label = L.data("label", [1], dtype="int64")
    x = L.embedding(words, size=[vocab, hidden])
    for _ in range(stacked):
        proj = L.fc(x, 4 * hidden)
        x, _ = L.dynamic_lstm(proj, size=4 * hidden, use_peepholes=False)
    pred = L.fc(L.sequence_pool(x, "max"), classes, act="softmax")
    loss = L.mean(L.cross_entropy(pred, label))
    fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return words, label, loss


def _programs(build, pkg, *args):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        out = build(*args)
    return main, startup, out


def _three_steps(jprog, tprog, feeds, losses_tol=TOL):
    """3 steps of both packages from the JAX package's startup values:
    losses at rtol/atol ``losses_tol``, every persistable within TOL of
    max(1, max|w|). Returns the port's losses."""
    jmain, jstart, jloss = jprog
    tmain, _, tloss = tprog
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
    names = [v.name for v in jmain.list_vars() if v.persistable]
    state = {n: np.asarray(jscope.find_var(n)) for n in names
             if jscope.find_var(n) is not None}
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, state, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    got = []
    for feed_j, feed_t in feeds:
        with jfluid.scope_guard(jscope):
            jl, = jexe.run(jmain, feed=feed_j, fetch_list=[jloss])
        tl, = texe.run(tmain, feed=feed_t, fetch_list=[tloss], scope=tscope)
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=losses_tol,
                                   atol=losses_tol)
        got.append(float(tl))
    for n in state:
        want = np.asarray(jscope.find_var(n))
        tol = TOL * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(tscope.get_numpy(n), want, rtol=0,
                                   atol=tol, err_msg=n)
    return got


def _lstm_feeds(rng, batch, vocab, lo=4, hi=9):
    lens = rng.randint(lo, hi, size=batch).tolist()
    ids = rng.randint(0, vocab, (sum(lens), 1)).astype(np.int64)
    ys = rng.randint(0, 2, (batch, 1)).astype(np.int64)
    return [({"words": pkg.create_lod_tensor(ids, [lens]), "label": ys})
            for pkg in (jfluid, tfluid)]


def test_stacked_lstm_program_is_the_benchmarks():
    jm, js, _ = _programs(_benchmark_build(), jfluid, 5000, 512, 3)
    tm, ts, _ = _programs(stacked_lstm, tfluid, tfluid, 5000, 512, 3)
    assert tm.to_json() == jm.to_json()
    assert ts.to_json() == js.to_json()


def test_stacked_lstm_three_adam_steps_match_jax():
    build = _benchmark_build()
    jm, js, (_, _, jloss) = _programs(build, jfluid, 50, 16, 3)
    tm, ts, (_, _, tloss) = _programs(stacked_lstm, tfluid, tfluid, 50, 16,
                                      3)
    rng = np.random.RandomState(3)
    feeds = [tuple(_lstm_feeds(rng, 4, 50)) for _ in range(3)]
    losses = _three_steps((jm, js, jloss), (tm, ts, tloss), feeds)
    assert all(np.isfinite(losses))


def test_stacked_lstm_run_steps_matches_run():
    """A list of per-step LoD feeds through run_steps (one staged [K, n]
    lengths buffer) gives what K run() calls give."""
    tm, ts, (_, _, loss) = _programs(stacked_lstm, tfluid, tfluid, 30, 8,
                                     2)
    exe = tfluid.Executor(tfluid.CPUPlace())
    init = tfluid.Scope()
    exe.run(ts, scope=init)
    state = {n: init.get_numpy(n) for n in init.local_var_names()}
    rng = np.random.RandomState(9)
    lens = [[3, 5, 2], [6, 4, 1], [5, 1, 3]]     # bucket 16, @MAXLEN 8
    feeds = []
    for ln in lens:
        ids = rng.randint(0, 30, (sum(ln), 1)).astype(np.int64)
        feeds.append({"words": tfluid.create_lod_tensor(ids, [ln]),
                      "label": rng.randint(0, 2, (3, 1)).astype(np.int64)})
    torch.set_num_threads(1)
    sa, sb = tfluid.Scope(), tfluid.Scope()
    tfluid.load_numpy_state(sa, state, "cpu")
    tfluid.load_numpy_state(sb, state, "cpu")
    want = [float(exe.run(tm, feed=f, fetch_list=[loss], scope=sa)[0])
            for f in feeds]
    got = [float(o[0]) for o in exe.run_steps(tm, feeds=feeds,
                                              fetch_list=[loss], scope=sb)]
    assert got == want
    for n in state:
        assert np.array_equal(sa.get_numpy(n), sb.get_numpy(n)), n


def test_run_steps_refuses_a_prestacked_lod_feed():
    tm, ts, (_, _, loss) = _programs(stacked_lstm, tfluid, tfluid, 30, 8,
                                     1)
    exe = tfluid.Executor(tfluid.CPUPlace())
    t = tfluid.create_lod_tensor(np.zeros((3, 1), np.int64), [[1, 2]])
    with pytest.raises(ValueError, match="pre-stacked"):
        exe.run_steps(tm, feeds={"words": t,
                                 "label": np.zeros((2, 2, 1), np.int64)},
                      k=2, fetch_list=[loss])


def test_run_steps_refuses_lod_feeds_of_two_shapes():
    tm, ts, (_, _, loss) = _programs(stacked_lstm, tfluid, tfluid, 30, 8,
                                     1)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(ts, scope=scope)
    y = np.zeros((2, 1), np.int64)
    feeds = [{"words": tfluid.create_lod_tensor(
        np.zeros((n, 1), np.int64), [[1, n - 1]]), "label": y}
        for n in (3, 7)]                     # @MAXLEN 2 vs 8
    with pytest.raises(ValueError, match="ONE step signature"):
        exe.run_steps(tm, feeds=feeds, fetch_list=[loss], scope=scope)


# --------------------------------------------------------------------------
def _seq2seq(fluid, dict_size, emb=16, gru=32):
    """tests/book/test_rnn_encoder_decoder.py's network in ``fluid``."""
    L = fluid.layers
    src = L.data("src_word_id", [1], dtype="int64", lod_level=1)
    trg = L.data("target_language_word", [1], dtype="int64", lod_level=1)
    label = L.data("target_language_next_word", [1], dtype="int64",
                   lod_level=1)
    enc = L.dynamic_gru(L.fc(L.embedding(src, size=[dict_size, emb]),
                             gru * 3), size=gru)
    dec = L.dynamic_gru(L.fc(L.embedding(trg, size=[dict_size, emb]),
                             gru * 3), size=gru,
                        h_0=L.sequence_last_step(enc))
    pred = L.fc(dec, dict_size, act="softmax")
    cost = L.sequence_pool(L.cross_entropy(pred, label), "sum")
    loss = L.mean(cost)
    fluid.optimizer.Adam(learning_rate=0.005).minimize(loss)
    return loss


def test_book_gru_encoder_decoder_three_adam_steps_match_jax():
    dict_size = 60
    jm, js, jloss = _programs(_seq2seq, jfluid, jfluid, dict_size)
    tm, ts, tloss = _programs(_seq2seq, tfluid, tfluid, dict_size)
    assert tm.to_json() == jm.to_json()
    rng = np.random.RandomState(4)
    slen = rng.randint(2, 7, 4).tolist()
    tlen = rng.randint(2, 6, 4).tolist()
    src = rng.randint(0, dict_size, (sum(slen), 1)).astype(np.int64)
    trg = rng.randint(0, dict_size, (sum(tlen), 1)).astype(np.int64)
    nxt = rng.randint(0, dict_size, (sum(tlen), 1)).astype(np.int64)
    feed = tuple(
        {"src_word_id": pkg.create_lod_tensor(src, [slen]),
         "target_language_word": pkg.create_lod_tensor(trg, [tlen]),
         "target_language_next_word": pkg.create_lod_tensor(nxt, [tlen])}
        for pkg in (jfluid, tfluid))
    losses = _three_steps((jm, js, jloss), (tm, ts, tloss), [feed] * 3)
    assert losses[-1] < losses[0]           # one batch, three steps
