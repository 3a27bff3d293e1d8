"""The port's decode models against the JAX package: the encoder-decoder
``TransformerInfer`` (``translate``, ``translate_greedy``) and
``TransformerLMInfer.generate``, the counterparts of
``tests/test_transformer_infer.py:35-190``.

Each model is trained a few Adam steps by ``paddle_tpu`` (2 layers, 4
heads, d_model 32, max_len 16, vocab 30), and its parameter stream
(``extract_params``) builds both the JAX decoder and the port's on the
CPU. Held: teacher-forced step logits at rtol 1e-5 / atol 1e-5 against
the JAX decoder (the same f32 arithmetic summed in other orders) and at
the JAX test's 2e-3 / 2e-4 against the port's own Program forward;
``translate`` (beam and greedy) and ``generate`` (greedy and beam)
tokens identical and scores at rtol 1e-5; ``extract_params`` fails
loudly on a mismatch; bf16 within the JAX test's tolerances. Each
``end_id`` that must end sentences inside the decode is a token the
port's own greedy run emits (chosen on the port side only). A guard
holds every decode free of host reads, which a CUDA graph (the card's
path) could not hold.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import transformer as JT
from paddle_tpu.models.transformer_infer import (
    TransformerInfer as JaxMT, TransformerLMInfer as JaxLM, extract_params)
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.models import transformer_infer as TI

N_LAYER, N_HEAD, D_MODEL, MAX_LEN, VOCAB, D_INNER = 2, 4, 32, 16, 30, 64
RTOL = ATOL = 1e-5


def _np_stream(program, scope):
    return [(role, [np.asarray(a) for a in arrays])
            for role, arrays in extract_params(program, scope)]


def _train(build, feeds, steps=4):
    """Build with ``paddle_tpu``, train ``steps`` Adam steps; returns
    (main, scope, stream)."""
    main, startup = jfluid.Program(), jfluid.Program()
    scope = jfluid.Scope()
    with jfluid.program_guard(main, startup), jfluid.scope_guard(scope), \
            jfluid.unique_name.guard():
        avg_cost, _ = build()
        jfluid.optimizer.Adam(learning_rate=1e-2).minimize(avg_cost)
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        for i in range(steps):
            exe.run(main, feed=feeds(np.random.RandomState(40 + i)),
                    fetch_list=[avg_cost])
    return main, scope, _np_stream(main, scope)


@pytest.fixture(scope="module")
def mt():
    main, scope, stream = _train(
        lambda: JT.transformer(
            src_vocab_size=VOCAB, trg_vocab_size=VOCAB, max_len=MAX_LEN,
            n_layer=N_LAYER, n_head=N_HEAD, d_model=D_MODEL,
            d_inner=D_INNER),
        lambda rng: TT.mt_feeds(TT.make_lm_batch(rng, 4, MAX_LEN, VOCAB),
                                TT.make_lm_batch(rng, 4, MAX_LEN, VOCAB)))
    return main, scope, stream


@pytest.fixture(scope="module")
def lm():
    main, scope, stream = _train(
        lambda: JT.transformer_lm(
            vocab_size=VOCAB, max_len=MAX_LEN, n_layer=N_LAYER,
            n_head=N_HEAD, d_model=D_MODEL, d_inner=D_INNER),
        lambda rng: TT.make_lm_batch(rng, 4, MAX_LEN, VOCAB))
    return main, scope, stream


def _pair(cls_j, cls_t, stream, main, scope, **kw):
    with jfluid.scope_guard(scope):
        jm = cls_j(main, scope, N_LAYER, N_HEAD, D_MODEL, MAX_LEN, **kw)
    tm = cls_t.from_stream(stream, N_LAYER, N_HEAD, D_MODEL, MAX_LEN,
                           device="cpu", **kw)
    return jm, tm


def _src(seed, batch=3):
    rng = np.random.RandomState(seed)
    src = rng.randint(3, VOCAB, (batch, MAX_LEN)).astype(np.int32)
    mask = np.ones((batch, MAX_LEN), np.float32)
    mask[1, 11:] = 0.0                      # one padded source sentence
    src[1, 11:] = 0
    return src, mask


def _assert_decode(got, ref):
    (toks, scores), (rtoks, rscores) = got, ref
    assert toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(), np.asarray(rtoks))
    np.testing.assert_allclose(scores.numpy(), np.asarray(rscores),
                               rtol=RTOL, atol=RTOL)


def _greedy_end_id(tokens):
    """A token the port's own greedy run emits in the middle of its first
    row: used as end_id, it ends that sentence inside the decode."""
    row = tokens.numpy()[0]
    return int(row[len(row) // 2])


# --------------------------------------------------------------------------
# the encoder-decoder model

def test_mt_stream_replay_checks_roles(mt):
    main, scope, stream = mt
    TI.mt_params_from_stream(stream, N_LAYER)
    with pytest.raises(AssertionError, match="mismatch|exhausted"):
        TI.TransformerInfer.from_stream(stream, N_LAYER + 1, N_HEAD,
                                        D_MODEL, MAX_LEN, device="cpu")
    with pytest.raises(AssertionError, match="mismatch"):
        TI.mt_params_from_stream(stream, N_LAYER - 1)
    with pytest.raises(AssertionError, match="unconsumed"):
        TI.mt_params_from_stream(stream + [stream[-1]], N_LAYER)


def test_mt_extract_params_reads_the_program_as_jax(mt):
    """The port's extract_params on the port's own MT Program (same JSON)
    over the same weights gives the JAX package's stream."""
    main, scope, stream = mt
    tmain = tfluid.Program.from_json(main.to_json())
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, {
        n: np.asarray(scope.find_var(n)) for n in scope.local_var_names()
        if scope.find_var(n) is not None}, "cpu")
    mine = TI.extract_params(tmain, tscope)
    assert [r for r, _ in mine] == [r for r, _ in stream]
    for (_, a), (_, b) in zip(mine, stream):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_mt_teacher_forced_logits_match_jax(mt):
    main, scope, stream = mt
    jm, tm = _pair(JaxMT, TI.TransformerInfer, stream, main, scope)
    src, mask = _src(0, batch=2)
    trg = np.random.RandomState(1).randint(3, VOCAB, (2, MAX_LEN))
    jenc = jm.encode(jnp.asarray(src), jnp.asarray(mask))
    tenc = tm.encode(torch.from_numpy(src), torch.from_numpy(mask))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), rtol=RTOL,
                               atol=ATOL)
    jstate = jm._init_decode_state(jenc, jnp.asarray(mask), 2)
    tstate = tm._init_decode_state(tenc, torch.from_numpy(mask), 2)
    for t in range(MAX_LEN):
        jl, jstate = jm._step_logits(jnp.asarray(trg[:, t], jnp.int32),
                                     jstate, t)
        tl, tstate = tm._step_logits(torch.from_numpy(trg[:, t]), tstate,
                                     t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL, err_msg="t=%d" % t)


def test_mt_step_logits_match_the_program_forward(mt):
    """The port's incremental decoder against the port's Executor running
    the trained MT Program (full-length masks), as the JAX test holds its
    own."""
    main, scope, stream = mt
    tmain = tfluid.Program.from_json(main.to_json())
    # the output projection: the program's last mul
    logits = [op.output("Out")[0] for op in tmain.global_block().ops
              if op.type == "mul"][-1]
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, {
        n: np.asarray(scope.find_var(n)) for n in scope.local_var_names()
        if scope.find_var(n) is not None}, "cpu")
    rng = np.random.RandomState(2)
    src = rng.randint(3, VOCAB, (2, MAX_LEN)).astype(np.int64)
    trg = rng.randint(3, VOCAB, (2, MAX_LEN)).astype(np.int64)
    ones = np.ones((2, MAX_LEN), np.float32)
    pos = np.tile(np.arange(MAX_LEN, dtype=np.int64), (2, 1))
    prog_logits, = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed={"src_word": src, "src_pos": pos, "src_mask": ones,
                     "trg_word": trg, "trg_pos": pos, "trg_mask": ones,
                     "lbl_word": trg}, fetch_list=[logits], scope=tscope)
    tm = TI.TransformerInfer.from_stream(stream, N_LAYER, N_HEAD, D_MODEL,
                                         MAX_LEN, device="cpu")
    state = tm._init_decode_state(
        tm.encode(torch.from_numpy(src), torch.from_numpy(ones)),
        torch.from_numpy(ones), 2)
    prog_logits = prog_logits.reshape(2, MAX_LEN, VOCAB)
    for t in range(MAX_LEN):
        step, state = tm._step_logits(torch.from_numpy(trg[:, t]), state, t)
        np.testing.assert_allclose(step.numpy(), prog_logits[:, t],
                                   rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("how", ["beam", "beam_lp", "greedy"])
def test_translate_matches_jax(mt, how):
    main, scope, stream = mt
    _, probe = _pair(JaxMT, TI.TransformerInfer, stream, main, scope)
    src, mask = _src(3)
    toks, _ = probe.translate_greedy(src, mask, max_out_len=10)
    end_id = _greedy_end_id(toks)
    jm, tm = _pair(JaxMT, TI.TransformerInfer, stream, main, scope,
                   end_id=end_id)
    jsrc, jmask = jnp.asarray(src), jnp.asarray(mask)
    if how == "greedy":
        ref = jm.translate_greedy(jsrc, jmask, max_out_len=10)
        got = tm.translate_greedy(src, mask, max_out_len=10)
        assert got[0].shape == (3, 10)
    else:
        lp = 0.6 if how == "beam_lp" else 0.0
        ref = jm.translate(jsrc, jmask, beam_size=3, max_out_len=10,
                           length_penalty=lp)
        got = tm.translate(src, mask, beam_size=3, max_out_len=10,
                           length_penalty=lp)
        assert got[0].shape == (3, 3, 10)
        assert (np.diff(got[1].numpy(), axis=1) <= 0).all()
    _assert_decode(got, ref)
    assert (got[0].numpy() == end_id).any()


def test_translate_greedy_equals_beam_one(mt):
    main, scope, stream = mt
    tm = TI.TransformerInfer.from_stream(stream, N_LAYER, N_HEAD, D_MODEL,
                                         MAX_LEN, device="cpu")
    src, mask = _src(4)
    toks, _ = tm.translate_greedy(src, mask, max_out_len=8)
    s1, _ = tm.translate(src, mask, beam_size=1, max_out_len=8)
    np.testing.assert_array_equal(toks.numpy(), s1.numpy()[:, 0, :])
    with pytest.raises(ValueError, match="exceeds"):
        tm.translate(src, mask, max_out_len=MAX_LEN + 1)


def test_mt_bf16_within_the_jax_tolerances(mt):
    """bf16 weights and caches, f32 scores, softmax, LN statistics and
    log-probs: teacher-forced logits within the JAX test's bf16 tolerance
    of the f32 decoder (rtol 0.1, atol 0.05), translate runs, and the
    port's bf16 logits within the same tolerance of the JAX package's;
    fp16 is refused."""
    main, scope, stream = mt
    f32 = TI.TransformerInfer.from_stream(stream, N_LAYER, N_HEAD, D_MODEL,
                                          MAX_LEN, device="cpu")
    with jfluid.scope_guard(scope):
        jm = JaxMT(main, scope, N_LAYER, N_HEAD, D_MODEL, MAX_LEN,
                   dtype=jnp.bfloat16)
    bf16 = TI.TransformerInfer.from_stream(
        stream, N_LAYER, N_HEAD, D_MODEL, MAX_LEN, device="cpu",
        dtype=torch.bfloat16)
    assert bf16.src_word_emb.dtype == torch.bfloat16
    src, mask = _src(5, batch=2)
    trg = np.random.RandomState(6).randint(3, VOCAB, (2, 6))
    states = []
    for m in (f32, bf16):
        enc = m.encode(torch.from_numpy(src), torch.from_numpy(mask))
        states.append(m._init_decode_state(enc, torch.from_numpy(mask), 2))
    assert states[1]["k0"].dtype == torch.bfloat16
    jenc = jm.encode(jnp.asarray(src), jnp.asarray(mask))
    jstate = jm._init_decode_state(jenc, jnp.asarray(mask), 2)
    for t in range(6):
        tok = torch.from_numpy(trg[:, t])
        l32, states[0] = f32._step_logits(tok, states[0], t)
        l16, states[1] = bf16._step_logits(tok, states[1], t)
        jl, jstate = jm._step_logits(jnp.asarray(trg[:, t], jnp.int32),
                                     jstate, t)
        np.testing.assert_allclose(l16.float().numpy(), l32.numpy(),
                                   rtol=0.1, atol=0.05)
        np.testing.assert_allclose(l16.float().numpy(),
                                   np.asarray(jl, np.float32), rtol=0.1,
                                   atol=0.05)
    sents, scores = bf16.translate(src, mask, beam_size=2, max_out_len=6)
    assert sents.shape == (2, 2, 6)
    assert torch.isfinite(scores).all() and scores.dtype == torch.float32
    with pytest.raises(ValueError, match="bfloat16"):
        TI.TransformerInfer.from_stream(stream, N_LAYER, N_HEAD, D_MODEL,
                                        MAX_LEN, device="cpu",
                                        dtype=torch.float16)


# --------------------------------------------------------------------------
# the decoder-only LM

@pytest.mark.parametrize("beam", [1, 3])
def test_lm_generate_matches_jax(lm, beam):
    main, scope, stream = lm
    _, probe = _pair(JaxLM, TI.TransformerLMInfer, stream, main, scope)
    toks, _ = probe.generate(batch=2, max_out_len=12)
    end_id = _greedy_end_id(toks)
    jm, tm = _pair(JaxLM, TI.TransformerLMInfer, stream, main, scope,
                   end_id=end_id)
    ref = jm.generate(batch=2, max_out_len=12, beam_size=beam)
    got = tm.generate(batch=2, max_out_len=12, beam_size=beam)
    assert got[0].shape == ((2, 12) if beam == 1 else (2, beam, 12))
    _assert_decode(got, ref)
    assert (got[0].numpy() == end_id).any()


def test_lm_generate_greedy_equals_sequential_steps(lm):
    """generate's greedy loop is the argmax of the dense step's logits,
    fed back one token at a time."""
    main, scope, stream = lm
    tm = TI.TransformerLMInfer.from_stream(stream, N_LAYER, N_HEAD,
                                           D_MODEL, MAX_LEN, device="cpu",
                                           end_id=VOCAB + 1)
    toks, _ = tm.generate(batch=1, max_out_len=10)
    state, tok, mine = tm._init_state(1), torch.tensor([tm.bos_id]), []
    for t in range(10):
        logits, state = tm._step_logits(tok, state, t)
        tok = logits.argmax(-1)
        mine.append(int(tok))
    assert toks.numpy()[0].tolist() == mine


# --------------------------------------------------------------------------
# no host reads inside a decode (what a CUDA graph cannot hold)

@pytest.fixture
def no_host_reads(monkeypatch):
    def refuse(name):
        def call(*args, **kwargs):
            raise AssertionError("%s reads a device value back to the host "
                                 "inside a decode" % name)
        return call
    for name in ("item", "cpu", "tolist", "numpy", "nonzero", "__bool__",
                 "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse("Tensor." + name))
    monkeypatch.setattr(torch, "nonzero", refuse("torch.nonzero"))
    real = torch.tensor

    def tensor(*args, **kwargs):
        if kwargs.get("device") is not None:
            raise AssertionError("torch.tensor(device=) inside a decode")
        return real(*args, **kwargs)
    monkeypatch.setattr(torch, "tensor", tensor)
    return monkeypatch


def test_decodes_read_nothing_back_to_the_host(mt, lm, no_host_reads):
    main, scope, stream = mt
    tm = TI.TransformerInfer.from_stream(stream, N_LAYER, N_HEAD, D_MODEL,
                                         MAX_LEN, device="cpu")
    src, mask = (torch.from_numpy(a) for a in _src(7))
    tm.translate(src, mask, beam_size=2, max_out_len=5, length_penalty=0.5)
    tm.translate_greedy(src, mask, max_out_len=5)
    lmain, lscope, lstream = lm
    tl = TI.TransformerLMInfer.from_stream(lstream, N_LAYER, N_HEAD,
                                           D_MODEL, MAX_LEN, device="cpu")
    tl.generate(batch=2, max_out_len=5)
    tl.generate(batch=2, max_out_len=5, beam_size=2)
    with pytest.raises(AssertionError, match="Tensor.item"):
        torch.ones(1).item()
