"""The port's beam search against the JAX package: the dense step, the
first step, the backtrack, the whole search, greedy against beam 1, the
state reorder, and the two ops in a Program through both Executors (the
seven cases of ``tests/test_beam_search.py``), plus cases with exact ties.

The same numpy-seeded inputs go through ``paddle_tpu``'s functions and
the port's. Ids and parents are held exactly; scores at rtol 1e-6 where
the port is handed the JAX package's log-probs, and at 1e-5 where each
package takes its own log_softmax of the same logits. The tie cases build
tables with equal entries (duplicated vocabulary columns, the NEG_INF of
dead and first-step beams) where ``lax.top_k`` puts the lower index first;
the port must choose the same rows and tokens.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import decoding as JD
from paddle_tpu.ops import beam_search as JB
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models import decoding as TD
from paddle_tpu_torch.ops import beam_search as TB

SCORE_RTOL = 1e-6        # same log-probs in, one add per candidate
SEARCH_RTOL = 1e-5       # each package's own log_softmax


def _logp(rng, rows, vocab):
    return np.log(rng.dirichlet(np.ones(vocab), rows)).astype(np.float32)


def _both_steps(pre_ids, pre_scores, logp, beam, end_id, first=False):
    ref = JB.beam_search_step(jnp.asarray(pre_ids), jnp.asarray(pre_scores),
                              jnp.asarray(logp), beam, end_id,
                              first_step=first)
    got = TB.beam_search_step(torch.from_numpy(pre_ids),
                              torch.from_numpy(pre_scores),
                              torch.from_numpy(logp), beam, end_id,
                              first_step=first)
    return [t.numpy() for t in got], [np.asarray(r) for r in ref]


def _assert_step(got, ref):
    (sel, sc, par), (rsel, rsc, rpar) = got, ref
    assert sel.dtype == np.int32 and par.dtype == np.int32
    np.testing.assert_array_equal(sel, rsel)
    np.testing.assert_array_equal(par, rpar)
    np.testing.assert_allclose(sc, rsc, rtol=SCORE_RTOL)


def test_beam_search_step_matches_jax():
    rng = np.random.RandomState(0)
    beam, vocab, batch = 3, 7, 2
    pre_ids = rng.randint(0, vocab, batch * beam).astype(np.int32)
    pre_ids[1] = 0                            # one finished beam (end_id 0)
    pre_scores = rng.randn(batch * beam).astype(np.float32)
    got, ref = _both_steps(pre_ids, pre_scores,
                           _logp(rng, batch * beam, vocab), beam, 0)
    _assert_step(got, ref)
    # the finished beam survives with its frozen score, re-emitting end_id
    assert pre_scores[1] in got[1] or (got[0][got[2] == 1] == 0).all()


def test_beam_search_first_step_matches_jax():
    rng = np.random.RandomState(1)
    beam, vocab, batch = 2, 5, 2
    pre_ids = np.full(batch * beam, 1, np.int32)
    pre_scores = np.zeros(batch * beam, np.float32)
    got, ref = _both_steps(pre_ids, pre_scores,
                           _logp(rng, batch * beam, vocab), beam, 0,
                           first=True)
    _assert_step(got, ref)
    np.testing.assert_array_equal(got[2], [0, 0, 2, 2])


@pytest.mark.parametrize("case", ["dup_columns", "dead_beams",
                                  "first_step_short_vocab"])
def test_beam_search_step_ties_match_jax(case):
    """Exact ties: duplicated columns give equal candidates within a row
    and across the beams of one source; dead beams and first-step masked
    beams fill the top-k with NEG_INF when a source has fewer live
    candidates than beams."""
    rng = np.random.RandomState(2)
    if case == "dup_columns":
        beam, vocab, batch = 3, 6, 2
        logp = _logp(rng, batch * beam, vocab)
        logp[:, 4] = logp[:, 1]               # tie within each row
        logp[1] = logp[0]                     # tie across two beams
        pre_ids = np.full(batch * beam, 3, np.int32)
        pre_scores = np.zeros(batch * beam, np.float32)
        first = False
    elif case == "dead_beams":
        beam, vocab, batch = 3, 2, 2
        logp = _logp(rng, batch * beam, vocab)
        pre_ids = np.array([0, 0, 1, 0, 0, 0], np.int32)   # end_id 0
        pre_scores = rng.randn(batch * beam).astype(np.float32)
        pre_scores[3] = pre_scores[4]         # two frozen beams tied
        first = False
    else:
        beam, vocab, batch = 4, 2, 2
        logp = _logp(rng, batch * beam, vocab)
        pre_ids = np.full(batch * beam, 1, np.int32)
        pre_scores = np.zeros(batch * beam, np.float32)
        first = True
    got, ref = _both_steps(pre_ids, pre_scores, logp, beam, 0, first)
    _assert_step(got, ref)
    # the tie really reached the top-k
    if case == "first_step_short_vocab":
        assert (got[1] == TB.NEG_INF).any()
    else:
        assert len(set(got[1].tolist())) < len(got[1])


def test_top_k_breaks_ties_toward_the_lower_index():
    x = np.array([[1.0, 3.0, 3.0, -1e9, 3.0, -1e9, -1e9]], np.float32)
    v, i = TB.top_k(torch.from_numpy(x), 6)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(i.numpy(), [[1, 2, 4, 0, 3, 5]])
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


def test_beam_search_decode_backtrack_matches_jax():
    # batch 1, beam 2, T 3: the hand-built tree of test_beam_search.py
    ids = np.array([[5, 3], [7, 8], [2, 0]], np.int32)
    parents = np.array([[0, 0], [0, 1], [1, 0]], np.int32)
    scores = np.array([-1.0, -2.0], np.float32)
    rs, rsc = JB.beam_search_decode(jnp.asarray(ids), jnp.asarray(parents),
                                    jnp.asarray(scores), 2, 0)
    s, sc = TB.beam_search_decode(torch.from_numpy(ids),
                                  torch.from_numpy(parents),
                                  torch.from_numpy(scores), 2, 0)
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(s.numpy()[0, 0], [3, 8, 2])
    np.testing.assert_array_equal(s.numpy()[0, 1], [5, 7, 0])
    np.testing.assert_array_equal(sc.numpy(), np.asarray(rsc))


def test_beam_search_decode_random_tree_matches_jax():
    rng = np.random.RandomState(3)
    steps, batch, beam = 7, 3, 4
    ids = rng.randint(0, 5, (steps, batch * beam)).astype(np.int32)
    parents = (rng.randint(0, beam, (steps, batch * beam))
               + np.repeat(np.arange(batch) * beam, beam)).astype(np.int32)
    scores = rng.randn(batch * beam).astype(np.float32)
    rs, rsc = JB.beam_search_decode(jnp.asarray(ids), jnp.asarray(parents),
                                    jnp.asarray(scores), beam, 0)
    s, sc = TB.beam_search_decode(torch.from_numpy(ids),
                                  torch.from_numpy(parents),
                                  torch.from_numpy(scores), beam, 0)
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(rsc))


# --------------------------------------------------------------------------
# whole searches over a fixed Markov table: logits_fn(tok, state, t)

def _markov(trans, sharpen, acc=False):
    """(JAX logits_fn, port logits_fn) over the table ``trans``; with
    ``acc`` each row's state counts its emitted tokens and biases the
    logits, so a wrong reorder changes the result."""
    jt, tt = jnp.asarray(trans), torch.from_numpy(trans)

    def jfn(tok, state, t):
        logits = jt[tok] * sharpen
        if acc:
            logits = logits + state["acc"][:, None] * 0.01
            state = {"acc": state["acc"] + tok}
        return logits, state

    def tfn(tok, state, t):
        logits = tt[tok.long()] * sharpen
        if acc:
            logits = logits + state["acc"][:, None] * 0.01
            state = {"acc": state["acc"] + tok}
        return logits, state
    return jfn, tfn


def _assert_search(got, ref):
    (s, sc), (rs, rsc) = got, ref
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_allclose(sc.numpy(), np.asarray(rsc),
                               rtol=SEARCH_RTOL)


@pytest.mark.parametrize("length_penalty", [0.0, 0.6])
def test_full_beam_search_matches_jax(length_penalty):
    rng = np.random.RandomState(4)
    vocab, beam, max_len, batch = 11, 3, 6, 2
    trans = _logp(rng, vocab, vocab)
    jfn, tfn = _markov(trans, 3.0)
    ref = JD.beam_search(jfn, {}, 1, 0, max_len, batch=batch,
                         beam_size=beam, length_penalty=length_penalty)
    got = TD.beam_search(tfn, {}, 1, 0, max_len, batch=batch,
                         beam_size=beam, length_penalty=length_penalty)
    _assert_search(got, ref)
    assert (np.diff(got[1].numpy(), axis=1) <= 0).all()


def test_beam_search_with_tied_logits_matches_jax():
    """Duplicated vocabulary columns give exactly tied continuations at
    every step, and end_id ends beams early (frozen NEG_INF rows)."""
    rng = np.random.RandomState(5)
    vocab, beam, max_len, batch = 8, 4, 7, 2
    trans = _logp(rng, vocab, vocab)
    trans[:, 5] = trans[:, 2]
    trans[:, 7] = trans[:, 3]
    trans[:, 0] += 1.5                        # end_id 0 comes often
    jfn, tfn = _markov(trans, 2.0)
    ref = JD.beam_search(jfn, {}, 1, 0, max_len, batch=batch,
                         beam_size=beam)
    got = TD.beam_search(tfn, {}, 1, 0, max_len, batch=batch,
                         beam_size=beam)
    _assert_search(got, ref)
    assert (got[0].numpy() == 0).any()


def test_greedy_search_matches_jax_and_beam1():
    rng = np.random.RandomState(6)
    vocab, max_len = 9, 5
    trans = _logp(rng, vocab, vocab)
    trans[:, 4] = trans[:, 6]                 # argmax ties go low
    jfn, tfn = _markov(trans, 2.0)
    ref = JD.greedy_search(jfn, {}, 1, 0, max_len, batch=2)
    got = TD.greedy_search(tfn, {}, 1, 0, max_len, batch=2)
    assert got[0].dtype == torch.int32
    _assert_search(got, ref)
    b1, _ = TD.beam_search(tfn, {}, 1, 0, max_len, batch=2, beam_size=1)
    np.testing.assert_array_equal(got[0].numpy(), b1.numpy()[:, 0, :])


def test_beam_state_reorder_matches_jax():
    """State rows follow their beam (the parent gather); the logits read
    the state, so a wrong reorder would part the two packages."""
    rng = np.random.RandomState(7)
    vocab, beam, max_len, batch = 8, 2, 4, 2
    trans = _logp(rng, vocab, vocab)
    jfn, tfn = _markov(trans, 3.0, acc=True)
    ref = JD.beam_search(jfn, {"acc": jnp.zeros(batch * beam)}, 1, 0,
                         max_len, batch=batch, beam_size=beam)
    got = TD.beam_search(tfn, {"acc": torch.zeros(batch * beam)}, 1, 0,
                         max_len, batch=batch, beam_size=beam)
    _assert_search(got, ref)
    state = {"acc": torch.arange(4.0), "n": 3, "w": torch.zeros(2, 5)}
    out = TD._reorder_state(state, torch.tensor([2, 2, 0, 1],
                                                dtype=torch.int32))
    assert out["acc"].tolist() == [2.0, 2.0, 0.0, 1.0]
    assert out["n"] == 3 and out["w"] is state["w"]


def test_beam_search_ops_in_program_match_jax():
    """The beam_search op (first step) and beam_search_decode through both
    Executors on the same feed."""
    rng = np.random.RandomState(8)
    beam, vocab = 2, 6
    feed = {"pre_ids": np.full((beam, 1), 1, np.int64),
            "pre_scores": np.zeros((beam, 1), np.float32),
            "scores": _logp(rng, beam, vocab)}

    def program(pkg):
        prog = pkg.Program()
        # under the guard, so that layer names do not depend on what
        # else this process has built in either package
        with pkg.program_guard(prog, pkg.Program()), \
                pkg.unique_name.guard():
            pi = pkg.layers.data("pre_ids", [1], dtype="int64")
            ps = pkg.layers.data("pre_scores", [1])
            sc = pkg.layers.data("scores", [vocab])
            blk = prog.current_block()
            outs = [blk.create_var(name="sel_ids", dtype="int64"),
                    blk.create_var(name="sel_scores"),
                    blk.create_var(name="parent_idx", dtype="int32")]
            blk.append_op(type="beam_search",
                          inputs={"pre_ids": [pi], "pre_scores": [ps],
                                  "scores": [sc]},
                          outputs={"selected_ids": [outs[0]],
                                   "selected_scores": [outs[1]],
                                   "parent_idx": [outs[2]]},
                          attrs={"beam_size": beam, "end_id": 0,
                                 "is_first_step": True})
            # one recorded step: [T = 1, B*W] ids and parents
            ids = pkg.layers.reshape(outs[0], [1, beam])
            parents = pkg.layers.reshape(outs[2], [1, beam])
            sent = blk.create_var(name="sent", dtype="int64")
            ssc = blk.create_var(name="sent_scores")
            blk.append_op(type="beam_search_decode",
                          inputs={"Ids": [ids], "Parents": [parents],
                                  "Scores": [outs[1]]},
                          outputs={"SentenceIds": [sent],
                                   "SentenceScores": [ssc]},
                          attrs={"beam_size": beam, "end_id": 0})
        return prog, outs + [sent, ssc]

    jprog, jouts = program(jfluid)
    with jfluid.scope_guard(jfluid.Scope()):
        ref = jfluid.Executor(jfluid.CPUPlace()).run(
            jprog, feed=feed, fetch_list=jouts)
    tprog, touts = program(tfluid)
    assert tprog.to_json() == jprog.to_json()
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tprog, feed=feed, fetch_list=touts, scope=tfluid.Scope())
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype
        if g.dtype == np.float32:
            np.testing.assert_allclose(g, r, rtol=SCORE_RTOL)
        else:
            np.testing.assert_array_equal(g, r)
    assert got[3].shape == (1, beam, 1)


def test_beam_search_layers_build_the_jax_ops():
    def program(pkg):
        prog = pkg.Program()
        with pkg.program_guard(prog, pkg.Program()), \
                pkg.unique_name.guard():
            pi = pkg.layers.data("pre_ids", [1], dtype="int64")
            ps = pkg.layers.data("pre_scores", [1])
            sc = pkg.layers.data("scores", [6])
            sel, ssc, _ = pkg.layers.beam_search(pi, ps, None, sc, 2, 0)
            pkg.layers.beam_search_decode(sel, ssc, 2, 0)
        return prog
    assert program(tfluid).to_json() == program(jfluid).to_json()
