"""The CRF, CTC and chunk ops of the PyTorch port (``ops/crf_ctc.py``)
against the JAX package, on the CPU.

* ``linear_chain_crf``, ``crf_decoding``, ``warpctc``, ``ctc_align`` and
  ``chunk_eval`` as one-op Programs through both Executors
  (``tools/op_sweep.detection_cases``, the card sweep's cases): forward
  at rtol 1e-5 / atol 1e-6, the ``calc_gradient`` of the CRF's Emission
  and Transition (start, end and transition rows all live) and of
  warpctc's Logits against ``jax.grad`` at rtol 1e-4 / atol 1e-5
  (tests/torch_op_harness.py). LoD totals are no power of two (the
  bucket pads them) and some sequences are empty; the cases hold ties
  in Viterbi, an impossible CTC alignment, ``norm_by_times``, a blank
  that is not 0 (the bucket's zero pad rows then survive ctc_align),
  excluded chunk types and the plain scheme;
* the CRF NLL and the Viterbi path against brute force over every
  path, and warpctc against ``torch.nn.functional.ctc_loss`` (an
  independent control, tests/test_detection_crf_ctc.py's): feasible
  alignments at rtol 1e-4, an impossible one a huge finite loss where
  ``ctc_loss`` gives inf;
* the layers (``linear_chain_crf``, ``crf_decoding``, ``warpctc``,
  ``ctc_greedy_decoder``, ``chunk_eval``) emit the JAX package's Program
  JSON, and ``ctc_greedy_decoder`` decodes as the JAX package does.
"""

import itertools

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.tools import op_sweep

from torch_op_harness import check

OPS = ("linear_chain_crf", "crf_decoding", "warpctc", "ctc_align",
       "chunk_eval")
CASES = [c for c in op_sweep.detection_cases() if c[0] in OPS]


@pytest.mark.parametrize("case", CASES, ids=[
    "%s-%d" % (c[0], i) for i, c in enumerate(CASES)])
def test_op_matches_jax(case):
    op_type, inputs, attrs, outs, wrt = case
    got = check(op_type, inputs, attrs, outs, wrt)
    if op_type == "warpctc" and not wrt:
        # the impossible alignment: huge and finite, as in the JAX package
        loss = got["out_loss_0"].ravel()
        assert np.isfinite(loss).all() and loss.max() > 1e29


def test_cases_cover_every_op():
    assert {c[0] for c in CASES} == set(OPS)
    attrs = [c[2] for c in CASES]
    assert any(a.get("excluded_chunk_types") for a in attrs)
    assert any(a.get("chunk_scheme") == "plain" for a in attrs)
    assert any(a.get("norm_by_times") for a in attrs)


def _run_one(op_type, inputs, attrs, outs):
    prog, feed, fetch = op_sweep.one_op_program(tfluid, op_type, inputs,
                                                attrs, outs)
    return tfluid.Executor(tfluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=fetch, scope=tfluid.Scope())


def _path_score(emission, trans, path):
    w_start, w_end, w = trans[0], trans[1], trans[2:]
    s = w_start[path[0]] + w_end[path[-1]]
    s += sum(emission[i, p] for i, p in enumerate(path))
    return s + sum(w[path[i], path[i + 1]] for i in range(len(path) - 1))


def test_crf_against_brute_force():
    d, lens = 3, [4, 2, 3]
    rng = np.random.RandomState(0)
    emission = rng.randn(sum(lens), d).astype(np.float32)
    trans = (rng.randn(d + 2, d) * 0.5).astype(np.float32)
    label = rng.randint(0, d, (sum(lens), 1)).astype(np.int32)
    nll, = _run_one("linear_chain_crf",
                    {"Emission": op_sweep.Seq(emission, lens),
                     "Label": op_sweep.Seq(label, lens),
                     "Transition": trans}, {}, ["LogLikelihood"])
    path, = _run_one("crf_decoding",
                     {"Emission": op_sweep.Seq(emission, lens),
                      "Transition": trans}, {}, ["ViterbiPath"])
    starts = np.cumsum([0] + lens[:-1])
    for k, (s, n) in enumerate(zip(starts, lens)):
        em = emission[s:s + n].astype(np.float64)
        paths = list(itertools.product(range(d), repeat=n))
        scores = [_path_score(em, trans, p) for p in paths]
        gold = _path_score(em, trans, tuple(label[s:s + n, 0]))
        np.testing.assert_allclose(nll[k, 0], np.log(np.sum(np.exp(
            scores))) - gold, rtol=1e-5)
        assert tuple(path[s:s + n, 0]) == paths[int(np.argmax(scores))]


def _ctc(logits, labels, in_lens, lab_lens, blank=0):
    return _run_one("warpctc",
                    {"Logits": op_sweep.Seq(logits, in_lens),
                     "Label": op_sweep.Seq(labels, lab_lens)},
                    {"blank": blank}, ["Loss"])[0].ravel()


def test_warpctc_against_torch_ctc_loss():
    b, t, c = 4, 9, 6
    rng = np.random.RandomState(2)
    in_lens, lab_lens = [9, 7, 5, 8], [3, 2, 4, 1]
    logits = rng.randn(sum(in_lens), c).astype(np.float32)
    labels = rng.randint(1, c, (sum(lab_lens), 1)).astype(np.int32)
    got = _ctc(logits, labels, in_lens, lab_lens)
    padded = np.zeros((t, b, c), np.float32)
    for k, (s, n) in enumerate(zip(np.cumsum([0] + in_lens[:-1]),
                                   in_lens)):
        padded[:n, k] = logits[s:s + n]
    want = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(padded), -1),
        torch.from_numpy(labels.ravel().astype(np.int64)),
        torch.tensor(in_lens), torch.tensor(lab_lens), blank=0,
        reduction="none").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # 3 equal labels need 5 steps; 4 steps cannot align them
    imp = _ctc(logits[:4], np.full((3, 1), 2, np.int32), [4], [3])
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(logits[:4, None]), -1),
        torch.full((1, 3), 2), torch.tensor([4]), torch.tensor([3]),
        reduction="none")
    assert np.isinf(ref.numpy()).all() and np.isfinite(imp).all()
    assert imp[0] > 1e29


def _layers_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        L = pkg.layers
        em = L.data("em", [5], lod_level=1)
        lab = L.data("lab", [1], dtype="int64", lod_level=1)
        nll = L.linear_chain_crf(em, lab,
                                 param_attr=pkg.ParamAttr(name="crfw"))
        path = L.crf_decoding(em, param_attr=pkg.ParamAttr(name="crfw"))
        chunks = L.chunk_eval(path, lab, chunk_scheme="IOB",
                              num_chunk_types=2, excluded_chunk_types=[1])
        logits = L.data("logits", [6], lod_level=1)
        ctc = L.warpctc(logits, lab, blank=0, norm_by_times=True)
        decoded = L.ctc_greedy_decoder(logits, blank=0)
    return main, startup, [nll, path, ctc, decoded] + list(chunks)


def test_layers_match_jax():
    jmain, jstart, jfetch = _layers_program(jfluid)
    tmain, tstart, tfetch = _layers_program(tfluid)
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    rng = np.random.RandomState(3)
    lens = [4, 3, 6]
    logits = np.round(rng.randn(13, 6)).astype(np.float32)   # argmax ties
    feed = {"em": (rng.randn(13, 5).astype(np.float32), lens),
            "lab": (rng.randint(1, 5, (13, 1)).astype(np.int64), lens),
            "logits": (logits, lens)}
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jexe.run(jstart)
        crfw = np.asarray(jscope.find_var("crfw"))
        want = jexe.run(jmain, feed={k: jfluid.create_lod_tensor(v, [n])
                                     for k, (v, n) in feed.items()},
                        fetch_list=jfetch)
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, {"crfw": crfw}, "cpu")
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed={k: tfluid.create_lod_tensor(v, [n])
                     for k, (v, n) in feed.items()},
        fetch_list=tfetch, scope=tscope)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
