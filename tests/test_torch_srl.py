"""The label_semantic_roles tagger (``models/label_semantic_roles.py``,
the reference book's ``db_lstm``) in the PyTorch port against the JAX
package, at small widths: word_dim 8, lstm size 32, depth 4 (forward,
reverse, forward, reverse), 9 labels, vocabularies of 100, with the
book's peepholes and activations (gate sigmoid, cell sigmoid,
candidate relu), the CRF loss, Viterbi decoding and chunk_eval.

* both packages emit the same Program JSON (main and startup), built
  under ``unique_name.guard()``;
* from the JAX package's startup values, 3 Adam steps at 2e-4 give the
  JAX package's losses and parameters within 2e-4 of max(1, max|w|)
  per tensor; after them, on the last batch, the Viterbi paths are
  identical and the chunk metrics equal;
* ``run_steps(K=3)`` on the CPU gives what 3 ``run()`` calls give,
  bitwise, with one thread (CPU reductions part run to run otherwise).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models import label_semantic_roles as SRL

TOL = 2e-4
SMALL = dict(word_dict_len=100, pred_dict_len=100, label_dict_len=9,
             word_dim=8, mark_dim=5, hidden_dim=32, depth=4)


def _net(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        net = SRL.build_train_net(pkg, learning_rate=2e-4, **SMALL)
    return main, startup, net


def _batch(pkg, seed):
    return SRL.make_batch(pkg, batch=6, seed=seed, **SMALL)[0]


def test_to_json_identical():
    jmain, jstart, _ = _net(jfluid)
    tmain, tstart, _ = _net(tfluid)
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    lstms = [op for op in tmain.global_block().ops if op.type == "lstm"]
    assert [op.attr("is_reverse") for op in lstms] == [False, True] * 2
    assert all(op.attr("use_peepholes") for op in lstms)


def test_batch_lengths_and_ids():
    feed, lens = SRL.make_batch(tfluid, batch=64, seed=0)
    assert lens == np.random.RandomState(0).randint(5, 30, 64).tolist()
    assert max(lens) <= 32 and sum(lens) & (sum(lens) - 1)  # pads
    verb = feed["verb"].data.ravel()
    starts = np.cumsum([0] + lens[:-1])
    assert all((verb[s:s + n] == verb[s]).all()
               for s, n in zip(starts, lens))
    assert feed["target"].data.max() < SRL.LABEL_DICT_LEN


def _jax_scope(jstart, names):
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstart)
    return jscope, {n: np.asarray(jscope.find_var(n)) for n in names
                    if jscope.find_var(n) is not None}


def test_three_adam_steps_match_jax():
    jmain, jstart, jnet = _net(jfluid)
    tmain, _, tnet = _net(tfluid)
    names = [v.name for v in jmain.list_vars() if v.persistable]
    jscope, state = _jax_scope(jstart, names)
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, state, "cpu")
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    for step in range(3):
        feed = _batch(jfluid, step)
        with jfluid.scope_guard(jscope):
            jl, = jexe.run(jmain, feed=feed, fetch_list=[jnet["loss"]])
        tl, = texe.run(tmain, feed=_batch(tfluid, step),
                       fetch_list=[tnet["loss"]], scope=tscope)
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=TOL, atol=TOL)
    for n in state:
        want = np.asarray(jscope.find_var(n))
        got = tscope.get_numpy(n)
        tol = TOL * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=n)
    assert np.array_equal(tscope.get_numpy("emb"), state["emb"])
    assert not np.array_equal(tscope.get_numpy("crfw"), state["crfw"])

    # decode the last batch from the stepped scopes (a program without
    # the optimizer: the paths and the chunk metrics only)
    jfetch = [jnet["path"]] + list(jnet["chunks"])
    tfetch = [tnet["path"]] + list(tnet["chunks"])
    jinfer = jmain.prune([v.name for v in jfetch])
    tinfer = tmain.prune([v.name for v in tfetch])
    with jfluid.scope_guard(jscope):
        want = jexe.run(jinfer, feed=_batch(jfluid, 2), fetch_list=jfetch)
    got = texe.run(tinfer, feed=_batch(tfluid, 2), fetch_list=tfetch,
                   scope=tscope)
    path = np.asarray(got[0])
    assert path.shape == (sum(SRL.make_batch(tfluid, 6, 2, **SMALL)[1]),
                          1)
    np.testing.assert_array_equal(path, np.asarray(want[0]))
    assert (path >= 0).all() and (path < SMALL["label_dict_len"]).all()
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert int(np.asarray(got[4])[0]) > 0           # label chunks seen


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_steps_equals_run_calls(one_thread):
    tmain, tstart, tnet = _net(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    init = tfluid.Scope()
    exe.run(tstart, scope=init)
    names = [v.name for v in tmain.list_vars() if v.persistable
             and init.find_var(v.name) is not None]
    state = {n: init.get_numpy(n) for n in names}
    feed = _batch(tfluid, 4)

    def scope():
        s = tfluid.Scope()
        tfluid.load_numpy_state(s, state, "cpu")
        return s

    a = scope()
    eager = [exe.run(tmain, feed=feed, fetch_list=[tnet["loss"]],
                     scope=a)[0] for _ in range(3)]
    b = scope()
    graph = exe.run_steps(tmain, feeds=[feed] * 3, k=3,
                          fetch_list=[tnet["loss"]], scope=b)
    np.testing.assert_array_equal(
        np.concatenate([np.ravel(o[0]) for o in graph]),
        np.concatenate([np.ravel(e) for e in eager]))
    for n in names:
        np.testing.assert_array_equal(b.get_numpy(n), a.get_numpy(n),
                                      err_msg=n)
    assert eager[-1] < eager[0]
