"""SelectedRows, its host ops and the sparse optimizer branches in the
PyTorch port against the JAX package.

* ``SelectedRows.to_dense`` / ``from_dense`` / ``merge`` give the JAX
  package's rows and values;
* ``split_ids``, ``split_selected_rows``, ``merge_selected_rows`` and
  ``lookup_sparse_table`` run through both Executors on the same values
  and agree exactly (they move and sum rows; duplicate sums of a few
  rows of small integers are exact);
* ``sgd`` with a SelectedRows gradient and lazy ``adam`` (after
  ``merge_selected_rows``: duplicate ids summed) equal the JAX package at
  rtol 1e-6 on the touched rows, over 3 steps, and leave every other row
  of the param and of both moments bitwise as it was;
* ``Executor.run_steps`` refuses a program with a host op.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core.selected_rows import SelectedRows as JSR
from paddle_tpu_torch.core.selected_rows import SelectedRows as TSR

SR = "selected_rows"


def _pair(rows, value, height):
    return (JSR(np.asarray(rows, np.int64), np.asarray(value, np.float32),
                height),
            TSR(np.asarray(rows, np.int64), np.asarray(value, np.float32),
                height))


def _same_sr(t, j):
    rows, value = t.numpy()
    np.testing.assert_array_equal(rows, j.rows)
    np.testing.assert_array_equal(value, j.value)
    assert t.height == j.height


def test_value_type_matches_jax():
    rng = np.random.RandomState(0)
    j, t = _pair([3, 1, 3, 7], rng.randn(4, 2), 9)
    np.testing.assert_array_equal(t.to_dense().numpy(), j.to_dense())
    j2, t2 = _pair([7, 0], rng.randn(2, 2), 9)
    _same_sr(t.merge(t2), j.merge(j2))
    dense = np.zeros((6, 3), np.float32)
    dense[[1, 4]] = rng.randn(2, 3)
    _same_sr(TSR.from_dense(dense), JSR.from_dense(dense))
    _same_sr(TSR.from_dense(dense, rows=[4, 0]),
             JSR.from_dense(dense, rows=[4, 0]))


def _host_program(pkg, sections):
    prog = pkg.Program()
    blk = prog.global_block()
    for n in ("sr_in", "dup", "table"):
        blk.create_var(name=n, persistable=True, type=SR)
    blk.create_var(name="ids", shape=(6, 1), dtype="int64", is_data=True)
    for n in ("part0", "part1", "merged", "looked", "id0", "id1", "id2"):
        blk.create_var(name=n)
    blk.append_op("split_selected_rows", {"X": ["sr_in"]},
                  {"Out": ["part0", "part1"]},
                  {"height_sections": sections})
    blk.append_op("merge_selected_rows", {"X": ["dup"]},
                  {"Out": ["merged"]}, {})
    blk.append_op("lookup_sparse_table", {"W": ["table"], "Ids": ["ids"]},
                  {"Out": ["looked"]}, {})
    blk.append_op("split_ids", {"Ids": ["ids"]},
                  {"Out": ["id0", "id1", "id2"]}, {})
    return prog


@pytest.mark.parametrize("sections", [[4, 5], []],
                         ids=["height_sections", "even"])
def test_host_ops_match_jax(sections):
    rng = np.random.RandomState(1)
    values = {"sr_in": ([1, 5, 6, 8], rng.randint(-3, 4, (4, 2)), 9),
              "dup": ([2, 2, 3, 0, 2], rng.randint(-3, 4, (5, 2)), 9),
              "table": ([3, 7, 5], rng.randint(-3, 4, (3, 2)), 10)}
    feed = {"ids": np.array([[7], [3], [9], [5], [0], [7]], np.int64)}
    fetch = ["part0", "part1", "merged", "looked", "id0", "id1", "id2"]
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    for name, (rows, value, height) in values.items():
        j, t = _pair(rows, value, height)
        jscope.set(name, j)
        tscope.set(name, t)
    with jfluid.scope_guard(jscope):
        want = jfluid.Executor(jfluid.CPUPlace()).run(
            _host_program(jfluid, sections), feed=feed, fetch_list=fetch,
            return_numpy=False)
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        _host_program(tfluid, sections), feed=feed, fetch_list=fetch,
        scope=tscope)
    for name, g, w in zip(fetch, got, want):
        if isinstance(w, JSR):
            assert isinstance(g, TSR), name
            _same_sr(g, w)
        else:
            w = np.asarray(w)
            assert g.shape == w.shape, name
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    assert got[3][2].tolist() == [0, 0]      # id 9: not in the table


def _opt_program(pkg, kind):
    """merge_selected_rows on the gradient, then sgd or lazy adam."""
    prog = pkg.Program()
    blk = prog.global_block()
    names = ["p", "lr"] + (["m1", "m2", "b1p", "b2p"] if kind == "adam"
                           else [])
    for n in names:
        blk.create_var(name=n, persistable=True)
    blk.create_var(name="g", persistable=True, type=SR)
    blk.create_var(name="gm")
    blk.append_op("merge_selected_rows", {"X": ["g"]}, {"Out": ["gm"]}, {})
    if kind == "sgd":
        blk.append_op("sgd", {"Param": ["p"], "Grad": ["gm"],
                              "LearningRate": ["lr"]},
                      {"ParamOut": ["p"]}, {})
    else:
        blk.append_op(
            "adam", {"Param": ["p"], "Grad": ["gm"], "LearningRate": ["lr"],
                     "Moment1": ["m1"], "Moment2": ["m2"],
                     "Beta1Pow": ["b1p"], "Beta2Pow": ["b2p"]},
            {"ParamOut": ["p"], "Moment1Out": ["m1"], "Moment2Out": ["m2"],
             "Beta1PowOut": ["b1p"], "Beta2PowOut": ["b2p"]},
            {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
             "update_beta_pow": True})
    return prog, [n for n in names if n != "lr"]


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_sparse_optimizers_match_jax(kind):
    rng = np.random.RandomState(2)
    height, width = 50, 4
    state = {"p": rng.randn(height, width).astype(np.float32),
             "lr": np.array([0.1], np.float32)}
    if kind == "adam":
        state.update(m1=rng.randn(height, width).astype(np.float32) * 0.1,
                     m2=np.abs(rng.randn(height, width)).astype(
                         np.float32) * 0.01,
                     b1p=np.array([0.9], np.float32),
                     b2p=np.array([0.999], np.float32))
    jprog, kept = _opt_program(jfluid, kind)
    tprog, _ = _opt_program(tfluid, kind)
    jscope, tscope = jfluid.Scope(), tfluid.Scope()
    for n, v in state.items():
        jscope.set(n, v.copy())
    tfluid.load_numpy_state(tscope, state, "cpu")
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    touched = set()
    for step in range(3):
        rows = rng.randint(0, height, 12)      # duplicate ids
        touched.update(rows.tolist())
        value = rng.randn(12, width).astype(np.float32)
        j, t = _pair(rows, value, height)
        jscope.set("g", j)
        tscope.set("g", t)
        with jfluid.scope_guard(jscope):
            jexe.run(jprog, feed={}, fetch_list=[])
        texe.run(tprog, feed={}, fetch_list=[], scope=tscope)
    idx = sorted(touched)
    untouched = sorted(set(range(height)) - touched)
    assert len(untouched) > 10
    for n in kept:
        want = np.asarray(jscope.find_var(n))
        got = tscope.get_numpy(n)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=n)
        if n in ("p", "m1", "m2"):
            assert not np.array_equal(got[idx], state[n][idx]), n
            np.testing.assert_array_equal(got[untouched],
                                          state[n][untouched], err_msg=n)


def test_run_steps_refuses_host_ops():
    prog, _ = _opt_program(tfluid, "sgd")
    with pytest.raises(NotImplementedError, match="host \\(IO\\) ops"):
        tfluid.Executor(tfluid.CPUPlace()).run_steps(
            prog, feeds=[{}, {}], scope=tfluid.Scope())


def test_wire_ops_still_raise():
    prog = tfluid.Program()
    prog.global_block().append_op(type="prefetch", inputs={}, outputs={})
    with pytest.raises(NotImplementedError, match="'prefetch'.*item 10"):
        tfluid.Executor(tfluid.CPUPlace()).run(prog, scope=tfluid.Scope())
