"""LoD feeds in the PyTorch port against the JAX package
(tests/test_lod_bucketing.py's ground, on the CPU).

The flat rows of a LoD feed are zero-padded to the next power of two
(flag ``lod_bucketing``), the lengths ride beside them as ``@LOD`` and
the longest length's power of two as ``@MAXLEN``; the reductions
(``mean``, the five ``reduce_*``, ``l1_norm``, ``squared_l2_norm``) and
``accuracy`` drop the pad rows, and fetched LoD values are cut to their
real rows. Each program runs in both packages on the same numpy inputs
(and, with parameters, from the JAX package's startup values): floats at
rtol 1e-6 / atol 1e-6 where the port sums in the JAX package's order,
1e-5 through an fc and a softmax, integers exactly.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import flags
from paddle_tpu_torch.core import executor as E


def _lod(pkg, arr, lengths):
    return pkg.create_lod_tensor(np.asarray(arr), [list(lengths)])


def _both(build, feed, rtol=1e-6, atol=1e-6):
    """``build(pkg) -> fetch vars`` in both packages, run once from the
    JAX package's startup values on ``feed(pkg)``; returns the port's
    fetches after holding them to the JAX package's."""
    progs = {}
    for pkg in (jfluid, tfluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            fetch = build(pkg)
        progs[pkg] = (main, startup, [v.name for v in fetch])
    jmain, jstart, jfetch = progs[jfluid]
    tmain, tstart, tfetch = progs[tfluid]
    assert tmain.to_json() == jmain.to_json()
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        want = jexe.run(jmain, feed=feed(jfluid), fetch_list=jfetch)
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, {
        n: np.asarray(jscope.find_var(n)) for n in jscope.local_var_names()
        if jscope.find_var(n) is not None}, "cpu")
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed(tfluid), fetch_list=tfetch, scope=tscope)
    for n, g, w in zip(tfetch, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (n, g.shape,
                                                          w.shape, g.dtype,
                                                          w.dtype)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=n)
    return got


def test_lod_tensor_api_is_the_jax_packages():
    arr = np.arange(10, dtype=np.float32).reshape(5, 2)
    for pkg in (jfluid, tfluid):
        t = pkg.create_lod_tensor(arr, [[2, 3]])
        assert t.lod == [[0, 2, 5]]
        assert t.recursive_sequence_lengths() == [[2, 3]]
        assert t.num_sequences() == 2 and t.shape() == (5, 2)
        seqs = pkg.create_lod_tensor([arr[:2], arr[2:]])
        assert seqs.recursive_sequence_lengths() == [[2, 3]]
    assert tfluid.LoDTensor is tfluid.core.LoDTensor


@pytest.mark.parametrize("total,lens,bucket", [
    (5, [2, 3], 8), (6, [3, 3], 8), (7, [3, 4], 8), (8, [8], 8),
    (9, [1, 8], 16), (1, [1], 1)])
def test_feeds_bucket_to_a_power_of_two(total, lens, bucket):
    arr = np.arange(total * 2, dtype=np.float32).reshape(total, 2)
    arrays, static = E._normalize_feeds({"x": _lod(tfluid, arr, lens)})
    assert arrays["x"].shape == (bucket, 2)
    assert not arrays["x"][total:].any()
    assert arrays["x@LOD"].dtype == np.int32
    assert arrays["x@LOD"].tolist() == lens
    mx = max(lens)
    assert static == {"x@MAXLEN": 1 << (mx - 1).bit_length()}


def test_bucketing_flag_off_keeps_the_total():
    flags.set_flag("lod_bucketing", False)
    try:
        arrays, _ = E._normalize_feeds(
            {"x": _lod(tfluid, np.ones((5, 2), np.float32), [2, 3])})
    finally:
        flags.set_flag("lod_bucketing", None)
    assert arrays["x"].shape == (5, 2)


def test_fetch_is_trimmed_to_the_real_rows():
    for total, lens in ((5, [2, 3]), (6, [3, 3]), (7, [3, 4])):
        arr = np.random.RandomState(total).rand(total, 2).astype(np.float32)
        out, = _both(lambda P: [P.layers.fc(
            P.layers.data("x", [2], lod_level=1), 3)],
            lambda P: {"x": _lod(P, arr, lens)}, rtol=1e-5, atol=1e-6)
        assert out.shape == (total, 3)


def test_mean_over_bucketed_rows_is_exact():
    arr = np.arange(1, 7, dtype=np.float32).reshape(6, 1)
    out, = _both(lambda P: [P.layers.mean(P.layers.data("x", [1],
                                                       lod_level=1))],
                 lambda P: {"x": _lod(P, arr, [2, 4])})
    assert float(out) == pytest.approx(3.5, rel=1e-6)


def test_reductions_mask_the_pad_rows():
    arr = -np.arange(1, 7, dtype=np.float32).reshape(6, 1)   # all negative

    def build(P):
        x = P.layers.data("x", [1], lod_level=1)
        L = P.layers
        return [L.reduce_max(x), L.reduce_min(x), L.reduce_sum(x),
                L.reduce_mean(x), L.reduce_prod(x),
                L.reduce_max(x, dim=1), L.reduce_sum(x, dim=0,
                                                     keep_dim=True)]
    got = _both(build, lambda P: {"x": _lod(P, arr, [3, 3])})
    assert float(np.ravel(got[0])[0]) == -1.0    # a zero pad row must not win
    assert float(np.ravel(got[4])[0]) == pytest.approx(720.0)


def test_norms_mask_the_pad_rows():
    arr = np.random.RandomState(2).randn(5, 3).astype(np.float32)

    def build(P):
        x = P.layers.data("x", [3], lod_level=1)
        blk = P.default_main_program().current_block()
        outs = []
        for op in ("l1_norm", "squared_l2_norm"):
            o = blk.create_var(name=op + "_out")
            blk.append_op(op, {"X": [x]}, {"Out": [o]}, {})
            outs.append(o)
        return outs
    _both(build, lambda P: {"x": _lod(P, arr, [2, 3])})


def test_token_loss_pipeline_is_exact_under_bucketing():
    rng = np.random.RandomState(0)
    arr = rng.rand(6, 4).astype(np.float32)                  # pads to 8
    lbl = rng.randint(0, 5, (6, 1)).astype(np.int64)

    def build(P):
        x = P.layers.data("emb", [4], lod_level=1)
        label = P.layers.data("lbl", [1], dtype="int64", lod_level=1)
        pred = P.layers.fc(x, 5, act="softmax")
        return [P.layers.mean(P.layers.cross_entropy(pred, label))]
    _both(build, lambda P: {"emb": _lod(P, arr, [2, 4]),
                            "lbl": _lod(P, lbl, [2, 4])}, rtol=1e-5)


def test_accuracy_masks_the_pad_rows():
    p = np.zeros((6, 3), np.float32)
    p[np.arange(6), [0, 1, 2, 0, 1, 2]] = 1.0
    lab = np.array([[0], [1], [0], [0], [2], [2]], np.int64)  # 4 hits

    def build(P):
        pred = P.layers.data("pred", [3], lod_level=1)
        lbl = P.layers.data("lbl", [1], dtype="int64", lod_level=1)
        return [P.layers.accuracy(pred, lbl)]
    acc, = _both(build, lambda P: {"pred": _lod(P, p, [3, 3]),
                                   "lbl": _lod(P, lab, [3, 3])})
    assert float(np.ravel(acc)[0]) == pytest.approx(4 / 6)


def test_reduce_max_keeps_an_integer_dtype():
    arr = np.array([[-5], [-2], [-9], [-1], [-7], [-3]], np.int64)
    mx, = _both(lambda P: [P.layers.reduce_max(
        P.layers.data("x", [1], dtype="int64", lod_level=1))],
        lambda P: {"x": _lod(P, arr, [3, 3])})
    assert mx.dtype.kind == "i" and int(np.ravel(mx)[0]) == -1


def test_lengths_flow_through_row_preserving_ops():
    """embedding -> fc -> sequence_pool: the pool reads the feed's
    lengths through the two ops that keep the rows."""
    ids = np.random.RandomState(3).randint(0, 20, (7, 1)).astype(np.int64)

    def build(P):
        w = P.layers.data("w", [1], dtype="int64", lod_level=1)
        h = P.layers.fc(P.layers.embedding(w, size=[20, 4]), 3, act="tanh")
        return [P.layers.sequence_pool(h, "sum"), h]
    pooled, h = _both(build, lambda P: {"w": _lod(P, ids, [3, 0, 4])},
                      rtol=1e-5)
    assert pooled.shape == (3, 3) and h.shape == (7, 3)
    np.testing.assert_allclose(pooled[0], h[:3].sum(0), rtol=1e-5)
    assert not pooled[1].any()


def test_run_steps_takes_per_step_lod_feeds():
    """Totals 5, 6 and 7 bucket to one signature: one K=3 dispatch over
    the three gives what three run() calls give."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [2], lod_level=1)
        h = tfluid.layers.fc(x, 3)
        loss = tfluid.layers.mean(tfluid.layers.sequence_pool(h, "max"))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    init = tfluid.Scope()
    exe.run(startup, scope=init)
    state = {n: init.get_numpy(n) for n in init.local_var_names()}
    rng = np.random.RandomState(1)
    feeds = [{"x": _lod(tfluid, rng.rand(t, 2).astype(np.float32), ln)}
             for t, ln in ((5, [2, 3]), (6, [3, 3]), (7, [3, 4]))]
    torch.set_num_threads(1)
    sa, sb = tfluid.Scope(), tfluid.Scope()
    tfluid.load_numpy_state(sa, state, "cpu")
    tfluid.load_numpy_state(sb, state, "cpu")
    want = [exe.run(main, feed=f, fetch_list=[loss, h], scope=sa)
            for f in feeds]
    got = exe.run_steps(main, feeds=feeds, fetch_list=[loss, h], scope=sb)
    assert len(exe._megasteps) == 1
    for (wl, wh), (gl, gh) in zip(want, got):
        assert np.array_equal(wl, gl)
        assert np.array_equal(wh, gh)          # trimmed per step
    assert [g[1].shape[0] for g in got] == [5, 6, 7]
    for n in state:
        assert np.array_equal(sa.get_numpy(n), sb.get_numpy(n)), n
