"""The sequence ops of the PyTorch port against the JAX package
(tests/test_sequence_ops.py's ground, on the CPU).

* every one-op case of ``tools/op_sweep.lod_cases`` outside the RNN ops:
  the 14 sequence ops (sequence_pool's seven types among them, an empty
  sequence and ties included), sequence_softmax, im2sequence,
  edit_distance and the LoD branches of roi_pool and row_conv, through
  both Executors: forward at rtol 1e-5 / atol 1e-6 and the gradients of
  ``calc_gradient`` against ``jax.grad`` at rtol 1e-4 / atol 1e-5
  (tests/torch_op_harness.py);
* MIN pooling's gradient reaches the stored winner only, and an empty
  sequence's MAX row is the dtype's lowest value and passes no gradient
  (tests/test_sequence_ops.py:166, 191), exactly;
* each sequence builder of ``layers`` emits the JAX package's Program
  JSON under ``unique_name.guard()``.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.ops import sequence_ops as S
from paddle_tpu_torch.tools import op_sweep

from torch_op_harness import check

RNN_OPS = ("lstm", "lstmp", "gru", "lstm_unit", "gru_unit")
CASES = [c for c in op_sweep.lod_cases() if c[0] not in RNN_OPS]


@pytest.mark.parametrize("case", CASES, ids=[
    "%s-%d" % (c[0], i) for i, c in enumerate(CASES)])
def test_sequence_op_matches_jax(case):
    op_type, inputs, attrs, outs, wrt = case
    check(op_type, inputs, attrs, outs, wrt)


def test_cases_cover_the_sequence_ops():
    held = {c[0] for c in CASES}
    assert held == {
        "sequence_pool", "sequence_first_step", "sequence_last_step",
        "sequence_concat", "sequence_expand", "lod_reset",
        "sequence_reshape", "sequence_slice", "sequence_erase",
        "sequence_conv", "sequence_pad", "sequence_unpad",
        "sequence_scatter", "reorder_lod_tensor_by_rank",
        "sequence_softmax", "im2sequence", "edit_distance", "roi_pool",
        "row_conv"}
    pools = {c[2]["pooltype"] for c in CASES if c[0] == "sequence_pool"}
    assert pools == {"SUM", "AVERAGE", "SQRT", "MAX", "MIN", "LAST",
                     "FIRST"}


def test_min_pool_gradient_reaches_the_winner_only():
    x = np.random.RandomState(5).rand(6, 3).astype(np.float32)
    x[1, 0] = x[0, 0] = x[:4, 0].min()            # a tie: row 0 wins
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        xv = tfluid.layers.data("xmin", [3], lod_level=1)
        pooled = tfluid.layers.sequence_pool(xv, "min")
        g, = tfluid.calc_gradient([tfluid.layers.reduce_sum(pooled)], [xv])
    exe = tfluid.Executor(tfluid.CPUPlace())
    gv, pv = exe.run(main, feed={"xmin": tfluid.create_lod_tensor(
        x, [[4, 2]])}, fetch_list=[g.name, pooled.name],
        scope=tfluid.Scope())
    gv = np.asarray(gv)[:6]
    np.testing.assert_array_equal(pv, np.stack([x[:4].min(0),
                                                x[4:].min(0)]))
    assert gv.sum() == 6.0
    for a, b in ((0, 4), (4, 6)):
        for f in range(3):
            assert gv[a + np.argmin(x[a:b, f]), f] == 1.0
    assert gv[0, 0] == 1.0 and gv[1, 0] == 0.0


def test_max_pool_of_an_empty_sequence():
    x = torch.tensor(np.random.RandomState(6).rand(5, 2).astype(np.float32),
                     requires_grad=True)
    lens = torch.tensor([3, 0, 2], dtype=torch.int32)
    out, idx = S._argext_pool(x, S.segments(lens, 5), 3, lens, is_max=True)
    np.testing.assert_array_equal(out[0].detach(), x[:3].max(0).values
                                  .detach())
    np.testing.assert_array_equal(out[2].detach(), x[3:].max(0).values
                                  .detach())
    assert (out[1] == torch.finfo(torch.float32).min).all()
    assert (idx[1] == torch.iinfo(torch.int32).max).all()
    g, = torch.autograd.grad(out.sum(), x)
    assert float(g.sum()) == 4.0             # 2 features x 2 sequences


def test_pad_rows_take_no_segment():
    lens = torch.tensor([2, 0, 3], dtype=torch.int32)
    seg = S.segments(lens, 8)
    assert seg.tolist() == [0, 0, 2, 2, 2, 3, 3, 3]
    x = torch.arange(8.0)[:, None]
    assert S.segment_sum(x, seg, 3)[:, 0].tolist() == [1.0, 0.0, 9.0]


@pytest.mark.parametrize("lens,maxlen,total", [
    ([2, 0, 3], 4, 8), ([4, 4, 4], 4, 16), ([1, 3], 4, 4)])
def test_unpad_index_is_the_stable_compaction(lens, maxlen, total):
    valid = (np.arange(maxlen)[None, :] < np.array(lens)[:, None]).ravel()
    want = np.argsort(~valid, kind="stable")[:total]
    got = S.unpad_index(torch.tensor(lens, dtype=torch.int32), maxlen,
                        total)
    assert got.tolist() == want.tolist()


def _data(pkg, name, shape, dtype="float32", lod_level=1):
    return pkg.layers.data(name, shape, dtype=dtype, lod_level=lod_level)


BUILDERS = {
    "pool": lambda P: [P.layers.sequence_pool(_data(P, "x", [4]), t)
                       for t in ("sum", "average", "sqrt", "max", "min",
                                 "last", "first")],
    "steps": lambda P: [P.layers.sequence_first_step(_data(P, "x", [3])),
                        P.layers.sequence_last_step(_data(P, "y", [3]))],
    "softmax_conv": lambda P: [
        P.layers.sequence_softmax(_data(P, "s", [1])),
        P.layers.sequence_conv(_data(P, "c", [4]), num_filters=5,
                               filter_size=3, act="tanh")],
    "expand_concat_reshape": lambda P: [
        P.layers.sequence_expand(_data(P, "x", [3], lod_level=0),
                                 _data(P, "y", [1])),
        P.layers.sequence_concat([_data(P, "a", [2]), _data(P, "b", [2])]),
        P.layers.sequence_reshape(_data(P, "r", [6]), new_dim=12)],
    "slice_erase_reset": lambda P: [
        P.layers.sequence_slice(_data(P, "x", [2]),
                                _data(P, "o", [1], "int32", 0),
                                _data(P, "l", [1], "int32", 0)),
        P.layers.sequence_erase(_data(P, "e", [1], "int64"), [2, 3]),
        P.layers.lod_reset(_data(P, "t", [2]), target_lod=[0, 2, 5])],
    "pad_unpad": lambda P: list(P.layers.sequence_pad(
        _data(P, "x", [3]), maxlen=5)) + [P.layers.sequence_unpad(
            _data(P, "p", [5, 3], lod_level=0),
            _data(P, "n", [1], "int32", 0))],
    "compat": lambda P: [
        P.layers.im2sequence(_data(P, "img", [3, 5, 5], lod_level=0),
                             filter_size=2, stride=2),
        P.layers.edit_distance(_data(P, "h", [1], "int64"),
                               _data(P, "r", [1], "int64"),
                               ignored_tokens=[0])[0]],
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builders_emit_the_jax_program(name):
    def program(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            BUILDERS[name](pkg)
        return main, startup
    (jm, js), (tm, ts) = program(jfluid), program(tfluid)
    assert tm.to_json() == jm.to_json()
    assert ts.to_json() == js.to_json()


def test_text_classifier_with_average_pool_trains():
    """tests/test_sequence_ops.py's bag-of-words model (embedding ->
    sequence_pool average -> fc) memorizes 4 sequences in the port."""
    torch.manual_seed(0)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        words = tfluid.layers.data("words", [1], dtype="int64", lod_level=1)
        label = tfluid.layers.data("label", [1], dtype="int64")
        emb = tfluid.layers.embedding(words, size=[100, 16])
        pred = tfluid.layers.fc(tfluid.layers.sequence_pool(emb, "average"),
                                2, act="softmax")
        loss = tfluid.layers.mean(tfluid.layers.cross_entropy(pred, label))
        tfluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    lens = [5, 3, 7, 2]
    ids = rng.randint(0, 100, (sum(lens), 1)).astype(np.int64)
    labels = (ids[np.cumsum(lens) - 1] % 2).astype(np.int64)
    t = tfluid.create_lod_tensor(ids, [lens])
    for _ in range(40):
        lv, = exe.run(main, feed={"words": t, "label": labels},
                      fetch_list=[loss], scope=scope)
    assert float(lv) < 0.3, float(lv)
