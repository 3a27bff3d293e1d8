"""DeepFM (``models/deepfm.py``) in the PyTorch port against the JAX
package.

* ``build_train_net`` and ``build_scoring_net`` emit the JAX package's
  Program JSON (main and startup), built under ``unique_name.guard()``;
* from the JAX package's startup values, 3 Adam steps on the synthetic
  click rule of tests/test_deepfm.py give the JAX package's losses and
  parameters within 2e-4 of max(1, max|w|) per tensor (the same fp32
  formulas, summed in other orders);
* the port alone learns that rule to tests/test_deepfm.py's bounds;
* the fetched FM second-order term equals the explicit pairwise sum;
* with one id per field, ``build_scoring_net`` over the gathered rows
  gives the train net's logits (rtol 1e-5).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import deepfm as JD
from paddle_tpu_torch.models import deepfm as TD

TOL = 2e-4


def _batch(rng, batch, num_fields, vocab):
    """tests/test_deepfm.py's rule: click iff field 0's id is even and
    field 1's id < vocab / 2."""
    ids = rng.randint(0, vocab, (batch, num_fields)).astype(np.int64)
    click = (ids[:, 0] % 2 == 0) & (ids[:, 1] < vocab // 2)
    return ids, click.astype(np.float32).reshape(-1, 1)


def _feed(fields, ids, click):
    feed = {f.name: ids[:, i:i + 1] for i, f in enumerate(fields)}
    feed["click"] = click
    return feed


def _train(pkg, mod, **kw):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        fields, _, prob, loss = mod.build_train_net(**kw)
    return main, startup, fields, prob, loss


def _scoring(pkg, mod, **kw):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        prob, logit = mod.build_scoring_net(**kw)
    return main, startup, logit


@pytest.mark.parametrize("net", ["train", "scoring"])
def test_to_json_identical(net):
    if net == "train":
        kw = dict(num_fields=4, vocab_size=50, embed_dim=4)
        jmain, jstart = _train(jfluid, JD, **kw)[:2]
        tmain, tstart = _train(tfluid, TD, **kw)[:2]
    else:
        kw = dict(num_fields=4, embed_dim=4)
        jmain, jstart = _scoring(jfluid, JD, **kw)[:2]
        tmain, tstart = _scoring(tfluid, TD, **kw)[:2]
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()


def test_three_adam_steps_match_jax():
    kw = dict(num_fields=4, vocab_size=40, embed_dim=4, learning_rate=1e-2)
    jmain, jstart, jfields, _, jloss = _train(jfluid, JD, **kw)
    tmain, _, tfields, _, tloss = _train(tfluid, TD, **kw)
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstart)
    names = [v.name for v in jmain.list_vars() if v.persistable]
    state = {n: np.asarray(jscope.find_var(n)) for n in names
             if jscope.find_var(n) is not None}
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, state, "cpu")
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(5)
    for _ in range(3):
        ids, click = _batch(rng, 32, 4, 40)
        with jfluid.scope_guard(jscope):
            jl, = jexe.run(jmain, feed=_feed(jfields, ids, click),
                           fetch_list=[jloss])
        tl, = texe.run(tmain, feed=_feed(tfields, ids, click),
                       fetch_list=[tloss], scope=tscope)
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=TOL, atol=TOL)
    for n in state:
        want = np.asarray(jscope.find_var(n))
        got = tscope.get_numpy(n)
        tol = TOL * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=n)
    # the shared tables moved in the rows the batches touched
    assert not np.array_equal(tscope.get_numpy("fm_second_w"),
                              state["fm_second_w"])


def test_port_learns_synthetic_ctr():
    torch.manual_seed(0)
    num_fields, vocab = 6, 64
    main, startup, fields, prob, loss = _train(
        tfluid, TD, num_fields=num_fields, vocab_size=vocab, embed_dim=8,
        learning_rate=2e-2)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    first = last = None
    for _ in range(150):
        ids, click = _batch(rng, 64, num_fields, vocab)
        lv, = exe.run(main, feed=_feed(fields, ids, click),
                      fetch_list=[loss], scope=scope)
        first = float(lv) if first is None else first
        last = float(lv)
    assert last < 0.45, (first, last)
    assert last < first * 0.7, (first, last)
    ids, click = _batch(rng, 256, num_fields, vocab)
    p, = exe.run(main, feed=_feed(fields, ids, click), fetch_list=[prob],
                 scope=scope)
    p = p.ravel()
    assert p[click.ravel() > 0].mean() > p[click.ravel() == 0].mean() + 0.2


def test_fm_second_order_identity():
    num_fields, vocab, k = 4, 20, 5
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup), tfluid.unique_name.guard():
        fields = [tfluid.layers.data("f%d" % i, [1], dtype="int64")
                  for i in range(num_fields)]
        _, logit = TD.deepfm(fields, vocab, embed_dim=k, dnn_dims=(4,))
    second_name = [op.outputs["Out"][0] for op in prog.global_block().ops
                   if op.type == "reduce_sum"][0]
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    ids = np.random.RandomState(1).randint(0, vocab, (3, num_fields))
    out, second = exe.run(prog, feed={f.name: ids[:, i:i + 1]
                                      for i, f in enumerate(fields)},
                          fetch_list=[logit, second_name], scope=scope)
    emb = scope.get_numpy("fm_second_w")[ids]            # [B, F, k]
    pairwise = np.zeros(3)
    for b in range(3):
        for i in range(num_fields):
            for j in range(i + 1, num_fields):
                pairwise[b] += emb[b, i] @ emb[b, j]
    np.testing.assert_allclose(second.ravel(), pairwise, rtol=1e-5,
                               atol=1e-6)
    assert out.shape == (3, 1)


def test_scoring_net_equals_train_logits():
    num_fields, vocab, k = 3, 30, 4
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        fields = [tfluid.layers.data("field_%d" % i, [1], dtype="int64")
                  for i in range(num_fields)]
        _, logit = TD.deepfm(fields, vocab, embed_dim=k)
    smain, sstart, slogit = _scoring(tfluid, TD, num_fields=num_fields,
                                     embed_dim=k)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(sstart, scope=scope)
    # the train net's dense params under the scoring net's names
    fcs = sorted(v.name for v in main.list_vars()
                 if v.persistable and v.name.startswith("fc_"))
    names = ["deepfm_scoring_fc0_w", "deepfm_scoring_fc0_b",
             "deepfm_scoring_fc1_w", "deepfm_scoring_fc1_b",
             "deepfm_scoring_out_w", "deepfm_scoring_out_b"]
    pairs = {"fc_0.w_0": names[0], "fc_0.b_0": names[1],
             "fc_1.w_0": names[2], "fc_1.b_0": names[3],
             "fc_2.w_0": names[4], "fc_2.b_0": names[5]}
    assert sorted(pairs) == fcs
    for src, dst in pairs.items():
        scope.set(dst, scope.find_var(src))
    ids = np.random.RandomState(2).randint(0, vocab, (5, num_fields))
    want, = exe.run(main, feed={f.name: ids[:, i:i + 1]
                                for i, f in enumerate(fields)},
                    fetch_list=[logit], scope=scope)
    first = scope.get_numpy("fm_first_w")[ids][..., 0]      # [B, F]
    second = scope.get_numpy("fm_second_w")[ids]            # [B, F, k]
    got, = exe.run(smain, feed={"fm_first_rows": first,
                                "fm_second_rows": second},
                   fetch_list=[slogit], scope=scope)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
