"""The ssd zoo model (``models/ssd.py``) in the PyTorch port against the
JAX package, on the CPU, at its own widths (3 x 64 x 64 images, 5
classes, 352 priors over two maps).

* ``build_ssd_train_net`` and ``build_ssd_infer_net`` emit the JAX
  package's Program JSON (main and startup), built under
  ``unique_name.guard()``; ``transform_zoo_entry("ssd")`` stages;
* from the JAX package's startup values, 3 Adam steps at 2e-4 over
  batches whose images hold 1 to 4 ground-truth boxes (LoD totals no
  power of two) give the JAX package's losses and parameters within
  2e-4 of max(1, max|w|) per tensor; then ``detection_output`` from the
  stepped scopes gives the JAX package's rows: labels and boxes within
  1e-5, scores at rtol 1e-5;
* the port alone drives the zoo feed's loss down, as
  tests/test_ssd.py's zoo test does;
* neither the SSD nor the SRL training step, nor the SSD inference
  net, reads a value back to the host or makes a tensor from host
  memory inside a ``run_steps`` body (a CUDA graph's capture would fail
  on it), and ``run_steps`` equals ``run()`` calls.
"""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import ssd as JS
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import executor as texecutor
from paddle_tpu_torch.models import label_semantic_roles as SRL
from paddle_tpu_torch.models import ssd as TS
from paddle_tpu_torch.models import transform_zoo_entry

TOL = 2e-4


def _train(pkg, mod, lr=2e-4):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, _, _, loss = mod.build_ssd_train_net(learning_rate=lr)
    return main, startup, loss


def _infer(pkg, mod):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        _, dets = mod.build_ssd_infer_net()
    return main, startup, dets


def _batch(pkg, seed, n=4):
    """n images with 1..4 ground-truth boxes each, from one seed."""
    return TS.make_batch(pkg, batch=n, seed=seed)[0]


@pytest.mark.parametrize("net", ["train", "infer"])
def test_to_json_identical(net):
    build = _train if net == "train" else _infer
    jmain, jstart, _ = build(jfluid, JS)
    tmain, tstart, _ = build(tfluid, TS)
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()


def test_zoo_entry_stages():
    main, startup, feed_fn, fetch = transform_zoo_entry("ssd")
    types = {op.type for op in main.global_block().ops}
    assert {"prior_box", "ssd_loss", "adam"} <= types
    feed = feed_fn(np.random.RandomState(0))
    assert feed["gt_box"].data.shape == (3, 4)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    loss, = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    assert np.isfinite(loss).all()


def test_three_adam_steps_and_detections_match_jax():
    jmain, jstart, jloss = _train(jfluid, JS)
    tmain, _, tloss = _train(tfluid, TS)
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
    for step in range(3):
        with jfluid.scope_guard(jscope):
            jl, = jexe.run(jmain, feed=_batch(jfluid, step),
                           fetch_list=[jloss])
        tl, = texe.run(tmain, feed=_batch(tfluid, step),
                       fetch_list=[tloss], scope=tscope)
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=TOL, atol=TOL)
    for n in state:
        want = np.asarray(jscope.find_var(n))
        got = tscope.get_numpy(n)
        tol = TOL * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=n)

    jinf, _, jdets = _infer(jfluid, JS)
    tinf, _, tdets = _infer(tfluid, TS)
    image = _batch(tfluid, 7)["image"]
    with jfluid.scope_guard(jscope):
        want, = jexe.run(jinf, feed={"image": image}, fetch_list=[jdets])
    got, = texe.run(tinf, feed={"image": image}, fetch_list=[tdets],
                    scope=tscope)
    want = np.asarray(want)
    assert got.shape == want.shape == (4, 50, 6)
    assert (got[..., 1] > 0).sum() > 0
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=0)
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=1e-5,
                               atol=1e-6)


def test_port_zoo_feed_loss_falls():
    main, startup, loss = _train(tfluid, TS, lr=1e-3)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = TS.zoo_spec()[1](np.random.RandomState(5))
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(10)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


_GUARD = threading.local()


def _guarded(name, real):
    def call(*args, **kwargs):
        if getattr(_GUARD, "on", False):
            raise AssertionError("%s inside a step body reads the card back "
                                 "to the host" % name)
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


def _srl():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        net = SRL.build_train_net(word_dict_len=50, pred_dict_len=20,
                                  label_dict_len=7, word_dim=4,
                                  hidden_dim=16, depth=2)
    feed = SRL.make_batch(batch=3, seed=1, word_dict_len=50,
                          pred_dict_len=20, label_dict_len=7)[0]
    return main, startup, net["loss"], feed


def _ssd():
    main, startup, loss = _train(tfluid, TS)
    return main, startup, loss, _batch(tfluid, 3, n=2)


def _ssd_infer():
    main, startup, dets = _infer(tfluid, TS)
    return main, startup, dets, {"image": _batch(tfluid, 3, n=2)["image"]}


@pytest.mark.parametrize("model", ["ssd", "srl", "ssd_infer"])
def test_run_steps_body_has_no_host_read(model, monkeypatch):
    """Nothing in a step body reads the card back, and nothing is made
    from host memory (the kept constants, prior boxes and NMS's class
    columns, are made by the run before)."""
    main, startup, loss, feed = {"ssd": _ssd, "srl": _srl,
                                 "ssd_infer": _ssd_infer}[model]()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    init = {n: scope.get_numpy(n) for n in scope.local_var_names()}
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref_scope = tfluid.Scope()
        tfluid.load_numpy_state(ref_scope, init, "cpu")
        ref = [exe.run(main, feed=feed, fetch_list=[loss],
                       scope=ref_scope)[0] for _ in range(2)]
        for name in ("item", "cpu", "tolist", "numpy", "nonzero",
                     "__bool__", "__int__", "__float__"):
            monkeypatch.setattr(torch.Tensor, name, _guarded(
                "Tensor." + name, getattr(torch.Tensor, name)))
        for name in ("nonzero", "from_numpy", "as_tensor", "tensor"):
            monkeypatch.setattr(torch, name, _guarded(
                "torch." + name, getattr(torch, name)))
        monkeypatch.setattr(texecutor._Megastep, "_body",
                            _body(texecutor._Megastep._body))
        got = exe.run_steps(main, feeds=[feed] * 2, fetch_list=[loss],
                            scope=scope)
    finally:
        torch.set_num_threads(n_threads)
    monkeypatch.undo()
    np.testing.assert_array_equal([np.ravel(g[0]) for g in got],
                                  [np.ravel(r) for r in ref])
