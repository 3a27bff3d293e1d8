"""Shared driver of the book-model parity tests
(``tests/test_torch_book_*.py``): one builder, written against a package
argument, builds the net in both packages; the port's own ``dataset``
reader and ``DataFeeder`` feed it; both train a few steps from the JAX
package's startup values.

``book_parity`` checks, in order:

* the main and startup Programs serialize to identical JSON, built under
  ``unique_name.guard()``;
* the port's ``DataFeeder`` and the JAX package's give the same feed
  (arrays byte for byte, the same LoD) for the same batches;
* from the JAX package's startup values copied into the port, ``steps``
  training steps give losses within rtol/atol 2e-4 and every persistable
  value within 2e-4 of max(1, max|w|), the reference's multi-step bound
  (``__graft_entry__.py:154``). With ``params_only`` the optimizer's
  accumulators are left out (the parameters and batch-norm statistics
  are held): a velocity is a raw sum of gradients, where one ReLU input
  within rounding of 0 in either package moves a whole element's share,
  and reaches the weights scaled by lr (as ``tests/test_torch_resnet.py``
  holds ResNet).
"""

import itertools
import random

import numpy as np

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

TOL = 2e-4


def build(pkg, builder):
    """(main, startup, feed vars, loss) of ``builder(pkg)``, which builds
    the net under the default programs and returns (feed vars, loss)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        feed_vars, loss = builder(pkg)
    return main, startup, feed_vars, loss


def same_feed(got, want):
    """The port's feed dict holds the JAX package's arrays and LoD."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if hasattr(w, "recursive_sequence_lengths"):
            assert isinstance(g, tfluid.LoDTensor), k
            assert g.lod == w.lod, k
            g, w = g.data, w.data
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, \
            (k, g.dtype, w.dtype, g.shape, w.shape)
        assert g.tobytes() == w.tobytes(), k


def book_parity(builder, reader, batch_size, steps=3, seed=0,
                params_only=False):
    """Run the checks of the module docstring; ``reader`` is a port
    reader creator (shuffled readers draw from Python's ``random``,
    seeded with ``seed``). Returns (losses, the port's scope, its main
    Program, its feed dicts)."""
    jmain, jstart, jvars, jloss = build(jfluid, builder)
    tmain, tstart, tvars, tloss = build(tfluid, builder)
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()

    random.seed(seed)
    batches = list(itertools.islice(
        tfluid.batch(reader, batch_size)(), steps))
    assert len(batches) == steps
    tfeeder = tfluid.DataFeeder(tvars, tfluid.CPUPlace(), program=tmain)
    jfeeder = jfluid.DataFeeder(jvars, jfluid.CPUPlace(), program=jmain)
    tfeeds = [tfeeder.feed(b) for b in batches]
    jfeeds = [jfeeder.feed(b) for b in batches]
    for t, j in zip(tfeeds, jfeeds):
        same_feed(t, j)

    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
    names = [v.name for v in jmain.list_vars() if v.persistable
             and jscope.find_var(v.name) is not None]
    state = {n: np.asarray(jscope.find_var(n)) for n in names}
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, state, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    losses = []
    for jfeed, tfeed in zip(jfeeds, tfeeds):
        with jfluid.scope_guard(jscope):
            jl, = jexe.run(jmain, feed=jfeed, fetch_list=[jloss])
        tl, = texe.run(tmain, feed=tfeed, fetch_list=[tloss], scope=tscope)
        np.testing.assert_allclose(tl, np.asarray(jl), rtol=TOL, atol=TOL)
        losses.append(float(np.ravel(tl)[0]))
    assert all(np.isfinite(losses))
    if params_only:
        params = {p.name for p in tmain.global_block().all_parameters()}
        names = [n for n in names if n in params]
    moved = 0
    for n in names:
        want = np.asarray(jscope.find_var(n))
        got = tscope.get_numpy(n)
        tol = TOL * max(1.0, float(np.abs(want).max(initial=0.0)))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=n)
        moved += not np.array_equal(want, state[n])
    assert moved, "no parameter moved"
    return losses, tscope, tmain, tfeeds
