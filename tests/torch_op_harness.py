"""One-op parity harness for the PyTorch port's op sweep
(tests/test_torch_ops_sweep*.py).

``check(op_type, inputs, attrs, outs, wrt=())`` builds the same one-op
Program in both packages (every input a fed variable, as
tests/op_test.py builds them; ``tools/op_sweep.one_op_program``), runs
it through each package's Executor on the CPU, and holds the port's outputs against the JAX package's:
the same shapes and dtypes, floats at rtol 1e-5 / atol 1e-6, integers
and booleans exactly. With ``wrt``, ``calc_gradient`` of the first
output (d sum(out) / d input, the objective tests/op_test.py's
check_grad uses) runs in both packages too: the port's autograd against
``jax.grad``, at rtol 1e-4 / atol 1e-5 (tests/test_ops_sweep.py holds
the JAX package's against finite differences at rtol 5e-2 / atol 5e-4).
"""

import numpy as np

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.tools.op_sweep import one_op_program

FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def rand(seed, *shape, lo=-1.0, hi=1.0, dtype=np.float32):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(dtype)


def build(pkg, op_type, inputs, attrs, outs, wrt=()):
    """(program, feed, fetch names, grad names) of a one-op program in
    ``pkg``, built by the port's ``tools/op_sweep.one_op_program``."""
    prog, feed, fetch = one_op_program(pkg, op_type, inputs, attrs, outs,
                                       wrt)
    n = len(fetch) - len(wrt)
    return prog, feed, fetch[:n], fetch[n:]


def run(pkg, prog, feed, fetch, scope=None):
    scope = scope or pkg.Scope()
    exe = pkg.Executor(pkg.CPUPlace())
    if pkg is jfluid:
        with jfluid.scope_guard(scope):
            out = exe.run(prog, feed=feed, fetch_list=fetch)
    else:
        out = exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
    return [np.asarray(o) for o in out]


def assert_same(got, want, rtol=FWD_RTOL, atol=FWD_ATOL, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def check(op_type, inputs, attrs, outs, wrt=()):
    """Runs the op in both packages and holds the port to the JAX
    package; returns the port's outputs."""
    jprog, feed, fetch, jgrads = build(jfluid, op_type, inputs, attrs,
                                       outs, wrt)
    tprog, _, _, tgrads = build(tfluid, op_type, inputs, attrs, outs, wrt)
    assert tgrads == jgrads
    want = run(jfluid, jprog, feed, fetch + jgrads)
    got = run(tfluid, tprog, feed, fetch + tgrads)
    n = len(fetch)
    for name, g, w in zip(fetch, got[:n], want[:n]):
        assert_same(g, w, what="%s %s" % (op_type, name))
    for name, g, w in zip(tgrads, got[n:], want[n:]):
        assert np.abs(w).max() > 0 or np.abs(g).max() == 0, name
        assert_same(g, w, GRAD_RTOL, GRAD_ATOL,
                    what="%s %s" % (op_type, name))
    return dict(zip(fetch, got[:n]))
