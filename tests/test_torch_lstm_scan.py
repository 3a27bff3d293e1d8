"""The port's LSTM scan (``paddle_tpu_torch/ops/lstm_cell.py``) on the CPU
against the JAX package:

* ``_lstm_step_plain`` (the fused step's plain version: xt + h_prev @ w,
  then the cell) against the JAX scan body
  (paddle_tpu/ops/rnn_ops.py:111-131, written out in jnp) at rtol 1e-5 /
  atol 1e-6, with and without peepholes, for both activation sets the
  card checks;
* ``_LSTMScan`` with the plain steps (what every CPU tensor runs: the
  hand-derived backward, the weight gradient as one product after the
  loop, dead rows passing their carry back, the peephole sums) against
  ``jax.grad`` of the JAX package's ``lstm`` lowering itself on the same
  flat LoD rows: forward, reverse, peepholes, H0/C0 and other
  activations, mixed lengths with dead steps past the longest, at rtol
  1e-4 / atol 1e-6;
* a float64 ``torch.autograd.gradcheck`` of ``_LSTMScan`` with the plain
  steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import rnn_ops as jrnn
from paddle_tpu_torch.ops import lstm_cell as LC

ACT_SETS = [(1, 2, 2), (1, 3, 0)]      # sigmoid/tanh/tanh, sigmoid/relu/id
_JACT = {0: lambda x: x, 1: jax.nn.sigmoid, 2: jnp.tanh, 3: jax.nn.relu}


def _jax_step(xt, h, c, w, peep, lens, t, acts):
    """paddle_tpu/ops/rnn_ops.py:111-131 with the bias folded into xt;
    also returns the gates before the peepholes (zero on dead rows, as
    the port saves them)."""
    ga, ca, ha = (_JACT[a] for a in acts)
    gates = xt + h @ w
    gi, gf, gc, go = jnp.split(gates, 4, axis=-1)
    d = c.shape[-1]
    if peep is not None:
        gi = gi + c * peep[:d]
        gf = gf + c * peep[d:2 * d]
    i = ga(gi)
    f = ga(gf)
    c_new = f * c + i * ca(gc)
    if peep is not None:
        go = go + c_new * peep[2 * d:]
    h_new = ga(go) * ha(c_new)
    alive = (t < lens)[:, None]
    h_new = jnp.where(alive, h_new, h)
    c_new = jnp.where(alive, c_new, c)
    return (h_new, c_new, jnp.where(alive, h_new, 0.0),
            jnp.where(alive, gates, 0.0))


@pytest.mark.parametrize("peep", [False, True])
@pytest.mark.parametrize("acts", ACT_SETS)
def test_lstm_step_plain_matches_the_jax_step(peep, acts):
    rng = np.random.RandomState(21)
    b, d, t = 6, 8, 2
    xt = rng.randn(b, 4 * d).astype(np.float32)
    h = rng.randn(b, d).astype(np.float32)
    c = rng.randn(b, d).astype(np.float32)
    w = (rng.randn(d, 4 * d) / np.sqrt(d)).astype(np.float32)
    p = rng.randn(3 * d).astype(np.float32) if peep else None
    lens = np.array([1, 3, 4, 0, 7, 2], np.int32)    # rows 0, 3, 5 dead
    want = _jax_step(*(None if a is None else jnp.asarray(a)
                       for a in (xt, h, c, w, p)), jnp.asarray(lens), t,
                     acts)
    got = LC._lstm_step_plain(*(None if a is None else torch.from_numpy(a)
                                for a in (xt, h, c, w, p)),
                              torch.from_numpy(lens), t, acts)
    for name, g, x in zip(("H", "C", "Out", "gates"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # with ``out``, the same values land in the given tensors
    out = tuple(torch.empty_like(g) for g in got)
    LC._lstm_step_plain(*(None if a is None else torch.from_numpy(a)
                          for a in (xt, h, c, w, p)),
                        torch.from_numpy(lens), t, acts, out=out)
    assert all(torch.equal(a, g) for a, g in zip(out, got))


# --------------------------------------------------------------------------
class _Op:
    def __init__(self, attrs):
        self.attrs = attrs

    def input(self, slot):
        return [slot]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


class _Ctx:
    """What the JAX package's ``lstm`` lowering reads and writes."""

    def __init__(self, env, maxlen):
        self.env = dict(env)
        self.static_info = {"Input@MAXLEN": maxlen}

    def in1(self, op, slot, default=None):
        return self.env.get(slot, default)

    def maybe_get(self, name):
        return self.env.get(name)

    def out_name(self, op, slot):
        return slot


def _jax_lstm(arrays, lens, maxlen, attrs, cot):
    """(Hidden, Cell, gradients) of the JAX lowering on the flat rows:
    jax.grad of sum(Hidden * cot[0]) + sum(Cell * cot[1])."""
    names = sorted(arrays)

    def loss(*vals):
        env = dict(zip(names, vals))
        env["Input@LOD"] = jnp.asarray(lens)
        ctx = _Ctx(env, maxlen)
        jrnn._lstm(ctx, _Op(attrs))
        hid, cell = ctx.env["Hidden"], ctx.env["Cell"]
        return jnp.sum(hid * cot[0]) + jnp.sum(cell * cot[1]), (hid, cell)

    vals = [jnp.asarray(arrays[n]) for n in names]
    (_, (hid, cell)), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(names))), has_aux=True)(*vals)
    return np.asarray(hid), np.asarray(cell), {
        n: np.asarray(g) for n, g in zip(names, grads)}


def _port_lstm(arrays, lens, maxlen, attrs, cot):
    """The same through ``lstm_scan`` (``_LSTMScan`` with the plain
    steps) on time-major padded rows, unpadded to the flat order."""
    leaves = {n: torch.tensor(a, requires_grad=True)
              for n, a in arrays.items()}
    x, w, bias = leaves["Input"], leaves["Weight"], leaves["Bias"]
    d = w.shape[0]
    n = len(lens)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    steps = np.arange(maxlen)
    live = steps[:, None] < np.asarray(lens)[None, :]          # [T, n]
    rows = np.minimum(starts[None, :] + steps[:, None], x.shape[0] - 1)
    xp = x[torch.from_numpy(rows.reshape(-1))].reshape(maxlen, n, 4 * d)
    xp = xp + bias[:, :4 * d]
    peep = bias[0, 4 * d:7 * d] if attrs.get("use_peepholes") else None
    h0 = leaves.get("H0", torch.zeros(n, d))
    c0 = leaves.get("C0", torch.zeros(n, d))
    acts = tuple(LC.ACT_CODES[attrs.get(a, dflt)] for a, dflt in (
        ("gate_activation", "sigmoid"), ("cell_activation", "tanh"),
        ("candidate_activation", "tanh")))
    hs, cs = LC.lstm_scan(xp, w, h0, c0, peep,
                          torch.tensor(lens, dtype=torch.int32), acts,
                          attrs.get("is_reverse", False))
    # the live (sequence, step) slots in sequence order
    flat = torch.from_numpy(np.array([t * n + b for b in range(n)
                                      for t in range(maxlen) if live[t, b]]))
    hid = hs.reshape(maxlen * n, d)[flat]
    cell = cs.reshape(maxlen * n, d)[flat]
    total = torch.sum(hid * torch.from_numpy(cot[0])) + \
        torch.sum(cell * torch.from_numpy(cot[1]))
    grads = torch.autograd.grad(total, list(leaves.values()))
    return hid.detach().numpy(), cell.detach().numpy(), {
        k: g.numpy() for k, g in zip(leaves, grads)}


SCAN_CASES = {
    "forward": dict(use_peepholes=False),
    "peepholes": dict(use_peepholes=True),
    "reverse-peepholes": dict(use_peepholes=True, is_reverse=True),
    "reverse": dict(use_peepholes=False, is_reverse=True),
    "h0-c0-relu-identity": dict(use_peepholes=False, h0=True,
                                cell_activation="relu",
                                candidate_activation="identity"),
    "h0-c0-peepholes-reverse": dict(use_peepholes=True, is_reverse=True,
                                    h0=True),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_lstm_scan_matches_jax_grad_of_the_lowering(case):
    attrs = dict(SCAN_CASES[case])
    with_h0 = attrs.pop("h0", False)
    rng = np.random.RandomState(sorted(SCAN_CASES).index(case))
    d, lens, maxlen = 6, [3, 5, 1, 0, 4], 8     # steps 5..7 dead for all
    total = sum(lens)
    peep = attrs["use_peepholes"]
    arrays = {"Input": 0.5 * rng.randn(total, 4 * d),
              "Weight": rng.randn(d, 4 * d) / np.sqrt(d),
              "Bias": 0.1 * rng.randn(1, (7 if peep else 4) * d)}
    if with_h0:
        arrays["H0"] = rng.randn(len(lens), d)
        arrays["C0"] = rng.randn(len(lens), d)
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    cot = [rng.randn(total, d).astype(np.float32) for _ in range(2)]
    want = _jax_lstm(arrays, lens, maxlen, attrs, cot)
    got = _port_lstm(arrays, lens, maxlen, attrs, cot)
    for name, g, w in (("Hidden", got[0], want[0]),
                       ("Cell", got[1], want[1])):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=name)
    assert set(got[2]) == set(want[2])
    for name in want[2]:
        np.testing.assert_allclose(got[2][name], want[2][name], rtol=1e-4,
                                   atol=1e-6, err_msg="d" + name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("peep", [False, True])
def test_lstm_scan_gradcheck_float64(reverse, peep):
    rng = np.random.RandomState(31 + 2 * reverse + peep)
    steps, n, d = 4, 3, 2
    f64 = lambda *s: torch.tensor(rng.randn(*s), dtype=torch.float64,
                                  requires_grad=True)
    inputs = [f64(steps, n, 4 * d), f64(d, 4 * d), f64(n, d), f64(n, d),
              f64(3 * d) if peep else None]
    lens = torch.tensor([4, 2, 0], dtype=torch.int32)
    plain = LC._steps_for(torch.device("cpu"))

    def scan(xp, w, h0, c0, p=None):
        return LC._LSTMScan.apply(xp, w, h0, c0, p, lens, (1, 2, 2),
                                  reverse, plain)

    assert torch.autograd.gradcheck(scan, [x for x in inputs
                                           if x is not None])


def test_lstm_scan_counts_no_launch_on_the_cpu():
    before = LC.lstm_scan.launches
    xp = torch.randn(3, 2, 8, requires_grad=True)
    hs, cs = LC.lstm_scan(xp, torch.randn(2, 8), torch.zeros(2, 2),
                          torch.zeros(2, 2), None,
                          torch.tensor([3, 1], dtype=torch.int32), (1, 2, 2))
    (hs.sum() + cs.sum()).backward()
    assert LC.lstm_scan.launches == before
    assert not hs[1:, 1].any()          # row 1 dead past step 0
