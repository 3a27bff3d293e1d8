"""The LSTM scan: one fused recurrent step a time step, forward and
backward, as a hand-written CUDA kernel and its plain PyTorch version.

The ``lstm`` lowering (``ops/rnn_ops.py``) runs its whole scan through
``lstm_scan``: the step's input row block ``xt`` (the input projection
with the gate bias added once before the scan), the carried
``h_prev``/``c_prev``, the recurrent weight ``w`` [D, 4D], the optional
peephole weights ``peep`` ([3D]: w_ic, w_fc, w_oc) and the device
lengths. Each step is the JAX package's scan body
(``paddle_tpu/ops/rnn_ops.py:111-131``): gates = xt + h_prev @ w, packed
[i, f, c~, o] as the reference's lstm_op.cc packs them,

    i = ga(g_i + c_prev w_ic)      f = ga(g_f + c_prev w_fc)
    c = f c_prev + i ca(g_c)       o = ga(g_o + c w_oc)
    h = o ha(c)

and, where step ``t`` is past a row's length, the carry unchanged and a
zero output: (H, C, Out) = (h, c, h) for live rows, (h_prev, c_prev, 0)
for dead ones. ``ga``/``ca``/``ha`` are the op's gate, cell and
candidate activations (``paddle_tpu/ops/rnn_ops.py``'s names).

``_LSTMScan`` is the scan as one autograd Function: a Python loop over
the steps, one forward step a step; its backward runs one backward step
a step in reverse order (the gate gradients of step t from those of the
step after it, the carried dh and dc, the saved pre-activations), then
the weight gradient as one product for the whole scan,
H_prev^T [D, T n] @ dG [T n, 4D]. Each step has two versions:

  * ``_lstm_step_cuda`` / ``_lstm_step_bwd_cuda``: the kernels
    (``csrc/lstm_cell.cu``, built by ``_build``: the product h @ W on
    3xTF32 tensor cores with the cell in its epilogue, and dg W^T with
    the cell's backward), float32 only;
  * ``_lstm_step_plain`` / ``_lstm_step_bwd_plain``: the same functions
    in torch ops (``xt + h_prev @ w``, then ``_lstm_cell_plain``; the
    hand-derived backward). ``chip_smoke.py`` holds the kernels against
    them on the card.

A CPU tensor runs the plain steps, a CUDA tensor the kernels: the
device alone chooses. Nothing reads the host, so a CUDA graph holds the
scan and a recompute region repeats it.

No TPU kernel stands behind this one: XLA fuses the JAX package's loop
body, eager PyTorch does not, so the port fuses it by hand.
``lstm_scan.launches`` counts kernel launches, forward and backward.
"""

import ctypes

import torch

from . import _build

__all__ = ["lstm_scan", "ACTS", "ACT_CODES"]

# The activations by name, in the order of their codes: the kernel's
# (csrc/lstm_cell.cu) and the reference's integer attributes (gru_unit).
ACTS = {"identity": lambda x: x, "sigmoid": torch.sigmoid,
        "tanh": torch.tanh, "relu": torch.relu}
ACT_CODES = {name: code for code, name in enumerate(ACTS)}
_BY_CODE = list(ACTS.values())


def _dact(y, code):
    """The derivative of activation ``code`` from its output ``y``."""
    if code == 1:
        return (1 - y) * y
    if code == 2:
        return 1 - y * y
    if code == 3:
        return (y > 0).to(y.dtype)
    return torch.ones_like(y)


def _lstm_cell_plain(xt, hw, c_prev, h_prev, peep, lens, t, acts):
    """(H, C, Out) in torch ops: the JAX package's step body, given the
    product ``hw`` = h_prev @ W."""
    ga, ca, ha = (_BY_CODE[a] for a in acts)
    d = c_prev.shape[-1]
    gi, gf, gc, go = torch.split(xt + hw, d, dim=-1)
    if peep is not None:
        gi = gi + c_prev * peep[:d]
        gf = gf + c_prev * peep[d:2 * d]
    i = ga(gi)
    f = ga(gf)
    c_new = f * c_prev + i * ca(gc)
    if peep is not None:
        go = go + c_new * peep[2 * d:]
    h_new = ga(go) * ha(c_new)
    alive = (t < lens)[:, None]
    h = torch.where(alive, h_new, h_prev)
    c = torch.where(alive, c_new, c_prev)
    return h, c, torch.where(alive, h, torch.zeros_like(h))


def _lstm_step_plain(xt, h_prev, c_prev, w, peep, lens, t, acts, out=None):
    """One forward step: (H, C, Out, gates), gates = xt + h_prev @ w [n,
    4D] for the rows live at t, zero for the others (the pre-activations
    before the peepholes, which the backward reads for live rows only).
    With ``out``, written into those four tensors."""
    hw = torch.matmul(h_prev, w)
    res = _lstm_cell_plain(xt, hw, c_prev, h_prev, peep, lens, t, acts) + (
        torch.where((t < lens)[:, None], xt + hw, 0),)
    if out is None:
        return res
    for o, v in zip(out, res):
        o.copy_(v)
    return out


def _lstm_step_bwd_plain(dg_next, w, lens, t_next, gates, c_prev, c_new,
                         peep, t, acts, dout, dcell, dh, dc, dpeep, dg):
    """One backward step, in place. First the carried ``dh`` [n, D]
    becomes the gradient of step t's carried h: ``dg_next @ w.T`` for the
    rows live at ``t_next`` (the step the forward ran after t, whose gate
    gradients are ``dg_next``), unchanged for the others (a dead row's h
    is its carry); ``dg_next`` None leaves it. Then, unless ``gates`` is
    None, the cell's backward at step t from the saved pre-activations
    ``gates``, ``c_prev`` and ``c_new`` (step t's C) with dh + ``dout``
    and dc + ``dcell`` (None: zero): ``dg`` [n, 4D] written (zero for rows
    dead at t), ``dc`` [n, D] becomes dc_prev (a dead row's passes
    through), and the per-row peephole gradients are added into ``dpeep``
    [n, 3D]."""
    if dg_next is not None:
        alive = (t_next < lens)[:, None]
        dh.copy_(torch.where(alive, torch.matmul(dg_next, w.t()), dh))
    if gates is None:
        return
    ga, ca, ha = acts
    d = dh.shape[-1]
    gi, gf, gc, go = torch.split(gates, d, dim=-1)
    if peep is not None:
        gi = gi + c_prev * peep[:d]
        gf = gf + c_prev * peep[d:2 * d]
        go = go + c_new * peep[2 * d:]
    i, f, o = (_BY_CODE[ga](x) for x in (gi, gf, go))
    cc = _BY_CODE[ca](gc)
    hc = _BY_CODE[ha](c_new)
    dht = dh if dout is None else dh + dout
    dct = dc if dcell is None else dc + dcell
    dgo = dht * hc * _dact(o, ga)
    dcn = dct + dht * o * _dact(hc, ha)
    if peep is not None:
        dcn = dcn + dgo * peep[2 * d:]
    dgi = dcn * cc * _dact(i, ga)
    dgf = dcn * c_prev * _dact(f, ga)
    dgc = dcn * i * _dact(cc, ca)
    dcp = dcn * f
    if peep is not None:
        dcp = dcp + dgi * peep[:d] + dgf * peep[d:2 * d]
    live = (t < lens)[:, None]
    dg.copy_(torch.where(live, torch.cat([dgi, dgf, dgc, dgo], dim=-1), 0))
    dc.copy_(torch.where(live, dcp, dct))
    if dpeep is not None:
        dpeep.add_(torch.where(live, torch.cat(
            [dgi * c_prev, dgf * c_prev, dgo * c_new], dim=-1), 0))


# --------------------------------------------------------------------------
def _lib():
    lib = _build.load("lstm_cell")
    if lib.ptt_lstm_step_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ptt_lstm_step_fwd.argtypes = [p] * 6 + [i] * 6 + [p] * 5
        lib.ptt_lstm_step_fwd.restype = i
        lib.ptt_lstm_step_bwd.argtypes = [p, p, p, i, p, p, p, p] + \
            [i] * 6 + [p] * 7
        lib.ptt_lstm_step_bwd.restype = i
        lib.ptt_lstm_step_error_string.argtypes = [i]
        lib.ptt_lstm_step_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(lib, rc, what):
    if rc != 0:
        raise RuntimeError("lstm_cell CUDA %s kernel failed to launch: %s "
                           "(%d)" % (what, lib.ptt_lstm_step_error_string(
                               rc).decode(), rc))


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _lstm_step_cuda(xt, h_prev, c_prev, w, peep, lens, t, acts, out=None):
    """The forward kernel: ``_lstm_step_plain``'s function."""
    b, d = c_prev.shape
    if out is None:
        out = tuple(torch.empty_like(c_prev) for _ in range(3)) + (
            torch.empty_like(xt),)
    lib = _lib()
    rc = lib.ptt_lstm_step_fwd(
        xt.data_ptr(), h_prev.data_ptr(), c_prev.data_ptr(), w.data_ptr(),
        _ptr(peep), lens.data_ptr(), int(t), b, d, *acts,
        *(o.data_ptr() for o in out), _stream(xt))
    _raise_on(lib, rc, "forward")
    lstm_scan.launches += 1
    return out


def _lstm_step_bwd_cuda(dg_next, w, lens, t_next, gates, c_prev, c_new,
                        peep, t, acts, dout, dcell, dh, dc, dpeep, dg):
    """The backward kernel: ``_lstm_step_bwd_plain``'s function."""
    b, d = dh.shape
    lib = _lib()
    rc = lib.ptt_lstm_step_bwd(
        _ptr(dg_next), w.data_ptr(), lens.data_ptr(),
        -1 if t_next is None else int(t_next), _ptr(gates), _ptr(c_prev),
        _ptr(c_new), _ptr(peep), -1 if t is None else int(t), b, d, *acts,
        _ptr(dout),
        _ptr(dcell), dh.data_ptr(), dc.data_ptr(), _ptr(dpeep), _ptr(dg),
        _stream(dh))
    _raise_on(lib, rc, "backward")
    lstm_scan.launches += 1


def _steps_for(device):
    """(forward step, backward step) for tensors on ``device``."""
    if device.type == "cpu":
        return _lstm_step_plain, _lstm_step_bwd_plain
    if device.type == "cuda":
        return _lstm_step_cuda, _lstm_step_bwd_cuda
    raise ValueError("lstm runs on CPU or CUDA tensors, got %s" % (device,))


def _order(steps, reverse):
    return range(steps - 1, -1, -1) if reverse else range(steps)


def _slots(t, reverse):
    """(slot of step t's carry in, slot of its carry out) in the [T + 1]
    carry buffers: the initial state sits at 0 (T when reversed)."""
    return (t + 1, t) if reverse else (t, t + 1)


class _LSTMScan(torch.autograd.Function):
    """(Hidden [T, n, D], Cell [T, n, D]) of the scan over xp [T, n, 4D]
    from (h0, c0), with ``steps`` = (forward step, backward step)."""

    @staticmethod
    def forward(ctx, xp, w, h0, c0, peep, lens, acts, reverse, steps):
        ctx.set_materialize_grads(False)
        fwd = steps[0]
        n_steps, n = xp.shape[0], xp.shape[1]
        d = w.shape[0]
        hb = xp.new_empty((n_steps + 1, n, d))
        cb = torch.empty_like(hb)
        hs = xp.new_empty((n_steps, n, d))
        gates = torch.empty_like(xp)
        home = n_steps if reverse else 0
        hb[home] = h0
        cb[home] = c0
        for t in _order(n_steps, reverse):
            src, dst = _slots(t, reverse)
            fwd(xp[t], hb[src], cb[src], w, peep, lens, t, acts,
                out=(hb[dst], cb[dst], hs[t], gates[t]))
        ctx.save_for_backward(w, peep, lens, hb, cb, gates)
        ctx.cfg = (acts, reverse, steps[1])
        return hs, (cb[:n_steps] if reverse else cb[1:])

    @staticmethod
    def backward(ctx, dhs, dcs):
        w, peep, lens, hb, cb, gates = ctx.saved_tensors
        acts, reverse, bwd = ctx.cfg
        n_steps, n, d = hb.shape[0] - 1, hb.shape[1], hb.shape[2]
        dhs = None if dhs is None else dhs.contiguous()
        dcs = None if dcs is None else dcs.contiguous()
        dg = torch.empty_like(gates)
        dh = hb.new_zeros((n, d))
        dc = torch.zeros_like(dh)
        dpeep = None if peep is None else hb.new_zeros((n, 3 * d))
        t_next = None
        for t in _order(n_steps, not reverse):
            src, dst = _slots(t, reverse)
            bwd(None if t_next is None else dg[t_next], w, lens, t_next,
                gates[t], cb[src], cb[dst], peep, t, acts,
                None if dhs is None else dhs[t],
                None if dcs is None else dcs[t], dh, dc, dpeep, dg[t])
            t_next = t
        need = ctx.needs_input_grad
        dw = dh0 = None
        if need[1]:
            h_prev = hb[1:] if reverse else hb[:n_steps]
            dw = torch.matmul(h_prev.reshape(n_steps * n, d).t(),
                              dg.reshape(n_steps * n, 4 * d))
        if need[2] and t_next is not None:
            bwd(dg[t_next], w, lens, t_next, None, None, None, None, None,
                acts, None, None, dh, dc, None, None)
        if need[2]:
            dh0 = dh
        dp = dpeep.sum(0) if need[4] and dpeep is not None else None
        return (dg if need[0] else None, dw, dh0, dc if need[3] else None,
                dp, None, None, None, None)


def _check(cond, msg, *args):
    if not cond:
        raise ValueError("lstm_cell CUDA kernel: " + msg % args)


def _check_cuda(xp, w, h0, c0, peep, lens):
    tensors = [xp, w, h0, c0] + ([] if peep is None else [peep])
    _check(all(x.dtype == torch.float32 for x in tensors),
           "float32 only (bf16 and fp16 LSTMs wait for amp, ROADMAP.md "
           "queue 2), got %s", sorted({str(x.dtype) for x in tensors}))
    _check(all(x.device == xp.device for x in tensors + [lens]),
           "every operand on one CUDA device")
    _check(all(x.is_contiguous() for x in tensors + [lens]),
           "contiguous operands only")
    t, n, d4 = xp.shape
    d = w.shape[0]
    _check(d4 == 4 * d and w.shape == (d, 4 * d) and h0.shape == (n, d)
           and c0.shape == (n, d) and lens.shape == (n,)
           and lens.dtype == torch.int32
           and (peep is None or peep.shape == (3 * d,)),
           "shapes xp [T, n, 4D], w [D, 4D], h0/c0 [n, D], lens int32 [n], "
           "peep [3D]; got %s %s %s %s %s %s", tuple(xp.shape),
           tuple(w.shape), tuple(h0.shape), tuple(c0.shape),
           tuple(lens.shape), None if peep is None else tuple(peep.shape))


def lstm_scan(xp, w, h0, c0, peep, lens, acts, reverse=False):
    """The LSTM's scan over ``xp`` [T, n, 4D] (bias added): (Hidden,
    Cell), each [T, n, D] in time order, Hidden zero past a row's length
    and Cell the carried c. ``w`` [D, 4D], ``h0``/``c0`` [n, D], ``peep``
    [3D] or None, ``lens`` int32 [n] on the same device, ``acts`` the
    (gate, cell, candidate) activation codes of ``ACT_CODES``,
    ``reverse`` the scan's direction. The kernels on CUDA tensors, the
    plain steps on CPU ones; differentiable in every float operand."""
    steps = _steps_for(xp.device)
    if xp.device.type == "cuda":
        _check_cuda(xp, w, h0, c0, peep, lens)
    return _LSTMScan.apply(xp, w, h0, c0, peep, lens, tuple(acts),
                           bool(reverse), steps)


lstm_scan.launches = 0
