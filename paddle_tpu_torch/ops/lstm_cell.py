"""The LSTM cell's pointwise step: a hand-written CUDA kernel and its plain
PyTorch version.

The ``lstm`` lowering (``ops/rnn_ops.py``) runs one step per time step of
its scan: ``hw = h @ W`` (``torch.matmul``), then this cell on the step's
input row block ``xt`` (the input projection with the gate bias added
once before the scan), ``hw``, the carried ``c_prev``/``h_prev``, the
optional peephole weights ``peep`` ([3D]: w_ic, w_fc, w_oc) and the
device lengths: gates = xt + hw, packed [i, f, c~, o] as the reference's
lstm_op.cc packs them,

    i = ga(g_i + c_prev w_ic)      f = ga(g_f + c_prev w_fc)
    c = f c_prev + i ca(g_c)       o = ga(g_o + c w_oc)
    h = o ha(c)

and, where step ``t`` is past a row's length, the carry unchanged and a
zero output: (H, C, Out) = (h, c, h) for live rows, (h_prev, c_prev, 0)
for dead ones. ``ga``/``ca``/``ha`` are the op's gate, cell and
candidate activations (``paddle_tpu/ops/rnn_ops.py``'s names).

Two versions of one function:

  * ``_lstm_cell_cuda``: the kernel (``csrc/lstm_cell.cu``, built by
    ``_build``), an autograd Function whose backward is the kernel's
    backward (it recomputes the gate activations from the forward's
    inputs; the peephole gradients come back per row and are summed
    here with ``torch.sum``); taken for every CUDA tensor, float32 only;
  * ``_lstm_cell_plain``: the JAX package's scan body in torch ops,
    differentiated by autograd; taken for CPU tensors. ``chip_smoke.py``
    holds the kernel against it on the card.

No TPU kernel stands behind this one: XLA fuses the JAX package's loop
body, eager PyTorch does not, so the port fuses it by hand.
``lstm_cell.launches`` counts kernel launches, forward and backward.
"""

import ctypes

import torch

from . import _build

__all__ = ["lstm_cell", "ACTS", "ACT_CODES"]

# The activations by name, in the order of their codes: the kernel's
# (csrc/lstm_cell.cu) and the reference's integer attributes (gru_unit).
ACTS = {"identity": lambda x: x, "sigmoid": torch.sigmoid,
        "tanh": torch.tanh, "relu": torch.relu}
ACT_CODES = {name: code for code, name in enumerate(ACTS)}
_BY_CODE = list(ACTS.values())


def _lstm_cell_plain(xt, hw, c_prev, h_prev, peep, lens, t, acts):
    """(H, C, Out) in torch ops: the JAX package's step body."""
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


# --------------------------------------------------------------------------
def _lib():
    lib = _build.load("lstm_cell")
    if lib.ptt_lstm_cell_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ptt_lstm_cell_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                          p, p, p, p]
        lib.ptt_lstm_cell_fwd.restype = i
        lib.ptt_lstm_cell_bwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                          p, p, p, p, p, p, p, p]
        lib.ptt_lstm_cell_bwd.restype = i
        lib.ptt_lstm_cell_error_string.argtypes = [i]
        lib.ptt_lstm_cell_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond, msg, *args):
    if not cond:
        raise ValueError("lstm_cell CUDA kernel: " + msg % args)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(lib, rc, what):
    if rc != 0:
        raise RuntimeError("lstm_cell CUDA %s kernel failed to launch: %s "
                           "(%d)" % (what, lib.ptt_lstm_cell_error_string(
                               rc).decode(), rc))


def _fwd_cuda(xt, hw, c_prev, h_prev, peep, lens, t, acts):
    b, d = c_prev.shape
    h, c, out = (torch.empty_like(c_prev) for _ in range(3))
    lib = _lib()
    stream = torch.cuda.current_stream(c_prev.device).cuda_stream
    rc = lib.ptt_lstm_cell_fwd(
        xt.data_ptr(), hw.data_ptr(), c_prev.data_ptr(), h_prev.data_ptr(),
        _ptr(peep), lens.data_ptr(), int(t), b, d, *acts, h.data_ptr(),
        c.data_ptr(), out.data_ptr(), stream)
    _raise_on(lib, rc, "forward")
    lstm_cell.launches += 1
    return h, c, out


def _bwd_cuda(xt, hw, c_prev, peep, lens, t, acts, dh, dc, dout):
    b, d = c_prev.shape
    dgates = torch.empty_like(xt)
    dc_prev, dh_prev = torch.empty_like(c_prev), torch.empty_like(c_prev)
    dpeep = None if peep is None else torch.empty(
        (b, 3 * d), dtype=xt.dtype, device=xt.device)
    lib = _lib()
    stream = torch.cuda.current_stream(c_prev.device).cuda_stream
    rc = lib.ptt_lstm_cell_bwd(
        xt.data_ptr(), hw.data_ptr(), c_prev.data_ptr(), _ptr(peep),
        lens.data_ptr(), int(t), b, d, *acts, dh.data_ptr(), dc.data_ptr(),
        dout.data_ptr(), dgates.data_ptr(), dc_prev.data_ptr(),
        dh_prev.data_ptr(), _ptr(dpeep), stream)
    _raise_on(lib, rc, "backward")
    lstm_cell.launches += 1
    return dgates, dc_prev, dh_prev, dpeep


class _LSTMCell(torch.autograd.Function):

    @staticmethod
    def forward(ctx, xt, hw, c_prev, h_prev, peep, lens, t, acts):
        h, c, out = _fwd_cuda(xt, hw, c_prev, h_prev, peep, lens, t, acts)
        ctx.save_for_backward(xt, hw, c_prev, peep, lens)
        ctx.step = (t, acts)
        return h, c, out

    @staticmethod
    def backward(ctx, dh, dc, dout):
        xt, hw, c_prev, peep, lens = ctx.saved_tensors
        t, acts = ctx.step
        dgates, dc_prev, dh_prev, dpeep = _bwd_cuda(
            xt, hw, c_prev, peep, lens, t, acts, dh.contiguous(),
            dc.contiguous(), dout.contiguous())
        dw = None if dpeep is None else torch.sum(dpeep, dim=0)
        return dgates, dgates, dc_prev, dh_prev, dw, None, None, None


def _lstm_cell_cuda(xt, hw, c_prev, h_prev, peep, lens, t, acts):
    """Check the operands and launch: (H, C, Out)."""
    tensors = [xt, hw, c_prev, h_prev] + ([] if peep is None else [peep])
    _check(all(x.dtype == torch.float32 for x in tensors),
           "float32 only (bf16 and fp16 LSTMs wait for amp, ROADMAP.md "
           "queue 2), got %s", sorted({str(x.dtype) for x in tensors}))
    _check(all(x.device == c_prev.device for x in tensors + [lens]),
           "every operand on one CUDA device")
    _check(all(x.is_contiguous() for x in tensors + [lens]),
           "contiguous operands only")
    b, d = c_prev.shape
    _check(xt.shape == (b, 4 * d) and hw.shape == (b, 4 * d)
           and h_prev.shape == (b, d) and lens.shape == (b,)
           and lens.dtype == torch.int32
           and (peep is None or peep.shape == (3 * d,)),
           "shapes xt/hw [B, 4D], c/h [B, D], lens int32 [B], peep [3D]; "
           "got %s %s %s %s %s %s", tuple(xt.shape), tuple(hw.shape),
           tuple(c_prev.shape), tuple(h_prev.shape), tuple(lens.shape),
           None if peep is None else tuple(peep.shape))
    return _LSTMCell.apply(xt, hw, c_prev, h_prev, peep, lens, int(t),
                           tuple(acts))


def lstm_cell(xt, hw, c_prev, h_prev, peep, lens, t, acts):
    """One LSTM step: (H, C, Out), each [B, D]. ``xt``/``hw`` [B, 4D],
    ``c_prev``/``h_prev`` [B, D], ``peep`` [3D] or None, ``lens`` int32
    [B] on the same device, ``t`` the step, ``acts`` the (gate, cell,
    candidate) activation codes of ``ACT_CODES``. The kernel on CUDA
    tensors, the plain version on CPU ones; differentiable in every
    float operand."""
    if c_prev.device.type == "cpu":
        return _lstm_cell_plain(xt, hw, c_prev, h_prev, peep, lens, t, acts)
    if c_prev.device.type != "cuda":
        raise ValueError("lstm_cell runs on CPU or CUDA tensors, got %s"
                         % (c_prev.device,))
    return _lstm_cell_cuda(xt, hw, c_prev, h_prev, peep, lens, t, acts)


lstm_cell.launches = 0
