"""Recurrent ops: lstm, lstmp, gru, lstm_unit and gru_unit.

The counterpart of ``paddle_tpu/ops/rnn_ops.py`` (operators/{lstm,lstmp,
gru,lstm_unit,gru_unit}_op.cc), with its gate packing:

  lstm: gates = x_proj + h @ W, W [D, 4D] packed [i, f, c~, o]; Bias
        [1, 4D], or [1, 7D] with the peephole weights w_ic, w_fc, w_oc
  gru:  Weight [D, 3D], the first 2D columns the update and reset gates,
        the last D the candidate's

Inputs arrive as flat LoD rows [T, ...] with ``@LOD`` lengths. The JAX
package pads them into [n, maxlen, ...] in the graph and runs one
``lax.scan`` over ``maxlen`` steps with a masked carry; the port runs the
same scan as a Python loop over ``maxlen`` steps, where ``maxlen`` is the
input's ``@MAXLEN`` bound from the run's static table (the next power of
two of the longest length), and masks with ``torch.where`` (the lstm
step: inside its kernel) on the device lengths. Nothing reads the host,
so a CUDA graph holds the loop. Each output passes its lengths and its
``@MAXLEN`` on (``_set_seq_out``): a stacked RNN's later layers scan
``maxlen`` steps too, not the flat total.

``lstm`` runs its scan as one autograd Function (``ops/lstm_cell.py``
``lstm_scan``): one fused recurrent step a step, product and cell
together (the hand-written CUDA kernels on the card, their plain
versions on the CPU), and the weight gradient as one product after the
backward's loop. lstmp (the same cell's plain version, then the
projection), gru and the units are plain PyTorch.
"""

import torch

from ..core.registry import register
from .lstm_cell import ACT_CODES, ACTS, _lstm_cell_plain, _order, lstm_scan
from .sequence_ops import starts, unpad_index


def _pad_from_lod(ctx, op, slot="Input"):
    """Flat [T, ...] and lengths -> (time-major padded [maxlen, n, ...],
    lengths int32 [n], T, maxlen); without a LoD, one sequence of T.

    A dead (sequence, step) slot reads a real row (its index clamped)
    instead of the JAX package's zero: every scan here keeps the carry
    and writes a zero output there, so the slot's value never shows and
    its gradient is exactly zero. The gather is an ``index_select``, its
    backward a scatter-add whose only repeated targets receive those
    zeros."""
    x = ctx.in1(op, slot)
    name = op.input(slot)[0]
    lens = ctx.maybe_get(name + "@LOD")
    t = x.shape[0]
    if lens is None:
        return x[:, None], torch.full((1,), t, dtype=torch.int32,
                                      device=x.device), t, t
    lens = lens.to(torch.int32)
    maxlen = min(int(ctx.static_info.get(name + "@MAXLEN", t)), t)
    steps = torch.arange(maxlen, device=x.device)
    rows = torch.clamp(steps[:, None] + starts(lens)[None, :], max=t - 1)
    padded = torch.index_select(x, 0, rows.reshape(-1))
    return padded.reshape((maxlen, lens.shape[0]) + tuple(x.shape[1:])), \
        lens, t, maxlen


def _unpad_to_lod(padded, lens, total):
    """Time-major [maxlen, n, ...] -> flat rows, stably compacted: the
    live (sequence, step) slots in sequence order, then the dead ones
    (``min(n * maxlen, total)`` rows, as in the JAX package)."""
    maxlen, n = padded.shape[0], padded.shape[1]
    idx = unpad_index(lens, maxlen, total)              # batch-major slots
    idx = (idx % maxlen) * n + idx // maxlen            # time-major slots
    flat = padded.reshape((maxlen * n,) + tuple(padded.shape[2:]))
    return torch.index_select(flat, 0, idx)


def _set_seq_out(ctx, op, slot, flat, lens, maxlen):
    """Write a sequence output with its lengths, passing the ``@MAXLEN``
    bound on: the generic LoD propagation skips an output whose ``@LOD``
    the lowering set, so without this a stacked RNN's second layer would
    scan the whole bucketed flat total (4,096 steps where the benchmark's
    lengths need 128)."""
    name = ctx.out_name(op, slot)
    if name is None:
        return
    ctx.env[name] = flat
    ctx.env[name + "@LOD"] = lens
    ctx.static_info.setdefault(name + "@MAXLEN", maxlen)


def _peepholes(op, bias, d):
    """The [3D] peephole weights (w_ic, w_fc, w_oc) of a [1, 7D] bias, or
    None."""
    if op.attr("use_peepholes", True) and bias is not None \
            and bias.shape[-1] >= 7 * d:
        return bias[0, 4 * d:7 * d]
    return None


def _promoted_input(xp, w, bias, h, c):
    """The lstm's input in the dtype its step computes in: the JAX
    package's step is ``x_t + h @ W + b`` under jnp type promotion, so a
    bfloat16 Input (an AMP ``fc`` without a bias) with float32 weights
    steps in float32. Its ``lax.scan`` refuses a carry whose dtype the
    step changes, so an initial state (H0/C0, by default zeros of the
    Input's dtype) in another dtype than the step's raises here too."""
    step = torch.promote_types(xp.dtype, w.dtype)
    if bias is not None:
        step = torch.promote_types(step, bias.dtype)
    if h.dtype != step or c.dtype != step:
        raise TypeError(
            "lstm: the step computes in %s (Input %s, Weight %s) but the "
            "initial state is %s/%s: give H0 and C0 in %s, as the JAX "
            "package's scan requires (its carry keeps one dtype)"
            % (step, xp.dtype, w.dtype, h.dtype, c.dtype, step))
    return xp.to(step)


def _cell_acts(op):
    """The (gate, cell, candidate) activation codes of an lstm/lstmp."""
    return tuple(ACT_CODES[op.attr(a, dflt)] for a, dflt in (
        ("gate_activation", "sigmoid"), ("cell_activation", "tanh"),
        ("candidate_activation", "tanh")))


@register("lstm")
def _lstm(ctx, op):
    """dynamic_lstm: Input [T, 4D] (x already projected), Weight [D, 4D],
    Bias [1, 4D] or [1, 7D] with peepholes; Hidden and Cell [T, D]."""
    acts = _cell_acts(op)
    xp, lens, total, maxlen = _pad_from_lod(ctx, op, "Input")  # [T,n,4D]
    w = ctx.in1(op, "Weight")                                   # [D,4D]
    d = w.shape[0]
    bias = ctx.in1(op, "Bias")
    n = xp.shape[1]
    h = ctx.in1(op, "H0")
    c = ctx.in1(op, "C0")
    h = torch.zeros((n, d), dtype=xp.dtype, device=xp.device) \
        if h is None else h.contiguous()
    c = torch.zeros((n, d), dtype=xp.dtype, device=xp.device) \
        if c is None else c.contiguous()
    xp = _promoted_input(xp, w, bias, h, c)
    if bias is not None:
        xp = xp + bias[:, :4 * d]           # once for every step
    peep = _peepholes(op, bias, d)
    hs, cs = lstm_scan(xp.contiguous(), w.contiguous(), h, c, peep, lens,
                       acts, op.attr("is_reverse", False))
    _set_seq_out(ctx, op, "Hidden", _unpad_to_lod(hs, lens, total), lens,
                 maxlen)
    if ctx.is_read(ctx.out_name(op, "Cell")):
        _set_seq_out(ctx, op, "Cell", _unpad_to_lod(cs, lens, total), lens,
                     maxlen)


@register("lstmp")
def _lstmp(ctx, op):
    """LSTM with a recurrent projection (lstmp_op.cc): the hidden h is
    projected to r = proj_act(h @ ProjWeight), which feeds the gates;
    Projection [T, P]."""
    acts = _cell_acts(op)
    pa = ACTS[op.attr("proj_activation", "tanh")]
    xp, lens, total, maxlen = _pad_from_lod(ctx, op, "Input")   # [T,n,4D]
    w = ctx.in1(op, "Weight")                                    # [P,4D]
    w_proj = ctx.in1(op, "ProjWeight")                           # [D,P]
    d, p = w_proj.shape
    bias = ctx.in1(op, "Bias")
    if bias is not None:
        xp = xp + bias[:, :4 * d]           # once for every step
    peep = _peepholes(op, bias, d)
    n = xp.shape[1]
    r = torch.zeros((n, p), dtype=xp.dtype, device=xp.device)
    c = torch.zeros((n, d), dtype=xp.dtype, device=xp.device)
    dead_h = torch.zeros_like(c)            # a dead row's h: masked below
    rs = [None] * maxlen
    for t in _order(maxlen, op.attr("is_reverse", False)):
        h, c, _ = _lstm_cell_plain(xp[t], r @ w, c, dead_h, peep, lens, t,
                                   acts)
        alive = (t < lens)[:, None]
        r = torch.where(alive, pa(h @ w_proj), r)
        rs[t] = torch.where(alive, r, torch.zeros_like(r))
    _set_seq_out(ctx, op, "Projection",
                 _unpad_to_lod(torch.stack(rs), lens, total), lens, maxlen)


@register("gru")
def _gru(ctx, op):
    """dynamic_gru: Input [T, 3D] (x already projected), Weight [D, 3D]
    (update and reset gates, then the candidate), Bias [1, 3D]; Hidden
    [T, D]. ``origin_mode`` takes h = u h_prev + (1 - u) c."""
    ga = ACTS[op.attr("gate_activation", "sigmoid")]
    ca = ACTS[op.attr("activation", "tanh")]
    origin_mode = op.attr("origin_mode", False)
    xp, lens, total, maxlen = _pad_from_lod(ctx, op, "Input")   # [T,n,3D]
    w = ctx.in1(op, "Weight")                                    # [D,3D]
    d = w.shape[0]
    w_gate, w_cand = w[:, :2 * d], w[:, 2 * d:]
    bias = ctx.in1(op, "Bias")
    b = bias if bias is not None else \
        torch.zeros((1, 3 * d), dtype=xp.dtype, device=xp.device)
    n = xp.shape[1]
    h = ctx.in1(op, "H0")
    if h is None:
        h = torch.zeros((n, d), dtype=xp.dtype, device=xp.device)
    hs = [None] * maxlen
    for t in _order(maxlen, op.attr("is_reverse", False)):
        xt = xp[t]
        gh = h @ w_gate                                          # [n,2D]
        u = ga(xt[:, :d] + gh[:, :d] + b[:, :d])
        r = ga(xt[:, d:2 * d] + gh[:, d:] + b[:, d:2 * d])
        cand = ca(xt[:, 2 * d:] + (r * h) @ w_cand + b[:, 2 * d:])
        if origin_mode:
            h_new = u * h + (1 - u) * cand
        else:
            h_new = (1 - u) * h + u * cand
        alive = (t < lens)[:, None]
        h = torch.where(alive, h_new, h)
        hs[t] = torch.where(alive, h, torch.zeros_like(h))
    _set_seq_out(ctx, op, "Hidden",
                 _unpad_to_lod(torch.stack(hs), lens, total), lens, maxlen)


@register("lstm_unit")
def _lstm_unit(ctx, op):
    """One LSTM step (lstm_unit_op.cc): X the gates [B, 4D], C_prev;
    the forget gate gets ``forget_bias``."""
    x = ctx.in1(op, "X")
    c_prev = ctx.in1(op, "C_prev")
    gi, gf, gc, go = torch.split(x, x.shape[-1] // 4, dim=-1)
    c = torch.sigmoid(gf + op.attr("forget_bias", 0.0)) * c_prev + \
        torch.sigmoid(gi) * torch.tanh(gc)
    ctx.set_out(op, "C", c)
    ctx.set_out(op, "H", torch.sigmoid(go) * torch.tanh(c))


def _unit_act(op, name, default):
    """An activation given by name or by the reference's code (an
    unknown code takes the attribute's default)."""
    v = op.attr(name, default)
    if isinstance(v, int):
        v = list(ACTS)[v if 0 <= v < len(ACTS) else default]
    return ACTS[v]


@register("gru_unit")
def _gru_unit(ctx, op):
    """One GRU step (gru_unit_op.cc): Input [B, 3D] (x projected),
    HiddenPrev [B, D], Weight [D, 3D], Bias [1, 3D]; Gate = [u, r, c],
    ResetHiddenPrev = r h_prev, Hidden = u c + (1 - u) h_prev
    (``origin_mode``: u h_prev + (1 - u) c). The activations are names
    or the reference's codes (0 identity, 1 sigmoid, 2 tanh, 3 relu)."""
    x = ctx.in1(op, "Input")
    h_prev = ctx.in1(op, "HiddenPrev")
    w = ctx.in1(op, "Weight")
    bias = ctx.in1(op, "Bias")
    d = h_prev.shape[-1]
    ga = _unit_act(op, "gate_activation", 1)
    ca = _unit_act(op, "activation", 2)
    if bias is not None:
        x = x + bias
    gh = h_prev @ w[:, :2 * d]
    u = ga(x[:, :d] + gh[:, :d])
    r = ga(x[:, d:2 * d] + gh[:, d:])
    c = ca(x[:, 2 * d:] + (r * h_prev) @ w[:, 2 * d:])
    if op.attr("origin_mode", False):
        h = u * h_prev + (1 - u) * c
    else:
        h = u * c + (1 - u) * h_prev
    ctx.set_out(op, "Gate", torch.cat([u, r, c], dim=-1))
    ctx.set_out(op, "ResetHiddenPrev", r * h_prev)
    ctx.set_out(op, "Hidden", h)
