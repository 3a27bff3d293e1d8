"""Sequence ops over the flat LoD layout: rows [T, ...] and the
per-sequence lengths ``<name>@LOD`` (an int32 tensor) the Executor feeds
beside them.

The counterpart of ``paddle_tpu/ops/sequence_ops.py`` (operators/
sequence_{pool,conv,expand,concat,reshape,slice,erase}_op.cc, sequence
pad/unpad, lod_reset, sequence_scatter, reorder_lod_tensor_by_rank). Each
op is a segment reduction or a gather over segment ids computed on the
device from the lengths, with no per-sequence loop and no host read, so
a CUDA graph holds them. Lengths flow to the outputs as ``@LOD``.

The bucket's pad rows (past sum(lengths)) take segment id n, one past
the last sequence. The JAX package's ``jax.ops.segment_*`` drop such ids;
``index_put_`` and ``scatter_reduce`` would raise on them, so every
segment reduction here runs over n + 1 segments and slices the extra
one off. Sums accumulate through ``index_put_(accumulate=True)``: on the
card it sorts the ids stably and adds each segment's rows in their
order, where ``index_add_`` adds with float atomics in no fixed order,
so a ``run_steps`` graph replays bitwise. Where the JAX package gathers rows with an index past the end,
JAX reads the last row and passes that read no gradient; ``take_rows``
does the same, so pad rows hold what they hold there and change no
gradient.
"""

import torch

from ..core.registry import register

__all__ = ["segments", "starts", "segment_sum", "take_rows",
           "unpad_index"]


def _lengths(ctx, op, slot="X"):
    names = op.input(slot)
    if not names:
        return None
    return ctx.maybe_get(names[0] + "@LOD")


def segments(lengths, total):
    """The segment id of each of ``total`` flat rows: row r belongs to
    the sequence whose end (the cumulative length) is first above r; a
    pad row gets n."""
    ends = torch.cumsum(lengths, 0)
    return torch.searchsorted(ends, torch.arange(total,
                                                 device=lengths.device),
                              right=True)


def starts(lengths):
    """Each sequence's first flat row (int64)."""
    return torch.cumsum(lengths, 0) - lengths


def take_rows(x, idx):
    """``x[idx]`` as JAX takes it: an index past the end reads the last
    row and passes it no gradient."""
    last = x.shape[0] - 1
    out = x[torch.clamp(idx, max=last)]
    if out.requires_grad:
        past = (idx > last).reshape((-1,) + (1,) * (x.dim() - 1))
        out = torch.where(past, out.detach(), out)
    return out


def segment_sum(x, seg, n):
    """Per-segment sums of the rows of ``x`` over segments 0..n-1 (rows
    of segment n, the pad rows, dropped)."""
    out = torch.zeros((n + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_put((seg,), x, accumulate=True)[:n]


def _segment_reduce(x, seg, n, how, ident):
    """``scatter_reduce`` ``how`` ("amax" / "amin") of the rows of ``x``
    per segment, ``ident`` where a segment has no row."""
    out = torch.full((n + 1,) + tuple(x.shape[1:]), ident, dtype=x.dtype,
                     device=x.device)
    idx = seg.reshape((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    return out.scatter_reduce(0, idx, x, how, include_self=True)[:n]


def unpad_index(lengths, maxlen, total):
    """The stable compaction of a padded ``[n, maxlen]`` layout as a
    gather index into its flat ``n * maxlen`` rows: first the live slots
    (t < length) in order, then the dead ones in order, ``min(n * maxlen,
    total)`` entries in all (the JAX package's ``argsort(~valid,
    stable=True)[:total]``, built from the lengths: the index is unique,
    so the gather's backward is a plain scatter)."""
    dev = lengths.device
    lens = lengths.to(torch.int64)
    rows = min(lens.shape[0] * maxlen, total)
    r = torch.arange(rows, device=dev)
    live_total = torch.sum(lens)
    live_seg = torch.searchsorted(torch.cumsum(lens, 0), r, right=True)
    live_seg = torch.clamp(live_seg, max=lens.shape[0] - 1)
    live = live_seg * maxlen + (r - (torch.cumsum(lens, 0) - lens)[live_seg])
    dead_lens = maxlen - lens
    k = torch.clamp(r - live_total, min=0)
    dead_seg = torch.searchsorted(torch.cumsum(dead_lens, 0), k, right=True)
    dead_seg = torch.clamp(dead_seg, max=lens.shape[0] - 1)
    dead = dead_seg * maxlen + lens[dead_seg] + \
        (k - (torch.cumsum(dead_lens, 0) - dead_lens)[dead_seg])
    return torch.where(r < live_total, live, dead)


def _set_out_lod(ctx, op, lengths, slot="Out"):
    name = ctx.out_name(op, slot)
    if name is not None and lengths is not None:
        ctx.env[name + "@LOD"] = lengths


def _one_sequence(x):
    return torch.full((1,), x.shape[0], dtype=torch.int32, device=x.device)


def _stable_partition(keep):
    """The order that puts the rows where ``keep`` holds first, each
    part in its original order."""
    return torch.argsort((~keep).to(torch.int8), stable=True)


@register("sequence_pool")
def _sequence_pool(ctx, op):
    _pool(ctx, op, op.attr("pooltype", "AVERAGE").upper())


@register("sequence_first_step")
def _sequence_first(ctx, op):
    _pool(ctx, op, "FIRST")


@register("sequence_last_step")
def _sequence_last(ctx, op):
    _pool(ctx, op, "LAST")


def _pool(ctx, op, ptype):
    """One row per sequence: SUM, AVERAGE, SQRT (sum over sqrt(length)),
    MAX and MIN (the arg-extremum gather, ``_argext_pool``; MAX also
    writes MaxIndex), LAST, FIRST."""
    x = ctx.in1(op, "X")                     # [T, D]
    lengths = _lengths(ctx, op)
    if lengths is None:
        lengths = _one_sequence(x)
    n = lengths.shape[0]
    t = x.shape[0]
    seg = segments(lengths, t)
    if ptype == "SUM":
        out = segment_sum(x, seg, n)
    elif ptype == "AVERAGE":
        out = segment_sum(x, seg, n) / \
            torch.clamp_min(lengths, 1).to(x.dtype)[:, None]
    elif ptype == "SQRT":
        out = segment_sum(x, seg, n) / torch.sqrt(
            torch.clamp_min(lengths, 1).to(x.dtype))[:, None]
    elif ptype == "MAX":
        out, maxidx = _argext_pool(x, seg, n, lengths, is_max=True)
        ctx.set_out(op, "MaxIndex", maxidx)
    elif ptype == "MIN":
        out, _ = _argext_pool(x, seg, n, lengths, is_max=False)
    elif ptype == "LAST":
        out = x[torch.cumsum(lengths, 0) - 1]
    elif ptype == "FIRST":
        out = take_rows(x, starts(lengths))
    else:
        raise NotImplementedError("sequence_pool type %r" % ptype)
    ctx.set_out(op, "Out", out)


def _segment_argext(x, seg, n, is_max):
    """[n, ...] int32: for each segment and feature, the first row
    holding the segment's max (or min); the int32 max where a segment is
    empty (the identity of the JAX package's segment_min)."""
    t = x.shape[0]
    x = x.detach()
    if x.is_floating_point():
        ident = float("-inf") if is_max else float("inf")
    else:
        info = torch.iinfo(x.dtype)
        ident = info.min if is_max else info.max
    best = _segment_reduce(x, seg, n + 1, "amax" if is_max else "amin",
                           ident)                 # n + 1: pad rows' own
    is_best = x == best[seg]
    idx = torch.arange(t, dtype=torch.int32, device=x.device)
    idx = idx.reshape((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    pos = torch.where(is_best, idx, t)
    return _segment_reduce(pos, seg, n, "amin",
                           torch.iinfo(torch.int32).max)


def _argext_pool(x, seg, n, lengths, is_max):
    """MAX/MIN pooling through the explicit arg-extremum gather, as in
    the JAX package: the first row wins a tie, the gradient goes to the
    stored winner only (the gather's backward), and an empty segment
    holds the dtype's lowest (MAX) or highest (MIN) finite value and
    passes no gradient."""
    argidx = _segment_argext(x, seg, n, is_max)
    safe = torch.clamp(argidx, 0, x.shape[0] - 1).to(torch.int64)
    gathered = torch.gather(x, 0, safe)
    if x.is_floating_point():
        info = torch.finfo(x.dtype)
    else:
        info = torch.iinfo(x.dtype)
    ident = info.min if is_max else info.max
    empty = (lengths <= 0).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(empty, ident, gathered), argidx


@register("sequence_concat")
def _sequence_concat(ctx, op):
    """Each sequence i of the output is sequence i of every input in
    order (sequence_concat_op.cc, axis 0); the lengths add up."""
    xs = ctx.in_list(op, "X")
    lens = [ctx.maybe_get(n + "@LOD") for n in op.input("X")]
    if any(ln is None for ln in lens):
        ctx.set_out(op, "Out", torch.cat(xs, dim=0))
        return
    out_lens = lens[0]
    for ln in lens[1:]:
        out_lens = out_lens + ln
    data = torch.cat(xs, dim=0)
    seg = torch.cat([segments(ln, x.shape[0]) for x, ln in zip(xs, lens)])
    # stable by segment: input order within a sequence, pad rows last
    ctx.set_out(op, "Out", data[torch.argsort(seg, stable=True)])
    _set_out_lod(ctx, op, out_lens)


@register("sequence_expand")
def _sequence_expand(ctx, op):
    """Sequence i of X repeated to cover sequence i of Y
    (sequence_expand_op.cc); X without LoD: row i is sequence i."""
    x = ctx.in1(op, "X")
    x_lens = _lengths(ctx, op, "X")
    y_lens = _lengths(ctx, op, "Y")
    if y_lens is None:
        ctx.set_out(op, "Out", x)
        return
    total = int(ctx.in1(op, "Y").shape[0])
    seg = segments(y_lens, total)
    if x_lens is None:
        src = seg
    else:
        src = starts(x_lens)[torch.clamp(seg, max=x_lens.shape[0] - 1)]
    ctx.set_out(op, "Out", take_rows(x, src))
    _set_out_lod(ctx, op, y_lens)


@register("lod_reset")
def _lod_reset(ctx, op):
    """X with new lengths (lod_reset_op.cc): Y's LoD, Y's values read as
    level-0 OFFSETS, or the ``target_lod`` attr (offsets too)."""
    x = ctx.in1(op, "X")
    ctx.set_out(op, "Out", x)
    y_names = op.input("Y")
    if y_names:
        y_lens = ctx.maybe_get(y_names[0] + "@LOD")
        if y_lens is not None:
            _set_out_lod(ctx, op, y_lens)
            return
        offsets = ctx.in1(op, "Y").reshape(-1)
    else:
        target = [int(v) for v in op.attr("target_lod") or []]
        if len(target) >= 2:
            # built by fills, not from a host list: a CUDA graph holds it
            lens = torch.empty(len(target) - 1, dtype=torch.int32,
                               device=x.device)
            for i in range(len(target) - 1):
                lens[i] = target[i + 1] - target[i]
            _set_out_lod(ctx, op, lens)
        return
    if offsets.shape[0] >= 2:
        _set_out_lod(ctx, op, (offsets[1:] - offsets[:-1]).to(torch.int32))


@register("sequence_reshape")
def _sequence_reshape(ctx, op):
    """Rows regrouped to ``new_dim`` columns; each length scales by
    old_dim / new_dim."""
    x = ctx.in1(op, "X")
    new_dim = int(op.attr("new_dim"))
    lengths = _lengths(ctx, op)
    ctx.set_out(op, "Out", x.reshape(-1, new_dim))
    if lengths is not None:
        _set_out_lod(ctx, op, (lengths * x.shape[1]) // new_dim)


@register("sequence_slice")
def _sequence_slice(ctx, op):
    """[offset, offset + length) of every sequence (sequence_slice_op.cc;
    Offset and Length [n, 1]). The kept rows move to the front, in
    order; the buffer keeps its size."""
    x = ctx.in1(op, "X")
    offset = ctx.in1(op, "Offset").reshape(-1)
    length = ctx.in1(op, "Length").reshape(-1)
    lengths = _lengths(ctx, op)
    if lengths is None:
        lengths = _one_sequence(x)
    t = x.shape[0]
    seg = torch.clamp(segments(lengths, t), max=lengths.shape[0] - 1)
    pos = torch.arange(t, device=x.device) - starts(lengths)[seg]
    keep = (pos >= offset[seg]) & (pos < offset[seg] + length[seg])
    ctx.set_out(op, "Out", x[_stable_partition(keep)])
    _set_out_lod(ctx, op, length.to(torch.int32))


@register("sequence_erase")
def _sequence_erase(ctx, op):
    """The rows holding one of ``tokens`` removed from every sequence
    (sequence_erase_op.cc): kept rows move to the front, in order, and
    the lengths count what each sequence kept."""
    x = ctx.in1(op, "X")
    lengths = _lengths(ctx, op)
    flat = x.reshape(-1) if x.dim() > 1 else x
    keep = torch.ones_like(flat, dtype=torch.bool)
    for tok in op.attr("tokens", []) or []:
        keep = keep & (flat != tok)
    ctx.set_out(op, "Out", x[_stable_partition(keep)])
    if lengths is not None:
        seg = segments(lengths, flat.shape[0])
        _set_out_lod(ctx, op, segment_sum(keep.to(torch.int32), seg,
                                          lengths.shape[0]))


@register("sequence_conv")
def _sequence_conv(ctx, op):
    """Context-window convolution over each sequence
    (sequence_conv_op.cc): out[t] = sum_k x[t + k + contextStart] W_k,
    zero where the window leaves the sequence."""
    x = ctx.in1(op, "X")                       # [T, D]
    w = ctx.in1(op, "Filter")                  # [ctx_len * D, M]
    ctx_len = int(op.attr("contextLength", 3))
    ctx_start = int(op.attr("contextStart", -(ctx_len // 2)))
    if int(op.attr("contextStride", 1)) != 1:
        raise ValueError("sequence_conv: contextStride must be 1 (the "
                         "reference's limitation too)")
    lengths = _lengths(ctx, op)
    t = x.shape[0]
    if lengths is None:
        lengths = _one_sequence(x)
    seg = segments(lengths, t)
    ar = torch.arange(t, device=x.device)
    pieces = []
    for k in range(ctx_len):
        off = ctx_start + k
        src = ar + off
        ok = (src >= 0) & (src < t) & \
            (seg[torch.clamp(src, 0, t - 1)] == seg)
        pieces.append(torch.where(ok[:, None], torch.roll(x, -off, 0), 0.0))
    ctx.set_out(op, "Out", torch.cat(pieces, dim=1) @ w)
    _set_out_lod(ctx, op, lengths)


@register("sequence_pad")
def _sequence_pad(ctx, op):
    """Flat rows and lengths -> padded [n, maxlen, ...] (maxlen the
    ``padded_length`` attr, else the flat total) filled with PadValue,
    and Length."""
    x = ctx.in1(op, "X")
    lengths = _lengths(ctx, op)
    maxlen = int(op.attr("padded_length", 0) or 0)
    pad_value = ctx.in1(op, "PadValue")
    if pad_value is None:
        pad_value = torch.zeros((), dtype=x.dtype, device=x.device)
    if lengths is None:
        ctx.set_out(op, "Out", x[None] if maxlen == 0 else x[None, :maxlen])
        ctx.set_out(op, "Length", _one_sequence(x))
        return
    n = lengths.shape[0]
    t = x.shape[0]
    if maxlen <= 0:
        maxlen = t
    steps = torch.arange(maxlen, device=x.device)
    rows = starts(lengths)[:, None] + steps[None, :]
    valid = steps[None, :] < lengths[:, None]
    gathered = x[torch.clamp(rows, 0, t - 1)]
    mask = valid.reshape((n, maxlen) + (1,) * (x.dim() - 1))
    ctx.set_out(op, "Out", torch.where(mask, gathered, pad_value))
    ctx.set_out(op, "Length", lengths)


@register("sequence_unpad")
def _sequence_unpad(ctx, op):
    """Padded [n, maxlen, ...] and Length -> flat rows, live slots first
    in order (the buffer keeps the padded size), and the lengths."""
    x = ctx.in1(op, "X")
    lengths = ctx.in1(op, "Length").reshape(-1).to(torch.int32)
    n, maxlen = x.shape[0], x.shape[1]
    flat = x.reshape((n * maxlen,) + tuple(x.shape[2:]))
    idx = unpad_index(lengths, maxlen, n * maxlen)
    ctx.set_out(op, "Out", torch.index_select(flat, 0, idx))
    _set_out_lod(ctx, op, lengths)


@register("sequence_scatter")
def _sequence_scatter(ctx, op):
    """Out = X with Updates added at rows Ids."""
    x = ctx.in1(op, "X")
    ids = ctx.in1(op, "Ids").reshape(-1).to(torch.int64)
    ctx.set_out(op, "Out", x.index_put((ids,), ctx.in1(op, "Updates"),
                                       accumulate=True))


@register("reorder_lod_tensor_by_rank")
def _reorder_lod_tensor_by_rank(ctx, op):
    """X's sequences in the rank table's order: decreasing length,
    stable (reorder_lod_tensor_by_rank_op.cc; the table is the lengths
    vector ``lod_rank_table`` makes). Without a LoD each row of X is a
    sequence; pad rows stay where they are."""
    x = ctx.in1(op, "X")
    table = ctx.in1(op, "RankTable").reshape(-1)
    lengths = _lengths(ctx, op)
    order = torch.argsort(-table, stable=True)   # new rank -> old sequence
    if lengths is None:
        ctx.set_out(op, "Out", x[order])
        return
    t = x.shape[0]
    n = lengths.shape[0]
    inv = torch.argsort(order, stable=True)      # old sequence -> new rank
    new_lens = lengths[order]
    new_starts = torch.cumsum(new_lens, 0) - new_lens
    seg = segments(lengths, t)
    seg_c = torch.clamp(seg, 0, n - 1)
    ar = torch.arange(t, device=x.device)
    new_row = new_starts[inv[seg_c]] + ar - starts(lengths)[seg_c]
    new_row = torch.where(seg < n, new_row, ar)
    ctx.set_out(op, "Out", torch.zeros_like(x).index_copy(0, new_row, x))
    _set_out_lod(ctx, op, new_lens)
