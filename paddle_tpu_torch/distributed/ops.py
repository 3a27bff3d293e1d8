"""SelectedRows host ops: split_ids, split_selected_rows,
merge_selected_rows and lookup_sparse_table.

The counterpart of the local ops of ``paddle_tpu/distributed/ops.py``
(operators/{split_ids,split_selected_rows,merge_selected_rows,
lookup_sparse_table}_op.cc). Each output's row count depends on the
data, so they are host ops (``register(..., host=True)``): a program
that holds one runs through ``Executor.run`` op by op, and
``Executor.run_steps`` refuses it. Their tensors stay on the
executor's device; only the row counts are read on the host.
"""

import torch

from ..core.registry import register
from ..core.selected_rows import SelectedRows, merge_rows


@register("split_ids", host=True)
def _split_ids(ctx, op):
    """Ids split by id mod the number of outputs, each [n_i, 1] int64."""
    ids = ctx.in1(op, "Ids").reshape(-1).long()
    outs = op.output("Out")
    n = len(outs)
    for i, out in enumerate(outs):
        ctx.env[out] = ids[ids % n == i].reshape(-1, 1)


@register("split_selected_rows", host=True)
def _split_selected_rows(ctx, op):
    """X cut into row ranges (``height_sections``, else equal ranges of
    its height), each with its rows made local to its range."""
    sr = ctx.in1(op, "X")
    outs = op.output("Out")
    sections = op.attr("height_sections") or []
    if sections:
        bounds = [0]
        for h in sections:
            bounds.append(bounds[-1] + int(h))
    else:       # np.linspace(0, height, n + 1), truncated
        n = len(outs)
        bounds = [int(i * (sr.height / n)) for i in range(n)] + [sr.height]
    for i, out in enumerate(outs):
        lo, hi = bounds[i], bounds[i + 1]
        mask = (sr.rows >= lo) & (sr.rows < hi)
        ctx.env[out] = SelectedRows(sr.rows[mask] - lo, sr.value[mask],
                                    hi - lo)


@register("merge_selected_rows", host=True)
def _merge_selected_rows(ctx, op):
    """X with its duplicate rows summed, rows sorted; a dense X passes."""
    sr = ctx.in1(op, "X")
    if isinstance(sr, SelectedRows):
        sr = merge_rows(sr.rows, sr.value, sr.height)
    ctx.set_out(op, "Out", sr)


@register("lookup_sparse_table", host=True)
def _lookup_sparse_table(ctx, op):
    """The rows of a SelectedRows-stored table W at Ids (the last of a
    repeated row), zeros for an id it does not hold; a dense W is read
    at the ids clipped into it."""
    w = ctx.in1(op, "W")
    ids = ctx.in1(op, "Ids").reshape(-1).long()
    if isinstance(w, SelectedRows):
        ids = ids.to(w.device)
        hit = w.rows[None, :] == ids[:, None]               # [n, rows]
        found = hit.any(dim=1)
        pos = torch.where(hit, torch.arange(w.rows.shape[0],
                                            device=w.device), -1).amax(dim=1)
        rows = torch.where(found[:, None], w.value[pos],
                           torch.zeros((), dtype=w.value.dtype,
                                       device=w.device))
    else:
        rows = w[torch.clamp(ids, 0, w.shape[0] - 1)]
    ctx.set_out(op, "Out", rows)
