"""Elementwise binary ops: add, mul, div.

The counterpart of ``paddle_tpu/ops/elementwise.py``, with its broadcast
rule: Y's dims align to X starting at ``axis`` (elementwise_op_function.h),
or trailing-aligned when ``axis`` is -1.
"""

import torch

from ..core.registry import register


def _broadcast_y(x, y, axis):
    if x.dim() == y.dim() or y.dim() == 0:
        return y
    if axis is None or axis == -1:
        return y  # numpy trailing broadcast
    axis = int(axis)
    new_shape = (1,) * axis + tuple(y.shape) + \
        (1,) * (x.dim() - axis - y.dim())
    return y.reshape(new_shape)


_BINARY = {
    "elementwise_add": torch.add,
    "elementwise_mul": torch.mul,
    "elementwise_div": torch.div,
}


def _make_binary(fn):
    def lower(ctx, op):
        x = ctx.in1(op, "X")
        y = ctx.in1(op, "Y")
        y = _broadcast_y(x, y, op.attr("axis", -1))
        out = fn(x, y)
        scale = op.attr("scale")  # fused scale support (elementwise add_op)
        if scale is not None and scale != 1.0:
            out = out * scale
        ctx.set_out(op, "Out", out)
    return lower


for _name, _fn in _BINARY.items():
    register(_name, _make_binary(_fn))
