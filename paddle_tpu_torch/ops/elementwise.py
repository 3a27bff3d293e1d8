"""Elementwise binary ops (add, sub, mul, div, max, min, pow, mod,
floordiv), the comparisons (compare_op.cc) and the logical ops
(logical_op.cc).

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
    "elementwise_sub": torch.sub,
    "elementwise_mul": torch.mul,
    "elementwise_div": torch.div,
    "elementwise_max": torch.maximum,
    "elementwise_min": torch.minimum,
    "elementwise_pow": torch.pow,
    "elementwise_mod": torch.remainder,        # jnp.mod: floor modulo
    "elementwise_floordiv": torch.floor_divide,
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


_COMPARE = {
    "less_than": torch.lt,
    "less_equal": torch.le,
    "greater_than": torch.gt,
    "greater_equal": torch.ge,
    "equal": torch.eq,
    "not_equal": torch.ne,
}

_LOGICAL_BIN = {
    "logical_and": torch.logical_and,
    "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
}

for _table in (_BINARY, _COMPARE, _LOGICAL_BIN):
    for _name, _fn in _table.items():
        register(_name, _make_binary(_fn))


@register("logical_not")
def _logical_not(ctx, op):
    ctx.set_out(op, "Out", torch.logical_not(ctx.in1(op, "X")))
