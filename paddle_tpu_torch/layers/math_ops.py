"""Operator-overload support for Variable arithmetic (a copy of
``paddle_tpu/layers/math_ops.py``)."""

import numpy as np

from ..core.program import Variable
from .layer_helper import LayerHelper


def _broadcast_shape(a, b):
    if a is None or b is None:
        return a or b
    try:
        return tuple(np.broadcast_shapes(tuple(a), tuple(b)))
    except ValueError:
        return a


_COMPARE_OPS = {"less_than", "less_equal", "greater_than", "greater_equal",
                "equal", "not_equal"}


def scale_var(x, scale=1.0, bias=0.0):
    helper = LayerHelper("scale")
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias)})
    return out


def _constant_like(x, value):
    helper = LayerHelper("fill")
    out = helper.create_variable_for_type_inference(
        x.dtype, shape=(1,), stop_gradient=True)
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": [1], "dtype": x.dtype,
                            "value": float(value)})
    return out


def elementwise_binary(x, other, op_type, reverse=False):
    if np.isscalar(other):
        # fast paths that keep the graph small
        if op_type == "elementwise_add":
            return scale_var(x, 1.0, other)
        if op_type == "elementwise_sub":
            return scale_var(x, -1.0 if reverse else 1.0,
                             other if reverse else -other)
        if op_type == "elementwise_mul":
            return scale_var(x, other)
        if op_type == "elementwise_div" and not reverse:
            return scale_var(x, 1.0 / other)
        other = _constant_like(x, other)
    a, b = (other, x) if reverse else (x, other)
    helper = LayerHelper(op_type)
    dtype = "bool" if op_type in _COMPARE_OPS else a.dtype
    out = helper.create_variable_for_type_inference(
        dtype, shape=_broadcast_shape(a.shape, b.shape))
    helper.append_op(type=op_type, inputs={"X": [a], "Y": [b]},
                     outputs={"Out": [out]}, attrs={"axis": -1})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """fluid.layers.scale parity (scale_op.cc): out = x*scale + bias
    (or (x+bias)*scale when bias_after_scale=False)."""
    if not bias_after_scale:
        bias = bias * scale
    out = scale_var(x, scale, bias)
    if act is None:
        return out
    helper = LayerHelper(act, name=name)
    final = helper.create_variable_for_type_inference(out.dtype,
                                                      shape=out.shape)
    helper.append_op(type=act, inputs={"X": [out]}, outputs={"Out": [final]})
    return final
