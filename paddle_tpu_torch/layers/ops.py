"""Generated unary and elementwise layer wrappers.

The counterpart of ``paddle_tpu/layers/ops.py``: one python function per
op type, built by the same generators so the emitted ops are identical.
Only the types the port lowers are generated here.
"""

from .layer_helper import LayerHelper

_UNARY_OPS = ["relu"]


def _make_layer(op_type):
    def layer(x, name=None, **kwargs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype,
                                                        shape=x.shape)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs={})
        return out

    layer.__name__ = op_type
    layer.__doc__ = "Elementwise %s (auto-generated wrapper)." % op_type
    return layer


_g = globals()
for _op in _UNARY_OPS:
    _g[_op] = _make_layer(_op)

__all__ = list(_UNARY_OPS)


def elementwise_layer(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        from .math_ops import _broadcast_shape
        helper = LayerHelper(op_type, act=act, name=name)
        out = helper.create_variable_for_type_inference(
            x.dtype, shape=_broadcast_shape(x.shape, y.shape))
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return helper.append_activation(out)
    layer.__name__ = op_type
    return layer


for _op in ["elementwise_add", "elementwise_mul", "elementwise_div"]:
    _g[_op] = elementwise_layer(_op)
    __all__.append(_op)
