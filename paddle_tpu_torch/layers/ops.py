"""Generated unary, elementwise, comparison and logical layer wrappers.

The counterpart of ``paddle_tpu/layers/ops.py`` (a copy): one python
function per op type, built by the same generators so the emitted ops
are identical.
"""

from .layer_helper import LayerHelper

_UNARY_OPS = [
    "sigmoid", "logsigmoid", "exp", "relu", "tanh", "tanh_shrink", "sqrt",
    "rsqrt", "abs", "ceil", "floor", "cos", "sin", "round", "reciprocal",
    "log", "square", "softplus", "softsign", "sign", "gelu", "erf",
    "brelu", "leaky_relu", "soft_relu", "elu", "relu6", "pow", "stanh",
    "hard_shrink", "softshrink", "thresholded_relu", "hard_sigmoid", "swish",
    "mish", "silu", "cumsum",
]

_ATTR_NAMES = {
    "brelu": ("t_min", "t_max"),
    "leaky_relu": ("alpha",),
    "soft_relu": ("threshold",),
    "elu": ("alpha",),
    "relu6": ("threshold",),
    "pow": ("factor",),
    "stanh": ("scale_a", "scale_b"),
    "hard_shrink": ("threshold",),
    "softshrink": ("lambda",),
    "thresholded_relu": ("threshold",),
    "hard_sigmoid": ("slope", "offset"),
    "swish": ("beta",),
    "gelu": ("approximate",),
    "cumsum": ("axis", "exclusive", "reverse"),
}


def _make_layer(op_type):
    allowed = _ATTR_NAMES.get(op_type, ())

    def layer(x, name=None, **kwargs):
        attrs = {k: v for k, v in kwargs.items() if k in allowed}
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype,
                                                        shape=x.shape)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
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


for _op in ["elementwise_add", "elementwise_sub", "elementwise_mul",
            "elementwise_div", "elementwise_max", "elementwise_min",
            "elementwise_pow"]:
    _g[_op] = elementwise_layer(_op)
    __all__.append(_op)


def _compare_layer(op_type):
    def layer(x, y, cond=None, **ignored):
        helper = LayerHelper(op_type)
        if cond is None:
            cond = helper.create_variable_for_type_inference(
                "bool", shape=x.shape)
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [cond]}, attrs={"axis": -1})
        return cond
    layer.__name__ = op_type
    return layer


for _op in ["less_than", "less_equal", "greater_than", "greater_equal",
            "equal", "not_equal"]:
    _g[_op] = _compare_layer(_op)
    __all__.append(_op)


def logical_op_layer(op_type, binary=True):
    def layer(x, y=None, out=None, name=None):
        helper = LayerHelper(op_type, name=name)
        if out is None:
            out = helper.create_variable_for_type_inference(
                "bool", shape=x.shape)
        inputs = {"X": [x]}
        if binary:
            inputs["Y"] = [y]
        helper.append_op(type=op_type, inputs=inputs, outputs={"Out": [out]})
        return out
    layer.__name__ = op_type
    return layer


for _op in ["logical_and", "logical_or", "logical_xor"]:
    _g[_op] = logical_op_layer(_op)
    __all__.append(_op)
_g["logical_not"] = logical_op_layer("logical_not", binary=False)
__all__.append("logical_not")
