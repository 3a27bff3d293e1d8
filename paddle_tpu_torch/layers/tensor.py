"""Tensor layers.

The counterpart of ``paddle_tpu/layers/tensor.py``, holding the layers
the flagship LM, the optimizers, the gradient clips, the mnist models and
``nets.glu`` use: create_global_var, cast, sums, assign, fill_constant,
reshape, transpose, expand and split.
"""

import numpy as np

from ..core.program import Variable, convert_dtype
from .layer_helper import LayerHelper


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    from ..initializer import ConstantInitializer
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        dtype=dtype, shape=shape, persistable=persistable, name=name)
    helper.set_variable_initializer(var, ConstantInitializer(value))
    return var


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype, shape=x.shape)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    in_shape = input.shape
    ax = dim % len(in_shape) if in_shape is not None else dim
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = None
        sizes = ([in_shape[ax] // num] * num
                 if in_shape is not None and in_shape[ax] > 0 else None)
    else:
        sections = list(num_or_sections)
        num = 0
        sizes = sections
    outs = []
    for i in range(len(sizes) if sizes else num):
        shape = None
        if in_shape is not None and sizes:
            s = list(in_shape)
            s[ax] = sizes[i]
            shape = tuple(s)
        outs.append(helper.create_variable_for_type_inference(
            input.dtype, shape=shape))
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs},
                     attrs={"axis": dim, "num": num,
                            "sections": sections or []})
    return outs


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(
            input[0].dtype, shape=input[0].shape)
    helper.append_op(type="sum", inputs={"X": list(input)},
                     outputs={"Out": [out]})
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(
                input.dtype, shape=input.shape)
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
    elif isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(
                str(input.dtype), shape=input.shape)
        helper.append_op(type="assign_value", outputs={"Out": [output]},
                         attrs={"shape": list(input.shape),
                                "dtype": str(input.dtype),
                                "values": input})
    else:
        raise TypeError("assign expects Variable or ndarray")
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(
            convert_dtype(dtype), shape=tuple(shape), stop_gradient=True)
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": convert_dtype(dtype),
                            "value": float(value)})
    out.stop_gradient = True
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape", act=act, name=name)
    new_shape = list(shape)
    if x.shape is not None:
        resolved = [x.shape[i] if s == 0 else s
                    for i, s in enumerate(new_shape)]
    else:
        resolved = new_shape
    out = helper.create_variable_for_type_inference(
        x.dtype, shape=tuple(resolved))
    helper.append_op(type="reshape", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"shape": new_shape})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    shape = tuple(x.shape[p] for p in perm) if x.shape is not None else None
    out = helper.create_variable_for_type_inference(x.dtype, shape=shape)
    helper.append_op(type="transpose", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": list(perm)})
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    shape = None
    if x.shape is not None:
        shape = tuple(s * t if s > 0 else -1
                      for s, t in zip(x.shape, expand_times))
    out = helper.create_variable_for_type_inference(x.dtype, shape=shape)
    helper.append_op(type="expand", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return out
