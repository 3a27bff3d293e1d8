"""Tensor layers.

The counterpart of ``paddle_tpu/layers/tensor.py`` (a copy): the
creation, cast, concat, split, reshape, transpose, expand, gather,
scatter, argmax/argmin, increment and slice layers.
"""

import numpy as np

from ..core.program import Variable, convert_dtype
from .layer_helper import LayerHelper


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


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


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    shape = None
    if all(x.shape is not None for x in input):
        shape = list(input[0].shape)
        ax = axis % len(shape)
        shape[ax] = sum(x.shape[ax] for x in input) \
            if all(x.shape[ax] > 0 for x in input) else -1
        shape = tuple(shape)
    out = helper.create_variable_for_type_inference(input[0].dtype,
                                                    shape=shape)
    helper.append_op(type="concat", inputs={"X": list(input)},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


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


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(
        convert_dtype(dtype), shape=tuple(shape), stop_gradient=True)
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "dtype": convert_dtype(dtype),
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


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


def gather(input, index):
    helper = LayerHelper("gather")
    shape = None
    if input.shape is not None and index.shape is not None:
        shape = tuple(index.shape[:1]) + tuple(input.shape[1:])
    out = helper.create_variable_for_type_inference(input.dtype, shape=shape)
    helper.append_op(type="gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=input.shape)
    helper.append_op(type="scatter",
                     inputs={"X": [input], "Ids": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]}, attrs={"overwrite": overwrite})
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max")
    shape = None
    if x.shape is not None:
        shape = tuple(s for i, s in enumerate(x.shape)
                      if i != axis % len(x.shape))
    out = helper.create_variable_for_type_inference("int64", shape=shape)
    helper.append_op(type="arg_max", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def argmin(x, axis=0):
    helper = LayerHelper("arg_min")
    shape = None
    if x.shape is not None:
        shape = tuple(s for i, s in enumerate(x.shape)
                      if i != axis % len(x.shape))
    out = helper.create_variable_for_type_inference("int64", shape=shape)
    helper.append_op(type="arg_min", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype,
                                                        shape=x.shape)
    helper.append_op(type="increment", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def slice(input, axes, starts, ends, name=None):
    """fluid.layers.slice parity (slice_op.cc)."""
    helper = LayerHelper("slice", name=name)
    shape = None
    if input.shape is not None:
        shape = list(input.shape)
        for ax, s, e in zip(axes, starts, ends):
            n = shape[ax]
            if n is not None and n >= 0:
                s2 = s if s >= 0 else n + s
                e2 = min(e if e >= 0 else n + e, n)
                shape[ax] = max(0, e2 - s2)
            else:
                shape[ax] = -1
        shape = tuple(shape)
    out = helper.create_variable_for_type_inference(input.dtype, shape=shape)
    helper.append_op(type="slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out
