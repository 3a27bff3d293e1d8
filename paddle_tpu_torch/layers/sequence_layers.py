"""Sequence layer functions (fluid.layers.sequence_* parity,
python/paddle/fluid/layers/nn.py).

The counterpart of ``paddle_tpu/layers/sequence_layers.py`` (a copy: the
two packages build the same Programs)."""

from .layer_helper import LayerHelper

__all__ = ["sequence_conv", "sequence_pool", "sequence_softmax",
           "sequence_first_step", "sequence_last_step", "sequence_expand",
           "sequence_concat", "sequence_reshape", "sequence_slice",
           "sequence_erase", "sequence_pad", "sequence_unpad",
           "lod_reset"]


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None):
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act)
    filter_shape = [filter_size * input.shape[1], num_filters]
    filter_param = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=input.dtype)
    pre_bias = helper.create_variable_for_type_inference(
        input.dtype, shape=(input.shape[0], num_filters))
    helper.append_op(
        type="sequence_conv",
        inputs={"X": [input], "Filter": [filter_param]},
        outputs={"Out": [pre_bias]},
        attrs={"contextStride": filter_stride,
               "contextStart": -int(filter_size // 2),
               "contextLength": filter_size})
    pre_act = helper.append_bias_op(pre_bias)
    return helper.append_activation(pre_act)


def _pool_op(input, pool_type):
    helper = LayerHelper("sequence_pool")
    out_shape = ((-1,) + tuple(input.shape[1:])) if input.shape else None
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=out_shape)
    max_index = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="sequence_pool", inputs={"X": [input]},
                     outputs={"Out": [out], "MaxIndex": [max_index]},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_pool(input, pool_type):
    return _pool_op(input, pool_type)


def sequence_first_step(input):
    return _pool_op(input, "first")


def sequence_last_step(input):
    return _pool_op(input, "last")


def sequence_softmax(input, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=input.shape)
    helper.append_op(type="sequence_softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_expand", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"ref_level": ref_level})
    return out


def lod_reset(x, y=None, target_lod=None, name=None):
    """Rebind x's LoD from y (its LoD, or its values as offsets) or from
    the target_lod offset list (layers/nn.py lod_reset parity)."""
    if y is None and target_lod is None:
        raise ValueError("lod_reset: y and target_lod should not be "
                         "both none")
    helper = LayerHelper("lod_reset", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x]}
    if y is not None:
        inputs["Y"] = [y]
    helper.append_op(
        type="lod_reset", inputs=inputs, outputs={"Out": [out]},
        attrs={"target_lod":
               [int(v) for v in target_lod] if target_lod is not None
               else []})
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="sequence_concat", inputs={"X": list(input)},
                     outputs={"Out": [out]})
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_reshape", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"new_dim": new_dim})
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_slice",
                     inputs={"X": [input], "Offset": [offset],
                             "Length": [length]},
                     outputs={"Out": [out]})
    return out


def sequence_erase(input, tokens, name=None):
    helper = LayerHelper("sequence_erase", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_erase", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"tokens": list(tokens)})
    return out


def sequence_pad(x, pad_value=None, maxlen=None, name=None):
    from .tensor import fill_constant
    helper = LayerHelper("sequence_pad", name=name)
    if pad_value is None:
        pad_value = fill_constant([1], x.dtype, 0.0)
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="sequence_pad",
                     inputs={"X": [x], "PadValue": [pad_value]},
                     outputs={"Out": [out], "Length": [length]},
                     attrs={"padded_length": maxlen or 0})
    return out, length


def sequence_unpad(x, length, name=None):
    helper = LayerHelper("sequence_unpad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_unpad",
                     inputs={"X": [x], "Length": [length]},
                     outputs={"Out": [out]})
    return out
