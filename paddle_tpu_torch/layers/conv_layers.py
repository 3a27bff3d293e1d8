"""Convolution / pooling layer functions: conv2d, conv3d,
conv2d_transpose, conv3d_transpose, pool2d, pool3d, roi_pool, row_conv
and spp.

The counterpart of ``paddle_tpu/layers/conv_layers.py`` (a copy); each
builds its op through LayerHelper exactly as the JAX package's does, so
the two packages emit the same Program.
"""

import numpy as np

from .layer_helper import LayerHelper
from ..initializer import Normal


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v)] * n


def _conv_out_dim(size, k, p, s, d=1):
    if size is None or int(size) < 0:
        return -1
    return (int(size) + 2 * p - (d * (k - 1) + 1)) // s + 1


def _conv_nd_layer(nd, op_type, input, num_filters, filter_size, stride,
                   padding, dilation, groups, param_attr, bias_attr, act,
                   name):
    helper = LayerHelper(op_type, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    groups = groups or 1
    num_channels = input.shape[1]
    filter_size = _pair(filter_size, nd)
    stride = _pair(stride, nd)
    padding = _pair(padding, nd)
    dilation = _pair(dilation, nd)
    filter_shape = [num_filters, num_channels // groups] + filter_size

    fan_in = (num_channels // groups) * int(np.prod(filter_size))
    std = (2.0 / fan_in) ** 0.5
    filter_param = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=Normal(0.0, std))

    out_shape = (input.shape[0], num_filters) + tuple(
        _conv_out_dim(input.shape[2 + i], filter_size[i], padding[i],
                      stride[i], dilation[i]) for i in range(nd))
    pre_bias = helper.create_variable_for_type_inference(dtype,
                                                         shape=out_shape)
    helper.append_op(
        type=op_type,
        inputs={"Input": [input], "Filter": [filter_param]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    return _conv_nd_layer(2, "conv2d", input, num_filters, filter_size,
                          stride, padding, dilation, groups, param_attr,
                          bias_attr, act, name)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    return _conv_nd_layer(3, "conv3d", input, num_filters, filter_size,
                          stride, padding, dilation, groups, param_attr,
                          bias_attr, act, name)


def _conv_transpose(nd, op_type, input, num_filters, output_size=None,
                    filter_size=None, padding=0, stride=1, dilation=1,
                    groups=None, param_attr=None, bias_attr=None,
                    use_cudnn=True, act=None, name=None):
    helper = LayerHelper(op_type, param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    dtype = input.dtype
    groups = groups or 1
    num_channels = input.shape[1]
    padding = _pair(padding, nd)
    stride = _pair(stride, nd)
    dilation = _pair(dilation, nd)
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size must be set when filter_size is None")
        output_size = _pair(output_size, nd)
        filter_size = [
            (output_size[i] - (input.shape[2 + i] - 1) * stride[i]
             + 2 * padding[i] - 1) // dilation[i] + 1 for i in range(nd)]
    else:
        filter_size = _pair(filter_size, nd)
    filter_shape = [num_channels, num_filters // groups] + filter_size
    img_filter = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype)
    if output_size is not None:
        out_sp = tuple(_pair(output_size, nd))
    else:
        out_sp = tuple(
            -1 if input.shape[2 + i] in (None, -1) else
            (input.shape[2 + i] - 1) * stride[i] - 2 * padding[i]
            + dilation[i] * (filter_size[i] - 1) + 1 for i in range(nd))
    pre_bias = helper.create_variable_for_type_inference(
        dtype, shape=(input.shape[0], num_filters) + out_sp)
    attrs = {"strides": stride, "paddings": padding, "dilations": dilation,
             "groups": groups}
    if output_size is not None:
        attrs["output_size"] = _pair(output_size, nd)
    helper.append_op(
        type=op_type,
        inputs={"Input": [input], "Filter": [img_filter]},
        outputs={"Output": [pre_bias]}, attrs=attrs)
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    return _conv_transpose(2, "conv2d_transpose", input, num_filters,
                           output_size, filter_size, padding, stride,
                           dilation, groups, param_attr, bias_attr,
                           use_cudnn, act, name)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    return _conv_transpose(3, "conv3d_transpose", input, num_filters,
                           output_size, filter_size, padding, stride,
                           dilation, groups, param_attr, bias_attr,
                           use_cudnn, act, name)


def _pool(nd, op_type, input, pool_size, pool_type, pool_stride, pool_padding,
          global_pooling, use_cudnn, ceil_mode, name, exclusive=True):
    if pool_type not in ("max", "avg"):
        raise ValueError("pool_type must be 'max' or 'avg', got %r" % pool_type)
    helper = LayerHelper(op_type, name=name)
    pool_size = _pair(pool_size, nd)
    pool_stride = _pair(pool_stride or pool_size, nd)
    pool_padding = _pair(pool_padding, nd)

    def odim(i):
        s = input.shape[2 + i]
        if s in (None, -1):
            return -1
        if global_pooling:
            return 1
        span = s + 2 * pool_padding[i] - pool_size[i]
        if ceil_mode:
            return -(-span // pool_stride[i]) + 1
        return span // pool_stride[i] + 1

    out_shape = (input.shape[0], input.shape[1]) + tuple(
        odim(i) for i in range(nd))
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=out_shape)
    helper.append_op(
        type=op_type, inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": pool_size,
               "global_pooling": global_pooling, "strides": pool_stride,
               "paddings": pool_padding, "ceil_mode": ceil_mode,
               "exclusive": exclusive})
    return out


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True):
    if pool_size == -1:
        global_pooling = True
        pool_size = 1
    return _pool(2, "pool2d", input, pool_size, pool_type, pool_stride,
                 pool_padding, global_pooling, use_cudnn, ceil_mode, name,
                 exclusive)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True):
    if pool_size == -1:
        global_pooling = True
        pool_size = 1
    return _pool(3, "pool3d", input, pool_size, pool_type, pool_stride,
                 pool_padding, global_pooling, use_cudnn, ceil_mode, name,
                 exclusive)


def roi_pool(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0):
    helper = LayerHelper("roi_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="roi_pool", inputs={"X": [input], "ROIs": [rois]},
        outputs={"Out": [out]},
        attrs={"pooled_height": pooled_height, "pooled_width": pooled_width,
               "spatial_scale": spatial_scale})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act)
    filter_shape = [future_context_size + 1, input.shape[-1]]
    filter_param = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=input.shape)
    helper.append_op(
        type="row_conv", inputs={"X": [input], "Filter": [filter_param]},
        outputs={"Out": [out]})
    return helper.append_activation(out)


def spp(input, pyramid_height=1, pool_type="max", name=None):
    helper = LayerHelper("spp", name=name)
    c = input.shape[1]
    width = c * sum(4 ** lvl for lvl in range(pyramid_height))
    out = helper.create_variable_for_type_inference(
        input.dtype, shape=(input.shape[0], width))
    helper.append_op(
        type="spp", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pyramid_height": pyramid_height, "pooling_type": pool_type})
    return out
