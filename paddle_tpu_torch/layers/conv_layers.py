"""Convolution / pooling layer functions: conv2d and pool2d.

The counterpart of ``paddle_tpu/layers/conv_layers.py`` for the layers
whose ops the port lowers; each builds its op through LayerHelper exactly
as the JAX package's does, so the two packages emit the same Program. The
other layers of that module (conv3d, the transposed convs, pool3d,
adaptive pooling, roi_pool, row_conv, spp, im2sequence) come with their
lowerings (ROADMAP.md, queue 1 item 7).
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
