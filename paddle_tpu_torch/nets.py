"""Composite network pieces.

The counterpart of ``paddle_tpu/nets.py``: ``simple_img_conv_pool``,
``img_conv_group`` (VGG's blocks), ``glu`` and
``scaled_dot_product_attention``, built through the port's ``layers`` so
they emit the JAX package's ops. ``sequence_conv_pool`` needs LoD
sequences, which the port does not have yet.
"""

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, param_attr=None,
                         pool_type="max", use_cudnn=True):
    conv_out = layers.conv2d(input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             act=act)
    return layers.pool2d(conv_out, pool_size=pool_size,
                         pool_stride=pool_stride, pool_type=pool_type)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    tmp = input
    n = len(conv_num_filter)

    def listify(obj):
        if isinstance(obj, (list, tuple)):
            assert len(obj) == n
            return list(obj)
        return [obj] * n

    conv_padding = listify(conv_padding)
    conv_filter_size = listify(conv_filter_size)
    param_attr = listify(param_attr)
    conv_with_batchnorm = listify(conv_with_batchnorm)
    conv_batchnorm_drop_rate = listify(conv_batchnorm_drop_rate)

    for i in range(n):
        local_conv_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(tmp, num_filters=conv_num_filter[i],
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i],
                            param_attr=param_attr[i], act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(tmp, act=conv_act)
            if conv_batchnorm_drop_rate[i] > 0:
                tmp = layers.dropout(tmp,
                                     dropout_prob=conv_batchnorm_drop_rate[i])
    return layers.pool2d(tmp, pool_size=pool_size, pool_stride=pool_stride,
                         pool_type=pool_type)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    raise NotImplementedError(
        "nets.sequence_conv_pool needs LoD sequences (sequence_conv, "
        "sequence_pool), which the port does not have yet (ROADMAP.md, "
        "queue 1 item 7)")


def glu(input, dim=-1):
    """Gated linear unit: split in half along dim, a * sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention over [batch, len, d]
    tensors, composed from matmul and softmax (nets.py:168)."""
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError("queries and keys must have the same hidden size")
    if (keys.shape is not None and values.shape is not None
            and keys.shape[-2] != values.shape[-2]):
        raise ValueError("keys and values must have the same length")

    def split_heads(x):
        if num_heads == 1:
            return x
        b, t, d = x.shape
        reshaped = layers.reshape(x, shape=[b, t, num_heads, d // num_heads])
        return layers.transpose(reshaped, perm=[0, 2, 1, 3])

    def combine_heads(x):
        if num_heads == 1:
            return x
        b, h, t, dk = x.shape
        trans = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(trans, shape=[b, t, h * dk])

    q = split_heads(queries)
    k = split_heads(keys)
    v = split_heads(values)
    key_dim = queries.shape[-1] // num_heads
    scaled_q = layers.scale(q, scale=key_dim ** -0.5)
    product = layers.matmul(scaled_q, k, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx = layers.matmul(weights, v)
    return combine_heads(ctx)
