"""v2 network helper groups (python/paddle/v2/networks.py →
trainer_config_helpers/networks.py parity): the composite blocks the v2
book scripts call, built from fluid layers.

Shape note: v2 image data arrives as a FLAT dense_vector; the conv
groups reshape it to [C, H, W] with H = W inferred from the vector
width and num_channel (the reference inferred the same from the data
layer's height/width fields)."""

import math

from .. import layers as fluid_layers
from .. import nets as fluid_nets
from .layer import _act_name
from .pooling import pool_name


def _to_chw(input, num_channel):
    """Flat [N, D] v2 image input → [N, C, H, W]; pass-through when the
    input is already 4-D."""
    if len(input.shape) >= 4:
        return input
    d = int(input.shape[-1])
    c = int(num_channel or 1)
    hw = int(math.isqrt(d // c))
    if c * hw * hw != d:
        raise ValueError(
            "cannot infer square image from width %d with %d channels"
            % (d, c))
    return fluid_layers.reshape(input, [-1, c, hw, hw])


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         pool_type=None, act=None, groups=1,
                         conv_stride=1, conv_padding=0, num_channel=None,
                         pool_stride=1, pool_padding=0, **kwargs):
    """Img input => Conv => Pooling (networks.py:144 parity; the
    composite body is fluid nets.simple_img_conv_pool)."""
    img = _to_chw(input, num_channel)
    if conv_stride != 1 or conv_padding != 0 or groups != 1 \
            or pool_padding != 0:
        conv = fluid_layers.conv2d(
            img, num_filters=num_filters, filter_size=filter_size,
            stride=conv_stride, padding=conv_padding, groups=groups,
            act=_act_name(act))
        return fluid_layers.pool2d(
            conv, pool_size=pool_size,
            pool_type=pool_name(pool_type, aliases={"average": "avg"},
                                allowed=("max", "avg")),
            pool_stride=pool_stride, pool_padding=pool_padding)
    return fluid_nets.simple_img_conv_pool(
        img, num_filters=num_filters, filter_size=filter_size,
        pool_size=pool_size, pool_stride=pool_stride,
        act=_act_name(act),
        pool_type=pool_name(pool_type, aliases={"average": "avg"},
                            allowed=("max", "avg")))


def sequence_conv_pool(input, context_len, hidden_size, pool_type=None,
                       act=None, **kwargs):
    """Text input => Context Projection => FC => Pooling
    (networks.py:40 parity; composite body is fluid
    nets.sequence_conv_pool). The v2 default activation is tanh; an
    explicit Linear() means none."""
    act_name = "tanh" if act is None else _act_name(act)
    return fluid_nets.sequence_conv_pool(
        input, num_filters=hidden_size, filter_size=context_len,
        act=act_name, pool_type=pool_name(pool_type))


__all__ = ["simple_img_conv_pool", "sequence_conv_pool"]
