"""v2 layer aliases (python/paddle/v2/layer.py + trainer_config_helpers
parity, minimal set): v2 names over the fluid layer DSL. Each returns a
fluid Variable, so v2 and fluid layers compose freely."""

from .. import layers as fluid_layers
from . import data_type as dtype_mod


def data(name, type, **kwargs):
    """v2: paddle.layer.data(name=..., type=paddle.data_type.*)."""
    if not isinstance(type, dtype_mod.InputType):
        raise TypeError("type must be a paddle.v2.data_type InputType")
    shape = [1] if type.dtype == "int64" else [type.dim]
    var = fluid_layers.data(name, shape, dtype=type.dtype,
                            lod_level=1 if type.seq_type else 0)
    if type.dtype == "int64":
        var._v2_vocab = type.dim   # integer range -> embedding vocab size
    return var


def fc(input, size, act=None, param_attr=None, bias_attr=None, **kwargs):
    act_name = _act_name(act)
    if isinstance(input, (list, tuple)):
        input = fluid_layers.concat(list(input), axis=1)
    return fluid_layers.fc(input, size, act=act_name,
                           param_attr=_param_attr(param_attr),
                           bias_attr=bias_attr
                           if bias_attr in (None, False)
                           else _param_attr(bias_attr))


def _param_attr(attr):
    """v2 attr.Param → fluid ParamAttr (pass ParamAttr/None through)."""
    if attr is None or not hasattr(attr, "to_param_attr"):
        return attr
    return attr.to_param_attr()


def embedding(input, size, **kwargs):
    # v2: `size` is the embedding WIDTH; vocab comes from the data layer's
    # declared integer range — the trainer records it on the Variable
    vocab = getattr(input, "_v2_vocab", None)
    if vocab is None:
        raise ValueError(
            "v2 embedding needs the input from paddle.v2.layer.data with "
            "an integer_value(_sequence) type")
    return fluid_layers.embedding(input, size=[vocab, size])


def lstmemory(input, size=None, reverse=False, **kwargs):
    width = input.shape[-1]
    h, _ = fluid_layers.dynamic_lstm(input, size=width, is_reverse=reverse)
    return h


def simple_gru(input, size, **kwargs):
    proj = fluid_layers.fc(input, size * 3)
    return fluid_layers.dynamic_gru(proj, size=size)


def pooling(input, pooling_type="max", **kwargs):
    from .pooling import pool_name
    return fluid_layers.sequence_pool(input, pool_name(pooling_type))


def img_conv(input, filter_size, num_filters, num_channel=None,
             stride=1, padding=0, act=None, **kwargs):
    """v2 paddle.layer.img_conv (trainer_config_helpers
    img_conv_layer:2510 capability)."""
    from .networks import _to_chw
    return fluid_layers.conv2d(
        _to_chw(input, num_channel), num_filters=num_filters,
        filter_size=filter_size, stride=stride, padding=padding,
        act=_act_name(act))


def img_pool(input, pool_size, pool_type=None, stride=1, padding=0,
             **kwargs):
    """v2 paddle.layer.img_pool (img_pool_layer:2728 capability)."""
    from .pooling import pool_name
    return fluid_layers.pool2d(
        input, pool_size=pool_size,
        pool_type=pool_name(pool_type, aliases={"average": "avg"},
                            allowed=("max", "avg")),
        pool_stride=stride, pool_padding=padding)


def max_id(input, **kwargs):
    """v2 paddle.layer.max_id: argmax over the class dim (the book
    scripts' inference head)."""
    return fluid_layers.argmax(input, axis=-1)


def first_seq(input, **kwargs):
    return fluid_layers.sequence_first_step(input)


def last_seq(input, **kwargs):
    return fluid_layers.sequence_last_step(input)


def concat(input, **kwargs):
    return fluid_layers.concat(list(input), axis=1)


def dropout(input, dropout_rate=0.5, **kwargs):
    return fluid_layers.dropout(input, dropout_prob=dropout_rate)


def classification_cost(input, label, **kwargs):
    cost = fluid_layers.cross_entropy(input, label)
    return fluid_layers.mean(cost)


def cross_entropy_cost(input, label, **kwargs):
    return classification_cost(input, label)


def square_error_cost(input, label, **kwargs):
    return fluid_layers.mean(
        fluid_layers.square_error_cost(input, label))


regression_cost = square_error_cost


def _act_name(act):
    if act is None:
        return None
    if isinstance(act, str):
        return act.lower()
    name = type(act).__name__.lower()    # v2 activation objects
    for known in ("softmax", "relu", "sigmoid", "tanh", "linear"):
        if known in name:
            return None if known == "linear" else known
    return None
