"""fluid.layers-compatible DSL surface: the layers whose ops the port
lowers. The others (the other convs and pools, sequence, RNN, the rest of
control flow, ...) come with their lowerings (ROADMAP.md, queue 1)."""

from .compat import beam_search, beam_search_decode  # noqa: F401
from .control_flow import recompute  # noqa: F401
from .conv_layers import conv2d, pool2d  # noqa: F401
from .io_ops import data  # noqa: F401
from .math_ops import scale  # noqa: F401
from .nn import (  # noqa: F401
    accuracy, batch_norm, clip, clip_by_norm, cross_entropy, dropout,
    embedding, fc, label_smooth, layer_norm, matmul, mean, one_hot,
    reduce_sum, softmax, softmax_with_cross_entropy, topk,
)
from .ops import (  # noqa: F401
    elementwise_add, elementwise_div, elementwise_max, elementwise_min,
    elementwise_mul, elementwise_pow, elementwise_sub, relu, sigmoid, sign,
    sqrt, square,
)
from .parallel_layers import sequence_parallel_attention  # noqa: F401
from .tensor import (  # noqa: F401
    assign, cast, create_global_var, expand, fill_constant, reshape, split,
    sums, transpose,
)
