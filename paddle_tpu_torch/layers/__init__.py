"""fluid.layers-compatible DSL surface: the layers whose ops the port
lowers. The others (the other convs and pools, sequence, RNN, control
flow, recompute, ...) come with their lowerings (ROADMAP.md, queue 1)."""

from .conv_layers import conv2d, pool2d  # noqa: F401
from .io_ops import data  # noqa: F401
from .math_ops import scale  # noqa: F401
from .nn import (  # noqa: F401
    accuracy, batch_norm, cross_entropy, embedding, fc, layer_norm,
    matmul, mean, reduce_sum, softmax, softmax_with_cross_entropy, topk,
)
from .ops import (  # noqa: F401
    elementwise_add, elementwise_div, elementwise_mul, relu,
)
from .parallel_layers import sequence_parallel_attention  # noqa: F401
from .tensor import (  # noqa: F401
    assign, create_global_var, expand, fill_constant, reshape,
    transpose,
)
