"""fluid.layers-compatible DSL surface: the layers whose ops the port
lowers, and the reader-layer API as host readers. The others come with
their lowerings (ROADMAP.md, queue 1)."""

from . import ops  # noqa: F401
from .compat import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from . import control_flow  # noqa: F401
from .conv_layers import (  # noqa: F401
    conv2d, conv2d_transpose, conv3d, conv3d_transpose, pool2d, pool3d,
    roi_pool, row_conv, spp,
)
from .io_ops import data  # noqa: F401
from . import learning_rate_scheduler  # noqa: F401
from .learning_rate_scheduler import (  # noqa: F401
    exponential_decay, inverse_time_decay, natural_exp_decay, noam_decay,
    piecewise_decay, polynomial_decay,
)
from .math_ops import scale  # noqa: F401
from .nn import (  # noqa: F401
    accuracy, auc, batch_norm, clip, clip_by_norm, cos_sim, crf_decoding,
    cross_entropy, dropout, embedding, fc, l2_normalize, label_smooth,
    layer_norm, linear_chain_crf, matmul, mean, one_hot, reduce_max,
    reduce_mean, reduce_min, reduce_prod, reduce_sum,
    sigmoid_cross_entropy_with_logits, softmax, softmax_with_cross_entropy,
    square_error_cost, topk,
)
from .ops import *  # noqa: F401,F403
from .parallel_layers import (  # noqa: F401
    pipelined_decoder_stack, sequence_parallel_attention, sparse_moe,
)
from .rnn_layers import *  # noqa: F401,F403
from .sequence_layers import *  # noqa: F401,F403
from .tensor import (  # noqa: F401
    argmax, argmin, assign, cast, concat, create_global_var, create_tensor,
    expand, fill_constant, fill_constant_batch_size_like, gather, increment,
    ones, reshape, scatter, slice, split, sums, transpose, zeros,
)
