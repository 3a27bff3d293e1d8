"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The package mirrors ``paddle_tpu``'s layout and names so each module's
counterpart is easy to find; it imports ``torch`` and never ``jax`` or
``paddle_tpu``. Entry points run on the CUDA card unless the caller
passes ``device="cpu"`` (or ``CPUPlace()``), and raise without a card.

Ported so far:

  * serving: ``serving.Engine`` over
    ``models.transformer_infer.TransformerLMInfer`` with the paged KV
    pool, the radix prefix cache and the hand-written CUDA
    paged-attention kernel (``ops/csrc/paged_attention.cu``);
  * training: the Fluid front half as far as the flagship LM's training
    step needs it — ``Program``/``layers``/``Executor``/
    ``append_backward``/``optimizer.SGD``/``optimizer.Adam`` — with
    ``sp_attention`` on the hand-written CUDA flash-attention forward and
    backward kernels (``ops/csrc/flash_attention.cu``);
  * vision training: ``models.resnet`` (ResNet-CIFAR and ResNet-ImageNet)
    through ``conv2d``/``pool2d``/``batch_norm``/``cross_entropy``/
    ``accuracy`` and ``optimizer.Momentum``; with the flag
    ``fuse_conv_bn`` on, each 1x1 convolution feeding a train-mode batch
    norm runs on the hand-written CUDA matmul + column-statistics kernel
    (``ops/csrc/matmul_stats.cu``).

Used as ``import paddle_tpu_torch as fluid``, as scripts use
``paddle_tpu``.
"""

from .core.places import resolve_device  # noqa: F401
from . import ops  # noqa: F401  (registers the lowerings)
from . import layers  # noqa: F401
from . import initializer  # noqa: F401
from . import optimizer  # noqa: F401
from .core import (  # noqa: F401
    CPUPlace, CUDAPlace, Executor, Program, Scope, TPUPlace,
    append_backward, default_main_program, default_startup_program,
    global_scope, load_numpy_state, program_guard, scope_guard,
    unique_name,
)
from .param_attr import ParamAttr  # noqa: F401
