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
    (``ops/csrc/matmul_stats.cu``);
  * megastep: ``Executor.run_steps`` and ``serving.Engine(megastep=K)``
    run K steps as one CUDA graph on the card (``core/graphs.py``), the
    same step bodies in a loop on the CPU;
  * persistence: ``io`` (vars, checkpoints and the CRC-manifested
    inference artifact, in the JAX package's file formats), and serving
    cold start from an artifact directory (``serving.Engine(<dir>)``);
  * training options: ``layers.recompute`` regions and
    ``append_backward(checkpoint=True)`` (``torch.utils.checkpoint``),
    ``calc_gradient``/``gradients``, label smoothing, dropout on the
    hand-written CUDA dropout kernel (``ops/csrc/dropout.cu``, counter-
    keyed Philox bits that a CUDA graph replays), the whole optimizer
    family with ``ModelAverage``, the gradient clips and the L1/L2
    regularizers;
  * the zoo and decoding: ``nets``, ``models.mlp`` (mlp, cnn and the
    uint8 ``cnn_infer`` pipeline), ``models.vgg``,
    ``models.transformer.transformer`` (the encoder-decoder MT model;
    its decoder's causal self-attention on the flash kernels when
    packed), ``models.TRANSFORM_ZOO``, beam search
    (``ops/beam_search.py``, ``layers.beam_search``/
    ``beam_search_decode``, ``models/decoding.py``) and the decode models'
    whole decodes, ``TransformerInfer.translate``/``translate_greedy``
    and ``TransformerLMInfer.generate``, each one CUDA graph on the card;
  * the data plane: ``dataset`` (seeded synthetic readers), ``reader``
    (the decorators, ``batch``, ``open_files``, ``DeviceLoader``, which
    stages feeds on the card from a worker thread, and its
    ``megabatches(k)`` for ``Executor.run_steps``), ``DataFeeder``,
    ``recordio`` (over a C++ library built with g++ and zlib at first
    use) and the reader layers;
  * the rest of the front end: ``profiler`` (host events and tables, the
    card traced through ``torch.profiler``), ``InferenceTranspiler``,
    ``memory_optimize``/``release_memory``, ``average``, ``debugger``,
    ``concurrency`` and the ``v2`` API (``paddle_tpu_torch.v2``), with the
    Executor's NaN/Inf guards (flag ``check_nan_inf``);
  * the parallel tier: ``distributed.launch`` (one process a rank over
    ``torch.distributed``), ``parallel`` (the mesh, the collectives, ring
    and Ulysses attention on the flash kernels, GPipe and interleaved
    pipelines, MoE) and ``ParallelExecutor`` (the global view over
    DTensors), with ``models.transformer.transformer_lm_parallel``;
  * the wire and its runtime: ``DistributeTranspiler`` and the
    parameter server (``distributed.rpc``, the six wire ops,
    ``membership``, ``master``), ``monitor`` (metrics, the flight
    recorder, the watchdog and the executor hooks), ``trace`` (spans
    across processes, merged into one timeline) and ``resilience``
    (seeded fault plans, the retry policy and ``resilient_loop``);
  * the serving fleet and its monitoring plane: the engine's telemetry,
    ``serving.fleet`` (the exactly-once router over replicas),
    ``serving.autoscale``, ``serving.rollout``, ``serving.sparse`` (the
    CTR scoring engine over the pserver tables), ``monitor.collector``,
    ``signals``, ``watch``, ``forensics``, ``goodput`` and its
    ``python -m`` CLI, ``slo`` and ``perfgate``.

Used as ``import paddle_tpu_torch as fluid``, as scripts use
``paddle_tpu``.
"""

from .core.places import resolve_device  # noqa: F401
from . import ops  # noqa: F401  (registers the lowerings)
from . import distributed  # noqa: F401  (registers the host ops)
from . import layers  # noqa: F401
from . import initializer  # noqa: F401
from . import optimizer  # noqa: F401
from . import regularizer  # noqa: F401
from . import clip  # noqa: F401
from . import io  # noqa: F401
from . import metrics  # noqa: F401
from . import evaluator  # noqa: F401
from . import nets  # noqa: F401
from .core import (  # noqa: F401
    Block, CPUPlace, CUDAPinnedPlace, CUDAPlace, Executor, LoDTensor,
    Operator, Parameter, Program, Scope, TPUPlace, Variable, append_backward,
    calc_gradient, create_lod_tensor, default_main_program,
    default_startup_program, global_scope, gradients, is_compiled_with_cuda,
    is_compiled_with_tpu, load_numpy_state, pack_sequences, program_guard,
    scope_guard, switch_main_program, switch_startup_program, unique_name,
)
from .core import backward  # noqa: F401
from .core.selected_rows import SelectedRows  # noqa: F401
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
from . import flags  # noqa: F401
from .data_feeder import DataFeeder  # noqa: F401
from . import dataset  # noqa: F401
from . import reader  # noqa: F401
from .reader import batch  # noqa: F401
from . import recordio  # noqa: F401
from . import average  # noqa: F401
from . import profiler  # noqa: F401
from . import debugger  # noqa: F401
from . import concurrency  # noqa: F401
from .transpiler import (  # noqa: F401
    InferenceTranspiler, memory_optimize, release_memory,
)
from . import parallel  # noqa: F401  (registers the collective ops)
from .parallel import ParallelExecutor  # noqa: F401
from . import monitor  # noqa: F401
# PADDLE_TPU_MONITOR=1 arms the runtime monitor for the whole process
monitor.maybe_enable_from_flags()
from . import resilience  # noqa: F401
# PADDLE_TPU_FAULTS arms a seeded fault plan for the whole process
resilience.faults.maybe_arm_from_flags()
from . import trace  # noqa: F401
# PADDLE_TPU_TRACE[=rate] arms cross-process tracing (span logs merged
# by `python -m paddle_tpu_torch.trace merge`)
trace.maybe_enable_from_flags()
from . import serving  # noqa: F401
# PADDLE_TPU_TELEMETRY=1 arms the scrape-only fleet-telemetry endpoint
from .monitor import collector as _collector  # noqa: E402
_collector.maybe_arm_from_flags()
from .distributed import DistributeTranspiler  # noqa: F401

# `import paddle_tpu_torch as paddle; paddle.fluid...` and `import
# paddle_tpu_torch.fluid as fluid`: the package itself is the fluid
# namespace, as in the JAX package
import sys as _sys
fluid = _sys.modules[__name__]
_sys.modules[__name__ + ".fluid"] = fluid
