"""SPMD parallel execution over a mesh of ranks.

The counterpart of ``paddle_tpu/parallel/``. The JAX package is one
controller: a jitted step over a ``jax.sharding.Mesh``, GSPMD deriving
every collective. The port is one process a rank over
``torch.distributed`` (``distributed/launch.py``), each rank running the
same user script on the same global feed:

  * ``ParallelExecutor`` keeps the global view with DTensors: state laid
    out by its ``shard`` hints, batch feeds sharded on ``dp``, every
    fetch the global value on every rank, the sharding propagation
    inserting the reductions (``executor.py``);
  * the shard_map counterparts (``ring.py``, ``pipeline.py``, ``moe.py``)
    run on each rank's blocks (``_shard_map.py``) and call the port's
    differentiable collectives (``collective.py``).
"""

from .mesh import (  # noqa: F401
    make_mesh, default_mesh, set_default_mesh, shard, sharding_hint,
    DistributedStrategy, Mesh, PartitionSpec,
)
from .executor import ParallelExecutor  # noqa: F401
from . import collective  # noqa: F401
from .ring import ring_attention, ulysses_attention  # noqa: F401
from .pipeline import gpipe, gpipe_interleaved  # noqa: F401
from .moe import moe_ffn, top1_gating, topk_gating  # noqa: F401
