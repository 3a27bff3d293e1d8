"""paddle_tpu_torch.serving: the continuous-batching decode engine over
the paged KV pool or the dense layout, its cold start from a saved
artifact, and the fleet around it (counterpart of
``paddle_tpu.serving``): ``fleet`` (the exactly-once ``Router`` over
``Replica`` engines, the lease registry and the ``Supervisor``),
``autoscale`` (replicas booted from an artifact, drained and rolled),
``rollout`` (canary analysis under SLO verdicts) and ``sparse`` (the
CTR scoring engine over the pserver tables)."""

from .artifact import (ArtifactError, engine_from_artifact,
                       model_from_artifact, save_lm_artifact)
from .engine import Engine, Request, sequential_generate
from .fleet import (Overloaded, Replica, ReplicaClient,  # noqa: F401
                    ReplicaDraining, ReplicaServer, Router, Supervisor)
from .autoscale import Autoscaler  # noqa: F401
from .rollout import RolloutController  # noqa: F401
from .kvpool import BlockPool, RadixCache, bytes_per_block
from .sampling import SamplingParams
from .spec import NgramDrafter

__all__ = ["Engine", "Request", "sequential_generate", "Router",
           "Replica", "ReplicaServer", "ReplicaClient", "Supervisor",
           "Overloaded", "ReplicaDraining", "Autoscaler",
           "RolloutController", "SamplingParams", "NgramDrafter",
           "BlockPool", "RadixCache", "bytes_per_block", "ArtifactError",
           "engine_from_artifact", "model_from_artifact",
           "save_lm_artifact"]
