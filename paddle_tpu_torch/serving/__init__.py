"""paddle_tpu_torch.serving: the continuous-batching decode engine over
the paged KV pool or the dense layout, and its cold start from a saved
artifact (counterpart of ``paddle_tpu.serving``)."""

from .artifact import (ArtifactError, engine_from_artifact,
                       model_from_artifact, save_lm_artifact)
from .engine import Engine, Request, sequential_generate
from .kvpool import BlockPool, RadixCache
from .sampling import SamplingParams

__all__ = ["Engine", "Request", "sequential_generate", "SamplingParams",
           "BlockPool", "RadixCache", "ArtifactError",
           "engine_from_artifact", "model_from_artifact",
           "save_lm_artifact"]
