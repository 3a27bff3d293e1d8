"""paddle_tpu_torch.serving: the continuous-batching decode engine over
the paged KV pool (counterpart of ``paddle_tpu.serving``)."""

from .engine import Engine, Request, sequential_generate
from .kvpool import BlockPool, RadixCache
from .sampling import SamplingParams

__all__ = ["Engine", "Request", "sequential_generate", "SamplingParams",
           "BlockPool", "RadixCache"]
