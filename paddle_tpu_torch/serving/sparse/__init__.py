"""paddle_tpu_torch.serving.sparse — sharded-embedding recsys serving
(ROADMAP direction 3).

The port's copy of ``paddle_tpu/serving/sparse/__init__.py``.

The inference composition over live pservers: the distributed lookup
table (row-sharded embeddings + server-side lazy sparse optimizers,
trained since the seed) finally SERVED —

  * ``cache``   — ``HotIDCache`` (per-process LRU, bounded staleness,
    version/incarnation invalidation) + ``SparseClient`` (batched,
    deduplicated PRFT prefetch against the shards, retry policy +
    membership resolver-following, measured miss-path cost),
  * ``scoring`` — ``ScoringEngine``: the serving Engine's
    iteration-level scheduling generalized to heterogeneous feature
    batches; ONE compiled fixed-shape scoring dispatch per iteration,
    request latency flowing into the existing TTFT-analogue
    histograms / SLO specs / flight recorder / trace spans; the
    fleet Router serves it unchanged (scores ride the decode result
    wire),
  * ``online``  — ``OnlineTrainer`` (sparse grad pushes landing while
    serving reads, exactly-once round tags) + ``measure_staleness``
    (the read-your-writes probe behind the SLO ``staleness_s``
    objective).

See README "Recsys serving" for the topology and the staleness
contract.
"""

from .cache import HotIDCache, SparseClient
from .online import OnlineTrainer, measure_staleness
from .scoring import ScoringEngine, ScoringRequest

__all__ = ["HotIDCache", "SparseClient", "ScoringEngine",
           "ScoringRequest", "OnlineTrainer", "measure_staleness"]
