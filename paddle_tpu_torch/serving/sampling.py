"""Per-request sampling: the knobs, the filter and the counter-keyed draw.

The counterpart of ``paddle_tpu/serving/sampling.py``: ``SamplingParams``
(validation, wire dict, ``greedy``), ``step_keys`` and ``sample``, plain
tensor functions the engine's decode step calls on the device.

  * ``temperature == 0`` stays bitwise greedy: the engine computes the
    argmax exactly as its greedy step does and selects the sampled draw
    per slot with ``torch.where``, so temperature-0 slots of a mixed
    batch emit the all-greedy run's tokens.
  * The filter (``filter_logits``) is the JAX package's: temperature
    rows <= 0 are computed at 1 (the caller discards them); top-k keeps
    every score >= the k-th largest, so ties at the boundary are all
    kept; top-p is taken over the top-k-filtered softmax, a token kept
    where the mass before it is < top_p, the top-1 always kept.
  * The random bits are the port's own: Philox4x32-10 (the generator
    cuRAND and PyTorch use; ``core/philox.py``, which dropout shares)
    written with integer tensor ops, keyed on
    the request's ``seed`` with the count of tokens generated so far as
    its counter. It holds no ``torch.Generator`` state, so the same
    (seed, counter) gives the same bits on the CPU and on the card, a
    CUDA graph can hold a draw (there is no generator offset to
    register), a preempted request that restarts draws its stream
    again, and a scoring dispatch draws position j at counter + j as j
    single steps would. jax's threefry never matches it draw for draw:
    the two packages agree in distribution.
  * One uniform per row: the token is drawn by inverse CDF over the
    filtered distribution sorted by descending probability.
"""

import torch

from ..core.philox import MASK32 as _MASK, philox4x32

__all__ = ["SamplingParams", "step_keys", "philox4x32", "uniform",
           "filter_logits", "sample"]


class SamplingParams:
    """Validated per-request sampling knobs, wire-serializable.

    temperature: 0 = greedy (the default). > 0 scales logits.
    top_k:       0 = off; else sample among the k highest logits.
    top_p:       1.0 = off; else nucleus sampling inside top-k.
    seed:        per-request PRNG seed (default 0)."""

    __slots__ = ("temperature", "top_k", "top_p", "seed")

    def __init__(self, temperature=0.0, top_k=0, top_p=1.0, seed=0):
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0, got %r"
                             % (temperature,))
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0, got %r" % (top_k,))
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError("top_p must be in (0, 1], got %r"
                             % (top_p,))
        if not (0 <= self.seed < 2 ** 32):
            raise ValueError("seed must fit uint32, got %r" % (seed,))

    @property
    def greedy(self):
        return self.temperature <= 0.0

    def to_dict(self):
        return {"temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p, "seed": self.seed}

    @classmethod
    def from_dict(cls, d):
        if d is None:
            return cls()
        if isinstance(d, cls):
            return d
        if not isinstance(d, dict):
            raise ValueError(
                "sampling must be a SamplingParams or its dict form, "
                "got %r" % (type(d).__name__,))
        unknown = set(d) - {"temperature", "top_k", "top_p", "seed"}
        if unknown:
            # a misspelled knob must not silently run greedy
            raise ValueError(
                "unknown sampling field(s) %s (known: temperature, "
                "top_k, top_p, seed)" % sorted(unknown))
        return cls(temperature=d.get("temperature", 0.0),
                   top_k=d.get("top_k", 0),
                   top_p=d.get("top_p", 1.0),
                   seed=d.get("seed", 0))

    def __repr__(self):
        return ("SamplingParams(temperature=%g, top_k=%d, top_p=%g, "
                "seed=%d)" % (self.temperature, self.top_k, self.top_p,
                              self.seed))


def step_keys(seeds, counts):
    """Per-slot keys for one decode step: ``seeds`` [S] (uint32 values)
    and ``counts`` [S] (tokens generated so far), packed as int64
    [S, 2]. The draw is a pure function of the pair, so a restart
    (preemption re-prefill) regenerates the same stream."""
    return torch.stack([seeds.long(), counts.long()], dim=-1)


def uniform(keys):
    """One float32 uniform in [0, 1) per key: Philox keyed on (seed, 0)
    at counter (count low word, count high word, 0, 0); the top 24 bits
    of the first output word, exact in float32."""
    seed, count = keys[..., 0] & _MASK, keys[..., 1]
    zero = torch.zeros_like(count)
    x = philox4x32((count & _MASK, (count >> 32) & _MASK, zero, zero),
                   (seed, zero))[0]
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def filter_logits(logits, temperature, top_k, top_p):
    """The filtered log-probabilities ``sample`` draws from: ``logits``
    [S, V] float32, ``temperature`` [S] (rows <= 0 computed at 1),
    ``top_k`` [S] (0 = off), ``top_p`` [S] (1 = off). Removed tokens are
    -inf. The JAX package's ``sample`` filters exactly so."""
    v = logits.shape[-1]
    t = torch.where(temperature > 0.0, temperature, 1.0)
    scaled = logits / t[:, None]
    # top-k: keep scores >= the k-th largest (ties at the boundary all
    # kept)
    srt = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.clamp(torch.where(top_k > 0, top_k, v), 1, v).long()
    kth = srt.gather(1, (k - 1)[:, None])
    masked = torch.where(scaled >= kth, scaled, float("-inf"))
    # top-p over the top-k-filtered distribution: keep the smallest
    # prefix of descending-prob tokens whose mass BEFORE each token is
    # < p (top-1 always kept)
    lp = torch.log_softmax(masked, dim=-1)
    probs = torch.exp(lp)
    ps = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(ps, dim=-1)
    keep = (csum - ps) < top_p[:, None]
    minkeep = torch.where(keep, ps, float("inf")).amin(dim=-1)
    return torch.where(probs >= minkeep[:, None], lp, float("-inf"))


def sample(logits, temperature, top_k, top_p, keys):
    """Draw one token per row: ``logits`` [S, V] float32, the filter's
    knobs as in ``filter_logits``, ``keys`` [S, 2] from ``step_keys``.
    Inverse CDF with one uniform a row: the kept tokens sorted by
    descending probability (ties by vocabulary index), the first whose
    running mass exceeds u times the total. Returns int64 [S]. Rows of
    temperature <= 0 are draws at temperature 1 that the caller
    discards."""
    final = filter_logits(logits, temperature, top_k, top_p)
    p = torch.softmax(final, dim=-1)
    ps, order = torch.sort(p, dim=-1, descending=True, stable=True)
    csum = torch.cumsum(ps, dim=-1)
    target = uniform(keys) * csum[:, -1]
    idx = (csum <= target[:, None]).sum(dim=-1)
    # u * total may round up to the total: stay inside the kept set
    nkeep = torch.isfinite(final).sum(dim=-1)
    idx = torch.minimum(idx, nkeep - 1)
    return order.gather(1, idx[:, None])[:, 0]
