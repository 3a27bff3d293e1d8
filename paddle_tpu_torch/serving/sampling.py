"""Per-request sampling parameters.

The counterpart of ``paddle_tpu/serving/sampling.py``, restricted to
``SamplingParams``: its validation, its wire dict and the ``greedy``
property. The port's engine serves greedy requests only; sampled
decoding with the port's own RNG is a ROADMAP.md item (queue 1,
serving slice).
"""

__all__ = ["SamplingParams"]


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
