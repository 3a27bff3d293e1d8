"""Self-drafting speculation: the host-side drafting tier.

The counterpart of ``paddle_tpu/serving/spec.py``, copied (that module
imports nothing, and the port imports nothing of the JAX package).

A cheap drafter proposes up to gamma tokens per slot; the full model
scores all gamma + 1 positions in ONE dispatch
(``models/transformer_infer._spec_logits_paged``: the paged kernel at
C = gamma + 1 query rows on the card), and the engine accepts the
longest prefix of drafts that matches what the model would have emitted
anyway. Every dispatch lands 1..gamma+1 verified tokens, and the output
never depends on the drafter being right.

  * ``NgramDrafter`` (the default): prompt/n-gram lookup. The request's
    own token chain (prompt + generated tokens) is searched for an
    earlier occurrence of its current n-token suffix (longest n first);
    the tokens that followed it become the draft. The radix prefix
    cache's published chains (``kvpool.RadixCache.token_chains``) are
    searched too, so a request can draft from text other requests
    committed.
  * The truncated drafter (flag ``serving_spec_drafter=truncated``)
    lives in ``serving/engine.py``: gamma decode steps through the first
    ``serving_spec_layers`` layers of the same weights and paged pool.

The drafter proposes; it never decides. Acceptance runs inside the
scoring step against the model's own (greedy or counter-keyed sampled)
tokens, which keeps temperature-0 output the non-speculative engine's
and seeded sampling replay-identical.
"""

__all__ = ["NgramDrafter"]


class NgramDrafter:
    """Prompt/n-gram lookup drafting over token chains.

    ``max_n``: longest suffix n-gram tried first (flag
    ``serving_spec_ngram``); shorter suffixes are fallbacks down to
    ``min_n`` (flag ``serving_spec_ngram_min``). The default floor of
    2 skips single-token matches: in the JAX package's CPU
    measurements, weak 1-gram evidence proposed mostly-rejected drafts
    whose scoring dispatches cost more than they returned — requiring
    a 2..3-gram match roughly doubled the acceptance rate at a small
    loss of draft opportunity (drafting less is free; drafting wrong
    is not).
    ``window``: how many trailing chain tokens are searched (bounds
    the per-slot host cost on long contexts).
    """

    def __init__(self, max_n=3, min_n=2, window=256):
        self.max_n = max(1, int(max_n))
        self.min_n = max(1, min(int(min_n), self.max_n))
        self.window = max(self.max_n + 1, int(window))

    @staticmethod
    def _continuation(hay, suffix, gamma, self_match):
        """Tokens following the best occurrence of ``suffix`` in
        ``hay``: the RIGHTMOST match with a full γ-token continuation,
        else the match with the longest one (recency is the
        tie-breaker — recent text predicts the immediate future best).
        ``self_match`` excludes the chain's own trailing suffix from
        matching itself (it has no continuation). Returns [] when
        ``suffix`` never occurs with at least one following token."""
        n = len(suffix)
        last = len(hay) - n - 1 if self_match else len(hay) - n
        best = []
        for i in range(last, -1, -1):
            if hay[i:i + n] != suffix:
                continue
            cont = hay[i + n:i + n + gamma]
            if len(cont) >= gamma:
                return cont
            if len(cont) > len(best):
                best = cont
        return best

    def propose(self, chain, gamma, extra_chains=()):
        """Up to ``gamma`` draft tokens continuing ``chain`` (the
        request's committed prompt + generated tokens). The request's
        own chain is searched first (longest n-gram first — the most
        specific evidence), then each published chain in
        ``extra_chains`` order. Returns a (possibly empty) int list;
        an empty draft costs the engine nothing — it falls back to the
        plain dispatch for that iteration."""
        gamma = int(gamma)
        if gamma <= 0 or not chain:
            return []
        hay = [int(t) for t in chain[-self.window:]]
        others = [[int(t) for t in o] for o in extra_chains]
        best = []
        for n in range(min(self.max_n, len(hay) - 1), self.min_n - 1,
                       -1):
            # a FULL-length continuation returns immediately at the
            # strongest n that offers one; a partial match never
            # blocks the ladder — a weaker suffix lower down may
            # still complete the full draft (period-2 cycles do
            # exactly this), and a full draft amortizes the scoring
            # dispatch best
            suffix = hay[-n:]
            cont = self._continuation(hay, suffix, gamma,
                                      self_match=True)
            if len(cont) >= gamma:
                return [int(t) for t in cont]
            if len(cont) > len(best):
                best = cont
            for other in others:
                oc = self._continuation(other, suffix, gamma,
                                        self_match=False)
                if len(oc) >= gamma:
                    return [int(t) for t in oc]
                if len(oc) > len(best):
                    best = oc
        return [int(t) for t in best]
