"""MQ2007 learning-to-rank — reference parity:
python/paddle/dataset/mq2007.py. Supports pointwise/pairwise/listwise
reader formats over 46-dim query-document features."""

import numpy as np

from . import common

FEATURE_DIM = 46


def _gen_query(rng):
    n_docs = int(rng.randint(5, 20))
    feats = rng.randn(n_docs, FEATURE_DIM).astype(np.float32)
    w = common.synthetic_rng("mq2007_w", 0).randn(FEATURE_DIM)
    scores = feats @ w
    rels = np.digitize(scores, np.percentile(scores, [50, 80]))
    return feats, rels.astype(np.int64)


def _make_reader(n, seed, format):
    def pointwise():
        rng = common.synthetic_rng("mq2007", seed)
        for _ in range(n):
            feats, rels = _gen_query(rng)
            for i in range(len(rels)):
                yield feats[i], int(rels[i])

    def pairwise():
        rng = common.synthetic_rng("mq2007", seed)
        for _ in range(n):
            feats, rels = _gen_query(rng)
            for i in range(len(rels)):
                for j in range(len(rels)):
                    if rels[i] > rels[j]:
                        yield np.array([1.0], np.float32), feats[i], feats[j]

    def listwise():
        rng = common.synthetic_rng("mq2007", seed)
        for _ in range(n):
            feats, rels = _gen_query(rng)
            yield feats, rels

    return {"pointwise": pointwise, "pairwise": pairwise,
            "listwise": listwise}[format]


def train(format="pairwise", n=256):
    return _make_reader(n, seed=0, format=format)


def test(format="pairwise", n=64):
    return _make_reader(n, seed=1, format=format)


def fetch():
    pass
