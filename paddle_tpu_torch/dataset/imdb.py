"""IMDB sentiment — reference parity: python/paddle/dataset/imdb.py.

Readers yield (word-id list, label in {0,1}). word_dict() gives the vocab.
Synthetic data embeds class-correlated token distributions so
understand_sentiment-style tests converge.
"""

import numpy as np

from . import common

VOCAB_SIZE = 5148   # reference imdb vocab magnitude


def word_dict():
    return {("w%d" % i).encode(): i for i in range(VOCAB_SIZE)}


def _make_reader(n, seed):
    def reader():
        rng = common.synthetic_rng("imdb", seed)
        half = VOCAB_SIZE // 2
        for _ in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(8, 64))
            base = 0 if label == 0 else half
            words = (base + rng.randint(0, half, size=length)).tolist()
            yield words, label
    return reader


def train(word_idx=None, n=2048):
    return _make_reader(n, seed=0)


def test(word_idx=None, n=512):
    return _make_reader(n, seed=1)


def fetch():
    pass
