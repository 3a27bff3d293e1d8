"""CoNLL-2005 SRL — reference parity: python/paddle/dataset/conll05.py.

Readers yield (word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, verb_ids,
mark, label_ids) — the label_semantic_roles book-test format.
"""

import numpy as np

from . import common

WORD_VOCAB = 44068
VERB_VOCAB = 3162
LABEL_COUNT = 59


def get_dict():
    word_dict = {("w%d" % i): i for i in range(WORD_VOCAB)}
    verb_dict = {("v%d" % i): i for i in range(VERB_VOCAB)}
    label_dict = {("l%d" % i): i for i in range(LABEL_COUNT)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    rng = common.synthetic_rng("conll05_emb", 0)
    return rng.randn(WORD_VOCAB, 32).astype(np.float32)


def _make_reader(n, seed):
    def reader():
        rng = common.synthetic_rng("conll05", seed)
        for _ in range(n):
            length = int(rng.randint(5, 30))
            words = rng.randint(0, WORD_VOCAB, size=length).tolist()
            ctx = [rng.randint(0, WORD_VOCAB, size=length).tolist()
                   for _ in range(5)]
            verb = [int(rng.randint(0, VERB_VOCAB))] * length
            mark = rng.randint(0, 2, size=length).tolist()
            labels = rng.randint(0, LABEL_COUNT, size=length).tolist()
            yield (words, ctx[0], ctx[1], ctx[2], ctx[3], ctx[4], verb,
                   mark, labels)
    return reader


def test(n=512):
    return _make_reader(n, seed=1)


def train(n=2048):
    return _make_reader(n, seed=0)


def fetch():
    pass
