"""PTB language-model n-grams — reference parity:
python/paddle/dataset/imikolov.py. Readers yield n-gram tuples of word ids
(word2vec book-test format)."""

import numpy as np

from . import common

VOCAB_SIZE = 2074


class DataType:
    NGRAM = 1
    SEQ = 2


def build_dict(min_word_freq=50):
    return {("w%d" % i).encode(): i for i in range(VOCAB_SIZE)}


def _make_reader(n, ngram_n, seed, data_type=DataType.NGRAM):
    def reader():
        rng = common.synthetic_rng("imikolov", seed)
        # markov-ish chain so n-gram prediction is learnable
        trans = rng.randint(0, VOCAB_SIZE, size=VOCAB_SIZE)
        for _ in range(n):
            if data_type == DataType.NGRAM:
                w = int(rng.randint(0, VOCAB_SIZE))
                gram = [w]
                for _ in range(ngram_n - 1):
                    w = int((trans[w] + rng.randint(0, 3)) % VOCAB_SIZE)
                    gram.append(w)
                yield tuple(gram)
            else:
                length = int(rng.randint(5, 20))
                seq = rng.randint(0, VOCAB_SIZE, size=length).tolist()
                yield seq
    return reader


def train(word_idx=None, n=5, data_type=DataType.NGRAM, samples=4096):
    return _make_reader(samples, n, seed=0, data_type=data_type)


def test(word_idx=None, n=5, data_type=DataType.NGRAM, samples=512):
    return _make_reader(samples, n, seed=1, data_type=data_type)


def fetch():
    pass
