"""WMT14 en-fr — reference parity: python/paddle/dataset/wmt14.py.

Readers yield (src_ids, trg_ids, trg_next_ids) triples for seq2seq training;
<s>=0, <e>=1, <unk>=2 like the reference.
"""

import numpy as np

from . import common

START = 0
END = 1
UNK = 2
DICT_SIZE = 30000


def _make_reader(n, seed, dict_size):
    def reader():
        rng = common.synthetic_rng("wmt14", seed)
        for _ in range(n):
            slen = int(rng.randint(3, 20))
            src = rng.randint(3, dict_size, size=slen).tolist()
            # learnable toy mapping: target token = src token shifted
            trg = [(w + 7) % dict_size for w in src]
            trg = [max(w, 3) for w in trg]
            trg_in = [START] + trg
            trg_next = trg + [END]
            yield src, trg_in, trg_next
    return reader


def train(dict_size=DICT_SIZE, n=2048):
    return _make_reader(n, 0, dict_size)


def test(dict_size=DICT_SIZE, n=256):
    return _make_reader(n, 1, dict_size)


def get_dict(dict_size=DICT_SIZE, reverse=False):
    src = {i: "w%d" % i for i in range(dict_size)}
    if not reverse:
        src = {v: k for k, v in src.items()}
    return src, dict(src)


def fetch():
    pass
