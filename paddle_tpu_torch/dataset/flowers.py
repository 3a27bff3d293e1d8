"""Oxford 102 flowers — reference parity: python/paddle/dataset/flowers.py.

Readers yield (image[3,224,224] float32, label int in [0,102)).
"""

import numpy as np

from . import common

NUM_CLASSES = 102
IMAGE_SHAPE = (3, 224, 224)


def _make_reader(name, n, seed, shape=IMAGE_SHAPE):
    def reader():
        rng = common.synthetic_rng(name, seed)
        base = common.synthetic_rng(name + "_centers", 0).rand(
            NUM_CLASSES, 8).astype(np.float32)
        for _ in range(n):
            label = int(rng.randint(0, NUM_CLASSES))
            img = np.tile(base[label].reshape(1, 8, 1),
                          (shape[0], shape[1] // 8 + 1, shape[2]))
            img = img[:, :shape[1], :] + \
                0.1 * rng.rand(*shape).astype(np.float32)
            yield img.astype(np.float32), label
    return reader


def train(n=1024, mapper=None, buffered_size=1024, use_xmap=False):
    return _make_reader("flowers", n, seed=0)


def test(n=256, mapper=None, buffered_size=1024, use_xmap=False):
    return _make_reader("flowers", n, seed=1)


def valid(n=256, mapper=None, buffered_size=1024, use_xmap=False):
    return _make_reader("flowers", n, seed=2)


def fetch():
    pass
