"""CIFAR-10/100 — reference parity: python/paddle/dataset/cifar.py.

Readers yield (image[3072] float32 in [0,1], label int).
"""

import numpy as np

from . import common

IMAGE_DIM = 3 * 32 * 32


def _make_reader(name, n, num_classes, seed):
    def reader():
        # class centers come from a split-independent RNG so train/test are
        # drawn from the same distribution (models trained on train10 must
        # generalize to test10)
        centers = common.synthetic_rng(name + "_centers", 0).rand(
            num_classes, IMAGE_DIM).astype(np.float32)
        rng = common.synthetic_rng(name, seed)
        labels = rng.randint(0, num_classes, size=n)
        for i in range(n):
            img = centers[labels[i]] * 0.7 + \
                0.3 * rng.rand(IMAGE_DIM).astype(np.float32)
            yield img.astype(np.float32), int(labels[i])
    return reader


def train10(n=4096):
    return _make_reader("cifar10", n, 10, seed=0)


def test10(n=512):
    return _make_reader("cifar10", n, 10, seed=1)


def train100(n=4096):
    return _make_reader("cifar100", n, 100, seed=0)


def test100(n=512):
    return _make_reader("cifar100", n, 100, seed=1)


def fetch():
    pass
