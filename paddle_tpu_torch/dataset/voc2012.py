"""Pascal VOC2012 segmentation — reference parity:
python/paddle/dataset/voc2012.py. Readers yield (image[3,H,W], seg-label[H,W])."""

import numpy as np

from . import common

NUM_CLASSES = 21
IMAGE_SHAPE = (3, 64, 64)


def _make_reader(n, seed):
    def reader():
        rng = common.synthetic_rng("voc2012", seed)
        c, h, w = IMAGE_SHAPE
        for _ in range(n):
            img = rng.rand(c, h, w).astype(np.float32)
            label = np.zeros((h, w), np.int32)
            # a rectangle of one class on background
            cls = int(rng.randint(1, NUM_CLASSES))
            y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
            label[y0:y0 + h // 2, x0:x0 + w // 2] = cls
            img[:, y0:y0 + h // 2, x0:x0 + w // 2] += cls / NUM_CLASSES
            yield img, label
    return reader


def train(n=512):
    return _make_reader(n, seed=0)


def test(n=128):
    return _make_reader(n, seed=1)


def val(n=128):
    return _make_reader(n, seed=2)


def fetch():
    pass
