"""UCI housing — reference parity: python/paddle/dataset/uci_housing.py.

Readers yield (features[13] float32, price float32). The synthetic data is a
fixed linear model + noise so fit_a_line-style book tests converge.
"""

import numpy as np

from . import common

feature_names = ["CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS",
                 "RAD", "TAX", "PTRATIO", "B", "LSTAT"]
FEATURE_DIM = 13


def _make_reader(n, seed):
    def reader():
        rng = common.synthetic_rng("uci_housing", seed)
        w = common.synthetic_rng("uci_housing_w", 0).randn(FEATURE_DIM)
        for _ in range(n):
            x = rng.randn(FEATURE_DIM).astype(np.float32)
            y = float(x @ w + 0.1 * rng.randn())
            yield x, np.array([y], np.float32)
    return reader


def train(n=404):
    return _make_reader(n, seed=0)


def test(n=102):
    return _make_reader(n, seed=1)


def fetch():
    pass
