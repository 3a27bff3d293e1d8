"""Pure-python running averages (reference python/paddle/fluid/average.py);
a copy of ``paddle_tpu/average.py``.

Host-side accumulators over fetched values — they never touch the
Program. Kept for API parity with reference user scripts; new code
should prefer paddle_tpu_torch.metrics.
"""

import numpy as np

__all__ = ["WeightedAverage"]


def _is_number(v):
    return isinstance(v, (int, float)) or (
        isinstance(v, np.ndarray) and v.shape == (1,))


class WeightedAverage:
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not (_is_number(value) or isinstance(value, np.ndarray)):
            raise ValueError("'value' must be a number or numpy ndarray")
        if not _is_number(weight):
            raise ValueError("'weight' must be a number")
        if self.numerator is None:
            self.numerator = value * weight
            self.denominator = weight
        else:
            self.numerator += value * weight
            self.denominator += weight

    def eval(self):
        if self.numerator is None or self.denominator == 0:
            raise ValueError("eval() before any add(); no data to average")
        return self.numerator / self.denominator
