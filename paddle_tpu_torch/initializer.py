"""Parameter initializers.

The counterpart of ``paddle_tpu/initializer.py`` (Constant, Uniform,
Normal, Xavier, MSRA, Bilinear, NumpyArray). Each appends an init op to
the *startup program*; running the startup program materializes the
parameters into the Scope. The port draws from torch generators, so its
values differ from the JAX package's draw for draw; they agree in
distribution. ``TruncatedNormal`` waits for its lowering (ROADMAP.md).
"""

import math

import numpy as np

from .core.program import Variable


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            type="fill_constant", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            type="uniform_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": float(self.low), "max": float(self.high),
                   "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            type="gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": float(self.loc), "std": float(self.scale),
                   "seed": self.seed})



def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = (
            uniform, fan_in, fan_out, seed)

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / fi)
            NormalInitializer(0.0, std, self.seed)(var, block)


class BilinearInitializer(Initializer):
    """For upsampling conv_transpose weights (initializer.py Bilinear)."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("bilinear init needs a 4-D weight")
        c, _, h, w = shape
        f = math.ceil(w / 2.0)
        cc = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype=np.float32)
        for i in range(int(np.prod(shape))):
            x = i % w
            y = (i // w) % h
            weight.flat[i] = (1 - abs(x / f - cc)) * (1 - abs(y / f - cc))
        block.append_op(
            type="assign_value", outputs={"Out": var},
            attrs={"shape": list(shape), "dtype": var.dtype,
                   "values": weight})


class NumpyArrayInitializer(Initializer):
    """Initialize a var to an exact numpy array (fluid NumpyArrayInitializer
    parity); used e.g. for sinusoid position-encoding tables."""

    def __init__(self, value):
        self._value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op(
            type="assign_value", outputs={"Out": var},
            attrs={"shape": list(self._value.shape), "dtype": var.dtype,
                   "values": self._value.astype(np.float32)})


# Aliases matching fluid.initializer public names
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer

