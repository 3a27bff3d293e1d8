"""Activation ops: relu, sigmoid, sqrt, square, sign (the counterpart of
``paddle_tpu/ops/activations.py`` for the flagship LM's FFN, ``nets.glu``,
the gradient clips and the weight-decay regularizers)."""

import torch

from ..core.registry import register

_SIMPLE = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "sqrt": torch.sqrt,
    "square": torch.square,
    "sign": torch.sign,
}


def _unary(fn):
    def lower(ctx, op):
        ctx.set_out(op, "Out", fn(ctx.in1(op, "X")))
    return lower


for _name, _fn in _SIMPLE.items():
    register(_name, _unary(_fn))
