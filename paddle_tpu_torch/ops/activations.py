"""Activation ops: the 36 unary activations of operators/activation_op.cc
and ``prelu``.

The counterpart of ``paddle_tpu/ops/activations.py``, term for term: each
is one PyTorch expression of the JAX package's formula, with its
attributes and defaults (``gelu`` is exact unless ``approximate``;
``leaky_relu`` passes x where x >= 0, as ``jax.nn.leaky_relu``;
``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus``).
"""

import torch
import torch.nn.functional as F

from ..core.registry import register


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


_SIMPLE = {
    "sigmoid": lambda x, op: torch.sigmoid(x),
    "logsigmoid": lambda x, op: -_softplus(-x),
    "exp": lambda x, op: torch.exp(x),
    "relu": lambda x, op: torch.relu(x),
    "tanh": lambda x, op: torch.tanh(x),
    "tanh_shrink": lambda x, op: x - torch.tanh(x),
    "sqrt": lambda x, op: torch.sqrt(x),
    "rsqrt": lambda x, op: torch.rsqrt(x),
    "abs": lambda x, op: torch.abs(x),
    "ceil": lambda x, op: torch.ceil(x),
    "floor": lambda x, op: torch.floor(x),
    "cos": lambda x, op: torch.cos(x),
    "sin": lambda x, op: torch.sin(x),
    "round": lambda x, op: torch.round(x),      # half to even, as jnp
    "reciprocal": lambda x, op: 1.0 / x,
    "log": lambda x, op: torch.log(x),
    "square": lambda x, op: torch.square(x),
    "softplus": lambda x, op: _softplus(x),
    "softsign": lambda x, op: x / (1 + torch.abs(x)),
    "sign": lambda x, op: torch.sign(x),
    "gelu": lambda x, op: F.gelu(
        x, approximate="tanh" if op.attr("approximate", False) else "none"),
    "erf": lambda x, op: torch.erf(x),
    "silu": lambda x, op: x * torch.sigmoid(x),
    "brelu": lambda x, op: torch.clamp(
        x, op.attr("t_min", 0.0), op.attr("t_max", 24.0)),
    "leaky_relu": lambda x, op: torch.where(
        x >= 0, x, op.attr("alpha", 0.02) * x),
    "soft_relu": lambda x, op: torch.log1p(
        torch.exp(torch.clamp(x, -op.attr("threshold", 40.0),
                              op.attr("threshold", 40.0)))),
    "elu": lambda x, op: F.elu(x, op.attr("alpha", 1.0)),
    "relu6": lambda x, op: torch.clamp(x, 0.0, op.attr("threshold", 6.0)),
    "pow": lambda x, op: torch.pow(x, op.attr("factor", 1.0)),
    "stanh": lambda x, op: op.attr("scale_b", 1.7159)
        * torch.tanh(op.attr("scale_a", 2.0 / 3.0) * x),
    "hard_shrink": lambda x, op: torch.where(
        torch.abs(x) > op.attr("threshold", 0.5), x, torch.zeros_like(x)),
    "softshrink": lambda x, op: torch.sign(x) * torch.relu(
        torch.abs(x) - op.attr("lambda", 0.5)),
    "thresholded_relu": lambda x, op: torch.where(
        x > op.attr("threshold", 1.0), x, torch.zeros_like(x)),
    "hard_sigmoid": lambda x, op: torch.clamp(
        op.attr("slope", 0.2) * x + op.attr("offset", 0.5), 0.0, 1.0),
    "swish": lambda x, op: x * torch.sigmoid(op.attr("beta", 1.0) * x),
    "mish": lambda x, op: x * torch.tanh(_softplus(x)),
}


def _unary(fn):
    def lower(ctx, op):
        ctx.set_out(op, "Out", fn(ctx.in1(op, "X"), op))
    return lower


for _name, _fn in _SIMPLE.items():
    register(_name, _unary(_fn))


@register("prelu")
def _prelu(ctx, op):
    """x where x > 0, else alpha x; a [C] alpha of ``mode="channel"``
    broadcasts over an NCHW x's channels."""
    x = ctx.in1(op, "X")
    alpha = ctx.in1(op, "Alpha")
    if op.attr("mode", "all") == "channel" and alpha.dim() == 1 \
            and x.dim() == 4:
        alpha = alpha.reshape(1, -1, 1, 1)
    ctx.set_out(op, "Out", torch.where(x > 0, x, alpha * x))
