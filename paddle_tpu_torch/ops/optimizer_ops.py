"""Optimizer ops: sgd, momentum, adam (dense gradients).

The counterpart of ``paddle_tpu/ops/optimizer_ops.py:40-130``. Each op
writes the updated value back into the env under the *input* var's name
as well as its output slot, so the Executor commits it to the scope.
Updates are functional — new tensors, as in the JAX package — never in
place: the old values may still be held by the step's autograd leaves.
SelectedRows (sparse) gradients are not ported yet.
"""

import torch

from ..core.registry import register


def _upd(ctx, op, slot_in, slot_out, value):
    names = op.input(slot_in)
    if names:
        ctx.env[names[0]] = value
    out = op.output(slot_out)
    if out:
        ctx.env[out[0]] = value


@register("sgd")
def _sgd(ctx, op):
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad")
    lr = ctx.in1(op, "LearningRate")
    _upd(ctx, op, "Param", "ParamOut", p - lr * g)


@register("momentum")
def _momentum(ctx, op):
    """v = mu v + g; p -= lr v, or with ``use_nesterov``
    p -= (g + mu v) lr."""
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad")
    v = ctx.in1(op, "Velocity")
    lr = ctx.in1(op, "LearningRate")
    mu = op.attr("mu", 0.9)
    v_new = mu * v + g
    if op.attr("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    _upd(ctx, op, "Velocity", "VelocityOut", v_new)
    _upd(ctx, op, "Param", "ParamOut", p_new)


@register("adam")
def _adam(ctx, op):
    """m1 = b1 m1 + (1-b1) g; m2 = b2 m2 + (1-b2) g^2;
    lr_t = lr sqrt(1 - b2^t) / (1 - b1^t); p -= lr_t m1 / (sqrt(m2) + eps).
    LearningRate, Beta1Pow and Beta2Pow are [1] tensors that broadcast;
    the beta powers advance only on ops with ``update_beta_pow``."""
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad")
    m1 = ctx.in1(op, "Moment1")
    m2 = ctx.in1(op, "Moment2")
    lr = ctx.in1(op, "LearningRate")
    b1p = ctx.in1(op, "Beta1Pow")
    b2p = ctx.in1(op, "Beta2Pow")
    b1 = op.attr("beta1", 0.9)
    b2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * g * g
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p_new = p - lr_t * m1n / (torch.sqrt(m2n) + eps)
    _upd(ctx, op, "Moment1", "Moment1Out", m1n)
    _upd(ctx, op, "Moment2", "Moment2Out", m2n)
    _upd(ctx, op, "Param", "ParamOut", p_new)
    if op.attr("update_beta_pow", False):
        _upd(ctx, op, "Beta1Pow", "Beta1PowOut", b1p * b1)
        _upd(ctx, op, "Beta2Pow", "Beta2PowOut", b2p * b2)
