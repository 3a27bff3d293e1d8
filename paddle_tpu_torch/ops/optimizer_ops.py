"""Optimizer ops (dense gradients): sgd, momentum, adagrad, adam, adamax,
decayed_adagrad, adadelta, rmsprop, ftrl, proximal_gd, proximal_adagrad
and ModelAverage's average_accumulates.

The counterpart of ``paddle_tpu/ops/optimizer_ops.py``, term for term. Each op
writes the updated value back into the env under the *input* var's name
as well as its output slot, so the Executor commits it to the scope.
Updates are functional — new tensors, as in the JAX package — never in
place: the old values may still be held by the step's autograd leaves.

A SelectedRows gradient takes the sparse branches of ``sgd`` and ``adam``
(sgd_op.cc and adam_op's lazy SelectedRows branch): only the rows it
holds change in the param and the moments; the others keep their bits.
``index_put`` adds (with accumulation: ``.at[rows].add``) or sets
(``.at[rows].set``) those rows in a new tensor. A gradient whose rows
repeat is summed row by row in ``sgd``; in lazy ``adam`` the moments of
a repeated row are set once per occurrence, in an order neither package
fixes, so such a gradient goes through ``merge_selected_rows`` first.
"""

import torch

from ..core.registry import register
from ..core.selected_rows import SelectedRows


def _upd(ctx, op, slot_in, slot_out, value):
    names = op.input(slot_in)
    if names:
        ctx.env[names[0]] = value
    out = op.output(slot_out)
    if out:
        ctx.env[out[0]] = value


def _sparse(g, p):
    """(rows as int64, values shaped [n, *p.shape[1:]]) of a SelectedRows
    gradient, else None."""
    if not isinstance(g, SelectedRows):
        return None
    rows = g.rows.to(p.device).reshape(-1)
    return rows, g.value.reshape((rows.shape[0],) + tuple(p.shape[1:]))


@register("sgd")
def _sgd(ctx, op):
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad")
    lr = ctx.in1(op, "LearningRate")
    sp = _sparse(g, p)
    if sp is not None:
        rows, vals = sp
        _upd(ctx, op, "Param", "ParamOut",
             p.index_put((rows,), -lr * vals, accumulate=True))
        return
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
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    sp = _sparse(g, p)
    if sp is not None:
        # lazy Adam: the moments and the param of the touched rows only
        rows, gv = sp
        m1r = b1 * m1[rows] + (1 - b1) * gv
        m2r = b2 * m2[rows] + (1 - b2) * gv * gv
        p_new = p.index_put((rows,), -lr_t * m1r / (torch.sqrt(m2r) + eps),
                            accumulate=True)
        m1n = m1.index_put((rows,), m1r)
        m2n = m2.index_put((rows,), m2r)
    else:
        m1n = b1 * m1 + (1 - b1) * g
        m2n = b2 * m2 + (1 - b2) * g * g
        p_new = p - lr_t * m1n / (torch.sqrt(m2n) + eps)
    _upd(ctx, op, "Moment1", "Moment1Out", m1n)
    _upd(ctx, op, "Moment2", "Moment2Out", m2n)
    _upd(ctx, op, "Param", "ParamOut", p_new)
    if op.attr("update_beta_pow", False):
        _upd(ctx, op, "Beta1Pow", "Beta1PowOut", b1p * b1)
        _upd(ctx, op, "Beta2Pow", "Beta2PowOut", b2p * b2)


@register("adagrad")
def _adagrad(ctx, op):
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad")
    m = ctx.in1(op, "Moment")
    lr = ctx.in1(op, "LearningRate")
    eps = op.attr("epsilon", 1e-6)
    m_new = m + g * g
    p_new = p - lr * g / (torch.sqrt(m_new) + eps)
    _upd(ctx, op, "Moment", "MomentOut", m_new)
    _upd(ctx, op, "Param", "ParamOut", p_new)


@register("adamax")
def _adamax(ctx, op):
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad")
    m = ctx.in1(op, "Moment")
    inf_norm = ctx.in1(op, "InfNorm")
    lr = ctx.in1(op, "LearningRate")
    b1p = ctx.in1(op, "Beta1Pow")
    b1 = op.attr("beta1", 0.9)
    b2 = op.attr("beta2", 0.999)
    eps = op.attr("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(b2 * inf_norm, torch.abs(g) + eps)
    p_new = p - (lr / (1 - b1p)) * m_new / inf_new
    _upd(ctx, op, "Moment", "MomentOut", m_new)
    _upd(ctx, op, "InfNorm", "InfNormOut", inf_new)
    _upd(ctx, op, "Param", "ParamOut", p_new)
    if op.attr("update_beta_pow", False):
        _upd(ctx, op, "Beta1Pow", "Beta1PowOut", b1p * b1)


@register("decayed_adagrad")
def _decayed_adagrad(ctx, op):
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad")
    m = ctx.in1(op, "Moment")
    lr = ctx.in1(op, "LearningRate")
    decay = op.attr("decay", 0.95)
    eps = op.attr("epsilon", 1e-6)
    m_new = decay * m + (1 - decay) * g * g
    p_new = p - lr * g / (torch.sqrt(m_new) + eps)
    _upd(ctx, op, "Moment", "MomentOut", m_new)
    _upd(ctx, op, "Param", "ParamOut", p_new)


@register("adadelta")
def _adadelta(ctx, op):
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad")
    avg_sq_grad = ctx.in1(op, "AvgSquaredGrad")
    avg_sq_upd = ctx.in1(op, "AvgSquaredUpdate")
    rho = op.attr("rho", 0.95)
    eps = op.attr("epsilon", 1e-6)
    asg = rho * avg_sq_grad + (1 - rho) * g * g
    upd = -torch.sqrt((avg_sq_upd + eps) / (asg + eps)) * g
    asu = rho * avg_sq_upd + (1 - rho) * upd * upd
    _upd(ctx, op, "AvgSquaredGrad", "AvgSquaredGradOut", asg)
    _upd(ctx, op, "AvgSquaredUpdate", "AvgSquaredUpdateOut", asu)
    _upd(ctx, op, "Param", "ParamOut", p + upd)


@register("rmsprop")
def _rmsprop(ctx, op):
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad")
    ms = ctx.in1(op, "MeanSquare")
    mom = ctx.in1(op, "Moment")
    lr = ctx.in1(op, "LearningRate")
    rho = op.attr("decay", 0.9)
    eps = op.attr("epsilon", 1e-10)
    momentum = op.attr("momentum", 0.0)
    ms_new = rho * ms + (1 - rho) * g * g
    mom_new = momentum * mom + lr * g / torch.sqrt(ms_new + eps)
    _upd(ctx, op, "MeanSquare", "MeanSquareOut", ms_new)
    _upd(ctx, op, "Moment", "MomentOut", mom_new)
    _upd(ctx, op, "Param", "ParamOut", p - mom_new)


@register("ftrl")
def _ftrl(ctx, op):
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad")
    sq = ctx.in1(op, "SquaredAccumulator")
    lin = ctx.in1(op, "LinearAccumulator")
    lr = ctx.in1(op, "LearningRate")
    l1 = op.attr("l1", 0.0)
    l2 = op.attr("l2", 0.0)
    power = op.attr("lr_power", -0.5)
    sq_new = sq + g * g
    sigma = (torch.pow(sq_new, -power) - torch.pow(sq, -power)) / lr
    lin_new = lin + g - sigma * p
    x = l1 * torch.sign(lin_new) - lin_new
    y = torch.pow(sq_new, -power) / lr + 2 * l2
    p_new = torch.where(torch.abs(lin_new) > l1, x / y,
                        torch.zeros_like(p))
    _upd(ctx, op, "SquaredAccumulator", "SquaredAccumOut", sq_new)
    _upd(ctx, op, "LinearAccumulator", "LinearAccumOut", lin_new)
    _upd(ctx, op, "Param", "ParamOut", p_new)


@register("proximal_gd")
def _proximal_gd(ctx, op):
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad")
    lr = ctx.in1(op, "LearningRate")
    l1 = op.attr("l1", 0.0)
    l2 = op.attr("l2", 0.0)
    prox = p - lr * g
    p_new = torch.sign(prox) * torch.clamp_min(
        torch.abs(prox) - lr * l1, 0.0) / (1.0 + lr * l2)
    _upd(ctx, op, "Param", "ParamOut", p_new)


@register("proximal_adagrad")
def _proximal_adagrad(ctx, op):
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad")
    m = ctx.in1(op, "Moment")
    lr = ctx.in1(op, "LearningRate")
    l1 = op.attr("l1", 0.0)
    l2 = op.attr("l2", 0.0)
    m_new = m + g * g
    lr_t = lr / torch.sqrt(m_new)
    prox = p - lr_t * g
    p_new = torch.sign(prox) * torch.clamp_min(
        torch.abs(prox) - lr_t * l1, 0.0) / (1.0 + lr_t * l2)
    _upd(ctx, op, "Moment", "MomentOut", m_new)
    _upd(ctx, op, "Param", "ParamOut", p_new)


@register("average_accumulates")
def _average_accumulates(ctx, op):
    """ModelAverage's windowed sums of parameter values
    (operators/average_accumulates_op.h, as the JAX package lowers it):
    the param is added into sum_1 each step; when the window is reached
    sum_1 + sum_2 fold into sum_3 and both restart, and ``apply``
    divides (sum_1 + sum_2 + sum_3) by the accumulation counts."""
    p = ctx.in1(op, "param")
    sum1 = ctx.in1(op, "in_sum_1")
    sum2 = ctx.in1(op, "in_sum_2")
    sum3 = ctx.in1(op, "in_sum_3")
    num_acc = ctx.in1(op, "in_num_accumulates")
    old_num = ctx.in1(op, "in_old_num_accumulates")
    num_upd = ctx.in1(op, "in_num_updates")
    avg_window = op.attr("average_window", 0.0)
    max_avg_win = op.attr("max_average_window", 10000)
    min_avg_win = op.attr("min_average_window", 10000)

    num_upd_n = num_upd + 1
    num_acc_n = num_acc + 1
    sum1_acc = sum1 + p
    window = torch.clamp(
        torch.clamp_min(avg_window * num_upd_n.to(torch.float32),
                        float(min_avg_win)),
        max=float(max_avg_win))
    roll = num_acc_n.to(torch.float32) >= window
    sum1_n = torch.where(roll, torch.zeros_like(sum1), sum1_acc)
    sum2_n = torch.where(roll, torch.zeros_like(sum2), sum2)
    sum3_n = torch.where(roll, sum1_acc + sum2, sum3)
    old_num_n = torch.where(roll, num_acc_n, old_num)
    num_acc_n = torch.where(roll, torch.zeros_like(num_acc_n), num_acc_n)

    _upd(ctx, op, "in_sum_1", "out_sum_1", sum1_n)
    _upd(ctx, op, "in_sum_2", "out_sum_2", sum2_n)
    _upd(ctx, op, "in_sum_3", "out_sum_3", sum3_n)
    _upd(ctx, op, "in_num_accumulates", "out_num_accumulates", num_acc_n)
    _upd(ctx, op, "in_old_num_accumulates", "out_old_num_accumulates",
         old_num_n)
    _upd(ctx, op, "in_num_updates", "out_num_updates", num_upd_n)
