"""LR decay schedules built as graph ops over a step counter.

The counterpart of ``paddle_tpu/layers/learning_rate_scheduler.py`` (a
copy): noam, exponential, natural_exp, inverse_time, polynomial and
piecewise decay.
Each returns a Variable usable as ``Optimizer(learning_rate=...)``; the step
counter is a persistable var incremented once per executed step, so the
schedule advances with training exactly like the reference's
``_decay_step_counter``.
"""

import math

from .layer_helper import LayerHelper
from .tensor import cast, fill_constant
from ..core import unique_name
from ..initializer import ConstantInitializer

__all__ = ["exponential_decay", "natural_exp_decay", "inverse_time_decay",
           "polynomial_decay", "piecewise_decay", "noam_decay"]


def _decay_step_counter(begin=0):
    helper = LayerHelper("global_step_counter")
    counter = helper.create_global_variable(
        name=unique_name.generate("@LR_DECAY_COUNTER@"), shape=[1],
        dtype="float32", persistable=True)
    helper.set_variable_initializer(
        counter, ConstantInitializer(float(begin - 1)))
    helper.append_op(type="increment", inputs={"X": [counter]},
                     outputs={"Out": [counter]}, attrs={"step": 1.0})
    counter.stop_gradient = True
    return counter


def _unary(x, op_type, **attrs):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def noam_decay(d_model, warmup_steps):
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)
    (Transformer schedule)."""
    from .ops import elementwise_min
    step = _decay_step_counter(begin=1)
    a = step ** -0.5
    b = (warmup_steps ** -1.5) * step
    return (d_model ** -0.5) * elementwise_min(a, b)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _decay_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = _unary(div, "floor")
    return learning_rate * (float(decay_rate) ** div)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    step = _decay_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = _unary(div, "floor")
    return learning_rate * _unary(-1.0 * float(decay_rate) * div, "exp")


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    step = _decay_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = _unary(div, "floor")
    return learning_rate / (1.0 + float(decay_rate) * div)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    from .ops import elementwise_max
    step = _decay_step_counter()
    if cycle:
        ratio = _unary(step / float(decay_steps), "ceil")
        # when step == 0, divisor must be 1 not 0
        one = fill_constant([1], "float32", 1.0)
        ratio = elementwise_max(ratio, one)
        decay_var = float(decay_steps) * ratio
        frac = step / decay_var
    else:
        # clip step to decay_steps
        cap = fill_constant([1], "float32", float(decay_steps))
        from .ops import elementwise_min
        step = elementwise_min(step, cap)
        frac = step / float(decay_steps)
    return (float(learning_rate) - float(end_learning_rate)) * \
        ((1.0 - frac) ** power) + float(end_learning_rate)


def piecewise_decay(boundaries, values):
    """Piecewise-constant schedule: lr = values[i] on
    [boundaries[i-1], boundaries[i])."""
    if len(values) != len(boundaries) + 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    step = _decay_step_counter()
    # the sum of indicator-weighted segment values (the reference used a
    # Switch control-flow block)
    lr = None
    for i, v in enumerate(values):
        if i == 0:
            ind = cast(step < float(boundaries[0]), "float32")
        elif i == len(values) - 1:
            ind = cast(step >= float(boundaries[-1]), "float32")
        else:
            ind = cast(step >= float(boundaries[i - 1]), "float32") * \
                  cast(step < float(boundaries[i]), "float32")
        term = ind * float(v)
        lr = term if lr is None else lr + term
    return lr
