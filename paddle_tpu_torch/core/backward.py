"""Autodiff: append_backward, calc_gradient.

The counterpart of ``paddle_tpu/core/backward.py``, and it emits the same
IR: one ``backward_marker`` op carrying (loss, parameter list, no_grad
set, checkpoint), with a fetchable gradient variable ``P@GRAD`` for every
parameter P; or one ``calc_gradient_marker`` carrying (targets, inputs),
with ``X@GRAD`` for every input X. At run time the port's Executor runs
the forward segment with ``torch.autograd`` and binds each gradient
(core/executor.py, ``_lower_with_grad``).
"""

from .program import Variable


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoint=False):
    """Append the gradient computation for `loss` and return
    [(param, grad_var), ...] like the reference.

    parameter_list: restrict to these parameter names (or Variables).
    no_grad_set: names excluded from differentiation (their grads are zero and
    they are treated as constants — parity with backward.py no_grad handling).
    checkpoint=True runs the whole forward under a checkpoint: it is
    recomputed in the backward instead of stored.
    """
    program = loss.block.program
    block = program.global_block()

    if parameter_list:
        pnames = [p.name if isinstance(p, Variable) else p
                  for p in parameter_list]
        params = [block.var(n) for n in pnames]
    else:
        params = [p for p in block.all_parameters() if p.trainable]

    no_grad = {n if isinstance(n, str) else n.name for n in (no_grad_set or ())}
    params = [p for p in params if p.name not in no_grad
              and not p.stop_gradient]

    param_grads = []
    for p in params:
        g = block.create_var(
            name=p.name + "@GRAD", shape=p.shape, dtype=p.dtype,
            persistable=False, stop_gradient=True)
        param_grads.append((p, g))

    loss_grad = block.create_var(
        name=loss.name + "@GRAD", shape=loss.shape or (1,), dtype=loss.dtype,
        persistable=False, stop_gradient=True)

    block.append_op(
        type="backward_marker",
        inputs={"Loss": [loss]},
        outputs={"Grads": [g for _, g in param_grads] + [loss_grad]},
        attrs={
            "loss_name": loss.name,
            "param_names": [p.name for p, _ in param_grads],
            "no_grad_set": sorted(no_grad),
            "checkpoint": bool(checkpoint),
        })
    program._loss_name = loss.name
    return param_grads


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of `targets` w.r.t. arbitrary `inputs` (backward.py:555).

    Implemented with the same marker mechanism: the Executor computes
    d(sum(targets))/d(inputs) with torch.autograd; returns the grad
    Variables."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    program = targets[0].block.program
    block = program.global_block()
    no_grad = {n if isinstance(n, str) else n.name for n in (no_grad_set or ())}

    grads = []
    for x in inputs:
        g = block.create_var(
            name=x.name + "@GRAD", shape=x.shape, dtype=x.dtype,
            stop_gradient=True)
        grads.append(g)

    block.append_op(
        type="calc_gradient_marker",
        inputs={"Targets": list(targets), "Inputs": list(inputs)},
        outputs={"Grads": grads},
        attrs={
            "target_names": [t.name for t in targets],
            "input_names": [x.name for x in inputs],
            "no_grad_set": sorted(no_grad),
        })
    return grads


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    return calc_gradient(targets, inputs, target_gradients, no_grad_set)
