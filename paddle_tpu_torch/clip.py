"""Gradient clipping hooks.

The counterpart of ``paddle_tpu/clip.py``, holding the machinery
``Optimizer.minimize`` runs (``append_gradient_clip_ops`` over each
parameter's ``gradient_clip_attr``, the identity default, and
``set_gradient_clip``). The clips themselves (by value, by norm, by
global norm) build ops whose lowerings are not ported yet (ROADMAP.md,
queue 1 item 3).
"""


class BaseErrorClipAttr:
    def append_clip_op(self, block, grad_name):
        raise NotImplementedError


class BaseGradientClipAttr:
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


def set_gradient_clip(clip, param_list=None, program=None):
    from .core.program import default_main_program
    program = program or default_main_program()
    if param_list is None:
        param_list = program.global_block().all_parameters()
    for p in param_list:
        if isinstance(p, str):
            p = program.global_block().var(p)
        p.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grad):
    context = {}
    clips = []
    for p, g in param_grad:
        clip = getattr(p, "gradient_clip_attr", None) or NullGradientClipAttr()
        clips.append(clip)
        clip._process_context(context, p, g)
    res = []
    for (p, g), clip in zip(param_grad, clips):
        res.append(clip._create_operators(p, g))
    return res


def error_clip_callback(block, context):
    pass
