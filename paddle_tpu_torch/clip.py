"""Gradient / error clipping.

The counterpart of ``paddle_tpu/clip.py`` (reference parity:
python/paddle/fluid/clip.py:79-215): ErrorClipByValue,
GradientClipByValue, GradientClipByNorm and GradientClipByGlobalNorm
(group norm clip), appended as the same ops into the gradient stream, and
the machinery ``Optimizer.minimize`` runs (``append_gradient_clip_ops``
over each parameter's ``gradient_clip_attr``, ``set_gradient_clip``).
"""

from .layers import nn as nn_layers
from .layers import tensor as tensor_layers
from .layers.layer_helper import LayerHelper


class BaseErrorClipAttr:
    def append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def append_clip_op(self, block, grad_name):
        block.append_op(type="clip", inputs={"X": [grad_name]},
                        outputs={"Out": [grad_name]},
                        attrs={"min": self.min, "max": self.max})


class BaseGradientClipAttr:
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def _create_operators(self, param, grad):
        return param, nn_layers.clip(grad, self.min, self.max)


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _create_operators(self, param, grad):
        return param, nn_layers.clip_by_norm(grad, self.clip_norm)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
        sq = nn_layers.reduce_sum(_square(grad))
        context[self.group_name].append(sq)
        self.context = context

    def _create_operators(self, param, grad):
        group = self.context[self.group_name]
        if not isinstance(group, dict):
            # first call after processing: compute the shared scale once
            global_norm_sq = tensor_layers.sums(group) if len(group) > 1 \
                else group[0]
            helper = LayerHelper("global_norm_clip")
            global_norm = helper.create_variable_for_type_inference(
                grad.dtype, shape=())
            helper.append_op(type="sqrt", inputs={"X": [global_norm_sq]},
                             outputs={"Out": [global_norm]})
            clip_v = tensor_layers.fill_constant((), grad.dtype,
                                                 self.clip_norm)
            # scale = clip / max(clip, global_norm)
            denom = helper.create_variable_for_type_inference(
                grad.dtype, shape=())
            helper.append_op(type="elementwise_max",
                             inputs={"X": [clip_v], "Y": [global_norm]},
                             outputs={"Out": [denom]})
            scale = helper.create_variable_for_type_inference(
                grad.dtype, shape=())
            helper.append_op(type="elementwise_div",
                             inputs={"X": [clip_v], "Y": [denom]},
                             outputs={"Out": [scale]})
            self.context[self.group_name] = {"scale": scale}
        scale = self.context[self.group_name]["scale"]
        helper = LayerHelper("global_norm_apply")
        out = helper.create_variable_for_type_inference(grad.dtype,
                                                        shape=grad.shape)
        helper.append_op(type="elementwise_mul",
                         inputs={"X": [grad], "Y": [scale]},
                         outputs={"Out": [out]})
        return param, out


def _square(x):
    helper = LayerHelper("square")
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(type="square", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


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
