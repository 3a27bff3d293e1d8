"""Layer DSL for the parallel ops.

The counterpart of ``paddle_tpu/layers/parallel_layers.py``, holding
``sequence_parallel_attention``: the ``sp_attention`` op, whose local
lowering is the flash-attention kernel. ``sparse_moe`` and
``pipelined_decoder_stack`` come with the parallel tier (ROADMAP.md,
queue 1 item 9).
"""

from .layer_helper import LayerHelper

__all__ = ["sequence_parallel_attention"]


def sequence_parallel_attention(q, k, v, causal=False, variant="ring",
                                scale=0.0, name=None):
    """q/k/v: [B, H, T, dk] variables. Returns [B, H, T, dk]."""
    helper = LayerHelper("sp_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype, shape=q.shape)
    helper.append_op(
        type="sp_attention", inputs={"Q": [q], "K": [k], "V": [v]},
        outputs={"Out": [out]},
        attrs={"causal": causal, "variant": variant, "scale": scale})
    return out
