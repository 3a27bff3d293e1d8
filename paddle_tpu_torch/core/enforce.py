"""Enforce-style error layer.

The counterpart of ``paddle_tpu/core/enforce.py``: when an op's lowering
raises, the raw PyTorch error has no program context, so the Executor
wraps it in :class:`EnforceError` listing the op type, each input/output
slot with the value's shape and dtype, and the op's attributes.
"""

import numpy as np


class EnforceError(RuntimeError):
    """A framework error with program context (PADDLE_ENFORCE analog)."""


def _dtype_name(dtype):
    text = str(dtype)
    if text.startswith("torch."):
        return text[len("torch."):]
    return np.dtype(dtype).name


def _describe_value(v):
    if v is None:
        return "<not materialized>"
    if isinstance(v, (list, tuple)):
        return "list[%d]" % len(v)
    shape = getattr(v, "shape", None)
    dtype = getattr(v, "dtype", None)
    if shape is None:
        return repr(type(v).__name__)
    return "%s%s" % (_dtype_name(dtype) if dtype is not None else "?",
                     list(shape))


def op_error(op, env, cause, phase="lowering"):
    """Build an EnforceError describing `op` with the values in `env`."""
    lines = ["%s of op %r failed: %s: %s"
             % (phase, op.type, type(cause).__name__, cause)]
    for slot, names in sorted(op.inputs.items()):
        for n in names:
            lines.append("  in  %s=%r: %s"
                         % (slot, n, _describe_value(env.get(n))))
    for slot, names in sorted(op.outputs.items()):
        for n in names:
            lines.append("  out %s=%r: %s"
                         % (slot, n, _describe_value(env.get(n))))
    attrs = {k: v for k, v in sorted(op.attrs.items())
             if not k.startswith("_")}
    if attrs:
        lines.append("  attrs: %s" % (attrs,))
    err = EnforceError("\n".join(lines))
    err.__cause__ = cause
    return err
