"""Program→Program rewrite passes.

The counterpart of ``paddle_tpu/transpiler.py``. Reference parity:
  * InferenceTranspiler (python/paddle/fluid/inference_transpiler.py:21):
    fuse batch_norm into the preceding conv's weights for inference.
  * memory_optimize / release_memory
    (python/paddle/fluid/memory_optimization_transpiler.py:362): liveness
    analysis for in-place buffer reuse. In the port PyTorch's caching
    allocator reuses a freed buffer for the next tensor of its size
    class, and a ``run_steps`` CUDA graph runs in one private memory
    pool, so these are intentional no-ops kept for API parity.
"""

import numpy as np
import torch

from .core.executor import as_numpy
from .core.places import Place
from .core.program import Operator, default_main_program
from .core.scope import global_scope, to_tensor

__all__ = ["InferenceTranspiler", "memory_optimize", "release_memory"]


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0):
    """No-op under the caching allocator (see module docstring). Returns
    the program."""
    return input_program


def release_memory(input_program, skip_opt_set=None):
    """No-op under the caching allocator (see module docstring). Returns
    the program."""
    return input_program


class InferenceTranspiler:
    """Fuses conv2d → batch_norm(is_test) into a single conv2d + bias add by
    folding the BN affine transform into the filter, exactly the
    inference_transpiler.py:21 optimization. Operates on scope values, so
    call it after params are initialized/loaded. The folded filter and
    bias are computed in numpy as the JAX package computes them, and
    written back as tensors on the device the filter's value lives on
    (``place``'s for a value that is no tensor; the card by default)."""

    def transpile(self, program=None, place=None, scope=None):
        program = program or default_main_program()
        scope = scope or global_scope()
        block = program.global_block()
        ops = block.ops
        i = 0
        while i < len(ops) - 1:
            op = ops[i]
            nxt = ops[i + 1]
            if (op.type == "conv2d" and nxt.type == "batch_norm"
                    and op.output("Output")
                    and nxt.input("X") == op.output("Output")):
                ops[i + 1] = self._fuse_conv_bn(block, scope, op, nxt,
                                                place)
                program._bump_version()
            i += 1
        return program

    @staticmethod
    def _fuse_conv_bn(block, scope, conv_op, bn_op, place):
        eps = bn_op.attr("epsilon", 1e-5)
        filter_name = conv_op.input("Filter")[0]
        w_value = scope.find_var(filter_name)
        if isinstance(w_value, torch.Tensor):
            device = w_value.device
        elif isinstance(place, Place):
            device = place.torch_device()
        else:
            device = torch.device("cuda", 0)
        w = as_numpy(w_value)
        scale = as_numpy(scope.find_var(bn_op.input("Scale")[0]))
        bias = as_numpy(scope.find_var(bn_op.input("Bias")[0]))
        mean = as_numpy(scope.find_var(bn_op.input("Mean")[0]))
        var = as_numpy(scope.find_var(bn_op.input("Variance")[0]))

        inv_std = 1.0 / np.sqrt(var + eps)
        alpha = scale * inv_std                      # [C_out]
        scope.set(filter_name, to_tensor(
            (w * alpha[:, None, None, None]).astype(w.dtype), device))
        new_bias = (bias - mean * alpha).astype(w.dtype)

        # rewrite the BN output to a bias-add on the conv output, reusing the
        # BN Bias var to carry the folded bias
        bias_name = bn_op.input("Bias")[0]
        scope.set(bias_name, to_tensor(new_bias, device))
        conv_out = conv_op.output("Output")[0]
        bn_out = bn_op.output("Y")[0]
        return Operator(block, "elementwise_add",
                        {"X": [conv_out], "Y": [bias_name]},
                        {"Out": [bn_out]}, {"axis": 1})
