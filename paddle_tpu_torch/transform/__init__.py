"""paddle_tpu_torch.transform: optimizing IR passes and inference
specialization.

The counterpart of ``paddle_tpu/transform/``, for what is ported:

  passes        Pass / PassManager over core/program.py's IR, with a
                bitwise re-execution verifier. Shipped passes:
                  constant_fold  evaluate all-constant pure ops into
                                 initialized (assign_value) vars
                  cse            common-subexpression elimination
                  dead_op        liveness-rooted dead-op elimination
                                 (beyond Program.prune's target walk)
                  fusion         pattern fusion (matmul+bias+act ->
                                 fused ops, inverse transpose/reshape
                                 chains, scale/cast pairs)
                  bf16_cast      OPT-IN bf16 operand cast (rtol-gated,
                                 excluded from 'all')
  infer         specialize_for_inference: prune + the pipeline into
                the io.save_inference_model servable artifact

Arm at runtime with PADDLE_TPU_TRANSFORM=1 (pass selection via
PADDLE_TPU_TRANSFORM_PASSES): the Executor builds each step from the
transformed clone while its keys stay the caller's program.

Not ported yet (ROADMAP.md queue 1, item 11(a) part two): ``memory``
(memory_plan), ``calibrate``, ``autoparallel`` (the dp/tp/pp/sp/ep
planner) and the ``python -m`` CLI.
"""

from .passes import (  # noqa: F401
    Pass, PassManager, TransformResult, ConstantFoldPass, CSEPass,
    DeadOpEliminationPass, default_passes, passes_by_name,
    resolve_passes, maybe_transform_for_build, verify_bitwise)
from .fusion import FusionPass, PATTERN_NAMES  # noqa: F401
from .infer import (Bf16CastPass, SpecializeResult,  # noqa: F401
                    specialize_for_inference)
