"""paddle_tpu_torch.resilience — fault injection + self-healing runtime.

The port's copy of ``paddle_tpu/resilience``: the same seeded fault
plans (the same decisions for the same seed), retry policy and
``resilient_loop``, over the port's Executor, io and wire.

The reference framework's whole cloud story is fault tolerance: the Go
master's at-least-once task leases (go/master/service.go) and the
pserver's CRC'd checkpoint/recover path (go/pserver/service.go). The
ports of those pieces (distributed/master.py, rpc.py, membership.py,
io.save_checkpoint) each survive a crash individually; this package is
what COMPOSES them — and what proves the composition under injected
failure.

Three pieces (see each module's docstring):
  faults   deterministic, seeded fault-injection plan: RPC frame
           drop / delay / close-mid-frame / duplicate, pserver/master
           kill-switches, checkpoint corruption, one-shot NaN batches
  retry    bounded-exponential-backoff Policy used by RPCClient /
           MasterClient to transparently reconnect and re-issue
           idempotent verbs (incarnation/replacement-aware via an
           endpoint resolver)
  driver   ``resilient_loop``: background checkpointing off the step
           path, auto-resume from the newest valid checkpoint, and a
           NaN/Inf guard that rolls back and skips the poisoned batch

Arm a fault plan for a whole process with ``PADDLE_TPU_FAULTS`` (JSON
spec or ``@/path/to/plan.json``) + ``PADDLE_TPU_FAULTS_SEED``, or
programmatically::

    from paddle_tpu_torch.resilience import faults
    plan = faults.arm({"rpc": {"drop": 0.02}, "nan": {"step": 7}}, seed=1)
    ...
    faults.disarm()

Every injection, retry, reconnect, rollback, and resume lands in
paddle_tpu_torch.monitor (counters always; flight-recorder events when a
recorder is armed), so a chaos run leaves a machine-readable black box.
"""

from . import faults  # noqa: F401
from . import retry  # noqa: F401
from . import driver  # noqa: F401
from .retry import Policy, default_policy  # noqa: F401
from .driver import resilient_loop  # noqa: F401

__all__ = ["faults", "retry", "driver", "Policy", "default_policy",
           "resilient_loop"]
