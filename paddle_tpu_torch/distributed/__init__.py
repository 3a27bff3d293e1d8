"""The distributed tier: the parameter-server wire and its runtime, the
SelectedRows host ops, and the process-group bootstrap of mesh-mode
training.

  * ``rpc``: ``VariableServer`` and ``RPCClient`` over the JAX package's
    numpy-native frames (SEND PUT GET PRFT BARR CHNK EXIT CLKS METR HLTH
    DUMP), with idempotent round tags, incarnations and
    checkpoint/recover;
  * ``transpiler``: ``DistributeTranspiler`` (pserver mode, sync and
    async, ``is_distributed`` tables sharded over the pservers);
  * ``ops``: the six wire ops (send, send_barrier, send_sparse, recv,
    prefetch, listen_and_serv) and the SelectedRows host ops;
  * ``membership``: the TTL-lease KV store, ``register_pserver``,
    ``wait_for_pservers``; ``master``: the elastic task queue;
  * ``launch``: one process a rank over ``torch.distributed``.
"""

from .rpc import VariableServer, RPCClient  # noqa: F401
from .transpiler import DistributeTranspiler  # noqa: F401
from .membership import (KVServer, KVClient, register_pserver,  # noqa: F401
                         wait_for_pservers, TrainerLease)
from . import ops  # noqa: F401  (registers the host ops)
from . import launch  # noqa: F401
