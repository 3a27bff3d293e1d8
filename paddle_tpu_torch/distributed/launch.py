"""Process-group bootstrap for mesh-mode training.

The counterpart of ``paddle_tpu/distributed/launch.py``. The JAX package
builds its cross-host group with ``jax.distributed.initialize``; the
port is one process a rank over ``torch.distributed``, so this module
starts that group and remembers the rank's device:

  * the device is the card (``cuda:<local rank>``) unless the caller asks
    for ``device="cpu"``; without a card the default raises, as every
    entry point of the port does;
  * the backend is NCCL on the card and gloo on the CPU, or gloo when
    named (``backend="gloo"``: several ranks on one card, whose
    collectives ``parallel/collective.py`` stages through host memory);
  * the rendezvous is the coordinator's address, ``host:port`` (a TCP
    store, rank 0 listening) or ``file://<path>`` (a ``FileStore``, the
    tests' choice: no port to collide on), or the usual environment. One
    process with no coordinator is a one-rank group over an in-memory
    store, so a script runs unchanged alone.

Environment (the JAX package's names first, then torchrun's):
  PADDLE_COORDINATOR or MASTER_ADDR:MASTER_PORT   the rendezvous
  PADDLE_TRAINERS_NUM or WORLD_SIZE               the process count
  PADDLE_TRAINER_ID or RANK                       this process's rank
  LOCAL_RANK                                      the card of this rank
"""

import datetime
import os

import torch
import torch.distributed as dist

from ..core.places import resolve_device

__all__ = ["init_parallel_env", "global_mesh", "trainer_id",
           "trainer_count", "device", "shutdown"]

# a rendezvous or collective that waits longer than this fails instead of
# hanging (a rank that died leaves the others waiting otherwise)
DEFAULT_TIMEOUT_S = 300

_state = {"device": None}


def _env_int(*names, default):
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return default


def init_parallel_env(coordinator_address=None, num_processes=None,
                      process_id=None, local_device_ids=None, device=None,
                      backend=None, timeout=None):
    """Idempotent process-group init. Returns this rank's device."""
    if dist.is_initialized():
        return _state["device"]
    coordinator_address = coordinator_address or \
        os.environ.get("PADDLE_COORDINATOR")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = "%s:%s" % (os.environ["MASTER_ADDR"],
                                         os.environ.get("MASTER_PORT",
                                                        "29500"))
    if num_processes is None:
        num_processes = _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE",
                                 default=1)
    if process_id is None:
        process_id = _env_int("PADDLE_TRAINER_ID", "RANK", default=0)
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = (local_device_ids[0] if local_device_ids else
                     _env_int("LOCAL_RANK", default=0))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    timeout = datetime.timedelta(seconds=timeout or DEFAULT_TIMEOUT_S)
    if coordinator_address is None:
        if num_processes > 1:
            raise ValueError(
                "init_parallel_env: %d processes need a coordinator "
                "address (host:port or file://<path>)" % num_processes)
        store = dist.HashStore()
    elif coordinator_address.startswith("file://"):
        store = dist.FileStore(coordinator_address[len("file://"):],
                               num_processes)
    else:
        host, port = coordinator_address.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), num_processes,
                              process_id == 0, timeout=timeout)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    _state["device"] = dev
    return dev


def device():
    """This rank's device (None before ``init_parallel_env``)."""
    return _state["device"]


def shutdown():
    """Tear the process group down (a test's ranks end with it)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _state["device"] = None


def global_mesh(axes):
    """Mesh over ALL processes (call after init_parallel_env). `axes`:
    dict name -> size, like parallel.make_mesh."""
    from ..parallel.mesh import make_mesh
    return make_mesh(axes)


def trainer_id():
    return dist.get_rank() if dist.is_initialized() else 0


def trainer_count():
    return dist.get_world_size() if dist.is_initialized() else 1
