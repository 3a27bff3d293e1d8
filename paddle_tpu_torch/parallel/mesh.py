"""Device mesh + sharding annotations.

The counterpart of ``paddle_tpu/parallel/mesh.py``. The axes follow the
same convention: ``dp`` (data), ``tp`` (tensor/model), ``pp``
(pipeline), ``sp`` (sequence/context), ``ep`` (expert); any subset may
be present, and an axis of size 1 is free.

The JAX mesh holds devices and XLA places arrays on it. The port runs one
process a rank, so a ``Mesh`` here holds the ranks of the process group
(``devices``, row-major over the axes, as ``make_mesh`` reshapes the JAX
devices) and, over more than one rank, a
``torch.distributed.device_mesh.DeviceMesh`` with the same dim names:
its per-axis process groups carry the collectives
(``parallel/collective.py``). A mesh of one rank has no process group to
use and places nothing.

``ParallelExecutor``'s DTensors live on the sub-mesh of the ``dp`` and
``tp`` axes (``dtensor_mesh``): those are the axes the JAX package's
GSPMD propagates through a whole program (the batch, the Megatron
hints). The ``pp``, ``sp`` and ``ep`` axes are worked only inside the
shard_map counterparts (the pipeline, ring/Ulysses, the MoE dispatch),
which slice and gather along them by hand; outside those a value is the
same on every rank of them. DTensor's redistribution planner searches
placement paths per op, and over three mesh dims that search takes
minutes a step on the CPU, which is what keeps the DTensor mesh at two.

Where the port steps around DTensor. This is the one list; a new
lowering that meets a DTensor value checks it first.

  * redistribution: layouts, their gradients and fetches move through
    the port's staged collectives (``collective.move_local``,
    ``collective.global_value``, ``_shard_map._dtensor_local``), not
    ``redistribute``/``full_tensor``: DTensor's functional all-gather of
    CUDA tensors over gloo kills the process on the H100's PyTorch 2.11.
    The Megatron combo (dp x tp) still all-gathers inside DTensor's own
    ops, so it runs on the CPU's ranks but not on the card (ROADMAP.md,
    queue 3);
  * ``from_local``'s backward: ``_shard_map._FromLocal`` brings the
    gradient to the block's placements with the same collectives;
  * ``view``: ``ops/common.reshape`` (used by ``reshape`` and ``mul``)
    makes a permuted gradient block contiguous first, since DTensor's
    stride bookkeeping can call it contiguous and its ``view`` fails;
  * ``index_put`` (``lookup_table``'s gradient): the lookup runs in a
    shard_map region on each rank's block of ids, the table whole
    (DTensor's strategy fails with "Shard dim -1 ... must be
    normalized");
  * ``gather`` (``softmax_with_cross_entropy``): gathers along the last
    dim by its index, as DTensor's strategy wants normalized dims;
  * the kernel wrappers read ``data_ptr()``, so no DTensor reaches a
    kernel: the parallel ops enter them through shard_map.
"""

import collections

import numpy as np
import torch
import torch.distributed as dist

_DEFAULT_MESH = None

# the axes ParallelExecutor's DTensors are laid out over (module docstring)
DTENSOR_AXES = ("dp", "tp")


class PartitionSpec(tuple):
    """The JAX ``PartitionSpec``: one entry a tensor dim, each None
    (replicated), a mesh axis name, or a tuple of names (the dim split
    over those axes, the first the major one)."""

    def __new__(cls, *parts):
        return tuple.__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


P = PartitionSpec


class Mesh:
    """Named axes over the ranks of the process group."""

    def __init__(self, axis_sizes, device_type):
        self.axis_names = tuple(axis_sizes)
        self.shape = collections.OrderedDict(
            (n, int(axis_sizes[n])) for n in self.axis_names)
        self.size = int(np.prod(list(self.shape.values()), dtype=np.int64))
        self.devices = np.arange(self.size).reshape(
            tuple(self.shape.values()))
        self.device_type = device_type
        self.device_mesh = None
        if self.size > 1:
            from torch.distributed.device_mesh import init_device_mesh
            self.device_mesh = init_device_mesh(
                device_type, tuple(self.shape.values()),
                mesh_dim_names=self.axis_names)

    def __repr__(self):
        return "Mesh(%s)" % ", ".join("%s=%d" % kv
                                      for kv in self.shape.items())

    @property
    def dtensor_axes(self):
        """The mesh axes of ``dtensor_mesh``, in mesh order."""
        return tuple(a for a in self.axis_names if a in DTENSOR_AXES)

    @property
    def dtensor_mesh(self):
        """The DeviceMesh of this rank's ``dp`` x ``tp`` slice (None when
        those axes hold one rank: nothing is a DTensor then)."""
        axes = self.dtensor_axes
        if self.device_mesh is None or \
                all(self.shape[a] <= 1 for a in axes):
            return None
        return self.device_mesh[axes if len(axes) > 1 else axes[0]]

    def group(self, axis):
        """The process group of this rank's ``axis`` line; None where the
        axis has one rank (every collective over it is the identity)."""
        if self.shape.get(axis, 1) <= 1:
            return None
        return self.device_mesh.get_group(axis)

    def axis_index(self, axis):
        """This rank's coordinate on ``axis``."""
        if self.shape.get(axis, 1) <= 1:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def device(self):
        """This rank's torch device."""
        from ..distributed import launch
        dev = launch.device()
        if dev is not None:
            return dev
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_type)


def _world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type(devices):
    if devices is not None and not isinstance(devices, (list, tuple)):
        return torch.device(devices).type
    from ..distributed import launch
    dev = launch.device()
    if dev is not None:
        return dev.type
    from ..core.places import resolve_device
    return resolve_device(None).type


def make_mesh(axis_sizes=None, devices=None):
    """Build a Mesh. axis_sizes: dict like {"dp": 4, "tp": 2} (ordered).
    Defaults to every rank on one dp axis. ``devices``: the device type
    ("cuda" or "cpu"); None is this rank's device
    (``distributed.launch``), the card by default. The axes must cover
    the process group's ranks exactly: one process a rank."""
    world = _world_size()
    if not axis_sizes:
        axis_sizes = {"dp": world}
    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[n]) for n in names)
    need = int(np.prod(sizes, dtype=np.int64))
    if need > world:
        raise ValueError(
            "mesh needs %d devices but only %d available" % (need, world))
    if need < world:
        raise ValueError(
            "mesh needs %d devices but the process group has %d ranks: a "
            "mesh spans every rank" % (need, world))
    return Mesh(collections.OrderedDict(zip(names, sizes)),
                _device_type(devices))


def set_default_mesh(mesh):
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh
    return mesh


def default_mesh():
    return _DEFAULT_MESH


def shard(var, *spec):
    """Annotate a Program variable (or name) with a PartitionSpec-like
    tuple, e.g. shard(w, None, "tp") -> rows replicated, cols on tp.
    ParallelExecutor lays out matching state with these placements."""
    from ..core.program import Variable, default_main_program
    name = var.name if isinstance(var, Variable) else str(var)
    prog = (var.block.program if isinstance(var, Variable)
            else default_main_program())
    prog._sharding_hints[name] = tuple(spec)
    return var


def sharding_hint(program, name):
    return program._sharding_hints.get(name)


def spec_axes(entry):
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_to_placements(mesh, spec):
    """The DTensor placements (one a ``dtensor_mesh`` dim) of a sharding
    hint: the counterpart of ``spec_to_named_sharding``. A dim names the
    mesh axes it is split over; an axis name that is not in this mesh
    replicates the dim, as there, and so does a ``pp``/``sp``/``ep``
    axis (the module docstring)."""
    from torch.distributed.tensor import Replicate, Shard
    axes = mesh.dtensor_axes
    placements = [Replicate() for _ in axes]
    for dim, entry in enumerate(spec or ()):
        for ax in spec_axes(entry):
            if ax in axes:
                placements[axes.index(ax)] = Shard(dim)
    return placements


class DistributedStrategy:
    """Knob container (reference BuildStrategy/ExecutionStrategy parity +
    the mesh axes)."""

    def __init__(self, dp=None, tp=1, pp=1, sp=1, ep=1,
                 use_bf16_compute=False, gradient_accumulation_steps=1,
                 gradient_accumulation_loss_norm=None,
                 pp_schedule="gpipe", pp_virtual_stages=0):
        self.dp = dp
        self.tp = tp
        self.pp = pp
        self.sp = sp
        self.ep = ep
        self.use_bf16_compute = use_bf16_compute
        self.gradient_accumulation_steps = gradient_accumulation_steps
        # loss-normalization contract for ragged (LoD) accumulation:
        # None | "sequence" | "token" | "token:<feed_name>" — see
        # ParallelExecutor._check_accum_weights
        self.gradient_accumulation_loss_norm = gradient_accumulation_loss_norm
        # pipeline schedule: "gpipe" (M >= S) or "interleaved" (Megatron
        # virtual stages, bubble / pp_virtual_stages; M <= S regime)
        self.pp_schedule = pp_schedule
        self.pp_virtual_stages = pp_virtual_stages

    def effective_dp(self, devices=None):
        """The dp size build_mesh will use: explicit dp wins; dp=None
        divides the ranks (or ``devices``, a count or a list) by the
        fixed axes. Model builders that bake dp-derived static attrs
        (the MoE moe_gate_groups = dp*ep) resolve dp through this."""
        if self.dp:
            return self.dp
        if devices is None:
            total = _world_size()
        elif isinstance(devices, int):
            total = devices
        else:
            total = len(devices)
        fixed = self.tp * self.pp * self.sp * self.ep
        return max(1, total // fixed)

    def build_mesh(self, devices=None):
        dp = self.effective_dp()
        sizes = collections.OrderedDict()
        for name, size in (("dp", dp), ("pp", self.pp), ("sp", self.sp),
                           ("ep", self.ep), ("tp", self.tp)):
            if size and size > 1 or name == "dp":
                sizes[name] = size
        return make_mesh(sizes, devices)
