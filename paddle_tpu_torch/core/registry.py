"""Op lowering registry.

The counterpart of ``paddle_tpu/core/registry.py``. Each op type
registers a lowering rule, a function ``(ctx, op) -> None`` that reads
its inputs from ``ctx.env`` and writes its outputs there. The JAX package
traces these rules into one XLA computation; the port's Executor calls
them eagerly on torch tensors, in program order. Hand-written kernels sit
inside lowering bodies (``sp_attention`` -> ``ops/flash_attention``,
``dropout`` -> ``ops/dropout``).

An op registered with ``host=True`` runs on the host's view of its
values (the SelectedRows ops of ``distributed/ops.py``); a program that
holds one runs op by op through ``Executor.run`` only.

An op registered with ``stateful_rng=True`` draws random numbers: the
initializers (``uniform_random``, ``gaussian_random``, ...), ``nce``'s
negatives and dropout all draw counter-keyed Philox bits
(``core/philox.py``) keyed by ``ctx.draw_key(op)``: the run's seed, a
device scalar, and the op's ordinal among the program's random ops
(``random_op_keys``). No op draws from a ``torch.Generator``, so a CUDA
graph of K steps draws what K runs draw.
"""


class OpInfo:
    def __init__(self, type, lower, infer_shape=None, stateful_rng=False,
                 host=False):
        self.type = type
        self.lower = lower            # fn(ctx, op) -> None (writes ctx env)
        self.infer_shape = infer_shape
        self.stateful_rng = stateful_rng  # draws random numbers
        self.host = host  # reads the host: never inside a CUDA graph


_REGISTRY = {}


def register(type, lower=None, infer_shape=None, stateful_rng=False,
             host=False):
    """Register an op lowering. Usable as decorator or direct call."""
    def deco(fn):
        _REGISTRY[type] = OpInfo(type, fn, infer_shape, stateful_rng, host)
        return fn
    if lower is not None:
        return deco(lower)
    return deco


def lookup(type):
    return _REGISTRY.get(type)


def is_host_op(type):
    """Whether op ``type`` is registered as a host op (the SelectedRows
    ops: their row counts are data, read on the host)."""
    info = _REGISTRY.get(type)
    return bool(info and info.host)


def registered_ops():
    return sorted(_REGISTRY)


def sub_blocks(op):
    """The sub-blocks an op carries in its attributes (a
    ``recompute_block``'s region)."""
    out = []
    for a in op.attrs.values():
        for b in (a if isinstance(a, (list, tuple)) else [a]):
            if hasattr(b, "ops"):
                out.append(b)
    return out


def random_op_keys(block):
    """{id(op): ordinal} over the random (``stateful_rng``) ops of
    ``block`` in program order, descending into each sub-block where its
    op stands. An op's key depends neither on whether it sits in a
    recompute region nor on its variables' names, so a region's
    recompute replays the forward's draws, and a model with regions
    draws what the same model without them draws."""
    keys = {}

    def walk(blk):
        for op in blk.ops:
            info = _REGISTRY.get(op.type)
            if info is not None and info.stateful_rng:
                keys[id(op)] = len(keys)
            for sub in sub_blocks(op):
                walk(sub)

    walk(block)
    return keys


class LowerContext:
    """Environment handed to lowering rules.

    ``env`` maps var name -> torch tensor. ``device`` is where the run's
    tensors live (lowerings that create tensors put them there).
    ``seed_fn()`` hands out the run's seed (an int64 device scalar) and
    ``rng_keys`` the program's ``random_op_keys``: together they key the
    counter-based draws (``draw_key``). ``guards`` is the step's NaN/Inf
    guard recorder (the executor's, under the ``check_nan_inf`` flag) or
    None. ``mesh`` is ``ParallelExecutor``'s ``parallel.Mesh`` (None
    under ``Executor``): the parallel ops (``ops/parallel_ops.py``) and
    the collectives (``parallel/collective.py``) read it. ``static_info`` is the
    run's static table, host values the feeds fix for the whole run:
    ``<name>@MAXLEN``, the bound of a LoD value's sequence lengths,
    which the RNN scans loop to. ``debug_nans`` (the flag's value for
    the run) makes every op check its outputs, and its backward the
    gradients it hands its inputs, for NaN.
    """

    debug_nans = False

    def __init__(self, env, device, is_test=False, executor=None,
                 block=None, mesh=None, fetch_names=(), read_names=None,
                 seed_fn=None, rng_keys=None, static_info=None,
                 guards=None):
        self.env = env
        self.static_info = static_info if static_info is not None else {}
        self.guards = guards
        self._seed_fn = seed_fn    # () -> the run's seed, int64 [] tensor
        self.rng_keys = rng_keys if rng_keys is not None else {}
        self.device = device
        self.is_test = is_test
        self.executor = executor
        self.block = block
        self.mesh = mesh
        self.fetch_names = tuple(fetch_names or ())
        # names some op of the block or a fetch reads; None = unknown
        self._read_names = read_names
        # {name: hint} of the persistables held as this rank's block
        # (``ParallelExecutor``; ``parallel/blocks.py``)
        self.held = getattr(executor, "_held", None) or {}

    def held_spec(self, name):
        """The hint of ``name`` (or of the parameter ``name`` is the
        gradient of) where this rank holds it as a block, else None."""
        if not self.held or name is None:
            return None
        if name.endswith("@GRAD"):
            name = name[:-len("@GRAD")]
        return self.held.get(name)

    def is_read(self, name):
        """Whether anything reads var ``name`` in this run, so a lowering
        may skip an output nobody reads (XLA drops those in the JAX
        package; eager execution would compute them)."""
        return name is not None and (self._read_names is None
                                     or name in self._read_names)

    # -- value access --------------------------------------------------------
    def get(self, name):
        if name not in self.env:
            raise KeyError("var %r not materialized at lowering time" % name)
        return self.env[name]

    def maybe_get(self, name, default=None):
        return self.env.get(name, default)

    def set(self, name, value):
        self.env[name] = value

    def in1(self, op, slot, default=None):
        names = op.input(slot)
        if not names:
            return default
        return self.get(names[0])

    def in_list(self, op, slot):
        return [self.get(n) for n in op.input(slot)]

    def out_name(self, op, slot):
        names = op.output(slot)
        return names[0] if names else None

    def set_out(self, op, slot, value):
        name = self.out_name(op, slot)
        if name is not None:
            self.env[name] = value

    def draw_key(self, op):
        """(the run's seed as an int64 device scalar, the op's key) for a
        counter-keyed draw of random op ``op``."""
        if self._seed_fn is None or id(op) not in self.rng_keys:
            raise RuntimeError(
                "random op %r has no draw key: it must run through an "
                "Executor, whose step keys every random op of the "
                "program" % op.type)
        return self._seed_fn(), self.rng_keys[id(op)]

    def sub_context(self, env, block, guarded=False):
        """A context for the ops of sub-block ``block`` over ``env``,
        drawing as this one does. ``guarded`` shares this context's NaN
        guards (a recompute region and the checkpointed forward, as the
        JAX package guards them); other sub-blocks (loops, branches) are
        guarded through the op that holds them."""
        sub = LowerContext(env, self.device,
                           is_test=self.is_test, executor=self.executor,
                           block=block, mesh=self.mesh,
                           fetch_names=self.fetch_names,
                           read_names=self._read_names,
                           seed_fn=self._seed_fn, rng_keys=self.rng_keys,
                           static_info=self.static_info,
                           guards=self.guards if guarded else None)
        sub.debug_nans = self.debug_nans
        return sub
