"""Op lowering registry.

The counterpart of ``paddle_tpu/core/registry.py``. Each op type
registers a lowering rule, a function ``(ctx, op) -> None`` that reads
its inputs from ``ctx.env`` and writes its outputs there. The JAX package
traces these rules into one XLA computation; the port's Executor calls
them eagerly on torch tensors, in program order. Hand-written kernels sit
inside lowering bodies (``sp_attention`` -> ``ops/flash_attention``).
"""


class OpInfo:
    def __init__(self, type, lower, infer_shape=None):
        self.type = type
        self.lower = lower            # fn(ctx, op) -> None (writes ctx env)
        self.infer_shape = infer_shape


_REGISTRY = {}


def register(type, lower=None, infer_shape=None):
    """Register an op lowering. Usable as decorator or direct call."""
    def deco(fn):
        _REGISTRY[type] = OpInfo(type, fn, infer_shape)
        return fn
    if lower is not None:
        return deco(lower)
    return deco


def lookup(type):
    return _REGISTRY.get(type)


def registered_ops():
    return sorted(_REGISTRY)


class LowerContext:
    """Environment handed to lowering rules.

    ``env`` maps var name -> torch tensor. ``device`` is where the run's
    tensors live (lowerings that create tensors put them there);
    ``rng()`` hands out the run's ``torch.Generator`` on that device, so
    every random op of one run draws from one seeded stream in program
    order. ``mesh`` is always None in the port: no op runs across cards
    yet.
    """

    def __init__(self, env, rng_fn, device, is_test=False, executor=None,
                 block=None, mesh=None, fetch_names=(), read_names=None):
        self.env = env
        self._rng_fn = rng_fn      # () -> the run's torch.Generator
        self.device = device
        self.is_test = is_test
        self.executor = executor
        self.block = block
        self.mesh = mesh
        self.fetch_names = tuple(fetch_names or ())
        # names some op of the block or a fetch reads; None = unknown
        self._read_names = read_names

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

    def rng(self):
        return self._rng_fn()
