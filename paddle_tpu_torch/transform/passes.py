"""Optimizing IR passes over core/program.py's Program.

The counterpart of ``paddle_tpu/transform/passes.py``, with its passes,
its purity model and its verifier. A ``Pass`` rewrites a Program clone,
a ``PassManager`` drives passes to a fixed point, and every shipped pass
is semantics-preserving by construction: ``verify_bitwise`` re-executes
the transformed program and asserts its fetches are BITWISE-identical to
the untransformed one's. Each pass makes the JAX package's rewrite, so
the two packages' transformed Programs serialize to the same JSON.

Why the rewrites matter to the port: its Executor runs every op of the
block eagerly, step after step, so a dead chain or a duplicate subgraph
costs a launch (and the host's dispatch) on every step, and a CUDA graph
holds it on every replay.

Purity model (what a pass may touch):
  * RNG ops (``registry.OpInfo.stateful_rng``) are pinned in place:
    each draws with its ordinal among the program's random ops
    (``registry.random_op_keys``), so removing or deduplicating one
    would shift every later op's draws and break bitwise identity
    (dropout masks, sampled negatives).
  * host (IO) ops, grad markers, ``print``, ops with sub-block attrs
    (control flow), in-place updaters (an output name that is also an
    input name) and writers of persistable vars are side-effecting
    roots: never removed, never deduplicated, never folded.
  * everything else is a pure function of its inputs + attrs.

``constant_fold`` evaluates through the port's own lowerings, on the
device the folded program will run on (``ConstantFoldPass(device=)``;
the armed Executor passes its own), so the folded bits are the bits the
unfolded op would compute there.
"""

import collections
import time

import numpy as np
import torch

from ..core import registry
from ..core.program import Block, Operator

# ops that are side-effecting regardless of registry info
_SIDE_EFFECT_TYPES = frozenset({
    "feed", "fetch", "print",
    "backward_marker", "calc_gradient_marker",
})

# grad markers name their dataflow in attrs, not input slots
_MARKER_ATTR_INPUTS = {
    "backward_marker": ("param_names", "loss_name"),
    "calc_gradient_marker": ("input_names", "target_names"),
}


class _Opaque(Exception):
    """Raised while canonicalizing attrs we refuse to reason about."""


def _attr_key(v):
    """Hashable canonical form of one attr value (CSE key material)."""
    if isinstance(v, Block):
        raise _Opaque(v)
    if isinstance(v, np.ndarray):
        return ("nd", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, (list, tuple)):
        return ("seq",) + tuple(_attr_key(x) for x in v)
    if isinstance(v, dict):
        return ("map", tuple(sorted((k, _attr_key(x))
                                    for k, x in v.items())))
    return (type(v).__name__, v)


def _has_subblock(op):
    return any(isinstance(v, Block) for v in op.attrs.values())


def _marker_input_names(op):
    names = []
    for attr in _MARKER_ATTR_INPUTS.get(op.type, ()):
        v = op.attr(attr)
        if isinstance(v, str):
            names.append(v)
        elif v:
            names.extend(str(n) for n in v)
    return names


def op_inputs(op):
    """All names an op reads, including grad-marker attr references."""
    return op.input_names + _marker_input_names(op)


def is_rng_op(op):
    info = registry.lookup(op.type)
    # unknown op type: assume the worst (it may draw from the stream)
    return info is None or info.stateful_rng


def is_side_effecting(op, persistable):
    """True when an op must stay, in place, regardless of use: it does
    IO, draws RNG (stream position!), owns control flow, updates state
    in place, or writes a persistable var (the step's lasting effect)."""
    if op.type in _SIDE_EFFECT_TYPES or _has_subblock(op):
        return True
    if registry.is_host_op(op.type) or is_rng_op(op):
        return True
    outs = set(op.output_names)
    if outs & set(op.input_names):      # in-place update
        return True
    return bool(outs & persistable)


def _subblock_needed(program):
    """Names referenced from any sub-block: control-flow bodies read
    parent-block vars by name, invisibly to the global op list."""
    needed = set()
    for blk in program.blocks[1:]:
        for op in blk.ops:
            needed.update(op_inputs(op))
            needed.update(op.output_names)
    return needed


def _def_counts(block):
    c = collections.Counter()
    for op in block.ops:
        for n in op.output_names:
            c[n] += 1
    return c


class Pass:
    """One rewrite over a Program's global block.

    Contract: ``rewrite(program, keep)`` mutates ``program`` in place
    (the PassManager hands it a clone) and returns the number of ops it
    removed or replaced. ``keep`` is the set of var names whose values
    must survive (fetch targets); persistable vars are always kept.
    Every pass must be semantics-preserving: the verify phase
    (``verify_bitwise``) re-executes and compares fetches bitwise."""

    name = "?"
    doc = ""

    def rewrite(self, program, keep):
        raise NotImplementedError


class DeadOpEliminationPass(Pass):
    """Remove ops whose outputs no fetch, persistable write or
    side-effecting op (transitively) consumes.

    Beyond ``Program.prune()``: prune backward-slices to explicit
    targets and is meant for carving inference graphs (it drops
    optimizer ops!); this is a liveness pass — roots are the keep set
    PLUS every side-effecting op, so training semantics survive while
    dead chains (including chains that feed only other dead ops, which
    prune's target-walk keeps when any link shares a var with a live
    chain's input set) are dropped."""

    name = "dead_op"
    doc = "liveness-rooted dead-op elimination (beyond prune())"

    def rewrite(self, program, keep):
        gb = program.global_block()
        persistable = {v.name for v in gb.vars.values() if v.persistable}
        needed = set(keep) | _subblock_needed(program)
        live = []
        for op in reversed(gb.ops):
            if is_side_effecting(op, persistable) \
                    or set(op.output_names) & needed:
                live.append(op)
                needed.update(op_inputs(op))
        if len(live) == len(gb.ops):
            return 0
        removed = len(gb.ops) - len(live)
        live.reverse()
        gb.ops = live
        program._bump_version()
        return removed


class CSEPass(Pass):
    """Common-subexpression elimination: two pure ops with the same
    type, attrs and (version-tracked) input values compute the same
    thing — the later one is dropped and its output names rewritten to
    the earlier one's.

    Safety: only ops whose outputs are written EXACTLY once in the
    block participate (the IR is not SSA; a name redefined later would
    let a rewritten consumer read the wrong generation), and outputs in
    the keep/persistable set are never dropped (their name must hold a
    value at fetch/commit time)."""

    name = "cse"
    doc = "common-subexpression elimination over pure ops"

    def rewrite(self, program, keep):
        gb = program.global_block()
        persistable = {v.name for v in gb.vars.values() if v.persistable}
        protected = set(keep) | persistable | _subblock_needed(program)
        # grad markers reference their dataflow through ATTRS, which the
        # rename map never rewrites — a producer of a marker-referenced
        # name must survive under its own name
        for op in gb.ops:
            protected.update(_marker_input_names(op))
        defs = _def_counts(gb)
        version = collections.Counter()
        rename = {}
        seen = {}
        new_ops = []
        removed = 0
        for op in gb.ops:
            for slot, names in op.inputs.items():
                op.inputs[slot] = [rename.get(n, n) for n in names]
            key = None
            if not is_side_effecting(op, persistable):
                try:
                    key = (
                        op.type,
                        tuple(sorted(
                            (slot,
                             tuple((n, version[n]) for n in names))
                            for slot, names in op.inputs.items())),
                        tuple(sorted((k, _attr_key(v))
                                     for k, v in op.attrs.items())),
                        tuple(sorted((slot, len(names))
                                     for slot, names in
                                     op.outputs.items())),
                    )
                except _Opaque:
                    key = None
            prev = seen.get(key) if key is not None else None
            eliminable = (
                prev is not None
                and all(defs[n] == 1 for n in op.output_names)
                and all(defs[n] == 1
                        for names in prev.values() for n in names)
                and not (set(op.output_names) & protected))
            if eliminable:
                for slot, names in op.outputs.items():
                    for mine, theirs in zip(names, prev[slot]):
                        if mine != theirs:
                            rename[mine] = theirs
                removed += 1
                continue
            if key is not None and key not in seen:
                seen[key] = {slot: list(names)
                             for slot, names in op.outputs.items()}
            for n in op.output_names:
                version[n] += 1
            new_ops.append(op)
        if removed:
            gb.ops = new_ops
            program._bump_version()
        return removed


class ConstantFoldPass(Pass):
    """Evaluate pure ops whose inputs are all compile-time constants
    and fold the result into an initialized var: the op is replaced by
    an ``assign_value`` op carrying the computed array (the IR's
    "initialized var" form: serializable, and its lowering materializes
    exactly the bits computed here).

    Constant sources are ``fill_constant`` / ``assign_value`` ops
    (evaluated but left in place: they are already minimal; a source
    made dead by folding its consumer is removed by the dead-op pass in
    the same fixed-point loop). Folding caps the materialized size
    (``max_elements``) so it never bakes a large constant into the
    program. ``device`` (a keyword the JAX package does not have) is
    where the lowerings run: the device the folded program will run on
    (None: the CPU). A result numpy cannot hold (bfloat16) is not
    folded."""

    name = "constant_fold"
    doc = "evaluate all-constant pure ops into assign_value ops"

    _SOURCES = frozenset({"fill_constant", "assign_value"})

    def __init__(self, max_elements=65536, device=None):
        self.max_elements = int(max_elements)
        self.device = torch.device(device or "cpu")

    def _evaluate(self, op, const_env):
        """Run the op's real lowering on the concrete constant inputs;
        None when anything about it resists folding."""
        from ..core.scope import to_tensor
        info = registry.lookup(op.type)
        if info is None:
            return None
        # a pure op never draws: no seed is handed out (draw_key raises)
        env = {n: to_tensor(const_env[n], self.device)
               for n in op.input_names}
        ctx = registry.LowerContext(env, self.device, block=op.block)
        try:
            with torch.no_grad():
                info.lower(ctx, op)
        except Exception:
            return None
        # lowerings may publish SIDECAR env entries beyond the declared
        # outputs (e.g. sequence ops write "<out>@LOD"); an assign_value
        # replacement cannot reproduce those, so such ops do not fold
        declared = set(op.input_names) | set(op.output_names)
        if any(k not in declared for k in env):
            return None
        outs = {}
        for n in op.output_names:
            v = env.get(n)
            if not isinstance(v, torch.Tensor) \
                    or v.dtype == torch.bfloat16:
                return None
            if v.numel() > self.max_elements:
                return None
            outs[n] = v.detach().cpu().numpy()
        return outs

    def rewrite(self, program, keep):
        gb = program.global_block()
        persistable = {v.name for v in gb.vars.values() if v.persistable}
        defs = _def_counts(gb)
        const_env = {}
        folded = 0
        for i, op in enumerate(list(gb.ops)):
            if is_side_effecting(op, persistable) or _has_subblock(op):
                # a redefinition kills constness of the name
                for n in op.output_names:
                    const_env.pop(n, None)
                continue
            inputs_const = all(n in const_env for n in op.input_names)
            single_def = all(defs[n] == 1 for n in op.output_names)
            if not (inputs_const and single_def):
                for n in op.output_names:
                    const_env.pop(n, None)
                continue
            if op.type in self._SOURCES:
                outs = self._evaluate(op, const_env)
                if outs:
                    const_env.update(outs)
                continue
            outs = self._evaluate(op, const_env)
            if not outs or len(outs) != 1:
                continue
            (name, arr), = outs.items()
            gb.ops[i] = Operator(
                gb, "assign_value", None, {"Out": [name]},
                {"shape": list(arr.shape), "dtype": str(arr.dtype),
                 "values": np.ascontiguousarray(arr)})
            const_env[name] = arr
            folded += 1
        if folded:
            program._bump_version()
        return folded


def default_passes(device=None):
    """The shipped pipeline, in application order: fold constants so
    duplicate results unify, dedup, drop what fell dead, then fuse the
    surviving chains (fusion last: dedup first means one fused op per
    unique chain, and fusion output never grows the CSE search
    space). ``device``: where constant folding evaluates."""
    from .fusion import FusionPass
    return [ConstantFoldPass(device=device), CSEPass(),
            DeadOpEliminationPass(), FusionPass()]


def passes_by_name(device=None):
    """Name -> instance for every selectable pass: the default pipeline
    plus the opt-in passes 'all' deliberately excludes (bf16_cast is
    rtol-gated, not bitwise — see transform/infer.py)."""
    from .infer import Bf16CastPass
    table = {p.name: p for p in default_passes(device)}
    table["bf16_cast"] = Bf16CastPass()
    return table


def resolve_passes(spec, device=None):
    """'all' / 'none' / comma list -> ordered Pass instances (the
    transform_passes flag grammar, shared by the armed executor path
    and the JAX package's CLI)."""
    spec = (spec or "all").strip().lower()
    if spec in ("", "none", "0"):
        return []
    if spec in ("all", "1", "true"):
        return default_passes(device)
    table = passes_by_name(device)
    out = []
    for name in spec.split(","):
        name = name.strip()
        if not name:
            continue
        if name not in table:
            raise ValueError(
                "unknown transform pass %r (have: %s)"
                % (name, ", ".join(sorted(table))))
        out.append(table[name])
    return out


class TransformResult:
    """PassManager output: the transformed clone + per-pass accounting
    (``stats[pass_name]`` = ops removed or rewritten by that pass),
    per-PATTERN fusion hits (``patterns``), plus the op counts
    before/after for the one-line story."""

    def __init__(self, program, stats, ops_before, ops_after, rounds,
                 patterns=None):
        self.program = program
        self.stats = stats            # OrderedDict pass -> changes
        self.ops_before = ops_before
        self.ops_after = ops_after
        self.rounds = rounds
        self.patterns = dict(patterns or {})   # pattern -> hits

    @property
    def ops_removed(self):
        return self.ops_before - self.ops_after

    def to_dict(self):
        return {"ops_before": self.ops_before,
                "ops_after": self.ops_after,
                "ops_removed": self.ops_removed,
                "rounds": self.rounds,
                "passes": dict(self.stats),
                "patterns": dict(self.patterns)}


class PassManager:
    """Drives passes to a fixed point over a CLONE of the input program
    (the caller's program is never mutated). The transformed clone
    carries ``_transform_meta`` — parent version, new version, pass
    stats — so the monitor's recompile classifier can attribute a
    post-transform compile to the transform instead of counting a
    mystery new program (see monitor/runtime.on_compile)."""

    def __init__(self, passes=None, max_rounds=8):
        self.passes = list(passes if passes is not None
                           else default_passes())
        self.max_rounds = int(max_rounds)

    def run(self, program, keep=()):
        from .. import monitor as _mon
        clone = program.clone()
        keep = tuple(str(k) for k in keep)
        stats = collections.OrderedDict((p.name, 0) for p in self.passes)
        patterns = collections.OrderedDict()
        ops_before = len(clone.global_block().ops)
        rounds = 0
        for _ in range(self.max_rounds):
            rounds += 1
            changed = 0
            for p in self.passes:
                before = len(clone.global_block().ops)
                t0 = time.perf_counter()
                n = p.rewrite(clone, keep)
                dt = time.perf_counter() - t0
                after = len(clone.global_block().ops)
                stats[p.name] += n
                changed += n
                hits = getattr(p, "last_patterns", None)
                if hits:
                    for pat, c in hits.items():
                        patterns[pat] = patterns.get(pat, 0) + c
                _mon.on_transform(clone, p.name, before, after, dt,
                                  changes=n, patterns=hits)
            if not changed:
                break
        ops_after = len(clone.global_block().ops)
        clone._bump_version()
        clone._transform_meta = {
            "parent_version": program._version,
            "version": clone._version,
            "passes": dict(stats),
            "patterns": {k: v for k, v in patterns.items() if v},
            "ops_removed": ops_before - ops_after,
        }
        return TransformResult(clone, stats, ops_before, ops_after,
                               rounds, patterns=patterns)


def maybe_transform_for_build(program, fetch_names, device=None):
    """Armed-executor hook (flag ``transform``, PADDLE_TPU_TRANSFORM=1):
    called by ``Executor._build`` for every step it builds, so the
    transformed program runs while the caller's program stays what the
    Executor's keys name. Off (the default), one flag check.
    ``device`` is the Executor's: constant folding evaluates there.

    The transformed clone is MEMOIZED on the original program per
    (version, pass list, keep set, device): the port's Executor builds
    its step on every ``run()``, and the pipeline runs once (constant
    folding executes real lowerings). The latest clone's meta is also
    mirrored onto the original as ``_transform_applied`` so the
    monitor's compile classifier — which sees the CALLER's program —
    can attribute the compile to the transform.

    Host-op programs pass through untouched (their op identity is the
    execution order on the wire), as do programs already carrying a
    transform meta (idempotence)."""
    from .. import flags
    if not flags.get_flag("transform"):
        # drop any stale mirror: a disarmed compile builds the REAL
        # program, and must not keep classifying as transformed
        program.__dict__.pop("_transform_applied", None)
        return program
    if getattr(program, "_transform_meta", None) is not None:
        return program
    if any(registry.is_host_op(o.type)
           for o in program.global_block().ops):
        program.__dict__.pop("_transform_applied", None)
        return program
    passes = resolve_passes(flags.get_flag("transform_passes"), device)
    if not passes:
        program.__dict__.pop("_transform_applied", None)
        return program
    key = (program._version, tuple(p.name for p in passes),
           tuple(sorted(str(k) for k in fetch_names)), str(device))
    memo = program.__dict__.setdefault("_transform_builds", {})
    clone = memo.get(key)
    if clone is None:
        clone = PassManager(passes).run(program, keep=fetch_names).program
        if len(memo) >= 4:    # bound: each clone pins a whole program
            memo.clear()
        memo[key] = clone
    program._transform_applied = clone._transform_meta
    return clone


# --------------------------------------------------------------------------
# verify phase: the semantics-preservation contract, checked for real
# --------------------------------------------------------------------------

def _bitwise_equal(a, b):
    """Same type, dtype, shape and bytes (a LoDTensor also the same
    LoD; a tensor array element by element)."""
    from ..core.lod import LoDTensor
    if isinstance(a, LoDTensor) or isinstance(b, LoDTensor):
        if not (isinstance(a, LoDTensor) and isinstance(b, LoDTensor)):
            return False
        return a.lod == b.lod and _bitwise_equal(a.data, b.data)
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (isinstance(a, (list, tuple))
                and isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_bitwise_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        if not (isinstance(a, torch.Tensor)
                and isinstance(b, torch.Tensor)):
            return False
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype == torch.bfloat16:   # numpy holds no bfloat16
            a, b = a.view(torch.int16), b.view(torch.int16)
        a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def verify_bitwise(main, startup, feed_fn, fetch_names, transformed,
                   steps=2, seed=0, place=None):
    """Execute ``main`` and ``transformed`` from identical initial
    state and feeds for ``steps`` real Executor steps; every fetch of
    every step must be BITWISE-identical (dtype, shape, bytes).

    Both runs use fresh Executors (RNG counters at 0) over copies of
    one startup-initialized scope, so the only degree of freedom is the
    transform itself. ``place`` (a keyword the JAX package does not
    have) is where both run: ``CPUPlace()`` by default, a
    ``CUDAPlace`` for the card. Returns (ok, detail_str)."""
    from .. import core

    place = place if place is not None else core.CPUPlace()
    base = core.Scope()
    core.Executor(place).run(startup, scope=base)
    rng = np.random.RandomState(seed)
    feeds = [feed_fn(rng) for _ in range(steps)]
    names = [v.name for v in main.global_block().vars.values()
             if v.persistable]

    def fork():
        sc = core.Scope()
        for n in names:
            v = base.find_var(n)
            if isinstance(v, torch.Tensor):
                sc.set(n, v.clone())
            elif v is not None:
                sc.set(n, np.array(np.asarray(v)))
        return sc

    runs = []
    for prog in (main, transformed):
        exe = core.Executor(place)
        sc = fork()
        runs.append([exe.run(prog, feed=f, fetch_list=list(fetch_names),
                             scope=sc, return_numpy=False)
                     for f in feeds])
    for step, (ref, got) in enumerate(zip(*runs)):
        for name, a, b in zip(fetch_names, ref, got):
            if not _bitwise_equal(a, b):
                return False, (
                    "fetch %r diverged at step %d: %r vs %r"
                    % (name, step, a, b))
    return True, "ok"
