"""Pattern fusion over the Program IR.

The counterpart of ``paddle_tpu/transform/fusion.py``: the same
declarative peephole matcher, so a program fuses to the same ops in
both packages. It rewrites multi-op chains into the fused ops registered
in ``ops/fused.py`` (whose lowerings replay the exact component
lowerings: bitwise identity by construction, see that module),
eliminates inverse transpose/transpose and reshape/reshape chains
outright, and folds adjacent scale/cast pairs into one op.

Patterns (per-pattern hit counters land in ``TransformResult.patterns``
and the ``ptpu_transform_patterns_total{pattern}`` metric):

  matmul_bias_act      mul/matmul/conv2d + elementwise_add + activation
                       -> ONE fused_matmul_bias_act op (3 -> 1)
  matmul_bias          the same chain without the activation (2 -> 1)
  transpose_transpose  inverse perms cancel to nothing (the pair is
                       dropped and consumers read the original name);
                       non-inverse perms compose into ONE transpose
  reshape_reshape      a reshape of a reshape is the outer reshape
  scale_cast           adjacent scale/cast ops fold into ONE
                       fused_scale_cast applying both in order

Safety discipline (the non-SSA IR rules of ``passes.py``): only pure
ops participate; every intermediate must be single-def, single-consumer
and outside the keep/persistable/marker/sub-block protected set; every
chain input must be single-def (the replacement op evaluates at the
chain tail's position, so a redefinition in between would change what
it reads). RNG ops never match (their draw ordinals are pinned).
"""

import collections

from ..core.program import Operator
from ..ops.fused import FUSABLE_ANCHORS, fusable_act_types
from .passes import (Pass, is_side_effecting, op_inputs,
                     _marker_input_names, _subblock_needed,
                     _def_counts, _has_subblock)

_TRANSPOSES = ("transpose", "transpose2")
_RESHAPES = ("reshape", "reshape2")
_SCALE_CAST = ("scale", "cast")

PATTERN_NAMES = ("matmul_bias_act", "matmul_bias",
                 "transpose_transpose", "reshape_reshape", "scale_cast")


class _Ctx:
    """Shared match context for one rewrite sweep."""

    def __init__(self, gb, keep, program):
        self.gb = gb
        self.ops = list(gb.ops)
        self.persistable = {v.name for v in gb.vars.values()
                            if v.persistable}
        self.protected = (set(keep) | self.persistable
                          | _subblock_needed(program))
        for op in self.ops:
            self.protected.update(_marker_input_names(op))
        self.defs = _def_counts(gb)
        self.uses = collections.defaultdict(list)
        for idx, op in enumerate(self.ops):
            for n in op_inputs(op):
                self.uses[n].append(idx)
        self.taken = set()
        self.dropped = set()
        self.replaced = {}      # index -> replacement Operator
        self.rename = {}
        self.hits = collections.OrderedDict(
            (p, 0) for p in PATTERN_NAMES)
        self._removed = 0

    def pure(self, op):
        return not (is_side_effecting(op, self.persistable)
                    or _has_subblock(op))

    def single_out(self, op):
        outs = op.output_names
        if len(outs) == 1 and self.defs[outs[0]] == 1:
            return outs[0]
        return None

    def single_consumer(self, name, after):
        """Index of the one op consuming ``name`` (one occurrence
        total), or None."""
        idxs = self.uses.get(name, [])
        if len(idxs) != 1 or idxs[0] <= after:
            return None
        return idxs[0]

    def inputs_stable(self, names):
        """True when every input name is defined at most once — the
        replacement evaluates at the chain tail, so any name redefined
        between head and tail would be read at the wrong generation."""
        return all(self.defs[n] <= 1 for n in names)

    def claim(self, pattern, drop, replacement_at=None, replacement=None,
              removed=None):
        self.taken.update(drop)
        if replacement_at is None:
            self.dropped.update(drop)
        else:
            self.taken.add(replacement_at)
            self.replaced[replacement_at] = replacement
            self.dropped.update(i for i in drop if i != replacement_at)
        self.hits[pattern] += 1
        self._removed += removed if removed is not None else len(drop)


def _match_matmul_bias_act(ctx, i):
    op = ctx.ops[i]
    if op.type not in FUSABLE_ANCHORS or not ctx.pure(op):
        return False
    o0 = ctx.single_out(op)
    if o0 is None or o0 in ctx.protected:
        return False
    j = ctx.single_consumer(o0, i)
    if j is None or j in ctx.taken:
        return False
    add = ctx.ops[j]
    if add.type != "elementwise_add" or not ctx.pure(add):
        return False
    if add.input("X") != [o0] or o0 in add.input("Y"):
        return False
    o1 = ctx.single_out(add)
    if o1 is None:
        return False
    lhs_slot, rhs_slot, _ = FUSABLE_ANCHORS[op.type]
    chain_inputs = (op.input(lhs_slot) + op.input(rhs_slot)
                    + add.input("Y"))
    if len(op.input(lhs_slot)) != 1 or len(op.input(rhs_slot)) != 1 \
            or len(add.input("Y")) != 1:
        return False
    if not ctx.inputs_stable(chain_inputs):
        return False

    act_idx, act = None, None
    if o1 not in ctx.protected:
        k = ctx.single_consumer(o1, j)
        if k is not None and k not in ctx.taken:
            cand = ctx.ops[k]
            if cand.type in fusable_act_types() and ctx.pure(cand) \
                    and cand.input("X") == [o1]:
                o2 = ctx.single_out(cand)
                if o2 is not None:
                    act_idx, act = k, cand

    final = act.output("Out")[0] if act is not None else o1
    tail = act_idx if act is not None else j
    fused = Operator(
        ctx.gb, "fused_matmul_bias_act",
        {"X": op.input(lhs_slot), "Y": op.input(rhs_slot),
         "Bias": add.input("Y")},
        {"Out": [final]},
        {"mm_type": op.type, "mm_attrs": dict(op.attrs),
         "add_attrs": dict(add.attrs),
         "act_type": act.type if act is not None else "",
         "act_attrs": dict(act.attrs) if act is not None else {}})
    drop = {i, j} | ({act_idx} if act_idx is not None else set())
    ctx.claim("matmul_bias_act" if act is not None else "matmul_bias",
              drop, replacement_at=tail, replacement=fused,
              removed=len(drop) - 1)
    return True


def _pair_head(ctx, i, types):
    """Shared head of the two-op patterns: pure op of ``types`` whose
    single unprotected output feeds exactly one pure consumer of
    ``types``. Returns (op, o0, j, op2, o1) or None."""
    op = ctx.ops[i]
    if op.type not in types or not ctx.pure(op):
        return None
    o0 = ctx.single_out(op)
    if o0 is None or o0 in ctx.protected:
        return None
    j = ctx.single_consumer(o0, i)
    if j is None or j in ctx.taken:
        return None
    op2 = ctx.ops[j]
    if op2.type not in types or not ctx.pure(op2):
        return None
    if op2.input("X") != [o0]:
        return None
    o1 = ctx.single_out(op2)
    if o1 is None:
        return None
    x = op.input("X")
    if len(x) != 1 or not ctx.inputs_stable(x):
        return None
    return op, o0, j, op2, o1


def _match_transpose_transpose(ctx, i):
    m = _pair_head(ctx, i, _TRANSPOSES)
    if m is None:
        return False
    op, o0, j, op2, o1 = m
    p1, p2 = op.attr("axis"), op2.attr("axis")
    if not p1 or not p2 or len(p1) != len(p2):
        return False
    composed = [p1[p2[a]] for a in range(len(p2))]
    x = op.input("X")[0]
    if composed == list(range(len(composed))):
        if o1 in ctx.protected:
            # the name must still hold a value at fetch time: keep ONE
            # op (a passthrough assign) instead of the pair
            rep = Operator(ctx.gb, "assign", {"X": [x]}, {"Out": [o1]},
                           {})
            ctx.claim("transpose_transpose", {i, j}, replacement_at=j,
                      replacement=rep, removed=1)
        else:
            ctx.rename[o1] = ctx.rename.get(x, x)
            ctx.claim("transpose_transpose", {i, j}, removed=2)
        return True
    rep = Operator(ctx.gb, op2.type, {"X": [x]}, {"Out": [o1]},
                   {"axis": composed})
    ctx.claim("transpose_transpose", {i, j}, replacement_at=j,
              replacement=rep, removed=1)
    return True


def _match_reshape_reshape(ctx, i):
    m = _pair_head(ctx, i, _RESHAPES)
    if m is None:
        return False
    op, o0, j, op2, o1 = m
    shape = op2.attr("shape")
    # a 0 entry copies the INTERMEDIATE's dim at that position — it
    # would resolve differently against the original input
    if not shape or any(int(s) == 0 for s in shape):
        return False
    rep = Operator(ctx.gb, op2.type, {"X": op.input("X")},
                   {"Out": [o1]}, dict(op2.attrs))
    ctx.claim("reshape_reshape", {i, j}, replacement_at=j,
              replacement=rep, removed=1)
    return True


def _match_scale_cast(ctx, i):
    m = _pair_head(ctx, i, _SCALE_CAST)
    if m is None:
        return False
    op, o0, j, op2, o1 = m
    rep = Operator(
        ctx.gb, "fused_scale_cast", {"X": op.input("X")},
        {"Out": [o1]},
        {"ops": [[op.type, dict(op.attrs)],
                 [op2.type, dict(op2.attrs)]]})
    ctx.claim("scale_cast", {i, j}, replacement_at=j, replacement=rep,
              removed=1)
    return True


_MATCHERS = (_match_matmul_bias_act, _match_transpose_transpose,
             _match_reshape_reshape, _match_scale_cast)


class FusionPass(Pass):
    """Declarative pattern fusion. One linear sweep per rewrite call;
    the PassManager's fixed-point loop composes longer chains (e.g. a
    scale/cast triple folds over two rounds). ``last_patterns`` holds
    the per-pattern hit counts of the most recent rewrite."""

    name = "fusion"
    doc = ("pattern fusion: matmul+bias+act -> fused op, inverse "
           "transpose/reshape chains, scale/cast pairs")

    def __init__(self):
        self.last_patterns = collections.OrderedDict(
            (p, 0) for p in PATTERN_NAMES)

    def rewrite(self, program, keep):
        gb = program.global_block()
        ctx = _Ctx(gb, keep, program)
        for i in range(len(ctx.ops)):
            if i in ctx.taken:
                continue
            for match in _MATCHERS:
                if match(ctx, i):
                    break
        self.last_patterns = ctx.hits
        if not ctx._removed:
            return 0
        new_ops = []
        for idx, op in enumerate(ctx.ops):
            if idx in ctx.dropped:
                continue
            out = ctx.replaced.get(idx, op)
            if ctx.rename:
                for slot, names in out.inputs.items():
                    out.inputs[slot] = [ctx.rename.get(n, n)
                                        for n in names]
            new_ops.append(out)
        gb.ops = new_ops
        program._bump_version()
        return ctx._removed
