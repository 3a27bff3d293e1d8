"""Inference specialization: the Fluid deploy path
(``save_inference_model``: prune to the inference subgraph and emit a
servable artifact) on the pass framework.

The counterpart of ``paddle_tpu/transform/infer.py``.
``specialize_for_inference(program, feeds, fetches)`` carves the
inference subgraph (``Program.prune`` + ``clone(for_test=True)``) and
drives it through dead_op -> constant_fold -> cse -> fusion to a fixed
point, every pass bitwise-gated by ``verify_bitwise``. The opt-in
``bf16=True`` additionally runs ``Bf16CastPass``: matmul/conv/embedding
compute moves to bfloat16 while every op's OUTPUT is cast back to f32,
so softmax / layer-norm / batch-norm statistics and reductions always
accumulate in f32. bf16 is NOT bitwise: it is exempt from
``verify_bitwise`` and held to an rtol contract instead
(tests/test_torch_specialize.py), and it is off by default everywhere.

``io.save_inference_model`` runs this pipeline and serializes the
result; the artifact round trip (CRC manifest, fresh-process load)
lives in ``paddle_tpu_torch/io.py``.
"""

import collections

from ..core.program import Variable
from .passes import (PassManager, Pass, ConstantFoldPass, CSEPass,
                     DeadOpEliminationPass)
from .fusion import FusionPass

# compute ops whose float32 inputs move to bf16 under Bf16CastPass:
# op type -> (castable input slots, output slot). Ids / indices are
# never cast; every output is cast BACK to f32 (stats contract).
_BF16_SITES = {
    "mul": (("X", "Y"), "Out"),
    "matmul": (("X", "Y"), "Out"),
    "fused_matmul_bias_act": (("X", "Y", "Bias"), "Out"),
    "conv2d": (("Input", "Filter"), "Output"),
    "depthwise_conv2d": (("Input", "Filter"), "Output"),
    "lookup_table": (("W",), "Out"),
}


class Bf16CastPass(Pass):
    """Opt-in bf16 compute cast for inference programs.

    For every matmul-class op (see ``_BF16_SITES``) whose operands are
    float32: insert ``cast -> bfloat16`` on each operand, run the op in
    bf16 (the products accumulate in f32 in their lowerings), and cast
    the result straight back to float32 — downstream softmax /
    normalization / reduction math is f32-identical in structure to the
    unfused program (the f32-stats contract). Parameters consumed ONLY
    by cast sites
    flip their var dtype to bfloat16, so the saved artifact stores
    half-width weights and the inserted operand cast becomes an
    identity at load time.

    NOT semantics-preserving bitwise: matmul operands are rounded to
    bf16. Excluded from ``default_passes()``/'all'; selectable by name
    and via ``specialize_for_inference(bf16=True)``; gated by a pinned
    rtol contract, not ``verify_bitwise``."""

    name = "bf16_cast"
    doc = ("opt-in bf16 operand cast for matmul-class inference "
           "compute (f32 stats preserved; rtol-gated, not bitwise)")

    def rewrite(self, program, keep):
        gb = program.global_block()
        uses = collections.Counter()
        for op in gb.ops:
            for n in op.input_names:
                uses[n] += 1
        cast_in = {}        # source name -> casted name (dedup)
        rewrote = 0
        param_casts = collections.Counter()  # name -> rewritten uses
        new_ops = []

        def _var(name):
            return gb.vars.get(name)

        def _to_bf16(name):
            if name in cast_in:
                return cast_in[name]
            v = _var(name)
            casted = name + "@bf16"
            gb.vars[casted] = Variable(
                gb, name=casted, shape=v.shape, dtype="bfloat16",
                stop_gradient=True)
            new_ops.append(_mk_cast(gb, name, casted, "bfloat16"))
            cast_in[name] = casted
            return casted

        for op in gb.ops:
            site = _BF16_SITES.get(op.type)
            if site is None:
                new_ops.append(op)
                continue
            slots, out_slot = site
            out_names = op.output(out_slot)
            out_v = _var(out_names[0]) if len(out_names) == 1 else None
            eligible = out_v is not None and out_v.dtype == "float32" \
                and all(
                    len(op.input(s)) == 1
                    and _var(op.input(s)[0]) is not None
                    and _var(op.input(s)[0]).dtype == "float32"
                    for s in slots if op.input(s))
            if not eligible:
                new_ops.append(op)
                continue
            for s in slots:
                names = op.input(s)
                if not names:
                    continue
                src = names[0]
                op.inputs[s] = [_to_bf16(src)]
                v = _var(src)
                if v is not None and v.persistable:
                    param_casts[src] += 1
            out = out_names[0]
            raw = out + "@bf16raw"
            gb.vars[raw] = Variable(gb, name=raw, shape=out_v.shape,
                                    dtype="bfloat16",
                                    stop_gradient=True)
            op.outputs[out_slot] = [raw]
            new_ops.append(op)
            new_ops.append(_mk_cast(gb, raw, out, "float32"))
            rewrote += 1

        if not rewrote:
            return 0
        gb.ops = new_ops
        # params used ONLY at cast sites store bf16 in the artifact:
        # the operand cast is then an identity at load time and the
        # params blob halves
        for name, n in param_casts.items():
            if uses[name] == n:
                gb.vars[name].dtype = "bfloat16"
        program._bump_version()
        return rewrote


def _mk_cast(block, src, dst, out_dtype):
    from ..core.program import Operator
    return Operator(block, "cast", {"X": [src]}, {"Out": [dst]},
                    {"out_dtype": out_dtype})


class SpecializeResult:
    """specialize_for_inference output: the servable program + the
    accounting the artifact manifest records."""

    def __init__(self, program, feed_names, fetch_names, transform,
                 bf16, bf16_sites=0):
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.transform = transform        # TransformResult of the pipeline
        self.bf16 = bool(bf16)
        self.bf16_sites = int(bf16_sites)

    def to_dict(self):
        return {"feed_names": self.feed_names,
                "fetch_names": self.fetch_names,
                "bf16": self.bf16, "bf16_sites": self.bf16_sites,
                **self.transform.to_dict()}


def specialize_pipeline(device=None):
    """The inference pipeline, in order: carve first (prune happens
    before this), then drop dead chains, fold constants (on ``device``),
    dedup, fuse."""
    return [DeadOpEliminationPass(), ConstantFoldPass(device=device),
            CSEPass(), FusionPass()]


def specialize_for_inference(program, feeds, fetches, bf16=False,
                             device=None):
    """Prune ``program`` to the subgraph computing ``fetches`` from
    ``feeds``, clone in test mode (dropout/BN eval lowering), and run
    the optimizing pipeline to a fixed point. Returns a
    ``SpecializeResult`` whose ``.program`` a fresh process can execute
    with nothing but the feeds (the ``io.save_inference_model``
    payload).

    ``feeds``/``fetches`` are names or Variables. Every pass but the
    opt-in bf16 cast is bitwise-gated (tests pin the full zoo); bf16
    rounds matmul-class operands and is covered by an rtol contract.
    ``device`` (a keyword the JAX package does not have) is where
    constant folding evaluates: the device the program will run on."""
    feed_names = [v.name if isinstance(v, Variable) else str(v)
                  for v in feeds]
    fetch_names = [v.name if isinstance(v, Variable) else str(v)
                   for v in fetches]
    gb = program.global_block()
    for n in feed_names + fetch_names:
        if not gb.has_var(n):
            raise ValueError(
                "specialize_for_inference: %r is not a variable of the "
                "program's global block" % (n,))
    pruned = program.prune(fetch_names).clone(for_test=True)
    result = PassManager(specialize_pipeline(device)).run(pruned,
                                                    keep=fetch_names)
    prog = result.program
    sites = 0
    if bf16:
        sites = Bf16CastPass().rewrite(prog, fetch_names)
        if sites:
            prog._transform_meta = dict(prog._transform_meta or {})
            prog._transform_meta["bf16_sites"] = sites
            prog._transform_meta["version"] = prog._version
    return SpecializeResult(prog, feed_names, fetch_names, result,
                            bf16, sites)
