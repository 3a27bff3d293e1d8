"""Program IR: the serializable graph a user script builds.

The counterpart of ``paddle_tpu/core/program.py``, kept line for line so
the two packages build the same graphs: a ``Program`` is a list of
``Block``s; each block holds typed ``Variable``s and an ordered list of
``Operator``s whose attrs may reference sub-blocks (control flow).

Programs are the interchange between the two packages:
``Program.to_json`` / ``Program.from_json`` are byte-compatible with the
JAX package's, so a Program built by either loads in the other. The IR is
numpy-only; the Executor (core/executor.py) runs it op by op on torch
tensors, resolving ``-1`` batch dims from the feed.
"""

import copy
import json

import numpy as np

from . import unique_name

# --------------------------------------------------------------------------
# dtype handling
# --------------------------------------------------------------------------

_CANON_DTYPES = {
    "float32", "float64", "float16", "bfloat16",
    "int8", "int16", "int32", "int64",
    "uint8", "bool",
}

_ALIASES = {
    "float": "float32", "double": "float64", "half": "float16",
    "int": "int32", "long": "int64",
    "fp32": "float32", "fp64": "float64", "fp16": "float16",
    "bf16": "bfloat16",
}


def convert_dtype(dtype):
    """Normalize any dtype spec (str/np/torch) to a canonical string."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        d = _ALIASES.get(dtype, dtype)
        if d in _CANON_DTYPES:
            return d
        raise ValueError("unsupported dtype %r" % (dtype,))
    if str(dtype).startswith("torch."):          # a torch.dtype
        name = str(dtype)[len("torch."):]
    else:                                        # numpy dtype objects
        name = np.dtype(dtype).name if not hasattr(dtype, "name") \
            else dtype.name
    name = _ALIASES.get(name, name)
    if name in _CANON_DTYPES:
        return name
    raise ValueError("unsupported dtype %r" % (dtype,))


_X64_NARROW = {"int64": "int32", "uint64": "uint32", "float64": "float32"}


def runtime_dtype(dtype):
    """convert_dtype + narrowing of 64-bit types to 32-bit, always: the
    JAX package narrows them whenever JAX's x64 mode is off (its
    default), and the port holds the same values so the two packages
    compute alike."""
    name = convert_dtype(dtype)
    return _X64_NARROW.get(name, name)


class VarType:
    """Variable kinds — parity with framework.proto VarType (19 kinds; we keep
    the ones with runtime meaning on TPU)."""

    LOD_TENSOR = "lod_tensor"
    SELECTED_ROWS = "selected_rows"   # sparse rows grad format (embeddings)
    LOD_TENSOR_ARRAY = "tensor_array"
    READER = "reader"
    STEP_SCOPES = "step_scopes"
    RAW = "raw"


# --------------------------------------------------------------------------
# Variable / Parameter
# --------------------------------------------------------------------------

class Variable:
    """A typed symbolic value in a Block.

    Mirrors python/paddle/fluid/framework.py:117 Variable: name, shape, dtype,
    lod_level, persistable, stop_gradient. Arithmetic sugar (``x + y`` etc.) is
    provided so layer code reads naturally.
    """

    def __init__(self, block, name=None, shape=None, dtype="float32",
                 lod_level=0, persistable=False, stop_gradient=False,
                 type=VarType.LOD_TENSOR, initializer=None, is_data=False,
                 **kwargs):
        self.block = block
        self.name = name or unique_name.generate("_generated_var")
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = type
        self.initializer = initializer    # callable(shape, dtype, rng) -> np/jnp
        self.is_data = is_data
        self.error_clip = kwargs.get("error_clip")

    # -- info ---------------------------------------------------------------
    @property
    def program(self):
        return self.block.program

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "type": self.type,
            "is_data": self.is_data,
            "is_parameter": isinstance(self, Parameter),
            "trainable": getattr(self, "trainable", False),
        }

    def __repr__(self):
        return "Var(%s, shape=%s, dtype=%s%s)" % (
            self.name, self.shape, self.dtype,
            ", persistable" if self.persistable else "")

    __str__ = __repr__

    # -- operator sugar ------------------------------------------------------
    def _elementwise(self, other, op, reverse=False):
        from ..layers import math_ops
        return math_ops.elementwise_binary(self, other, op, reverse)

    def __add__(self, o):  return self._elementwise(o, "elementwise_add")
    def __radd__(self, o): return self._elementwise(o, "elementwise_add", True)
    def __sub__(self, o):  return self._elementwise(o, "elementwise_sub")
    def __rsub__(self, o): return self._elementwise(o, "elementwise_sub", True)
    def __mul__(self, o):  return self._elementwise(o, "elementwise_mul")
    def __rmul__(self, o): return self._elementwise(o, "elementwise_mul", True)
    def __truediv__(self, o):  return self._elementwise(o, "elementwise_div")
    def __rtruediv__(self, o): return self._elementwise(o, "elementwise_div", True)
    def __pow__(self, o):  return self._elementwise(o, "elementwise_pow")
    def __rpow__(self, o): return self._elementwise(o, "elementwise_pow", True)
    def __neg__(self):
        from ..layers import math_ops
        return math_ops.scale_var(self, -1.0)
    def __lt__(self, o):  return self._elementwise(o, "less_than")
    def __le__(self, o):  return self._elementwise(o, "less_equal")
    def __gt__(self, o):  return self._elementwise(o, "greater_than")
    def __ge__(self, o):  return self._elementwise(o, "greater_equal")

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)

    def astype(self, dtype):
        from ..layers import tensor as tensor_layers
        return tensor_layers.cast(self, dtype)


class Parameter(Variable):
    """A persistable, trainable Variable with optimizer metadata
    (framework.py Parameter)."""

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)


# --------------------------------------------------------------------------
# Operator
# --------------------------------------------------------------------------

class Operator:
    """One op node: type + named input/output slots (each a list of var names)
    + attrs. Mirrors OpDesc (framework.proto:34) / framework.py:361."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {k: _as_name_list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: _as_name_list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_names(self):
        return [n for v in self.inputs.values() for n in v]

    @property
    def output_names(self):
        return [n for v in self.outputs.values() for n in v]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def set_attr(self, name, val):
        self.attrs[name] = val
        self.block.program._bump_version()

    def to_dict(self):
        attrs = {}
        for k, v in self.attrs.items():
            if isinstance(v, Block):
                attrs[k] = {"__block__": v.idx}
            elif isinstance(v, np.ndarray):
                attrs[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            else:
                attrs[k] = v
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs, "attrs": attrs}

    def __repr__(self):
        return "Op(%s: %s -> %s)" % (self.type, self.inputs, self.outputs)


def _as_name_list(v):
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [x.name if isinstance(x, Variable) else str(x) for x in v]
    return [v.name if isinstance(v, Variable) else str(v)]


# --------------------------------------------------------------------------
# Block
# --------------------------------------------------------------------------

class Block:
    """Scope of variables + ordered ops; sub-blocks implement control flow
    (framework.py:658)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}          # name -> Variable
        self.ops = []           # ordered Operators

    # -- vars ---------------------------------------------------------------
    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def create_var(self, **kwargs):
        name = kwargs.get("name")
        if name and name in self.vars:
            return self.vars[name]
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        self.program._bump_version()
        return var

    def create_parameter(self, shape, dtype, **kwargs):
        # Parameters always live in the root (global) block, like the reference
        # (framework.py Block.create_parameter → global_block).
        gb = self.program.global_block()
        name = kwargs.get("name")
        if name and name in gb.vars:
            return gb.vars[name]
        p = Parameter(gb, shape=shape, dtype=dtype, **kwargs)
        gb.vars[p.name] = p
        self.program._bump_version()
        return p

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise KeyError("variable %r not in block %d" % (name, self.idx))
        return v

    def has_var(self, name):
        return name in self.vars

    def _find_var_recursive(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- ops ----------------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._bump_version()
        _infer_shape(self, op)
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._bump_version()
        return op

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": {n: v.to_dict() for n, v in self.vars.items()},
            "ops": [op.to_dict() for op in self.ops],
        }

    def __repr__(self):
        return "Block(%d, %d vars, %d ops)" % (
            self.idx, len(self.vars), len(self.ops))


def _infer_shape(block, op):
    """Compile-time shape inference via the op registry (parity with
    CompileTimeInferShapeContext, op_desc.cc). A registered infer_shape that
    fails raises an enforce-style error with the op's declared context —
    never swallowed (lowering-time errors get the same treatment in
    core/executor._lower_op)."""
    from . import registry
    from .enforce import op_error
    info = registry.lookup(op.type)
    if info is None or info.infer_shape is None:
        return
    try:
        info.infer_shape(block, op)
    except Exception as e:
        # pass Variables (shape+dtype attrs) so op_error prints real dims,
        # not a bare tuple's "list[rank]" rendering
        raise op_error(op, dict(block.vars), e, phase="shape inference") \
            from e


# --------------------------------------------------------------------------
# Program
# --------------------------------------------------------------------------

class Program:
    """A whole trainable program: blocks[0] is global (framework.py ~890).

    ``_version`` increments on every mutation; the Executor's compiled-step
    cache keys on it (replacement for executor.py:165's program cache).
    """

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self._current_block_idx = 0
        self.random_seed = 0
        self._version = 0
        # metadata used by append_backward / optimizers / transpilers
        self._loss_name = None
        self._sharding_hints = {}   # var name -> PartitionSpec-like tuple

    # -- structure -----------------------------------------------------------
    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self._current_block_idx]

    def create_block(self, parent_idx=None):
        parent = self._current_block_idx if parent_idx is None else parent_idx
        blk = Block(self, len(self.blocks), parent)
        self.blocks.append(blk)
        self._current_block_idx = blk.idx
        self._bump_version()
        return blk

    def rollback(self):
        self._current_block_idx = self.current_block().parent_idx

    def _bump_version(self):
        self._version += 1

    @property
    def num_blocks(self):
        return len(self.blocks)

    def all_parameters(self):
        return self.global_block().all_parameters()

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    # -- clone / prune -------------------------------------------------------
    def clone(self, for_test=False):
        """Deep copy. With for_test=True, marks the clone as inference-mode:
        ops like dropout/batch_norm lower in eval mode (parity with
        framework.py Program.clone)."""
        p = Program.__new__(Program)
        p.blocks = []
        p._current_block_idx = self._current_block_idx
        p.random_seed = self.random_seed
        p._version = self._version
        p._loss_name = self._loss_name
        p._sharding_hints = dict(self._sharding_hints)
        for blk in self.blocks:
            nb = Block(p, blk.idx, blk.parent_idx)
            for name, v in blk.vars.items():
                cls = Parameter if isinstance(v, Parameter) else Variable
                nv = cls.__new__(cls)
                nv.__dict__.update(v.__dict__)
                nv.block = nb
                nb.vars[name] = nv
            for op in blk.ops:
                nop = Operator(nb, op.type, None, None, None)
                nop.inputs = {k: list(vv) for k, vv in op.inputs.items()}
                nop.outputs = {k: list(vv) for k, vv in op.outputs.items()}
                nop.attrs = copy.copy(op.attrs)
                if for_test and "is_test" in _TEST_MODE_OPS.get(op.type, ()):
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
            p.blocks.append(nb)
        # fix sub-block attr refs to point into the clone
        for blk in p.blocks:
            for op in blk.ops:
                for k, v in list(op.attrs.items()):
                    if isinstance(v, Block):
                        op.attrs[k] = p.block(v.idx)
        if for_test:
            p._bump_version()
        return p

    def prune(self, targets):
        """Backward-slice the global block to the ops needed for `targets`
        (parity with framework/prune.cc)."""
        target_names = {t.name if isinstance(t, Variable) else t
                        for t in targets}
        gb = self.global_block()
        needed = set(target_names)
        keep = []
        for op in reversed(gb.ops):
            if set(op.output_names) & needed or op.type in ("feed", "fetch"):
                keep.append(op)
                needed |= set(op.input_names)
        keep.reverse()
        pruned = self.clone()
        pgb = pruned.global_block()
        keep_ids = {id(op) for op in keep}
        src_ids = [id(op) for op in gb.ops]
        pgb.ops = [pop for sop_id, pop in zip(src_ids, list(pgb.ops))
                   if sop_id in keep_ids]
        pruned._bump_version()
        return pruned

    # -- serialization -------------------------------------------------------
    def to_dict(self):
        return {
            "version": 1,
            "random_seed": self.random_seed,
            "loss_name": self._loss_name,
            "blocks": [b.to_dict() for b in self.blocks],
        }

    def to_json(self):
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d):
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        p._loss_name = d.get("loss_name")
        p.blocks = []
        for bd in d["blocks"]:
            blk = Block(p, bd["idx"], bd["parent_idx"])
            for name, vd in bd["vars"].items():
                cls = Parameter if vd.get("is_parameter") else Variable
                v = cls.__new__(cls)
                v.block = blk
                v.name = vd["name"]
                v.shape = tuple(vd["shape"]) if vd["shape"] is not None else None
                v.dtype = vd["dtype"]
                v.lod_level = vd.get("lod_level", 0)
                v.persistable = vd.get("persistable", False)
                v.stop_gradient = vd.get("stop_gradient", False)
                v.type = vd.get("type", VarType.LOD_TENSOR)
                v.initializer = None
                v.is_data = vd.get("is_data", False)
                v.error_clip = None
                if vd.get("is_parameter"):
                    v.trainable = vd.get("trainable", True)
                    v.optimize_attr = {"learning_rate": 1.0}
                    v.regularizer = None
                    v.gradient_clip_attr = None
                    v.do_model_average = None
                blk.vars[name] = v
            p.blocks.append(blk)
        for bd, blk in zip(d["blocks"], p.blocks):
            for od in bd["ops"]:
                attrs = {}
                for k, v in od["attrs"].items():
                    if isinstance(v, dict) and "__block__" in v:
                        attrs[k] = p.block(v["__block__"])
                    elif isinstance(v, dict) and "__ndarray__" in v:
                        attrs[k] = np.array(v["__ndarray__"], dtype=v["dtype"])
                    else:
                        attrs[k] = v
                op = Operator(blk, od["type"], od["inputs"], od["outputs"],
                              attrs)
                blk.ops.append(op)
        p._bump_version()
        return p

    @staticmethod
    def from_json(s):
        return Program.from_dict(json.loads(s))

    def to_string(self, throw_on_error=False):
        lines = []
        for blk in self.blocks:
            lines.append("block %d (parent %d):" % (blk.idx, blk.parent_idx))
            for v in blk.vars.values():
                lines.append("  " + repr(v))
            for op in blk.ops:
                lines.append("  " + repr(op))
        return "\n".join(lines)

    def __repr__(self):
        return "Program(%d blocks, %d ops)" % (
            len(self.blocks), sum(len(b.ops) for b in self.blocks))


# Ops whose lowering changes between train and eval; used by clone(for_test).
_TEST_MODE_OPS = {
    "dropout": ("is_test",),
    "batch_norm": ("is_test",),
}


# --------------------------------------------------------------------------
# default programs + guards (framework.py program_guard etc.)
# --------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


def switch_main_program(program):
    global _main_program
    old, _main_program = _main_program, program
    return old


def switch_startup_program(program):
    global _startup_program
    old, _startup_program = _startup_program, program
    return old


class program_guard:
    def __init__(self, main_program, startup_program=None):
        self.main = main_program
        self.startup = startup_program

    def __enter__(self):
        self.old_main = switch_main_program(self.main)
        if self.startup is not None:
            self.old_startup = switch_startup_program(self.startup)
        return self

    def __exit__(self, *exc):
        switch_main_program(self.old_main)
        if self.startup is not None:
            switch_startup_program(self.old_startup)
        return False
