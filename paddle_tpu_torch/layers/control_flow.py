"""Control-flow layer DSL.

The counterpart of ``paddle_tpu/layers/control_flow.py`` (a copy, so the
two packages build the same Programs): While, StaticRNN, DynamicRNN,
IfElse, Switch, increment, the tensor arrays (create_array,
array_read/array_write/array_length), less_than, lod_rank_table,
max_sequence_len, zeros_like and ``recompute`` regions. The RNN builders
emit one ``recurrent`` op (a loop over the time axis with masked carry,
differentiable); IfElse computes both branches over the whole batch and
merges rows by mask; Switch builds a select chain. ``ops/control_flow.py``
lowers them.
"""


from .layer_helper import LayerHelper
from .tensor import cast
from ..core import unique_name
from ..core.program import default_main_program

__all__ = ["While", "StaticRNN", "DynamicRNN", "IfElse", "Switch",
           "increment", "array_read", "array_write", "array_length",
           "less_than", "equal", "lod_rank_table", "max_sequence_len",
           "create_array", "zeros_like", "recompute"]


from .tensor import increment  # noqa: F401  (single implementation)


from .ops import equal, less_than  # noqa: F401  (single implementation)


def create_array(dtype):
    helper = LayerHelper("array")
    return helper.create_variable(
        name=unique_name.generate("array"), dtype=dtype,
        type="tensor_array")


def array_write(x, i, array=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    helper.append_op(type="write_to_array",
                     inputs={"X": [x], "I": [i]}, outputs={"Out": [array]})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op(type="read_from_array",
                     inputs={"X": [array], "I": [i]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int64", shape=(1,))
    helper.append_op(type="lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


def lod_rank_table(x, level=0):
    helper = LayerHelper("lod_rank_table")
    out = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="lod_rank_table", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"level": level})
    return out


def max_sequence_len(rank_table):
    helper = LayerHelper("max_sequence_len")
    out = helper.create_variable_for_type_inference("int64", shape=(1,))
    helper.append_op(type="max_sequence_len",
                     inputs={"RankTable": [rank_table]},
                     outputs={"Out": [out]})
    return out


def zeros_like(x):
    helper = LayerHelper("zeros_like")
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


class BlockGuard:
    def __init__(self, program):
        self.program = program

    def __enter__(self):
        self.program.create_block()
        return self

    def __exit__(self, *exc):
        self.program.rollback()
        return False


class recompute(BlockGuard):
    """Rematerialization region (``with layers.recompute(): ...``): ops
    built inside the block re-run during the backward pass instead of
    storing their activations. Wrap each transformer layer to train
    longer sequences or bigger batches in the same device memory at
    about 1/3 extra forward work. Fetch intermediates OUTSIDE a region:
    only what later ops, the persistables and the fetch list read leaves
    it."""

    def __init__(self):
        super().__init__(default_main_program())

    def __exit__(self, *exc):
        program = self.program
        sub_block = program.current_block()
        super().__exit__(*exc)
        if exc[0] is None:
            # record the region's external reads and writes as REAL op
            # inputs/outputs so every name-based dependency scan (later
            # recompute regions, prune) sees them
            reads, created = [], set()
            for o in sub_block.ops:
                for ns in o.inputs.values():
                    reads.extend(n for n in ns if n not in created)
                for ns in o.outputs.values():
                    created.update(ns)
            program.current_block().append_op(
                type="recompute_block",
                inputs={"X": list(dict.fromkeys(reads))},
                outputs={"Out": sorted(created)},
                attrs={"sub_block": sub_block})
        return False


class While:
    """fluid.layers.While parity: iterate a block while cond holds.

    Loop-carried vars must be declared via ``loop_vars`` (the reference
    discovers them from scope writes; explicit is required here because the
    compiled loop needs a static carry structure).
    """

    def __init__(self, cond, loop_vars=None, name=None, max_iters=None):
        self.cond_var = cond
        self.loop_vars = list(loop_vars or [])
        self.max_iters = max_iters
        self.helper = LayerHelper("while", name=name)

    def block(self):
        return _WhileBlock(self)


class _WhileBlock(BlockGuard):
    def __init__(self, while_op):
        super().__init__(default_main_program())
        self.w = while_op

    def __enter__(self):
        super().__enter__()
        return self

    def __exit__(self, *exc):
        program = self.program
        sub_block = program.current_block()
        super().__exit__(*exc)
        if exc[0] is None:
            parent = program.current_block()
            parent.append_op(
                type="while",
                inputs={"Condition": [self.w.cond_var]},
                outputs={"Out": [v.name for v in self.w.loop_vars]},
                attrs={"sub_block": sub_block,
                       "carry_names": [v.name for v in self.w.loop_vars],
                       "max_iters": self.w.max_iters})
        return False


class StaticRNN:
    """fluid.layers.StaticRNN parity: step over the 0th (time) axis of
    time-major [T, B, ...] inputs. Emits one `recurrent` op."""

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._program = None
        self._sub_block = None
        self._step_inputs = []      # (outer var, inner var)
        self._memories = []         # (boot var, inner var, update inner name)
        self._outputs = []          # (inner var, outer var)
        self._in_step = False

    class _Step(BlockGuard):
        def __init__(self, rnn):
            super().__init__(default_main_program())
            self.rnn = rnn

        def __enter__(self):
            super().__enter__()
            self.rnn._in_step = True
            self.rnn._program = self.program
            self.rnn._sub_block = self.program.current_block()
            return self

        def __exit__(self, *exc):
            self.rnn._in_step = False
            super().__exit__(*exc)
            if exc[0] is None:
                self.rnn._complete()
            return False

    def step(self):
        return StaticRNN._Step(self)

    def _assert_in_step(self):
        if not self._in_step:
            raise ValueError("must be called inside rnn.step() block")

    def step_input(self, x):
        self._assert_in_step()
        blk = self._sub_block
        inner = blk.create_var(
            name=unique_name.generate("rnn_step_in"), dtype=x.dtype,
            shape=tuple(x.shape[1:]) if x.shape else None)
        self._step_inputs.append((x, inner))
        return inner

    def memory(self, init=None, shape=None, batch_ref=None, value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=1, init_value=None):
        self._assert_in_step()
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory needs init var or shape+batch_ref")
            parent = self._program.block(self._sub_block.parent_idx)
            # batch_ref may be an inner step var — the boot op lives in the
            # parent block, so reference the outer sequence var instead
            # (its dim 1 is the batch of the time-major [T, B, ...] input)
            ref, ref_dim = batch_ref, ref_batch_dim_idx
            for outer, inner in self._step_inputs:
                if inner is batch_ref:
                    ref, ref_dim = outer, 1
                    break
            # the carry keeps one dtype from step to step, so the boot
            # value follows the reference input's
            mem_dtype = getattr(batch_ref, "dtype", "float32") or "float32"
            init = parent.create_var(
                name=unique_name.generate("rnn_mem_boot"), dtype=mem_dtype,
                shape=tuple(shape))
            parent.append_op(
                type="fill_constant_batch_size_like",
                inputs={"Input": [ref]}, outputs={"Out": [init]},
                attrs={"shape": [-1] + list(shape[1:] if len(shape) > 1
                                            else shape),
                       "value": float(init_value
                                      if init_value is not None else value),
                       "dtype": mem_dtype,
                       "input_dim_idx": ref_dim,
                       "output_dim_idx": init_batch_dim_idx})
        inner = self._sub_block.create_var(
            name=unique_name.generate("rnn_mem"), dtype=init.dtype,
            shape=init.shape)
        self._memories.append([init, inner, None])
        return inner

    def update_memory(self, mem, var):
        self._assert_in_step()
        for m in self._memories:
            if m[1] is mem:
                m[2] = var.name
                return
        raise ValueError("update_memory on unknown memory %r" % mem.name)

    def step_output(self, o):
        self._assert_in_step()
        outer = self._program.block(self._sub_block.parent_idx).create_var(
            name=unique_name.generate("rnn_out"), dtype=o.dtype)
        self._outputs.append((o, outer))

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete(self):
        for m in self._memories:
            if m[2] is None:
                raise ValueError("memory %r never updated" % m[1].name)
        parent = self._program.current_block()
        final_states = [
            parent.create_var(name=unique_name.generate("rnn_final"),
                              dtype=m[0].dtype) for m in self._memories]
        parent.append_op(
            type="recurrent",
            inputs={"inputs": [x.name for x, _ in self._step_inputs],
                    "initial_states": [m[0].name for m in self._memories]},
            outputs={"outputs": [outer.name for _, outer in self._outputs],
                     "final_states": [v.name for v in final_states]},
            attrs={"sub_block": self._sub_block,
                   "inner_input_names": [i.name for _, i in
                                         self._step_inputs],
                   "inner_state_names": [m[1].name for m in self._memories],
                   "inner_state_out_names": [m[2] for m in self._memories],
                   "inner_output_names": [o.name for o, _ in self._outputs],
                   "time_major": True, "reverse": False})

    def __call__(self):
        outs = [outer for _, outer in self._outputs]
        return outs[0] if len(outs) == 1 else outs


class DynamicRNN:
    """fluid.layers.DynamicRNN parity over flat-LoD inputs.

    The reference sorts sequences by length (lod_rank_table), buckets
    timesteps and shrinks the live batch as sequences end. The static-shape
    equivalent: pad inside the graph, scan with per-sequence length masks
    (state freezes once a sequence ends), unpad back to flat LoD.
    """

    BEFORE_RNN = 0
    IN_RNN = 1
    AFTER_RNN = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self.status = DynamicRNN.BEFORE_RNN
        self._program = None
        self._sub_block = None
        self._step_inputs = []      # (padded outer var, inner var)
        self._memories = []
        self._outputs = []
        self._lens_var = None
        self._src_lod_var = None

    class _Block(BlockGuard):
        def __init__(self, rnn):
            super().__init__(default_main_program())
            self.rnn = rnn

        def __enter__(self):
            super().__enter__()
            self.rnn.status = DynamicRNN.IN_RNN
            self.rnn._program = self.program
            self.rnn._sub_block = self.program.current_block()
            return self

        def __exit__(self, *exc):
            self.rnn.status = DynamicRNN.AFTER_RNN
            super().__exit__(*exc)
            if exc[0] is None:
                self.rnn._complete()
            return False

    def block(self):
        return DynamicRNN._Block(self)

    def step_input(self, x, level=0):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError("step_input must be called inside block()")
        parent = self._program.block(self._sub_block.parent_idx)
        # pad flat LoD [T,D] -> [B,Tmax,D] in the parent block
        from .sequence_layers import sequence_pad
        # sequence_pad appends to the *current* block; temporarily switch
        cur = self._program._current_block_idx
        self._program._current_block_idx = parent.idx
        try:
            padded, lens = sequence_pad(x)
        finally:
            self._program._current_block_idx = cur
        if self._lens_var is None:
            self._lens_var = lens
            self._src_lod_var = x
        inner = self._sub_block.create_var(
            name=unique_name.generate("drnn_step_in"), dtype=x.dtype,
            shape=(None if x.shape is None else (-1,) + tuple(x.shape[1:])))
        self._step_inputs.append((padded, inner))
        return inner

    def memory(self, init=None, shape=None, value=0.0, dtype="float32",
               need_reorder=False):
        if self.status != DynamicRNN.IN_RNN:
            raise ValueError("memory must be called inside block()")
        if init is None:
            if shape is None:
                raise ValueError("memory needs init or shape")
            if not self._step_inputs:
                raise ValueError("declare step_input before value memories")
            parent = self._program.block(self._sub_block.parent_idx)
            ref = self._step_inputs[0][0]   # padded [B,T,D]
            init = parent.create_var(
                name=unique_name.generate("drnn_mem_boot"), dtype=dtype,
                shape=(-1,) + tuple(shape))
            parent.append_op(
                type="fill_constant_batch_size_like",
                inputs={"Input": [ref]}, outputs={"Out": [init]},
                attrs={"shape": [-1] + list(shape), "value": float(value),
                       "dtype": dtype, "input_dim_idx": 0,
                       "output_dim_idx": 0})
        inner = self._sub_block.create_var(
            name=unique_name.generate("drnn_mem"), dtype=init.dtype,
            shape=init.shape)
        self._memories.append([init, inner, None])
        return inner

    def update_memory(self, ex_mem, new_mem):
        for m in self._memories:
            if m[1] is ex_mem:
                m[2] = new_mem.name
                return
        raise ValueError("update_memory on unknown memory")

    def output(self, *outputs):
        for o in outputs:
            outer = self._program.block(
                self._sub_block.parent_idx).create_var(
                name=unique_name.generate("drnn_out"), dtype=o.dtype)
            self._outputs.append((o, outer))

    def _complete(self):
        parent = self._program.current_block()
        padded_outs = [
            parent.create_var(name=unique_name.generate("drnn_padded_out"),
                              dtype=o.dtype) for o, _ in self._outputs]
        final_states = [
            parent.create_var(name=unique_name.generate("drnn_final"),
                              dtype=m[0].dtype) for m in self._memories]
        parent.append_op(
            type="recurrent",
            inputs={"inputs": [p.name for p, _ in self._step_inputs],
                    "initial_states": [m[0].name for m in self._memories],
                    "sequence_length": [self._lens_var.name]},
            outputs={"outputs": [v.name for v in padded_outs],
                     "final_states": [v.name for v in final_states]},
            attrs={"sub_block": self._sub_block,
                   "inner_input_names": [i.name for _, i in
                                         self._step_inputs],
                   "inner_state_names": [m[1].name for m in self._memories],
                   "inner_state_out_names": [m[2] for m in self._memories],
                   "inner_output_names": [o.name for o, _ in self._outputs],
                   "time_major": False, "reverse": False})
        # unpad back to flat LoD
        from .sequence_layers import sequence_unpad
        self._flat_outs = [sequence_unpad(p, self._lens_var)
                           for p in padded_outs]

    def __call__(self):
        outs = self._flat_outs
        return outs[0] if len(outs) == 1 else outs


class IfElse:
    """fluid.layers.IfElse parity. The reference splits batch rows by a
    boolean mask, runs each branch on its subset and merges
    (split_lod_tensor/merge_lod_tensor). Static-shape equivalent: both
    branches run on the full batch; outputs merge row-wise by mask."""

    OUT_IF_ELSE_TRUE_BLOCKS = 0
    OUT_IF_ELSE_FALSE_BLOCKS = 1

    def __init__(self, cond, name=None):
        self.cond = cond
        self.helper = LayerHelper("ifelse", name=name)
        self._true_outs = []
        self._false_outs = []
        self._in_true = None

    class _Branch:
        def __init__(self, ie, is_true):
            self.ie = ie
            self.is_true = is_true

        def __enter__(self):
            self.ie._in_true = self.is_true
            return self

        def __exit__(self, *exc):
            self.ie._in_true = None
            return False

    def true_block(self):
        return IfElse._Branch(self, True)

    def false_block(self):
        return IfElse._Branch(self, False)

    def input(self, x):
        if self._in_true is None:
            raise ValueError("IfElse.input must be inside a branch block")
        return x  # full batch; mask applied at merge

    def output(self, *outs):
        if self._in_true is None:
            raise ValueError("IfElse.output must be inside a branch block")
        (self._true_outs if self._in_true else self._false_outs).extend(outs)

    def __call__(self):
        if len(self._true_outs) != len(self._false_outs):
            raise ValueError("true/false branches produced different "
                             "output counts")
        helper = self.helper
        merged = []
        for t, f in zip(self._true_outs, self._false_outs):
            out = helper.create_variable_for_type_inference(
                t.dtype, shape=t.shape)
            helper.append_op(
                type="select_rows_by_mask",
                inputs={"Mask": [self.cond], "TrueOut": [t],
                        "FalseOut": [f]},
                outputs={"Out": [out]})
            merged.append(out)
        return merged


class Switch:
    """fluid.layers.Switch parity for scalar conditions (LR schedules):
    builds a chained select. Usage:

        with switch.case(cond1): assign(v1, out)
        with switch.default():   assign(v2, out)
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._cases = []       # (cond var or None, [(target, value)])
        self._current = None

    class _Case:
        def __init__(self, sw, cond):
            self.sw = sw
            self.cond = cond

        def __enter__(self):
            self.sw._current = (self.cond, [])
            return self

        def __exit__(self, *exc):
            self.sw._cases.append(self.sw._current)
            self.sw._current = None
            return False

    def case(self, cond):
        return Switch._Case(self, cond)

    def default(self):
        return Switch._Case(self, None)

    def assign(self, value, target):
        """Record `target = value` for the active case."""
        if self._current is None:
            raise ValueError("Switch.assign outside case block")
        self._current[1].append((target, value))

    def finalize(self):
        """Emit the select chain: first matching case wins."""
        helper = self.helper
        targets = {}
        for cond, assigns in self._cases:
            for target, value in assigns:
                targets.setdefault(target, []).append((cond, value))
        for target, arms in targets.items():
            taken = None      # running "already matched" flag
            acc = None
            default_val = None
            for cond, value in arms:
                if cond is None:
                    default_val = value
                    continue
                c = cast(cond, "float32")
                use = c if taken is None else c * (1.0 - taken)
                term = use * value
                acc = term if acc is None else acc + term
                taken = use if taken is None else taken + use
            if default_val is None:
                # reference Switch executes no assign when nothing matches:
                # the target keeps its previous value
                default_val = target
            rest = (1.0 - taken) if taken is not None else 1.0
            term = rest * default_val
            acc = term if acc is None else acc + term
            helper.append_op(type="assign", inputs={"X": [acc]},
                             outputs={"Out": [target]})
