"""Reference-parity layer wrappers over the port's op lowerings.

The counterpart of ``paddle_tpu/layers/compat.py`` for Print, mul,
sums/sum, pad, multiplex, smooth_l1, lrn, im2sequence, the random layers
(also ``*_batch_size_like``), nce, edit_distance, the two beam-search
builders, shrink_memory, reorder_lod_tensor_by_rank and
ConditionalBlock. Its CTC, detection and reader wrappers come with their
lowerings (ROADMAP.md, queue 1 items 7 and 10).
"""

from .layer_helper import LayerHelper

__all__ = [
    "Print", "mul", "sums", "sum", "pad", "multiplex", "smooth_l1", "lrn",
    "uniform_random", "gaussian_random", "uniform_random_batch_size_like",
    "gaussian_random_batch_size_like", "nce", "beam_search",
    "beam_search_decode", "im2sequence", "edit_distance", "shrink_memory",
    "reorder_lod_tensor_by_rank", "ConditionalBlock",
]


def _simple(op_type, inputs, attrs, out_slots=("Out",), dtype="float32",
            name=None):
    helper = LayerHelper(op_type, name=name)
    outs = {s: [helper.create_variable_for_type_inference(dtype)]
            for s in out_slots}
    helper.append_op(type=op_type, inputs=inputs, outputs=outs,
                     attrs=attrs or {})
    vals = tuple(outs[s][0] for s in out_slots)
    return vals if len(vals) > 1 else vals[0]


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    return _simple("print", {"In": [input]},
                   {"message": message or "", "first_n": first_n,
                    "summarize": summarize}, dtype=input.dtype)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    shape = None
    if x.shape is not None and y.shape is not None:
        shape = (tuple(x.shape[:x_num_col_dims])
                 + tuple(y.shape[y_num_col_dims:]))
    out = helper.create_variable_for_type_inference(x.dtype, shape=shape)
    helper.append_op(type="mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


from .tensor import sums          # noqa: F401,E402  (single implementation)

sum = sums   # reference ops.py exported `sum` for the same op


def pad(x, paddings, pad_value=0.0, name=None):
    return _simple("pad", {"X": [x]},
                   {"paddings": list(paddings), "pad_value": pad_value},
                   dtype=x.dtype, name=name)


def multiplex(inputs, index):
    return _simple("multiplex", {"X": list(inputs), "Ids": [index]}, {},
                   dtype=inputs[0].dtype)


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    out, _ = _simple("smooth_l1_loss", inputs,
                     {"sigma": 1.0 if sigma is None else float(sigma)},
                     out_slots=("Out", "Diff"), dtype=x.dtype)
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    return _simple("lrn", {"X": [input]},
                   {"n": n, "k": k, "alpha": alpha, "beta": beta},
                   dtype=input.dtype, name=name)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    return _simple("uniform_random", {},
                   {"shape": list(shape), "min": float(min),
                    "max": float(max), "seed": seed, "dtype": dtype},
                   dtype=dtype)


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    return _simple("gaussian_random", {},
                   {"shape": list(shape), "mean": float(mean),
                    "std": float(std), "seed": seed, "dtype": dtype},
                   dtype=dtype)


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    return _simple("uniform_random_batch_size_like", {"Input": [input]},
                   {"shape": list(shape), "input_dim_idx": input_dim_idx,
                    "output_dim_idx": output_dim_idx, "min": float(min),
                    "max": float(max), "seed": seed, "dtype": dtype},
                   dtype=dtype)


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    return _simple("gaussian_random_batch_size_like", {"Input": [input]},
                   {"shape": list(shape), "input_dim_idx": input_dim_idx,
                    "output_dim_idx": output_dim_idx, "mean": float(mean),
                    "std": float(std), "seed": seed, "dtype": dtype},
                   dtype=dtype)


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None):
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr)
    if input.shape is None or len(input.shape) < 2:
        raise ValueError(
            "nce: `input` must carry a known [batch, dim] shape; got %r"
            % (input.shape,))
    dim = int(input.shape[1])
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[num_total_classes, dim],
                                dtype=input.dtype)
    b = helper.create_parameter(attr=helper.bias_attr,
                                shape=[num_total_classes, 1],
                                dtype=input.dtype, is_bias=True)
    cost = helper.create_variable_for_type_inference(input.dtype)
    sl = helper.create_variable_for_type_inference(input.dtype)
    sll = helper.create_variable_for_type_inference("int64")
    inputs = {"Input": [input], "Label": [label], "Weight": [w],
              "Bias": [b]}
    if sample_weight is not None:
        # per-example cost weight (nce_op.cc:97 sample_weight input)
        inputs["SampleWeight"] = [sample_weight]
    helper.append_op(
        type="nce",
        inputs=inputs,
        outputs={"Cost": [cost], "SampleLogits": [sl],
                 "SampleLabels": [sll]},
        attrs={"num_total_classes": num_total_classes,
               "num_neg_samples": num_neg_samples or 10})
    return cost


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None):
    """One beam-search step (beam_search_op.cc). `ids` is accepted for
    API parity; selection uses `scores` ([rows, vocab] accumulated
    log-probs when is_accumulated)."""
    helper = LayerHelper("beam_search", name=name)
    sel = helper.create_variable_for_type_inference("int64")
    ssc = helper.create_variable_for_type_inference(scores.dtype)
    par = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="beam_search",
        inputs={"pre_ids": [pre_ids], "pre_scores": [pre_scores],
                "scores": [scores]},
        outputs={"selected_ids": [sel], "selected_scores": [ssc],
                 "parent_idx": [par]},
        attrs={"beam_size": beam_size, "end_id": end_id,
               "is_accumulated": is_accumulated})
    return sel, ssc, par


def beam_search_decode(ids, scores, beam_size, end_id, name=None):
    helper = LayerHelper("beam_search_decode", name=name)
    out_ids = helper.create_variable_for_type_inference("int64")
    out_scores = helper.create_variable_for_type_inference(scores.dtype)
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids], "Scores": [scores]},
        outputs={"SentenceIds": [out_ids],
                 "SentenceScores": [out_scores]},
        attrs={"beam_size": beam_size, "end_id": end_id})
    return out_ids, out_scores

def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    def _pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v]

    pad4 = _pair(padding)
    if len(pad4) == 2:
        pad4 = pad4 + pad4
    return _simple("im2sequence", {"X": [input]},
                   {"kernels": _pair(filter_size),
                    "strides": _pair(stride), "paddings": pad4},
                   dtype=input.dtype, name=name)


def edit_distance(input, label, normalized=True, ignored_tokens=None):
    if ignored_tokens:
        # reference composition (layers/metric wrappers): erase the
        # ignored tokens from both sequences BEFORE the distance
        from .sequence_layers import sequence_erase
        input = sequence_erase(input, list(ignored_tokens))
        label = sequence_erase(label, list(ignored_tokens))
    out, seq_num = _simple(
        "edit_distance", {"Hyps": [input], "Refs": [label]},
        {"normalized": normalized},
        out_slots=("Out", "SequenceNum"))
    return out, seq_num


def shrink_memory(x, i, table):
    return _simple("shrink_rnn_memory", {"X": [x]}, {}, dtype=x.dtype)


def reorder_lod_tensor_by_rank(x, rank_table):
    return _simple("reorder_lod_tensor_by_rank",
                   {"X": [x], "RankTable": [rank_table]}, {},
                   dtype=x.dtype)


class ConditionalBlock:
    """`with ConditionalBlock([cond]).block(): ...` — ops built inside
    run only when cond holds (conditional_block_op.cc). Vars written in
    the block must have a pre-set default (the false branch keeps it)."""

    def __init__(self, inputs, is_scalar_condition=True, name=None):
        self.cond = inputs[0] if isinstance(inputs, (list, tuple)) \
            else inputs

    def block(self):
        from .control_flow import BlockGuard
        from ..core.program import default_main_program
        outer = self

        class _Guard(BlockGuard):
            def __init__(self):
                super().__init__(default_main_program())

            def __exit__(self, *exc):
                program = self.program
                sub_block = program.current_block()
                super().__exit__(*exc)
                if exc[0] is None:
                    # Only vars of OUTER blocks are conditional outputs;
                    # names created inside the sub-block are its private
                    # temps and die with it (conditional_block_op.cc: the
                    # op's Out is the parent-scope vars the block assigns).
                    written = sorted({n for o in sub_block.ops
                                      for ns in o.outputs.values()
                                      for n in ns} - set(sub_block.vars))
                    program.current_block().append_op(
                        type="conditional_block",
                        inputs={"Condition": [outer.cond]},
                        outputs={"Out": written},
                        attrs={"sub_block": sub_block,
                               "written_names": written})
                return False

        return _Guard()
