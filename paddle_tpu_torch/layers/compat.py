"""Reference-parity layer wrappers over the port's op lowerings.

The counterpart of ``paddle_tpu/layers/compat.py`` for Print, mul,
sums/sum, pad, multiplex, smooth_l1, lrn, im2sequence, the random layers
(also ``*_batch_size_like``), nce, the CTC layers (warpctc,
ctc_greedy_decoder), edit_distance, chunk_eval, the two beam-search
builders, the detection builders (bipartite_match, target_assign,
prior_box, box_coder, multiclass_nms, detection_output, detection_map,
multi_box_head, ssd_loss), shrink_memory, reorder_lod_tensor_by_rank
and ConditionalBlock. Its reader wrappers wait for the wire (ROADMAP.md,
queue 1 item 10).
"""

from .layer_helper import LayerHelper

__all__ = [
    "Print", "mul", "sums", "sum", "pad", "multiplex", "smooth_l1", "lrn",
    "uniform_random", "gaussian_random", "uniform_random_batch_size_like",
    "gaussian_random_batch_size_like", "nce", "beam_search",
    "beam_search_decode", "im2sequence", "edit_distance", "shrink_memory",
    "reorder_lod_tensor_by_rank", "ConditionalBlock", "warpctc",
    "ctc_greedy_decoder", "chunk_eval", "bipartite_match", "target_assign",
    "prior_box", "box_coder", "multiclass_nms", "detection_output",
    "detection_map", "multi_box_head", "ssd_loss",
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


def warpctc(input, label, blank=0, norm_by_times=False):
    loss, _ = _simple("warpctc", {"Logits": [input], "Label": [label]},
                      {"blank": blank, "norm_by_times": norm_by_times},
                      out_slots=("Loss", "WarpCTCGrad"),
                      dtype=input.dtype)
    return loss


def ctc_greedy_decoder(input, blank, name=None):
    """argmax over classes then CTC collapse (ctc_align), matching the
    reference's topk+ctc_align composition."""
    from .tensor import argmax
    ids = argmax(input, axis=1)
    return _simple("ctc_align", {"Input": [ids]},
                   {"blank": blank, "merge_repeated": True},
                   out_slots=("Output",), dtype="int64", name=name)


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


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None):
    outs = _simple(
        "chunk_eval", {"Inference": [input], "Label": [label]},
        {"chunk_scheme": chunk_scheme, "num_chunk_types": num_chunk_types,
         "excluded_chunk_types": list(excluded_chunk_types or [])},
        out_slots=("Precision", "Recall", "F1-Score", "NumInferChunks",
                   "NumLabelChunks", "NumCorrectChunks"))
    return outs


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    idx, dist = _simple(
        "bipartite_match", {"DistMat": [dist_matrix]},
        {"match_type": match_type or "bipartite",
         "dist_threshold": dist_threshold or 0.5},
        out_slots=("ColToRowMatchIndices", "ColToRowMatchDist"))
    return idx, dist


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0.0, name=None):
    inputs = {"X": [input], "MatchIndices": [matched_indices]}
    if negative_indices is not None:
        inputs["NegIndices"] = [negative_indices]
    out, w = _simple("target_assign", inputs,
                     {"mismatch_value": float(mismatch_value)},
                     out_slots=("Out", "OutWeight"), name=name)
    return out, w


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=None, offset=0.5, name=None):
    boxes, vars_ = _simple(
        "prior_box", {"Input": [input], "Image": [image]},
        {"min_sizes": list(min_sizes), "max_sizes": list(max_sizes or []),
         "aspect_ratios": list(aspect_ratios or [1.0]),
         "variances": list(variance), "flip": flip, "clip": clip,
         "step_w": (steps or [0.0, 0.0])[0],
         "step_h": (steps or [0.0, 0.0])[1], "offset": offset},
        out_slots=("Boxes", "Variances"), name=name)
    return boxes, vars_


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None):
    return _simple("box_coder",
                   {"PriorBox": [prior_box], "PriorBoxVar": [prior_box_var],
                    "TargetBox": [target_box]},
                   {"code_type": code_type,
                    "box_normalized": box_normalized},
                   out_slots=("OutputBox",), name=name)


def multiclass_nms(bboxes, scores, score_threshold=0.0, nms_top_k=400,
                   keep_top_k=200, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, name=None):
    return _simple("multiclass_nms",
                   {"BBoxes": [bboxes], "Scores": [scores]},
                   {"score_threshold": score_threshold,
                    "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
                    "nms_threshold": nms_threshold,
                    "normalized": normalized, "nms_eta": float(nms_eta),
                    "background_label": background_label}, name=name)


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01,
                     nms_eta=1.0):
    """Reference composition (layers/detection.py detection_output):
    softmax the raw class scores [N, M, C], decode predicted offsets
    against priors, transpose scores to [N, C, M], then multiclass
    NMS (nms_eta < 1 = adaptive threshold decay, detection.py:54)."""
    from .nn import softmax
    from .tensor import transpose
    probs = transpose(softmax(scores), perm=[0, 2, 1])
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    return multiclass_nms(decoded, probs,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold, nms_eta=nms_eta,
                          background_label=background_label)


def detection_map(detect_res, label, class_num=None, background_label=0,
                  overlap_threshold=0.5, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version="11point", difficult=None):
    """VOC mAP over NMS-format detections (detection_map_op.cc).
    evaluate_difficult=False needs the per-GT `difficult` column input;
    ap_version: "11point" | "integral"."""
    if ap_version not in ("11point", "integral"):
        raise ValueError("detection_map: ap_version must be '11point' "
                         "or 'integral', got %r" % (ap_version,))
    if not evaluate_difficult and difficult is None:
        raise ValueError(
            "detection_map: evaluate_difficult=False needs the "
            "`difficult` ground-truth flag input")
    inputs = {"DetectRes": [detect_res], "Label": [label]}
    if difficult is not None:
        inputs["Difficult"] = [difficult]
    m, _ = _simple("detection_map", inputs,
                   {"overlap_threshold": overlap_threshold,
                    "ap_version": ap_version,
                    "evaluate_difficult": bool(evaluate_difficult),
                    "class_num": int(class_num or 0),
                    "background_label": background_label},
                   out_slots=("MAP", "AccumPosCount"))
    return m


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


def _num_priors_per_loc(min_sizes, max_sizes, aspect_ratios, flip):
    """Priors per feature-map cell — mirrors the prior_box lowering's
    aspect-ratio expansion (ops/detection_ops.py)."""
    ars = [1.0]
    for r in aspect_ratios or [1.0]:
        if all(abs(r - a) > 1e-6 for a in ars):
            ars.append(r)
            if flip:
                ars.append(1.0 / r)
    cnt = 0
    for k, ms in enumerate(min_sizes):
        for a in ars:
            cnt += 1
            if a == 1.0 and k < len(max_sizes or []):
                cnt += 1
    return cnt


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None):
    """SSD detection head over multiple feature maps (reference
    layers/detection.py multi_box_head): per input, generate priors and
    predict per-prior location offsets + class confidences with convs;
    concat across maps. Returns (mbox_locs [N, Np, 4],
    mbox_confs [N, Np, C], boxes [Np, 4], variances [Np, 4])."""
    import math
    from .conv_layers import conv2d
    from .tensor import concat, reshape, transpose

    if not isinstance(inputs, (list, tuple)):
        raise ValueError("inputs should be a list or tuple")
    num_layer = len(inputs)
    if num_layer <= 2:
        assert min_sizes is not None and max_sizes is not None
    elif min_sizes is None and max_sizes is None:
        min_sizes, max_sizes = [], []
        step = int(math.floor((max_ratio - min_ratio) / (num_layer - 2)))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes
        max_sizes = [base_size * 0.20] + max_sizes
    if steps:
        step_w = step_h = steps

    locs, confs, boxes_all, vars_all = [], [], [], []
    for i, feat in enumerate(inputs):
        ms = min_sizes[i]
        ms = ms if isinstance(ms, (list, tuple)) else [ms]
        mx = (max_sizes or [None] * num_layer)[i]
        mx = [] if mx is None else \
            (mx if isinstance(mx, (list, tuple)) else [mx])
        ar = (aspect_ratios or [None] * num_layer)[i]
        ar = [1.0] if ar is None else \
            (list(ar) if isinstance(ar, (list, tuple)) else [ar])
        box, var = prior_box(
            feat, image, ms, mx, ar, variance=variance, flip=flip,
            clip=clip,
            steps=[(step_w[i] if step_w else 0.0),
                   (step_h[i] if step_h else 0.0)], offset=offset)
        boxes_all.append(reshape(box, [-1, 4]))
        vars_all.append(reshape(var, [-1, 4]))
        p = _num_priors_per_loc(ms, mx, ar, flip)

        loc = conv2d(feat, num_filters=p * 4,
                     filter_size=kernel_size, padding=pad,
                     stride=stride)
        loc = transpose(loc, perm=[0, 2, 3, 1])
        locs.append(reshape(loc, [0, -1, 4]))
        cf = conv2d(feat, num_filters=p * num_classes,
                    filter_size=kernel_size, padding=pad,
                    stride=stride)
        cf = transpose(cf, perm=[0, 2, 3, 1])
        confs.append(reshape(cf, [0, -1, num_classes]))

    mbox_locs = locs[0] if len(locs) == 1 else concat(locs, axis=1)
    mbox_confs = confs[0] if len(confs) == 1 else concat(confs, axis=1)
    boxes = boxes_all[0] if len(boxes_all) == 1 else \
        concat(boxes_all, axis=0)
    variances = vars_all[0] if len(vars_all) == 1 else \
        concat(vars_all, axis=0)
    return mbox_locs, mbox_confs, boxes, variances


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0,
             overlap_threshold=0.5, neg_pos_ratio=3.0, neg_overlap=0.5,
             loc_loss_weight=1.0, conf_loss_weight=1.0,
             match_type="per_prediction", mining_type="max_negative",
             normalize=True, sample_size=None, name=None):
    """SSD multibox loss (reference layers/detection.py ssd_loss): IoU
    matching + hard negative mining + softmax CE + smooth-l1, fused into
    one batch-aware op (ops/detection_ops.py `ssd_loss`). location
    [N, Np, 4], confidence [N, Np, C], gt_box/gt_label flat LoD
    ([Ng, 4]/[Ng, 1]). Returns the per-image weighted loss [N, 1]."""
    if mining_type != "max_negative":
        raise ValueError("Only mining_type == 'max_negative' is "
                         "supported (reference parity)")
    helper = LayerHelper("ssd_loss", name=name)
    out = helper.create_variable_for_type_inference(
        "float32", shape=(location.shape[0], 1))
    inputs = {"Loc": [location], "Conf": [confidence],
              "GTBox": [gt_box], "GTLabel": [gt_label],
              "PriorBox": [prior_box]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var]
    helper.append_op(
        type="ssd_loss", inputs=inputs, outputs={"Loss": [out]},
        attrs={"background_label": int(background_label),
               "overlap_threshold": float(overlap_threshold),
               "neg_pos_ratio": float(neg_pos_ratio),
               "neg_overlap": float(neg_overlap),
               "loc_loss_weight": float(loc_loss_weight),
               "conf_loss_weight": float(conf_loss_weight),
               "match_type": match_type, "normalize": bool(normalize)})
    return out
