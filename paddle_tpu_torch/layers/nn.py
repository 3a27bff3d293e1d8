"""Neural-network layers.

The counterpart of ``paddle_tpu/layers/nn.py``, holding the layers whose
ops the port lowers (the flagship LM's and the ResNet models'): fc,
embedding, softmax, cross_entropy, softmax_with_cross_entropy, mean,
sigmoid_cross_entropy_with_logits, square_error_cost, accuracy, auc,
batch_norm, layer_norm, l2_normalize, dropout, matmul, topk, clip,
clip_by_norm, label_smooth, one_hot, the five reductions, the CRF's
linear_chain_crf and crf_decoding, and cos_sim. Each builds ops through
LayerHelper exactly as the JAX package's does, so the two packages emit
the same Program.
"""

from .layer_helper import LayerHelper


def _prod(xs):
    out = 1
    for x in xs:
        out *= int(x)
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully connected (nn.py fc). Multiple inputs are each matmul'd then
    summed, like the reference."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    param_attrs = helper.param_attr
    if not isinstance(param_attrs, (list, tuple)):
        param_attrs = [param_attrs] * len(inputs)

    mul_results = []
    for x, pattr in zip(inputs, param_attrs):
        in_features = _prod(x.shape[num_flatten_dims:])
        w = helper.create_parameter(pattr, shape=[in_features, size],
                                    dtype=x.dtype)
        out_shape = tuple(x.shape[:num_flatten_dims]) + (size,)
        tmp = helper.create_variable_for_type_inference(x.dtype,
                                                        shape=out_shape)
        helper.append_op(
            type="mul", inputs={"X": [x], "Y": [w]}, outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
        mul_results.append(tmp)

    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(
            mul_results[0].dtype, shape=mul_results[0].shape)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32", name=None):
    helper = LayerHelper("embedding", param_attr=param_attr, name=name)
    w = helper.create_parameter(helper.param_attr, shape=list(size),
                                dtype=dtype)
    in_shape = tuple(input.shape) if input.shape else (-1,)
    if in_shape and in_shape[-1] == 1:
        in_shape = in_shape[:-1]
    out = helper.create_variable_for_type_inference(
        dtype, shape=in_shape + (size[1],))
    helper.append_op(
        type="lookup_table", inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [out]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": -1 if padding_idx is None else padding_idx})
    return out


def softmax(input, use_cudnn=True, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=input.shape)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    shape = tuple(input.shape[:-1]) + (1,) if input.shape else None
    out = helper.create_variable_for_type_inference(input.dtype, shape=shape)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    sm = helper.create_variable_for_type_inference(logits.dtype,
                                                   shape=logits.shape)
    shape = tuple(logits.shape[:-1]) + (1,) if logits.shape else None
    loss = helper.create_variable_for_type_inference(logits.dtype,
                                                     shape=shape)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [sm], "Loss": [loss]},
                     attrs={"soft_label": soft_label})
    if return_softmax:
        return loss, sm
    return loss


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]})
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    minus = helper.create_variable_for_type_inference(input.dtype,
                                                      shape=input.shape)
    helper.append_op(type="elementwise_sub",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [minus]})
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=input.shape)
    helper.append_op(type="square", inputs={"X": [minus]},
                     outputs={"Out": [out]})
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=())
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(
        input.dtype, shape=tuple(input.shape[:-1]) + (k,))
    topk_idx = helper.create_variable_for_type_inference(
        "int64", shape=tuple(input.shape[:-1]) + (k,))
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [topk_out], "Indices": [topk_idx]},
                     attrs={"k": k})
    acc_out = helper.create_variable_for_type_inference("float32", shape=(1,))
    correct = correct or helper.create_variable_for_type_inference(
        "int64", shape=(1,))
    total = total or helper.create_variable_for_type_inference(
        "int64", shape=(1,))
    helper.append_op(type="accuracy",
                     inputs={"Out": [topk_out], "Indices": [topk_idx],
                             "Label": [label]},
                     outputs={"Accuracy": [acc_out], "Correct": [correct],
                              "Total": [total]})
    return acc_out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=False):
    from ..initializer import ConstantInitializer
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    ch = (input.shape[1] if data_layout == "NCHW" and len(input.shape) > 1
          else input.shape[-1])
    pshape = [ch]
    scale = helper.create_parameter(
        helper.param_attr, shape=pshape, dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(helper.bias_attr, shape=pshape,
                                   dtype=dtype, is_bias=True)
    mean = helper.create_parameter(
        _nt_attr(moving_mean_name), shape=pshape, dtype=dtype,
        default_initializer=ConstantInitializer(0.0))
    mean.stop_gradient = True
    variance = helper.create_parameter(
        _nt_attr(moving_variance_name), shape=pshape, dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    variance.stop_gradient = True

    saved_mean = helper.create_variable_for_type_inference(
        dtype, shape=pshape, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, shape=pshape, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype, shape=input.shape)

    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout})
    return helper.append_activation(out)


def _nt_attr(name):
    from ..param_attr import ParamAttr
    a = ParamAttr(name=name, trainable=False)
    return a


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-05, param_attr=None, bias_attr=None, act=None,
               name=None):
    from ..initializer import ConstantInitializer
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = input.dtype
    pshape = [_prod(input.shape[begin_norm_axis:])]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            helper.param_attr, shape=pshape, dtype=dtype,
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(helper.bias_attr, shape=pshape,
                                    dtype=dtype, is_bias=True)
        inputs["Bias"] = [b]
    mean = helper.create_variable_for_type_inference(
        dtype, shape=input.shape[:begin_norm_axis], stop_gradient=True)
    var = helper.create_variable_for_type_inference(
        dtype, shape=input.shape[:begin_norm_axis], stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype, shape=input.shape)
    helper.append_op(
        type="layer_norm", inputs=inputs,
        outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def auc(input, label, curve="ROC", num_thresholds=200, topk=1):
    helper = LayerHelper("auc")
    out = helper.create_variable_for_type_inference("float32", shape=(1,))
    helper.append_op(type="auc",
                     inputs={"Out": [input], "Label": [label]},
                     outputs={"AUC": [out]},
                     attrs={"curve": curve,
                            "num_thresholds": num_thresholds})
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    mask = helper.create_variable_for_type_inference(
        x.dtype, shape=x.shape, stop_gradient=True)
    helper.append_op(
        type="dropout", inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed if seed is not None else 0,
               "dropout_implementation": dropout_implementation})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    norm = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(type="norm", inputs={"X": [x]},
                     outputs={"Out": [out], "Norm": [norm]},
                     attrs={"axis": 1 if axis is None else axis,
                            "epsilon": epsilon})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    xs = list(x.shape) if x.shape else None
    ys = list(y.shape) if y.shape else None
    shape = None
    if xs and ys:
        a = xs[:-2] + [xs[-1], xs[-2]] if transpose_x else list(xs)
        b = ys[:-2] + [ys[-1], ys[-2]] if transpose_y else list(ys)
        shape = tuple(a[:-1] + b[-1:])
    out = helper.create_variable_for_type_inference(x.dtype, shape=shape)
    helper.append_op(type="matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    shape = tuple(input.shape[:-1]) + (k,) if input.shape else None
    values = helper.create_variable_for_type_inference(input.dtype,
                                                       shape=shape)
    indices = helper.create_variable_for_type_inference("int64", shape=shape)
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    return values, indices


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(type="clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": min, "max": max})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(type="clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"max_norm": max_norm})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype, shape=label.shape)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [out]}, attrs={"epsilon": epsilon})
    return out


def one_hot(input, depth, name=None):
    helper = LayerHelper("one_hot", name=name)
    shape = input.shape
    if shape and shape[-1] == 1:
        shape = shape[:-1]
    out = helper.create_variable_for_type_inference(
        "float32", shape=tuple(shape or ()) + (depth,))
    helper.append_op(type="one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def reduce_op_layer(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        reduce_all = dim is None
        if dim is None:
            dims = [0]
            shape = ()
        else:
            dims = [dim] if isinstance(dim, int) else list(dim)
            if input.shape is not None:
                nd = len(input.shape)
                axes = {d % nd for d in dims}
                if keep_dim:
                    shape = tuple(1 if i in axes else s
                                  for i, s in enumerate(input.shape))
                else:
                    shape = tuple(s for i, s in enumerate(input.shape)
                                  if i not in axes)
            else:
                shape = None
        out = helper.create_variable_for_type_inference(input.dtype,
                                                        shape=shape)
        helper.append_op(type=op_type, inputs={"X": [input]},
                         outputs={"Out": [out]},
                         attrs={"dim": dims, "keep_dim": keep_dim,
                                "reduce_all": reduce_all})
        return out
    layer.__name__ = op_type
    return layer


reduce_sum = reduce_op_layer("reduce_sum")
reduce_mean = reduce_op_layer("reduce_mean")
reduce_max = reduce_op_layer("reduce_max")
reduce_min = reduce_op_layer("reduce_min")
reduce_prod = reduce_op_layer("reduce_prod")


def linear_chain_crf(input, label, param_attr=None, name=None):
    """CRF negative log-likelihood over emission ``input`` [T, D] (LoD).

    Creates the Transition parameter [D+2, D] (row 0 start, row 1 end,
    rows 2.. transitions: linear_chain_crf_op.cc's layout) and returns
    the per-sequence NLL [N, 1]; train with mean(nll)."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr,
                         name=name)
    size = input.shape[-1]
    transition = helper.create_parameter(
        helper.param_attr, shape=[size + 2, size], dtype=input.dtype)
    ll = helper.create_variable_for_type_inference(input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype)
    eexp = helper.create_variable_for_type_inference(input.dtype)
    texp = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="linear_chain_crf",
        inputs={"Emission": [input], "Label": [label],
                "Transition": [transition]},
        outputs={"LogLikelihood": [ll], "Alpha": [alpha],
                 "EmissionExps": [eexp], "TransitionExps": [texp]})
    return ll


def crf_decoding(input, param_attr=None, name=None, label=None):
    """Viterbi decode against the transition parameter made by
    linear_chain_crf (shared through the param_attr's name)."""
    helper = LayerHelper("crf_decoding", param_attr=param_attr, name=name)
    size = input.shape[-1]
    transition = helper.create_parameter(
        helper.param_attr, shape=[size + 2, size], dtype=input.dtype)
    path = helper.create_variable_for_type_inference("int64")
    inputs = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        inputs["Label"] = [label]
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [path]})
    return path


def cos_sim(X, Y, name=None):
    """Row-wise cosine similarity (operators/cos_sim_op.cc)."""
    helper = LayerHelper("cos_sim", name=name)
    out = helper.create_variable_for_type_inference(
        X.dtype, shape=(X.shape[0] if X.shape else -1, 1))
    xn = helper.create_variable_for_type_inference(X.dtype)
    yn = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op(type="cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xn], "YNorm": [yn]})
    return out
