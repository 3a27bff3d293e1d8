"""Neural-network layers.

The counterpart of ``paddle_tpu/layers/nn.py``, holding the layers whose
ops the port lowers (the flagship LM's and the ResNet models'): fc,
embedding, softmax, cross_entropy, softmax_with_cross_entropy, mean,
accuracy, batch_norm, layer_norm, matmul, topk and reduce_sum. Each
builds ops through LayerHelper exactly as the JAX package's does, so the
two packages emit the same Program. The rest of the JAX package's layers
come with their lowerings (ROADMAP.md, queue 1 item 7).
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
