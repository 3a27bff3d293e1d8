"""Recurrent layer functions: dynamic_lstm, dynamic_lstmp, dynamic_gru,
lstm_unit, gru_unit (python/paddle/fluid/layers/nn.py parity).

The counterpart of ``paddle_tpu/layers/rnn_layers.py`` (a copy: the
two packages build the same Programs)."""

from .layer_helper import LayerHelper

__all__ = ["dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "lstm_unit",
           "gru_unit"]


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """input: [T, 4*hidden] (x already projected); size = 4*hidden."""
    helper = LayerHelper("lstm", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    hidden = size // 4
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[hidden, 4 * hidden], dtype=dtype)
    bias_size = [1, 7 * hidden if use_peepholes else 4 * hidden]
    bias = helper.create_parameter(attr=helper.bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    hidden_out = helper.create_variable_for_type_inference(
        dtype, shape=(-1, hidden))
    cell_out = helper.create_variable_for_type_inference(
        dtype, shape=(-1, hidden))
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(
        type="lstm", inputs=inputs,
        outputs={"Hidden": [hidden_out], "Cell": [cell_out]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    return hidden_out, cell_out


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    helper = LayerHelper("lstmp", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    hidden = size // 4
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[proj_size, 4 * hidden], dtype=dtype)
    proj_weight = helper.create_parameter(
        attr=helper.param_attr, shape=[hidden, proj_size], dtype=dtype)
    bias_size = [1, 7 * hidden if use_peepholes else 4 * hidden]
    bias = helper.create_parameter(attr=helper.bias_attr, shape=bias_size,
                                   dtype=dtype, is_bias=True)
    proj_out = helper.create_variable_for_type_inference(
        dtype, shape=(-1, proj_size))
    helper.append_op(
        type="lstmp",
        inputs={"Input": [input], "Weight": [weight],
                "ProjWeight": [proj_weight], "Bias": [bias]},
        outputs={"Projection": [proj_out]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "proj_activation": proj_activation})
    return proj_out


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, origin_mode=False,
                name=None):
    """input: [T, 3*size]; returns hidden [T, size]."""
    helper = LayerHelper("gru", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    dtype = input.dtype
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(attr=helper.bias_attr,
                                   shape=[1, 3 * size], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype,
                                                       shape=(-1, size))
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(
        type="gru", inputs=inputs, outputs={"Hidden": [hidden]},
        attrs={"is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "activation": candidate_activation,
               "origin_mode": origin_mode})
    return hidden


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step from raw x_t: projects [x_t, h_prev] to 4*hidden gates
    with an fc, then applies the cell (layers/nn.py lstm_unit parity).
    Returns (hidden_t, cell_t)."""
    from .tensor import concat
    from .nn import fc
    helper = LayerHelper("lstm_unit_graph", name=name)
    size = cell_t_prev.shape[-1]
    concat_in = concat([x_t, hidden_t_prev], axis=-1)
    fc_out = fc(concat_in, 4 * size, param_attr=param_attr,
                bias_attr=bias_attr)
    h = helper.create_variable_for_type_inference(x_t.dtype,
                                                  shape=(-1, size))
    c = helper.create_variable_for_type_inference(x_t.dtype,
                                                  shape=(-1, size))
    helper.append_op(
        type="lstm_unit",
        inputs={"X": [fc_out], "C_prev": [cell_t_prev]},
        outputs={"C": [c], "H": [h]},
        attrs={"forget_bias": float(forget_bias)})
    return h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    """One GRU step: input [B, 3*hidden] (x proj), hidden [B, hidden].
    Returns (updated_hidden, reset_hidden_prev, gate)."""
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr)
    dtype = input.dtype
    size = size // 3
    weight = helper.create_parameter(attr=helper.param_attr,
                                     shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(attr=helper.bias_attr,
                                   shape=[1, 3 * size], dtype=dtype,
                                   is_bias=True)
    gate = helper.create_variable_for_type_inference(dtype)
    reset_hidden_prev = helper.create_variable_for_type_inference(dtype)
    updated_hidden = helper.create_variable_for_type_inference(
        dtype, shape=(-1, size))
    helper.append_op(
        type="gru_unit",
        inputs={"Input": [input], "HiddenPrev": [hidden],
                "Weight": [weight], "Bias": [bias]},
        outputs={"Gate": [gate], "ResetHiddenPrev": [reset_hidden_prev],
                 "Hidden": [updated_hidden]},
        attrs={"activation": activation,
               "gate_activation": gate_activation,
               "origin_mode": origin_mode})
    return updated_hidden, reset_hidden_prev, gate
