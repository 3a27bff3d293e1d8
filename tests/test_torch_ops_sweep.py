"""Op sweep of the PyTorch port, part 1: the activations (and prelu),
the comparison and logical ops, and the math ops (reductions, cumsum,
norms and distances, cos_sim, bilinear_tensor_product, arg_max/arg_min,
minus, conv_shift), each through both Executors against the JAX package
(tests/torch_op_harness.py: forward at rtol 1e-5, gradients where
tests/test_ops_sweep.py checks one). Inputs are numpy draws from fixed
seeds, in the domains tests/test_ops_sweep.py uses."""

import numpy as np
import pytest

from torch_op_harness import check, rand

# op: (attrs, input domain, check the gradient)
UNARY = {
    "sigmoid": ({}, (-2, 2), True),
    "logsigmoid": ({}, (-2, 2), True),
    "exp": ({}, (-2, 2), True),
    "relu": ({}, (0.1, 2), True),
    "tanh": ({}, (-2, 2), True),
    "tanh_shrink": ({}, (-2, 2), True),
    "sqrt": ({}, (0.5, 4), True),
    "rsqrt": ({}, (0.5, 4), True),
    "abs": ({}, (0.3, 2), True),
    "ceil": ({}, (-2, 2), False),
    "floor": ({}, (-2, 2), False),
    "cos": ({}, (-2, 2), True),
    "sin": ({}, (-2, 2), True),
    "round": ({}, (-2, 2), False),
    "reciprocal": ({}, (0.5, 3), True),
    "log": ({}, (0.5, 4), True),
    "square": ({}, (-2, 2), True),
    "softplus": ({}, (-2, 2), True),
    "softsign": ({}, (0.2, 2), True),
    "sign": ({}, (0.3, 2), False),
    "gelu": ({}, (-2, 2), True),
    "erf": ({}, (-2, 2), True),
    "silu": ({}, (-2, 2), True),
    "brelu": ({"t_min": -0.5, "t_max": 0.8}, (-2, 2), False),
    "leaky_relu": ({"alpha": 0.1}, (-2, 2), True),
    "soft_relu": ({"threshold": 40.0}, (-2, 2), True),
    "elu": ({"alpha": 1.5}, (-2, 2), True),
    "relu6": ({"threshold": 6.0}, (0.2, 2), True),
    "pow": ({"factor": 3.0}, (0.5, 2), True),
    "stanh": ({"scale_a": 0.67, "scale_b": 1.7159}, (-2, 2), True),
    "hard_shrink": ({"threshold": 0.5}, (-2, 2), False),
    "softshrink": ({"lambda": 0.5}, (0.8, 2), True),
    "thresholded_relu": ({"threshold": 1.0}, (1.2, 2), True),
    "hard_sigmoid": ({"slope": 0.2, "offset": 0.5}, (-1.5, 1.5), False),
    "swish": ({"beta": 1.5}, (-2, 2), True),
    "mish": ({}, (-2, 2), True),
}


@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary(op):
    attrs, (lo, hi), grad = UNARY[op]
    check(op, {"X": rand(1, 3, 4, lo=lo, hi=hi)}, attrs, ["Out"],
          wrt=["X"] if grad else ())


@pytest.mark.parametrize("op,attrs", [
    ("gelu", {"approximate": True}),
    ("leaky_relu", {}),
    ("elu", {}),
    ("soft_relu", {"threshold": 1.0}),
    ("relu6", {"threshold": 1.0}),
    ("stanh", {}),
    ("hard_sigmoid", {}),
])
def test_unary_attrs_and_defaults(op, attrs):
    check(op, {"X": rand(2, 4, 5, lo=-3, hi=3)}, attrs, ["Out"])


def test_round_half_to_even():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49, 1.51], np.float32)
    out = check("round", {"X": x}, {}, ["Out"])
    np.testing.assert_array_equal(out["out_out_0"],
                                  [-2, -2, -0, 0, 2, 2, 0, 2])


@pytest.mark.parametrize("mode", ["all", "channel"])
def test_prelu(mode):
    x = rand(3, 2, 3, 4, 4, lo=-2, hi=2)
    alpha = np.array([0.25], np.float32) if mode == "all" else \
        np.array([0.1, 0.2, 0.3], np.float32)
    check("prelu", {"X": x, "Alpha": alpha}, {"mode": mode}, ["Out"],
          wrt=["X", "Alpha"])


COMPARE = ["less_than", "less_equal", "greater_than", "greater_equal",
           "equal", "not_equal"]


@pytest.mark.parametrize("op", COMPARE)
@pytest.mark.parametrize("kind", ["int", "float", "axis"])
def test_compare(op, kind):
    if kind == "int":
        x = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
        y = np.array([[1, 3, 2], [4, 4, 7]], np.int32)
        attrs = {}
    elif kind == "float":
        x = np.round(rand(4, 3, 4, lo=0, hi=3))
        y = np.round(rand(5, 3, 4, lo=0, hi=3))
        attrs = {}
    else:   # Y [3] aligned to X [2, 3, 4] at axis 1
        x = np.round(rand(6, 2, 3, 4, lo=0, hi=3))
        y = np.round(rand(7, 3, lo=0, hi=3))
        attrs = {"axis": 1}
    check(op, {"X": x, "Y": y}, attrs, ["Out"])


@pytest.mark.parametrize("op", ["logical_and", "logical_or", "logical_xor",
                                "logical_not"])
def test_logical(op):
    x = np.array([True, True, False, False])
    y = np.array([True, False, True, False])
    inputs = {"X": x} if op == "logical_not" else {"X": x, "Y": y}
    check(op, inputs, {}, ["Out"])


REDUCE = ["reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
          "reduce_prod"]


@pytest.mark.parametrize("op", REDUCE)
@pytest.mark.parametrize("attrs", [
    {"dim": [1]}, {"dim": [1], "keep_dim": True}, {"reduce_all": True},
    {"dim": [-1]}, {"dim": [0, 2]}, {"reduce_all": True, "keep_dim": True},
], ids=["dim1", "keep", "all", "last", "dims02", "all_keep"])
def test_reduce(op, attrs):
    check(op, {"X": rand(8, 2, 3, 4, lo=0.5, hi=2)}, attrs, ["Out"],
          wrt=["X"])


def test_reduce_ties_and_integers():
    x = np.array([[1.0, 3.0, 3.0], [2.0, 2.0, 0.5]], np.float32)
    for op in ("reduce_max", "reduce_min"):
        check(op, {"X": x}, {"dim": [1]}, ["Out"], wrt=["X"])
    xi = np.array([[1, 2, 4], [3, 5, 8]], np.int32)
    for op in REDUCE:
        check(op, {"X": xi}, {"dim": [1]}, ["Out"])


def test_reduce_prod_grad_at_zero():
    """d prod / dx_i is the product of the others: one zero leaves only
    its own entry nonzero, two zeros none."""
    x = np.array([[2.0, 0.0, 3.0], [0.0, 0.0, 4.0], [1.5, 2.0, 0.5]],
                 np.float32)
    check("reduce_prod", {"X": x}, {"dim": [1]}, ["Out"], wrt=["X"])


@pytest.mark.parametrize("attrs", [
    {"axis": 1}, {"axis": 1, "reverse": True}, {"axis": 0, "exclusive": True},
    {"axis": -1, "exclusive": True, "reverse": True}, {},
])
def test_cumsum(attrs):
    check("cumsum", {"X": rand(9, 3, 4)}, attrs, ["Out"], wrt=["X"])


def test_norm_ops():
    x = rand(10, 3, 4, lo=0.5, hi=2)
    check("l1_norm", {"X": x}, {}, ["Out"], wrt=["X"])
    check("squared_l2_norm", {"X": x}, {}, ["Out"], wrt=["X"])
    check("norm", {"X": x}, {"axis": 1, "epsilon": 1e-10},
          ["Out", "Norm"], wrt=["X"])
    check("norm", {"X": rand(11, 2, 3, 4)}, {"axis": 2}, ["Out", "Norm"],
          wrt=["X"])


def test_squared_l2_distance():
    check("squared_l2_distance", {"X": rand(12, 3, 4), "Y": rand(13, 3, 4)},
          {}, ["Out", "sub_result"], wrt=["X", "Y"])
    # one Y row against every X row
    check("squared_l2_distance", {"X": rand(14, 3, 4), "Y": rand(15, 1, 4)},
          {}, ["Out", "sub_result"], wrt=["X"])


@pytest.mark.parametrize("rows", [3, 1])
def test_cos_sim(rows):
    x = rand(16, 3, 4, lo=0.5, hi=2)
    y = rand(17, rows, 4, lo=0.5, hi=2)
    check("cos_sim", {"X": x, "Y": y}, {}, ["Out", "XNorm", "YNorm"],
          wrt=["X", "Y"])


@pytest.mark.parametrize("bias", [False, True])
def test_bilinear_tensor_product(bias):
    inputs = {"X": rand(18, 3, 4), "Y": rand(19, 3, 5),
              "Weight": rand(20, 2, 4, 5)}
    if bias:
        inputs["Bias"] = rand(21, 1, 2)
    check("bilinear_tensor_product", inputs, {}, ["Out"],
          wrt=["X", "Y", "Weight"])


@pytest.mark.parametrize("op", ["arg_max", "arg_min"])
def test_arg_max_min(op):
    check(op, {"X": rand(22, 3, 5)}, {"axis": 1}, ["Out"])
    check(op, {"X": rand(23, 3, 5)}, {"axis": 0}, ["Out"])
    check(op, {"X": rand(24, 2, 3, 4)}, {}, ["Out"])
    # ties: the first index wins
    x = np.array([[1, 3, 3, 0], [2, 2, 2, 2], [0, 0, 1, 1]], np.float32)
    out = check(op, {"X": x}, {"axis": 1}, ["Out"])
    want = [1, 0, 2] if op == "arg_max" else [3, 0, 0]
    np.testing.assert_array_equal(out["out_out_0"], want)


def test_minus():
    check("minus", {"X": rand(25, 3, 4), "Y": rand(26, 3, 4)}, {}, ["Out"],
          wrt=["X", "Y"])


def test_conv_shift():
    check("conv_shift", {"X": rand(27, 2, 7), "Y": rand(28, 2, 3)}, {},
          ["Out"], wrt=["X", "Y"])
    check("conv_shift", {"X": rand(29, 3, 5), "Y": rand(30, 3, 5)}, {},
          ["Out"], wrt=["X", "Y"])
