"""What each rank holds, without ranks: ``parallel/mesh.block_slices``
against the JAX package's placement (``NamedSharding``'s per-device
index map on the 8 virtual CPU devices of ``tests/conftest.py``), a dim
that does not split raising in both, the DTensor and manual axes of a
mesh, and ``parallel/blocks.held_specs`` on the LM's programs (its stage
weights, its expert weights and the Adam moments that follow them).

A mesh here is seen from one rank (``_At``): the functions under test
read only the axes and that rank's coordinates, so no process group is
needed.
"""

import collections

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import parallel as tpar
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.parallel import blocks, mesh as tmesh


class _At(tmesh.Mesh):
    """A mesh of ``sizes`` seen from the rank at ``coords``."""

    def __init__(self, sizes, coords=None):
        self.axis_names = tuple(sizes)
        self.shape = collections.OrderedDict(sizes)
        self.size = int(np.prod(list(self.shape.values())))
        self.device_mesh = None
        self.device_type = "cpu"
        self.coords = dict(coords or {})

    def axis_index(self, axis):
        return self.coords.get(axis, 0)


PLACEMENTS = [
    ({"dp": 2, "pp": 2, "tp": 2}, ("pp", None, None), (4, 8, 8)),
    ({"dp": 2, "pp": 2, "tp": 2}, ("pp", None, "tp"), (2, 8, 8)),
    ({"dp": 2, "pp": 2, "tp": 2}, ("pp", "tp", None), (2, 8, 8)),
    ({"dp": 2, "pp": 2, "ep": 2}, ("pp", "ep", None, None), (4, 4, 8, 8)),
    ({"dp": 2, "pp": 2, "ep": 2}, (None, ("dp", "ep")), (4, 8)),
    ({"dp": 2, "ep": 2, "tp": 2}, ("ep", "sp", None), (4, 6, 2)),
]


def _jax_mesh(sizes):
    devs = np.array(jax.devices()[:8]).reshape(tuple(sizes.values()))
    return jax.sharding.Mesh(devs, tuple(sizes))


@pytest.mark.parametrize("sizes,spec,shape", PLACEMENTS)
def test_block_slices_match_the_jax_placement(sizes, spec, shape):
    jmesh = _jax_mesh(sizes)
    cleaned = [s if s is None or all(a in sizes for a in
                                     (s if isinstance(s, tuple) else (s,)))
               else None for s in spec]
    index = NamedSharding(jmesh, PartitionSpec(*cleaned)) \
        .devices_indices_map(shape)
    for pos in np.ndindex(*jmesh.devices.shape):
        dev = jmesh.devices[pos]
        want = [(sl.start or 0, (sl.stop or n) - (sl.start or 0))
                for sl, n in zip(index[dev], shape)]
        block, cuts = tmesh.block_slices(
            _At(sizes, dict(zip(sizes, pos))), spec, shape)
        got = [(0, n) for n in shape]
        for dim, start, size in cuts:
            got[dim] = (start, size)
        assert got == want, (pos, got, want)
        assert block == tuple(n for _, n in want)


def test_a_dim_that_does_not_split_raises_as_in_jax():
    sizes = {"dp": 2, "pp": 2, "tp": 2}
    with pytest.raises(ValueError, match="should be divisible by 2"):
        jax.device_put(np.zeros((3, 4), np.float32),
                       NamedSharding(_jax_mesh(sizes), PartitionSpec("pp")))
    with pytest.raises(ValueError, match="should be divisible by 2"):
        tmesh.block_slices(_At(sizes), ("pp",), (3, 4))


@pytest.mark.parametrize("sizes,dtensor,manual", [
    ({"dp": 2, "sp": 2}, ("dp", "sp"), ()),
    ({"sp": 2}, ("sp",), ()),
    ({"dp": 2, "tp": 2, "sp": 2}, ("dp", "tp"), ("sp",)),
    ({"dp": 2, "pp": 2, "tp": 2}, ("dp", "tp"), ("pp",)),
    ({"dp": 2, "pp": 2, "ep": 2}, ("dp",), ("pp", "ep")),
])
def test_dtensor_and_manual_axes(sizes, dtensor, manual):
    m = _At(sizes)
    assert m.dtensor_axes == dtensor
    assert m.manual_axes == manual


def _lm_program(strategy, experts=0, optimizer="adam"):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        cost, _ = TT.transformer_lm_parallel(
            vocab_size=64, max_len=16, n_layer=2, n_head=4, d_model=32,
            d_inner=64, strategy=strategy, num_experts=experts)
        opt = tfluid.optimizer.Adam(learning_rate=1e-3) \
            if optimizer == "adam" else tfluid.optimizer.SGD(0.1)
        opt.minimize(cost)
    return main


def test_held_specs_of_the_pipelined_lm_with_adam():
    main = _lm_program(tpar.DistributedStrategy(dp=2, pp=2))
    held = blocks.held_specs(main, _At({"dp": 2, "pp": 2}))
    stage = [n for n in held if "moment" not in n]
    moments = [n for n in held if "moment" in n]
    assert len(stage) == 12 and len(moments) == 24, sorted(held)
    for n in moments:
        param = n.split("_moment")[0]
        assert held[n] == held[param] == main._sharding_hints[param]
    assert all(s[0] == "pp" for s in held.values())
    # no manual axis of more than one rank: nothing is held
    assert blocks.held_specs(main, _At({"dp": 2, "pp": 1})) == {}
    assert blocks.held_specs(main, _At({"dp": 4})) == {}


def test_held_specs_of_the_moe_lm():
    main = _lm_program(tpar.DistributedStrategy(dp=2, ep=2), experts=4,
                       optimizer="sgd")
    held = blocks.held_specs(main, _At({"dp": 2, "ep": 2}))
    assert sorted(held) == ["moe_ffn_0.w_down", "moe_ffn_0.w_up",
                            "moe_ffn_1.w_down", "moe_ffn_1.w_up"]
    assert set(held.values()) == {("ep", None, None)}
