"""The kernel trials tool builds its matmul_stats variants from the kernel
source by literal substitutions: each must still apply to the source as
it stands and keep the C interface, and the shapes it times must be the
ResNet-50 step's own, as ``chip_smoke.py`` reads them from the Program.
(The builds and timings run on the card.)"""

import collections
import importlib.util
import os

import pytest

from paddle_tpu_torch.tools import kernel_trials as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY = T.FAMILIES["matmul_stats"]


@pytest.fixture(scope="module")
def sources():
    return FAMILY.sources()


@pytest.mark.parametrize("name", sorted(T.MM_VARIANTS))
def test_variant_applies_and_keeps_the_interface(sources, name):
    text = sources[name]
    for entry in ("ptt_matmul_stats(", "ptt_matmul_stats_tile("):
        assert entry in text
    for _, new in T.MM_VARIANTS[name]:
        assert new in text
    assert (text == sources["as built"]) == (name == "as built")


def test_a_stale_substitution_raises(sources):
    with pytest.raises(ValueError, match="does not apply"):
        T.variant_source(sources["as built"], [("no such line;", "")])


def test_shapes_are_the_resnet50_step():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet as R
    _, shapes = smoke._resnet_program(fluid, R)
    assert dict(collections.Counter(shapes)) == T.MM_SHAPES
    assert sum(T.MM_SHAPES.values()) == smoke.RESNET_FUSED_PER_STEP
