"""The kernel trials tool builds its LSTM step variants from the kernel
source by literal substitutions: each must still apply to the source as
it stands and keep the C interface, and the shape and lengths it times
must be the stacked LSTM's, as ``chip_smoke.py`` runs it. (The builds
and timings run on the card.)"""

import importlib.util
import os

import numpy as np
import pytest

from paddle_tpu_torch.tools import kernel_trials as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY = T.FAMILIES["lstm"]


@pytest.fixture(scope="module")
def sources():
    return FAMILY.sources()


@pytest.mark.parametrize("name", sorted(T.LSTM_VARIANTS))
def test_variant_applies_and_keeps_the_interface(sources, name):
    text = sources[name]
    for entry in ("int ptt_lstm_step_fwd(", "int ptt_lstm_step_bwd(",
                  "ptt_lstm_step_error_string("):
        assert entry in text
    for _, new in T.LSTM_VARIANTS[name]:
        assert new in text
    assert (text == sources["as built"]) == (name == "as built")


def test_a_stale_substitution_raises(sources):
    with pytest.raises(ValueError, match="does not apply"):
        T.variant_source(sources["as built"], [("no such line;", "")])


def test_shape_and_lengths_are_the_stacked_lstms():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert T.LSTM_SHAPE == (smoke.LSTM["batch"], smoke.LSTM["hidden"])
    assert T._lstm_lengths() == smoke._lstm_lengths(
        np.random.RandomState(0))
