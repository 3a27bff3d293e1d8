"""The kernel trials tool builds its flash-attention variants from the
kernel source by literal substitutions: each must still apply to the
source as it stands, and each variant keeps the C interface while
building only the f32, D <= 64 kernels. ``chip_smoke.py`` reads each
kernel's registers and spills from the same ptxas report. (The builds
and timings run on the card.)"""

import importlib.util
import os

import pytest

from paddle_tpu_torch.tools import kernel_trials as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY = T.FAMILIES["flash"]

# nvcc -Xptxas -v, as it reports two of the backward instantiations
PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash_bwd_dq_\
kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_S4_PKfS6_PfPS2_iifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash_bwd_dq_\
kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_S4_S4_PKfS6_PfPS2_iifi
    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16 bytes cumulative \
stack size
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_bwd_dkv\
_kernelIfLi64EEEvPKT_S3_S3_S3_PKfS5_PS1_S6_iifi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_bwd_dkv\
_kernelIfLi64EEEvPKT_S3_S3_S3_PKfS5_PS1_S6_iifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 167 registers, used 1 barriers
"""


def test_chip_smoke_reads_registers_and_spills():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke._ptxas_report(PTXAS) == {
        "flash_bwd_dq_kernel<bf16, 64>": (128, 12, 12),
        "flash_bwd_dkv_kernel<float, 64>": (167, 0, 0)}
    assert smoke._ptxas_report("") == {}


@pytest.fixture(scope="module")
def sources():
    return FAMILY.sources()


@pytest.mark.parametrize("name", sorted(T.FLASH_VARIANTS))
def test_variant_applies_and_keeps_the_interface(sources, name):
    text = sources[name]
    for entry in ("ptt_flash_fwd(", "ptt_flash_bwd_dq(", "ptt_flash_bwd_dkv("):
        assert 'extern "C" int ' + entry in text
    assert "FN<float, 64>(__VA_ARGS__)" in text
    assert "FN<float, 128>" not in text and "__nv_bfloat16, 64>(" not in text
    for old, new in T.FLASH_VARIANTS[name]:
        assert new in text
    assert (text == sources["as built"]) == (name == "as built")


def test_a_stale_substitution_raises(sources):
    with pytest.raises(ValueError, match="does not apply"):
        T.variant_source(sources["as built"], [("no such line;", "")])


def test_chip_smoke_names_matmul_stats_tiles():
    """Kernels with several template arguments (matmul_stats' tile
    classes) keep them all in the name chip_smoke.py reports."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    text = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119matmul_"
        "stats_kernelIfLi128ELi64EEEvPKT_S3_PKfPS1_Pfiiibb' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 123 registers, used 1 barriers\n")
    assert smoke._ptxas_report(text) == {
        "matmul_stats_kernel<float, 128, 64>": (123, 0, 0)}


@pytest.mark.parametrize("family", sorted(T.FAMILIES))
def test_every_family_applies_its_variants_and_a_baseline(family):
    """Each family's variants all apply, "as built" first (the reference
    of every difference the tool prints), and ``--baseline`` adds the
    given source last, prepared as the variants are."""
    fam = T.FAMILIES[family]
    got = fam.sources(baseline=fam.source)
    assert list(got) == list(fam.variants) + ["baseline"]
    assert list(got)[0] == "as built"
    assert got["baseline"] == got["as built"]
