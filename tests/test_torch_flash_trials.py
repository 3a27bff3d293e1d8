"""The flash backward trials tool builds its variants from the kernel
source by literal substitutions: each must still apply to the source as
it stands, and each variant keeps the C interface while building only
the f32, D <= 64 kernels. ``chip_smoke.py`` reads each kernel's
registers and spills from the same ptxas report. (The builds and timings
run on the card.)"""

import importlib.util
import os

import pytest

from paddle_tpu_torch.tools import flash_bwd_trials as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
def source():
    with open(T.SRC) as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(T.VARIANTS))
def test_variant_applies_and_keeps_the_interface(source, name):
    text = T.variant_source(source, T.VARIANTS[name])
    for entry in ("ptt_flash_fwd(", "ptt_flash_bwd_dq(", "ptt_flash_bwd_dkv("):
        assert 'extern "C" int ' + entry in text
    assert "FN<float, 64>(__VA_ARGS__)" in text
    assert "FN<float, 128>" not in text and "__nv_bfloat16, 64>(" not in text
    for old, new in T.VARIANTS[name]:
        assert new in text
    assert (text == T.variant_source(source, [])) == (name == "as built")


def test_a_stale_substitution_raises(source):
    with pytest.raises(ValueError, match="does not apply"):
        T.variant_source(source, [("no such line;", "")])
