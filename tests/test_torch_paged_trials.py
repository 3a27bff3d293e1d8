"""The paged-attention pieces of the card-side scripts that the CPU can
check: the kernel trials tool's ``paged`` variants (literal substitutions
of the kernel source, each of which must apply), the names
``chip_smoke.py`` gives the paged kernels in its ptxas report (fp8 pools
included; a kernel that is no template keeps its bare name), its case
list (every pool type, C, dk, bs and chain length the kernel is held
to), and the bytes its bound counts. (The builds, checks and timings run
on the card.)"""

import importlib.util
import os

import pytest
import torch

from paddle_tpu_torch.ops import paged_attention as P
from paddle_tpu_torch.tools import kernel_trials as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY = T.FAMILIES["paged"]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sources():
    return FAMILY.sources()


@pytest.mark.parametrize("name", sorted(T.PAGED_VARIANTS))
def test_paged_variant_applies_and_keeps_the_interface(sources, name):
    text = sources[name]
    assert 'extern "C" int ptt_paged_attention(' in text
    for _, new in T.PAGED_VARIANTS[name]:
        assert new in text
    assert (text == sources["as built"]) == (name == "as built")


def test_paged_baseline_takes_the_first_version_interface():
    assert FAMILY.baseline_time is T._paged_time_first_version
    assert FAMILY.time is T._paged_time
    assert set(T.PAGED_SPLITS) == {"a", "b", "c"}


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_122paged_attention_kernelI13__nv_fp8_e4m3Lb1ELi4ELi4"
     "EEEvNS_4ArgsE", "paged_attention_kernel<fp8, true, 4, 4>"),
    ("_ZN12_GLOBAL__N_122paged_attention_kernelIaLb1ELi1ELi1EEEvNS_4ArgsE",
     "paged_attention_kernel<int8, true, 1, 1>"),
    ("_ZN12_GLOBAL__N_122paged_attention_kernelIfLb0ELi2ELi4EEEvNS_4ArgsE",
     "paged_attention_kernel<float, false, 2, 4>"),
    ("_ZN12_GLOBAL__N_122paged_attention_kernelI13__nv_bfloat16Lb0ELi1ELi1"
     "EEEvNS_4ArgsE", "paged_attention_kernel<bf16, false, 1, 1>"),
    ("_ZN12_GLOBAL__N_110foo_kernelEPKfPfxii", "foo_kernel"),
])
def test_chip_smoke_names_paged_kernels(smoke, mangled, name):
    text = ("ptxas info    : Compiling entry function '%s' for 'sm_90a'\n"
            "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
            "loads\nptxas info    : Used 64 registers, used 1 barriers\n"
            % mangled)
    assert smoke._ptxas_report(text) == {name: (64, 8, 4)}


def test_chip_smoke_paged_cases_cover_the_contract(smoke):
    """Every pool type at C 1, 5 and 16; dk 64, 128 and 256; bs 16 and
    32; chains of 128 blocks; 1-byte tiles that need 8-byte copies."""
    seen = set()
    for s, c, dk, bs, nbmax, quants in smoke.PAGED_CASES:
        for quant in quants:
            seen.add((quant, c, dk, bs, nbmax))
    for quant in smoke.QUANTS:
        for c in (1, 5, 16):
            for dk in (64, 128, 256):
                assert (quant, c, dk, 16, 16) in seen, (quant, c, dk)
        assert {(quant, c, 64, 32, 8) for c in (1, 16)} <= seen
    assert {q for q, _, _, _, nbmax in seen if nbmax == 128} == {"fp32",
                                                                 "fp8"}
    tiny = [(q, bs, dk) for q, _, dk, bs, _ in seen
            if P._granule(bs, dk, 1) == 8]
    assert {q for q, _, _ in tiny} == {"int8", "fp8"}


def test_chip_smoke_paged_bound_counts_live_bytes(smoke):
    """Shape (a): 32 slots x 8 heads x 256 positions x 64 of K and V in
    f32 (33.5 MB) plus q, out and the tables; ragged chains count only
    their own blocks."""
    q = torch.zeros(32, 8, 1, 64)
    full = torch.full((32, 1), 255, dtype=torch.int32)
    nbytes, flops = smoke._paged_work(q, full, 8, 64, 16)
    kv = 2 * 32 * 8 * 256 * 64 * 4
    assert nbytes == kv + 2 * q.numel() * 4 + 4 * (32 + 32 * 16)
    assert flops == 4 * 32 * 256 * 8 * 64
    short = full.clone()
    short[1:] = 15                       # one block for every other slot
    nb2, _ = smoke._paged_work(q, short, 8, 64, 16)
    assert nb2 - 2 * q.numel() * 4 - 4 * (32 + 47) == 2 * 47 * 8 * 16 * 64 * 4
