"""Time source variants of the port's CUDA kernels side by side, on one
card, in one process.

A family is one kernel source under ``ops/csrc/`` and its variants: each
variant is the source with a few literal substitutions (every one must
apply). Every variant of the chosen families is built by its own
``nvcc`` (all started together) into ``build/paddle_tpu_torch/trials/``
and timed in turns over ``--rounds`` rounds, with its largest difference
from the source as built. Each launch is timed as device time alone, as
``chip_smoke.py`` times the kernels: a sleep kernel queued before the
start event keeps the card busy while the host enqueues the launch. Some
variants are diagnostic only (their numerics are wrong on purpose): they
show what a part of the kernel costs.

  flash         ``flash_attention.cu``, built for f32 and D <= 64 only:
                the forward, dQ and dK/dV launches at the LM training
                shape (B=32, H=8, T=256, D=64, causal, f32; four input
                sets rotating through the L2).
  matmul_stats  ``matmul_stats.cu``: f32 at the 15 distinct shapes of
                ResNet-50's fused 1x1 convs (batch 32 at 224x224), summed
                over the 36 launches of one training step.
  paged         ``paged_attention.cu``: f32 pools at the serving decode
                shape (a: S=32, H=8, C=1, dk 64, bs 16, 256 positions a
                slot, four layers of 33.5 MB rotating through the L2),
                decode over ragged chains (b) and a prefill chunk (c:
                S=1, C=16, a chain of 14 blocks), at
                the host rule's split count and at each of
                ``PAGED_SPLITS`` (the split-rule variants).

``--baseline FAMILY=PATH`` adds another version of a family's source (for
example the parent commit's, unpacked from ``git archive``); its C
interface must be the family's own, except for ``paged``, where the
baseline is called through the interface of the first version (no
splits; one launch per call).

Run on the card from the repository root:
    python3 -m paddle_tpu_torch.tools.kernel_trials [flash] [matmul_stats]
        [paged] [--rounds 2] [--baseline matmul_stats=PARENT.cu]
"""

import argparse
import ctypes
import os
import re
import subprocess

import torch

from paddle_tpu_torch.ops import _build

OUT = os.path.join(_build.BUILD_DIR, "trials")
HIDE_HOST_CYCLES = 4_000_000       # ~2 ms of the card's clock


def variant_source(text, subs):
    """``text`` with each (old, new) substitution applied in order."""
    for old, new in subs:
        if old not in text:
            raise ValueError("substitution does not apply: %r" % old[:60])
        text = text.replace(old, new)
    return text


def build(sources, out_dir):
    """{name: (ctypes lib or None, ptxas summary or the error)}: each
    source built by its own ``nvcc``, all started together."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src, so = (os.path.join(out_dir, "v%d.%s" % (i, ext))
                   for ext in ("cu", "so"))
        with open(src, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            out[name] = (None, log[-2000:])
            continue
        regs = re.findall(r"Compiling entry function '\w*?\d([a-z][a-z_]*"
                          r"_kernel)I.*?(\d+) bytes spill stores.*?Used "
                          r"(\d+) registers", log, re.S)
        out[name] = (ctypes.CDLL(so), ", ".join(
            "%s %s regs %s B spilled" % (k, r, s) for k, s, r in regs))
    return out


def _launched(rc):
    if rc != 0:
        raise RuntimeError("kernel launch failed: cudaError_t %d" % rc)


def _events_ms(fn, reps):
    """Mean device ms of ``fn(i)`` over ``reps`` calls, each as device
    time alone (a sleep kernel before the start event hides the host)."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    pairs = []
    for i in range(reps):
        torch.cuda._sleep(HIDE_HOST_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(i)
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


# -- flash ------------------------------------------------------------------
_F_SPLIT = ("    big = to_tf32(x);\n"
            "    small = to_tf32(x - __uint_as_float(big));")
_F_SMALL_MMAS = ("  if (!A_EXACT) mma(c, a.small, b.big);\n"
                 "  if (!B_EXACT) mma(c, a.big, b.small);\n")
_F_NO_SPLIT = [(_F_SPLIT, "    big = __float_as_uint(x);\n    small = big;")]
_F_ONE_MMA = [(_F_SMALL_MMAS, "")]
_F_CFG64 = ("static constexpr int NW = 4, COLS = 32, MINB = 3;",
            "static constexpr int NW = 4, DSPLIT = 1, COLS = 32, MINB = 3;")

FLASH_VARIANTS = {
    "as built": [],
    "expf": [("constexpr float LOG2E = 1.4426950408889634f;",
              "constexpr float LOG2E = 1.0f;"), ("exp2f(", "expf(")],
    "cvt.rna": [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                 '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" '
                 ': "=r"(r) : "f"(x));\n  return r;')],
    "veltkamp split": [(_F_SPLIT,
                        "    const float c = __fmul_rn(x, 8193.f);\n"
                        "    const float b = __fsub_rn(c, __fsub_rn(c, x));\n"
                        "    big = __float_as_uint(b);\n"
                        "    small = to_tf32(__fsub_rn(x, b));")],
    "2 blocks/SM": [(c, c.replace("MINB = 3", "MINB = 2")) for c in _F_CFG64],
    "64-wide tiles": [(c, c.replace("COLS = 32, MINB = 3",
                                    "COLS = 64, MINB = 2")) for c in _F_CFG64],
    "no split (wrong)": _F_NO_SPLIT,
    "one MMA (wrong)": _F_ONE_MMA,
    "one MMA, no split (wrong)": _F_NO_SPLIT + _F_ONE_MMA,
    "fwd 64-key tiles, 2 blocks/SM": [
        ("static constexpr int NW = 4, MINB = 3, COLS = 32;",
         "static constexpr int NW = 4, MINB = 2, COLS = 64;")],
}

_ONLY_F32_64 = ("#define PTT_DISPATCH(FN, ...) \\\n"
                "  do { return (int)FN<float, 64>(__VA_ARGS__); } while (0)")


def _flash_prepare(text):
    """Only the f32, D <= 64 instantiations: the dispatch macro's body."""
    start = text.index("#define PTT_DISPATCH")
    end = text.index("} while (0)", start) + len("} while (0)")
    return text[:start] + _ONLY_F32_64 + text[end:]


def _flash_inputs():
    from paddle_tpu_torch.ops import flash_attention as F
    b, h, t, d = 32, 8, 256, 64
    scale = d ** -0.5
    sets = []
    for s in range(4):
        g = torch.Generator(device="cuda").manual_seed(s)
        q, k, v, do = [torch.randn(b, h, t, d, generator=g, device="cuda")
                       for _ in range(4)]
        o, lse = F._dense_lse(q, k, v, True, scale)
        sets.append((q, k, v, o.contiguous(), do, lse.contiguous(),
                     (do * o).sum(-1)))
    outs = [torch.empty_like(sets[0][0]) for _ in range(4)]
    rows = [torch.empty(b, h, t, device="cuda") for _ in range(2)]
    return (b * h, t, d, scale), sets, outs, rows


def _flash_time(lib, inputs, reps):
    (bh, t, d, scale), sets, (o_out, dq, dk, dv), (lse_out, delta) = inputs
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i, i, i, f, i, i, p]
    lib.ptt_flash_fwd.argtypes = [p] * 5 + tail
    lib.ptt_flash_bwd_dq.argtypes = [p] * 9 + tail
    lib.ptt_flash_bwd_dkv.argtypes = [p] * 8 + tail
    for fn in (lib.ptt_flash_fwd, lib.ptt_flash_bwd_dq, lib.ptt_flash_bwd_dkv):
        fn.restype = i
    dims = (bh, t, d, scale, 1, 0, None)

    def fwd(j):
        q, k, v = sets[j % 4][:3]
        _launched(lib.ptt_flash_fwd(
            *[x.data_ptr() for x in (q, k, v, o_out, lse_out)], *dims))

    def dq_(j):
        q, k, v, o, do, lse, _ = sets[j % 4]
        # dlse None; the kernel writes delta for dK/dV
        _launched(lib.ptt_flash_bwd_dq(
            *[x.data_ptr() for x in (q, k, v, o, do, lse)], None,
            delta.data_ptr(), dq.data_ptr(), *dims))

    def dkv(j):
        q, k, v, _, do, lse, dl = sets[j % 4]
        _launched(lib.ptt_flash_bwd_dkv(
            *[x.data_ptr() for x in (q, k, v, do, lse, dl, dk, dv)], *dims))

    times = {"fwd": _events_ms(fwd, reps), "dq": _events_ms(dq_, reps),
             "dkv": _events_ms(dkv, reps)}
    times["dq+dkv"] = times["dq"] + times["dkv"]
    for fn in (fwd, dq_, dkv):
        fn(0)
    torch.cuda.synchronize()
    return times, [x.clone() for x in (o_out, lse_out, dq, dk, dv)]


# -- matmul_stats -----------------------------------------------------------
# (M, K, N) of the 1x1 convs that feed a train-mode batch norm in one
# ResNet-50 step (batch 32, 224x224), and how many of each
MM_SHAPES = {
    (100352, 256, 64): 2, (100352, 64, 256): 4, (100352, 64, 64): 1,
    (25088, 512, 128): 3, (25088, 256, 512): 1, (25088, 256, 128): 1,
    (25088, 128, 512): 4, (6272, 1024, 256): 5, (6272, 512, 1024): 1,
    (6272, 512, 256): 1, (6272, 256, 1024): 6, (1568, 2048, 512): 2,
    (1568, 1024, 2048): 1, (1568, 1024, 512): 1, (1568, 512, 2048): 3,
}

_M_SPLIT = ("  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
            "  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;")
_M_FRESH = ("  float d[4] = {0.f, 0.f, 0.f, 0.f};\n"
            "  mma_tf32(d, a.small, b.big);\n"
            "  mma_tf32(d, a.big, b.small);\n"
            "  mma_tf32(d, a.big, b.big);\n"
            "#pragma unroll\n"
            "  for (int e = 0; e < 4; ++e) c[e] += d[e];")
_M_TILE_RULE = "  if (n > 64 && blocks(m, n, 128, 128) >= sms) {"
_M_NS2 = [("constexpr int NS = 3;", "constexpr int NS = 2;")]
_M_UNROLL = [("#pragma unroll 1\n      for (int e = threadIdx.x;",
              "      for (int e = threadIdx.x;")]
_M_W32 = [("template <> struct Tile<128, 128> { static constexpr int WM = 64, "
           "MINB = 2; };",
           "template <> struct Tile<128, 128> { static constexpr int WM = 32, "
           "MINB = 1; };"),
          ("template <> struct Tile<128, 64> { static constexpr int WM = 64, "
           "MINB = 2; };",
           "template <> struct Tile<128, 64> { static constexpr int WM = 32, "
           "MINB = 2; };")]
_M_IN_ORDER = [('  asm("mma.sync.aligned.m16n8k8',
                '  asm volatile("mma.sync.aligned.m16n8k8')]

# Split once per block instead of once per warp that reads an element: a
# pass over each landed f32 stage leaves big = tf32(x) in place and writes
# small = x - big (half a TF32 ulp added, the MMA clears the rest) to one
# more stage-sized buffer; the fragments then read both without splitting.
_M_PRESPLIT_FN = r"""
template <int MI, int NI, int BK, int LD>
__device__ __forceinline__ void slice_mma_split(
    float (&acc)[MI][NI][4], const float* xb, const float* wb,
    const float* xsm, const float* wsm, int g, int tq) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    FragB b[NI];
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int i = (8 * ni + g) * LD + 8 * kk + tq;
      b[ni].big[0] = __float_as_uint(wb[i]);
      b[ni].big[1] = __float_as_uint(wb[i + 4]);
      b[ni].small[0] = __float_as_uint(wsm[i]);
      b[ni].small[1] = __float_as_uint(wsm[i + 4]);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int i = (16 * mi + g) * LD + 8 * kk + tq;
      FragA a;
      a.big[0] = __float_as_uint(xb[i]);
      a.big[1] = __float_as_uint(xb[i + 8 * LD]);
      a.big[2] = __float_as_uint(xb[i + 4]);
      a.big[3] = __float_as_uint(xb[i + 8 * LD + 4]);
      a.small[0] = __float_as_uint(xsm[i]);
      a.small[1] = __float_as_uint(xsm[i + 8 * LD]);
      a.small[2] = __float_as_uint(xsm[i + 4]);
      a.small[3] = __float_as_uint(xsm[i + 8 * LD + 4]);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma3(acc[mi][ni], a, b[ni]);
    }
  }
}

// One block per BM x BN tile of y: the tile"""
_M_PRESPLIT_LOOP = r"""    const T* xs = smem + (kt % NS) * STAGE;
    if constexpr (sizeof(T) == 4) {
      float* raw = reinterpret_cast<float*>(smem + (kt % NS) * STAGE);
      float* sm = reinterpret_cast<float*>(smem + NS * STAGE);
      for (int e = threadIdx.x; e < (BM + BN) * BK / 4; e += NTH) {
        const int i = (e / (BK / 4)) * LD + (e % (BK / 4)) * 4;
        float4 v = *reinterpret_cast<float4*>(raw + i), lo;
        float* pv = &v.x;
        float* pl = &lo.x;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t big, small;
          split(pv[j], big, small);
          pl[j] = __uint_as_float(small);
          pv[j] = __uint_as_float(big);
        }
        *reinterpret_cast<float4*>(raw + i) = v;
        *reinterpret_cast<float4*>(sm + i) = lo;
      }
      __syncthreads();
      slice_mma_split<MI, NI, BK, LD>(
          acc, raw + wm * WM * LD, raw + (BM + wn * WN) * LD,
          sm + wm * WM * LD, sm + (BM + wn * WN) * LD, g, tq);
    } else {
      slice_mma<MI, NI, BK, LD>(acc, xs + wm * WM * LD,
                                xs + (BM + wn * WN) * LD, g, tq);
    }"""
_M_PRESPLIT = [
    ("\n// One block per BM x BN tile of y: the tile", _M_PRESPLIT_FN),
    ("    const T* xs = smem + (kt % NS) * STAGE;\n"
     "    slice_mma<MI, NI, BK, LD>(acc, xs + wm * WM * LD,\n"
     "                              xs + (BM + wn * WN) * LD, g, tq);",
     _M_PRESPLIT_LOOP),
    ("  const size_t smem = sizeof(T) * NS * (BM + BN) * LD;",
     "  const size_t smem = sizeof(T) * (NS + 1) * (BM + BN) * LD;"),
]

MM_VARIANTS = {
    "as built": [],
    "small masked (5 operations)": [
        (_M_SPLIT, "  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
                   "  small = (__float_as_uint(x - __uint_as_float(big))"
                   " + 0x1000u) & 0xffffe000u;")],
    "truncated split (2 operations)": [
        (_M_SPLIT, "  big = __float_as_uint(x) & 0xffffe000u;\n"
                   "  small = __float_as_uint(x - __uint_as_float(big));")],
    "split once per block": _M_PRESPLIT,
    "2 stages": _M_NS2,
    "staging unrolled": _M_UNROLL,
    "2 stages, staging unrolled": _M_NS2 + _M_UNROLL,
    "32-row warps": _M_W32,
    "MMAs in order": _M_IN_ORDER,
    "no 128x128 tiles": [(_M_TILE_RULE, "  if (false) {")],
    "chained accumulator (inexact)": [
        (_M_FRESH, "  mma_tf32(c, a.small, b.big);\n"
                   "  mma_tf32(c, a.big, b.small);\n"
                   "  mma_tf32(c, a.big, b.big);")],
    "no split (wrong)": [(_M_SPLIT, "  big = __float_as_uint(x);\n"
                                    "  small = big;")],
    "one MMA (wrong)": [(_M_FRESH, "  mma_tf32(c, a.big, b.big);")],
}


def _mm_inputs():
    cases = {}
    for s, (m, k, n) in enumerate(sorted(MM_SHAPES, reverse=True)):
        g = torch.Generator(device="cuda").manual_seed(s)
        x = torch.randn(m, k, generator=g, device="cuda")
        w = torch.randn(n, k, generator=g, device="cuda") * k ** -0.5
        c = 0.1 * torch.randn(n, generator=g, device="cuda")
        # the scratch holds row blocks of 64, the fewest rows of a tile
        cases[m, k, n] = (x, w, c, torch.empty(m, n, device="cuda"),
                          torch.empty(2, -(-m // 64), n, device="cuda"),
                          torch.empty(2, n, device="cuda"))
    return cases


def _mm_time(lib, cases, reps):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ptt_matmul_stats.argtypes = [p] * 6 + [i] * 4 + [p]
    lib.ptt_matmul_stats.restype = i
    times, got = {"step": 0.0}, []
    for (m, k, n), (x, w, c, y, part, s) in cases.items():
        def launch(_):
            _launched(lib.ptt_matmul_stats(
                x.data_ptr(), w.data_ptr(), c.data_ptr(), y.data_ptr(),
                part.data_ptr(), s.data_ptr(), m, k, n, 0, None))
        ms = _events_ms(launch, reps)
        times["step"] += MM_SHAPES[m, k, n] * ms
        times["M=%d K=%d N=%d" % (m, k, n)] = ms
        launch(0)
        torch.cuda.synchronize()
        got += [y.clone(), s.clone()]
    return times, got


# -- paged ------------------------------------------------------------------
_P_NS = "constexpr int NS = 3;            // cp.async ring stages"
_P_KG = "constexpr int KG = 4;            // keys a warp scores per softmax"
_P_MINB = "RW == 1 ? (NC == 1 ? 8 : 4)"

# the first design of the split merge: a second kernel, one warp per row
_P_MERGE_KERNEL = r"""// A second launch merges the splits' partials.
__global__ void __launch_bounds__(NT) paged_merge_kernel(
    const float* __restrict__ part, float* __restrict__ out, long long nrow,
    int dk, int splits) {
  const long long row = (long long)blockIdx.x * NW + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= nrow) return;
  const float* ml = part + (long long)splits * nrow * dk;
  float mx = NEG_INF;
  for (int i = 0; i < splits; ++i) mx = fmaxf(mx, ml[2 * (i * nrow + row)]);
  float lsum = 0.f;
  for (int i = 0; i < splits; ++i) {
    const long long pr = i * nrow + row;
    lsum = fmaf(ml[2 * pr + 1], expf(ml[2 * pr] - mx), lsum);
  }
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  for (int d = lane; d < dk; d += 32) {
    float o = 0.f;
    for (int i = 0; i < splits; ++i) {
      const long long pr = i * nrow + row;
      o = fmaf(part[pr * dk + d], expf(ml[2 * pr] - mx), o);
    }
    out[row * dk + d] = o * inv;
  }
}

// Raise a kernel's dynamic shared-memory cap"""
_P_TWO_LAUNCHES = [
    ("  if (a.splits == 1) return;\n\n  // count this block in",
     "  return;\n  // count this block in"),
    ("// Raise a kernel's dynamic shared-memory cap", _P_MERGE_KERNEL),
    ("  fn<<<grid, NT, lay.total, st>>>(a);\n  return cudaGetLastError();",
     "  fn<<<grid, NT, lay.total, st>>>(a);\n"
     "  err = cudaGetLastError();\n"
     "  if (err != cudaSuccess || a.splits == 1) return err;\n"
     "  const long long nrow = (long long)a.S * a.H * a.C;\n"
     "  paged_merge_kernel<<<(unsigned)((nrow + NW - 1) / NW), NT, 0, st>>>(\n"
     "      a.part, a.out, nrow, a.dk, a.splits);\n"
     "  return cudaGetLastError();"),
]

PAGED_VARIANTS = {
    "as built": [],
    "merge kernel (two launches)": _P_TWO_LAUNCHES,
    "2 stages": [(_P_NS, _P_NS.replace("3;", "2;"))],
    "4 stages": [(_P_NS, _P_NS.replace("3;", "4;"))],
    "6 stages": [(_P_NS, _P_NS.replace("3;", "6;"))],
    "2 keys per update": [(_P_KG, _P_KG.replace("4;", "2;"))],
    "decode registers for 4 blocks/SM": [
        (_P_MINB, "RW == 1 ? (NC == 1 ? 4 : 4)")],
}
# split counts timed beside the host rule's at each shape
PAGED_SPLITS = {"a": (1, 2, 8, 16), "b": (1, 2, 8), "c": (1, 4, 14)}


def _paged_inputs(device="cuda"):
    """The serving decode shape (a), decode over ragged chains of 1..16
    blocks (b) and a prefill chunk (c) on one f32 pool of 512 blocks x
    4 layers (S=32, H=8, bs 16, dk 64)."""
    s, h, bs, dk, nbmax, layers = 32, 8, 16, 64, 16, 4
    g = torch.Generator(device=device).manual_seed(0)
    shape = (s * nbmax, layers, h, bs, dk)
    pk = torch.randn(shape, generator=g, device=device)
    pv = torch.randn(shape, generator=g, device=device)
    btab = torch.randperm(s * nbmax, generator=g, device=device).reshape(
        s, nbmax).to(torch.int32)
    q = torch.randn(s, h, 1, dk, generator=g, device=device) / 8
    ragged = torch.randint(0, nbmax * bs, (s, 1), generator=g,
                           device=device, dtype=torch.int32)
    shapes = {
        "a": (q, btab, torch.full((s, 1), nbmax * bs - 1, dtype=torch.int32,
                                  device=device), nbmax),
        "b": (q, btab, ragged, int(ragged.max()) // bs + 1),
        "c": (torch.randn(1, h, 16, dk, generator=g, device=device) / 8,
              btab[:1].contiguous(),
              torch.arange(13 * bs, 14 * bs, dtype=torch.int32,
                           device=device)[None], 14)}
    return pk, pv, {k: v[:3] + (torch.tensor([v[3]], dtype=torch.int32,
                                             device=device),)
                    for k, v in shapes.items()}


def _paged_time(lib, inputs, reps):
    from paddle_tpu_torch.ops import paged_attention as P
    pk, pv, shapes = inputs
    p = ctypes.c_void_p
    lib.ptt_paged_attention.argtypes = [p] * 11 + [
        ctypes.POINTER(ctypes.c_longlong), p]
    lib.ptt_paged_attention.restype = ctypes.c_int
    times, got = {}, []
    for name, (q, bt, qp, nblk) in shapes.items():
        rule = P._splits(q.shape[0], q.shape[1], q.shape[2], bt.shape[1],
                         pk.shape[3])
        for splits in (rule,) + PAGED_SPLITS[name]:
            # out allocated here, outside the timed span
            calls = [P._launch_args(q, pk, pv, bt, qp, nblk, None, None,
                                    layer, splits) for layer in range(4)]

            def launch(j):
                _launched(lib.ptt_paged_attention(*calls[j % 4][1]))
            key = name if splits == rule else "%s splits=%d" % (name,
                                                                  splits)
            times[key] = _events_ms(launch, reps)
            if splits == rule:
                launch(0)
                torch.cuda.synchronize()
                got.append(calls[0][0].clone())
    return times, got


def _paged_time_first_version(lib, inputs, reps):
    """The first version's C interface: one launch per call, int strides
    (p_sb, p_sl, p_sh, p_sp, s_sb, s_sl, s_sh), no splits."""
    pk, pv, shapes = inputs
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ptt_paged_attention.argtypes = [p] * 9 + [i] * 14 + [i, p]
    lib.ptt_paged_attention.restype = i
    times, got = {}, []
    st = pk.stride()
    for name, (q, bt, qp, nblk) in shapes.items():
        s, h, c, dk = q.shape
        out = torch.empty_like(q)

        def launch(j):
            _launched(lib.ptt_paged_attention(
                q.data_ptr(), pk.data_ptr(), pv.data_ptr(), None, None,
                bt.data_ptr(), qp.data_ptr(), nblk.data_ptr(),
                out.data_ptr(), s, h, c, dk, pk.shape[3], bt.shape[1], j % 4,
                st[0], st[1], st[2], st[3], 0, 0, 0, 0, None))
        times[name] = _events_ms(launch, reps)
        launch(0)
        torch.cuda.synchronize()
        got.append(out.clone())
    return times, got


class Family:
    def __init__(self, source, variants, inputs, time, prepare=None,
                 reps=20, baseline_time=None):
        self.source = os.path.join(_build._CSRC, source)
        self.variants = variants
        self.inputs, self.time, self.reps = inputs, time, reps
        self.prepare = prepare or (lambda text: text)
        self.baseline_time = baseline_time or time

    def sources(self, baseline=None):
        """{variant name: source text}, the baseline's last when given."""
        with open(self.source) as f:
            text = f.read()
        out = {name: self.prepare(variant_source(text, subs))
               for name, subs in self.variants.items()}
        if baseline:
            with open(baseline) as f:
                out["baseline"] = self.prepare(f.read())
        return out


FAMILIES = {
    "flash": Family("flash_attention.cu", FLASH_VARIANTS, _flash_inputs,
                    _flash_time, prepare=_flash_prepare, reps=50),
    "matmul_stats": Family("matmul_stats.cu", MM_VARIANTS, _mm_inputs,
                           _mm_time),
    "paged": Family("paged_attention.cu", PAGED_VARIANTS, _paged_inputs,
                    _paged_time, reps=100,
                    baseline_time=_paged_time_first_version),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("families", nargs="*", choices=sorted(FAMILIES),
                    help="kernel families to time (default: all)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--baseline", action="append", default=[],
                    metavar="FAMILY=PATH",
                    help="another version of a family's source")
    args = ap.parse_args()
    baselines = dict(b.split("=", 1) for b in args.baseline)
    names = args.families or sorted(FAMILIES)
    sources = {fam: FAMILIES[fam].sources(baselines.get(fam))
               for fam in names}
    # every nvcc of every family started together
    built = build({(fam, v): text for fam in names
                   for v, text in sources[fam].items()}, OUT)
    for (fam, v), (lib, info) in built.items():
        print("build %-12s %-30s %s" % (fam, v, info if lib else
                                        "FAILED\n" + info), flush=True)
    inputs = {fam: FAMILIES[fam].inputs() for fam in names}
    ref = {}
    for rnd in range(args.rounds):
        for fam in names:
            for v in sources[fam]:
                lib = built[fam, v][0]
                if lib is None:
                    continue
                family = FAMILIES[fam]
                timer = family.baseline_time if v == "baseline" else \
                    family.time
                times, got = timer(lib, inputs[fam], family.reps)
                base = ref.setdefault(fam, got)
                diff = max(float((a - b).abs().max())
                           for a, b in zip(got, base))
                print("round %d  %-12s %-30s %s  max|diff vs as built| %.3g"
                      % (rnd, fam, v, "  ".join("%s %.5f ms" % kv for kv in
                                                times.items()), diff),
                      flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
