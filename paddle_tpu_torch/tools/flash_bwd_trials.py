"""Time source variants of the flash-attention backward kernels side by
side, on one card, in one process.

Each variant is ``ops/csrc/flash_attention.cu`` with a few literal
substitutions (every one must apply), built for f32 and D <= 64 only
(one ``nvcc`` per variant, all started together) into
``build/paddle_tpu_torch/trials/``. The dQ and dK/dV launches are timed at
the LM training shape (B=32, H=8, T=256, D=64, causal, f32; four input
sets rotating through the L2, CUDA events around each launch), in turns
over ``--rounds`` rounds, with each variant's largest difference from the
source as built. Some variants are diagnostic only (their numerics are
wrong on purpose): they show what a part of the kernel costs.

``--baseline PATH`` adds another version of the source (for example the
parent commit's, unpacked from ``git archive``); a source whose dQ entry
point takes no O and dLSE gets delta from plain PyTorch.

Run on the card from the repository root:
    python3 -m paddle_tpu_torch.tools.flash_bwd_trials [--rounds 2]
"""

import argparse
import ctypes
import os
import re
import subprocess

import torch

from paddle_tpu_torch.ops import _build

SRC = os.path.join(_build._CSRC, "flash_attention.cu")
OUT = os.path.join(_build.BUILD_DIR, "trials")

_SPLIT = ("    big = to_tf32(x);\n"
          "    small = to_tf32(x - __uint_as_float(big));")
_SMALL_MMAS = ("  if (!A_EXACT) mma(c, a.small, b.big);\n"
               "  if (!B_EXACT) mma(c, a.big, b.small);\n")
_NO_SPLIT = [(_SPLIT, "    big = __float_as_uint(x);\n    small = big;")]
_ONE_MMA = [(_SMALL_MMAS, "")]
_CFG64 = ("static constexpr int NW = 4, COLS = 32, MINB = 3;",
          "static constexpr int NW = 4, DSPLIT = 1, COLS = 32, MINB = 3;")

# name -> substitutions (old, new) applied to the source in order
VARIANTS = {
    "as built": [],
    "expf": [("constexpr float LOG2E = 1.4426950408889634f;",
              "constexpr float LOG2E = 1.0f;"), ("exp2f(", "expf(")],
    "cvt.rna": [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                 '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" '
                 ': "=r"(r) : "f"(x));\n  return r;')],
    "veltkamp split": [(_SPLIT,
                        "    const float c = __fmul_rn(x, 8193.f);\n"
                        "    const float b = __fsub_rn(c, __fsub_rn(c, x));\n"
                        "    big = __float_as_uint(b);\n"
                        "    small = to_tf32(__fsub_rn(x, b));")],
    "2 blocks/SM": [(c, c.replace("MINB = 3", "MINB = 2")) for c in _CFG64],
    "64-wide tiles": [(c, c.replace("COLS = 32, MINB = 3",
                                    "COLS = 64, MINB = 2")) for c in _CFG64],
    "no split (wrong)": _NO_SPLIT,
    "one MMA (wrong)": _ONE_MMA,
    "one MMA, no split (wrong)": _NO_SPLIT + _ONE_MMA,
}

_ONLY_F32_64 = ("#define PTT_DISPATCH(FN, ...) \\\n"
                "  do { return (int)FN<float, 64>(__VA_ARGS__); } while (0)")


def variant_source(text, subs):
    for old, new in subs:
        if old not in text:
            raise ValueError("substitution does not apply: %r" % old[:60])
        text = text.replace(old, new)
    start = text.index("#define PTT_DISPATCH")
    end = text.index("} while (0)", start) + len("} while (0)")
    return text[:start] + _ONLY_F32_64 + text[end:]


def build(sources):
    """{name: (ctypes lib or None, ptxas summary or the error)}."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src, so = (os.path.join(OUT, "v%d.%s" % (i, ext))
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
        regs = re.findall(r"Compiling entry function '\w*?(flash_\w+?_kernel)"
                          r".*?(\d+) bytes spill stores.*?Used (\d+) "
                          r"registers", log, re.S)
        out[name] = (ctypes.CDLL(so), ", ".join(
            "%s %s regs %s B spilled" % (k, r, s) for k, s, r in regs))
    return out


def _bind(lib, with_delta):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i, i, i, f, i, i, p]
    lib.ptt_flash_fwd.argtypes = [p] * 5 + tail
    lib.ptt_flash_bwd_dq.argtypes = [p] * (9 if with_delta else 7) + tail
    lib.ptt_flash_bwd_dkv.argtypes = [p] * 8 + tail
    for fn in (lib.ptt_flash_fwd, lib.ptt_flash_bwd_dq,
               lib.ptt_flash_bwd_dkv):
        fn.restype = i


def _launched(rc):
    if rc != 0:
        raise RuntimeError("kernel launch failed: cudaError_t %d" % rc)


def _events_ms(fn, reps):
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    pairs = []
    for i in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(i)
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--baseline", help="another flash_attention.cu")
    args = ap.parse_args()
    with open(SRC) as f:
        text = f.read()
    sources = {name: variant_source(text, subs)
               for name, subs in VARIANTS.items()}
    if args.baseline:
        with open(args.baseline) as f:
            sources["baseline"] = variant_source(f.read(), [])
    libs = build(sources)
    for name, (lib, info) in libs.items():
        print("build %-26s %s" % (name, info if lib else "FAILED\n" + info),
              flush=True)
    b, h, t, d = 32, 8, 256, 64
    scale = d ** -0.5
    ref_lib = libs["as built"][0]
    _bind(ref_lib, True)
    sets = []
    for s in range(4):
        g = torch.Generator(device="cuda").manual_seed(s)
        q, k, v, do = [torch.randn(b, h, t, d, generator=g, device="cuda")
                       for _ in range(4)]
        o, lse = torch.empty_like(q), torch.empty(b, h, t, device="cuda")
        _launched(ref_lib.ptt_flash_fwd(q.data_ptr(), k.data_ptr(),
                                        v.data_ptr(), o.data_ptr(),
                                        lse.data_ptr(), b * h, t, d, scale,
                                        1, 0, None))
        sets.append((q, k, v, o, do, lse, (do * o).sum(-1)))
    dq, dk, dv = (torch.empty_like(sets[0][0]) for _ in range(3))
    delta = torch.empty(b, h, t, device="cuda")
    ref = None
    for rnd in range(args.rounds):
        for name, (lib, _) in libs.items():
            if lib is None:
                continue
            new = "const void* dlse" in sources[name]
            _bind(lib, new)

            def run_dq(i, lib=lib, new=new):
                q, k, v, o, do, lse, dl = sets[i % 4]
                ptrs = ((q, k, v, o, do, lse) if new else
                        (q, k, v, do, lse, dl))
                extra = [None, delta.data_ptr()] if new else []
                _launched(lib.ptt_flash_bwd_dq(
                    *[x.data_ptr() for x in ptrs], *extra, dq.data_ptr(),
                    b * h, t, d, scale, 1, 0, None))

            def run_dkv(i, lib=lib):
                q, k, v, _, do, lse, dl = sets[i % 4]
                _launched(lib.ptt_flash_bwd_dkv(
                    *[x.data_ptr() for x in (q, k, v, do, lse, dl, dk, dv)],
                    b * h, t, d, scale, 1, 0, None))

            t_dq, t_dkv = _events_ms(run_dq, args.reps), \
                _events_ms(run_dkv, args.reps)
            run_dq(0)
            run_dkv(0)
            torch.cuda.synchronize()
            got = (dq.clone(), dk.clone(), dv.clone())
            ref = got if ref is None else ref
            diff = max(float((x - y).abs().max()) for x, y in zip(got, ref))
            print("round %d  %-26s dq %.5f ms  dkv %.5f ms  sum %.5f ms  "
                  "max|diff vs as built| %.3g" % (rnd, name, t_dq, t_dkv,
                                                   t_dq + t_dkv, diff),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
