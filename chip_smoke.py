#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``paddle_tpu_torch``) on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (``$CUDA_HOME``, ``PATH`` or
``/usr/local/cuda``) and the repository's sources; it imports neither JAX
nor ``paddle_tpu``. Phases, each fatal on failure:

  1. device — the card's name and power limit (``nvidia-smi``); TF32
     switched off for matmuls and cuDNN, so fp32 stays fp32;
  2. build  — ``ops/csrc/paged_attention.cu`` compiled for sm_90a;
  3. kernel — the CUDA paged-attention kernel held against its plain
     PyTorch version (``_attend_plain``) at rtol 1e-4 / atol 1e-5 on
     live rows: decode (C=1, S=32), a prefill chunk (C=16, S=1), a
     speculative width (C=5), ragged chains of 1..16 blocks, layers 0
     and 3 of a 4-layer pool, fp32, int8 and bf16 pools, bs 16, dk 64;
     then timed at the serving shape against the plain version, one
     PyTorch library call (scaled_dot_product_attention over the
     gathered dense K/V, a yardstick the port never calls) and the
     card's memory-bandwidth bound;
  4. slice  — the flagship ``transformer_lm`` at its own widths (vocab
     4096, max_len 256, 4 layers, 8 heads, d_model 512, d_inner 2048,
     fp32, weights from ``init_stream(seed=0)``) served by
     ``Engine(slots=32, prefill_chunk=16, block_size=16)``: 64 greedy
     requests, half sharing one 64-token prefix. The kernel's launch
     count is reset just before and read just after; tokens must equal
     the gather path's and, for 4 requests, ``sequential_generate``'s.

The last three lines of standard output are the kernels' JSON line, the
``nvidia-smi`` name/power-limit line, and ``{"ok": true, "device": ...}``.
Without a CUDA card, or outside the repository, it exits non-zero and
prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS = 67e12                 # H100 SXM fp32, outside tensor cores
RTOL, ATOL = 1e-4, 1e-5

# the flagship transformer_lm defaults (models/transformer.py)
VOCAB, MAX_LEN, N_LAYER, N_HEAD, D_MODEL, D_INNER = 4096, 256, 4, 8, 512, 2048


class SmokeFailure(Exception):
    pass


def check(cond, msg, *args):
    if not cond:
        raise SmokeFailure(msg % args)


def log(msg, *args):
    print(msg % args if args else msg, flush=True)


# -- phase 1 -------------------------------------------------------------
def device_phase(torch):
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0 and proc.stdout.strip(),
          "nvidia-smi failed: %s", proc.stderr.strip())
    smi = proc.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device: %s (torch %s, CUDA %s, %d card(s)); nvidia-smi: %s",
        torch.cuda.get_device_name(0), torch.__version__,
        torch.version.cuda, torch.cuda.device_count(), smi)
    return smi


# -- phase 2 -------------------------------------------------------------
def build_phase():
    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load("paged_attention")
    log("build: paged_attention.cu in %.2f s", time.perf_counter() - t0)
    for line in _build.build_log.get("paged_attention", "").splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: %s", line.strip())


# -- phase 3 -------------------------------------------------------------
def _pool_case(torch, rng, s, c, chains, quant, layers=4, h=8, bs=16,
               dk=64, nbmax=16):
    dev = torch.device("cuda")
    nb = s * nbmax + 4
    shape = (nb, layers, h, bs, dk)
    pk = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    pv = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    btab = rng.permutation(nb)[:s * nbmax].reshape(s, nbmax)
    qpos = np.stack([rng.integers(0, ch * bs, size=c) for ch in chains])
    qpos[:, -1] = (np.asarray(chains) - 1) * bs + rng.integers(0, bs, s)
    q = rng.normal(size=(s, h, c, dk)).astype(np.float32) * dk ** -0.5
    case = {"q": torch.from_numpy(q).to(dev),
            "btab": torch.from_numpy(btab.astype(np.int32)).to(dev),
            "qpos": torch.from_numpy(qpos.astype(np.int32)).to(dev),
            "k_scale": None, "v_scale": None}
    from paddle_tpu_torch.ops import paged_attention as P
    if quant == "int8":
        pk, case["k_scale"] = P.quantize_kv(pk, torch.int8)
        pv, case["v_scale"] = P.quantize_kv(pv, torch.int8)
    elif quant == "bf16":
        pk, pv = pk.to(torch.bfloat16), pv.to(torch.bfloat16)
    case["pool_k"], case["pool_v"] = pk.contiguous(), pv.contiguous()
    return case


def kernel_phase(torch):
    """Every listed case against the plain version; returns the largest
    absolute error seen."""
    from paddle_tpu_torch.ops import paged_attention as P
    rng = np.random.default_rng(0)
    worst = 0.0
    shapes = [(32, 1), (1, 16), (8, 5)]
    for s, c in shapes:
        for quant in ("fp32", "int8", "bf16"):
            if quant == "bf16" and c != 1:
                continue
            chains = rng.integers(1, 17, size=s)
            chains[0] = 16
            if c == 16:
                chains[0] = 9
            case = _pool_case(torch, rng, s, c, chains, quant)
            for layer in (0, 3):
                # nblk 8 caps the walk below the longest chain: only
                # slots whose own chain fits are live rows
                for nblk in [n for n in (16, 8) if (chains <= n).any()]:
                    args = (case["q"], case["pool_k"], case["pool_v"],
                            case["btab"], case["qpos"])
                    nb_t = torch.tensor([nblk], dtype=torch.int32,
                                        device="cuda")
                    got = P.paged_attention(
                        *args, nblk=nb_t, k_scale=case["k_scale"],
                        v_scale=case["v_scale"], layer=layer)
                    ref = P._attend_plain(
                        *args, nblk, case["k_scale"], case["v_scale"],
                        layer=layer)
                    torch.cuda.synchronize()
                    live = torch.as_tensor(chains <= nblk, device="cuda")
                    err = (got[live] - ref[live]).abs()
                    bad = err > ATOL + RTOL * ref[live].abs()
                    worst = max(worst, float(err.max()))
                    check(bool(torch.isfinite(got[live]).all())
                          and not bool(bad.any()),
                          "kernel disagrees with _attend_plain: S=%d C=%d "
                          "%s layer=%d nblk=%d max_abs_err=%g", s, c,
                          quant, layer, nblk, float(err.max()))
                    log("kernel: S=%-2d C=%-2d %-4s layer=%d nblk=%-2d "
                        "max_abs_err=%.3g  ok", s, c, quant, layer, nblk,
                        float(err.max()))
    return worst


def _time_ms(torch, fn, reps, rounds=4):
    """Mean ms of ``fn(layer)`` over ``reps`` passes of layers 0..3 (a
    different 33.5 MB pool slice each call: 134 MB rotate through the
    50 MB L2, as the decode loop meets them), CUDA-event timed."""
    for layer in range(rounds):
        fn(layer)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for layer in range(rounds):
            fn(layer)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * rounds)


def timing_phase(torch):
    """The serving decode shape: S=32, H=8, dk=64, C=1, 256 cached
    positions (16 blocks of 16) per slot, 4-layer 512-block pool."""
    from paddle_tpu_torch.ops import paged_attention as P
    rng = np.random.default_rng(1)
    s, h, dk, bs, npos, layers = 32, 8, 64, 16, 256, 4
    nbmax = npos // bs
    case = _pool_case(torch, rng, s, 1, [nbmax] * s, "fp32",
                      layers=layers, h=h, bs=bs, dk=dk, nbmax=nbmax)
    case["qpos"].fill_(npos - 1)
    q, pk, pv, bt, qp = (case["q"], case["pool_k"], case["pool_v"],
                         case["btab"], case["qpos"])
    nblk = torch.tensor([nbmax], dtype=torch.int32, device="cuda")
    kernel_ms = _time_ms(torch, lambda l: P.paged_attention(
        q, pk, pv, bt, qp, nblk=nblk, layer=l), reps=50)
    plain_ms = _time_ms(torch, lambda l: P._attend_plain(
        q, pk, pv, bt, qp, nbmax, None, None, layer=l), reps=5)
    dense = []
    for layer in range(layers):
        k = pk[:, layer][bt.long()].permute(0, 2, 1, 3, 4).reshape(
            s, h, npos, dk).contiguous()
        v = pv[:, layer][bt.long()].permute(0, 2, 1, 3, 4).reshape(
            s, h, npos, dk).contiguous()
        dense.append((k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = _time_ms(torch, lambda l: sdpa(
        q, dense[l][0], dense[l][1], scale=1.0), reps=50)
    lib_out = sdpa(q, dense[0][0], dense[0][1], scale=1.0)
    ker_out = P.paged_attention(q, pk, pv, bt, qp, nblk=nblk, layer=0)
    check(torch.allclose(ker_out, lib_out, rtol=RTOL, atol=ATOL),
          "kernel disagrees with scaled_dot_product_attention")
    nbytes = 4 * (2 * s * h * npos * dk + 2 * s * h * dk) + 4 * (
        s * nbmax + s)
    flops = 4 * s * h * npos * dk
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    out = {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    log("timing (S=32 H=8 C=1 dk=64, 256 positions, fp32): kernel_ms=%.5f "
        "plain_ms=%.5f library_ms=%.5f bound_ms=%.5f (%s, %d bytes, %d "
        "flops)", kernel_ms, plain_ms, library_ms, bound_ms,
        out["bound_by"], nbytes, flops)
    return out


# -- phase 4 -------------------------------------------------------------
def _requests(rng):
    prefix = [1] + rng.integers(3, VOCAB, 63).tolist()
    reqs = []
    for i in range(64):
        if i % 2 == 0:
            prompt = prefix + rng.integers(
                3, VOCAB, int(rng.integers(1, 33))).tolist()
        else:
            prompt = [1] + rng.integers(
                3, VOCAB, int(rng.integers(7, 96))).tolist()
        reqs.append((prompt, int(rng.integers(32, 129))))
    return reqs


def slice_phase(torch):
    from paddle_tpu_torch.models.transformer_infer import (
        TransformerLMInfer, init_stream)
    from paddle_tpu_torch.ops import paged_attention as P
    from paddle_tpu_torch.serving import Engine, sequential_generate
    stream = init_stream(VOCAB, MAX_LEN, N_LAYER, N_HEAD, D_MODEL, D_INNER,
                         seed=0)
    # end_id past the vocabulary: random weights never stop early
    model = TransformerLMInfer.from_stream(
        stream, N_LAYER, N_HEAD, D_MODEL, MAX_LEN, end_id=VOCAB)
    check(model.device.type == "cuda", "model is not on the card")
    reqs = _requests(np.random.default_rng(0))
    prompts, max_new = [p for p, _ in reqs], [m for _, m in reqs]
    runs = {}
    for kernel in (True, False):
        with Engine(model, slots=32, prefill_chunk=16, block_size=16,
                    block_kernel=kernel) as eng:
            check(eng._block_kernel is kernel, "attention path mismatch")
            eng.warmup()
            P.paged_attention.launches = 0
            t0 = time.perf_counter()
            out = eng.generate_many(prompts, max_new)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = P.paged_attention.launches
            stats = dict(eng.stats)
            pool_mb = sum(t.numel() * t.element_size()
                          for n, t in eng._state.items()
                          if n.startswith("pool")) / 1e6
        runs[kernel] = (out, wall, launches, stats)
        ntok = sum(len(t) for t, _ in out)
        log("slice (%s): %d requests, %d tokens in %.3f s = %.1f tokens/s; "
            "mean decode step %.3f ms over %d steps; prefill chunks %d; "
            "prefix_hits %d; preemptions %d; pool %.1f MB; kernel "
            "launches %d", "block kernel" if kernel else "gather",
            len(out), ntok, wall, ntok / wall,
            1e3 * stats["decode_seconds"] / stats["decode_steps"],
            stats["decode_steps"], stats["prefill_chunks"],
            stats["prefix_hits"], stats["preemptions"], pool_mb, launches)
    out, _, launches, stats = runs[True]
    dispatches = stats["decode_steps"] + stats["prefill_chunks"]
    check(launches >= N_LAYER * dispatches,
          "kernel launches %d < n_layer x dispatches %d", launches,
          N_LAYER * dispatches)
    check(runs[False][2] == 0, "the gather path launched the kernel")
    for i, ((toks, score), (req_p, req_m)) in enumerate(zip(out, reqs)):
        check(len(toks) == req_m and all(0 <= t < VOCAB for t in toks)
              and np.isfinite(score), "request %d: bad output", i)
    gather = runs[False][0]
    diverged = [i for i, (a, b) in enumerate(zip(out, gather))
                if a[0] != b[0]]
    check(not diverged, "block-kernel tokens differ from the gather "
          "path's for requests %s", diverged)
    check(stats["prefix_hits"] > 0, "no prefix-cache hit")
    seq = sequential_generate(model, reqs[:4])
    for i, ((a, sa), (b, sb)) in enumerate(zip(out[:4], seq)):
        check(a == b, "request %d differs from sequential_generate", i)
        check(abs(sa - sb) <= 1e-3 * max(1.0, abs(sb)),
              "request %d score %r vs sequential %r", i, sa, sb)
    log("slice: tokens equal the gather path (64 requests) and "
        "sequential_generate (4 requests); %d launches for %d dispatches "
        "x %d layers", launches, dispatches, N_LAYER)
    profile_phase(torch, model, reqs)
    return launches


def profile_phase(torch, model, reqs):
    """A separate traced pass (the timed runs above are untraced): the
    block-kernel engine serves the first 32 requests under
    torch.profiler with device activity only; prints the device busy
    share of the wall time and the kernels that take the most of it."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving import Engine
    sub = reqs[:32]
    with Engine(model, slots=32, prefill_chunk=16, block_size=16) as eng:
        eng.warmup()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.generate_many([p for p, _ in sub], [m for _, m in sub])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        steps = eng.stats["decode_steps"] + eng.stats["prefill_chunks"]
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    busy_s = sum(r[0] for r in rows) / 1e6
    if not rows:
        log("profile: the profiler reported no device time (not measured)")
        return
    log("profile (traced, 32 requests, %d dispatches): wall %.3f s, device "
        "busy %.3f s = %.1f%% (idle %.1f%%)", steps, wall, busy_s,
        100 * busy_s / wall, 100 - 100 * busy_s / wall)
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        log("  %6.1f%% of device time  %8.3f ms  x%-6d %s",
            100 * dev_us / 1e6 / busy_s, dev_us / 1e3, count, key[:70])


def main():
    try:
        import torch
    except ImportError as e:
        print("chip_smoke: torch is not importable: %s" % e,
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print("chip_smoke: the port is not importable from %s: %s"
              % (ROOT, e), file=sys.stderr)
        return 2
    try:
        smi = device_phase(torch)
        build_phase()
        max_err = kernel_phase(torch)
        times = timing_phase(torch)
        launches = slice_phase(torch)
    except SmokeFailure as e:
        print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
        return 1
    kernel = {"name": "paged_attention", "route": "cuda",
              "source": "paddle_tpu_torch/ops/csrc/paged_attention.cu",
              "replaces": "paddle_tpu/ops/paged_attention.py:185",
              "launches": launches, "max_abs_err": max_err}
    kernel.update(times)
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
