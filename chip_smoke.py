#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``paddle_tpu_torch``) on one card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card, ``nvcc`` (``$CUDA_HOME``, ``PATH`` or
``/usr/local/cuda``) and the repository's sources; it imports neither JAX
nor ``paddle_tpu``. Phases, each fatal on failure:

  1. device — the card's name and power limit (``nvidia-smi``); TF32
     switched off for matmuls and cuDNN, so fp32 stays fp32;
  2. build  — ``ops/csrc/paged_attention.cu``,
     ``ops/csrc/flash_attention.cu`` and ``ops/csrc/matmul_stats.cu``
     compiled for sm_90a, one ``nvcc`` each, started together; ptxas
     must report no spills in any of the 24 paged instantiations (4 pool
     types x 3 widths x 2 row classes), the 18 flash ones (3 kernels x 2
     dtypes x 3 widths) or the 6 matmul_stats ones (2 dtypes x 3 tiles);
  3. kernel — the CUDA paged-attention kernel (each chain split across
     blocks, the splits merged in the same launch) held against its
     plain PyTorch version (``_attend_plain``) at rtol 1e-4 / atol 1e-5
     on live rows (``PAGED_CASES``): decode (C=1, S=32), a prefill chunk
     (C=16, S=1), a speculative width (C=5), ragged chains, layers 0 and
     3 of a 4-layer pool, nblk at NBmax and capped at half of it, f32,
     bf16, int8 and fp8-e4m3 pools, dk 64, 128 and 256, bs 16 and 32,
     chains of up to 128 blocks, and 1-byte tiles of 24 bytes (8-byte
     copies). Then timed at three shapes — (a) the serving decode shape
     (S=32, H=8, C=1, dk 64, bs 16, 256 positions, fp32, a 4-layer pool
     rotating through the L2), (b) the same pool with ragged chains of
     1..16 blocks, (c) a prefill chunk (S=1, C=16, a chain of 14 blocks)
     — each as device time alone and with the host's gaps, against the
     plain version, scaled_dot_product_attention over the gathered dense
     K/V (a boolean mask from qpos at b and c; a yardstick the port never
     calls) and the bound (the bytes of the live chains, the fp32-SIMT
     operations beside it); two launches bitwise equal at (a) and (c);
  4. slice  — the flagship ``transformer_lm`` at its own widths (vocab
     4096, max_len 256, 4 layers, 8 heads, d_model 512, d_inner 2048,
     fp32, weights from ``init_stream(seed=0)``) served by
     ``Engine(slots=32, prefill_chunk=16, block_size=16)``: 64 greedy
     requests, half sharing one 64-token prefix. The kernel's launch
     count is reset just before and read just after; tokens must equal
     the gather path's and, for 4 requests, ``sequential_generate``'s;
     16 of the requests again over an fp8-e4m3 pool
     (``kv_quant='fp8'``), the block kernel's tokens equal to the gather
     path's; then a traced pass of 32 requests (device busy share, top
     kernels, the paged kernel's share of device time);
  5. flash  — the three CUDA flash-attention kernels (forward: O and
     LSE; dQ, which also writes delta; dK/dV, with a nonzero dLSE
     cotangent) held against the plain PyTorch version (``_dense_lse``
     and its autograd) on causal and non-causal T in {128, 256, 200,
     1024}, D in {64, 128}, B*H in {1, 16}; T in {200, 256} at D 8 and
     256 (the contract's ends); and the training shape (B=32, H=8,
     T=256, D=64, causal): fp32 at rtol 1e-4 / atol 1e-5, bf16 (D up to
     256) at rtol 2^-7 / atol 1e-2 per element (bf16 keeps 8 bits:
     outputs round at 2^-9 relative in both versions, and the kernel's
     delta reads the rounded O); gradients are compared with atol scaled
     by their largest value. Two forwards (O and LSE) and two backwards
     on the same inputs must be bitwise equal; the delta the dQ kernel
     wrote must agree with ``_delta``. Then each kernel timed at the
     training shape (B=32, H=8, T=256, D=64, causal, fp32), as device
     time alone and with the host's gaps (calls enqueued one after
     another), against the plain version, scaled_dot_product_attention
     forward and backward (a yardstick the port never calls; its
     backward's kernels are named from a traced pass) and the card's
     bound: the larger of TF32 tensor-core arithmetic (3xTF32's extra
     MMAs not counted) and bytes, the fp32-SIMT figure beside it; the
     kernel route's whole backward through autograd beside the library's
     and the plain version's, as device time alone (a sleep kernel hides
     the host's enqueue) and with the host's gaps;
  6. train  — ``transformer_lm(packed=True)`` at its own widths with
     ``Adam(1e-3)``, started on the card (``Executor(CUDAPlace(0))``),
     10 steps over a fixed set of batch-32 batches
     (``make_lm_batch(RandomState(seed), 32, 256, 4096)``): finite
     losses that fall from step 1 to step 10, each flash launch count
     exactly n_layer per step (reset just before, read just after);
     tokens/s and step ms for it and the unpacked form (composed
     matmul/softmax, no kernel). From one startup scope copied twice, 3
     steps packed and 3 steps unpacked agree in losses (rtol 1e-4) and
     weights: with SGD to 2e-4 of max(1, max|w|) per tensor, with Adam
     to 5e-4 in the norm of the whole difference, a limit that the same
     run with dK zeroed must exceed (see ``parity_phase``). Then a
     traced pass of 3 steps;
  7. mm     — the CUDA matmul_stats kernel (y = x w with the shifted
     column sums s1, s2 of y - c in its epilogue) held against its plain
     version (``_dense_matmul_stats``) at the 15 distinct 1x1-conv shapes
     of the ResNet-50 training step below plus ragged M, K, N: fp32 y at
     rtol 1e-4 / atol 1e-5, bf16 y at rtol 2^-7 / atol 1e-5, s1 and s2
     at rtol 1e-4 plus 1e-5 of sum|y - c| and sum (y - c)^2 per column
     (the two versions sum up to 100,352 rows in other orders); fp32 dX
     and dW through the autograd Function (all three cotangents nonzero)
     against autograd through the plain version, atol 1e-5 of the largest
     value; two launches bitwise equal (y, s1, s2) at the largest shape
     and at M=1,568 K=2,048 N=512. Then each shape timed as device time
     alone (and, for the kernel and ``torch.matmul``, with the host's
     gaps too) against the plain version, ``torch.matmul`` of the same
     product (the product WITHOUT the statistics, a yardstick the port
     never calls), the composed route (cuDNN 1x1 conv + the BN
     statistics pass) and the bound (the larger of TF32 tensor-core
     arithmetic and bytes, the fp32-SIMT figure beside it), per shape and
     summed over the 36 launches of one step; each shape's tile must put
     a block on every SM or be bound by bytes;
  8. resnet — ``models.resnet.build_train_net`` (ResNet-50, ImageNet
     224x224x3, batch 32, 1000 classes, fp32, ``Momentum(0.01, 0.9)``)
     started on the card, with ``fuse_conv_bn`` on: 10 steps over two
     fixed numpy batches, finite losses that fall, matmul_stats launches
     exactly 36 per step (reset just before, read just after); images/s
     and step ms for it and for the same net with the flag off (cuDNN
     conv + BN statistics, no kernel). From one startup scope copied
     twice, 3 steps fused and 3 flag-off agree in the step-1 loss (rtol
     1e-4), and in the weights and BN running statistics within a limit
     that controls place (see ``resnet_parity_phase``). Then traced
     passes of 3 fused and 3 flag-off steps;
  9. megastep — K steps as one CUDA graph, captured once and replayed,
     against the eager steps (``core/graphs.py``): the packed LM with
     Adam and ResNet-50 with ``fuse_conv_bn`` on and off, each 10
     ``run()`` steps against 2 ``run_steps(K=5)`` dispatches over the
     same 10 batches from one startup scope copied twice (the graph
     captured before, by a warm call on a third copy): losses and every
     state tensor bitwise equal, or the first differing op named and the
     weights held to the limit the earlier controls place (ResNet's
     eager steps are compared twice first; where cuDNN's default
     algorithms part run to run, the comparison runs under
     ``cudnn.deterministic``); flash launches exactly n_layer and
     matmul_stats exactly 36 per logical step, counted through replays.
     Then ``Engine(slots=32, prefill_chunk=16, block_size=16)`` at
     megastep 1 and 8 on the 64-request mixed set and a decode-heavy set
     (32 requests, prompts of 8-32 tokens, 192 new tokens each): tokens
     equal between K=1 and K=8 and, for 4 requests,
     ``sequential_generate``'s; paged launches exactly n_layer x (decode
     steps the device ran + prefill chunks); captures, replays and
     megastep dispatches printed. Each path is timed eager against graph
     in A/B/A/B order (3 pairs: the host varies from run to run), with
     the medians, and traced once each way for the device busy share;
     every timing line carries the ``nvidia-smi`` line;
 10. spec    — speculative and sampled serving. Kernel #1 at the scoring
     shape (S=32, H=8, C=gamma+1=5, dk 64, ragged per-row qpos = pos +
     j, fp32 and fp8 pools) against its plain version at phase 3's
     tolerances, then timed at (d) (every slot scoring positions
     251..255 of 256) as device time alone and with the host's gaps
     against the plain version, scaled_dot_product_attention with the
     per-row causal mask and the bound. Then the flagship served by
     ``Engine(slots=32, prefill_chunk=16, block_size=16)`` with
     ``speculative=True``, gamma 4, drafter ``ngram`` and ``truncated``
     (2 layers), on both request sets: tokens equal to the plain
     engine's at megastep 1 and, for 4 requests, to
     ``sequential_generate``'s (phase 9's); drafted scoring dispatches
     required; paged launches exactly n_layer x (scoring dispatches +
     plain steps run + prefill chunks) + spec_layers x draft steps;
     accepted tokens per scoring dispatch printed. The scoring dispatch
     computes a position at M = S x C GEMM rows and the kernel's C = 5
     layout, the plain step at M = S and C = 1, so the two round
     differently: where a speculative run's tokens part from the plain
     run's, the first differing token is diagnosed (``_divergence``). A
     near-tie within the row's fp32 rounding (the most the plain and
     the dense fp32 dispatches of that row disagree on a logit) is
     logged with its figures and counted: the scoring dispatch's logits
     within twice that rounding of the plain step's, and the two
     tokens' logits under the plain step no further apart than it
     (sampled: the uniform no further from a CDF step than the two
     dispatches' CDFs disagree); anything else fails. Sampled: 16
     requests (temperature 0.8, top_k 50, top_p 0.95, seeds 100-115)
     among 4 greedy ones, 64 new tokens each, through the plain engine,
     the megastep-8 engine (its sampled CUDA graph, replays required)
     and the ngram speculative engine: identical tokens, a second pass
     identical, the greedy requests equal to their all-greedy tokens;
     the counter RNG's bits (Philox words and uniforms) equal on the
     CPU and the card for 1,000 (seed, counter) pairs. Last, the
     decode-heavy set timed over plain K=1, plain K=8, spec-ngram and
     spec-truncated in A/B/A/B order (3 rounds, medians: ms per decode
     dispatch, tokens/s) and traced once each for the device busy
     share.

The last three lines of standard output are the kernels' JSON line, the
``nvidia-smi`` name/power-limit line, and ``{"ok": true, "device": ...}``.
In the kernels' line ``launches`` sums the eager main path's run, the
megastep graph's (counted through replays) and phase 10's speculative
and plain runs; ``graph_launches`` gives the graph's alone and
``spec_launches`` phase 10's. Paged attention's entry carries
``scoring_shape``: its times and bound at (d), and its launches at the
scoring shape among phase 10's: counted inside each scoring dispatch
(the kernel's counter read before and after it, n_layer required) and
each launch's query rows (C = 5 required). Every entry's ``ms`` and ``library_ms`` are device
time alone, and each adds both read with the host's gaps
(``ms_with_host_gaps``, ``library_ms_with_host_gaps``); paged
attention's are at shape (a), and its ``launches`` count one per call.
matmul_stats's times and bound are sums over the 36 launches of one
ResNet-50 step, and its max_abs_err covers y, s1 and s2 (the sums'
absolute errors dominate: they are sums of up to 100,352 rows).
Without a CUDA card, or outside the repository, it exits non-zero and
prints no result.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS = 67e12                 # H100 SXM fp32, outside tensor cores
TF32_FLOPS = 495e12                # H100 SXM TF32 tensor cores, dense
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
def _kernel_name(line):
    """``kernel<args>`` from a ptxas line's mangled template name (the
    bare name for a kernel that is no template)."""
    m = re.search(r"([a-z_]+_kernel)I(\w*?)EE", line)
    if not m:
        m = re.search(r"([a-z_]+_kernel)E", line)
        return m.group(1) if m else line.strip()
    args = m.group(2)
    for mangled, plain in (("13__nv_bfloat16", "bf16"),
                           ("13__nv_fp8_e4m3", "fp8"), ("ELi", ", "),
                           ("Li", ", "),
                           ("Lb0", ", false"), ("Lb1", ", true")):
        args = args.replace(mangled, plain)
    head = {"f": "float", "a": "int8"}.get(args[:1])
    if head and not args.startswith("fp8"):
        args = head + args[1:]
    return "%s<%s>" % (m.group(1), args)


def _ptxas_report(text):
    """{kernel<args>: (registers, spill store bytes, spill load bytes)}
    from nvcc's -Xptxas -v output."""
    out, cur = {}, None
    for line in text.splitlines():
        if "Compiling entry" in line:
            cur = _kernel_name(line)
            out[cur] = [0, 0, 0]
        elif cur is None:
            continue
        elif "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out[cur][1:] = [int(m.group(1)), int(m.group(2))]
        elif "Used" in line and "registers" in line:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[cur][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def build_phase():
    from paddle_tpu_torch.ops import _build
    names = ("paged_attention", "flash_attention", "matmul_stats")
    t0 = time.perf_counter()
    _build.load_all(names)
    log("build: %s in %.2f s (one nvcc each, in parallel)",
        ", ".join(n + ".cu" for n in names), time.perf_counter() - t0)
    held = {}
    for name in names:
        report = _ptxas_report(_build.build_log.get(name, ""))
        for kernel, (regs, st, ld) in sorted(report.items()):
            log("  ptxas %s: %-36s %3d registers, spill stores %d bytes, "
                "spill loads %d bytes", name, kernel, regs, st, ld)
            if kernel.startswith(("flash_", "matmul_stats_kernel",
                                  "paged_")):
                held[kernel] = st, ld
    counts = {p: sum(k.startswith(p) for k in held)
              for p in ("flash_", "matmul_stats_kernel", "paged_")}
    for prefix, want, what in (
            ("flash_", 18, "3 kernels x 2 dtypes x 3 widths"),
            ("matmul_stats_kernel", 6, "2 dtypes x 3 tiles"),
            ("paged_", 24, "4 pool types x 3 widths x 2 row classes")):
        check(counts[prefix] == want, "ptxas reported %d %s kernels, "
              "expected %d (%s)", counts[prefix], prefix, want, what)
    spilled = [k for k, (st, ld) in held.items() if st or ld]
    check(not spilled, "ptxas spills in the paged, flash or matmul_stats "
          "kernels: %s", spilled)


# -- phase 3 -------------------------------------------------------------
QUANTS = {"fp32": None, "bf16": None, "int8": "int8", "fp8": "fp8"}


def _pool_case(torch, rng, s, c, chains, quant, layers=4, h=8, bs=16,
               dk=64, nbmax=16, nb=None):
    """A random pool problem: K/V drawn on the card from a seed taken
    from ``rng``; slot i's chain of ``chains[i]`` blocks, its last query
    at the chain's last block."""
    from paddle_tpu_torch.ops import paged_attention as P
    dev = torch.device("cuda")
    nb = nb or s * nbmax + 4
    shape = (nb, layers, h, bs, dk)
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    pk = torch.randn(shape, generator=g, device=dev)
    pv = torch.randn(shape, generator=g, device=dev)
    btab = rng.permutation(nb)[:s * nbmax].reshape(s, nbmax)
    qpos = np.stack([rng.integers(0, ch * bs, size=c) for ch in chains])
    qpos[:, -1] = (np.asarray(chains) - 1) * bs + rng.integers(0, bs, s)
    q = rng.normal(size=(s, h, c, dk)).astype(np.float32) * dk ** -0.5
    case = {"q": torch.from_numpy(q).to(dev),
            "btab": torch.from_numpy(btab.astype(np.int32)).to(dev),
            "qpos": torch.from_numpy(qpos.astype(np.int32)).to(dev),
            "k_scale": None, "v_scale": None}
    spec = P.kv_quant_spec(QUANTS[quant])
    if spec is not None:
        pk, case["k_scale"] = P.quantize_kv(pk, spec[0])
        pv, case["v_scale"] = P.quantize_kv(pv, spec[0])
    elif quant == "bf16":
        pk, pv = pk.to(torch.bfloat16), pv.to(torch.bfloat16)
    case["pool_k"], case["pool_v"] = pk.contiguous(), pv.contiguous()
    return case


# (S, C, dk, bs, NBmax, pool types): the serving shapes (decode S=32,
# a prefill chunk C=16, a speculative width C=5) at dk 64 and bs 16 in
# all four pool types; dk 128 and 256; bs 32; chains up to 128 blocks
# (many splits, many of them past a short chain); 1-byte codes whose
# K/V tiles are not a multiple of 16 bytes (bs 3, dk 8: 8-byte copies)
PAGED_CASES = [(s, c, 64, 16, 16, tuple(QUANTS))
               for s, c in ((32, 1), (1, 16), (8, 5))] + \
    [(s, c, dk, 16, 16, tuple(QUANTS)) for dk in (128, 256)
     for s, c in ((8, 1), (1, 16), (4, 5))] + \
    [(s, c, 64, 32, 8, tuple(QUANTS)) for s, c in ((8, 1), (1, 16))] + \
    [(s, c, 64, 16, 128, ("fp32", "fp8")) for s, c in ((4, 1), (2, 16))] + \
    [(s, c, 8, 3, 6, ("int8", "fp8")) for s, c in ((4, 1), (3, 5))]


def kernel_phase(torch):
    """Every listed case against the plain version, at layers 0 and 3,
    with nblk at NBmax and at half of it (which caps the walk below the
    longest chain: only slots whose own chain fits are live rows);
    returns the largest absolute error seen."""
    from paddle_tpu_torch.ops import paged_attention as P
    rng = np.random.default_rng(0)
    worst, n = 0.0, 0
    for s, c, dk, bs, nbmax, quants in PAGED_CASES:
        for quant in quants:
            chains = rng.integers(1, nbmax + 1, size=s)
            chains[0] = nbmax
            case = _pool_case(torch, rng, s, c, chains, quant, bs=bs, dk=dk,
                              nbmax=nbmax)
            args = tuple(case[k] for k in ("q", "pool_k", "pool_v", "btab",
                                           "qpos"))
            splits = P._splits(s, args[0].shape[1], c, nbmax, bs)
            for layer in (0, 3):
                for nblk in [v for v in (nbmax, nbmax // 2)
                             if v and (chains <= v).any()]:
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
                    n += 1
                    check(bool(torch.isfinite(got[live]).all())
                          and not bool(bad.any()),
                          "kernel disagrees with _attend_plain: S=%d C=%d "
                          "dk=%d bs=%d NBmax=%d %s layer=%d nblk=%d "
                          "max_abs_err=%g", s, c, dk, bs, nbmax, quant,
                          layer, nblk, float(err.max()))
                    log("kernel: S=%-2d C=%-2d dk=%-3d bs=%-2d NBmax=%-3d "
                        "%-4s splits=%-3d layer=%d nblk=%-3d "
                        "max_abs_err=%.3g  ok", s, c, dk, bs, nbmax, quant,
                        splits, layer, nblk, float(err.max()))
    log("kernel: %d comparisons ok; largest abs error %.3g", n, worst)
    return worst


def _paged_shapes(torch):
    """The three timed shapes on one 4-layer pool of 512 blocks (S=32,
    H=8, bs 16, dk 64, fp32; 33.5 MB a layer, 134 MB rotating through
    the 50 MB L2 as the decode loop meets them): (a) decode, every slot
    at 256 positions; (b) decode with ragged chains of 1..16 blocks;
    (c) a prefill chunk, S=1, C=16, a chain of 14 blocks."""
    rng = np.random.default_rng(1)
    s, bs, nbmax = 32, 16, 16
    case = _pool_case(torch, rng, s, 1, [nbmax] * s, "fp32", nb=s * nbmax)
    case["qpos"].fill_(nbmax * bs - 1)
    ragged = rng.integers(1, nbmax + 1, size=s)
    qpos_b = (ragged - 1) * bs + rng.integers(0, bs, size=s)
    q16 = rng.normal(size=(1, 8, 16, 64)).astype(np.float32) * 0.125
    shapes = {
        "a": (case["q"], case["btab"], case["qpos"], nbmax),
        "b": (case["q"], case["btab"], torch.from_numpy(
            qpos_b[:, None].astype(np.int32)).cuda(), int(ragged.max())),
        "c": (torch.from_numpy(q16).cuda(), case["btab"][:1],
              torch.arange(13 * bs, 14 * bs, dtype=torch.int32,
                           device="cuda")[None], 14),
    }
    return case["pool_k"], case["pool_v"], shapes


def _paged_work(q, qpos, h, dk, bs, itemsize=4):
    """(bytes, flops) one call needs: each live K/V element read once
    (the blocks up to each slot's last query), q read and out written
    once, the tables read; 4 flops per (query, key, dk) pair that
    attends (2 for QK^T, 2 for PV)."""
    s, c = qpos.shape
    qp = qpos.long().cpu()
    blocks = int((qp.max(dim=1).values // bs + 1).sum())
    pairs = int((qp + 1).sum())
    nbytes = (2 * blocks * h * bs * dk * itemsize + 2 * q.numel() * 4
              + 4 * (qpos.numel() + blocks))
    return nbytes, 4 * pairs * h * dk


def timing_phase(torch):
    """Kernel, plain version and library call at the three shapes, each
    as device time alone (a sleep kernel hides the host's enqueue) and
    with the host's gaps (calls back to back, each between its own
    events); the library call is scaled_dot_product_attention over the
    gathered dense K/V (a yardstick the port never calls), with a
    boolean mask from qpos where the chains are ragged or C > 1. Then
    two launches on the same inputs must be bitwise equal at (a) and
    (c). Returns the kernels-line entry (shape a)."""
    from paddle_tpu_torch.ops import paged_attention as P
    pk, pv, shapes = _paged_shapes(torch)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    h, bs, dk = pk.shape[2], pk.shape[3], pk.shape[4]
    out = {}
    for name, (q, bt, qp, nblk) in shapes.items():
        nb_t = torch.tensor([nblk], dtype=torch.int32, device="cuda")
        c = qp.shape[1]
        npos = nblk * bs
        dense, mask = [], None
        if name != "a":
            kpos = torch.arange(npos, device="cuda")
            mask = (kpos[None, None, None, :] <= qp[:, None, :, None])
        for layer in range(4):
            kv = []
            for pool in (pk, pv):
                g = pool[:, layer][bt[:, :nblk].long()]
                kv.append(g.permute(0, 2, 1, 3, 4).reshape(
                    bt.shape[0], h, npos, dk).contiguous())
            dense.append(kv)

        def kernel(i):
            P.paged_attention(q, pk, pv, bt, qp, nblk=nb_t, layer=i % 4)

        def library(i):
            k, v = dense[i % 4]
            sdpa(q, k, v, attn_mask=mask, scale=1.0)

        def plain(i):
            P._attend_plain(q, pk, pv, bt, qp, nblk, None, None,
                            layer=i % 4)
        r = {"ms": _events_ms(torch, kernel, 100, hide_host=True),
             "ms_with_host_gaps": _events_ms(torch, kernel, 100),
             "library_ms": _events_ms(torch, library, 100,
                                      hide_host=True),
             "library_ms_with_host_gaps": _events_ms(torch, library, 100),
             "plain_ms": _events_ms(torch, plain, 5)}
        got = P.paged_attention(q, pk, pv, bt, qp, nblk=nb_t, layer=0)
        lib = sdpa(q, dense[0][0], dense[0][1], attn_mask=mask, scale=1.0)
        check(torch.allclose(got, lib, rtol=RTOL, atol=ATOL),
              "kernel disagrees with scaled_dot_product_attention at (%s)",
              name)
        if name in ("a", "c"):
            again = P.paged_attention(q, pk, pv, bt, qp, nblk=nb_t,
                                      layer=0)
            torch.cuda.synchronize()
            check(torch.equal(got, again), "two launches at (%s) are not "
                  "bitwise equal", name)
        nbytes, flops = _paged_work(q, qp, h, dk, bs)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / FP32_FLOPS * 1e3
        r.update(bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        splits = P._splits(q.shape[0], h, c, bt.shape[1], bs)
        log("timing (%s) S=%d H=%d C=%d dk=%d bs=%d, %s fp32, splits %d: "
            "device time alone kernel_ms=%.5f library_ms=%.5f (kernel / "
            "library %.3f); with the host's gaps kernel_ms=%.5f "
            "library_ms=%.5f; plain_ms=%.5f (with gaps); bound_ms=%.5f "
            "(%s: %d bytes %.5f ms, %d flops at fp32 SIMT %.5f ms)%s",
            name, q.shape[0], h, c, dk, bs,
            {"a": "256 positions per slot",
             "b": "ragged chains of 1..16 blocks",
             "c": "a chain of 14 blocks"}[name], splits, r["ms"],
            r["library_ms"], r["ms"] / r["library_ms"],
            r["ms_with_host_gaps"], r["library_ms_with_host_gaps"],
            r["plain_ms"], r["bound_ms"], r["bound_by"], nbytes, bytes_ms,
            flops, ops_ms, "; two launches bitwise equal"
            if name in ("a", "c") else "")
        out[name] = r
    return out["a"]


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
    fp8_slice_phase(torch, model, reqs[:16])
    profile_phase(torch, model, reqs)
    return launches


def fp8_slice_phase(torch, model, reqs):
    """The same engine over an fp8-e4m3 pool (``kv_quant='fp8'``): codes
    and per-vector scales written on the card, read by the kernel and,
    on the gather path, by the dense gather; both paths must give the
    same tokens."""
    from paddle_tpu_torch.ops import paged_attention as P
    from paddle_tpu_torch.serving import Engine
    prompts, max_new = [p for p, _ in reqs], [m for _, m in reqs]
    outs = {}
    for kernel in (True, False):
        with Engine(model, slots=32, prefill_chunk=16, block_size=16,
                    block_kernel=kernel, kv_quant="fp8") as eng:
            check(eng._state["pool_k"].dtype == torch.float8_e4m3fn,
                  "the fp8 engine's pool is %s", eng._state["pool_k"].dtype)
            eng.warmup()
            P.paged_attention.launches = 0
            outs[kernel] = eng.generate_many(prompts, max_new)
            torch.cuda.synchronize()
            launches = P.paged_attention.launches
            dispatches = (eng.stats["decode_steps"]
                          + eng.stats["prefill_chunks"])
        if kernel:
            check(launches >= N_LAYER * dispatches, "fp8: kernel launches "
                  "%d < n_layer x dispatches %d", launches,
                  N_LAYER * dispatches)
            kernel_launches = launches
    for i, ((toks, score), req_m) in enumerate(zip(outs[True], max_new)):
        check(len(toks) == req_m and all(0 <= t < VOCAB for t in toks)
              and np.isfinite(score), "fp8 request %d: bad output", i)
    diverged = [i for i, (a, b) in enumerate(zip(outs[True], outs[False]))
                if a[0] != b[0]]
    check(not diverged, "fp8 pool: block-kernel tokens differ from the "
          "gather path's for requests %s", diverged)
    log("slice (fp8 pool): %d requests, tokens equal on the block kernel "
        "and the gather path; %d launches", len(reqs), kernel_launches)


def profile_phase(torch, model, reqs):
    """A separate traced pass (the timed runs above are untraced): the
    block-kernel engine serves the first 32 requests under
    torch.profiler with device activity only; prints the device busy
    share of the wall time, the kernels that take the most of it, and
    the paged kernel's share."""
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
    _report_profile(prof, wall, "profile (traced, 32 requests, %d "
                    "dispatches)" % steps, focus="paged_attention_kernel")


# -- phase 5 -------------------------------------------------------------
BF16_ATOL, BF16_RTOL = 1e-2, 2.0 ** -7
# (causal, T, D, B, H); then the contract's narrowest and widest D; the
# last is the training path's own shape
FLASH_CASES = [(causal, t, d, 1, h) for causal in (False, True)
               for t in (128, 256, 200, 1024) for d in (64, 128)
               for h in (1, 16)] + \
    [(causal, t, d, 1, 16) for causal in (False, True) for t in (200, 256)
     for d in (8, 256)] + [(True, MAX_LEN, D_MODEL // N_HEAD, 32, N_HEAD)]
FLASH_BF16_CASES = [(causal, t, d, 1, 16) for causal in (False, True)
                    for t in (128, 200) for d in (64, 128)] + \
    [(True, 200, 256, 1, 16)]


def _flash_case(torch, F, causal, t, d, b, h, dtype, seed):
    """One forward + backward through the kernels and through the plain
    version on the same inputs; returns the error of each output."""
    g = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return torch.randn(*shape, generator=g).to("cuda")
    q, k, v = [draw(b, h, t, d).to(dtype).requires_grad_(True)
               for _ in range(3)]
    dout, dlse = draw(b, h, t, d), draw(b, h, t)
    errs = {}
    results = []
    for fn in (F.flash_attention_lse, F._dense_lse):
        out, lse = fn(q, k, v, causal=causal, scale=d ** -0.5)
        loss = (out.float() * dout).sum() + (lse * dlse).sum()
        grads = torch.autograd.grad(loss, [q, k, v])
        results.append([x.detach().float() for x in (out, lse) + grads])
    torch.cuda.synchronize()
    atol, rtol = (ATOL, RTOL) if dtype == torch.float32 else (BF16_ATOL,
                                                             BF16_RTOL)
    for name, got, ref in zip(("o", "lse", "dq", "dk", "dv"), *results):
        scale = 1.0
        if name not in ("o", "lse"):
            scale = float(ref.abs().max().clamp_min(1e-30))
        err = (got - ref).abs()
        bad = err > atol * scale + rtol * ref.abs()
        check(bool(torch.isfinite(got).all()) and not bool(bad.any()),
              "flash %s disagrees with the plain version: %s causal=%s "
              "T=%d D=%d B=%d H=%d max_abs_err=%g", name, dtype, causal, t,
              d, b, h, float(err.max()))
        errs[name] = (float(err.max()), float(err.max()) / scale)
    return errs


def flash_kernel_phase(torch):
    """Every case against the plain version; returns the largest fp32
    absolute error per kernel."""
    from paddle_tpu_torch.ops import flash_attention as F
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    cases = [(c, torch.float32) for c in FLASH_CASES] + \
        [(c, torch.bfloat16) for c in FLASH_BF16_CASES]
    for i, ((causal, t, d, b, h), dtype) in enumerate(cases):
        e = _flash_case(torch, F, causal, t, d, b, h, dtype, seed=i)
        log("flash: %-8s causal=%-5s T=%-4d D=%-3d B=%-2d H=%-2d "
            "max_abs_err o %.2e lse %.2e | scaled dq %.2e dk %.2e dv %.2e  "
            "ok", str(dtype).replace("torch.", ""), causal, t, d, b, h,
            e["o"][0], e["lse"][0], e["dq"][1], e["dk"][1], e["dv"][1])
        if dtype == torch.float32:
            worst["flash_fwd"] = max(worst["flash_fwd"], e["o"][0],
                                     e["lse"][0])
            worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], e["dq"][0])
            worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"],
                                         e["dk"][0], e["dv"][0])
    log("flash: %d cases ok (%d fp32, %d bf16); largest fp32 abs errors %s",
        len(cases), len(FLASH_CASES), len(cases) - len(FLASH_CASES),
        ", ".join("%s %.3g" % kv for kv in worst.items()))
    flash_backward_checks(torch, F)
    return worst


def flash_backward_checks(torch, F):
    """At the training shape (fp32) and the widest bf16 case, with a
    nonzero dLSE: two forwards on the same inputs give bitwise-equal O and
    LSE, two backwards bitwise-equal dQ, dK, dV and delta (no atomics),
    and the delta the dQ kernel wrote
    agrees with its plain version ``_delta`` (atol 1e-5 of max|delta|,
    rtol 1e-4: the two sum the D products in other orders)."""
    for (causal, t, d, b, h), dtype in (
            ((True, MAX_LEN, D_MODEL // N_HEAD, 32, N_HEAD), torch.float32),
            ((True, 200, 256, 1, 16), torch.bfloat16)):
        g = torch.Generator().manual_seed(7)
        q, k, v, dout = [torch.randn(b, h, t, d, generator=g).to(
            "cuda", dtype) for _ in range(4)]
        dlse = torch.randn(b, h, t, generator=g).to("cuda")
        scale = d ** -0.5
        out, lse = F._fwd_cuda(q, k, v, causal, scale)
        out2, lse2 = F._fwd_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        check(torch.equal(out, out2) and torch.equal(lse, lse2),
              "flash forward not bitwise repeatable (%s T=%d D=%d): o, lse "
              "equal %s", dtype, t, d,
              [torch.equal(out, out2), torch.equal(lse, lse2)])
        runs = []
        for _ in range(2):
            dq, delta = F._bwd_dq_cuda(q, k, v, out, dout, lse, dlse,
                                        causal, scale)
            dk, dv = F._bwd_dkv_cuda(q, k, v, dout, lse, delta, causal,
                                     scale)
            runs.append((dq, dk, dv, delta))
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(*runs)]
        check(all(same), "flash backward not bitwise repeatable (%s T=%d "
              "D=%d): dq, dk, dv, delta equal %s", dtype, t, d, same)
        ref = F._delta(out, dout, dlse)
        err = (runs[0][3] - ref).abs()
        top = float(ref.abs().max())
        check(not bool((err > ATOL * top + RTOL * ref.abs()).any()),
              "kernel-written delta disagrees with _delta (%s T=%d D=%d): "
              "max_abs_err %g of max|delta| %g", dtype, t, d,
              float(err.max()), top)
        log("flash backward: %s causal=%s T=%d D=%d B=%d H=%d: two "
            "forwards bitwise equal (o, lse), two backwards bitwise equal "
            "(dq, dk, dv, delta); kernel delta vs "
            "_delta max_abs_err %.3g (max|delta| %.3g)  ok",
            str(dtype).replace("torch.", ""), causal, t, d, b, h,
            float(err.max()), top)


HIDE_HOST_CYCLES = 4_000_000       # ~2 ms of the card's clock


def _events_ms(torch, fn, reps, prep=None, hide_host=False):
    """Mean device ms of ``fn(i)`` over ``reps`` calls, CUDA-event timed
    around each call; ``prep(i)``, when given, runs before each call
    outside the timed span (to build an autograd graph). With
    ``hide_host``, a sleep kernel queued before the start event keeps the
    card busy while the host enqueues the call, so the span is device
    time alone, without the host's gaps between the call's launches."""
    for i in range(3):
        if prep:
            prep(i)
        fn(i)
    torch.cuda.synchronize()
    pairs = []
    for i in range(reps):
        if prep:
            prep(i)
        if hide_host:
            torch.cuda._sleep(HIDE_HOST_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(i)
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def flash_timing_phase(torch):
    """The training shape: B=32, H=8, T=256, D=64, causal, fp32. Four
    input sets (4 x 67 MB) rotate through the 50 MB L2, as the layers of
    a training step meet them."""
    from paddle_tpu_torch.ops import flash_attention as F
    b, h, t, d = 32, 8, 256, 64
    scale = d ** -0.5
    sets = []
    for i in range(4):
        g = torch.Generator().manual_seed(100 + i)
        q, k, v, dout = [torch.randn(b, h, t, d, generator=g).to("cuda")
                         for _ in range(4)]
        out, lse = F._fwd_cuda(q, k, v, True, scale)
        _, delta = F._bwd_dq_cuda(q, k, v, out, dout, lse, None, True,
                                  scale)
        sets.append((q, k, v, dout, out, lse, delta))
    cur = {}

    def fwd(i):
        q, k, v = sets[i % 4][:3]
        F._fwd_cuda(q, k, v, True, scale)

    def dq(i):
        q, k, v, dout, out, lse, _ = sets[i % 4]
        F._bwd_dq_cuda(q, k, v, out, dout, lse, None, True, scale)

    def dkv(i):
        q, k, v, dout, _, lse, delta = sets[i % 4]
        F._bwd_dkv_cuda(q, k, v, dout, lse, delta, True, scale)

    def graph(fn):
        def prep(i):
            q, k, v, dout = [x.detach().requires_grad_(True)
                             for x in sets[i % 4][:4]]
            cur["out"] = fn(q, k, v)
            cur["in"], cur["dout"] = (q, k, v), dout
        return prep

    def backward(i):
        torch.autograd.grad(cur["out"], cur["in"], cur["dout"])

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def plain(q, k, v):
        return F._dense_lse(q, k, v, True, scale)[0]

    def lib(q, k, v):
        return sdpa(q, k, v, is_causal=True, scale=scale)

    def kernels(q, k, v):
        return F.flash_attention(q, k, v, causal=True, scale=scale)

    # each launch read two ways: as device time alone (a sleep kernel
    # hides the host's enqueue, which can outlast a 0.1 ms kernel) and
    # with the host's gaps (calls enqueued one after another, as a step
    # enqueues them: a host slower than the card shows as idle card)
    times, gaps = {}, {}
    for name, fn in (("flash_fwd", fwd), ("flash_bwd_dq", dq),
                     ("flash_bwd_dkv", dkv)):
        times[name] = _events_ms(torch, fn, 50, hide_host=True)
        gaps[name] = _events_ms(torch, fn, 50)
    with torch.no_grad():
        plain_fwd = _events_ms(torch, lambda i: plain(*sets[i % 4][:3]), 10,
                               hide_host=True)
        lib_fwd = _events_ms(torch, lambda i: lib(*sets[i % 4][:3]), 50,
                             hide_host=True)
        lib_fwd_gaps = _events_ms(torch, lambda i: lib(*sets[i % 4][:3]), 50)
    # the whole backward through autograd, each route timed the same way:
    # with the host's gaps (as enqueued) and as device time alone; the
    # library twice, before and after the kernel route
    whole = {}
    for hide in (False, True):
        for route, fn, reps in (("plain", plain, 10), ("library", lib, 50),
                                ("kernels", kernels, 50),
                                ("library again", lib, 50)):
            whole[route, hide] = _events_ms(torch, backward, reps,
                                            prep=graph(fn), hide_host=hide)
    plain_bwd, lib_bwd = whole["plain", True], whole["library", True]
    q, k, v, _, out = sets[0][:5]
    check(torch.allclose(out, lib(q, k, v), rtol=RTOL, atol=ATOL),
          "flash forward disagrees with scaled_dot_product_attention")
    # the work this run's data needs: causal keeps T(T+1)/2 of the T^2
    # (query, key) pairs; each product is 2 flops per pair and head dim
    pairs = b * h * t * (t + 1) // 2
    elem = b * h * t * d * 4                # one [B, H, T, D] f32 tensor
    row = b * h * t * 4                     # one [B, H, T] f32 tensor
    # (flops, bytes: inputs read once, outputs written once, peak). Every
    # kernel's products run on the TF32 tensor cores (3xTF32: the
    # emulation's 3 MMAs are not counted as work). fwd reads q, k, v and
    # writes o and lse; dq reads q, k, v, o, do and lse and writes dq and
    # delta; dkv reads q, k, v, do, lse and delta and writes dk and dv.
    work = {
        "flash_fwd": (2 * 2 * pairs * d, 4 * elem + row, TF32_FLOPS),
        "flash_bwd_dq": (3 * 2 * pairs * d, 6 * elem + 2 * row, TF32_FLOPS),
        "flash_bwd_dkv": (4 * 2 * pairs * d, 6 * elem + 2 * row,
                          TF32_FLOPS),
    }
    out = {}
    for name, (flops, nbytes, peak) in work.items():
        ops_ms = flops / peak * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        fwd_side = name == "flash_fwd"
        out[name] = {
            "ms": times[name],
            "plain_ms": plain_fwd if fwd_side else plain_bwd,
            "library_ms": lib_fwd if fwd_side else lib_bwd,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ms_with_host_gaps": gaps[name],
            "library_ms_with_host_gaps": (lib_fwd_gaps if fwd_side else
                                          whole["library", False])}
        log("timing %s (B=32 H=8 T=256 D=64 causal fp32), device time "
            "alone: kernel_ms=%.5f bound_ms=%.5f (%s; operations %.5f ms "
            "at %g TFLOP/s, bytes %.5f ms: %d flops, %d bytes; fp32-SIMT "
            "operations bound %.5f ms) plain_ms=%.5f library_ms=%.5f; with "
            "the host's gaps: kernel_ms=%.5f library_ms=%.5f%s", name,
            times[name], out[name]["bound_ms"], out[name]["bound_by"],
            ops_ms, peak / 1e12, bytes_ms, flops, nbytes,
            flops / FP32_FLOPS * 1e3, out[name]["plain_ms"],
            out[name]["library_ms"], gaps[name],
            out[name]["library_ms_with_host_gaps"], "" if fwd_side else
            " (plain and library: one backward computing dq, dk, dv)")
    for hide, how in ((True, "device time alone"),
                      (False, "with the host's gaps")):
        kern = whole["kernels", hide]
        libs = whole["library", hide], whole["library again", hide]
        log("timing: whole backward through autograd (B=32 H=8 T=256 D=64 "
            "causal fp32), %s: kernel route %.5f ms (dq %.5f + dkv %.5f "
            "timed alone), library (scaled_dot_product_attention) %.5f / "
            "%.5f ms (before and after), plain %.5f ms; kernel route / "
            "library %.3f", how, kern, times["flash_bwd_dq"],
            times["flash_bwd_dkv"], libs[0], libs[1], whole["plain", hide],
            kern / min(libs))
    _library_backward_kernels(torch, backward, graph(lib))
    return out


def _library_backward_kernels(torch, backward, prep):
    """Name the kernels of scaled_dot_product_attention's backward (which
    backend the library yardstick is) from a short traced pass."""
    from torch.profiler import ProfilerActivity, profile
    prep(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        backward(0)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    if not rows:
        log("library backward kernels: the profiler reported no device "
            "time (not measured)")
        return
    for dev_us, count, key in sorted(rows, reverse=True)[:6]:
        log("library backward kernel: %8.4f ms x%d  %s", dev_us / 1e3,
            count, key[:110])


# -- phase 6 -------------------------------------------------------------
TRAIN_BATCH, TRAIN_STEPS, PARITY_STEPS = 32, 10, 3


def _lm_program(fluid, T, packed, optimizer="adam"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        # the constants are transformer_lm's own defaults
        avg_cost, _ = T.transformer_lm(
            vocab_size=VOCAB, max_len=MAX_LEN, n_layer=N_LAYER,
            n_head=N_HEAD, d_model=D_MODEL, d_inner=D_INNER, packed=packed)
        if optimizer == "adam":
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
        else:
            fluid.optimizer.SGD(learning_rate=0.1).minimize(avg_cost)
    return main, startup, avg_cost


def _train(torch, fluid, exe, prog, init, batches, steps):
    """``steps`` steps from a fresh copy of ``init``: (losses, wall
    seconds of steps 2..n, scope)."""
    main, _, avg_cost = prog
    scope = fluid.Scope()
    fluid.load_numpy_state(scope, init, exe.device)
    losses = []
    t0 = None
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        loss, = exe.run(main, feed=batches[i % len(batches)],
                        fetch_list=[avg_cost], scope=scope)
        losses.append(float(loss))
    torch.cuda.synchronize()
    return losses, time.perf_counter() - t0, scope


def train_phase(torch):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops import flash_attention as F
    exe = fluid.Executor(fluid.CUDAPlace(0))
    check(exe.device.type == "cuda", "the executor is not on the card")
    check(fluid.Executor().device.type == "cuda",
          "Executor() does not default to the card")
    packed = _lm_program(fluid, T, True)
    unpacked = _lm_program(fluid, T, False)
    ops = [op.type for op in packed[0].global_block().ops]
    check(ops.count("sp_attention") == N_LAYER and "softmax" not in ops,
          "the packed program does not route attention to sp_attention")
    scope0 = fluid.Scope()
    exe.run(packed[1], scope=scope0)
    init = {n: scope0.get_numpy(n) for n in scope0.local_var_names()
            if scope0.find_var(n) is not None}
    batches = [T.make_lm_batch(np.random.RandomState(seed), TRAIN_BATCH,
                               MAX_LEN, VOCAB) for seed in (0, 1)]
    tokens = TRAIN_BATCH * MAX_LEN
    runs = {}
    for name, prog in (("packed", packed), ("unpacked", unpacked)):
        for key in F.flash_attention.launches:
            F.flash_attention.launches[key] = 0
        losses, wall, _ = _train(torch, fluid, exe, prog, init, batches,
                                 TRAIN_STEPS)
        launches = dict(F.flash_attention.launches)
        runs[name] = (losses, wall, launches)
        log("train (%s): %d steps, losses %s; %.1f tokens/s, mean step "
            "%.3f ms (steps 2..%d); flash launches %s", name, TRAIN_STEPS,
            " ".join("%.4f" % x for x in losses),
            tokens * (TRAIN_STEPS - 1) / wall,
            1e3 * wall / (TRAIN_STEPS - 1), TRAIN_STEPS, launches)
        check(all(np.isfinite(losses)), "%s losses not finite", name)
        check(losses[-1] < losses[0], "%s loss did not fall: %r", name,
              losses)
    launches = runs["packed"][2]
    for key, n in launches.items():
        check(n == N_LAYER * TRAIN_STEPS, "flash %s launches %d != "
              "n_layer x steps = %d", key, n, N_LAYER * TRAIN_STEPS)
    check(not any(runs["unpacked"][2].values()),
          "the unpacked program launched a flash kernel")

    parity_phase(torch, fluid, T, exe, packed, unpacked, init, batches)
    train_profile(torch, fluid, exe, packed, init, batches)
    return {"flash_fwd": launches["fwd"],
            "flash_bwd_dq": launches["bwd_dq"],
            "flash_bwd_dkv": launches["bwd_dkv"]}


ADAM_NORM_TOL = 5e-4


@contextlib.contextmanager
def _patched(module, name, wrap):
    """``module.name`` replaced by ``wrap(original)`` for the block."""
    real = getattr(module, name)
    setattr(module, name, wrap(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def _plain_route(real):
    return lambda q, scale: (False, real(q, scale)[1])


def _zero_dk(real):
    def faulted(*args):
        dk, dv = real(*args)
        return dk.zero_(), dv
    return faulted


def _apart(wp, wu):
    """(largest |diff| / max(1, max|w|) per tensor, its tensor, norm of
    the whole difference over the weights' norm)."""
    graft = {n: float(np.abs(wp[n] - wu[n]).max()) /
             max(1.0, float(np.abs(wu[n]).max())) for n in wp}
    worst = max(graft, key=graft.get)
    norm = float(np.sqrt(sum(float(np.sum((wp[n] - wu[n]) ** 2))
                             for n in wp)) /
                 np.sqrt(sum(float(np.sum(wu[n] ** 2)) for n in wp)))
    return graft[worst], worst, norm


def parity_phase(torch, fluid, T, exe, packed, unpacked, init, batches):
    """From one startup scope copied twice, PARITY_STEPS steps packed
    (the flash kernels) and unpacked (composed matmul/softmax, no
    kernel). The two forms differ only in rounding, but a ReLU input
    within rounding of 0 switches a unit on in one form and off in the
    other, which moves that unit's gradient column by one token's share.
    SGD carries such a difference into the weights at its size, so the
    SGD run is held to the reference's multi-step bound: 2e-4 of
    max(1, max|w|) per tensor (__graft_entry__.py:154). Adam divides
    every update by its gradient's own magnitude, so a weight whose
    gradient is within rounding of zero can step +lr in one form and -lr
    in the other: the Adam run is held in losses (rtol 1e-4) and in the
    norm of the whole weight difference over the weights' norm
    (ADAM_NORM_TOL), the per-tensor figure printed. Two controls at the
    same width place that limit: the packed form with its attention
    routed to the plain version (the two forms' own rounding noise, no
    kernel), and the packed form with the dK/dV kernel's dK zeroed (a
    wrong backward), which must land above the limit."""
    sgd = (_lm_program(fluid, T, True, "sgd"),
           _lm_program(fluid, T, False, "sgd"))
    scope = fluid.Scope()
    exe.run(sgd[0][1], scope=scope)
    sgd_init = {n: scope.get_numpy(n) for n in scope.local_var_names()
                if scope.find_var(n) is not None}

    def run(prog, start):
        losses, _, sc = _train(torch, fluid, exe, prog, start, batches,
                               PARITY_STEPS)
        return losses, {n: sc.get_numpy(n) for n in start}

    for opt, progs, start in (("sgd", sgd, sgd_init),
                              ("adam", (packed, unpacked), init)):
        (lp, wp), (lu, wu) = run(progs[0], start), run(progs[1], start)
        for i, (a, b) in enumerate(zip(lp, lu)):
            check(abs(a - b) <= 1e-4 * abs(b), "%s step %d loss packed %r "
                  "vs unpacked %r", opt, i + 1, a, b)
        graft, worst, norm = _apart(wp, wu)
        if opt == "sgd":
            check(graft <= 2e-4, "sgd weights diverge after %d steps: %s "
                  "%g", PARITY_STEPS, worst, graft)
        else:
            check(norm <= ADAM_NORM_TOL, "adam weights diverge after %d "
                  "steps: relative norm %g", PARITY_STEPS, norm)
        log("train parity (%s, %d steps): losses packed %s vs unpacked %s; "
            "weights: largest |diff| / max(1, max|w|) %.3g (%s), relative "
            "norm of the whole difference %.3g", opt, PARITY_STEPS,
            ["%.6f" % x for x in lp], ["%.6f" % x for x in lu], graft,
            worst, norm)
    from paddle_tpu_torch.ops import flash_attention as F
    controls = {}
    for name, attr, wrap in (("plain attention", "_route", _plain_route),
                             ("dK zeroed", "_bwd_dkv_cuda", _zero_dk)):
        with _patched(F, attr, wrap):
            lc, wc = run(packed, init)
        graft, worst, norm = _apart(wc, wu)
        controls[name] = norm
        log("train parity control (adam, packed with %s vs unpacked): "
            "losses %s; largest |diff| / max(1, max|w|) %.3g (%s), relative "
            "norm %.3g (limit %g)", name, ["%.6f" % x for x in lc], graft,
            worst, norm, ADAM_NORM_TOL)
    check(controls["dK zeroed"] > ADAM_NORM_TOL, "the Adam parity limit "
          "%g does not catch a zeroed dK (relative norm %g)", ADAM_NORM_TOL,
          controls["dK zeroed"])


def train_profile(torch, fluid, exe, prog, init, batches,
                  title="train profile (traced, 3 steps)"):
    """A separate traced pass of 3 training steps of ``prog`` (after one
    warm step): device busy share of the wall time and the kernels that
    take the most of it."""
    from torch.profiler import ProfilerActivity, profile
    main, _, avg_cost = prog
    scope = fluid.Scope()
    fluid.load_numpy_state(scope, init, exe.device)
    exe.run(main, feed=batches[0], fetch_list=[avg_cost], scope=scope)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3):
            exe.run(main, feed=batches[i % 2], fetch_list=[avg_cost],
                    scope=scope)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report_profile(prof, wall, title)


# -- phase 7 -------------------------------------------------------------
# ResNet-50 as benchmarks/resnet.py trains it: ImageNet 224x224, batch 32
RESNET_BATCH, RESNET_IMAGE, RESNET_CLASSES = 32, 224, 1000
RESNET_FUSED_PER_STEP = 36     # 1x1 convs feeding a train BN, of 53 convs
MM_STAT_TOL = 1e-5             # of sum|y - c| and sum (y - c)^2 per column
MM_RAGGED = [(1000, 72, 200), (1000, 67, 131), (97, 2048, 64), (5, 3, 1)]


def _resnet_program(fluid, R):
    """The ResNet-50 training Program and the (M, K, N) of each 1x1 conv
    that feeds a train-mode batch norm, in program order (the fused
    route's matmul_stats launches of one step)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, _, avg_cost, _ = R.build_train_net(
            model="resnet_imagenet", depth=50,
            image_shape=(3, RESNET_IMAGE, RESNET_IMAGE),
            num_classes=RESNET_CLASSES)
    block = main.global_block()
    bn_in = {op.input("X")[0] for op in block.ops
             if op.type == "batch_norm" and not op.attr("is_test", False)}
    shapes = []
    for op in block.ops:
        if op.type != "conv2d":
            continue
        co, ci, kh, kw = block.vars[op.input("Filter")[0]].shape
        out = op.output("Output")[0]
        if (kh, kw) == (1, 1) and out in bn_in:
            _, _, ho, wo = block.vars[out].shape
            shapes.append((RESNET_BATCH * ho * wo, ci, co))
    return (main, startup, avg_cost), shapes


def _mm_inputs(torch, m, k, n, dtype, seed):
    """x [M, K], w [K, N] as the transpose of an [N, K] filter (the conv
    route's layout), c [N] f32; drawn on the card from a seeded
    generator."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(m, k, generator=g, device="cuda")
    w_nk = torch.randn(n, k, generator=g, device="cuda") * k ** -0.5
    c = 0.1 * torch.randn(n, generator=g, device="cuda")
    return x.to(dtype), w_nk.to(dtype), c


def _mm_case(torch, MS, m, k, n, dtype, seed, grads):
    """Kernel against plain version on one shape; returns the largest
    absolute error of y, s1, s2 (and dx, dw)."""
    x, w_nk, c = _mm_inputs(torch, m, k, n, dtype, seed)
    got = MS.matmul_colstats(x, w_nk.t(), c)
    ref = MS._dense_matmul_stats(x, w_nk.t(), c)
    torch.cuda.synchronize()
    yc = ref[0].float() - c[None, :]
    rtol = RTOL if dtype == torch.float32 else BF16_RTOL
    err = {}
    y_err = (got[0].float() - ref[0].float()).abs()
    err["y"] = float(y_err.max())
    check(bool(torch.isfinite(got[0]).all()) and not bool(
        (y_err > ATOL + rtol * ref[0].float().abs()).any()),
        "matmul_stats y disagrees with the plain version: %s M=%d K=%d "
        "N=%d max_abs_err=%g", dtype, m, k, n, err["y"])
    for name, g, r, scale in (("s1", got[1], ref[1], yc.abs().sum(0)),
                              ("s2", got[2], ref[2], (yc * yc).sum(0))):
        e = (g - r).abs()
        err[name] = float(e.max())
        err[name + "_rel"] = float((e / scale.clamp_min(1e-30)).max())
        check(bool(torch.isfinite(g).all()) and not bool(
            (e > MM_STAT_TOL * scale + RTOL * r.abs()).any()),
            "matmul_stats %s disagrees with the plain version: %s M=%d K=%d "
            "N=%d max_abs_err=%g (%.3g of the sum of magnitudes)", name,
            dtype, m, k, n, err[name], err[name + "_rel"])
    if not grads:
        return err
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    gy = torch.randn(m, n, generator=gen, device="cuda")
    g1 = torch.randn(n, generator=gen, device="cuda")
    g2 = torch.randn(n, generator=gen, device="cuda") / m
    results = []
    for fn in (MS.matmul_colstats, MS._dense_matmul_stats):
        xl = x.detach().requires_grad_(True)
        wl = w_nk.detach().requires_grad_(True)
        y, s1, s2 = fn(xl, wl.t(), c)
        loss = (y * gy).sum() + (s1 * g1).sum() + (s2 * g2).sum()
        results.append(torch.autograd.grad(loss, [xl, wl]))
    torch.cuda.synchronize()
    for name, g, r in zip(("dx", "dw"), *results):
        scale = float(r.abs().max().clamp_min(1e-30))
        e = (g - r).abs()
        err[name] = float(e.max())
        check(bool(torch.isfinite(g).all()) and not bool(
            (e > ATOL * scale + RTOL * r.abs()).any()),
            "matmul_stats %s disagrees with the plain autograd: M=%d K=%d "
            "N=%d max_abs_err=%g (largest %g)", name, m, k, n, err[name],
            scale)
    return err


def mm_kernel_phase(torch, shapes):
    """The 15 ResNet-50 shapes and the ragged ones, fp32 with gradients
    and bf16; returns the largest fp32 absolute error over y, s1, s2."""
    from paddle_tpu_torch.ops import matmul_stats as MS
    distinct = sorted(set(shapes), reverse=True)
    worst = 0.0
    cases = [(s, torch.float32) for s in distinct + MM_RAGGED] + \
        [(s, torch.bfloat16) for s in distinct[::3] + MM_RAGGED[:2]]
    for i, ((m, k, n), dtype) in enumerate(cases):
        fp32 = dtype == torch.float32
        e = _mm_case(torch, MS, m, k, n, dtype, seed=i, grads=fp32)
        if fp32:
            worst = max(worst, e["y"], e["s1"], e["s2"])
        log("mm: %-8s M=%-6d K=%-4d N=%-4d max_abs_err y %.2e s1 %.2e s2 "
            "%.2e (of the sums of magnitudes: %.1e, %.1e)%s  ok",
            str(dtype).replace("torch.", ""), m, k, n, e["y"], e["s1"],
            e["s2"], e["s1_rel"], e["s2_rel"],
            " dx %.2e dw %.2e" % (e["dx"], e["dw"]) if fp32 else "")
    log("mm: %d cases ok (%d fp32 with gradients, %d bf16); largest fp32 "
        "abs error over y, s1, s2 %.3g", len(cases),
        len(distinct) + len(MM_RAGGED),
        len(cases) - len(distinct) - len(MM_RAGGED), worst)
    mm_repeat_checks(torch, MS, shapes)
    return worst


def _mm_work(m, k, n, itemsize=4):
    """(operations, bytes) of one launch: the product's 2MKN plus the
    statistics' 4MN (subtract, add, multiply, add); x, w and y in their
    dtype, c, s1, s2 in f32, each read or written once."""
    return (2 * m * k * n + 4 * m * n,
            itemsize * (m * k + k * n + m * n) + 4 * 3 * n)


def mm_repeat_checks(torch, MS, shapes):
    """Two launches on the same inputs give bitwise-equal y, s1 and s2
    (fixed summation orders, no atomics): at the step's largest shape and
    at the narrowest grid's (M=1,568 K=2,048 N=512: 52 blocks of
    128 x 128)."""
    largest = max(set(shapes), key=lambda s: _mm_work(*s)[0])
    for m, k, n in (largest, (1568, 2048, 512)):
        x, w_nk, c = _mm_inputs(torch, m, k, n, torch.float32, seed=3)
        a = MS._fwd_cuda(x, w_nk.t(), c)
        b = MS._fwd_cuda(x, w_nk.t(), c)
        torch.cuda.synchronize()
        same = [torch.equal(u, v) for u, v in zip(a, b)]
        check(all(same), "matmul_stats not bitwise repeatable (M=%d K=%d "
              "N=%d): y, s1, s2 equal %s", m, k, n, same)
        log("mm: M=%d K=%d N=%d fp32: two launches bitwise equal (y, s1, "
            "s2)  ok", m, k, n)


def mm_timing_phase(torch, shapes):
    """Each distinct shape, fp32: the kernel, the plain version, the
    product alone in torch.matmul and the composed route, CUDA-event
    timed per call; then the sum over one step's launches. Each shape's
    tile must give every SM a block, or the shape must be bound by bytes
    at that tile."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import matmul_stats as MS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    counts = {}
    for s in shapes:
        counts[s] = counts.get(s, 0) + 1
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "composed_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0,
            "bytes_ms": 0.0, "simt_ms": 0.0, "ms_with_host_gaps": 0.0,
            "library_ms_with_host_gaps": 0.0}
    largest = max(counts, key=lambda s: _mm_work(*s)[0])
    per_shape = {}
    for m, k, n in sorted(counts, reverse=True):
        x, w_nk, c = _mm_inputs(torch, m, k, n, torch.float32, seed=m + n)
        w = w_nk.t()
        hw = m // RESNET_BATCH
        side = int(round(hw ** 0.5))
        x4 = x.reshape(RESNET_BATCH, side, side, k).permute(
            0, 3, 1, 2).contiguous()
        w4 = w_nk.reshape(n, k, 1, 1)

        def composed(i):
            y = F.conv2d(x4, w4)
            yc = y - c.reshape(1, -1, 1, 1)
            return yc.sum(dim=(0, 2, 3)), (yc * yc).sum(dim=(0, 2, 3))

        def kernel(i):
            MS._fwd_cuda(x, w, c)

        def library(i):
            torch.matmul(x, w)

        # device time alone (a sleep kernel hides the host's enqueue), and
        # the kernel and torch.matmul also with the host's gaps
        t = {"ms": _events_ms(torch, kernel, 20, hide_host=True),
             "plain_ms": _events_ms(
                 torch, lambda i: MS._dense_matmul_stats(x, w, c), 10,
                 hide_host=True),
             "library_ms": _events_ms(torch, library, 20, hide_host=True),
             "composed_ms": _events_ms(torch, composed, 10, hide_host=True),
             "ms_with_host_gaps": _events_ms(torch, kernel, 20),
             "library_ms_with_host_gaps": _events_ms(torch, library, 20)}
        # the products run on the TF32 tensor cores (3xTF32: the
        # emulation's 3 MMAs are not counted as work)
        flops, nbytes = _mm_work(m, k, n)
        ops_ms = flops / TF32_FLOPS * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        t["bound_ms"] = max(ops_ms, bytes_ms)
        t["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
        bm, bn, blocks = MS._tile(m, n)
        check(blocks >= sms or t["bound_by"] == "bytes", "matmul_stats "
              "M=%d N=%d: %d blocks of %dx%d for %d SMs, and not bound by "
              "bytes", m, n, blocks, bm, bn, sms)
        per_shape[(m, k, n)] = t
        for key in ("ms", "plain_ms", "library_ms", "composed_ms",
                    "bound_ms", "ms_with_host_gaps",
                    "library_ms_with_host_gaps"):
            step[key] += counts[(m, k, n)] * t[key]
        step["ops_ms"] += counts[(m, k, n)] * ops_ms
        step["bytes_ms"] += counts[(m, k, n)] * bytes_ms
        step["simt_ms"] += counts[(m, k, n)] * flops / FP32_FLOPS * 1e3
        log("timing mm M=%-6d K=%-4d N=%-4d x%d per step, device time "
            "alone: kernel_ms=%.5f bound_ms=%.5f (%s: %d flops, %d bytes; "
            "fp32-SIMT operations bound %.5f) plain_ms=%.5f library_ms=%.5f "
            "(product only) composed_ms=%.5f; with the host's gaps: "
            "kernel_ms=%.5f library_ms=%.5f; tile %dx%d, %d blocks for %d "
            "SMs", m, k, n, counts[(m, k, n)], t["ms"], t["bound_ms"],
            t["bound_by"], flops, nbytes, flops / FP32_FLOPS * 1e3,
            t["plain_ms"], t["library_ms"], t["composed_ms"],
            t["ms_with_host_gaps"], t["library_ms_with_host_gaps"], bm, bn,
            blocks, sms)
    log("timing mm, summed over the %d launches of one step, device time "
        "alone: kernel_ms=%.4f bound_ms=%.4f (TF32 operations %.4f, bytes "
        "%.4f; fp32-SIMT operations %.4f) plain_ms=%.4f "
        "library_ms=%.4f (torch.matmul, product only) composed_ms=%.4f "
        "(cuDNN 1x1 conv + BN statistics pass); kernel / library %.3f; "
        "with the host's gaps: kernel_ms=%.4f library_ms=%.4f, kernel / "
        "library %.3f; largest shape M=%d K=%d N=%d:"
        " kernel_ms=%.5f bound_ms=%.5f plain_ms=%.5f library_ms=%.5f",
        len(shapes), step["ms"], step["bound_ms"], step["ops_ms"],
        step["bytes_ms"], step["simt_ms"], step["plain_ms"], step["library_ms"],
        step["composed_ms"], step["ms"] / step["library_ms"],
        step["ms_with_host_gaps"], step["library_ms_with_host_gaps"],
        step["ms_with_host_gaps"] / step["library_ms_with_host_gaps"],
        *largest, per_shape[largest]["ms"],
        per_shape[largest]["bound_ms"], per_shape[largest]["plain_ms"],
        per_shape[largest]["library_ms"])
    return {"ms": step["ms"], "plain_ms": step["plain_ms"],
            "library_ms": step["library_ms"], "bound_ms": step["bound_ms"],
            "bound_by": "operations" if step["ops_ms"] >= step["bytes_ms"]
            else "bytes", "ms_with_host_gaps": step["ms_with_host_gaps"],
            "library_ms_with_host_gaps": step["library_ms_with_host_gaps"]}


# -- phase 8 -------------------------------------------------------------
def _resnet_batches():
    return [{"data": np.random.RandomState(seed).rand(
                RESNET_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE).astype(
                    np.float32),
             "label": np.random.RandomState(seed + 100).randint(
                 0, RESNET_CLASSES, (RESNET_BATCH, 1)).astype(np.int64)}
            for seed in (0, 1)]


@contextlib.contextmanager
def _fuse(flags, on):
    flags.set_flag("fuse_conv_bn", on)
    try:
        yield
    finally:
        flags.set_flag("fuse_conv_bn", None)


def resnet_phase(torch, prog, shapes):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.ops import matmul_stats as MS
    check(len(shapes) == RESNET_FUSED_PER_STEP and len(set(shapes)) == 15,
          "ResNet-50 has %d fusable 1x1 convs (%d shapes), expected %d (15)",
          len(shapes), len(set(shapes)), RESNET_FUSED_PER_STEP)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    check(exe.device.type == "cuda", "the executor is not on the card")
    scope0 = fluid.Scope()
    exe.run(prog[1], scope=scope0)
    init = {n: scope0.get_numpy(n) for n in scope0.local_var_names()
            if scope0.find_var(n) is not None}
    batches = _resnet_batches()
    runs = {}
    for name, on in (("fused", True), ("flag off", False)):
        with _fuse(flags, on):
            MS.matmul_colstats.launches = 0
            losses, wall, _ = _train(torch, fluid, exe, prog, init, batches,
                                     TRAIN_STEPS)
            launches = MS.matmul_colstats.launches
        runs[name] = (losses, wall, launches)
        log("resnet50 (%s): %d steps, losses %s; %.1f images/s, mean step "
            "%.3f ms (steps 2..%d); matmul_stats launches %d", name,
            TRAIN_STEPS, " ".join("%.4f" % x for x in losses),
            RESNET_BATCH * (TRAIN_STEPS - 1) / wall,
            1e3 * wall / (TRAIN_STEPS - 1), TRAIN_STEPS, launches)
        check(all(np.isfinite(losses)), "%s losses not finite", name)
        check(losses[-1] < losses[0], "%s loss did not fall: %r", name,
              losses)
    check(runs["fused"][2] == RESNET_FUSED_PER_STEP * TRAIN_STEPS,
          "matmul_stats launches %d != %d per step x %d steps",
          runs["fused"][2], RESNET_FUSED_PER_STEP, TRAIN_STEPS)
    check(runs["flag off"][2] == 0, "the flag-off run launched the kernel")
    resnet_parity_phase(torch, fluid, flags, exe, prog, init, batches)
    for name, on in (("fused", True), ("flag off", False)):
        with _fuse(flags, on):
            train_profile(torch, fluid, exe, prog, init, batches,
                          "resnet50 profile (traced, 3 %s steps)" % name)
    return runs["fused"][2]


# the fused route against the flag-off route after PARITY_STEPS Momentum
# steps (see resnet_parity_phase): the largest |diff| / max(1, max|w|)
# over the weights and BN running statistics, per tensor; and a sanity
# bound on the losses of steps 2.. (step 1, before any update, is held
# at rtol 1e-4)
RESNET_PARITY_TOL = 0.2
RESNET_LATER_LOSS_RTOL = 2e-2


def _drop_ds2(real):
    def faulted(x, w, c, y, dy, ds1, ds2):
        return real(x, w, c, y, dy, ds1, ds2.new_zeros(ds2.shape))
    return faulted


def resnet_parity_phase(torch, fluid, flags, exe, prog, init, batches):
    """From one startup scope copied twice, PARITY_STEPS Momentum steps
    fused (the kernel) and flag-off (cuDNN conv, BN's own statistics
    pass). The step-1 losses (same weights: forward rounding only) agree
    at rtol 1e-4. After an update the two routes part by more than
    rounding: at this width ResNet-50's first gradients amplify rounding
    differences in the forward to ~10% in some tensors (the JAX package's
    own fused and composed routes part alike on the CPU), and cuDNN's
    backward is not repeatable run to run. So the weights and BN running
    statistics (the block's parameters) are held to RESNET_PARITY_TOL, a
    limit that controls at full width place in the same run: the
    flag-off route run again, and the fused route with the kernel
    replaced by its plain version (the routes' own noise, no kernel),
    must stay within it; the fused route with the 2 (Y - c) ds2 term
    dropped from the backward (a wrong gradient through the variance)
    must exceed it. The later losses cannot tell that fault from noise
    (its losses land as near flag-off's as the sound run's), so they are
    held only to the sanity bound RESNET_LATER_LOSS_RTOL."""
    from paddle_tpu_torch.ops import matmul_stats as MS
    names = [p.name for p in prog[0].global_block().all_parameters()]

    def run(on):
        with _fuse(flags, on):
            losses, _, sc = _train(torch, fluid, exe, prog, init, batches,
                                   PARITY_STEPS)
        return losses, {n: sc.get_numpy(n) for n in names}

    lf, wf = run(True)
    lo, wo = run(False)
    sound = _apart(wf, wo)
    la, wa = run(False)
    again = _apart(wa, wo)
    log("resnet50 parity noise (flag off run again vs flag off): losses %s;"
        " largest |diff| / max(1, max|w|) %.3g (%s), relative norm %.3g",
        ["%.6f" % x for x in la], *again)
    log("resnet50 parity (%d steps): losses fused %s vs flag off %s; "
        "weights and BN running stats: largest |diff| / max(1, max|w|) "
        "%.3g (%s), relative norm %.3g (limit %g)", PARITY_STEPS,
        ["%.6f" % x for x in lf], ["%.6f" % x for x in lo], sound[0],
        sound[1], sound[2], RESNET_PARITY_TOL)
    controls = {}
    for name, attr, wrap in (
            ("plain version", "_fwd_cuda",
             lambda real: MS._dense_matmul_stats),
            ("ds2 term dropped", "_mmstats_bwd", _drop_ds2)):
        with _patched(MS, attr, wrap):
            lc, wc = run(True)
        controls[name] = _apart(wc, wo) + (wc, lc)
        log("resnet50 parity control (fused with %s vs flag off): losses "
            "%s; largest |diff| / max(1, max|w|) %.3g (%s), relative norm "
            "%.3g (limit %g)", name, ["%.6f" % x for x in lc],
            controls[name][0], controls[name][1], controls[name][2],
            RESNET_PARITY_TOL)
    log("resnet50 parity: kernel vs its plain version on the fused route: "
        "largest |diff| / max(1, max|w|) %.3g (%s), relative norm %.3g",
        *_apart(wf, controls["plain version"][3]))
    for i, (a, b) in enumerate(zip(lf, lo)):
        rtol = 1e-4 if i == 0 else RESNET_LATER_LOSS_RTOL
        check(abs(a - b) <= rtol * abs(b), "resnet50 step %d loss fused %r "
              "vs flag off %r (rtol %g)", i + 1, a, b, rtol)
        check(abs(controls["plain version"][4][i] - b) <= rtol * abs(b),
              "resnet50 step %d loss of the plain-version control %r vs "
              "flag off %r (rtol %g)", i + 1,
              controls["plain version"][4][i], b, rtol)
    check(again[0] <= RESNET_PARITY_TOL, "the flag-off route's own run-to-"
          "run noise %g exceeds the limit %g", again[0], RESNET_PARITY_TOL)
    check(sound[0] <= RESNET_PARITY_TOL, "resnet50 weights diverge after "
          "%d steps: %s %g", PARITY_STEPS, sound[1], sound[0])
    check(controls["plain version"][0] <= RESNET_PARITY_TOL,
          "the routes' own noise %g exceeds the limit %g",
          controls["plain version"][0], RESNET_PARITY_TOL)
    check(controls["ds2 term dropped"][0] > RESNET_PARITY_TOL,
          "the parity limit %g does not catch a dropped ds2 term (%g)",
          RESNET_PARITY_TOL, controls["ds2 term dropped"][0])


# -- phase 9 -------------------------------------------------------------
# megastep: K steps as one CUDA graph (Executor.run_steps,
# Engine(megastep=K)) against the eager steps, on the full-width paths
MEGA_TRAIN_K, MEGA_TRAIN_STEPS, MEGA_SERVE_K, MEGA_PAIRS = 5, 10, 8, 3


def _reset_launches():
    from paddle_tpu_torch.ops import flash_attention as F
    from paddle_tpu_torch.ops import matmul_stats as MS
    from paddle_tpu_torch.ops import paged_attention as P
    for key in F.flash_attention.launches:
        F.flash_attention.launches[key] = 0
    MS.matmul_colstats.launches = 0
    P.paged_attention.launches = 0


def _launches():
    from paddle_tpu_torch.core.graphs import launch_counts
    return launch_counts()


def _scope_from(fluid, init, device):
    scope = fluid.Scope()
    fluid.load_numpy_state(scope, init, device)
    return scope


def _eager_steps(torch, exe, main, avg_cost, scope, batches):
    losses = [exe.run(main, feed=b, fetch_list=[avg_cost], scope=scope)[0]
              for b in batches]
    torch.cuda.synchronize()
    return losses


def _graph_steps(torch, exe, main, avg_cost, scope, batches):
    losses = []
    for i in range(0, len(batches), MEGA_TRAIN_K):
        out = exe.run_steps(main, feeds=batches[i:i + MEGA_TRAIN_K],
                            fetch_list=[avg_cost], scope=scope)
        losses += [o[0] for o in out]
    torch.cuda.synchronize()
    return losses


def _first_mismatch(torch, fluid, exe, prog, init, batch):
    """The first op, in program order, whose output differs between one
    eager step and one captured step (K=1) from the same state: every
    lowered op's outputs are copied as it runs (under capture, into the
    graph's memory, so a replay fills them). The autograd backward runs
    inside one call, so a difference born there shows first at an
    optimizer op."""
    from paddle_tpu_torch.core import executor as E
    main, _, avg_cost = prog
    records = []
    real = E._lower_op

    def recording(ctx, op):
        real(ctx, op)
        for names in op.outputs.values():
            for n in names:
                v = ctx.env.get(n)
                if isinstance(v, torch.Tensor):
                    records.append((op.type, n, v.detach().clone()))

    E._lower_op = recording
    try:
        exe.run(main, feed=batch, fetch_list=[avg_cost],
                scope=_scope_from(fluid, init, exe.device))
        eager = list(records)
        del records[:]
        exe.run_steps(main, feeds=[batch], fetch_list=[avg_cost],
                      scope=_scope_from(fluid, init, exe.device),
                      use_program_cache=False)
        graph = records[-len(eager):]
    finally:
        E._lower_op = real
    torch.cuda.synchronize()
    for (op_type, name, a), (_, _, b) in zip(eager, graph):
        if not torch.equal(a, b):
            diff = (a.double() - b.double()).abs().max().item() \
                if a.is_floating_point() else float("nan")
            return "%s (output %s, largest |diff| %.3g)" % (op_type, name,
                                                            diff)
    return "none of the %d op outputs (the difference is in the state " \
        "update)" % len(eager)


def _mega_compare(torch, fluid, exe, prog, init, batches, what, limit,
                  apart):
    """MEGA_TRAIN_STEPS run() steps against MEGA_TRAIN_STEPS / K
    run_steps(K) dispatches over the same batches, each from its own copy
    of ``init``; the graph was captured before (a warm call on a third
    copy), so the counted run only replays. Losses and weights must be
    bitwise equal; where they are not, the first differing op is named
    and the weights are held to ``limit`` by ``apart`` (the limit the
    existing controls place). Returns (the graph run's launch counts,
    bitwise)."""
    main, _, avg_cost = prog
    names = sorted(init)
    sa = _scope_from(fluid, init, exe.device)
    le = _eager_steps(torch, exe, main, avg_cost, sa, batches)
    sb = _scope_from(fluid, init, exe.device)
    _reset_launches()
    replays = exe.stats["graph_replays"]
    lg = _graph_steps(torch, exe, main, avg_cost, sb, batches)
    counts = _launches()
    check(exe.stats["graph_replays"] - replays
          == MEGA_TRAIN_STEPS // MEGA_TRAIN_K, "%s: %d replays for %d "
          "dispatches", what, exe.stats["graph_replays"] - replays,
          MEGA_TRAIN_STEPS // MEGA_TRAIN_K)
    we = {n: sa.get_numpy(n) for n in names}
    wg = {n: sb.get_numpy(n) for n in names}
    check(all(np.isfinite(lg)), "%s: graph losses not finite", what)
    same_loss = all(np.array_equal(a, b) for a, b in zip(le, lg))
    differ = [n for n in names if not np.array_equal(we[n], wg[n])]
    log("%s: %d run() steps vs %d run_steps(K=%d) dispatches: losses %s; "
        "graph losses %s; %s", what, MEGA_TRAIN_STEPS,
        MEGA_TRAIN_STEPS // MEGA_TRAIN_K, MEGA_TRAIN_K,
        " ".join("%.6f" % float(x) for x in le),
        "bitwise equal" if same_loss else
        " ".join("%.6f" % float(x) for x in lg),
        "every one of %d state tensors bitwise equal" % len(names)
        if not differ else "%d of %d state tensors differ (first %s)"
        % (len(differ), len(names), differ[0]))
    if same_loss and not differ:
        return counts, True
    op = _first_mismatch(torch, fluid, exe, prog, init, batches[0])
    value, worst = apart(wg, we)
    log("%s: NOT bitwise; first differing op: %s; weights apart %.3g "
        "(%s), limit %g", what, op, value, worst, limit)
    check(value <= limit, "%s: graph weights %g apart from eager (limit "
          "%g; first differing op %s)", what, value, op, limit)
    for i, (a, b) in enumerate(zip(le, lg)):
        check(abs(float(a) - float(b)) <= 1e-4 * abs(float(b)),
              "%s step %d loss eager %r vs graph %r", what, i + 1, a, b)
    return counts, False


def _capture_warm(torch, fluid, exe, prog, init, batches, what):
    """A warm call on a scratch copy of ``init``: captures the K-step
    graph, so that the counted and timed runs only replay."""
    main, _, avg_cost = prog
    captures = exe.stats["graph_captures"]
    t0 = time.perf_counter()
    exe.run_steps(main, feeds=batches[:MEGA_TRAIN_K], fetch_list=[avg_cost],
                  scope=_scope_from(fluid, init, exe.device))
    torch.cuda.synchronize()
    check(exe.stats["graph_captures"] == captures + 1,
          "%s: the warm call captured no graph", what)
    log("%s: K=%d graph captured (warm-up step, capture, first replay) in "
        "%.3f s", what, MEGA_TRAIN_K, time.perf_counter() - t0)


def _median(xs):
    return float(np.median(xs))


def _timed_train(torch, exe, prog, scope, batches, graph):
    main, _, avg_cost = prog
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (_graph_steps if graph else _eager_steps)(torch, exe, main, avg_cost,
                                              scope, batches)
    return time.perf_counter() - t0


def _interleaved_train(torch, fluid, exe, prog, init, batches, what,
                       unit, per_step, smi):
    """Eager and graph steps in A/B/A/B order, MEGA_PAIRS pairs (the host
    varies from run to run), each over the MEGA_TRAIN_STEPS batches on a
    scope of its own; then one traced pass of each. Returns the medians
    and busy shares."""
    scopes = {g: _scope_from(fluid, init, exe.device) for g in (0, 1)}
    walls = {0: [], 1: []}
    for _ in range(MEGA_PAIRS):
        for g in (0, 1):
            walls[g].append(_timed_train(torch, exe, prog, scopes[g],
                                         batches, g))
    busy = {}
    for g in (0, 1):
        _timed_train(torch, exe, prog, scopes[g], batches[:MEGA_TRAIN_K], g)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = _timed_train(torch, exe, prog, scopes[g],
                                batches[:MEGA_TRAIN_K], g)
            torch.cuda.synchronize()
        busy[g] = _report_profile(
            prof, wall, "%s profile (traced, %d %s steps)" % (
                what, MEGA_TRAIN_K, "graph" if g else "eager"))[0]
    n = len(batches)
    out = {}
    for g, name in ((0, "eager"), (1, "graph")):
        ms = [1e3 * w / n for w in walls[g]]
        rate = [per_step * n / w for w in walls[g]]
        out[name] = (_median(ms), _median(rate), busy[g])
        log("%s timing (%s, %d pairs interleaved eager/graph): step ms %s "
            "(median %.3f); %s %s (median %.1f); device busy %s; %s", what,
            name, MEGA_PAIRS, " ".join("%.3f" % x for x in ms), out[name][0],
            unit, " ".join("%.1f" % x for x in rate), out[name][1],
            "not measured" if busy[g] is None else "%.1f%%" % (100 * busy[g]),
            smi)
    log("%s timing: graph / eager step ms (medians) %.3f; %s", what,
        out["graph"][0] / out["eager"][0], smi)
    return out


def mega_train_lm_phase(torch, smi):
    """The packed LM with Adam(1e-3) at full width: 10 run() steps vs 2
    run_steps(K=5) dispatches over the same 10 batches; flash launches
    exactly n_layer per logical step, each kernel, through replays."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer as T
    exe = fluid.Executor(fluid.CUDAPlace(0))
    prog = _lm_program(fluid, T, True)
    scope0 = fluid.Scope()
    exe.run(prog[1], scope=scope0)
    init = {n: scope0.get_numpy(n) for n in scope0.local_var_names()
            if scope0.find_var(n) is not None}
    batches = [T.make_lm_batch(np.random.RandomState(seed), TRAIN_BATCH,
                               MAX_LEN, VOCAB)
               for seed in range(MEGA_TRAIN_STEPS)]
    what = "mega-train lm"
    _capture_warm(torch, fluid, exe, prog, init, batches, what)
    counts, bitwise = _mega_compare(
        torch, fluid, exe, prog, init, batches, what, ADAM_NORM_TOL,
        lambda a, b: (_apart(a, b)[2], "relative norm of the difference"))
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(counts[key] == N_LAYER * MEGA_TRAIN_STEPS, "%s: %s launches "
              "%d through replays != n_layer x steps = %d", what, key,
              counts[key], N_LAYER * MEGA_TRAIN_STEPS)
    log("%s: launches through %d replays %s (n_layer %d x %d logical "
        "steps each); captures %d, replays %d", what,
        MEGA_TRAIN_STEPS // MEGA_TRAIN_K,
        {k: v for k, v in counts.items() if v}, N_LAYER, MEGA_TRAIN_STEPS,
        exe.stats["graph_captures"], exe.stats["graph_replays"])
    timing = _interleaved_train(torch, fluid, exe, prog, init, batches,
                                what, "tokens/s", TRAIN_BATCH * MAX_LEN,
                                smi)
    return counts, bitwise, timing


def mega_train_resnet_phase(torch, prog, smi):
    """ResNet-50 (batch 32, 224x224) with fuse_conv_bn on and off: 10
    run() steps vs 2 run_steps(K=5) dispatches over the same 10 batches.
    Eager ResNet steps are not repeatable run to run by default (cuDNN's
    backward), so a control runs the eager steps twice; where they part,
    the comparison is repeated with cudnn.deterministic (graph captured
    anew), which must be bitwise. matmul_stats launches exactly 36 per
    logical step through replays (fused), none with the flag off."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope0 = fluid.Scope()
    exe.run(prog[1], scope=scope0)
    init = {n: scope0.get_numpy(n) for n in scope0.local_var_names()
            if scope0.find_var(n) is not None}
    batches = [{"data": np.random.RandomState(seed).rand(
                    RESNET_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE).astype(
                        np.float32),
                "label": np.random.RandomState(seed + 100).randint(
                    0, RESNET_CLASSES, (RESNET_BATCH, 1)).astype(np.int64)}
               for seed in range(MEGA_TRAIN_STEPS)]
    params = [p.name for p in prog[0].global_block().all_parameters()]

    def apart(a, b):
        graft, worst, _ = _apart({n: a[n] for n in params},
                                 {n: b[n] for n in params})
        return graft, worst

    out = {}
    for name, on in (("fused", True), ("flag off", False)):
        what = "mega-train resnet50 (%s)" % name
        with _fuse(flags, on):
            _capture_warm(torch, fluid, exe, prog, init, batches, what)
            main, _, avg_cost = prog
            s1 = _scope_from(fluid, init, exe.device)
            s2 = _scope_from(fluid, init, exe.device)
            l1 = _eager_steps(torch, exe, main, avg_cost, s1, batches)
            l2 = _eager_steps(torch, exe, main, avg_cost, s2, batches)
            repeatable = all(np.array_equal(a, b) for a, b in zip(l1, l2)) \
                and all(np.array_equal(s1.get_numpy(n), s2.get_numpy(n))
                        for n in init)
            log("%s: eager steps run twice %s", what,
                "bitwise equal" if repeatable else
                "part (cuDNN's default algorithms are not repeatable); the "
                "graph is compared under cudnn.deterministic")
            det = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = not repeatable or det
            try:
                if not repeatable:
                    _capture_warm(torch, fluid, exe, prog, init, batches,
                                  what + " deterministic")
                counts, bitwise = _mega_compare(
                    torch, fluid, exe, prog, init, batches, what,
                    RESNET_PARITY_TOL, apart)
            finally:
                torch.backends.cudnn.deterministic = det
            want = RESNET_FUSED_PER_STEP * MEGA_TRAIN_STEPS if on else 0
            check(counts["matmul_stats"] == want, "%s: matmul_stats launches "
                  "%d through replays, expected %d", what,
                  counts["matmul_stats"], want)
            log("%s: matmul_stats launches through %d replays %d (%d per "
                "logical step); captures %d, replays %d", what,
                MEGA_TRAIN_STEPS // MEGA_TRAIN_K, counts["matmul_stats"],
                counts["matmul_stats"] // MEGA_TRAIN_STEPS,
                exe.stats["graph_captures"], exe.stats["graph_replays"])
            timing = _interleaved_train(torch, fluid, exe, prog, init,
                                        batches, what, "images/s",
                                        RESNET_BATCH, smi)
        out[name] = (counts, bitwise, repeatable, timing)
    return out


def _decode_heavy_requests(rng):
    """32 requests, one per slot: prompts of 8-32 tokens, 192 new tokens
    each (long generation at a full batch)."""
    return [([1] + rng.integers(3, VOCAB, int(rng.integers(7, 32))).tolist(),
             192) for _ in range(32)]


def _serve_once(torch, eng, reqs):
    before = dict(eng.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate_many([p for p, _ in reqs], [m for _, m in reqs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = {k: eng.stats[k] - before[k] for k in eng.stats}
    return out, wall, delta


def mega_serve_phase(torch, smi):
    """The flagship served by Engine(slots=32, prefill_chunk=16,
    block_size=16) at megastep=1 and megastep=8 on the 64-request mixed
    set and a decode-heavy set (32 requests, max_new 192): tokens equal
    between K=1 and K=8, and for 4 requests equal to
    sequential_generate's; paged launches exactly n_layer x (decode steps
    the device ran + prefill chunks). Then timed A/B/A/B and traced."""
    from paddle_tpu_torch.models.transformer_infer import (
        TransformerLMInfer, init_stream)
    from paddle_tpu_torch.serving import Engine, sequential_generate
    stream = init_stream(VOCAB, MAX_LEN, N_LAYER, N_HEAD, D_MODEL, D_INNER,
                         seed=0)
    model = TransformerLMInfer.from_stream(
        stream, N_LAYER, N_HEAD, D_MODEL, MAX_LEN, end_id=VOCAB)
    sets = {"mixed": _requests(np.random.default_rng(0)),
            "decode-heavy": _decode_heavy_requests(np.random.default_rng(1))}
    engines = {}
    seqs = {}
    for k in (1, MEGA_SERVE_K):
        eng = Engine(model, slots=32, prefill_chunk=16, block_size=16,
                     megastep=k)
        t0 = time.perf_counter()
        eng.warmup()
        log("mega-serve: Engine(megastep=%d) warmup %.3f s (graph "
            "captures %d)", k, time.perf_counter() - t0,
            eng.stats["graph_captures"])
        engines[k] = eng
    graph_paged = 0
    try:
        timing = {}
        for set_name, reqs in sets.items():
            outs = {}
            for k, eng in engines.items():
                _reset_launches()
                out, wall, d = _serve_once(torch, eng, reqs)
                launches = _launches()["paged_attention"]
                outs[k] = out
                ntok = sum(len(t) for t, _ in out)
                log("mega-serve %s (megastep=%d): %d requests, %d tokens in "
                    "%.3f s = %.1f tokens/s; decode steps consumed %d, run %d "
                    "(%.3f ms each); megastep dispatches %d; prefill chunks "
                    "%d; graph replays %d (captures %d); paged launches %d; "
                    "%s", set_name, k, len(out), ntok, wall, ntok / wall,
                    d["decode_steps"], d["decode_steps_run"],
                    1e3 * d["decode_seconds"] / d["decode_steps_run"],
                    d["megastep_dispatches"], d["prefill_chunks"],
                    d["graph_replays"], eng.stats["graph_captures"],
                    launches, smi)
                want = N_LAYER * (d["decode_steps_run"] + d["prefill_chunks"])
                check(launches == want, "mega-serve %s megastep=%d: paged "
                      "launches %d != n_layer x (decode steps run + prefill "
                      "chunks) = %d", set_name, k, launches, want)
                for i, ((toks, score), (_, m)) in enumerate(zip(out, reqs)):
                    check(len(toks) == m and np.isfinite(score),
                          "mega-serve %s megastep=%d request %d: bad "
                          "output", set_name, k, i)
                if k > 1:
                    check(d["megastep_dispatches"] > 0 and
                          d["graph_replays"] == d["megastep_dispatches"],
                          "mega-serve %s: %d megastep dispatches, %d "
                          "replays", set_name, d["megastep_dispatches"],
                          d["graph_replays"])
                    graph_paged += launches
            diverged = [i for i, (a, b) in enumerate(zip(outs[1],
                                                         outs[MEGA_SERVE_K]))
                        if a[0] != b[0]]
            check(not diverged, "mega-serve %s: megastep=%d tokens differ "
                  "from megastep=1 for requests %s", set_name, MEGA_SERVE_K,
                  diverged)
            seq = seqs[set_name] = sequential_generate(model, reqs[:4])
            for i, ((a, _), (b, _)) in enumerate(zip(outs[MEGA_SERVE_K][:4],
                                                     seq)):
                check(a == b, "mega-serve %s request %d differs from "
                      "sequential_generate", set_name, i)
            log("mega-serve %s: megastep=%d tokens equal megastep=1's (%d "
                "requests) and sequential_generate's (4 requests)",
                set_name, MEGA_SERVE_K, len(reqs))
            timing[set_name] = _interleaved_serve(
                torch, {"megastep=%d" % k: e for k, e in engines.items()},
                reqs, "mega-serve " + set_name, smi)
    finally:
        for eng in engines.values():
            eng.close()
    return graph_paged, timing, seqs


def _interleaved_serve(torch, engines, reqs, title, smi):
    """Each engine of ``{label: engine}`` serves ``reqs`` in turn,
    MEGA_PAIRS rounds (A/B/A/B: the host varies from run to run), then
    once traced. A decode dispatch is a plain step the device ran or a
    scoring dispatch. Returns {label: (median ms per decode dispatch,
    median tokens/s, busy share)}."""
    walls = {k: [] for k in engines}
    rates = {k: [] for k in engines}
    steps = {k: [] for k in engines}
    for _ in range(MEGA_PAIRS):
        for k, eng in engines.items():
            out, wall, d = _serve_once(torch, eng, reqs)
            walls[k].append(wall)
            rates[k].append(sum(len(t) for t, _ in out) / wall)
            steps[k].append(1e3 * d["decode_seconds"] / (
                d["decode_steps_run"] + d["spec_dispatches"]))
    busy = {}
    from torch.profiler import ProfilerActivity, profile
    for k, eng in engines.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, wall, _ = _serve_once(torch, eng, reqs)
        busy[k] = _report_profile(
            prof, wall, "%s profile (traced, %s)" % (title, k),
            focus="paged_attention_kernel")[0]
    out = {}
    for k in engines:
        out[k] = (_median(steps[k]), _median(rates[k]), busy[k])
        log("%s timing (%s, %d rounds interleaved): decode dispatch ms %s "
            "(median %.3f); tokens/s %s (median %.1f); wall s %s; device "
            "busy %s; %s", title, k, MEGA_PAIRS,
            " ".join("%.3f" % x for x in steps[k]), out[k][0],
            " ".join("%.1f" % x for x in rates[k]), out[k][1],
            " ".join("%.3f" % x for x in walls[k]),
            "not measured" if busy[k] is None else "%.1f%%" % (100 * busy[k]),
            smi)
    return out


# -- phase 10 ------------------------------------------------------------
# speculative and sampled serving: the scoring dispatch (the paged kernel
# at C = gamma + 1 rows), the truncated drafter, the counter-keyed
# sampler and the sampled megastep graph
SPEC_GAMMA, SPEC_LAYERS = 4, 2
# a parting is a near-tie only if the scoring dispatch's logits of that
# row stay within this many times the row's fp32 rounding of the plain
# step's (``_divergence``)
SPEC_DELTA_X = 2
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
SAMPLED_SEEDS = range(100, 116)


def spec_kernel_phase(torch):
    """Kernel #1 at the scoring shape (S=32, H=8, C=gamma+1=5, dk 64, bs
    16, ragged per-row qpos = pos + j) against the plain version on
    fp32 and fp8 pools (layers 0 and 3, phase 3's tolerances); then
    timed at (d), every slot scoring positions 251..255 of a 256-position
    chain on the phase-3 timing pool, as device time alone and with the
    host's gaps, against the plain version, scaled_dot_product_attention
    over the gathered K/V with the per-row causal mask, and the bound.
    Returns (largest abs error, timing entry)."""
    from paddle_tpu_torch.ops import paged_attention as P
    rng = np.random.default_rng(10)
    s, c, bs, nbmax = 32, SPEC_GAMMA + 1, 16, 16
    worst = 0.0
    for quant in ("fp32", "fp8"):
        chains = rng.integers(1, nbmax + 1, size=s)
        chains[0] = nbmax
        case = _pool_case(torch, rng, s, c, chains, quant)
        last = (chains - 1) * bs + rng.integers(0, bs, size=s)
        pos = np.maximum(last - (c - 1), 0)
        case["qpos"] = torch.from_numpy(
            (pos[:, None] + np.arange(c)[None]).astype(np.int32)).cuda()
        args = tuple(case[k] for k in ("q", "pool_k", "pool_v", "btab",
                                       "qpos"))
        nb_t = torch.tensor([nbmax], dtype=torch.int32, device="cuda")
        for layer in (0, 3):
            got = P.paged_attention(*args, nblk=nb_t,
                                    k_scale=case["k_scale"],
                                    v_scale=case["v_scale"], layer=layer)
            ref = P._attend_plain(*args, nbmax, case["k_scale"],
                                  case["v_scale"], layer=layer)
            torch.cuda.synchronize()
            err = (got - ref).abs()
            bad = err > ATOL + RTOL * ref.abs()
            worst = max(worst, float(err.max()))
            check(bool(torch.isfinite(got).all()) and not bool(bad.any()),
                  "scoring shape: kernel disagrees with _attend_plain (%s, "
                  "layer %d): max_abs_err=%g", quant, layer,
                  float(err.max()))
            log("spec kernel: S=%d C=%d dk=64 bs=16 %s ragged qpos=pos+j "
                "splits=%d layer=%d max_abs_err=%.3g  ok", s, c, quant,
                P._splits(s, 8, c, nbmax, bs), layer, float(err.max()))
    pk, pv, shapes = _paged_shapes(torch)
    bt = shapes["a"][1]
    h, dk = pk.shape[2], pk.shape[4]
    q = torch.from_numpy(rng.normal(size=(s, h, c, dk)).astype(
        np.float32) * dk ** -0.5).cuda()
    qp = (torch.arange(c, dtype=torch.int32, device="cuda")[None]
          + (nbmax * bs - c)).expand(s, c).contiguous()
    nb_t = torch.tensor([nbmax], dtype=torch.int32, device="cuda")
    npos = nbmax * bs
    kpos = torch.arange(npos, device="cuda")
    mask = kpos[None, None, None, :] <= qp[:, None, :, None]
    dense = []
    for layer in range(4):
        dense.append([pool[:, layer][bt.long()].permute(0, 2, 1, 3, 4)
                      .reshape(s, h, npos, dk).contiguous()
                      for pool in (pk, pv)])
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kernel(i):
        P.paged_attention(q, pk, pv, bt, qp, nblk=nb_t, layer=i % 4)

    def library(i):
        k, v = dense[i % 4]
        sdpa(q, k, v, attn_mask=mask, scale=1.0)

    def plain(i):
        P._attend_plain(q, pk, pv, bt, qp, nbmax, None, None, layer=i % 4)
    r = {"ms": _events_ms(torch, kernel, 100, hide_host=True),
         "ms_with_host_gaps": _events_ms(torch, kernel, 100),
         "library_ms": _events_ms(torch, library, 100, hide_host=True),
         "library_ms_with_host_gaps": _events_ms(torch, library, 100),
         "plain_ms": _events_ms(torch, plain, 5)}
    got = P.paged_attention(q, pk, pv, bt, qp, nblk=nb_t, layer=0)
    lib = sdpa(q, dense[0][0], dense[0][1], attn_mask=mask, scale=1.0)
    check(torch.allclose(got, lib, rtol=RTOL, atol=ATOL),
          "kernel disagrees with scaled_dot_product_attention at (d)")
    nbytes, flops = _paged_work(q, qp, h, dk, bs)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    r.update(bound_ms=max(bytes_ms, ops_ms),
             bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    log("timing (d) scoring S=%d H=%d C=%d dk=%d bs=%d, positions 251..255 "
        "of 256 per slot, fp32, splits %d: device time alone kernel_ms=%.5f "
        "library_ms=%.5f (kernel / library %.3f); with the host's gaps "
        "kernel_ms=%.5f library_ms=%.5f; plain_ms=%.5f (with gaps); "
        "bound_ms=%.5f (%s: %d bytes %.5f ms, %d flops at fp32 SIMT %.5f "
        "ms)", s, h, c, dk, bs, P._splits(s, h, c, nbmax, bs), r["ms"],
        r["library_ms"], r["ms"] / r["library_ms"], r["ms_with_host_gaps"],
        r["library_ms_with_host_gaps"], r["plain_ms"], r["bound_ms"],
        r["bound_by"], nbytes, bytes_ms, flops, ops_ms)
    return worst, r


def _row_logits(torch, model, prompt, toks, i):
    """The logits for generated token ``i`` of a request whose earlier
    tokens are ``toks[:i]``, under three fp32 dispatches: the plain
    paged step (S=32 slots, row 0 live, prefilled in chunks of 16, as the
    plain engine computes that row), the scoring dispatch (C = gamma+1,
    the position at j=0, the following tokens as drafts, on a copy of the
    same pool) and the dense single-row step. Returns three [V] f32
    tensors."""
    dev, bs, s = model.device, 16, 32
    nbmax = MAX_LEN // bs
    need = len(prompt) - 1
    st = model._init_paged_state(nbmax, bs)
    btab = torch.zeros((s, nbmax), dtype=torch.int32, device=dev)
    btab[0] = torch.arange(nbmax, dtype=torch.int32, device=dev)
    for cur in range(0, need, 16):
        n = min(16, need - cur)
        chunk = torch.zeros(16, dtype=torch.long, device=dev)
        chunk[:n] = torch.tensor(prompt[cur:cur + n], device=dev)
        model._prefill_chunk_paged(st, chunk, cur, n, btab[0],
                                   block_kernel=True)
    active = torch.zeros(s, dtype=torch.bool, device=dev)
    active[0] = True
    tok = torch.zeros(s, dtype=torch.long, device=dev)
    pos = torch.zeros(s, dtype=torch.long, device=dev)
    seq = [prompt[-1]] + list(toks[:i])
    c = SPEC_GAMMA + 1
    for j in range(i + 1):
        tok[0], pos[0] = seq[j], need + j
        if j == i:
            drafts = list(toks[i:i + c - 1])
            toks_c = torch.zeros((s, c), dtype=torch.long, device=dev)
            toks_c[0, :1 + len(drafts)] = torch.tensor(
                [seq[i]] + drafts, device=dev)
            nv = torch.zeros(s, dtype=torch.long, device=dev)
            nv[0] = len(drafts)
            spool = {n: t.clone() for n, t in st.items()}
            score, _ = model._spec_logits_paged(
                toks_c, spool, pos, btab, nv, write_mask=active,
                block_kernel=True)
        plain, _ = model._step_logits_paged(tok, st, pos, btab,
                                            write_mask=active,
                                            block_kernel=True)
    dstate = model._init_state(1)
    for t, tk in enumerate(list(prompt[:-1]) + seq):
        dense, dstate = model._step_logits(
            torch.full((1,), tk, dtype=torch.long, device=dev), dstate, t)
    return plain[0].float(), score[0, 0].float(), dense[0].float()


def _divergence(torch, model, req, a, b, sp=None):
    """Diagnose the first token where the speculative run ``a`` and the
    plain run ``b`` part. The row's fp32 rounding is taken as the largest
    difference between two correct fp32 dispatches of it, the plain
    paged step and the dense step (``_row_logits``), neither of them the
    scoring dispatch under test. A near-tie needs both: the scoring
    dispatch's logits of the row within ``SPEC_DELTA_X`` times that
    rounding of the plain step's, and (greedy) the two tokens' logits
    under the plain step no further apart than that rounding, or
    (sampled, ``sp``) the uniform no further from a step of the plain
    step's CDF than the two correct dispatches' CDFs differ. Returns
    (near-tie, figures)."""
    from paddle_tpu_torch.serving import sampling as SM
    i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if i is None:
        return False, "lengths %d vs %d" % (len(a), len(b))
    with torch.no_grad():
        plain, score, dense = _row_logits(torch, model, req[0], b, i)
    eps = float((plain - dense).abs().max())
    delta = float((plain - score).abs().max())
    top = torch.topk(plain, 2)
    gap = abs(float(plain[a[i]] - plain[b[i]]))
    ulp = float(torch.finfo(torch.float32).eps * top.values[0].abs())
    msg = ("token %d: %d vs %d (plain); plain step top-2 %s, logit gap of "
           "the two %.3g (fp32 ulp of the top logit %.3g); scoring "
           "dispatch picks %d (gap %.3g), differs from the plain step by "
           "up to %.3g; the dense step picks %d, differs by up to %.3g"
           % (i, a[i], b[i], top.indices.tolist(), gap, ulp,
              int(score.argmax()), abs(float(score[a[i]] - score[b[i]])),
              delta, int(dense.argmax()), eps))
    close = delta <= SPEC_DELTA_X * eps
    if not close:
        msg += ("; the scoring dispatch is further from the plain step "
                "than %d x the row's rounding" % SPEC_DELTA_X)
    if sp is None:
        return close and gap <= eps, msg
    dev = model.device

    def cdf(lg, order=None):
        final = SM.filter_logits(
            lg[None], torch.tensor([sp["temperature"]], device=dev),
            torch.tensor([sp["top_k"]], device=dev),
            torch.tensor([sp["top_p"]], device=dev))
        p = torch.softmax(final, -1)[0]
        if order is None:
            order = torch.sort(p, descending=True, stable=True).indices
        return torch.cumsum(p[order], 0), order
    c_plain, order = cdf(plain)
    c_dense, _ = cdf(dense, order)
    u = float(SM.uniform(SM.step_keys(
        torch.tensor([sp["seed"]], device=dev),
        torch.tensor([i], device=dev)))[0])
    dist = float((c_plain - u * c_plain[-1]).abs().min())
    eps_cdf = float((c_plain - c_dense).abs().max())
    msg += ("; sampled: u %.7f lands %.3g from the plain step's nearest "
            "CDF step; the two dispatches' CDFs differ by up to %.3g"
            % (u, dist, eps_cdf))
    return close and dist <= eps_cdf, msg


def _same_or_near_tie(torch, model, req, a, b, what, near_ties, sp=None):
    """Tokens ``a`` (speculative) must equal ``b`` (plain), unless they
    part at a near-tie (``_divergence``); a near-tie is logged and kept
    in ``near_ties``, anything else fails."""
    if a == b:
        return True
    tie, msg = _divergence(torch, model, req, a, b, sp)
    log("%s: tokens part: %s: %s", what,
        "a near-tie within the row's fp32 rounding" if tie
        else "NOT a near-tie", msg)
    check(tie, "%s differs from the plain engine, and not at a near-tie: "
          "%s", what, msg)
    near_ties.append("%s: %s" % (what, msg))
    return False


@contextlib.contextmanager
def _scoring_launches(eng):
    """Watch ``eng``'s scoring dispatches for one run: yields (the paged
    launches inside each call of ``_spec_step_impl``, read from the
    kernel's counter before and after it; {query rows C: launches}
    inside those calls, read from each launch's q)."""
    from paddle_tpu_torch.ops import paged_attention as P
    per, rows, inside = [], {}, [False]
    impl, attend = eng._spec_step_impl, P._attend_cuda

    def attend_seen(q, *args, **kw):
        if inside[0]:
            rows[q.shape[2]] = rows.get(q.shape[2], 0) + 1
        return attend(q, *args, **kw)

    def scoring(*args, **kw):
        n0 = P.paged_attention.launches
        inside[0] = True
        try:
            return impl(*args, **kw)
        finally:
            inside[0] = False
            per.append(P.paged_attention.launches - n0)
    eng._spec_step_impl, P._attend_cuda = scoring, attend_seen
    try:
        yield per, rows
    finally:
        del eng._spec_step_impl
        P._attend_cuda = attend


def _spec_engines(model):
    from paddle_tpu_torch.serving import Engine
    out = {}
    for label, kw in (("plain K=1", {}),
                      ("plain K=%d" % MEGA_SERVE_K,
                       {"megastep": MEGA_SERVE_K}),
                      ("spec-ngram", {"speculative": True,
                                      "spec_gamma": SPEC_GAMMA,
                                      "spec_drafter": "ngram"}),
                      ("spec-truncated", {"speculative": True,
                                          "spec_gamma": SPEC_GAMMA,
                                          "spec_drafter": "truncated",
                                          "spec_layers": SPEC_LAYERS})):
        eng = Engine(model, slots=32, prefill_chunk=16, block_size=16, **kw)
        t0 = time.perf_counter()
        eng.warmup(sampled=True)
        log("spec-serve: %s warmup (greedy and sampled) %.3f s, graph "
            "captures %d", label, time.perf_counter() - t0,
            eng.stats["graph_captures"])
        out[label] = eng
    return out


def spec_serve_phase(torch, smi, seqs):
    """Speculative and sampled serving of the flagship LM. Greedy: both
    request sets through the ngram and the truncated drafter, tokens
    equal to the plain engine's at megastep 1 (or parted at a diagnosed
    near-tie, ``_same_or_near_tie``), whose tokens equal (4 requests)
    sequential_generate's (``seqs``, from phase 9); paged launches exactly
    n_layer x (scoring dispatches + plain steps run + prefill chunks) +
    spec_layers x truncated draft steps. Sampled: 16 requests (seeds
    100-115) among 4 greedy ones through the plain engine, the megastep
    graph (its sampled variant) and the speculative engine, twice;
    the RNG's bits on the card against the CPU's. Then the decode-heavy
    set timed A/B/A/B over the four engines. Returns (paged launches,
    those of them inside scoring dispatches, at C = gamma + 1, counted
    around each dispatch by ``_scoring_launches``; timing)."""
    from paddle_tpu_torch.models.transformer_infer import (
        TransformerLMInfer, init_stream)
    stream = init_stream(VOCAB, MAX_LEN, N_LAYER, N_HEAD, D_MODEL, D_INNER,
                         seed=0)
    model = TransformerLMInfer.from_stream(
        stream, N_LAYER, N_HEAD, D_MODEL, MAX_LEN, end_id=VOCAB)
    sets = {"mixed": _requests(np.random.default_rng(0)),
            "decode-heavy": _decode_heavy_requests(np.random.default_rng(1))}
    engines = _spec_engines(model)
    total = scoring = 0
    near_ties = []
    try:
        for set_name, reqs in sets.items():
            _reset_launches()
            base, _, d = _serve_once(torch, engines["plain K=1"], reqs)
            want = N_LAYER * (d["decode_steps_run"] + d["prefill_chunks"])
            launches = _launches()["paged_attention"]
            check(launches == want, "spec-serve %s plain: paged launches "
                  "%d != %d", set_name, launches, want)
            total += launches
            for i, ((a, _), (b, _)) in enumerate(zip(base, seqs[set_name])):
                check(a == b, "spec-serve %s: plain request %d differs from "
                      "sequential_generate", set_name, i)
            for label in ("spec-ngram", "spec-truncated"):
                eng = engines[label]
                _reset_launches()
                with _scoring_launches(eng) as (per, rows):
                    out, wall, d = _serve_once(torch, eng, reqs)
                launches = _launches()["paged_attention"]
                want = (N_LAYER * (d["spec_dispatches"] + d["decode_steps_run"]
                                   + d["prefill_chunks"])
                        + eng._spec_layers * d["spec_draft_steps"])
                ntok = sum(len(t) for t, _ in out)
                log("spec-serve %s (%s, gamma %d%s): %d requests, %d tokens "
                    "in %.3f s = %.1f tokens/s; scoring dispatches %d, "
                    "drafted %d, accepted %d (%.1f%% of drafted), emitted "
                    "%d (accepted tokens per scoring dispatch %.3f, emitted "
                    "%.3f, summed over its slots); plain steps run %d; "
                    "draft steps %d; prefill chunks %d; paged launches %d; "
                    "%s", set_name, label, SPEC_GAMMA,
                    ", %d layers" % eng._spec_layers
                    if eng._spec_layers else "", len(out), ntok, wall,
                    ntok / wall, d["spec_dispatches"], d["spec_drafted"],
                    d["spec_accepted"],
                    100 * d["spec_accepted"] / max(1, d["spec_drafted"]),
                    d["spec_emitted"],
                    d["spec_accepted"] / max(1, d["spec_dispatches"]),
                    d["spec_emitted"] / max(1, d["spec_dispatches"]),
                    d["decode_steps_run"], d["spec_draft_steps"],
                    d["prefill_chunks"], launches, smi)
                check(d["spec_dispatches"] > 0 and d["spec_drafted"] > 0,
                      "spec-serve %s %s: no drafted scoring dispatch",
                      set_name, label)
                check(launches == want, "spec-serve %s %s: paged launches "
                      "%d != n_layer x (scoring dispatches + plain steps + "
                      "prefill chunks) + spec_layers x draft steps = %d",
                      set_name, label, launches, want)
                total += launches
                check(len(per) == d["spec_dispatches"]
                      and all(n == N_LAYER for n in per),
                      "spec-serve %s %s: %d scoring dispatches seen (stats "
                      "%d), paged launches inside them %s, not n_layer "
                      "each", set_name, label, len(per),
                      d["spec_dispatches"], sorted(set(per)))
                check(rows == {SPEC_GAMMA + 1: sum(per)},
                      "spec-serve %s %s: paged launches inside scoring "
                      "dispatches by query rows %s, not all at C = %d",
                      set_name, label, rows, SPEC_GAMMA + 1)
                log("spec-serve %s %s: %d paged launches inside its %d "
                    "scoring dispatches (counted around each), all at C = "
                    "%d", set_name, label, sum(per), len(per),
                    SPEC_GAMMA + 1)
                scoring += sum(per)
                for i, ((a, sa), (b, sb)) in enumerate(zip(out, base)):
                    what = "spec-serve %s %s request %d" % (set_name,
                                                            label, i)
                    if _same_or_near_tie(torch, model, reqs[i], a, b, what,
                                         near_ties):
                        check(abs(sa - sb) <= 1e-3 * max(1.0, abs(sb)),
                              "%s: score %r vs %r", what, sa, sb)
            log("spec-serve %s: both drafters' tokens equal the plain "
                "engine's (%d requests; near-ties so far %d) and the plain "
                "engine's equal sequential_generate's (4 requests)",
                set_name, len(reqs), len(near_ties))
        sampled_phase(torch, model, engines, sets["decode-heavy"], base,
                      near_ties)
        timing = _interleaved_serve(torch, engines, sets["decode-heavy"],
                                    "spec-serve decode-heavy", smi)
        log("spec-serve: %d near-tie(s) where a speculative run parted "
            "from the plain one%s", len(near_ties),
            "".join("\n  " + t for t in near_ties))
    finally:
        for eng in engines.values():
            eng.close()
    return total, scoring, timing


def sampled_phase(torch, model, engines, heavy, heavy_greedy, near_ties):
    """16 sampled requests (temperature 0.8, top_k 50, top_p 0.95, seeds
    100-115) with 4 greedy ones among them, 64 new tokens each, through
    the plain engine, the megastep-8 engine (its sampled CUDA graph) and
    the speculative engine: identical tokens (the speculative engine's
    may part at a diagnosed near-tie, appended to ``near_ties``), a
    second pass identical, the greedy requests equal to their all-greedy
    tokens, the sampled
    ones not all greedy (``heavy_greedy``: the set's greedy tokens).
    Then the counter RNG's bits on the card against the CPU's."""
    from paddle_tpu_torch.serving import sampling as SM
    reqs = [(p, 64) for p, _ in heavy[:20]]
    greedy = (3, 8, 13, 18)
    seeds = iter(SAMPLED_SEEDS)
    samp = [None if i in greedy else dict(SAMPLED, seed=next(seeds))
            for i in range(len(reqs))]

    def run(eng):
        hs = [eng.submit(p, m, sampling=sp)
              for (p, m), sp in zip(reqs, samp)]
        return [h.result(timeout=600)[0] for h in hs]
    mega = engines["plain K=%d" % MEGA_SERVE_K]
    outs = {}
    for label in ("plain K=1", "plain K=%d" % MEGA_SERVE_K, "spec-ngram"):
        eng = engines[label]
        before = dict(eng.stats)
        graph = eng._graphs[True]
        replays = graph.replays if graph is not None else 0
        outs[label] = [run(eng), run(eng)]
        d = {k: eng.stats[k] - before[k] for k in eng.stats}
        if graph is not None:
            replays = graph.replays - replays
        log("sampled %s: 2 passes of %d requests (%d sampled); sampled "
            "graph replays %d (all graph replays %d); scoring dispatches %d "
            "(accepted %d)", label, len(reqs), len(SAMPLED_SEEDS), replays,
            d["graph_replays"], d["spec_dispatches"], d["spec_accepted"])
        if eng is mega:
            check(graph is not None and replays > 0,
                  "sampled: the megastep engine replayed no sampled graph")
    ref = outs["plain K=1"][0]
    for label, (a, b) in outs.items():
        for i, (x, y, r) in enumerate(zip(a, b, ref)):
            check(x == y, "sampled %s request %d: the second pass differs",
                  label, i)
            if label.startswith("spec"):
                _same_or_near_tie(torch, model, reqs[i], x, r,
                                  "sampled %s request %d" % (label, i),
                                  near_ties, samp[i])
            else:
                check(x == r, "sampled %s request %d differs from the plain "
                      "engine's at megastep 1", label, i)
    alone = engines["plain K=1"].generate_many(
        [reqs[i][0] for i in greedy], [reqs[i][1] for i in greedy])
    for i, (toks, _) in zip(greedy, alone):
        check(ref[i] == toks, "sampled: greedy request %d differs from its "
              "all-greedy tokens", i)
    drew = sum(ref[i] != heavy_greedy[i][0][:64] for i in range(len(reqs))
               if i not in greedy)
    check(drew > 0, "sampled: every sampled request gave its greedy tokens")
    rng = np.random.default_rng(7)
    seeds = torch.from_numpy(rng.integers(0, 2 ** 32, 1000))
    counts = torch.from_numpy(rng.integers(0, 2 ** 40, 1000))

    def bits(keys):
        seed, count = keys[:, 0], keys[:, 1]
        zero = torch.zeros_like(count)
        words = SM.philox4x32((count & 0xFFFFFFFF, count >> 32, zero, zero),
                              (seed, zero))
        return torch.stack(words, 1).cpu(), SM.uniform(keys).cpu()
    keys = SM.step_keys(seeds, counts)
    (w_cpu, u_cpu), (w_dev, u_dev) = bits(keys), bits(keys.cuda())
    check(torch.equal(w_cpu, w_dev) and torch.equal(u_cpu, u_dev),
          "the counter RNG's bits differ between the CPU and the card")
    log("sampled: tokens equal across plain K=1, K=%d (sampled graph) and "
        "spec-ngram (near-ties in phase 10: %d), and across two passes; "
        "greedy requests equal their all-greedy tokens; %d of %d sampled "
        "requests part from greedy; counter RNG bits (4 Philox words and "
        "the uniform) equal on the CPU and the card for 1000 (seed, "
        "counter) pairs", MEGA_SERVE_K, len(near_ties), drew,
        len(SAMPLED_SEEDS))


def _report_profile(prof, wall, title, focus=None):
    """Device busy share of ``wall`` and the top kernels; with ``focus``,
    also the share of the kernels whose names hold it. Returns (busy
    share or None when the profiler saw no device time, launches of the
    focus kernels in the trace)."""
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    if not rows:
        log("%s: the profiler reported no device time (not measured)",
            title)
        return None, 0
    busy_s = sum(r[0] for r in rows) / 1e6
    log("%s: wall %.3f s, device busy %.3f s = %.1f%% (idle %.1f%%)",
        title, wall, busy_s, 100 * busy_s / wall, 100 - 100 * busy_s / wall)
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        log("  %6.1f%% of device time  %8.3f ms  x%-6d %s",
            100 * dev_us / 1e6 / busy_s, dev_us / 1e3, count, key[:70])
    mine = [r for r in rows if focus and focus in r[2]]
    if focus:
        log("%s: %s %.3f ms in %d launches = %.1f%% of device time",
            title, focus, sum(r[0] for r in mine) / 1e3,
            sum(r[1] for r in mine),
            100 * sum(r[0] for r in mine) / 1e6 / busy_s)
    return busy_s / wall, sum(r[1] for r in mine)


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
        flash_err = flash_kernel_phase(torch)
        flash_times = flash_timing_phase(torch)
        flash_launches = train_phase(torch)
        import paddle_tpu_torch as fluid
        from paddle_tpu_torch.models import resnet as R
        resnet, shapes = _resnet_program(fluid, R)
        mm_err = mm_kernel_phase(torch, shapes)
        mm_times = mm_timing_phase(torch, shapes)
        mm_launches = resnet_phase(torch, resnet, shapes)
        lm_counts, _, _ = mega_train_lm_phase(torch, smi)
        mega_resnet = mega_train_resnet_phase(torch, resnet, smi)
        serve_launches, _, seqs = mega_serve_phase(torch, smi)
        spec_err, spec_times = spec_kernel_phase(torch)
        spec_launches, scoring_launches, _ = spec_serve_phase(torch, smi,
                                                              seqs)
    except SmokeFailure as e:
        print("chip_smoke: FAILED: %s" % e, file=sys.stderr)
        return 1
    flash_src = "paddle_tpu_torch/ops/csrc/flash_attention.cu"
    # launches: the eager main path's and the graph path's (counted
    # through replays), each reset just before its run and read after
    mm_graph = mega_resnet["fused"][0]["matmul_stats"]
    kernels = [dict({
        "name": "paged_attention", "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/paged_attention.py:185",
        "launches": launches + serve_launches + spec_launches,
        "graph_launches": serve_launches, "spec_launches": spec_launches,
        "max_abs_err": max(max_err, spec_err),
        "scoring_shape": dict(spec_times, launches=scoring_launches)},
        **times)]
    for name, line in (("flash_fwd", 68), ("flash_bwd_dq", 163),
                       ("flash_bwd_dkv", 202)):
        kernels.append(dict({
            "name": name, "route": "cuda", "source": flash_src,
            "replaces": "paddle_tpu/ops/flash_attention.py:%d" % line,
            "launches": flash_launches[name] + lm_counts[name],
            "graph_launches": lm_counts[name],
            "max_abs_err": flash_err[name]}, **flash_times[name]))
    kernels.append(dict({
        "name": "matmul_stats", "route": "cuda",
        "source": "paddle_tpu_torch/ops/csrc/matmul_stats.cu",
        "replaces": "paddle_tpu/ops/matmul_stats.py:72",
        "launches": mm_launches + mm_graph, "graph_launches": mm_graph,
        "max_abs_err": mm_err}, **mm_times))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
