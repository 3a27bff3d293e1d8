"""Block-chain paged attention over a shared KV pool.

The counterpart of ``paddle_tpu/ops/paged_attention.py``. Two versions
of one function:

  * ``_attend_cuda`` — the hand-written CUDA kernel
    (``csrc/paged_attention.cu``, built by ``_build``), taken for every
    CUDA tensor. A tensor it cannot take raises; it never falls back.
    Each chain is split across thread blocks (``_splits`` picks how
    many on the host) and the partials are merged in split order.
  * ``_attend_plain`` — plain PyTorch with the semantics of the JAX
    package's ``_attend_lax``: online softmax over the first ``nblk``
    block-table columns. Taken for CPU tensors; ``chip_smoke.py``
    holds the kernel against it on the card.

``_attend_splits_plain`` repeats the kernel's split-and-merge
arithmetic in plain PyTorch, for the tests; nothing on the main path
calls it.

Shapes (the JAX package's layout): ``q`` [S, H, C, dk] pre-scaled by
dk**-0.5; ``pool_k``/``pool_v`` the full [NB, L, H, bs, dk] pool with a
``layer`` index, or one layer's [NB, H, bs, dk] slice with
``layer=None``; ``btab`` [S, NBmax] int32 block table; ``qpos`` [S, C]
int32 — cache positions <= qpos[s, c] attend. Output [S, H, C, dk]
float32. int8 and fp8-e4m3 pools carry ``k_scale``/``v_scale``
([NB, L, H, bs] or [NB, H, bs], f32), one scale per cached vector.
"""

import ctypes
import functools

import torch

from . import _build

__all__ = ["paged_attention", "kv_quant_spec", "quantize_kv",
           "dequantize_kv"]

_NEG_INF = -1e30
_FP8 = torch.float8_e4m3fn
_QMAX = {torch.int8: 127.0, _FP8: 448.0}
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, _FP8: 3}
_MAX_DK = 256
# the .cu's constants: query rows per block tile, cp.async ring stages,
# partial rows merged per block, keys a warp scores per softmax update,
# warps per block, splits of a chain at most
_QT, _NS, _SLOTS, _KG, _NW, _MAX_SPLITS = 16, 3, 16, 4, 4, 64
_SMEM_LIMIT = 232448           # bytes of shared memory a block may use
_TARGET_BLOCKS = 8 * 132       # blocks the split rule aims for: 8 per SM


# --------------------------------------------------------------------------
# KV quantization: codes stored at the pool dtype, one f32 scale per
# cached (block, position, head) vector stored beside the pool.
def kv_quant_spec(kind):
    """(pool dtype, qmax) for a kv-quant mode name, or None for off."""
    if kind in (None, "", "none", "off"):
        return None
    if kind == "int8":
        return torch.int8, 127.0
    if kind == "fp8":
        return _FP8, 448.0
    raise ValueError(
        "unknown kv quantization %r (expected '', 'int8' or 'fp8')"
        % (kind,))


def quantize_kv(x, qdtype):
    """Quantize vectors ``x`` [..., dk] to (codes [..., dk] qdtype,
    scale [...] f32): symmetric per-vector scaling amax/qmax, scale 1
    for all-zero vectors. int8 codes round half to even
    (``torch.round``, as ``jnp.round``); fp8 codes are the e4m3 cast of
    the scaled value, with no rounding to an integer first, as the JAX
    package casts them."""
    qmax = _QMAX[qdtype]
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0.0, amax / qmax, torch.ones_like(amax))
    y = xf / scale[..., None]
    if qdtype == torch.int8:
        return torch.clamp(torch.round(y), -qmax, qmax).to(qdtype), scale
    return y.to(qdtype), scale


def dequantize_kv(codes, scale):
    """codes [..., dk] x scale [...] -> f32 vectors."""
    return codes.to(torch.float32) * scale[..., None].to(torch.float32)


def take_blocks(pool, idx):
    """``pool[idx]``. fp8 codes are indexed through a uint8 view of the
    same bytes: index kernels for fp8 need not exist on every device."""
    if pool.dtype == _FP8:
        return pool.view(torch.uint8)[idx].view(_FP8)
    return pool[idx]


# --------------------------------------------------------------------------
def _attend_plain(q, pool_k, pool_v, btab, qpos, nblk, k_scale, v_scale,
                  block_group=1, layer=None):
    """Plain PyTorch paged attention: ``_attend_lax``'s online softmax
    over ``ceil(nblk / block_group)`` groups of table columns. Rows of
    slots whose chain ``nblk`` does not cover are garbage, as there."""
    s, h, c, dk = q.shape
    bs = pool_k.shape[-2]
    nbmax = btab.shape[1]
    u = max(1, min(int(block_group), nbmax))
    btab = btab.long()
    pad = (-nbmax) % u
    if pad:
        # padded columns read block 0 and are masked by kpos > qpos
        btab = torch.nn.functional.pad(btab, (0, pad))
    if layer is not None:
        # a strided view: selecting the layer copies nothing
        pool_k, pool_v = pool_k[:, layer], pool_v[:, layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[:, layer], v_scale[:, layer]
    qf = q.to(torch.float32)
    qpos_e = qpos.long()[:, None, :, None]            # [S, 1, C, 1]

    def pick(pool, scale, cols):
        blk = take_blocks(pool, cols)                 # [S, u, H, bs, dk]
        if scale is not None:
            blk = dequantize_kv(blk, scale[cols])
        return blk.to(torch.float32).permute(0, 2, 1, 3, 4).reshape(
            s, h, u * bs, dk)

    m = torch.full((s, h, c, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((s, h, c, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((s, h, c, dk), dtype=torch.float32, device=q.device)
    trips = (int(nblk) + u - 1) // u
    for t in range(trips):
        col0 = t * u
        cols = btab[:, col0:col0 + u]
        kb = pick(pool_k, k_scale, cols)
        vb = pick(pool_v, v_scale, cols)
        sc = torch.einsum("shcd,shkd->shck", qf, kb)
        kpos = col0 * bs + torch.arange(u * bs, device=q.device)
        sc = torch.where(kpos[None, None, None, :] <= qpos_e, sc,
                         torch.full_like(sc, _NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("shck,shkd->shcd", p, vb)
        m = m_new
    return acc / torch.clamp_min(l, 1e-30)


def _attend_splits_plain(q, pool_k, pool_v, btab, qpos, nblk, k_scale,
                         v_scale, splits, layer=None):
    """The kernel's split-and-merge arithmetic in plain PyTorch (for the
    tests; nothing on the main path calls it). Per slot and tile of
    ``_QT`` query rows: chain = min(max(qpos of the rows, 0) / bs + 1,
    clamp(nblk, 1, NBmax)) blocks, cut into ``splits`` ranges of
    ceil(chain / splits). In each range every key class (every
    ``_NW``-th key of a block, one per warp, when the tile has at most 4
    rows; else one class) keeps its own (m, l, acc), updated ``_KG``
    keys at a time; the classes merge, then the ranges merge in split
    order. A range past the chain is empty: (-1e30, 0, 0)."""
    s, h, c, dk = q.shape
    bs = pool_k.shape[-2]
    nbmax = btab.shape[1]
    if layer is not None:
        pool_k, pool_v = pool_k[:, layer], pool_v[:, layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[:, layer], v_scale[:, layer]
    cap = min(max(int(nblk), 1), nbmax)
    qf = q.to(torch.float32)
    dev = q.device
    out = torch.empty((s, h, c, dk), dtype=torch.float32, device=dev)

    def block(pool, scale, b):
        blk = take_blocks(pool, b)                    # [H, bs, dk]
        if scale is not None:
            blk = dequantize_kv(blk, scale[b])
        return blk.to(torch.float32)

    def merge(parts):
        mx = parts[0][0]
        for m, _, _ in parts[1:]:
            mx = torch.maximum(mx, m)
        lsum, acc = 0.0, 0.0
        for m, l, a in parts:
            g = torch.exp(m - mx)
            lsum, acc = lsum + l * g, acc + a * g
        return mx, lsum, acc

    for si in range(s):
        for c0 in range(0, c, _QT):
            rows = slice(c0, min(c, c0 + _QT))
            qp = qpos[si, rows].long()                # [R]
            chain = min(int(qp.max().clamp_min(0)) // bs + 1, cap)
            per = -(-chain // splits)
            kstep = _NW if qp.numel() <= 4 else 1
            qs = qf[si, :, rows]                      # [H, R, dk]
            ranges = []
            for sp in range(splits):
                classes = []
                for w in range(kstep):
                    m = torch.full(qs.shape[:2] + (1,), _NEG_INF,
                                   dtype=torch.float32, device=dev)
                    l = torch.zeros_like(m)
                    acc = torch.zeros_like(qs)
                    for b in range(sp * per, min(chain, sp * per + per)):
                        if w >= bs:
                            break
                        phys = int(btab[si, b])
                        kb = block(pool_k, k_scale, phys)
                        vb = block(pool_v, v_scale, phys)
                        keys = torch.arange(w, bs, kstep, device=dev)
                        for g0 in range(0, keys.numel(), _KG):
                            j = keys[g0:g0 + _KG]
                            sc = torch.einsum("hrd,hkd->hrk", qs, kb[:, j])
                            sc = torch.where(
                                (b * bs + j)[None, None, :] <= qp[None, :,
                                                                  None],
                                sc, torch.full_like(sc, _NEG_INF))
                            m_new = torch.maximum(
                                m, sc.amax(dim=-1, keepdim=True))
                            alpha = torch.exp(m - m_new)
                            p = torch.exp(sc - m_new)
                            l = alpha * l + p.sum(dim=-1, keepdim=True)
                            acc = acc * alpha + torch.einsum(
                                "hrk,hkd->hrd", p, vb[:, j])
                            m = m_new
                    classes.append((m, l, acc))
                ranges.append(merge(classes))
            _, lsum, acc = merge(ranges)
            out[si, :, rows] = acc / torch.clamp_min(lsum, 1e-30)
    return out


def _splits(s, h, c, nbmax, bs):
    """Thread blocks each (slot, head, row tile) chain is split across,
    picked on the host from shapes alone: enough blocks for 8 per SM of
    132 (``_TARGET_BLOCKS``), no split shorter than 16 keys, and the
    count rounded so that a chain of NBmax blocks leaves no split empty;
    at most ``_MAX_SPLITS``. 4 at the serving decode shape (S=32, H=8,
    C=1, NBmax 16, bs 16), 16 at a prefill chunk (S=1, C=16)."""
    tiles = s * h * -(-c // _QT)
    want = min(_MAX_SPLITS, -(-_TARGET_BLOCKS // tiles))
    per = max(-(-16 // bs), -(-nbmax // want))
    return -(-nbmax // per)


def _granule(bs, dk, itemsize):
    """Bytes per cp.async copy of one K or V tile (bs x dk codes): 16
    where the tile is a multiple of 16 bytes, else 8 (1-byte codes with
    bs odd and dk = 8 mod 16; dk is a multiple of 8, so every tile is a
    multiple of 8 bytes)."""
    return 16 if bs * dk * itemsize % 16 == 0 else 8


def _smem_bytes(bs, dk, itemsize, quant):
    """Dynamic shared memory of one block, as the .cu's ``Layout``:
    ``_NS`` stages of a K and a V tile (and their scales), or the
    merge's ``_SLOTS`` rows of dk + 2 floats and the split weights
    (``_QT`` rows of ``_MAX_SPLITS`` + 1) if larger."""
    def a16(x):
        return (x + 15) // 16 * 16
    stage = 2 * a16(bs * dk * itemsize) + (2 * a16(4 * bs) if quant
                                             else 0)
    return max(_NS * stage,
               (_SLOTS * (dk + 2) + _QT * (_MAX_SPLITS + 1)) * 4)


def _lib():
    lib = _build.load("paged_attention")
    if lib.ptt_paged_attention.argtypes is None:
        p = ctypes.c_void_p
        lib.ptt_paged_attention.argtypes = [p] * 11 + [
            ctypes.POINTER(ctypes.c_longlong), p]
        lib.ptt_paged_attention.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond, msg, *args):
    if not cond:
        raise ValueError("paged_attention CUDA kernel: " + msg % args)


def _validate(q, pool_k, pool_v, btab, qpos, nblk, k_scale, v_scale,
              layer):
    """Raise ValueError naming the first input the kernel cannot take
    (called when the one-expression check in ``_launch_args`` fails)."""
    s, h, c, dk = q.shape
    dev = q.device
    quant = pool_k.dtype in _QMAX
    tensors = [q, pool_k, pool_v, btab, qpos, nblk]
    if quant:
        _check(k_scale is not None and v_scale is not None,
               "a %s pool needs k_scale and v_scale", pool_k.dtype)
        tensors += [k_scale, v_scale]
    else:
        _check(k_scale is None and v_scale is None,
               "scales are taken only with an int8 or fp8 pool")
    for t in tensors:
        _check(t.device == dev, "every tensor must be on %s, got %s",
               dev, t.device)
        _check(t.is_contiguous(), "every tensor must be contiguous")
    _check(q.dtype == torch.float32, "q must be float32, got %s", q.dtype)
    _check(pool_k.dtype in _KIND and pool_v.dtype == pool_k.dtype,
           "pool must be float32, bfloat16, int8 or float8_e4m3fn, got "
           "%s / %s", pool_k.dtype, pool_v.dtype)
    _check(pool_k.shape == pool_v.shape and pool_k.dim() in (4, 5),
           "K and V pools must be one [NB, (L,) H, bs, dk] shape")
    _check(btab.dtype == torch.int32 and qpos.dtype == torch.int32
           and nblk.dtype == torch.int32 and nblk.numel() == 1,
           "btab, qpos and nblk must be int32 (nblk one element)")
    _check(dk % 8 == 0 and dk <= _MAX_DK,
           "dk must be a multiple of 8 and at most %d, got %d",
           _MAX_DK, dk)
    _check(pool_k.shape[-1] == dk and pool_k.shape[-3] == h,
           "pool [.., H=%d, bs, dk=%d] does not match q [S, H=%d, C, "
           "dk=%d]", pool_k.shape[-3], pool_k.shape[-1], h, dk)
    _check(btab.dim() == 2 and btab.shape[0] == s
           and tuple(qpos.shape) == (s, c),
           "btab [S, NBmax] / qpos [S, C] do not match q's S=%d C=%d",
           s, c)
    _check((pool_k.dim() == 5) == (layer is not None)
           and (layer is None or 0 <= layer < pool_k.shape[1]),
           "layer %r does not fit a pool of %d dims", layer, pool_k.dim())
    if quant:
        _check(k_scale.dtype == torch.float32
               and v_scale.dtype == torch.float32
               and k_scale.shape == pool_k.shape[:-1]
               and v_scale.shape == pool_k.shape[:-1],
               "scales must be float32 shaped like the pool minus dk")
    _check(pool_k.data_ptr() % 16 == 0 and pool_v.data_ptr() % 16 == 0
           and q.data_ptr() % 8 == 0, "pool storage must be 16-byte "
           "aligned and q 8-byte aligned")
    raise ValueError("paged_attention CUDA kernel: inputs not accepted")


@functools.lru_cache(maxsize=None)
def _plan(qshape, pshape, pdtype, nbmax, layer, splits):
    """(the ``dims`` array of ``ptt_paged_attention``, splits) for one
    call shape: the host rules' choices and the strides of contiguous
    pools and scales. Raises where a block would need more shared
    memory than the card gives it."""
    s, h, c, dk = qshape
    bs = pshape[-2]
    quant = pdtype in _QMAX
    smem = _smem_bytes(bs, dk, pdtype.itemsize, quant)
    _check(smem <= _SMEM_LIMIT, "block size %d x dk %d of %s needs %d "
           "bytes of shared memory", bs, dk, pdtype, smem)
    if splits is None:
        splits = _splits(s, h, c, nbmax, bs)
    tile = bs * dk
    if len(pshape) == 5:
        p_str, s_str = (pshape[1] * h * tile, h * tile, tile), \
            (pshape[1] * h * bs, h * bs, bs)
    else:
        p_str, s_str = (h * tile, 0, tile), (h * bs, 0, bs)
    dims = (ctypes.c_longlong * 16)(
        s, h, c, dk, bs, nbmax, layer or 0, splits,
        _granule(bs, dk, pdtype.itemsize), *p_str,
        *(s_str if quant else (0, 0, 0)), _KIND[pdtype])
    return dims, splits


_WORK = {}       # (device index, stream) -> (split scratch, counters)
_RETIRED = []    # outgrown workspaces: a captured graph may still use one


def take_workspace(dev, stream):
    """Remove and return the workspace of device ``dev`` and raw stream
    ``stream`` (None if it has none). A CUDA graph captured on a stream
    of its own takes the workspace its capture allocated in the graph's
    pool and keeps it alive as long as the graph; a warm-up's is
    dropped."""
    return _WORK.pop((torch.device(dev), stream), None)


def _workspace(dev, stream, nfloat, ncount):
    """The split scratch (>= nfloat f32) and arrival counters (>= ncount
    int32, zero between calls) of one device and stream. Calls on one
    stream run in order, so they share one workspace; it grows (never
    shrinks, never frees) as larger shapes come. Under capture the
    allocation lands in the graph's pool and the counters' zero fill is
    part of the graph."""
    key = (dev, stream)
    work = _WORK.get(key)
    if work is None or work[0].numel() < nfloat or work[1].numel() < ncount:
        if work is not None:
            _RETIRED.append(work)
            nfloat = max(nfloat, 2 * work[0].numel())
            ncount = max(ncount, 2 * work[1].numel())
        work = (torch.empty(nfloat, dtype=torch.float32, device=dev),
                torch.zeros(ncount, dtype=torch.int32, device=dev))
        _WORK[key] = work
    return work


def _launch_args(q, pool_k, pool_v, btab, qpos, nblk, k_scale, v_scale,
                 layer, splits):
    """Check every input the kernel cannot take (ValueError naming it),
    allocate ``out``, and return (out, the arguments of
    ``ptt_paged_attention``). ``splits`` None takes the host rule
    ``_splits``; the trials tool passes others. The host's share of a
    call is kept short
    (n_layer calls per serving step): the inputs are checked in one
    expression, ``_validate`` names the fault only when that fails, and
    what follows from the shapes alone is cached (``_plan``)."""
    qshape, pshape, pdt = q.shape, pool_k.shape, pool_k.dtype
    s, h, c, dk = qshape
    d = q.get_device()
    quant = pdt in _QMAX
    if not (q.dtype == torch.float32 and pdt in _KIND
            and pool_v.dtype == pdt and pool_v.shape == pshape
            and len(pshape) == (4 if layer is None else 5)
            and pshape[-1] == dk and pshape[-3] == h and dk % 8 == 0
            and dk <= _MAX_DK and (layer is None or 0 <= layer < pshape[1])
            and btab.dtype == torch.int32 and qpos.dtype == torch.int32
            and nblk.dtype == torch.int32 and nblk.numel() == 1
            and btab.dim() == 2 and btab.shape[0] == s
            and qpos.dim() == 2 and qpos.shape[0] == s
            and qpos.shape[1] == c
            and (k_scale is not None) == quant == (v_scale is not None)
            and pool_k.get_device() == d and pool_v.get_device() == d
            and btab.get_device() == d and qpos.get_device() == d
            and nblk.get_device() == d and q.is_contiguous()
            and pool_k.is_contiguous() and pool_v.is_contiguous()
            and btab.is_contiguous() and qpos.is_contiguous()
            and pool_k.data_ptr() % 16 == 0
            and pool_v.data_ptr() % 16 == 0 and q.data_ptr() % 8 == 0
            and (not quant or (
                k_scale.dtype == torch.float32
                and v_scale.dtype == torch.float32
                and k_scale.shape == pshape[:-1]
                and v_scale.shape == pshape[:-1]
                and k_scale.get_device() == d
                and v_scale.get_device() == d
                and k_scale.is_contiguous()
                and v_scale.is_contiguous()))):
        _validate(q, pool_k, pool_v, btab, qpos, nblk, k_scale, v_scale,
                  layer)
    dims, splits = _plan(qshape, pshape, pdt, btab.shape[1], layer, splits)
    out = torch.empty_like(q)
    stream = torch._C._cuda_getCurrentRawStream(d) if d >= 0 else None
    part = cnt = None
    if splits > 1:
        part, cnt = _workspace(q.device, stream,
                               splits * s * h * c * (dk + 2),
                               s * h * -(-c // _QT))
    return out, (q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                 k_scale.data_ptr() if quant else None,
                 v_scale.data_ptr() if quant else None,
                 btab.data_ptr(), qpos.data_ptr(), nblk.data_ptr(),
                 out.data_ptr(), None if part is None else part.data_ptr(),
                 None if cnt is None else cnt.data_ptr(), dims, stream)


def _attend_cuda(q, pool_k, pool_v, btab, qpos, nblk, k_scale, v_scale,
                 layer=None):
    """Launch the CUDA kernel on the current stream. ``nblk`` is a
    1-element int32 tensor on the card (read there, never synced). One
    call is one launch, counted in ``paged_attention.launches``."""
    out, args = _launch_args(q, pool_k, pool_v, btab, qpos, nblk, k_scale,
                             v_scale, layer, None)
    lib = _lib()
    rc = lib.ptt_paged_attention(*args)
    if rc != 0:
        raise RuntimeError(
            "paged_attention CUDA kernel failed to launch: %s (%d)"
            % (lib.ptt_error_string(rc).decode(), rc))
    paged_attention.launches += 1
    return out


def paged_attention(q, pool_k, pool_v, btab, qpos, nblk=None,
                    k_scale=None, v_scale=None, block_group=1,
                    layer=None):
    """Block-chain paged attention over a shared KV pool (shapes in the
    module docstring). ``nblk`` bounds the walk: the longest live chain
    in the batch (defaults to covering max(qpos)), a Python int or a
    tensor; on the card each slot also stops at its own chain. Rows of
    slots the bound does not cover are garbage the engine never reads.
    ``block_group`` is the plain version's blocks-per-update knob.

    CPU tensors run ``_attend_plain``; CUDA tensors run the kernel or
    raise. ``paged_attention.launches`` counts kernel launches: one per
    call on a CUDA tensor, whether or not the chain is split across
    blocks (the last block of each row tile merges the splits in the
    same launch)."""
    if (pool_k.dim() == 5) != (layer is not None):
        raise ValueError(
            "a [NB, L, H, bs, dk] pool needs layer=<int> and a "
            "per-layer [NB, H, bs, dk] slice needs layer=None; got "
            "pool ndim %d, layer %r" % (pool_k.dim(), layer))
    nbmax = btab.shape[1]
    bs = pool_k.shape[-2]
    if nblk is None:
        nblk = qpos.max() // bs + 1
    if q.device.type == "cpu":
        nblk = min(max(int(nblk), 1), nbmax)
        return _attend_plain(q, pool_k, pool_v, btab, qpos, nblk,
                             k_scale, v_scale, block_group, layer=layer)
    if q.device.type != "cuda":
        raise ValueError("paged_attention runs on CPU or CUDA tensors, "
                         "got %s" % (q.device,))
    if not (isinstance(nblk, torch.Tensor) and nblk.dtype == torch.int32
            and nblk.device == q.device and nblk.dim() == 1):
        nblk = torch.as_tensor(nblk, device=q.device).to(
            torch.int32).reshape(1)
    return _attend_cuda(q, pool_k, pool_v, btab, qpos, nblk, k_scale,
                        v_scale, layer=layer)


paged_attention.launches = 0
