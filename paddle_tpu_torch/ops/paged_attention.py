"""Block-chain paged attention over a shared KV pool.

The counterpart of ``paddle_tpu/ops/paged_attention.py``. Two versions
of one function:

  * ``_attend_cuda`` — the hand-written CUDA kernel
    (``csrc/paged_attention.cu``, built by ``_build``), taken for every
    CUDA tensor. A tensor it cannot take raises; it never falls back.
  * ``_attend_plain`` — plain PyTorch with the semantics of the JAX
    package's ``_attend_lax``: online softmax over the first ``nblk``
    block-table columns. Taken for CPU tensors; ``chip_smoke.py``
    holds the kernel against it on the card.

Shapes (the JAX package's layout): ``q`` [S, H, C, dk] pre-scaled by
dk**-0.5; ``pool_k``/``pool_v`` the full [NB, L, H, bs, dk] pool with a
``layer`` index, or one layer's [NB, H, bs, dk] slice with
``layer=None``; ``btab`` [S, NBmax] int32 block table; ``qpos`` [S, C]
int32 — cache positions <= qpos[s, c] attend. Output [S, H, C, dk]
float32. int8 pools carry ``k_scale``/``v_scale`` ([NB, L, H, bs] or
[NB, H, bs], f32), one scale per cached vector.
"""

import ctypes

import torch

from . import _build

__all__ = ["paged_attention", "kv_quant_spec", "quantize_kv",
           "dequantize_kv"]

_NEG_INF = -1e30
_QMAX = {torch.int8: 127.0}
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_DK = 256
_QT = 16                       # query rows per thread block (the .cu)
_SMEM_LIMIT = 232448           # bytes of shared memory a block may use


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
        raise ValueError(
            "serving_kv_quant='fp8' is not ported yet (ROADMAP.md, "
            "queue 2: fp8 e4m3 KV); use 'int8'")
    raise ValueError(
        "unknown kv quantization %r (expected '' or 'int8')" % (kind,))


def quantize_kv(x, qdtype):
    """Quantize vectors ``x`` [..., dk] to (codes [..., dk] qdtype,
    scale [...] f32): symmetric per-vector scaling amax/qmax, scale 1
    for all-zero vectors. ``torch.round`` rounds half to even, as
    ``jnp.round`` does, so codes match the JAX package's."""
    qmax = _QMAX[qdtype]
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0.0, amax / qmax, torch.ones_like(amax))
    y = xf / scale[..., None]
    codes = torch.clamp(torch.round(y), -qmax, qmax).to(qdtype)
    return codes, scale


def dequantize_kv(codes, scale):
    """codes [..., dk] x scale [...] -> f32 vectors."""
    return codes.to(torch.float32) * scale[..., None].to(torch.float32)


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
        blk = pool[cols]                              # [S, u, H, bs, dk]
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


def _lib():
    lib = _build.load("paged_attention")
    if lib.ptt_paged_attention.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ptt_paged_attention.argtypes = [p] * 9 + [i] * 14 + [i, p]
        lib.ptt_paged_attention.restype = i
        lib.ptt_error_string.argtypes = [i]
        lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond, msg, *args):
    if not cond:
        raise ValueError("paged_attention CUDA kernel: " + msg % args)


def _attend_cuda(q, pool_k, pool_v, btab, qpos, nblk, k_scale, v_scale,
                 layer=None):
    """Launch the CUDA kernel on the current stream. ``nblk`` is a
    1-element int32 tensor on the card (read there, never synced)."""
    s, h, c, dk = q.shape
    dev = q.device
    pool5 = pool_k.dim() == 5
    quant = pool_k.dtype == torch.int8
    tensors = [q, pool_k, pool_v, btab, qpos, nblk]
    if quant:
        _check(k_scale is not None and v_scale is not None,
               "an int8 pool needs k_scale and v_scale")
        tensors += [k_scale, v_scale]
    else:
        _check(k_scale is None and v_scale is None,
               "scales are taken only with an int8 pool")
    for t in tensors:
        _check(t.device == dev, "every tensor must be on %s, got %s",
               dev, t.device)
        _check(t.is_contiguous(), "every tensor must be contiguous")
    _check(q.dtype == torch.float32, "q must be float32, got %s", q.dtype)
    _check(pool_k.dtype in _KIND and pool_v.dtype == pool_k.dtype,
           "pool must be float32, bfloat16 or int8, got %s / %s",
           pool_k.dtype, pool_v.dtype)
    _check(pool_k.shape == pool_v.shape, "K and V pools differ in shape")
    _check(btab.dtype == torch.int32 and qpos.dtype == torch.int32
           and nblk.dtype == torch.int32 and nblk.numel() == 1,
           "btab, qpos and nblk must be int32 (nblk one element)")
    _check(dk % 8 == 0 and dk <= _MAX_DK,
           "dk must be a multiple of 8 and at most %d, got %d",
           _MAX_DK, dk)
    bs = pool_k.shape[-2]
    nbmax = btab.shape[1]
    n_head = pool_k.shape[2] if pool5 else pool_k.shape[1]
    _check(pool_k.shape[-1] == dk and n_head == h,
           "pool [.., H=%d, bs, dk=%d] does not match q [S, H=%d, C, "
           "dk=%d]", n_head, pool_k.shape[-1], h, dk)
    _check(btab.shape[0] == s and tuple(qpos.shape) == (s, c),
           "btab [S, NBmax] / qpos [S, C] do not match q's S=%d C=%d",
           s, c)
    if pool5:
        _check(0 <= layer < pool_k.shape[1], "layer %r out of range",
               layer)
    smem = 4 * (bs * (dk + 1) + bs * dk + _QT * dk + _QT * bs + 4 * _QT)
    _check(smem <= _SMEM_LIMIT, "block size %d x dk %d needs %d bytes "
           "of shared memory", bs, dk, smem)
    for t in (pool_k, pool_v):
        _check(t.data_ptr() % 16 == 0, "pool storage must be 16-byte "
               "aligned")
    ps = pool_k.stride()
    if pool5:
        p_sb, p_sl, p_sh, p_sp = ps[0], ps[1], ps[2], ps[3]
    else:
        p_sb, p_sl, p_sh, p_sp = ps[0], 0, ps[1], ps[2]
    s_sb = s_sl = s_sh = 0
    if quant:
        _check(k_scale.dtype == torch.float32
               and v_scale.dtype == torch.float32
               and tuple(k_scale.shape) == tuple(pool_k.shape[:-1])
               and tuple(v_scale.shape) == tuple(pool_k.shape[:-1]),
               "scales must be float32 shaped like the pool minus dk")
        ss = k_scale.stride()
        s_sb, s_sl, s_sh = (ss[0], ss[1], ss[2]) if pool5 else \
            (ss[0], 0, ss[1])
    _check(max(p_sb, s_sb) < 2 ** 31, "pool strides must fit in 32 bits")
    out = torch.empty((s, h, c, dk), dtype=torch.float32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ptt_paged_attention(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        btab.data_ptr(), qpos.data_ptr(), nblk.data_ptr(), out.data_ptr(),
        s, h, c, dk, bs, nbmax, 0 if layer is None else int(layer),
        p_sb, p_sl, p_sh, p_sp, s_sb, s_sl, s_sh, _KIND[pool_k.dtype],
        stream)
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
    raise. ``paged_attention.launches`` counts kernel launches."""
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
    nblk = torch.as_tensor(nblk, device=q.device).to(
        torch.int32).reshape(1)
    return _attend_cuda(q, pool_k, pool_v, btab, qpos, nblk, k_scale,
                        v_scale, layer=layer)


paged_attention.launches = 0
