"""KV-cached incremental decode of the flagship decoder-only LM.

The counterpart of ``paddle_tpu/models/transformer_infer.py``, restricted
to ``TransformerLMInfer``: the dense single-row step that
``sequential_generate`` drives, and the paged-pool steps the serving
engine drives (``_step_logits_paged`` for decode and the truncated
drafter, ``_spec_logits_paged`` for speculative scoring,
``_prefill_chunk_paged`` for chunked prefill), all writing through
``_pool_write`` and attending through ``_mha_paged``.

Weights arrive as the parameter stream ``paddle_tpu``'s
``extract_params(program, scope)`` yields, converted to numpy:
``[(role, [ndarray, ...]), ...]`` in the builder's op order. The same
role-checking cursor replays it, so a builder whose op order changes
fails loudly instead of mis-wiring weights. ``init_stream`` makes that
stream from a seed with the builder's own initializers, for runs with
no JAX at hand.

PyTorch runs eagerly, so state dicts are updated IN PLACE (the pools,
the dense caches) where the JAX package returned new arrays.
"""

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..ops import paged_attention as _paged_ops

__all__ = ["TransformerLMInfer", "params_from_stream", "init_stream"]

# every tensor a paged state dict may carry for the KV pool itself: codes
# and, when quantized, the per-vector scales beside them
_POOL_KEYS = ("pool_k", "pool_v", "pool_ks", "pool_vs")
_LAYER_KEYS = ("wq", "wk", "wv", "wo", "ln1_scale", "ln1_bias", "ffn_w1",
               "ffn_b1", "ffn_w2", "ffn_b2", "ln2_scale", "ln2_bias")
_PER_LAYER = 10                    # stream entries one layer consumes


class _Cursor:
    def __init__(self, items):
        self._items = items
        self._i = 0

    def take(self, role):
        if self._i >= len(self._items):
            raise AssertionError("parameter stream exhausted wanting %r"
                                 % role)
        got_role, arrays = self._items[self._i]
        if got_role != role:
            raise AssertionError(
                "parameter stream mismatch at %d: wanted %r got %r — "
                "training builder and inference replayer out of sync"
                % (self._i, role, got_role))
        self._i += 1
        return arrays[0] if len(arrays) == 1 else arrays

    def done(self):
        if self._i != len(self._items):
            raise AssertionError("unconsumed parameters: %d of %d used"
                                 % (self._i, len(self._items)))


def params_from_stream(stream, n_layer=None):
    """Replay a parameter stream into ``{"word_emb", "pos_emb", "w_out",
    "layers": [{wq, wk, wv, wo, ln1_*, ffn_*, ln2_*}, ...]}`` of float32
    numpy arrays. ``n_layer`` defaults to what the stream's length
    implies; the cursor's role checks hold either way."""
    items = [(role, [np.array(a, dtype=np.float32) for a in arrays])
             for role, arrays in stream]
    if n_layer is None:
        n_layer = (len(items) - 3) // _PER_LAYER
    cur = _Cursor(items)
    out = {"word_emb": cur.take("lookup"), "pos_emb": cur.take("lookup"),
           "layers": []}
    for _ in range(n_layer):
        p = {"wq": cur.take("mul"), "wk": cur.take("mul"),
             "wv": cur.take("mul"), "wo": cur.take("mul")}
        p["ln1_scale"], p["ln1_bias"] = cur.take("layer_norm")
        p["ffn_w1"], p["ffn_b1"] = cur.take("mul"), cur.take("bias")
        p["ffn_w2"], p["ffn_b2"] = cur.take("mul"), cur.take("bias")
        p["ln2_scale"], p["ln2_bias"] = cur.take("layer_norm")
        out["layers"].append(p)
    out["w_out"] = cur.take("mul")
    cur.done()
    return out


def _position_encoding(n_position, d_model):
    """Sinusoid position table [n_position, d_model] (the builder's)."""
    pos = np.arange(n_position)[:, None].astype(np.float64)
    dim = np.arange(d_model)[None, :].astype(np.float64)
    angle = pos / np.power(10000, 2 * (dim // 2) / d_model)
    enc = np.zeros((n_position, d_model), np.float32)
    enc[:, 0::2] = np.sin(angle[:, 0::2])
    enc[:, 1::2] = np.cos(angle[:, 1::2])
    return enc


def init_stream(vocab, max_len, n_layer, n_head, d_model, d_inner, seed):
    """A ``transformer_lm`` parameter stream drawn with numpy from
    ``seed``, using the builder's initializers: Normal(0, d_model**-0.5)
    word embeddings, the sinusoid position table, Xavier-uniform ``fc``
    weights, zero biases, layer norms at ones/zeros. (``n_head`` does
    not shape any weight; it is taken for a uniform signature.)"""
    del n_head
    rng = np.random.default_rng(seed)

    def xavier(fan_in, fan_out):
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-lim, lim, (fan_in, fan_out)).astype(
            np.float32)

    def ln():
        return ("layer_norm", [np.ones(d_model, np.float32),
                               np.zeros(d_model, np.float32)])

    out = [("lookup", [rng.normal(0.0, d_model ** -0.5,
                                  (vocab, d_model)).astype(np.float32)]),
           ("lookup", [_position_encoding(max_len, d_model)])]
    for _ in range(n_layer):
        out += [("mul", [xavier(d_model, d_model)]) for _ in range(4)]
        out.append(ln())
        out += [("mul", [xavier(d_model, d_inner)]),
                ("bias", [np.zeros(d_inner, np.float32)]),
                ("mul", [xavier(d_inner, d_model)]),
                ("bias", [np.zeros(d_model, np.float32)])]
        out.append(ln())
    out.append(("mul", [xavier(d_model, vocab)]))
    return out


def _split_heads(x, n_head):
    # [rows, T, H*dk] -> [rows, H, T, dk]
    r, t = x.shape[0], x.shape[1]
    return x.reshape(r, t, n_head, -1).permute(0, 2, 1, 3)


def _ln(x, scale, bias, eps=1e-5):
    # population variance (correction=0), as jnp.var
    xf = x.float() if x.dtype == torch.bfloat16 else x
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    return ((xf - mean) * torch.rsqrt(var + eps) * scale + bias).to(
        x.dtype)


class _Layer(nn.Module):
    """One decoder layer's weights (attention, layer norms, FFN)."""

    def __init__(self, arrays, dtype, device):
        super().__init__()
        for name in _LAYER_KEYS:
            setattr(self, name, nn.Parameter(
                torch.as_tensor(arrays[name]).to(device=device,
                                                 dtype=dtype),
                requires_grad=False))


class TransformerLMInfer(nn.Module):
    """KV-cached incremental decode for ``transformer_lm`` weights.

    ``dtype`` is float32 (default) or bfloat16: bf16 casts weights and
    KV caches, with scores, softmax and layer-norm statistics in f32.
    ``device`` defaults to the CUDA card (raising without one)."""

    def __init__(self, params, n_layer, n_head, d_model, max_len,
                 bos_id=1, end_id=2, dtype=None, device=None):
        super().__init__()
        dtype = torch.float32 if dtype is None else dtype
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("infer dtype must be bfloat16 or float32; "
                             "got %r" % (dtype,))
        dev = resolve_device(device)
        if len(params["layers"]) != n_layer:
            raise ValueError("params hold %d layers, n_layer is %d"
                             % (len(params["layers"]), n_layer))
        self.n_layer, self.n_head = n_layer, n_head
        self.d_model, self.max_len = d_model, max_len
        self.bos_id, self.end_id = bos_id, end_id

        def param(a):
            return nn.Parameter(torch.as_tensor(a).to(device=dev,
                                                      dtype=dtype),
                                requires_grad=False)

        self.word_emb = param(params["word_emb"])
        self.pos_emb = param(params["pos_emb"])
        self.layers = nn.ModuleList(
            _Layer(p, dtype, dev) for p in params["layers"])
        self.w_out = param(params["w_out"])

    @classmethod
    def from_stream(cls, stream, n_layer, n_head, d_model, max_len,
                    bos_id=1, end_id=2, dtype=None, device=None):
        """Build from a parameter stream (``params_from_stream``)."""
        return cls(params_from_stream(stream, n_layer), n_layer, n_head,
                   d_model, max_len, bos_id=bos_id, end_id=end_id,
                   dtype=dtype, device=device)

    @property
    def device(self):
        return self.word_emb.device

    @property
    def dtype(self):
        return self.word_emb.dtype

    # ------------------------------------------------------------------
    def _embed(self, tok, pos):
        return self.word_emb[tok] * (self.d_model ** 0.5) \
            + self.pos_emb[pos]

    def _bias(self, qpos):
        """Additive causal bias: 0 where key position <= ``qpos``, -1e9
        elsewhere; ``qpos`` [..., Tq] -> [..., Tq, max_len]."""
        ar = torch.arange(self.max_len, device=qpos.device)
        return torch.where(ar <= qpos[..., None], 0.0, -1e9)

    def _mha(self, p, q_in, kv_k, kv_v, bias):
        """q_in [rows, Tq, D]; kv_k/v [rows, H, Tk, dk]; bias
        broadcastable to [rows, H, Tq, Tk]."""
        q = _split_heads(q_in @ p.wq, self.n_head)
        dk = q.shape[-1]
        s = torch.einsum("rhqd,rhkd->rhqk", (q * (dk ** -0.5)).float(),
                         kv_k.float())
        if bias is not None:
            s = s + bias
        w = torch.softmax(s, dim=-1).to(kv_v.dtype)
        o = torch.einsum("rhqk,rhkd->rhqd", w, kv_v)
        r, t = q_in.shape[0], q_in.shape[1]
        return o.permute(0, 2, 1, 3).reshape(r, t, -1) @ p.wo

    def _kv(self, p, x):
        h = self.n_head
        return _split_heads(x @ p.wk, h), _split_heads(x @ p.wv, h)

    def _ffn(self, p, x):
        hdn = torch.relu(x @ p.ffn_w1 + p.ffn_b1)
        return hdn @ p.ffn_w2 + p.ffn_b2

    def _block_tail(self, p, x, a):
        x = _ln(x + a, p.ln1_scale, p.ln1_bias)
        return _ln(x + self._ffn(p, x), p.ln2_scale, p.ln2_bias)

    # -- dense cache (sequential baseline) -----------------------------
    def _init_state(self, rows):
        dk = self.d_model // self.n_head
        shape = (rows, self.n_head, self.max_len, dk)
        return {("k%d" % i if half == 0 else "v%d" % i):
                torch.zeros(shape, dtype=self.dtype, device=self.device)
                for i in range(self.n_layer) for half in (0, 1)}

    def _step_logits(self, tok, state, t):
        """One incremental step: tok [rows] int64 -> (logits [rows, V],
        state with this token's K/V written at cache slot ``t``)."""
        x = self._embed(tok, t)[:, None, :]
        bias = self._bias(torch.tensor(t, device=self.device))
        for i, p in enumerate(self.layers):
            k_new, v_new = self._kv(p, x)
            k, v = state["k%d" % i], state["v%d" % i]
            k[:, :, t] = k_new[:, :, 0]
            v[:, :, t] = v_new[:, :, 0]
            x = self._block_tail(p, x, self._mha(p, x, k, v, bias))
        return x[:, 0, :] @ self.w_out, state

    # -- paged KV pool (serving.kvpool block pool) ---------------------
    def _init_paged_state(self, num_blocks, block_size, kv_quant=None):
        """Shared paged KV pool ``[num_blocks + 1, n_layer, n_head,
        block_size, dk]`` for K and V. Block ``num_blocks`` is the trash
        block: masked writes land there (the JAX package's drop-mode
        index, given a block to drop into), and no block table names it.
        Unassigned block-table entries read block 0, which the causal
        predicate masks. ``kv_quant`` ('int8' or 'fp8') stores codes plus
        one f32 scale per cached vector (``pool_ks``/``pool_vs``),
        initialized to 1 so block 0's zero codes dequantize to exact
        zeros."""
        dk = self.d_model // self.n_head
        shape = (int(num_blocks) + 1, self.n_layer, self.n_head,
                 int(block_size), dk)
        dev = self.device
        spec = _paged_ops.kv_quant_spec(kv_quant)
        if spec is None:
            return {"pool_k": torch.zeros(shape, dtype=self.dtype,
                                          device=dev),
                    "pool_v": torch.zeros(shape, dtype=self.dtype,
                                          device=dev)}
        qdtype, _ = spec
        # zero bytes are zero codes in int8 and in fp8 e4m3
        return {"pool_k": torch.zeros(shape, dtype=torch.uint8,
                                      device=dev).view(qdtype),
                "pool_v": torch.zeros(shape, dtype=torch.uint8,
                                      device=dev).view(qdtype),
                "pool_ks": torch.ones(shape[:-1], dtype=torch.float32,
                                      device=dev),
                "pool_vs": torch.ones(shape[:-1], dtype=torch.float32,
                                      device=dev)}

    @staticmethod
    def _write_index(wphys, off):
        """The pool entries a call writes, as ``(rows, cols, phys,
        off)`` over every entry of [S, C] ``wphys``/``off``. Masked
        entries point at the trash block (``_init_paged_state``), so
        the write needs no host read to drop them and leaves every
        other block's bytes as they were."""
        s, c = wphys.shape
        rows = torch.arange(s, device=wphys.device)[:, None].expand(
            s, c).reshape(-1)
        cols = torch.arange(c, device=wphys.device)[None, :].expand(
            s, c).reshape(-1)
        return rows, cols, wphys.reshape(-1), off.reshape(-1)

    def _pool_write(self, pools, i, widx, k_new, v_new):
        """Write layer ``i``'s new K/V vectors ``k_new``/``v_new``
        [S, H, C, dk] into the pool IN PLACE at the entries of ``widx``
        (``_write_index``, or the prefill's valid entries): vector (s,
        c) lands at ``(phys, i, :, off)``. Quantized pools store codes +
        per-vector scales."""
        rows, cols, phys, off = widx
        for name, sname, val in (("pool_k", "pool_ks", k_new),
                                 ("pool_v", "pool_vs", v_new)):
            vec = val.permute(0, 2, 1, 3)[rows, cols]    # [N, H, dk]
            pool = pools[name][:, i]                     # [NB, H, bs, dk]
            if sname in pools:
                codes, scale = _paged_ops.quantize_kv(vec, pool.dtype)
                # 1-byte codes written through a uint8 view of the same
                # bytes: index_put need not exist for fp8 on every device
                pool.view(torch.uint8)[phys, :, off, :] = codes.view(
                    torch.uint8)
                pools[sname][:, i][phys, :, off] = scale
            else:
                pool[phys, :, off, :] = vec.to(pool.dtype)
        return pools

    def _pool_gather(self, pools, i, btab):
        """The dense block-table gather (the ``block_kernel=False``
        path): layer ``i``'s K/V for every table row in position order,
        sliced to the dense ``[S, H, max_len, dk]`` axis. ``btab``
        [S, max_blocks] (or one [max_blocks] row)."""
        bt = btab if btab.dim() == 2 else btab[None]
        s = bt.shape[0]
        dk = self.d_model // self.n_head
        out = []
        for name, sname in (("pool_k", "pool_ks"), ("pool_v", "pool_vs")):
            g = _paged_ops.take_blocks(pools[name][:, i], bt)
            # g: [S, NB, H, bs, dk]
            if sname in pools:
                g = _paged_ops.dequantize_kv(g, pools[sname][:, i][bt])
            out.append(g.permute(0, 2, 1, 3, 4).reshape(
                s, self.n_head, -1, dk)[:, :, :self.max_len])
        return out

    def _mha_paged(self, p, q_in, pools, i, btab, qpos, nblk, bias,
                   block_kernel, attn_unroll=1):
        """Paged-pool attention + output projection for queries
        ``q_in`` [S, C, D]. ``block_kernel=False`` gathers the dense
        axis and runs ``_mha``; ``True`` runs ``ops.paged_attention``
        over the full 5-D pool at layer ``i``: keys at cache positions
        ``<= qpos[s, c]``, walking at most ``nblk`` table columns.
        ``btab``/``qpos`` are int32 here (the kernel's index type)."""
        if not block_kernel:
            k, v = self._pool_gather(pools, i, btab)
            return self._mha(p, q_in, k, v, bias)
        q = _split_heads(q_in @ p.wq, self.n_head)
        dk = q.shape[-1]
        bt = btab if btab.dim() == 2 else btab[None]
        o = _paged_ops.paged_attention(
            (q * (dk ** -0.5)).float().contiguous(),
            pools["pool_k"], pools["pool_v"], bt, qpos, nblk=nblk,
            k_scale=pools.get("pool_ks"), v_scale=pools.get("pool_vs"),
            block_group=attn_unroll, layer=i)
        o = o.to(q_in.dtype)
        r, t = q_in.shape[0], q_in.shape[1]
        return o.permute(0, 2, 1, 3).reshape(r, t, -1) @ p.wo

    @staticmethod
    def _pool_slice(state):
        """The pool entries of a paged state dict (codes + scales)."""
        return {n: state[n] for n in _POOL_KEYS if n in state}

    def _step_logits_paged(self, tok, state, pos, btab, write_mask=None,
                           n_layers=None, block_kernel=False,
                           attn_unroll=1):
        """Per-slot decode step over the paged pool: tok/pos [S] int64,
        ``btab`` [S, max_blocks] int32 block tables, ``write_mask`` [S]
        bool gating the pool writes (idle and prefilling slots must not
        write: theirs go to the trash block, the pool's last). Returns
        (logits [S, V], state) with the pool updated in place. It is the
        C = 1 case of ``_spec_logits_paged`` (no drafts), so nothing is
        read back to the host and a CUDA graph can hold the step.
        ``n_layers`` runs only the first n layers: the truncated
        speculative drafter, whose K/V writes land only at layer rows
        the full-depth scoring dispatch rewrites."""
        logits, state = self._spec_logits_paged(
            tok[:, None], state, pos, btab, torch.zeros_like(pos),
            write_mask, n_layers, block_kernel, attn_unroll)
        return logits[:, 0], state

    def _spec_logits_paged(self, toks, state, pos, btab, n_valid,
                           write_mask=None, n_layers=None,
                           block_kernel=False, attn_unroll=1):
        """Speculative scoring: logits at all ``C = gamma + 1`` positions
        of every slot in one dispatch. ``toks`` [S, C] int64 holds each
        slot's current token and its drafted tokens; position j is
        written and read at cache position ``pos[s] + j`` through the
        slot's block-table row, and the logits at j are what the j-th
        single step of ``_step_logits_paged`` would give after
        ``toks[s, :j+1]``. ``n_valid`` [S] counts each slot's valid
        drafts: positions ``j > n_valid[s]``, and every position of a
        ``write_mask``-False slot, write into the trash block, and
        their logits are garbage the acceptance never reads. The
        causal bound masks cache positions past each query, so a
        rejected draft's stale K/V is never read before the dispatch
        that rewrites it. The walk bound stays on the device, so
        nothing is read back to the host. ``n_layers`` runs only the
        first n layers (``_step_logits_paged``'s). Returns (logits
        [S, C, V], state) with the pool updated in place; on the card
        the paged kernel scores all C rows in one launch per layer."""
        trash, bs = state["pool_k"].shape[0] - 1, state["pool_k"].shape[3]
        nbmax = btab.shape[1]
        btab = btab.to(torch.int32)
        c = toks.shape[1]
        cpos = pos[:, None] + torch.arange(c, device=pos.device)[None]
        qpos_l = torch.clamp(cpos, max=self.max_len - 1)     # [S, C]
        x = self._embed(toks, qpos_l)                    # [S, C, D]
        bias = self._bias(cpos)[:, None]                 # [S, 1, C, L]
        blk = torch.clamp(cpos // bs, max=nbmax - 1)
        off = cpos % bs
        phys = btab.gather(1, blk).long()                # [S, C]
        valid = torch.arange(c, device=pos.device)[None] \
            <= n_valid[:, None]
        if write_mask is not None:
            valid = valid & write_mask[:, None]
        widx = self._write_index(torch.where(valid, phys, trash), off)
        qpos = qpos_l.to(torch.int32)
        live = pos if write_mask is None else \
            torch.where(write_mask, pos, 0)
        nblk = torch.clamp((live + c - 1).max() // bs + 1,
                           max=nbmax).to(torch.int32).reshape(1)
        pools = self._pool_slice(state)
        layers = self.layers if n_layers is None \
            else self.layers[:n_layers]
        for i, p in enumerate(layers):
            k_new, v_new = self._kv(p, x)                # [S, H, C, dk]
            self._pool_write(pools, i, widx, k_new, v_new)
            a = self._mha_paged(p, x, pools, i, btab, qpos, nblk, bias,
                                block_kernel, attn_unroll)
            x = self._block_tail(p, x, a)
        return x @ self.w_out, state                     # [S, C, V]

    def _prefill_chunk_paged(self, state, toks, start, n_valid,
                             btab_row, block_kernel=False,
                             attn_unroll=1):
        """Teacher-forced chunk prefill into the paged pool for ONE
        slot: ``toks`` [C] int64 (a fixed-length chunk whose first
        ``n_valid`` entries are real), written at cache positions
        ``start..start+n_valid-1`` through the slot's block table
        ``btab_row`` [max_blocks]. ``start``/``n_valid`` are host ints,
        so the write index and the walk bound need no device sync. No
        logits are computed. Returns the state (pool updated in
        place)."""
        bs = state["pool_k"].shape[3]
        nbmax = btab_row.shape[0]
        dev = self.device
        c = toks.shape[0]
        idx = torch.arange(c, device=dev)
        cpos = start + idx                               # [C]
        valid = idx < n_valid
        gather_pos = torch.where(
            valid, torch.clamp(cpos, max=self.max_len - 1), 0)
        x = self._embed(toks, gather_pos)[None]          # [1, C, D]
        bias = self._bias(cpos)[None, None]              # [1, 1, C, L]
        bt = btab_row.to(torch.int32)
        blk = torch.clamp(cpos // bs, max=nbmax - 1)
        off = cpos % bs
        n = int(n_valid)
        widx = (torch.zeros(n, dtype=torch.long, device=dev), idx[:n],
                bt[blk[:n]].long(), off[:n])
        qpos = torch.clamp(cpos, max=self.max_len - 1)[None].to(
            torch.int32)                                 # [1, C]
        nblk = torch.tensor(
            [min((start + max(n, 1) - 1) // bs + 1, nbmax)],
            dtype=torch.int32, device=dev)
        pools = self._pool_slice(state)
        for i, p in enumerate(self.layers):
            k_new, v_new = self._kv(p, x)                # [1, H, C, dk]
            self._pool_write(pools, i, widx, k_new, v_new)
            a = self._mha_paged(p, x, pools, i, bt, qpos, nblk, bias,
                                block_kernel, attn_unroll)
            x = self._block_tail(p, x, a)
        return state
