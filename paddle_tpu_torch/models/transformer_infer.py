"""KV-cached incremental decode: the MT decoder and the flagship LM.

The counterpart of ``paddle_tpu/models/transformer_infer.py``:

* ``TransformerInfer`` replays ``models.transformer.transformer`` (the
  encoder-decoder MT model): ``encode``, the beam-tiled cross K/V of
  ``_init_decode_state``, the dense per-row step ``_step_logits`` and the
  whole decodes ``translate`` (beam search) and ``translate_greedy``. Its
  attention is the plain ``_mha``, no kernel, as in the JAX package.
* ``TransformerLMInfer`` replays ``transformer_lm``: the dense single-row
  step that ``sequential_generate`` and ``generate`` drive, the dense
  per-slot steps of the engine's ``paged=False`` layout
  (``_step_logits_slots``, ``_prefill_chunk_slot``), and the paged-pool
  steps the serving engine drives by default (``_step_logits_paged`` for
  decode and the truncated drafter, ``_spec_logits_paged`` for
  speculative scoring, ``_prefill_chunk_paged`` for chunked prefill), all
  writing through ``_pool_write`` and attending through ``_mha_paged``.

A whole decode (``translate``, ``translate_greedy``, ``generate``) runs
``models/decoding``'s loops: eagerly on the CPU, and on the card as one
CUDA graph per shape (``core/graphs.StepGraph``) holding all its steps,
the encoder, the top-k, the cache reorder and the backtrack, captured at
the first call and replayed after (``_decode``).

Weights arrive as a parameter stream ``[(role, [ndarray, ...]), ...]``
in the builder's op order: ``extract_params(program, scope)`` walks a
trained Program and its scope (``from_program``), and ``init_stream``
draws an LM's from a seed with the builder's own initializers. A
role-checking cursor replays it, so a builder whose op order changes
fails loudly instead of mis-wiring weights.

PyTorch runs eagerly, so state dicts are updated IN PLACE (the pools,
the dense caches) where the JAX package returned new arrays.
"""

import numpy as np
import torch
from torch import nn

from . import decoding
from .. import resolve_device
from ..core.graphs import StepGraph
from ..ops import paged_attention as _paged_ops

__all__ = ["TransformerInfer", "TransformerLMInfer", "extract_params",
           "params_from_stream", "mt_params_from_stream", "init_stream"]

# every tensor a paged state dict may carry for the KV pool itself: codes
# and, when quantized, the per-vector scales beside them
_POOL_KEYS = ("pool_k", "pool_v", "pool_ks", "pool_vs")
_PER_LAYER = 10                    # stream entries one layer consumes

# op type -> (stream role, input slot holding the parameter)
_PARAM_OPS = {
    "lookup_table": ("lookup", "W"),
    "mul": ("mul", "Y"),
    "matmul": ("mul", "Y"),
    "elementwise_add": ("bias", "Y"),
    "layer_norm": ("layer_norm", None),
}


def _numpy(value):
    """A scope value as a numpy array; bfloat16 widens to float32
    exactly (numpy has no bfloat16)."""
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.detach().cpu().numpy()
    return np.asarray(value)


def extract_params(program, scope):
    """Walk the program's ops in order and return ``[(role, [ndarray,
    ...]), ...]`` for every op that consumes a persistable parameter:
    the bridge from the Program IR to the decode model. A
    ``fused_matmul_bias_act`` op (a specialized artifact of the JAX
    package) gives its "mul" and "bias" roles at the stream position the
    unfused chain gives them, so a fused artifact replays into the same
    stream. A ``cast`` of a persistable (a ``bf16=True`` artifact casts
    each weight before the op that reads it) stands for that persistable
    here; the JAX package's ``extract_params`` stops at the cast, so its
    engine does not boot such an LM artifact."""
    gb = program.global_block()
    persistable = {v.name: v.name for v in gb.vars.values()
                   if v.persistable}
    for op in gb.ops:
        if op.type == "cast" and op.input("X")[0] in persistable:
            persistable[op.output("Out")[0]] = op.input("X")[0]

    def take(names):
        return _numpy(scope.find_var(persistable.get(names[0], names[0])))

    out = []
    for op in gb.ops:
        if op.type == "fused_matmul_bias_act":
            for role, names in (("mul", op.input("Y")),
                                ("bias", op.input("Bias"))):
                if names and names[0] in persistable:
                    out.append((role, [take(names)]))
            continue
        if op.type not in _PARAM_OPS:
            continue
        role, slot = _PARAM_OPS[op.type]
        if role == "layer_norm":
            out.append((role, [take(op.input("Scale")),
                               take(op.input("Bias"))]))
            continue
        names = op.input(slot)
        if names and names[0] in persistable:  # not residual adds etc.
            out.append((role, [take(names)]))
    return out


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


def _take_mha(cur):
    return {"wq": cur.take("mul"), "wk": cur.take("mul"),
            "wv": cur.take("mul"), "wo": cur.take("mul")}


def _take_attn_ffn(cur):
    """An LM layer's (or an MT encoder layer's) stream: the attention's
    four matmuls, a layer norm, the FFN, a layer norm."""
    p = _take_mha(cur)
    p["ln1_scale"], p["ln1_bias"] = cur.take("layer_norm")
    p["ffn_w1"], p["ffn_b1"] = cur.take("mul"), cur.take("bias")
    p["ffn_w2"], p["ffn_b2"] = cur.take("mul"), cur.take("bias")
    p["ln2_scale"], p["ln2_bias"] = cur.take("layer_norm")
    return p


def _take_dec_layer(cur):
    """An MT decoder layer's stream: self-attention, a layer norm,
    cross-attention, a layer norm, the FFN, a layer norm."""
    p = {"self_attn": _take_mha(cur)}
    p["ln1_scale"], p["ln1_bias"] = cur.take("layer_norm")
    p["cross"] = _take_mha(cur)
    p["ln2_scale"], p["ln2_bias"] = cur.take("layer_norm")
    p["ffn_w1"], p["ffn_b1"] = cur.take("mul"), cur.take("bias")
    p["ffn_w2"], p["ffn_b2"] = cur.take("mul"), cur.take("bias")
    p["ln3_scale"], p["ln3_bias"] = cur.take("layer_norm")
    return p


def _cursor(stream):
    return _Cursor([(role, [np.array(a, dtype=np.float32) for a in arrays])
                    for role, arrays in stream])


def params_from_stream(stream, n_layer=None):
    """Replay a ``transformer_lm`` parameter stream into ``{"word_emb",
    "pos_emb", "w_out", "layers": [{wq, wk, wv, wo, ln1_*, ffn_*, ln2_*},
    ...]}`` of float32 numpy arrays. ``n_layer`` defaults to what the
    stream's length implies; the cursor's role checks hold either way."""
    if n_layer is None:
        n_layer = (len(stream) - 3) // _PER_LAYER
    cur = _cursor(stream)
    out = {"word_emb": cur.take("lookup"), "pos_emb": cur.take("lookup")}
    out["layers"] = [_take_attn_ffn(cur) for _ in range(n_layer)]
    out["w_out"] = cur.take("mul")
    cur.done()
    return out


def mt_params_from_stream(stream, n_layer):
    """Replay a ``transformer`` (MT) parameter stream in the builder's
    order: the source embeddings, ``n_layer`` encoder layers, the target
    embeddings, ``n_layer`` decoder layers, the output projection."""
    cur = _cursor(stream)
    out = {"src_word_emb": cur.take("lookup"),
           "src_pos_emb": cur.take("lookup")}
    out["enc_layers"] = [_take_attn_ffn(cur) for _ in range(n_layer)]
    out["trg_word_emb"] = cur.take("lookup")
    out["trg_pos_emb"] = cur.take("lookup")
    out["dec_layers"] = [_take_dec_layer(cur) for _ in range(n_layer)]
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
    """One layer's weights: each array of ``arrays`` a frozen parameter,
    each dict a sub-layer (an MT decoder layer's two attentions)."""

    def __init__(self, arrays, dtype, device):
        super().__init__()
        for name, a in arrays.items():
            setattr(self, name, _Layer(a, dtype, device)
                    if isinstance(a, dict) else _param(a, dtype, device))


def _param(a, dtype, device):
    return nn.Parameter(torch.as_tensor(a).to(device=device, dtype=dtype),
                        requires_grad=False)


def _infer_dtype(dtype):
    dtype = torch.float32 if dtype is None else dtype
    if dtype not in (torch.float32, torch.bfloat16):
        # _ln's f32 statistics and the f32 scores are built for bf16;
        # fp16's 5-bit exponent would degrade the LN statistics
        raise ValueError("infer dtype must be bfloat16 or float32; got %r"
                         % (dtype,))
    return dtype


class _Decoder(nn.Module):
    """What the two decode models share: the attention, FFN and cache
    helpers, the output-length check and the decode graphs."""

    def __init__(self, n_layer, n_head, d_model, max_len, bos_id, end_id):
        super().__init__()
        self.n_layer, self.n_head = n_layer, n_head
        self.d_model, self.max_len = d_model, max_len
        self.bos_id, self.end_id = bos_id, end_id
        self._decode_graphs = {}

    @property
    def device(self):
        return self.w_out.device

    @property
    def dtype(self):
        return self.w_out.dtype

    def _causal(self, t):
        """Self-attention bias of the dense step at host position ``t``:
        0 on cache positions <= t, -1e9 after; [max_len]."""
        ar = torch.arange(self.max_len, device=self.device)
        return torch.where(ar <= t, 0.0, -1e9)

    def _mha(self, p, q_in, kv_k, kv_v, bias):
        """q_in [rows, Tq, D]; kv_k/v [rows, H, Tk, dk]; bias
        broadcastable to [rows, H, Tq, Tk]. Scores and softmax in f32."""
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

    def _init_state(self, rows):
        """Dense self-attention caches k<i>/v<i> [rows, H, max_len, dk],
        zeroed."""
        dk = self.d_model // self.n_head
        shape = (rows, self.n_head, self.max_len, dk)
        return {("k%d" % i if half == 0 else "v%d" % i):
                torch.zeros(shape, dtype=self.dtype, device=self.device)
                for i in range(self.n_layer) for half in (0, 1)}

    def _check_out_len(self, max_out_len):
        max_out = max_out_len or self.max_len
        if max_out > self.max_len:
            # beyond max_len the position lookup and the cache writes
            # would run off the tables: fail loudly instead
            raise ValueError("max_out_len %d exceeds the model's max_len %d"
                             % (max_out, self.max_len))
        return max_out

    def _input(self, value, dtype):
        return torch.as_tensor(value).to(device=self.device, dtype=dtype)

    def _decode(self, key, fn, *inputs):
        """``fn(*inputs)``, a whole decode returning a tuple of tensors.
        On the CPU it runs eagerly. On the card it runs as one CUDA graph
        per ``key``, dtype, BOS and end ids and input shape: captured at
        the first call (after an eager warm-up), then replayed with the
        inputs copied into its static buffers; the outputs are copied out
        of the graph's own."""
        if self.device.type != "cuda":
            return fn(*inputs)
        key = (key, self.dtype, self.bos_id, self.end_id) + tuple(
            (tuple(x.shape), x.dtype) for x in inputs)
        entry = self._decode_graphs.get(key)
        if entry is None:
            static = [x.clone() for x in inputs]
            out = []
            graph = StepGraph(self.device, "the decode %r" % (key,))
            graph.capture(lambda: fn(*static),
                          lambda: out.append(fn(*static)))
            entry = self._decode_graphs[key] = (graph, static, out)
        graph, static, out = entry
        for buf, x in zip(static, inputs):
            buf.copy_(x)
        graph.replay()
        return tuple(r.clone() for r in out[0])


class TransformerInfer(_Decoder):
    """KV-cached decode of ``transformer`` (MT) weights: the encoder once,
    then one decoder step a token over dense per-row self-attention
    caches and the cross K/V precomputed from the encoder's output.

    ``dtype`` is float32 (default) or bfloat16: bf16 casts weights and
    caches, with scores, softmax, layer-norm statistics and log-probs in
    f32. ``device`` defaults to the CUDA card (raising without one)."""

    def __init__(self, params, n_layer, n_head, d_model, max_len,
                 bos_id=1, end_id=2, dtype=None, device=None):
        super().__init__(n_layer, n_head, d_model, max_len, bos_id, end_id)
        dtype = _infer_dtype(dtype)
        dev = resolve_device(device)
        for name in ("src_word_emb", "src_pos_emb", "trg_word_emb",
                     "trg_pos_emb", "w_out"):
            setattr(self, name, _param(params[name], dtype, dev))
        self.enc_layers = nn.ModuleList(
            _Layer(p, dtype, dev) for p in params["enc_layers"])
        self.dec_layers = nn.ModuleList(
            _Layer(p, dtype, dev) for p in params["dec_layers"])

    @classmethod
    def from_stream(cls, stream, n_layer, n_head, d_model, max_len,
                    bos_id=1, end_id=2, dtype=None, device=None):
        """Build from a parameter stream (``mt_params_from_stream``)."""
        return cls(mt_params_from_stream(stream, n_layer), n_layer, n_head,
                   d_model, max_len, bos_id=bos_id, end_id=end_id,
                   dtype=dtype, device=device)

    @classmethod
    def from_program(cls, program, scope, n_layer, n_head, d_model,
                     max_len, bos_id=1, end_id=2, dtype=None, device=None):
        """Build from a trained ``transformer`` Program and its scope
        (``extract_params``), the JAX package's constructor signature."""
        return cls.from_stream(extract_params(program, scope), n_layer,
                               n_head, d_model, max_len, bos_id=bos_id,
                               end_id=end_id, dtype=dtype, device=device)

    def encode(self, src_tokens, src_mask):
        """src_tokens [B, T] int, src_mask [B, T] float -> [B, T, D]."""
        t = src_tokens.shape[1]
        x = self.src_word_emb[src_tokens.long()] * (self.d_model ** 0.5) \
            + self.src_pos_emb[:t][None]
        bias = (src_mask[:, None, None, :].float() - 1.0) * 1e9
        for p in self.enc_layers:
            k, v = self._kv(p, x)
            x = _ln(x + self._mha(p, x, k, v, bias), p.ln1_scale,
                    p.ln1_bias)
            x = _ln(x + self._ffn(p, x), p.ln2_scale, p.ln2_bias)
        return x

    def _init_decode_state(self, enc_out, src_mask, rows):
        """The cross K/V of every decoder layer and the cross bias, each
        source's repeated for its ``rows // B`` beams, and zeroed
        self-attention caches of ``rows`` rows."""
        def tile(x):
            # each source's row ``rows // B`` times in a row, as
            # jnp.repeat (an expand: nothing read back to the host)
            b = x.shape[0]
            return x[:, None].expand(b, rows // b, *x.shape[1:]).reshape(
                rows, *x.shape[1:])
        enc_out, src_mask = tile(enc_out), tile(src_mask)
        state = {"cross_bias":
                 (src_mask[:, None, None, :].float() - 1.0) * 1e9}
        for i, p in enumerate(self.dec_layers):
            state["cross_k%d" % i], state["cross_v%d" % i] = \
                self._kv(p.cross, enc_out)
        state.update(self._init_state(rows))
        return state

    def _step_logits(self, tok, state, t):
        """One decoder step at host position ``t``: tok [rows] int ->
        (logits [rows, V], state with this token's K/V written at cache
        position ``t`` in place)."""
        x = (self.trg_word_emb[tok.long()] * (self.d_model ** 0.5)
             + self.trg_pos_emb[t])[:, None, :]           # [rows, 1, D]
        bias = self._causal(t)
        for i, p in enumerate(self.dec_layers):
            k_new, v_new = self._kv(p.self_attn, x)       # [rows, H, 1, dk]
            k, v = state["k%d" % i], state["v%d" % i]
            k[:, :, t] = k_new[:, :, 0]
            v[:, :, t] = v_new[:, :, 0]
            a = self._mha(p.self_attn, x, k, v, bias)
            x = _ln(x + a, p.ln1_scale, p.ln1_bias)
            c = self._mha(p.cross, x, state["cross_k%d" % i],
                          state["cross_v%d" % i], state["cross_bias"])
            x = _ln(x + c, p.ln2_scale, p.ln2_bias)
            x = _ln(x + self._ffn(p, x), p.ln3_scale, p.ln3_bias)
        return x[:, 0, :] @ self.w_out, state

    def translate(self, src_tokens, src_mask, beam_size=4, max_out_len=None,
                  length_penalty=0.0):
        """Beam-search translate. Returns (sentences [B, beam, T] int32,
        best first, scores [B, beam])."""
        max_out = self._check_out_len(max_out_len)

        def run(src, mask):
            batch = src.shape[0]
            state = self._init_decode_state(self.encode(src, mask), mask,
                                            batch * beam_size)
            return decoding.beam_search(
                self._step_logits, state, self.bos_id, self.end_id,
                max_out, batch, beam_size, length_penalty)

        return self._decode(("translate", beam_size, max_out,
                             length_penalty), run,
                            self._input(src_tokens, torch.int32),
                            self._input(src_mask, torch.float32))

    def translate_greedy(self, src_tokens, src_mask, max_out_len=None):
        """Greedy translate. Returns (tokens [B, T] int32, scores [B])."""
        max_out = self._check_out_len(max_out_len)

        def run(src, mask):
            batch = src.shape[0]
            state = self._init_decode_state(self.encode(src, mask), mask,
                                            batch)
            return decoding.greedy_search(
                self._step_logits, state, self.bos_id, self.end_id,
                max_out, batch)

        return self._decode(("translate_greedy", max_out), run,
                            self._input(src_tokens, torch.int32),
                            self._input(src_mask, torch.float32))


class TransformerLMInfer(_Decoder):
    """KV-cached incremental decode for ``transformer_lm`` weights.

    ``dtype`` is float32 (default) or bfloat16: bf16 casts weights and
    KV caches, with scores, softmax and layer-norm statistics in f32.
    ``device`` defaults to the CUDA card (raising without one)."""

    def __init__(self, params, n_layer, n_head, d_model, max_len,
                 bos_id=1, end_id=2, dtype=None, device=None):
        super().__init__(n_layer, n_head, d_model, max_len, bos_id, end_id)
        dtype = _infer_dtype(dtype)
        dev = resolve_device(device)
        if len(params["layers"]) != n_layer:
            raise ValueError("params hold %d layers, n_layer is %d"
                             % (len(params["layers"]), n_layer))
        self.word_emb = _param(params["word_emb"], dtype, dev)
        self.pos_emb = _param(params["pos_emb"], dtype, dev)
        self.layers = nn.ModuleList(
            _Layer(p, dtype, dev) for p in params["layers"])
        self.w_out = _param(params["w_out"], dtype, dev)

    @classmethod
    def from_stream(cls, stream, n_layer, n_head, d_model, max_len,
                    bos_id=1, end_id=2, dtype=None, device=None):
        """Build from a parameter stream (``params_from_stream``)."""
        return cls(params_from_stream(stream, n_layer), n_layer, n_head,
                   d_model, max_len, bos_id=bos_id, end_id=end_id,
                   dtype=dtype, device=device)

    @classmethod
    def from_program(cls, program, scope, n_layer, n_head, d_model,
                     max_len, bos_id=1, end_id=2, dtype=None, device=None):
        """Build from a trained ``transformer_lm`` Program and its scope
        (``extract_params``), the JAX package's constructor signature."""
        return cls.from_stream(extract_params(program, scope), n_layer,
                               n_head, d_model, max_len, bos_id=bos_id,
                               end_id=end_id, dtype=dtype, device=device)

    # ------------------------------------------------------------------
    def _embed(self, tok, pos):
        return self.word_emb[tok] * (self.d_model ** 0.5) \
            + self.pos_emb[pos]

    def _bias(self, qpos):
        """Additive causal bias: 0 where key position <= ``qpos``, -1e9
        elsewhere; ``qpos`` [..., Tq] -> [..., Tq, max_len]."""
        ar = torch.arange(self.max_len, device=qpos.device)
        return torch.where(ar <= qpos[..., None], 0.0, -1e9)

    def _block_tail(self, p, x, a):
        x = _ln(x + a, p.ln1_scale, p.ln1_bias)
        return _ln(x + self._ffn(p, x), p.ln2_scale, p.ln2_bias)

    # -- dense cache (sequential baseline) -----------------------------
    def _step_logits(self, tok, state, t):
        """One incremental step: tok [rows] int64 -> (logits [rows, V],
        state with this token's K/V written at cache slot ``t``)."""
        x = self._embed(tok, t)[:, None, :]
        bias = self._causal(t)
        for i, p in enumerate(self.layers):
            k_new, v_new = self._kv(p, x)
            k, v = state["k%d" % i], state["v%d" % i]
            k[:, :, t] = k_new[:, :, 0]
            v[:, :, t] = v_new[:, :, 0]
            x = self._block_tail(p, x, self._mha(p, x, k, v, bias))
        return x[:, 0, :] @ self.w_out, state

    def generate(self, batch, max_out_len=None, beam_size=1,
                 length_penalty=0.0):
        """Generate from BOS. beam_size 1: greedy, (tokens [B, T] int32,
        scores [B]); beam_size > 1: beam search, (tokens [B, beam, T],
        scores [B, beam]), best first."""
        max_out = self._check_out_len(max_out_len)
        if beam_size > 1:
            def run():
                return decoding.beam_search(
                    self._step_logits, self._init_state(batch * beam_size),
                    self.bos_id, self.end_id, max_out, batch, beam_size,
                    length_penalty)
        else:
            def run():
                return decoding.greedy_search(
                    self._step_logits, self._init_state(batch),
                    self.bos_id, self.end_id, max_out, batch)
        return self._decode(("generate", batch, beam_size, max_out,
                             length_penalty), run)

    # -- dense per-slot cache (the engine's paged=False layout) ---------
    def _step_logits_slots(self, tok, state, pos, write_mask=None):
        """Per-slot decode step over the dense ``[S, H, max_len, dk]``
        caches: tok/pos [S] int64, every slot reading and writing its
        own cache position. ``write_mask`` [S] bool gates the writes:
        an idle or prefilling slot writes back the value it reads (the
        JAX package drops the write at index ``max_len``; torch would
        fault on it), so nothing is read back to the host and a CUDA
        graph can hold the step. Attention is ``_mha`` over all
        ``max_len`` keys, as the JAX package's. Returns (logits [S, V],
        state) with the caches updated in place."""
        qpos = torch.clamp(pos, max=self.max_len - 1)
        x = self._embed(tok, qpos)[:, None, :]           # [S, 1, D]
        bias = self._bias(pos)[:, None, None, :]         # [S, 1, 1, L]
        rows = torch.arange(tok.shape[0], device=tok.device)
        for i, p in enumerate(self.layers):
            k_new, v_new = self._kv(p, x)                # [S, H, 1, dk]
            for name, new in (("k%d" % i, k_new), ("v%d" % i, v_new)):
                cache, new = state[name], new[:, :, 0]
                if write_mask is not None:
                    new = torch.where(write_mask[:, None, None], new,
                                      cache[rows, :, qpos])
                cache[rows, :, qpos] = new
            a = self._mha(p, x, state["k%d" % i], state["v%d" % i], bias)
            x = self._block_tail(p, x, a)
        return x[:, 0, :] @ self.w_out, state

    def _prefill_chunk_slot(self, state, slot, toks, start, n_valid):
        """Teacher-forced chunk prefill into slot ``slot``'s dense
        cache: ``toks`` [C] int64 (a fixed-length chunk whose first
        ``n_valid`` entries are real) written at cache positions
        ``start..start+n_valid-1``. ``slot``/``start``/``n_valid`` are
        host ints, so the padded tail is simply not written. No logits
        are computed. Returns the state (caches updated in place)."""
        c = toks.shape[0]
        idx = torch.arange(c, device=self.device)
        cpos = start + idx                               # [C]
        gather_pos = torch.where(
            idx < n_valid, torch.clamp(cpos, max=self.max_len - 1), 0)
        x = self._embed(toks, gather_pos)[None]          # [1, C, D]
        bias = self._bias(cpos)[None, None]              # [1, 1, C, L]
        n = int(n_valid)
        for i, p in enumerate(self.layers):
            k_new, v_new = self._kv(p, x)                # [1, H, C, dk]
            k, v = state["k%d" % i], state["v%d" % i]
            k[slot, :, start:start + n] = k_new[0, :, :n]
            v[slot, :, start:start + n] = v_new[0, :, :n]
            a = self._mha(p, x, k[slot][None], v[slot][None], bias)
            x = self._block_tail(p, x, a)
        return state

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
