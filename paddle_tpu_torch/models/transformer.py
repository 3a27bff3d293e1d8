"""The transformer models: the flagship decoder-only LM and the
encoder-decoder MT model.

The counterpart of ``paddle_tpu/models/transformer.py`` for
``transformer_lm``, ``transformer`` (machine translation) and the pieces
they are built from (``position_encoding_init``, ``multi_head_attention``,
``positionwise_feed_forward``, ``pre_post_process_layer``,
``encoder_layer``, ``decoder_layer``, ``_embed``, ``make_attn_bias``),
with ``make_lm_batch`` and the zoo entries ``zoo_spec`` and
``zoo_spec_mt``. Built through the port's ``layers``, each emits the same
Program as the JAX package (``Program.to_json`` is identical under
``unique_name.guard()``).

With ``packed=True`` causal self-attention is one ``sp_attention`` op:
the CUDA flash-attention kernels on the card (the LM's every layer, the
MT decoder's every layer; the MT encoder and cross-attention stay
composed). ``packed=False`` is the composed matmul/softmax form with an
additive mask, the kernel-free twin of the same model. The options:
``recompute=True`` (LM) wraps each decoder layer in a
``layers.recompute()`` region (the flash forward then runs twice a
step: in the forward and in the recompute); ``dropout_rate > 0`` adds
the embedding dropout (LM), the attention-weight dropout (which takes the
composed path, as in the JAX package) and two residual dropouts a
layer, all on the CUDA dropout kernel; ``label_smooth_eps > 0`` trains
on soft labels, ``label_smooth(one_hot(label))``. Not ported yet:
``transformer_lm_parallel`` and the MoE zoo entry (ROADMAP.md, queue 1
item 9).
"""

import contextlib

import numpy as np

from .. import initializer, layers, optimizer
from ..param_attr import ParamAttr


def position_encoding_init(n_position, d_model):
    """Sinusoid position encoding table [n_position, d_model]."""
    pos = np.arange(n_position)[:, None].astype(np.float64)
    dim = np.arange(d_model)[None, :].astype(np.float64)
    angle = pos / np.power(10000, 2 * (dim // 2) / d_model)
    enc = np.zeros((n_position, d_model), np.float32)
    enc[:, 0::2] = np.sin(angle[:, 0::2])
    enc[:, 1::2] = np.cos(angle[:, 1::2])
    return enc


def multi_head_attention(queries, keys, values, attn_bias, d_key, d_value,
                         d_model, n_head=1, dropout_rate=0.0,
                         causal=False):
    """queries/keys/values: [B, T, D]; attn_bias: [B, n_head, Tq, Tk] addend
    (−inf at masked positions) or None.

    `causal=True` with no bias and no attention dropout takes the FUSED
    path: the sp_attention op, whose local lowering is the Pallas flash
    kernel on TPU (ops/flash_attention.py) — no [T, T] score tensor in
    HBM. Arbitrary biases keep the composed matmul+softmax form."""
    q = layers.fc(queries, d_key * n_head, num_flatten_dims=2,
                  bias_attr=False)
    k = layers.fc(keys, d_key * n_head, num_flatten_dims=2, bias_attr=False)
    v = layers.fc(values, d_value * n_head, num_flatten_dims=2,
                  bias_attr=False)

    def split_heads(x, d):
        b, t = x.shape[0], x.shape[1]
        x = layers.reshape(x, [b, t, n_head, d])
        return layers.transpose(x, perm=[0, 2, 1, 3])     # [B, H, T, d]

    q = split_heads(q, d_key)
    k = split_heads(k, d_key)
    v = split_heads(v, d_value)

    if causal and attn_bias is None and not dropout_rate:
        ctx = layers.sequence_parallel_attention(q, k, v, causal=True)
    else:
        if causal:
            # fused-path preconditions not met (dropout/bias): the
            # composed form must still mask the future. The T^2 constant
            # is created once per (block, T) and shared by every layer
            # instead of materializing a fresh triu per call.
            t = q.shape[2]
            blk = q.block
            cname = "causal_bias_%d" % t
            if blk.has_var(cname):
                tri_var = blk.var(cname)
            else:
                tri = np.triu(np.ones((t, t), np.float32), k=1) * -1e9
                tri_var = blk.create_var(name=cname, shape=(1, 1, t, t),
                                         dtype="float32")
                blk.append_op(
                    "assign_value", {}, {"Out": [cname]},
                    {"shape": [1, 1, t, t], "dtype": "float32",
                     # ndarray attr (serialized natively) — a .tolist()
                     # would box T^2 python floats
                     "values": tri.reshape(1, 1, t, t)})
            attn_bias = tri_var if attn_bias is None else \
                layers.elementwise_add(attn_bias, tri_var)
        product = layers.matmul(layers.scale(q, d_key ** -0.5), k,
                                transpose_y=True)         # [B, H, Tq, Tk]
        if attn_bias is not None:
            product = layers.elementwise_add(product, attn_bias)
        weights = layers.softmax(product)
        if dropout_rate:
            weights = layers.dropout(weights, dropout_prob=dropout_rate)
        ctx = layers.matmul(weights, v)                   # [B, H, Tq, dv]
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    b, t = ctx.shape[0], ctx.shape[1]
    ctx = layers.reshape(ctx, [b, t, n_head * d_value])
    return layers.fc(ctx, d_model, num_flatten_dims=2, bias_attr=False)


def positionwise_feed_forward(x, d_inner, d_model):
    hidden = layers.fc(x, d_inner, num_flatten_dims=2, act="relu")
    return layers.fc(hidden, d_model, num_flatten_dims=2)


def pre_post_process_layer(prev, out, process_cmd, dropout_rate=0.0):
    """'a' residual-add, 'n' layernorm, 'd' dropout (transformer_model.py
    pre_post_process_layer parity)."""
    for cmd in process_cmd:
        if cmd == "a":
            out = layers.elementwise_add(out, prev) if prev is not None \
                else out
        elif cmd == "n":
            out = layers.layer_norm(out, begin_norm_axis=len(out.shape) - 1)
        elif cmd == "d":
            if dropout_rate:
                out = layers.dropout(out, dropout_prob=dropout_rate)
    return out


def encoder_layer(x, attn_bias, n_head, d_key, d_value, d_model, d_inner,
                  dropout_rate=0.0):
    attn = multi_head_attention(x, x, x, attn_bias, d_key, d_value, d_model,
                                n_head, dropout_rate)
    attn_out = pre_post_process_layer(x, attn, "dan", dropout_rate)
    ffn = positionwise_feed_forward(attn_out, d_inner, d_model)
    return pre_post_process_layer(attn_out, ffn, "dan", dropout_rate)


def decoder_layer(x, enc_output, slf_attn_bias, dec_enc_attn_bias, n_head,
                  d_key, d_value, d_model, d_inner, dropout_rate=0.0,
                  causal=False):
    slf = multi_head_attention(x, x, x, slf_attn_bias, d_key, d_value,
                               d_model, n_head, dropout_rate,
                               causal=causal)
    slf_out = pre_post_process_layer(x, slf, "dan", dropout_rate)
    if enc_output is not None:
        cross = multi_head_attention(slf_out, enc_output, enc_output,
                                     dec_enc_attn_bias, d_key, d_value,
                                     d_model, n_head, dropout_rate)
        cross_out = pre_post_process_layer(slf_out, cross, "dan",
                                           dropout_rate)
    else:
        cross_out = slf_out
    ffn = positionwise_feed_forward(cross_out, d_inner, d_model)
    return pre_post_process_layer(cross_out, ffn, "dan", dropout_rate)


def _embed(tokens, vocab_size, d_model, max_len, pos_input, name):
    word = layers.embedding(
        tokens, size=[vocab_size, d_model],
        param_attr=ParamAttr(
            name=name + "_word_emb",
            initializer=initializer.Normal(0., d_model ** -0.5)))
    word = layers.scale(word, d_model ** 0.5)
    pos = layers.embedding(
        pos_input, size=[max_len, d_model],
        param_attr=ParamAttr(
            name=name + "_pos_emb", trainable=False,
            initializer=initializer.NumpyArrayInitializer(
                position_encoding_init(max_len, d_model))))
    return layers.elementwise_add(word, pos)


def make_attn_bias(mask_2d, n_head, causal=False, seq_len=None):
    """mask_2d: [B, T] 1/0 validity → additive bias [B, H, T, T]."""
    b, t = mask_2d.shape[0], mask_2d.shape[1]
    key_mask = layers.reshape(mask_2d, [b, 1, 1, t])
    # (mask-1)*1e9 : 0 where valid, -1e9 where padding.
    # scale(bias_after_scale=False) computes scale*(x+bias) → bias=-1.0
    bias = layers.scale(key_mask, 1e9, bias=-1.0, bias_after_scale=False)
    bias = layers.expand(bias, expand_times=[1, n_head, t, 1])
    if causal:
        tri = np.triu(np.ones((t, t), np.float32), k=1) * -1e9
        tri_var = layers.assign(tri.reshape(1, 1, t, t))
        bias = layers.elementwise_add(bias, tri_var)
    return bias


def transformer_lm(vocab_size=4096, max_len=256, n_layer=4, n_head=8,
                   d_model=512, d_inner=2048, dropout_rate=0.0,
                   label_smooth_eps=0.0, packed=False, recompute=False):
    """Decoder-only LM (flagship bench model). Feeds: src [B,T] int64,
    pos [B,T] int64, mask [B,T] float32, label [B,T] int64.
    Returns (avg_cost, logits).

    packed=True assumes full-length (packed) sequences — the standard LM
    pretraining layout — and drops the padding half of the attention bias
    so self-attention runs through the fused flash path; `mask` still
    weights the loss. recompute=True wraps each decoder layer in a
    layers.recompute() region: layer activations are recomputed in the
    backward pass, trading ~1/3 extra forward work for activation
    memory — the long-context lever."""
    d_key = d_value = d_model // n_head
    src = layers.data("src", [max_len], dtype="int64")
    pos = layers.data("pos", [max_len], dtype="int64")
    mask = layers.data("mask", [max_len], dtype="float32")
    label = layers.data("label", [max_len], dtype="int64")

    x = _embed(src, vocab_size, d_model, max_len, pos, "lm")
    if dropout_rate:
        x = layers.dropout(x, dropout_prob=dropout_rate)
    bias = None if packed else make_attn_bias(mask, n_head, causal=True)
    for _ in range(n_layer):
        with layers.recompute() if recompute else contextlib.nullcontext():
            x = decoder_layer(x, None, bias, None, n_head, d_key, d_value,
                              d_model, d_inner, dropout_rate,
                              causal=packed)
    logits = layers.fc(x, vocab_size, num_flatten_dims=2, bias_attr=False)

    b, t = logits.shape[0], logits.shape[1]
    flat_logits = layers.reshape(logits, [-1, vocab_size])
    flat_label = layers.reshape(label, [-1, 1])
    if label_smooth_eps:
        smooth = layers.label_smooth(
            layers.one_hot(flat_label, vocab_size), epsilon=label_smooth_eps)
        cost = layers.softmax_with_cross_entropy(flat_logits, smooth,
                                                 soft_label=True)
    else:
        cost = layers.softmax_with_cross_entropy(flat_logits, flat_label)
    flat_mask = layers.reshape(mask, [-1, 1])
    masked = layers.elementwise_mul(cost, flat_mask)
    avg_cost = layers.reduce_sum(masked) / layers.reduce_sum(flat_mask)
    return avg_cost, logits


def transformer(src_vocab_size=4096, trg_vocab_size=4096, max_len=64,
                n_layer=2, n_head=8, d_model=256, d_inner=1024,
                dropout_rate=0.0, label_smooth_eps=0.0, packed=False):
    """Encoder-decoder MT model (machine_translation benchmark parity).
    Feeds: src_word, src_pos, src_mask, trg_word, trg_pos, trg_mask,
    lbl_word, all [B, T]. Returns (avg_cost, predictions).

    packed=True assumes full-length (packed) sequences: padding biases are
    dropped and decoder self-attention takes the fused flash path
    (causal in the kernel); `trg_mask` still weights the loss."""
    d_key = d_value = d_model // n_head
    src_word = layers.data("src_word", [max_len], dtype="int64")
    src_pos = layers.data("src_pos", [max_len], dtype="int64")
    src_mask = layers.data("src_mask", [max_len], dtype="float32")
    trg_word = layers.data("trg_word", [max_len], dtype="int64")
    trg_pos = layers.data("trg_pos", [max_len], dtype="int64")
    trg_mask = layers.data("trg_mask", [max_len], dtype="float32")
    lbl_word = layers.data("lbl_word", [max_len], dtype="int64")

    enc_in = _embed(src_word, src_vocab_size, d_model, max_len, src_pos,
                    "src")
    enc_bias = None if packed else make_attn_bias(src_mask, n_head)
    enc = enc_in
    for _ in range(n_layer):
        enc = encoder_layer(enc, enc_bias, n_head, d_key, d_value, d_model,
                            d_inner, dropout_rate)

    dec_in = _embed(trg_word, trg_vocab_size, d_model, max_len, trg_pos,
                    "trg")
    slf_bias = None if packed else make_attn_bias(trg_mask, n_head,
                                                  causal=True)
    # cross bias: queries are target positions, keys source positions
    # (Tq == Tk == max_len, so the key-padding bias applies as it is)
    cross_bias = None if packed else make_attn_bias(src_mask, n_head)
    dec = dec_in
    for _ in range(n_layer):
        dec = decoder_layer(dec, enc, slf_bias, cross_bias, n_head, d_key,
                            d_value, d_model, d_inner, dropout_rate,
                            causal=packed)

    logits = layers.fc(dec, trg_vocab_size, num_flatten_dims=2,
                       bias_attr=False)
    flat_logits = layers.reshape(logits, [-1, trg_vocab_size])
    flat_label = layers.reshape(lbl_word, [-1, 1])
    if label_smooth_eps:
        smooth = layers.label_smooth(
            layers.one_hot(flat_label, trg_vocab_size),
            epsilon=label_smooth_eps)
        cost = layers.softmax_with_cross_entropy(flat_logits, smooth,
                                                 soft_label=True)
    else:
        cost = layers.softmax_with_cross_entropy(flat_logits, flat_label)
    flat_mask = layers.reshape(trg_mask, [-1, 1])
    masked = layers.elementwise_mul(cost, flat_mask)
    avg_cost = layers.reduce_sum(masked) / layers.reduce_sum(flat_mask)
    return avg_cost, logits


def zoo_spec():
    """(build_fn, feed_fn): flagship decoder-only LM, SGD train step."""
    vocab, max_len = 256, 32

    def build():
        avg_cost, _ = transformer_lm(vocab_size=vocab, max_len=max_len,
                                     n_layer=2, n_head=4, d_model=64,
                                     d_inner=128)
        optimizer.SGD(learning_rate=1e-3).minimize(avg_cost)
        return (avg_cost,)

    def feeds(rng):
        return make_lm_batch(rng, 4, max_len, vocab)

    return build, feeds


def zoo_spec_mt():
    """(build_fn, feed_fn): encoder-decoder MT model, SGD train step. The
    encoder's self-attention bias and the decoder's cross-attention bias
    are both derived from ``src_mask`` through identical chains."""
    vocab, max_len = 64, 16

    def build():
        avg_cost, _ = transformer(
            src_vocab_size=vocab, trg_vocab_size=vocab,
            max_len=max_len, n_layer=1, n_head=2, d_model=32,
            d_inner=64)
        optimizer.SGD(learning_rate=1e-3).minimize(avg_cost)
        return (avg_cost,)

    def feeds(rng):
        return mt_feeds(make_lm_batch(rng, 2, max_len, vocab),
                        make_lm_batch(rng, 2, max_len, vocab))

    return build, feeds


def mt_feeds(src, trg):
    """The MT model's feed from two ``make_lm_batch`` batches: ``src``'s
    tokens, positions and mask on the source side, ``trg``'s on the
    target side with its labels."""
    return {"src_word": src["src"], "src_pos": src["pos"],
            "src_mask": src["mask"], "trg_word": trg["src"],
            "trg_pos": trg["pos"], "trg_mask": trg["mask"],
            "lbl_word": trg["label"]}


def make_lm_batch(rng, batch, max_len, vocab_size):
    """Synthetic LM batch (shifted-token next-token task)."""
    lens = rng.randint(max_len // 2, max_len + 1, size=batch)
    src = rng.randint(3, vocab_size, size=(batch, max_len))
    mask = (np.arange(max_len)[None, :] < lens[:, None]).astype(np.float32)
    src = (src * mask).astype(np.int64)
    label = np.roll(src, -1, axis=1)
    label[:, -1] = 0
    pos = np.tile(np.arange(max_len, dtype=np.int64), (batch, 1))
    return {"src": src, "pos": pos, "mask": mask, "label": label}
