"""Book models of ``tests/book/`` through the port against the JAX
package, part 2: label_semantic_roles, machine_translation,
rnn_encoder_decoder, understand_sentiment and word2vec, at narrow
widths. Each net is built in both packages from one builder, fed by the
port's own ``dataset`` reader and ``DataFeeder`` (the JAX package's
feeder gives the same feed, LoD included), and trained 3 steps from the
JAX package's startup values: the losses and every persistable value
within 2e-4 (``torch_book_harness``).
"""

import numpy as np

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.dataset import conll05, imdb, imikolov, wmt14

from torch_book_harness import book_parity


def db_lstm(pkg, word_dim=8, hidden=32, depth=2):
    """The book's SRL tagger: word and context embeddings sharing one
    table, predicate and mark embeddings, fc + dynamic_lstm pairs
    alternating direction, the CRF loss; Viterbi decoding shares the
    transition parameter by name."""
    names = ["word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2",
             "verb", "mark"]
    feats = [pkg.layers.data(n, [1], dtype="int64", lod_level=1)
             for n in names]
    target = pkg.layers.data("target", [1], dtype="int64", lod_level=1)
    shared = pkg.ParamAttr(name="word_emb")
    embs = [pkg.layers.embedding(w, size=[conll05.WORD_VOCAB, word_dim],
                                 param_attr=shared) for w in feats[:6]]
    embs.append(pkg.layers.embedding(feats[6], size=[conll05.VERB_VOCAB,
                                                     word_dim]))
    embs.append(pkg.layers.embedding(feats[7], size=[2, word_dim]))
    hidden0 = pkg.layers.fc(pkg.layers.concat(embs, axis=1), hidden,
                            act="tanh")
    lstm0, _ = pkg.layers.dynamic_lstm(hidden0, size=hidden)
    inp = [hidden0, lstm0]
    for i in range(1, depth):
        mix = pkg.layers.fc(pkg.layers.concat(inp, axis=1), hidden,
                            act="tanh")
        lstm, _ = pkg.layers.dynamic_lstm(mix, size=hidden,
                                          is_reverse=(i % 2 == 1))
        inp = [mix, lstm]
    feature_out = pkg.layers.fc(pkg.layers.concat(inp, axis=1),
                                conll05.LABEL_COUNT)
    crf_cost = pkg.layers.linear_chain_crf(
        feature_out, target, param_attr=pkg.ParamAttr(name="crfw"))
    avg_cost = pkg.layers.mean(crf_cost)
    pkg.optimizer.Adam(learning_rate=2e-3).minimize(avg_cost)
    pkg.layers.crf_decoding(feature_out,
                            param_attr=pkg.ParamAttr(name="crfw"))
    return feats + [target], avg_cost


def test_label_semantic_roles():
    losses, scope, main, feeds = book_parity(db_lstm, conll05.train(24),
                                             batch_size=8)
    assert all(isinstance(feeds[0][n], tfluid.LoDTensor)
               for n in ("word", "verb", "target"))
    path = [op for op in main.global_block().ops
            if op.type == "crf_decoding"][0].output("ViterbiPath")[0]
    pv, = tfluid.Executor(tfluid.CPUPlace()).run(
        main.prune([path]), feed=feeds[0], fetch_list=[path], scope=scope)
    assert pv.shape == (int(feeds[0]["word"].data.shape[0]), 1)
    assert (pv >= 0).all() and (pv < conll05.LABEL_COUNT).all()


MT_DICT, MT_LEN = 64, 16


def _mt_sample(sample):
    """A wmt14 (src, trg, trg_next) triple as the transformer's padded
    rows: words, positions and masks of MT_LEN."""
    def pad(ids):
        ids = list(ids)[:MT_LEN]
        n = len(ids)
        return (np.array(ids + [0] * (MT_LEN - n), np.int64),
                np.arange(MT_LEN, dtype=np.int64),
                (np.arange(MT_LEN) < n).astype(np.float32))
    src, trg, nxt = sample
    s_w, s_p, s_m = pad(src)
    t_w, t_p, t_m = pad(trg)
    return s_w, s_p, s_m, t_w, t_p, t_m, pad(nxt)[0]


def transformer_mt(pkg):
    if pkg is tfluid:
        from paddle_tpu_torch.models import transformer as T
    else:
        from paddle_tpu.models import transformer as T
    avg_cost, _ = T.transformer(
        src_vocab_size=MT_DICT, trg_vocab_size=MT_DICT, max_len=MT_LEN,
        n_layer=1, n_head=2, d_model=32, d_inner=64)
    pkg.optimizer.Adam(learning_rate=5e-3).minimize(avg_cost)
    block = pkg.default_main_program().global_block()
    names = ["src_word", "src_pos", "src_mask", "trg_word", "trg_pos",
             "trg_mask", "lbl_word"]
    return [block.var(n) for n in names], avg_cost


def test_machine_translation():
    """The book's MT model as the JAX package's book test builds it (the
    encoder-decoder transformer), fed from wmt14 through a mapped reader
    and DataFeeder."""
    reader = tfluid.reader.map_readers(
        _mt_sample, wmt14.train(dict_size=MT_DICT, n=48))
    losses, _, _, feeds = book_parity(transformer_mt, reader, batch_size=8)
    assert feeds[0]["src_word"].shape == (8, MT_LEN)
    assert feeds[0]["src_mask"].dtype == np.float32


RNN_DICT, RNN_EMB, RNN_GRU = 500, 8, 16


def seq_to_seq(pkg):
    """The book's GRU encoder-decoder: the encoder's last state starts
    the decoder; the per-token cost sum-pooled per sequence."""
    src = pkg.layers.data("src_word_id", [1], dtype="int64", lod_level=1)
    trg = pkg.layers.data("target_language_word", [1], dtype="int64",
                          lod_level=1)
    label = pkg.layers.data("target_language_next_word", [1],
                            dtype="int64", lod_level=1)
    src_emb = pkg.layers.embedding(src, size=[RNN_DICT, RNN_EMB])
    enc = pkg.layers.dynamic_gru(pkg.layers.fc(src_emb, RNN_GRU * 3),
                                 size=RNN_GRU)
    enc_last = pkg.layers.sequence_last_step(enc)
    trg_emb = pkg.layers.embedding(trg, size=[RNN_DICT, RNN_EMB])
    dec = pkg.layers.dynamic_gru(pkg.layers.fc(trg_emb, RNN_GRU * 3),
                                 size=RNN_GRU, h_0=enc_last)
    prediction = pkg.layers.fc(dec, RNN_DICT, act="softmax")
    cost = pkg.layers.cross_entropy(prediction, label)
    avg_cost = pkg.layers.mean(pkg.layers.sequence_pool(cost, "sum"))
    pkg.optimizer.Adam(learning_rate=0.005).minimize(avg_cost)
    return [src, trg, label], avg_cost


def test_rnn_encoder_decoder():
    losses, _, _, feeds = book_parity(
        seq_to_seq, wmt14.train(dict_size=RNN_DICT, n=32), batch_size=8)
    lens = feeds[0]["src_word_id"].recursive_sequence_lengths()[0]
    assert len(lens) == 8 and min(lens) >= 3


def stacked_lstm_net(pkg, emb_dim=16, hid_dim=32, stacked_num=3):
    """The book's stacked_lstm_net: fc + dynamic_lstm pairs, every later
    pair reversed, max-pooled, a softmax classifier."""
    data = pkg.layers.data("words", [1], dtype="int64", lod_level=1)
    label = pkg.layers.data("label", [1], dtype="int64")
    emb = pkg.layers.embedding(data, size=[imdb.VOCAB_SIZE, emb_dim])
    fc1 = pkg.layers.fc(emb, hid_dim)
    lstm1, _ = pkg.layers.dynamic_lstm(fc1, size=hid_dim)
    inputs = [fc1, lstm1]
    for _ in range(2, stacked_num + 1):
        fc = pkg.layers.fc(pkg.layers.concat(inputs, axis=1), hid_dim)
        lstm, _ = pkg.layers.dynamic_lstm(fc, size=hid_dim, is_reverse=True)
        inputs = [fc, lstm]
    fc_last = pkg.layers.sequence_pool(inputs[0], "max")
    lstm_last = pkg.layers.sequence_pool(inputs[1], "max")
    prediction = pkg.layers.fc(pkg.layers.concat([fc_last, lstm_last],
                                                 axis=1), 2, act="softmax")
    avg_cost = pkg.layers.mean(pkg.layers.cross_entropy(prediction, label))
    pkg.layers.accuracy(prediction, label)
    pkg.optimizer.Adam(learning_rate=0.002).minimize(avg_cost)
    return [data, label], avg_cost


def test_understand_sentiment():
    losses, _, _, feeds = book_parity(
        stacked_lstm_net, tfluid.reader.shuffle(imdb.train(n=64), 64),
        batch_size=8)
    assert feeds[0]["label"].shape == (8, 1)
    assert feeds[0]["words"].data.shape[1:] == (1,)


def word2vec(pkg, emb_size=8, hidden=16):
    """The book's N-gram LM: four context words through one shared
    table, a sigmoid hidden layer, a softmax over the vocabulary."""
    words = [pkg.layers.data("w%d" % i, [1], dtype="int64")
             for i in range(4)]
    target = pkg.layers.data("target", [1], dtype="int64")
    embeds = [pkg.layers.embedding(
        w, size=[imikolov.VOCAB_SIZE, emb_size],
        param_attr=pkg.ParamAttr(name="shared_w")) for w in words]
    hidden1 = pkg.layers.fc(pkg.layers.concat(embeds, axis=1), hidden,
                            act="sigmoid")
    predict = pkg.layers.fc(hidden1, imikolov.VOCAB_SIZE, act="softmax")
    avg_cost = pkg.layers.mean(pkg.layers.cross_entropy(predict, target))
    pkg.optimizer.Adam(learning_rate=1e-2).minimize(avg_cost)
    return words + [target], avg_cost


def test_word2vec():
    losses, scope, main, feeds = book_parity(
        word2vec, imikolov.train(None, 5, samples=256), batch_size=64)
    params = [p.name for p in main.global_block().all_parameters()]
    assert params.count("shared_w") == 1
    assert feeds[0]["w0"].shape == (64, 1)
