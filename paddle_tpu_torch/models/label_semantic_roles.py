"""The label_semantic_roles book model: the reference's SRL tagger
(python/paddle/fluid/tests/book/test_label_semantic_roles.py ``db_lstm``)
over CoNLL-2005, trained by a linear-chain CRF and decoded by Viterbi
over the same transition parameter, with chunk metrics in the program.

The network, at the book's widths by default: six word and context
lookups into one shared table (``emb``, not trained), a predicate and a
mark lookup; ``hidden_0`` the sum of one fc(hidden_dim, tanh) a lookup;
then ``depth`` layers, each the sum of two fc(hidden_dim, tanh) over
the last [mix, lstm] pair and a ``dynamic_lstm(hidden_dim)`` with
peepholes and the book's activation attributes (gate sigmoid, cell
sigmoid, candidate relu: the JAX package's ``lstm``, which the port
follows, applies the cell activation to the candidate and the candidate
activation to the cell; ROADMAP.md, queue 3), reversed on odd layers;
``feature_out`` the sum of two fc(label_dict_len, tanh);
``linear_chain_crf`` with its transition ``crfw`` at learning rate
``mix_hidden_lr``, ``crf_decoding`` sharing ``crfw``, and ``chunk_eval``
(IOB) of the decoded path against the target. The lookups are dense
(``is_sparse=False``, where the book's are sparse): ``run_steps`` holds
no SelectedRows host op. Adam at ``learning_rate`` takes the book's SGD
place, as the repo's book test (tests/book/test_label_semantic_roles.py)
trains it.

``fluid`` is the package that builds the net: this one by default, or
any package with its Program API (the tests build the same net with the
JAX package).
"""

import math

import numpy as np

# python/paddle/dataset/conll05.py's dictionaries
WORD_DICT_LEN, VERB_DICT_LEN, LABEL_DICT_LEN = 44068, 3162, 59
MARK_DICT_LEN = 2
FEEDS = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2", "verb",
         "mark")
BOOK = dict(word_dict_len=WORD_DICT_LEN, pred_dict_len=VERB_DICT_LEN,
            label_dict_len=LABEL_DICT_LEN, word_dim=32, mark_dim=5,
            hidden_dim=512, depth=8)


def _package(fluid):
    if fluid is None:
        import paddle_tpu_torch as fluid
    return fluid


def db_lstm(fluid, feats, word_dict_len, pred_dict_len, label_dict_len,
            word_dim, mark_dim, hidden_dim, depth):
    """The tagger's emission scores [T, label_dict_len] over the eight
    LoD id inputs ``feats`` (FEEDS' order)."""
    L = fluid.layers
    word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, predicate, mark = feats
    predicate_emb = L.embedding(predicate, size=[pred_dict_len, word_dim],
                                param_attr="vemb")
    mark_emb = L.embedding(mark, size=[MARK_DICT_LEN, mark_dim])
    embs = [L.embedding(x, size=[word_dict_len, word_dim],
                        param_attr=fluid.ParamAttr(name="emb",
                                                   trainable=False))
            for x in (word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2)]
    embs += [predicate_emb, mark_emb]
    hidden_0 = L.sums([L.fc(e, hidden_dim, act="tanh") for e in embs])
    lstm_0, _ = L.dynamic_lstm(hidden_0, size=hidden_dim,
                               candidate_activation="relu",
                               gate_activation="sigmoid",
                               cell_activation="sigmoid")
    inp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix = L.sums([L.fc(inp[0], hidden_dim, act="tanh"),
                      L.fc(inp[1], hidden_dim, act="tanh")])
        lstm, _ = L.dynamic_lstm(mix, size=hidden_dim,
                                 candidate_activation="relu",
                                 gate_activation="sigmoid",
                                 cell_activation="sigmoid",
                                 is_reverse=(i % 2 == 1))
        inp = [mix, lstm]
    return L.sums([L.fc(inp[0], label_dict_len, act="tanh"),
                   L.fc(inp[1], label_dict_len, act="tanh")])


def build_train_net(fluid=None, learning_rate=2e-3, mix_hidden_lr=1e-3,
                    **widths):
    """Builds the training program into the current programs: returns
    {"feeds": the nine data vars (FEEDS and "target"), "emission": the
    tagger's scores, "loss": the mean CRF NLL, "nll": the per-sentence
    NLL [n, 1], "path": the Viterbi path, "chunks": chunk_eval's
    (precision, recall, f1, num_infer, num_label, num_correct)}.
    ``widths`` override BOOK's."""
    fluid = _package(fluid)
    w = dict(BOOK, **widths)
    L = fluid.layers
    feats = [L.data(n, [1], dtype="int64", lod_level=1) for n in FEEDS]
    target = L.data("target", [1], dtype="int64", lod_level=1)
    feature_out = db_lstm(fluid, feats, **w)
    nll = L.linear_chain_crf(
        feature_out, target,
        param_attr=fluid.ParamAttr(name="crfw", learning_rate=mix_hidden_lr))
    loss = L.mean(nll)
    fluid.optimizer.Adam(learning_rate=learning_rate).minimize(loss)
    path = L.crf_decoding(feature_out,
                          param_attr=fluid.ParamAttr(name="crfw"))
    chunks = L.chunk_eval(
        path, target, chunk_scheme="IOB",
        num_chunk_types=int(math.ceil((w["label_dict_len"] - 1) / 2.0)))
    return {"feeds": feats + [target], "emission": feature_out,
            "loss": loss, "nll": nll, "path": path, "chunks": chunks}


def make_batch(fluid=None, batch=64, seed=0, **widths):
    """(feed dict of LoDTensors, lengths): ``batch`` sentences of lengths
    RandomState(seed).randint(5, 30) (the conll05 reader's range), then
    from the same stream the six word and context ids, one predicate a
    sentence, the marks and the labels."""
    fluid = _package(fluid)
    w = dict(BOOK, **widths)
    rng = np.random.RandomState(seed)
    lens = rng.randint(5, 30, size=batch).tolist()
    total = sum(lens)

    def ids(hi, n=total):
        return rng.randint(0, hi, (n, 1)).astype(np.int64)

    cols = [ids(w["word_dict_len"]) for _ in range(6)]
    cols.append(np.repeat(ids(w["pred_dict_len"], batch), lens, axis=0))
    cols.append(ids(MARK_DICT_LEN))
    cols.append(ids(w["label_dict_len"]))
    names = FEEDS + ("target",)
    return {n: fluid.create_lod_tensor(c, [lens])
            for n, c in zip(names, cols)}, lens
