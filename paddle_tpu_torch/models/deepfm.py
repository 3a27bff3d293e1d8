"""DeepFM CTR model (the counterpart of ``paddle_tpu/models/deepfm.py``,
but for its ``analysis_entry``: ROADMAP.md, queue 1 item 11(b)).

Architecture (DeepFM): per-field sparse id embeddings feed BOTH a
factorization machine (first-order weights + pairwise second-order
interactions via the sum-square/square-sum identity) and a DNN over the
concatenated embeddings; logits add. ``lookup_table`` keeps its dense
gradient, as the JAX package's does on one device, and ``is_sparse``
changes nothing on one device. ``is_distributed=True`` marks both FM
tables for ``DistributeTranspiler``: in pserver mode each table is
row-sharded over the pservers, the trainer's lookups become
``prefetch`` ops and the rows' gradients go back as SelectedRows
(``send_sparse``). ``make_featurizer`` (host numpy) feeds the
``serving.sparse`` ScoringEngine, which scores ``build_scoring_net``
over the pserver tables.
"""

from .. import layers, optimizer
from ..param_attr import ParamAttr


def deepfm(field_inputs, vocab_size, embed_dim=8, dnn_dims=(32, 32),
           is_sparse=True, is_distributed=False):
    """field_inputs: list of [B, 1] int64 Variables (one id per field).
    Returns (prob [B, 1], logit [B, 1])."""
    num_fields = len(field_inputs)

    # first-order term: a 1-wide embedding per id
    first = [layers.embedding(
        x, size=[vocab_size, 1], is_sparse=is_sparse,
        is_distributed=is_distributed,
        param_attr=ParamAttr(name="fm_first_w"))
        for x in field_inputs]
    y_first = layers.sums([layers.reshape(f, [-1, 1]) for f in first])

    # second-order term over shared k-dim embeddings:
    # 0.5 * sum_k[(sum_f v_fk)^2 - sum_f v_fk^2]
    embeds = [layers.embedding(
        x, size=[vocab_size, embed_dim], is_sparse=is_sparse,
        is_distributed=is_distributed,
        param_attr=ParamAttr(name="fm_second_w"))
        for x in field_inputs]
    embeds2d = [layers.reshape(e, [-1, embed_dim]) for e in embeds]
    sum_v = layers.sums(embeds2d)
    sum_sq = layers.elementwise_mul(sum_v, sum_v)
    sq_sum = layers.sums(
        [layers.elementwise_mul(e, e) for e in embeds2d])
    second = layers.scale(
        layers.elementwise_sub(sum_sq, sq_sum), scale=0.5)
    y_second = layers.reduce_sum(second, dim=[1], keep_dim=True)

    # deep component over the concatenated field embeddings
    deep = layers.concat(embeds2d, axis=1)      # [B, F*k]
    for width in dnn_dims:
        deep = layers.fc(deep, width, act="relu")
    y_deep = layers.fc(deep, 1)

    logit = layers.elementwise_add(
        layers.elementwise_add(y_first, y_second), y_deep)
    prob = layers.sigmoid(logit)
    return prob, logit


def build_train_net(num_fields=8, vocab_size=1000, embed_dim=8,
                    learning_rate=1e-2, is_sparse=True):
    """CTR training net: per-field ids + 0/1 click label -> log loss."""
    fields = [layers.data("field_%d" % i, [1], dtype="int64")
              for i in range(num_fields)]
    label = layers.data("click", [1])
    prob, logit = deepfm(fields, vocab_size, embed_dim,
                         is_sparse=is_sparse)
    loss = layers.mean(
        layers.sigmoid_cross_entropy_with_logits(logit, label))
    optimizer.Adam(learning_rate=learning_rate).minimize(loss)
    return fields, label, prob, loss


def build_scoring_net(num_fields, embed_dim, dnn_dims=(32, 32),
                      prefix="deepfm_scoring"):
    """DeepFM INFERENCE net over prefetched embedding rows — the
    serving-side twin of ``deepfm`` for the sharded-table deployment
    (serving.sparse): the trainer's ``lookup_table`` ops became
    prefetches against live pservers, so the scoring program takes the
    already-gathered (and, for multi-hot fields, sum-POOLED) rows as
    dense inputs and is a pure fixed-shape dispatch — raggedness and
    the wire never reach the compiled program.

    Feeds: ``fm_first_rows`` [B, F] (per-field first-order weights,
    summed over the field's ids), ``fm_second_rows`` [B, F, D]
    (per-field pooled k-dim embeddings). With one id per field the
    pooled rows equal the train net's embedding outputs, so scores
    match the training forward given the same dense params. Returns
    (prob [B, 1], logit [B, 1])."""
    first_rows = layers.data("fm_first_rows", [num_fields])
    second_rows = layers.data("fm_second_rows",
                              [num_fields, embed_dim])

    # first-order term: sum of the fields' 1-wide weights
    y_first = layers.reduce_sum(first_rows, dim=[1],
                                      keep_dim=True)

    # second-order: 0.5 * sum_k[(sum_f v_fk)^2 - sum_f v_fk^2]
    sum_v = layers.reduce_sum(second_rows, dim=[1])      # [B, D]
    sum_sq = layers.elementwise_mul(sum_v, sum_v)
    sq_sum = layers.reduce_sum(
        layers.elementwise_mul(second_rows, second_rows),
        dim=[1])
    second = layers.scale(
        layers.elementwise_sub(sum_sq, sq_sum), scale=0.5)
    y_second = layers.reduce_sum(second, dim=[1], keep_dim=True)

    # deep component over the concatenated field embeddings
    deep = layers.reshape(second_rows, [-1, num_fields * embed_dim])
    for i, width in enumerate(dnn_dims):
        deep = layers.fc(
            deep, width, act="relu",
            param_attr=ParamAttr(name="%s_fc%d_w" % (prefix, i)),
            bias_attr=ParamAttr(name="%s_fc%d_b" % (prefix, i)))
    y_deep = layers.fc(
        deep, 1,
        param_attr=ParamAttr(name="%s_out_w" % prefix),
        bias_attr=ParamAttr(name="%s_out_b" % prefix))

    logit = layers.elementwise_add(
        layers.elementwise_add(y_first, y_second), y_deep)
    prob = layers.sigmoid(logit)
    return prob, logit


def make_featurizer(first_client, second_client, num_fields,
                    embed_dim):
    """ScoringEngine featurizer for ``build_scoring_net``: resolves
    every request's ragged per-field id lists through the hot-ID
    caches with ONE deduplicated batched lookup per table across the
    whole admitted batch, sum-pools multi-hot fields, and pads to the
    engine's fixed batch shape. ``features``: {"f0": [ids...], ...,
    "f<F-1>": [...]} (ragged, >= 1 id per present field; an absent
    field pools to zero)."""
    import numpy as np

    field_names = ["f%d" % i for i in range(num_fields)]

    def validate(feats):
        """Submit-time schema check (ScoringEngine calls it via the
        featurizer's .validate attr): a malformed payload raises HERE
        — the BADR typed-reject surface — never inside the scheduler
        loop where it would fail a whole co-admitted batch."""
        unknown = sorted(set(feats) - set(field_names))
        if unknown:
            raise ValueError(
                "unknown feature field(s) %s (expected %s)"
                % (unknown, field_names))
        for name, ids in feats.items():
            try:
                [int(i) for i in np.asarray(ids).reshape(-1)]
            except (TypeError, ValueError):
                raise ValueError(
                    "field %r ids %r are not an int id list"
                    % (name, ids))

    def featurizer(features_list, batch):
        for feats in features_list:
            validate(feats)
        # ONE deduplicated wire/cache resolution per table for the
        # whole batch — the batched-prefetch contract
        all_ids = sorted({int(i) for feats in features_list
                          for ids in feats.values()
                          for i in np.asarray(ids).reshape(-1)})
        first_rows = {}
        second_rows = {}
        if all_ids:
            fr = first_client.lookup(all_ids)
            sr = second_client.lookup(all_ids)
            for j, i in enumerate(all_ids):
                first_rows[i] = fr[j]
                second_rows[i] = sr[j]
        first = np.zeros((batch, num_fields), np.float32)
        second = np.zeros((batch, num_fields, embed_dim), np.float32)
        for b, feats in enumerate(features_list):
            for f, name in enumerate(field_names):
                ids = np.asarray(feats.get(name, ()),
                                 np.int64).reshape(-1)
                for i in ids:                    # sum-pool multi-hot
                    first[b, f] += float(
                        np.asarray(first_rows[int(i)]).reshape(-1)[0])
                    second[b, f] += np.asarray(
                        second_rows[int(i)], np.float32).reshape(-1)
        # frozen: identical padded batches re-use committed device
        # buffers through the executor's feed-plan cache
        first.flags.writeable = False
        second.flags.writeable = False
        return {"fm_first_rows": first, "fm_second_rows": second}

    featurizer.validate = validate
    return featurizer


def zoo_spec():
    """(build_fn, feed_fn): DeepFM CTR Adam train step."""
    import numpy as np
    num_fields, vocab = 8, 1000

    def build():
        _, _, prob, loss = build_train_net(num_fields=num_fields,
                                           vocab_size=vocab)
        return loss, prob

    def feeds(rng):
        f = {"field_%d" % i: rng.randint(0, vocab, (8, 1))
             .astype(np.int64) for i in range(num_fields)}
        f["click"] = rng.randint(0, 2, (8, 1)).astype(np.float32)
        return f

    return build, feeds

