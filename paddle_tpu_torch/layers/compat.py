"""Reference-parity layer wrappers: the two beam-search builders.

The counterpart of ``paddle_tpu/layers/compat.py`` for ``beam_search``
and ``beam_search_decode``, whose ops lower in ``ops/beam_search.py``.
The rest of that module (the sequence, detection, metric and reader
wrappers) comes with the op library (ROADMAP.md, queue 1 item 7).
"""

from .layer_helper import LayerHelper

__all__ = ["beam_search", "beam_search_decode"]


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None):
    """One beam-search step (beam_search_op.cc). `ids` is accepted for
    API parity; selection uses `scores` ([rows, vocab] accumulated
    log-probs when is_accumulated)."""
    helper = LayerHelper("beam_search", name=name)
    sel = helper.create_variable_for_type_inference("int64")
    ssc = helper.create_variable_for_type_inference(scores.dtype)
    par = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="beam_search",
        inputs={"pre_ids": [pre_ids], "pre_scores": [pre_scores],
                "scores": [scores]},
        outputs={"selected_ids": [sel], "selected_scores": [ssc],
                 "parent_idx": [par]},
        attrs={"beam_size": beam_size, "end_id": end_id,
               "is_accumulated": is_accumulated})
    return sel, ssc, par


def beam_search_decode(ids, scores, beam_size, end_id, name=None):
    helper = LayerHelper("beam_search_decode", name=name)
    out_ids = helper.create_variable_for_type_inference("int64")
    out_scores = helper.create_variable_for_type_inference(scores.dtype)
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids], "Scores": [scores]},
        outputs={"SentenceIds": [out_ids],
                 "SentenceScores": [out_scores]},
        attrs={"beam_size": beam_size, "end_id": end_id})
    return out_ids, out_scores
