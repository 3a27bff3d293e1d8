"""LoDTensor: batches of nested variable-length sequences.

The counterpart of ``paddle_tpu/core/lod.py`` (a copy: the module is
numpy only). Ragged sequences are held as one flat row buffer plus the
reference's Level-of-Detail offset table; the Executor feeds sequence
ops the per-sequence LENGTHS as ``<name>@LOD`` (an int32 tensor on the
executor's device) beside the flat rows, bucketed to a power-of-two
total (``core/executor._normalize_feeds``)."""

import numpy as np


class LoDTensor:
    """data: np.ndarray (padded on axis 0 = flattened time dim or batch),
    lod: list of offset vectors, outermost first (reference convention)."""

    def __init__(self, data=None, lod=None):
        self.data = None if data is None else np.asarray(data)
        self.lod = [list(map(int, level)) for level in (lod or [])]

    # -- reference API -------------------------------------------------------
    def set(self, data, place=None):
        self.data = np.asarray(data)

    def set_lod(self, lod):
        self.lod = [list(map(int, level)) for level in lod]

    def set_recursive_sequence_lengths(self, lengths):
        self.lod = [_lengths_to_offsets(lv) for lv in lengths]

    def recursive_sequence_lengths(self):
        return [_offsets_to_lengths(lv) for lv in self.lod]

    def shape(self):
        return tuple(self.data.shape)

    def __array__(self, dtype=None):
        return np.asarray(self.data, dtype=dtype)

    def __repr__(self):
        return "LoDTensor(shape=%s, lod=%s)" % (
            None if self.data is None else self.data.shape, self.lod)

    # -- sequence helpers ----------------------------------------------------
    def sequence_lengths(self):
        """Innermost-level lengths (sequence count view)."""
        if not self.lod:
            return [self.data.shape[0]] if self.data is not None else []
        return _offsets_to_lengths(self.lod[-1])

    def num_sequences(self):
        if not self.lod:
            return self.data.shape[0] if self.data is not None else 0
        return len(self.lod[0]) - 1


def _lengths_to_offsets(lengths):
    out = [0]
    for ln in lengths:
        out.append(out[-1] + int(ln))
    return out


def _offsets_to_lengths(offsets):
    return [offsets[i + 1] - offsets[i] for i in range(len(offsets) - 1)]


def create_lod_tensor(data, recursive_seq_lens=None, place=None):
    """Reference fluid.create_lod_tensor parity: build from a flat array (or a
    list of per-sequence arrays) + nested lengths."""
    if isinstance(data, (list, tuple)) and data and not np.isscalar(data[0]):
        seqs = [np.asarray(s) for s in data]
        lengths = [[len(s) for s in seqs]]
        flat = np.concatenate(seqs, axis=0)
        t = LoDTensor(flat)
        t.set_recursive_sequence_lengths(recursive_seq_lens or lengths)
        return t
    t = LoDTensor(np.asarray(data))
    if recursive_seq_lens:
        t.set_recursive_sequence_lengths(recursive_seq_lens)
    return t


def pack_sequences(seqs, pad_value=0, dtype=None, time_major=False,
                   maxlen=None):
    """Ragged list of [T_i, ...] arrays → (padded [B, T, ...], lengths [B]).

    This is the bucketing/padding pass SURVEY.md §5.7 calls for: the static-
    shape representation the RNN and padding ops consume."""
    seqs = [np.asarray(s) for s in seqs]
    if dtype is None:
        dtype = seqs[0].dtype
    maxlen = maxlen or max((s.shape[0] for s in seqs), default=0)
    batch = len(seqs)
    trailing = seqs[0].shape[1:] if seqs else ()
    out = np.full((batch, maxlen) + tuple(trailing), pad_value, dtype=dtype)
    lengths = np.zeros((batch,), np.int32)
    for i, s in enumerate(seqs):
        t = min(s.shape[0], maxlen)
        out[i, :t] = s[:t]
        lengths[i] = t
    if time_major:
        out = np.moveaxis(out, 0, 1)
    return out, lengths


def unpack_sequences(padded, lengths):
    """Inverse of pack_sequences → list of ragged arrays."""
    return [np.asarray(padded[i, :int(l)]) for i, l in enumerate(lengths)]


def lod_to_segment_ids(lengths, total):
    """lengths [B] → segment id per flattened timestep (size `total`).
    Segment ids are the encoding of LoD for sequence_* ops."""
    lengths = np.asarray(lengths, np.int64)
    ids = np.repeat(np.arange(len(lengths)), lengths)
    if len(ids) < total:
        ids = np.concatenate([ids, np.full(total - len(ids), -1, ids.dtype)])
    return ids
