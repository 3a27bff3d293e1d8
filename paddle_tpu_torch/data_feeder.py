"""DataFeeder: minibatch rows → feed dict.

The counterpart of ``paddle_tpu/data_feeder.py`` (a copy over the port's
``core.lod`` and ``core.program``): it returns host numpy arrays and
LoDTensors, and the Executor (or ``reader.DeviceLoader``) uploads them.
Reference parity: python/paddle/fluid/data_feeder.py:69 — converts a list of
sample tuples (one element per feed var) into arrays/LoDTensors keyed by var
name. LoD-level>0 vars become padded arrays + `<name>@LOD` length vectors
(the TPU static-shape representation, see core/lod.py).
"""

import numpy as np

from .core.lod import LoDTensor
from .core.program import Variable, convert_dtype, default_main_program


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.place = place
        program = program or default_main_program()
        self.feed_vars = []
        for v in feed_list:
            if isinstance(v, str):
                v = program.global_block().var(v)
            self.feed_vars.append(v)

    def feed(self, iterable):
        """iterable: list of sample tuples. Returns {var name: array|LoDTensor}."""
        columns = list(zip(*iterable)) if iterable else \
            [[] for _ in self.feed_vars]
        out = {}
        for var, col in zip(self.feed_vars, columns):
            dtype = np.dtype(convert_dtype(var.dtype))
            if var.lod_level and var.lod_level > 0:
                seqs = [np.asarray(s, dtype=dtype) for s in col]
                if seqs and seqs[0].ndim == 0:
                    seqs = [s.reshape(1) for s in seqs]
                # FLAT concatenated rows [sum(Ti), ...] + lengths — the one
                # LoD representation every sequence op consumes (same as
                # create_lod_tensor; ops read `<name>@LOD` for boundaries)
                flat = np.concatenate(seqs, axis=0) if seqs else \
                    np.zeros((0,), dtype)
                if flat.ndim == 1 and var.shape and \
                        len(var.shape) >= 1 and int(var.shape[-1]) == 1:
                    flat = flat.reshape(-1, 1)   # [T] ids -> [T, 1]
                t = LoDTensor(flat)
                t.set_recursive_sequence_lengths(
                    [[len(s) for s in seqs]])
                out[var.name] = t
            else:
                arr = np.asarray(col, dtype=dtype)
                shape = var.shape
                if shape is not None:
                    want = [len(col)] + [int(s) for s in shape[1:]]
                    if -1 not in want and list(arr.shape) != want:
                        arr = arr.reshape(want)
                    elif arr.ndim == 1 and len(shape) > 1:
                        arr = arr.reshape(len(col), -1)
                out[var.name] = arr
        return out

    def feed_parallel(self, iterable, num_places):
        """Split one batch into per-device sub-batches (SplitLoDTensor
        equivalent, lod_tensor.h:149: WHOLE sequences go to one device).

        Dense feeds split on the batch axis; flat LoD feeds split on the
        SEQUENCE axis — each device gets its sequences' contiguous rows
        plus a matching lengths LoDTensor, never a mid-sequence cut."""
        full = self.feed(iterable)
        outs = [dict() for _ in range(num_places)]
        for name, val in full.items():
            if isinstance(val, LoDTensor) and val.lod:
                lengths = val.recursive_sequence_lengths()[-1]
                seq_chunks = np.array_split(np.arange(len(lengths)),
                                            num_places)
                starts = np.cumsum([0] + list(lengths))
                for i, seqs in enumerate(seq_chunks):
                    if len(seqs):
                        lo = starts[seqs[0]]
                        hi = starts[seqs[-1] + 1]
                        part = val.data[lo:hi]
                        part_lens = [lengths[s] for s in seqs]
                    else:
                        part = val.data[:0]
                        part_lens = []
                    t = LoDTensor(part)
                    t.set_recursive_sequence_lengths([part_lens])
                    outs[i][name] = t
            else:
                arr = val.data if isinstance(val, LoDTensor) else val
                for i, c in enumerate(np.array_split(arr, num_places)):
                    outs[i][name] = c
        return outs
