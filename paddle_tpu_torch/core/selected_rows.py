"""SelectedRows: a sparse row-slice value.

The counterpart of ``paddle_tpu/core/selected_rows.py``
(framework/selected_rows.h:27): ``height`` rows of which only ``rows``
are held, as the rows of ``value``. ``rows`` is an int64 tensor and
``value`` a tensor, both on the executor's device. It is the gradient
format of the sparse optimizer branches (``sgd``, lazy ``adam``) and
the value the SelectedRows host ops (``distributed/ops.py``) pass
around; ``lookup_table``'s own gradient stays dense, as in the JAX
package on one device.
"""

import numpy as np
import torch

__all__ = ["SelectedRows"]


class SelectedRows:
    def __init__(self, rows=None, value=None, height=0):
        value = torch.zeros((0, 0), dtype=torch.float32) if value is None \
            else torch.as_tensor(value)
        rows = torch.as_tensor(rows if rows is not None else [],
                               dtype=torch.int64)
        self.rows = rows.reshape(-1).to(value.device)
        self.value = value
        self.height = int(height)

    @property
    def device(self):
        return self.value.device

    def to(self, device, dtype=None):
        """A copy on ``device`` (the value cast to ``dtype`` when
        given)."""
        return SelectedRows(self.rows.to(device),
                            self.value.to(device=device, dtype=dtype),
                            self.height)

    def detach(self):
        return SelectedRows(self.rows, self.value.detach(), self.height)

    def to_dense(self, width=None):
        """[height, width] with each held row added into its place
        (duplicates summed)."""
        width = width or (self.value.shape[1] if self.value.dim() > 1 else 1)
        out = torch.zeros((self.height, width), dtype=self.value.dtype,
                          device=self.device)
        return out.index_put((self.rows,), self.value.reshape(-1, width),
                             accumulate=True)

    @staticmethod
    def from_dense(dense, rows=None):
        """The rows of ``dense`` at ``rows``, or at every row with a
        nonzero entry."""
        dense = torch.as_tensor(dense)
        if rows is None:
            rows = torch.nonzero(torch.abs(dense).sum(
                dim=tuple(range(1, dense.dim())))).reshape(-1)
        rows = torch.as_tensor(rows, dtype=torch.int64, device=dense.device)
        return SelectedRows(rows, dense[rows], dense.shape[0])

    def merge(self, other):
        """Row-wise add (math/selected_rows_functor merge_add): the
        sorted union of both row sets, duplicates summed."""
        assert self.height == other.height
        return merge_rows(torch.cat([self.rows, other.rows.to(self.device)]),
                          torch.cat([self.value,
                                     other.value.to(self.device)], dim=0),
                          self.height)

    def numpy(self):
        """(rows, value) as numpy arrays."""
        return (self.rows.cpu().numpy(),
                self.value.detach().cpu().numpy())

    def __repr__(self):
        return "SelectedRows(height=%d, nrows=%d, width=%s)" % (
            self.height, len(self.rows),
            tuple(self.value.shape[1:]) if self.value.dim() > 1 else 1)


def merge_rows(rows, value, height):
    """A SelectedRows of the sorted unique ``rows``, each row's values
    summed (``np.add.at`` in the JAX package; ``index_put`` with
    accumulation here: on the card it sums a row's duplicates in their
    order after a stable sort, on the CPU its parallel path adds them in
    no fixed order)."""
    uniq, inv = torch.unique(rows, sorted=True, return_inverse=True)
    out = torch.zeros((uniq.shape[0],) + tuple(value.shape[1:]),
                      dtype=value.dtype, device=value.device)
    return SelectedRows(uniq, out.index_put((inv,), value, accumulate=True),
                        height)


def as_selected_rows(value, device):
    """``value`` as the port's SelectedRows on ``device``: one of the
    port's, or any object with numpy ``rows``, ``value`` and ``height``
    (the JAX package's)."""
    if isinstance(value, SelectedRows):
        return value.to(device)
    return SelectedRows(torch.from_numpy(np.asarray(value.rows, np.int64)),
                        torch.from_numpy(np.ascontiguousarray(
                            np.asarray(value.value))), value.height
                        ).to(device)
