"""The distributed tier's host ops that need no wire: the SelectedRows
ops (``ops.py``). The wire ops (send, recv, prefetch, listen_and_serv,
...) and the parameter server wait for ROADMAP.md queue 1 item 10."""

from . import ops  # noqa: F401  (registers the host ops)
