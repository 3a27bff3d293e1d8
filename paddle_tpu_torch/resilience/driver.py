"""``resilient_loop`` — the self-healing training driver.

The port's copy of ``paddle_tpu/resilience/driver.py``, over the port's
Executor and ``io``: the snapshot copies each persistable off its
device to the host, and a rollback loads the checkpoint back onto the
device each scope value lives on.

Composes the pieces the distributed layer provides but nothing wired
together before: periodic checkpointing OFF the step path (a background
writer thread gets an array snapshot; the step never waits on fsync),
auto-resume from the newest VALID checkpoint at startup (corrupt ones
are skipped by CRC, io.load_checkpoint semantics), and a NaN/Inf guard
that ROLLS BACK to the last checkpoint and skips the poisoned batch
instead of dying (the go/pserver recovery stance applied to numerics).

    summary = resilient_loop(step_fn, batches, ckpt_dir,
                             program=main, scope=scope,
                             checkpoint_every=20)

``step_fn(step, feeds)`` runs one training step and returns the loss
(scalar, or a sequence whose first element is the loss). ``batches``
iterates feed dicts — on auto-resume it is treated as the REMAINING
work (a master task queue naturally has this shape; a fresh local
iterable simply re-trains from the restored weights). An armed
``resilience.faults`` plan poisons feeds here (the one-shot NaN batch),
so the guard is exercised by the same mechanism production would see.

Rollback reloads the newest valid checkpoint into ``scope`` — losing
at most ``checkpoint_every`` steps of progress — then SKIPS the
poisoned batch. ``on_rollback(step)`` lets a distributed trainer
re-push the restored parameters to its pservers (the trainer scope is
the source of truth after a rollback). More than ``max_rollbacks``
trips raises: a loop that cannot stay finite must fail loudly, not
grind checkpoints forever.
"""

import queue
import threading

import numpy as np
import torch

from ..monitor import runtime as _mon

__all__ = ["resilient_loop"]


class _CkptWriter:
    """One background writer: the step thread hands over an array
    snapshot (a cheap host copy) and keeps training; np.savez + fsync
    happen here. A snapshot arriving while the previous write is still
    in flight is DROPPED (recorded as skipped) — checkpointing must
    never backpressure the step path."""

    def __init__(self, dirname, keep_last):
        self.dirname = dirname
        self.keep_last = keep_last
        self.written = 0
        self.skipped = 0
        self.error = None
        self._q = queue.Queue(maxsize=1)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ptpu-ckpt-writer")
        self._thread.start()

    def _run(self):
        from .. import io as _io
        while True:
            item = self._q.get()
            if item is None:
                return
            step, arrays = item
            try:
                path = _io.write_checkpoint_arrays(
                    self.dirname, step, arrays, keep_last=self.keep_last)
                self.written += 1
                _mon.on_checkpoint(step, path, mode="background")
            except Exception as e:   # never kill training over telemetry
                self.error = e

    def submit(self, step, arrays):
        try:
            self._q.put_nowait((step, arrays))
            return True
        except queue.Full:
            self.skipped += 1
            _mon.on_checkpoint(step, None, mode="skipped_busy")
            return False

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=30.0)


def _snapshot_arrays(program, scope):
    """Host copies of every persistable var with a value — same
    collection rule as io.save_checkpoint, but decoupled from the write
    so the copy happens at a step boundary and the fsync elsewhere."""
    from .. import io as _io
    arrays = {}
    for v in program.list_vars():
        if v.persistable:
            val = scope.find_var(v.name)
            if val is not None:
                arrays[v.name] = np.array(_io._host(scope, v.name),
                                          copy=True)
    return arrays


def _loss_of(out):
    if isinstance(out, (tuple, list)):
        out = out[0]
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


def resilient_loop(step_fn, batches, ckpt_dir, program=None, scope=None,
                   checkpoint_every=20, keep_last=3, max_rollbacks=8,
                   background=True, resume=True, on_rollback=None):
    """Run ``step_fn`` over ``batches`` under checkpoint/rollback
    protection; returns a summary dict (steps, rollbacks, skipped
    steps, resumed_from, checkpoints, losses, final_loss).

    checkpoint_every: steps between checkpoints (also the rollback
                      blast radius). The loop always writes a step-0
                      baseline checkpoint synchronously if it has
                      nothing to resume from — the NaN guard must
                      always have a rollback target.
    background:       write checkpoints on the writer thread (True) or
                      inline (False, deterministic tests).
    resume:           load the newest valid checkpoint into ``scope``
                      before training and continue step numbering from
                      it.
    """
    from .. import io as _io
    from ..core.program import default_main_program
    from ..core.scope import global_scope
    from . import faults as _faults

    program = program or default_main_program()
    scope = scope or global_scope()
    if checkpoint_every < 1:
        raise ValueError("checkpoint_every must be >= 1")

    step = 0
    resumed_from = None
    if resume:
        got = _io.load_checkpoint(ckpt_dir, program, scope)
        if got is not None:
            resumed_from = got
            step = got + 1
            _mon.on_resume(got)
    if resumed_from is None:
        # baseline rollback target (synchronous: must exist before any
        # step can poison the weights)
        _io.write_checkpoint_arrays(ckpt_dir, step,
                                    _snapshot_arrays(program, scope),
                                    keep_last=keep_last)
        _mon.on_checkpoint(step, ckpt_dir, mode="baseline")

    writer = _CkptWriter(ckpt_dir, keep_last) if background else None
    rollbacks = 0
    skipped = []
    losses = []
    sync_ckpts = 0
    try:
        for feeds in batches:
            plan = _faults._ACTIVE
            if plan is not None:
                feeds = plan.maybe_poison_feeds(step, feeds)
            loss = _loss_of(step_fn(step, feeds))
            if not np.all(np.isfinite(loss)):
                rollbacks += 1
                _mon.on_rollback(step, "nan")
                if rollbacks > max_rollbacks:
                    raise FloatingPointError(
                        "resilient_loop: %d NaN/Inf rollbacks (> %d) — "
                        "the model is diverging, not hitting stray bad "
                        "batches" % (rollbacks, max_rollbacks))
                got = _io.load_checkpoint(ckpt_dir, program, scope)
                if got is None:
                    raise FloatingPointError(
                        "resilient_loop: NaN/Inf at step %d and no "
                        "valid checkpoint to roll back to" % step)
                if on_rollback is not None:
                    on_rollback(step)
                skipped.append(step)
                step += 1
                continue
            losses.append(float(np.asarray(loss).reshape(-1)[0]))
            if (step + 1) % checkpoint_every == 0:
                arrays = _snapshot_arrays(program, scope)
                if writer is not None:
                    writer.submit(step, arrays)
                else:
                    path = _io.write_checkpoint_arrays(
                        ckpt_dir, step, arrays, keep_last=keep_last)
                    sync_ckpts += 1
                    _mon.on_checkpoint(step, path, mode="sync")
            step += 1
    finally:
        if writer is not None:
            writer.close()
    if writer is not None and writer.error is not None:
        raise writer.error
    return {
        "steps": len(losses),
        "start_step": (resumed_from + 1) if resumed_from is not None
                      else 0,
        "resumed_from": resumed_from,
        "rollbacks": rollbacks,
        "skipped_steps": skipped,
        "checkpoints": (writer.written if writer is not None
                        else sync_ckpts),
        "checkpoints_skipped_busy": (writer.skipped if writer is not None
                                     else 0),
        "losses": losses,
        "final_loss": losses[-1] if losses else None,
    }
