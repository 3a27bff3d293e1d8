"""Staging and running a zoo entry's Programs.

The counterpart of ``paddle_tpu/models/harness.py``: ``staged_programs``,
``monitored_run`` (a few steps under the monitor) and ``resilient_run``
(a few steps under ``resilience.resilient_loop``). Both runs take
``place`` (a keyword the JAX package does not have: its harness runs on
the CPU): None is the card, ``CPUPlace()`` the CPU. Its
``program_entry`` (the static analyzer's harness) waits for ROADMAP.md
queue 1 item 11.
"""

import numpy as np


def staged_programs(build_fn, feed_fn):
    """(main, startup, feed_fn, fetch_names), the programs built afresh
    under their own guards. Build only: nothing runs here."""
    from .. import Program, program_guard

    main, startup = Program(), Program()
    with program_guard(main, startup):
        fetch_vars = build_fn()
        if not isinstance(fetch_vars, (tuple, list)):
            fetch_vars = (fetch_vars,)
    return main, startup, feed_fn, [v.name for v in fetch_vars]


def monitored_run(build_fn, feed_fn, steps=3, seed=0, log_path=None,
                  place=None, **enable_kwargs):
    """Run a zoo entry for ``steps`` real Executor steps under
    paddle_tpu_torch.monitor; returns a ``monitor.summary()``-shaped
    dict whose COUNT fields (steps/compiles/recompiles/cache_hits/
    feed_bytes) are deltas for THIS run; latency percentiles and the
    tokens-s gauge reflect the ambient session (last values). Programs
    and scope are fresh. The process-wide registry is never reset; if
    the monitor is ALREADY armed (e.g. PADDLE_TPU_MONITOR=1) the ambient
    session is reused untouched, otherwise one is armed for the call
    and disarmed after."""
    from .. import (Executor, Program, Scope, monitor, program_guard,
                    scope_guard)

    with monitor.session(log_path=log_path, **enable_kwargs) as sess:
        main, startup = Program(), Program()
        scope = Scope()
        with program_guard(main, startup), scope_guard(scope):
            fetch_vars = build_fn()
            if not isinstance(fetch_vars, (tuple, list)):
                fetch_vars = (fetch_vars,)
            exe = Executor(place)
            exe.run(startup)
            rng = np.random.RandomState(seed)
            for _ in range(steps):
                exe.run(main, feed=feed_fn(rng), fetch_list=fetch_vars)
    return sess.summary()


def resilient_run(build_fn, feed_fn, ckpt_dir, steps=8, seed=0,
                  checkpoint_every=2, place=None, **loop_kwargs):
    """Run a zoo entry for ``steps`` real Executor steps under
    ``resilience.driver.resilient_loop``; returns the loop summary
    (steps, rollbacks, resumed_from, losses, ...). Convention: the
    FIRST fetch build_fn returns is the loss the NaN guard watches.
    A fresh program/scope per call; auto-resume means a repeated call
    with the same ckpt_dir restores the previous call's weights before
    training (kill-and-resume in one process)."""
    from .. import Executor, Program, Scope, program_guard, scope_guard
    from ..resilience import resilient_loop

    main, startup = Program(), Program()
    scope = Scope()
    with program_guard(main, startup), scope_guard(scope):
        fetch_vars = build_fn()
        if not isinstance(fetch_vars, (tuple, list)):
            fetch_vars = (fetch_vars,)
        exe = Executor(place)
        exe.run(startup)
        rng = np.random.RandomState(seed)
        batches = [feed_fn(rng) for _ in range(steps)]

        def step_fn(step, feeds):
            outs = exe.run(main, feed=feeds, fetch_list=list(fetch_vars))
            return outs[0]

        return resilient_loop(step_fn, batches, ckpt_dir, program=main,
                              scope=scope,
                              checkpoint_every=checkpoint_every,
                              **loop_kwargs)
