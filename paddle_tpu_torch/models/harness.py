"""Staging a zoo entry's Programs.

The counterpart of ``paddle_tpu/models/harness.py`` for
``staged_programs``. Its ``program_entry`` (the static analyzer's
harness) waits for ROADMAP.md queue 1 item 11, and ``monitored_run`` and
``resilient_run`` for items 10 and 11.
"""


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
