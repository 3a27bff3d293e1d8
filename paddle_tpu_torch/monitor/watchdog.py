"""Stall watchdog: dumps every thread's stack when training stops
stepping.

The port's copy of ``paddle_tpu/monitor/watchdog.py`` (pure Python).

A hung collective, a deadlocked pserver barrier, or a wedged host-op
thread shows up as "no step completed for N seconds" long before anyone
can attach a debugger. The watchdog is a daemon thread that checks a
liveness timestamp (touched by every completed step AND every compile —
a first XLA compile legitimately takes minutes) and, past the deadline,
writes a ``stall`` event carrying all thread stacks plus a full metrics
snapshot to the flight recorder and stderr. It fires ONCE per stall and
re-arms when stepping resumes, so a long hang produces one loud report,
not a spam loop.
"""

import sys
import threading
import time
import traceback

__all__ = ["Watchdog", "thread_stacks"]


def thread_stacks():
    """{thread_name/ident: [stack lines]} for every live thread."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for ident, frame in sys._current_frames().items():
        label = "%s(%d)" % (names.get(ident, "?"), ident)
        out[label] = [ln.rstrip("\n")
                      for ln in traceback.format_stack(frame)]
    return out


class Watchdog:
    def __init__(self, deadline_s, on_stall, check_interval=None):
        """on_stall(idle_seconds, stacks_dict) is invoked from the
        watchdog thread on each NEW stall."""
        self.deadline_s = float(deadline_s)
        self.on_stall = on_stall
        self._interval = check_interval or min(
            1.0, max(0.05, self.deadline_s / 4.0))
        self._last = time.monotonic()
        # the countdown ARMS on the first touch (first step/compile):
        # pre-training setup (dataset download, preprocessing) longer
        # than the deadline must not read as a stall
        self._armed = False
        self._fired = False
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.stall_count = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ptpu-monitor-watchdog")

    def start(self):
        self._thread.start()
        return self

    def touch(self):
        """Mark liveness (called on every step / compile completion)."""
        with self._lock:
            self._last = time.monotonic()
            self._armed = True
            self._fired = False

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2 * self._interval + 1.0)

    def _run(self):
        while not self._stop.wait(self._interval):
            with self._lock:
                idle = time.monotonic() - self._last
                should_fire = self._armed and idle > self.deadline_s \
                    and not self._fired
                if should_fire:
                    self._fired = True
                    self.stall_count += 1
            if should_fire:
                try:
                    self.on_stall(idle, thread_stacks())
                except Exception:
                    # the watchdog must never take the process down
                    traceback.print_exc(file=sys.stderr)
