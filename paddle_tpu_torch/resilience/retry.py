"""Bounded-retry policy for the distributed clients.

The port's copy of ``paddle_tpu/resilience/retry.py`` (pure Python).

``Policy`` is bounded exponential backoff with seeded jitter and a
total wall-clock deadline. RPCClient and MasterClient run their
IDEMPOTENT verbs through it (``retry=Policy(...)``): on a socket error
the client drops its connections, sleeps the backoff, reconnects —
optionally through an endpoint ``resolver``, so a REPLACEMENT pserver
(a new incarnation recovered from its checkpoint after a membership
lease expiry, possibly at a new port) is picked up transparently — and
re-issues the verb. Idempotency is what makes this safe:

  * GET / PRFT / PUT are idempotent by definition;
  * tagged SEND / BARR are exactly-once server-side (rpc.py replaces a
    retried (name, tag) send and dedups a counted barrier tag);
  * UNTAGGED SEND / BARR are NOT retried — a blind re-send would
    double-accumulate a gradient.

Non-socket errors (StaleIncarnationError, protocol assertions) always
propagate: they need the caller's semantics, not a blind retry.

Every retry/reconnect bumps a monitor counter and, when a flight
recorder is armed, writes a ``retry`` / ``reconnect`` event.
"""

import os
import random
import time

from ..monitor import runtime as _mon

__all__ = ["Policy", "default_policy", "RETRYABLE", "VERB_CLASSES"]

# TimeoutError covers socket.timeout (an alias since 3.10); both are
# OSError subclasses, listed for readers, matched as one family.
RETRYABLE = (ConnectionError, TimeoutError, OSError)

# The retry-idempotence contract, one entry per request verb — the
# machine-readable form of the rules the clients implement by hand
# (RPCClient._retrying call sites, MasterClient, ReplicaClient's
# journal dedup). `python -m paddle_tpu.analysis --runtime`
# (verb-conformance) checks every dispatch loop's verbs against this
# table, so a new verb MUST take a position on re-issue safety:
#
#   idempotent     blind re-issue after a lost reply is safe (reads,
#                  last-writer-wins puts, journal-deduped fleet verbs)
#   round_tag      safe ONLY when carrying a ROUND-format tag the
#                  server dedups (untagged SEND/BARR double-applies)
#   nonretryable   never re-issued blindly (CAS/CAD: a lost reply
#                  leaves compare-and-X outcomes ambiguous; CHNK:
#                  side-stream parts are re-sent by the commit SEND)
#   admin          connection/shutdown control, excluded from fault
#                  injection and retry alike
VERB_CLASSES = {
    # pserver (distributed/rpc.py)
    "SEND": "round_tag", "BARR": "round_tag",
    "PUT": "idempotent", "GET": "idempotent", "PRFT": "idempotent",
    "CHNK": "nonretryable",
    # master task queue (distributed/master.py)
    "GETT": "idempotent", "DONE": "idempotent", "FAIL": "idempotent",
    "PING": "idempotent",
    # membership KV (distributed/membership.py; PUT/GET shared above)
    "CAS": "nonretryable", "CAD": "nonretryable",
    "DEL": "idempotent", "LIST": "idempotent", "LEAS": "idempotent",
    # serving fleet (serving/fleet.py): exactly-once via the request
    # journal, so EVERY verb is idempotent by construction
    "SUBM": "idempotent", "POLL": "idempotent", "CANC": "idempotent",
    "STAT": "idempotent",
    # rollout controller (serving/rollout.py): VERD is a read of the
    # current delta-verdict state — safe to re-issue
    "VERD": "idempotent",
    # clock/telemetry/forensics reads served by every dispatcher +
    # shutdown (DUMP is a read-only snapshot: safe to re-issue)
    "CLKS": "idempotent", "METR": "idempotent", "HLTH": "idempotent",
    "DUMP": "idempotent",
    "EXIT": "admin",
}


class Policy:
    """Bounded exponential backoff + seeded jitter + total deadline.

    max_attempts:  total tries of the wrapped call (first one included)
    base_delay:    sleep before the first retry (seconds)
    multiplier:    backoff growth per retry
    max_delay:     per-sleep cap
    jitter:        each sleep is scaled by 1 + jitter*U[0,1)
    deadline:      total wall-clock budget; the next sleep must fit.
                   Note it bounds backoff SCHEDULING, not a single
                   in-flight attempt — the client's socket timeout is
                   what bounds a hung connect/recv.
    seed:          jitter RNG seed (deterministic chaos runs)
    """

    def __init__(self, max_attempts=6, base_delay=0.05, max_delay=2.0,
                 multiplier=2.0, jitter=0.25, deadline=30.0, seed=0):
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline = float(deadline)
        self.seed = int(seed)

    def delays(self):
        """The deterministic backoff sequence (one sleep per retry)."""
        rng = random.Random(self.seed)
        d = self.base_delay
        for _ in range(max(0, self.max_attempts - 1)):
            yield min(d, self.max_delay) * (1.0 + self.jitter
                                            * rng.random())
            d *= self.multiplier

    def run(self, fn, what="rpc", retry_on=RETRYABLE, on_retry=None):
        """Call ``fn()`` with retries. ``on_retry(attempt, exc)`` runs
        before each backoff sleep (the clients drop their dead sockets
        there; reconnection happens inside the next ``fn()`` attempt so
        a refused reconnect counts as a failed attempt, not a crash).

        With paddle_tpu_torch.trace armed and an ambient span open (the
        client's logical verb span), every try runs inside an
        ``<what>.attempt`` child span — a retried GET merges into ONE
        client span with N attempt children, failed attempts carrying
        their error and the reconnect/endpoint annotations from the
        client's _connect."""
        from ..trace import runtime as _trace
        t0 = time.monotonic()
        delays = self.delays()
        attempt = 0
        while True:
            trc = _trace._TRACER
            try:
                if trc is not None and trc.current_span() is not None:
                    with trc.span(what + ".attempt", attempt=attempt + 1):
                        return fn()
                return fn()
            except retry_on as exc:
                attempt += 1
                sleep_s = next(delays, None)
                if sleep_s is None or \
                        time.monotonic() - t0 + sleep_s > self.deadline:
                    raise
                _mon.on_retry(what, attempt, exc)
                _trace.annotate(retries=attempt)
                if on_retry is not None:
                    on_retry(attempt, exc)
                time.sleep(sleep_s)


def default_policy():
    """The flag-driven policy the executor's cached RPC clients use:
    ``rpc_retry`` (bool) gates it, ``rpc_retry_deadline`` bounds it.
    Returns None when retries are off.

    The deadline GOVERNS: max_attempts is set high enough that the
    backoff schedule always reaches the deadline (a handful of attempts
    would otherwise exhaust in ~2 s against a 6 s budget). The jitter
    seed derives from the pid so a fleet of trainers disconnected by
    the same pserver restart does NOT back off in lockstep — the
    deterministic-chaos tests pass their own seeded Policy instead."""
    from .. import flags
    try:
        if not flags.get_flag("rpc_retry"):
            return None
        deadline = float(flags.get_flag("rpc_retry_deadline"))
    except KeyError:
        return None
    return Policy(max_attempts=1000, deadline=deadline,
                  seed=os.getpid())
