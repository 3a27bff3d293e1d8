"""NTP-style clock-offset estimation over RPC round trips.

The port's copy of ``paddle_tpu/trace/clock.py`` (pure Python).

Two processes' span logs carry ``time.time()`` timestamps from two
unsynchronized clocks; nesting a server span inside its client span in
the merged timeline needs the relative offset. The midpoint method:
the client stamps t0 (just before send) and t3 (just after the reply),
the server stamps its own clock ``ts`` while handling the probe
(the CLKS verb, distributed/rpc.py). Assuming symmetric network legs,
the server handled the probe at client-clock (t0+t3)/2, so

    offset = ts - (t0 + t3) / 2        (server clock minus client's)

with uncertainty bounded by half the round-trip time. Clients sample
periodically per peer (Tracer.clock_due) and record each sample as a
``clock`` row; the merge picks the minimum-RTT sample per edge (the
tightest bound) and chains offsets across processes that never talked
directly.
"""

import time

__all__ = ["midpoint_offset", "probe"]


def midpoint_offset(t0, server_t, t3):
    """(offset, rtt) from one probe's three timestamps (midpoint
    method). ``offset`` is the server clock minus the client clock."""
    return server_t - (t0 + t3) / 2.0, t3 - t0


def probe(trc, peer, exchange):
    """One rate-limited probe against ``peer``: ``exchange()`` performs
    the CLKS round trip on an IDLE client connection and returns the
    server's epoch seconds (or None on a non-OK reply). Records a
    ``clock`` row; returns the offset or None. Socket errors propagate
    — the caller owns the connection and must drop it (a half-done
    probe leaves the stream desynced)."""
    if not trc.clock_due(peer):
        return None
    t0 = time.time()
    server_t = exchange()
    t3 = time.time()
    if server_t is None:
        return None
    offset, rtt = midpoint_offset(t0, float(server_t), t3)
    trc.record_clock(peer, offset, rtt)
    return offset
