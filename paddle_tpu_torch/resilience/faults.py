"""Deterministic, seeded fault injection for the distributed runtime.

The port's copy of ``paddle_tpu/resilience/faults.py`` (pure Python).

A ``FaultPlan`` is a JSON-able spec of failures to inject, armed
process-wide with ``arm(spec, seed)`` (or ``PADDLE_TPU_FAULTS`` /
``PADDLE_TPU_FAULTS_SEED`` at import — see ``maybe_arm_from_flags``).
Disarmed, every hook site is a single ``is None`` check, so production
paths pay nothing.

Spec keys (all optional)::

    {
      "rpc": {            # distributed/rpc.py _send_msg/_recv_msg hooks
        "drop": 0.02,             # P(frame never sent; conn breaks)
        "close_mid_frame": 0.01,  # P(partial header sent; conn breaks)
        "duplicate": 0.02,        # P(frame sent TWICE; conn breaks)
        "delay": 0.05,            # P(send delayed delay_s)
        "delay_s": 0.01,
        "recv_drop": 0.0,         # P(receiver abandons the frame)
        "recv_delay": 0.0,        # P(receive delayed delay_s)
        "ops": ["SEND", "BARR"],  # default: all request verbs
        "ports": [40123],         # restrict to these server ports
        "max": 25                 # total injection budget
      },
      "kill": [{"target": "pserver", "after": 6}],   # "master",
                                        # "replica" / "replica:<slot>";
                                        # "drain" (after = drains
                                        # started) and "roll" (after =
                                        # replicas replaced) crash the
                                        # cell whose graceful drain is
                                        # just beginning
                                        # (serving.autoscale)
      "stall": [{"target": "replica:1", "after": 4, "seconds": 3.0}],
                                        # one-shot dispatch wedge
      "ckpt": {"nth": 3, "mode": "bitflip"},         # or "truncate"
      "nan":  {"step": 9, "name": "img"}             # one-shot NaN batch
    }

The connection-breaking kinds model a frame lost / torn / delivered
twice followed by a broken connection — precisely the at-least-once
hazard the idempotent round tags (rpc.py SEND/BARR) and the
``resilience.retry`` reconnect path exist for. Decisions are drawn from
per-site ``random.Random(seed ^ crc32(site))`` streams, so the n-th
framing call at a site always sees the same decision regardless of how
threads interleave across sites — a fixed seed gives a reproducible
chaos run.

Every injection bumps ``ptpu_fault_injections_total{kind=...}`` and,
when a flight recorder is armed, writes a ``fault`` event.
"""

import json
import os
import random
import socket
import threading
import time
import zlib

import numpy as np

from ..monitor import runtime as _mon

__all__ = ["FaultPlan", "arm", "disarm", "active", "maybe_arm_from_flags",
           "corrupt_file"]

# request verbs of the rpc/master/kv protocols; replies (OK/VAL/...)
# are excluded by default so a plan faults requests unless it opts in.
# Every dispatch loop's verbs must appear here (or be classified
# 'admin' in resilience.retry.VERB_CLASSES) — enforced by
# `python -m paddle_tpu.analysis --runtime` (verb-conformance).
_DEFAULT_OPS = frozenset({
    "SEND", "PUT", "GET", "PRFT", "BARR", "CHNK",        # pserver
    "GETT", "DONE", "FAIL", "PING",                      # master
    "CAS", "DEL", "CAD", "LIST", "LEAS",                 # kv store
    "SUBM", "POLL", "CANC", "STAT",                      # serving fleet
    "VERD",                           # rollout verdict (serving/rollout)
    "CLKS", "METR", "HLTH", "DUMP",   # clock/telemetry/forensics
                                      # (every dispatcher)
})

_SEND_KINDS = ("drop", "close_mid_frame", "duplicate", "delay")
_RECV_KINDS = ("recv_drop", "recv_delay")


class FaultPlan:
    """One armed fault plan (see module docstring for the spec)."""

    def __init__(self, spec=None, seed=0):
        if isinstance(spec, str):
            spec = spec.strip()
            if spec.startswith("@"):
                with open(spec[1:]) as f:
                    spec = json.load(f)
            else:
                spec = json.loads(spec) if spec else {}
        self.spec = dict(spec or {})
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._rngs = {}                      # site -> random.Random
        self.trips = []                      # [(kind, site), ...]

        rpc = dict(self.spec.get("rpc") or {})
        self._rpc = rpc
        self._rpc_ops = (frozenset(rpc["ops"]) if rpc.get("ops")
                         else _DEFAULT_OPS)
        ports = rpc.get("ports")
        self._rpc_ports = (frozenset(int(p) for p in ports)
                           if ports else None)
        self._rpc_budget = int(rpc.get("max", 1 << 30))
        self._kills = [dict(k) for k in (self.spec.get("kill") or ())]
        self._stalls = [dict(k) for k in (self.spec.get("stall") or ())]
        self._ckpt = dict(self.spec.get("ckpt") or {})
        self._ckpt_count = 0
        self._nan = dict(self.spec.get("nan") or {})
        self._nan_done = False

    # -- internals ---------------------------------------------------------
    def _rng(self, site):
        # under self._lock
        r = self._rngs.get(site)
        if r is None:
            r = self._rngs[site] = random.Random(
                self.seed ^ zlib.crc32(site.encode()))
        return r

    def _port_ok(self, sock):
        if self._rpc_ports is None:
            return True
        try:
            ports = {sock.getpeername()[1], sock.getsockname()[1]}
        except OSError:
            return False
        return bool(ports & self._rpc_ports)

    def _draw(self, site, kinds):
        """One decision for this framing call: the injected kind, or
        None. Mutually exclusive draw over the plan's probabilities."""
        with self._lock:
            if self._rpc_budget <= 0:
                return None
            u = self._rng(site).random()
            acc = 0.0
            for kind in kinds:
                acc += float(self._rpc.get(kind, 0.0))
                if u < acc:
                    self._rpc_budget -= 1
                    self.trips.append((kind, site))
                    break
            else:
                return None
        _mon.on_fault(kind, site)
        return kind

    @staticmethod
    def _break_conn(sock, kind, op):
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass
        raise ConnectionError("injected fault: %s on %s" % (kind, op))

    # -- rpc framing hooks (called from distributed/rpc.py) ----------------
    def on_send(self, sock, op, frame):
        """May sleep (delay), or perform the faulty wire behavior itself
        and raise ConnectionError (drop / close_mid_frame / duplicate).
        Returning normally means the caller proceeds with the real send."""
        if not self._rpc or op not in self._rpc_ops \
                or not self._port_ok(sock):
            return
        kind = self._draw("send:" + op, _SEND_KINDS)
        if kind is None:
            return
        if kind == "delay":
            time.sleep(float(self._rpc.get("delay_s", 0.01)))
            return
        from ..distributed.rpc import _sendall_parts
        try:
            if kind == "duplicate":
                _sendall_parts(sock, frame)
                _sendall_parts(sock, frame)
            elif kind == "close_mid_frame":
                head = bytes(frame[0])
                sock.sendall(head[:max(1, len(head) // 2)])
            # drop: nothing reaches the wire
        except OSError:
            pass
        self._break_conn(sock, kind, op)

    def on_recv(self, sock):
        """Receive-side hook: delay, or abandon the frame (close + raise
        ConnectionError) before any bytes are read."""
        if not self._rpc or not self._port_ok(sock):
            return
        kind = self._draw("recv", _RECV_KINDS)
        if kind is None:
            return
        if kind == "recv_delay":
            time.sleep(float(self._rpc.get("delay_s", 0.01)))
            return
        self._break_conn(sock, kind, "recv")

    # -- kill-switches -----------------------------------------------------
    def has_kill(self, target):
        return any(k.get("target") == target for k in self._kills)

    def should_kill(self, target, value):
        """One-shot: True exactly once, when ``value`` (rounds applied,
        tasks done, ...) reaches the plan's ``after`` threshold."""
        with self._lock:
            for k in self._kills:
                if k.get("target") == target and not k.get("_fired") \
                        and value >= int(k.get("after", 0)):
                    k["_fired"] = True
                    self.trips.append(("kill", target))
                    break
            else:
                return False
        _mon.on_fault("kill", target)
        return True

    def should_stall(self, target, value):
        """One-shot wedge: returns the stall duration in seconds exactly
        once, when ``value`` reaches the plan's ``after`` threshold for
        this target; 0.0 otherwise. Models a live-but-unresponsive
        process (GC pause, runaway compile, wedged device): the lease
        keeps beating, so only a response-deadline watchdog — not lease
        expiry — can evict the member."""
        with self._lock:
            for k in self._stalls:
                if k.get("target") == target and not k.get("_fired") \
                        and value >= int(k.get("after", 0)):
                    k["_fired"] = True
                    self.trips.append(("stall", target))
                    secs = float(k.get("seconds", 1.0))
                    break
            else:
                return 0.0
        _mon.on_fault("stall", target)
        return secs

    # -- checkpoint corruption --------------------------------------------
    def maybe_corrupt_checkpoint(self, blob_path):
        """Called by io.write_checkpoint_arrays after a (blob, meta)
        pair lands: corrupts the n-th written blob on disk so the CRC
        recovery fallback is exercised. Returns True when it fired."""
        if not self._ckpt:
            return False
        with self._lock:
            self._ckpt_count += 1
            if self._ckpt_count != int(self._ckpt.get("nth", 1)):
                return False
            self.trips.append(("ckpt_corrupt",
                               os.path.basename(blob_path)))
        corrupt_file(blob_path, self._ckpt.get("mode", "bitflip"),
                     seed=self.seed)
        _mon.on_fault("ckpt_corrupt", os.path.basename(blob_path))
        return True

    # -- NaN batch ---------------------------------------------------------
    def maybe_poison_feeds(self, step, feeds):
        """One-shot NaN injection: at the plan's step, returns a COPY of
        ``feeds`` with NaNs written into the named (or first float)
        array — the poison propagates to the loss and every gradient,
        which is what the resilient_loop guard must catch."""
        if not self._nan or self._nan_done \
                or step != int(self._nan.get("step", -1)):
            return feeds
        with self._lock:
            if self._nan_done:
                return feeds
            self._nan_done = True
        name = self._nan.get("name")
        if name is not None and (name not in feeds or not np.issubdtype(
                np.asarray(feeds[name]).dtype, np.floating)):
            name = None       # int feeds can't carry NaN: auto-pick
        if name is None:
            for k in sorted(feeds):
                arr = np.asarray(feeds[k])
                if np.issubdtype(arr.dtype, np.floating):
                    name = k
                    break
        if name is None:
            return feeds
        out = dict(feeds)
        arr = np.array(out[name], copy=True)
        arr.reshape(-1)[:: max(1, arr.size // 4)] = np.nan
        out[name] = arr
        with self._lock:
            self.trips.append(("nan", name))
        _mon.on_fault("nan", name)
        return out


def corrupt_file(path, mode="bitflip", seed=0):
    """Corrupt a blob on disk the way real storage does: ``truncate``
    (torn write — the tail is gone) or ``bitflip`` (media error — one
    byte inverted at a seeded offset). Used by the armed plan and
    directly by the corrupt-checkpoint tests."""
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        return
    off = random.Random(seed).randrange(max(1, size))
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")


# -- process-wide arming ---------------------------------------------------

_ACTIVE = None


def arm(spec=None, seed=0):
    """Arm a fault plan process-wide; returns the FaultPlan (exposing
    ``.trips`` for assertions). Re-arming replaces the previous plan."""
    global _ACTIVE
    plan = spec if isinstance(spec, FaultPlan) else FaultPlan(spec, seed)
    _ACTIVE = plan
    return plan


def disarm():
    global _ACTIVE
    _ACTIVE = None


def active():
    return _ACTIVE


def maybe_arm_from_flags():
    """Flag-driven arming (called from package import):
    ``PADDLE_TPU_FAULTS`` carries the JSON spec (or ``@path``) and
    ``PADDLE_TPU_FAULTS_SEED`` the decision seed."""
    from .. import flags
    try:
        spec = flags.get_flag("faults")
    except KeyError:
        return None
    if not spec:
        return None
    return arm(spec, seed=flags.get_flag("faults_seed"))
