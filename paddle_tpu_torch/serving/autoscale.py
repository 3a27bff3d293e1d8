"""Elastic serving fleet: the autoscale control loop —
scale-hint-driven replica count, graceful drain, and chaos-gated
rolling weight updates.

The port's copy of ``paddle_tpu/serving/autoscale.py`` (replicas boot
from a ``save_lm_artifact`` directory through the port's
``Engine(<dir>)``).

ROADMAP direction 1(a)+(b) composed from seams that already exist:

  * the signal plane's typed autoscaling input —
    ``Signals.scale_hint()`` returns ``(direction, magnitude, reason)``; the ``Autoscaler`` installs
    itself as the evaluator's ``scale_hook`` (the capture-hook
    pattern) and moves a ``desired`` replica count within
    ``[min_replicas, max_replicas]`` under a cooldown,
  * the artifact's cold-boot seam — scale-UP spawns ``fleet.Replica`` cells
    booting from a ``save_inference_model`` artifact directory (no
    in-process model-object sharing; a fresh cell rebuilds the model
    from the CRC-manifested artifact exactly like a fresh process
    would),
  * lease registry + exactly-once router — scale-DOWN picks the
    least-loaded cell and GRACEFULLY drains it: admissions close (the
    replica NACKs new SUBM with the typed ``DRNG`` reply the router
    re-dispatches without burning the attempt budget), the lease value
    is re-marked ``draining:<ep>`` (``membership.DRAINING_PREFIX``) so
    every registry reader sees the state while the lease keeps
    beating, in-flight requests retire and their results are delivered
    AND ACKED (CANC) before the lease is revoked. A kill mid-drain is
    just replica death: the lease expires and the router's existing
    resubmission path re-executes the in-flight requests exactly-once
    on a survivor.

Rolling weight updates replace replicas one at a time given a NEW
artifact version::

    boot v2 -> healthy STAT -> drain one v1 -> retire -> repeat

with the exactly-once contract preserved across the roll (every hop is
either a spawn, a drain, or a death — all already covered), the
serving artifact version stamped into STAT / DUMP / the
``ptpu_fleet_version_replicas`` gauge so ``monitor watch`` renders the
fleet's version mix converging, and an ABORT path: a v2 cell that
fails its health gate (or fails to boot at all) halts the ROLL, not
the fleet — the sick cell is retired, the surviving v1 fleet keeps
serving, and the ``roll`` recorder row lands with ``aborted: true``.

Chaos surfaces: the fault plan's ``kill`` targets ``drain`` (value =
drains started) and ``roll`` (value = replicas replaced so far) crash
the cell being drained the moment its drain begins —
``tests/test_autoscale.py`` gates "kill mid-scale-down" and "kill
mid-roll" on token-identical exactly-once completion.

The control loop is itself a fleet citizen per the forensics
contract: it answers ``METR`` / ``HLTH`` / ``DUMP`` / ``CLKS`` /
``EXIT`` on the shared frame protocol (``DUMP`` carries the
controller's state: desired vs live, version mix, roll phase, last
scale event) and lease-registers under role ``autoscaler`` so
collectors and the ``monitor bundle`` coordinator discover it without
configuration.
"""

import threading
import time

from ..distributed import membership as _membership
from ..distributed.membership import KVClient
from ..distributed.rpc import (_send_msg, _recv_msg, _clock_reply,
                               _metr_reply, _hlth_reply, _dump_reply)
from ..monitor import metrics as _metrics
from ..monitor import runtime as _monrt
from ..monitor.collector import AUTOSCALER_ROLE
from ..resilience import faults as _faults
from ..trace import runtime as _trace
from .fleet import (Replica, ReplicaClient, REPLICA_ROLE,
                    EVICTED_PREFIX, FLEET_SHED)

__all__ = ["Autoscaler", "ControlServer", "AUTOSCALER_ROLE"]


def _shed_total():
    """Router shed count visible in THIS process's registry (the
    roll-under-traffic harness runs router + autoscaler in one
    process; a cross-process deployment reads the collector's merged
    ``ptpu_fleet_shed_total`` instead)."""
    return sum(FLEET_SHED.snapshot().values())


class ControlServer:
    """Scrape + black-box endpoint of the control loop (METR / HLTH /
    DUMP / CLKS / EXIT on the shared frame protocol, all idempotent
    reads + the admin EXIT). ``DUMP`` replies via ``rpc._dump_reply``
    with the controller's live state dict — the incident-bundle
    coordinator's view of "what was the autoscaler doing"."""

    def __init__(self, state_fn, host="127.0.0.1", port=0):
        import socketserver
        self._state_fn = state_fn
        outer = self

        def _serve(request, op, payload):
            if op == "METR":
                _metr_reply(request, payload, role=AUTOSCALER_ROLE)
            elif op == "HLTH":
                _hlth_reply(request, role=AUTOSCALER_ROLE)
            elif op == "DUMP":
                try:
                    state = outer._state_fn()
                except Exception as e:       # capture must not die
                    state = {"error": repr(e)}
                _dump_reply(request, payload, role=AUTOSCALER_ROLE,
                            state=state)
            elif op == "CLKS":
                _clock_reply(request)
            elif op == "EXIT":
                _send_msg(request, "OK")
                outer.stop()
                return False
            else:
                _send_msg(request, "ERR", "unknown op %s" % op)
            return True

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # same trace-header discipline as every dispatch loop
                # (replica/kv/telemetry): a traced scrape nests under
                # the caller's client span
                try:
                    while True:
                        op, name, payload, tctx = _recv_msg(
                            self.request, want_ctx=True)
                        trc = _trace._TRACER
                        if trc is not None and tctx is not None \
                                and op != "CLKS":
                            with trc.server_span("autoscaler." + op,
                                                 tctx, op=op):
                                cont = _serve(self.request, op,
                                              payload)
                        else:
                            cont = _serve(self.request, op, payload)
                        if not cont:
                            break
                except (ConnectionError, OSError):
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self.endpoint = "%s:%d" % (host, self.port)
        trc = _trace._TRACER
        if trc is not None:
            trc.record_server_port(self.port, self.endpoint)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="ptpu-autoscale-ctl")

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()


class Autoscaler:
    """The elastic-fleet control loop. Owns its replica cells (spawn /
    drain / retire / respawn — the Supervisor's respawn duty is folded
    in so two reconcilers never fight over one registry), consumes
    scale hints, and executes rolling weight updates.

    ``artifact`` is what cells boot from — an inference-artifact
    directory (the production shape) or a live model object (tests);
    ``version`` labels it (derived from the artifact dirname when
    omitted). ``max_replicas + 1`` registry slots are provisioned so
    the roll's N+1 transient (v2 booted, v1 not yet retired) always
    finds a slot.

    The loop reconciles once per ``interval``: reap dead cells, retire
    drained ones, advance the roll state machine one step, then move
    live capacity toward ``desired`` (spawn at most one cell per tick;
    start at most one drain at a time). All state mutation happens on
    the control thread; ``status()`` readers take the lock briefly —
    never across a network call (lock-discipline)."""

    def __init__(self, kv_endpoint, artifact, desired, min_replicas=1,
                 max_replicas=8, version=None, role=REPLICA_ROLE,
                 slots=2, ttl=0.5, interval=0.05, cooldown=1.0,
                 drain_timeout=30.0, health_timeout=10.0,
                 register=True, control_slots=4, **engine_kwargs):
        self.role = role
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.desired = max(self.min_replicas,
                           min(self.max_replicas, int(desired)))
        if version is None and isinstance(artifact, str):
            import os
            version = os.path.basename(os.path.normpath(artifact))
        self._artifact = artifact
        self._version = version
        self._slots = int(slots)
        self._ttl = float(ttl)
        self._interval = float(interval)
        self._cooldown = float(cooldown)
        self.drain_timeout = float(drain_timeout)
        self.health_timeout = float(health_timeout)
        self._engine_kwargs = dict(engine_kwargs)
        self._slot_span = self.max_replicas + 1
        self._kv = KVClient(kv_endpoint)
        self._lock = threading.Lock()
        self.cells = []          # every incarnation (test teardown)
        self._active = []        # cells under management (incl. draining)
        self._draining = {}      # cell -> retire deadline (monotonic)
        self._roll = None        # roll state machine (None = steady)
        self._known_versions = set()
        if version is not None:
            self._known_versions.add(str(version))
        self.spawns = 0
        self.drains = 0
        self.rolls = 0
        self.aborted_rolls = 0
        self.scale_events = 0
        self.last_scale = None
        self.last_roll = None
        self.last_hint = None
        self.errors = []         # bounded control-loop error history
        self._last_scale_ts = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ptpu-autoscale")
        # forensics contract: the control loop is scrapeable and
        # black-box-dumpable like every other fleet process
        self.control = ControlServer(self.status).start()
        self._control_lease = None
        if register:
            try:
                _, self._control_lease = _membership.register_endpoint(
                    self._kv, AUTOSCALER_ROLE, int(control_slots),
                    self.control.endpoint, ttl=2.0, timeout=5.0)
            except Exception as e:
                import sys
                print("paddle_tpu_torch.serving.autoscale: control-lease "
                      "registration failed (%r); serving unregistered "
                      "on %s" % (e, self.control.endpoint),
                      file=sys.stderr)
        _monrt.FLEET_DESIRED.set(self.desired)

    def start(self):
        self._thread.start()
        return self

    # -- scale hints -------------------------------------------------------
    def attach(self, signals):
        """Install this controller as the evaluator's scale hook
        (capture-hook pattern): every ``Signals.evaluate()`` round
        feeds its ``scale_hint()`` into ``offer_hint``."""
        signals.scale_hook = self.offer_hint
        return self

    def offer_hint(self, hint):
        """Consume one ``ScaleHint``. Moves ``desired`` for ``up`` /
        ``down`` hints within bounds, under the cooldown, and never
        during a roll (elasticity must not race a weight update);
        ``hold`` only records. Returns True when desired moved."""
        with self._lock:
            self.last_hint = tuple(hint)
        direction = hint[0]
        if direction not in ("up", "down"):
            return False
        now = time.monotonic()
        with self._lock:
            if self._roll is not None:
                return False
            if now - self._last_scale_ts < self._cooldown:
                return False
        mag = max(1, int(hint[1]))
        delta = mag if direction == "up" else -mag
        reason = "pressure" if direction == "up" else "idle"
        return self.set_desired(self.desired + delta, reason=reason,
                                detail=hint[2]) is not None

    def set_desired(self, n, reason="manual", detail=None):
        """Move the desired replica count (clamped to bounds). The
        loop converges: scale-up spawns artifact-booted cells,
        scale-down gracefully drains the least-loaded. Returns the new
        desired count, or None when nothing changed."""
        n = max(self.min_replicas, min(self.max_replicas, int(n)))
        with self._lock:
            if n == self.desired:
                return None
            direction = "up" if n > self.desired else "down"
            self.desired = n
            self.scale_events += 1
            self._last_scale_ts = time.monotonic()
            live = len(self._active) - len(self._draining)
            mix = self._version_mix_locked()
            self.last_scale = {"direction": direction, "desired": n,
                               "live": live, "reason": reason,
                               "detail": detail, "ts": time.time()}
        _monrt.on_scale_event(direction, n, live, reason,
                              detail=detail, version_mix=mix)
        return n

    # -- rolling weight updates --------------------------------------------
    def roll(self, artifact, version=None):
        """Begin a rolling weight update to a NEW artifact. One
        replica at a time: boot the new version, gate on a healthy
        STAT, drain one old-version cell, retire it, repeat until the
        fleet serves only the new version. Returns the target version
        label; progress via ``roll_status()`` / ``wait_roll()``."""
        if version is None and isinstance(artifact, str):
            import os
            version = os.path.basename(os.path.normpath(artifact))
        with self._lock:
            if self._roll is not None:
                raise RuntimeError("roll to %r already in progress"
                                   % (self._roll["to"],))
            if version is not None:
                self._known_versions.add(str(version))
            self._roll = {
                "artifact": artifact, "to": version,
                "from": self._version, "t0": time.time(),
                "shed0": _shed_total(), "replaced": 0,
                "state": "boot", "v2": None, "deadline": None,
                "draining": None,
            }
        return version

    def roll_status(self):
        with self._lock:
            r = self._roll
            if r is None:
                return None
            return {"from": r["from"], "to": r["to"],
                    "state": r["state"], "replaced": r["replaced"]}

    def wait_roll(self, timeout=120.0):
        """Block until the in-progress roll finishes (completed or
        aborted); returns the terminal ``last_roll`` dict."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._roll is None:
                    return dict(self.last_roll or {})
            time.sleep(0.02)
        raise TimeoutError("roll did not finish within %gs" % timeout)

    def wait_steady(self, timeout=60.0):
        """Block until live == desired with no drains and no roll."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            st = self.status()
            if st["phase"] == "steady" and st["draining"] == 0 \
                    and st["live"] == st["desired"]:
                return st
            time.sleep(0.02)
        raise TimeoutError(
            "fleet not steady within %gs: %r" % (timeout,
                                                 self.status()))

    # -- introspection -----------------------------------------------------
    def status(self):
        """Controller state snapshot (also the DUMP verb's ``state``
        payload): desired vs live, per-version mix, drain/roll phase,
        last scale event."""
        with self._lock:
            r = self._roll
            return {
                "desired": self.desired,
                "live": len(self._active) - len(self._draining),
                "draining": len(self._draining),
                "min": self.min_replicas, "max": self.max_replicas,
                "version": self._version,
                "version_mix": self._version_mix_locked(),
                "phase": "rolling" if r is not None else "steady",
                "roll": None if r is None else {
                    "from": r["from"], "to": r["to"],
                    "state": r["state"], "replaced": r["replaced"]},
                "last_scale": dict(self.last_scale)
                if self.last_scale else None,
                "last_roll": dict(self.last_roll)
                if self.last_roll else None,
                "last_hint": self.last_hint,
                "spawns": self.spawns, "drains": self.drains,
                "rolls": self.rolls,
                "aborted_rolls": self.aborted_rolls,
                "scale_events": self.scale_events,
            }

    def _version_mix_locked(self):
        mix = {str(v): 0 for v in self._known_versions}
        for c in self._active:
            mix[str(c.version)] = mix.get(str(c.version), 0) + 1
        return mix

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        """Stop the control loop and retire everything it owns."""
        self._stop.set()
        if self._thread.ident is not None:   # never start()ed: no join
            self._thread.join(timeout=10)
        if self._control_lease is not None:
            try:
                self._control_lease.revoke()
            except (ConnectionError, OSError):
                pass
        try:
            self.control.stop()
        except OSError:
            pass
        for c in list(self.cells):
            try:
                c.shutdown()
            except Exception:
                pass
        self._kv.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- the control loop --------------------------------------------------
    def _loop(self):
        prefix = _membership.role_prefix(self.role)
        while not self._stop.wait(self._interval):
            try:
                self._tick(prefix)
            except Exception as e:
                # the control loop outlives anything a chaotic fleet
                # throws at one tick — but keeps the evidence
                self.errors.append(repr(e))
                del self.errors[:-64]

    @staticmethod
    def _cell_dead(cell):
        # crash() and a lost lease both stop the heartbeat; a retired
        # cell never reaches this check (removed from _active first)
        return cell.lease.lost or cell.lease._stop.is_set()

    def _cell_load(self, cell):
        with cell.server._lock:
            return sum(1 for j in cell.server._jobs.values()
                       if not j["req"].done())

    @staticmethod
    def _cell_quiesced(cell):
        # drained = every admitted request delivered AND acked: the
        # journal holds finished-but-unacked results until CANC, so an
        # empty journal is exactly the CANC-safe retire condition
        return not cell.server._jobs

    def _spawn_cell(self, artifact, version):
        cell = Replica(self._kv, artifact, desired=self._slot_span,
                       slots=self._slots, ttl=self._ttl,
                       role=self.role, version=version,
                       **self._engine_kwargs)
        self.spawns += 1
        with self._lock:
            if version is not None:
                self._known_versions.add(str(version))
            self.cells.append(cell)
            self._active.append(cell)
        return cell

    def _retire_cell(self, cell):
        with self._lock:
            if cell in self._active:
                self._active.remove(cell)
            self._draining.pop(cell, None)
        # shutdown revokes the lease (joins the heartbeat thread) —
        # run it off the control thread so a tick never blocks on it
        threading.Thread(target=cell.shutdown, daemon=True).start()

    def _start_drain(self, cell, kill_target, kill_value):
        """Begin one graceful drain; consult the armed fault plan's
        kill-during-drain targets the moment the drain starts (the
        chaos gate: a cell killed MID-drain resolves its in-flight
        requests exactly-once via lease expiry + resubmission)."""
        self.drains += 1
        _monrt.on_drain(cell.slot, cell.endpoint, version=cell.version)
        cell.drain()
        with self._lock:
            self._draining[cell] = time.monotonic() + self.drain_timeout
        plan = _faults._ACTIVE
        if plan is not None and plan.should_kill(kill_target,
                                                 kill_value):
            cell.crash()

    def _healthy(self, cell, version):
        """Roll health gate: one real STAT round trip over the wire
        (not an in-process peek — the gate must prove the cell SERVES)
        reporting the expected artifact version."""
        cli = ReplicaClient(cell.endpoint, timeout=1.0)
        try:
            st = cli.stat()
            return st.get("version") == (None if version is None
                                         else str(version))
        except Exception:
            return False
        finally:
            cli.close()

    def _abort_roll(self, why):
        with self._lock:
            r = self._roll
            self._roll = None
            if r is None:
                return
            self.aborted_rolls += 1
            self.last_roll = {
                "from": r["from"], "to": r["to"], "aborted": True,
                "replaced": r["replaced"], "reason": why,
                "shed_during": _shed_total() - r["shed0"]}
            last = dict(self.last_roll)
        _monrt.on_roll(last["from"], last["to"],
                       replaced=last["replaced"],
                       shed_during=last["shed_during"],
                       aborted=True, reason=why)

    def _finish_roll(self, r):
        dt = time.time() - r["t0"]
        shed = _shed_total() - r["shed0"]
        with self._lock:
            self._artifact = r["artifact"]
            self._version = r["to"]
            self.rolls += 1
            self._roll = None
            self.last_roll = {
                "from": r["from"], "to": r["to"], "aborted": False,
                "replaced": r["replaced"], "convergence_s": dt,
                "shed_during": shed, "reason": None}
        _monrt.on_roll(r["from"], r["to"], convergence_s=dt,
                       replaced=r["replaced"], shed_during=shed)

    def _advance_roll(self):
        """One roll state-machine step per tick:
        boot -> health -> drain -> (boot ...), completing when no
        old-version cell remains."""
        with self._lock:
            r = self._roll
            if r is None:
                return
            old = [c for c in self._active
                   if c not in self._draining
                   and str(c.version) != str(r["to"])]
        if r["state"] == "boot":
            if not old and r["v2"] is None:
                self._finish_roll(r)
                return
            if r["v2"] is not None:      # spawn from a PREVIOUS tick
                r["state"] = "health"    # (respawn path) — re-gate
                return
            try:
                cell = self._spawn_cell(r["artifact"], r["to"])
            except Exception as e:
                self._abort_roll("v2 boot failed: %r" % e)
                return
            r["v2"] = cell
            r["deadline"] = time.monotonic() + self.health_timeout
            r["state"] = "health"
        elif r["state"] == "health":
            cell = r["v2"]
            if cell is None or self._cell_dead(cell):
                self._abort_roll("v2 replica died before health")
                return
            if self._healthy(cell, r["to"]):
                r["state"] = "drain"
                return
            if time.monotonic() > r["deadline"]:
                # halt the ROLL, not the fleet: retire the sick v2,
                # the surviving v1 cells keep serving
                self._retire_cell(cell)
                self._abort_roll(
                    "v2 replica failed health within %gs"
                    % self.health_timeout)
        elif r["state"] == "drain":
            if r["draining"] is None:
                if not old:
                    r["v2"] = None
                    r["state"] = "boot"  # completion check next tick
                    return
                victim = min(old, key=lambda c: (self._cell_load(c),
                                                 c.slot))
                r["draining"] = victim
                self._start_drain(victim, "roll", r["replaced"])
                return
            victim = r["draining"]
            with self._lock:
                gone = victim not in self._active
            if gone:
                r["replaced"] += 1
                r["draining"] = None
                r["v2"] = None
                r["state"] = "boot"

    def _tick(self, prefix):
        # 1. free tombstoned slots (compare-and-delete, never remove a
        #    slot a fresh holder re-claimed) — Supervisor duty, folded in
        try:
            live = _membership.live_endpoints(self._kv, self.role)
        except Exception:
            live = {}
        for slot, val in live.items():
            if val.startswith(EVICTED_PREFIX):
                try:
                    self._kv.cad(prefix + str(slot), val)
                except Exception:
                    pass
        # 2. reap dead cells (kills, lost leases): the router's
        #    resubmission path already re-executes their in-flight work
        with self._lock:
            dead = [c for c in self._active if self._cell_dead(c)]
            for c in dead:
                self._active.remove(c)
                self._draining.pop(c, None)
            draining = list(self._draining.items())
        # 3. retire drained cells: quiesced (all delivered AND acked —
        #    CANC-safe) or past the drain deadline
        now = time.monotonic()
        for cell, deadline in draining:
            if self._cell_quiesced(cell) or now > deadline:
                self._retire_cell(cell)
        # 4. advance the roll state machine one step
        self._advance_roll()
        # 5. reconcile capacity toward desired
        with self._lock:
            capacity = len(self._active) - len(self._draining)
            want = self.desired
            rolling = self._roll is not None
            can_drain = not self._draining and not rolling
            idle_cells = [c for c in self._active
                          if c not in self._draining]
            artifact, version = self._artifact, self._version
            if rolling:
                artifact = self._roll["artifact"]
                version = self._roll["to"]
        if capacity < want:
            # spawn at most one per tick; a cold boot is the slow part
            # and one-at-a-time keeps slot claims race-free
            try:
                self._spawn_cell(artifact, version)
            except Exception as e:
                self.errors.append("spawn: %r" % e)
                del self.errors[:-64]
        elif capacity > want and can_drain and idle_cells:
            victim = min(idle_cells, key=lambda c: (self._cell_load(c),
                                                    c.slot))
            self._start_drain(victim, "drain", self.drains)
        # 6. telemetry: the version-mix gauge tracks live cells
        with self._lock:
            mix = self._version_mix_locked()
        _monrt.FLEET_DESIRED.set(self.desired)
        for ver, n in mix.items():
            _monrt.FLEET_VERSION_REPLICAS.set(n, version=ver)
