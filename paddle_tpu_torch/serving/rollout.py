"""Verdict-gated model rollouts: the canary analysis plane's
controller — artifact in, promoted-or-rolled-back fleet out.

The port's copy of ``paddle_tpu/serving/rollout.py`` (pure host code
over the port's fleet).

The pipeline composes seams that already exist instead of inventing a
parallel one:

  boot        spawn ``candidates`` fleet.Replica cells from the NEW
              artifact under role ``candidate`` (the router keys them
              at an offset so the journal / dedup / lease-expiry
              machinery covers them wholesale),
  shadow      ``Router.arm_shadow``: a sampled fraction of live decode
              requests is DUPLICATED to candidates — scored, never
              served, never counted in the incumbent's SLO histograms
              (the failed-request exclusion discipline); candidate and
              incumbent results join by rid into ``mirror_pair`` recorder rows,
  verdict     a ``signals.DeltaRule`` buffers the mirrored window's
              rows and decides EXACTLY ONCE via ``slo.evaluate_delta``
              — candidate-vs-incumbent percentile inflation, error-
              rate delta, token agreement — once ``min_pairs`` joined
              pairs and ``min_requests`` per side have landed. FAIL
              fires through the normal Signals edge: offender traces
              retained, forensics bundle captured, incident row landed,
  canary      PASS advances to ``Router.arm_canary``: a small weighted
              fraction is served FOR REAL by candidates (version
              stamped on row / span / lease) and a second DeltaRule —
              token agreement dropped, there are no mirrored pairs to
              join — gates on the real-traffic deltas,
  rolling     PASS promotes via the ``Autoscaler``'s existing rolling
              weight update (boot v2 -> health gate -> drain v1 ->
              repeat), which already carries the exactly-once contract
              and its own chaos gates,
  rollback    ANY FAIL (including a forced one) disarms the mirror
              FIRST — so a rollout aborted in shadow serves ZERO
              candidate-only tokens — then retires every candidate
              cell and returns the fleet to single-version routing.
              Unfinished CANARY requests resubmit to incumbents via
              the journal: exactly-once completion holds through the
              rollback.

Chaos surfaces: the armed fault plan's kill targets ``shadow`` (value
= joined mirror pairs) and ``canary`` (value = canary-served requests)
crash one live candidate cell MID-phase; the controller reconciles —
bounded respawns from the same artifact — so the verdict still lands.
``tests/test_rollout.py`` gates the whole pipeline under seeded frame
faults + mid-phase kills on token-identical exactly-once completion
with zero shed.

The controller is a fleet citizen per the forensics contract:
``RolloutServer`` answers METR / HLTH / DUMP / CLKS / EXIT plus the
rollout-specific idempotent VERD (current phase + per-phase verdicts)
on the shared frame protocol, and lease-registers under role
``rollout`` so collectors and the ``monitor bundle`` coordinator
discover it without configuration.
"""

import json
import threading
import time

from ..distributed import membership as _membership
from ..distributed.membership import KVClient
from ..distributed.rpc import (_send_msg, _recv_msg, _clock_reply,
                               _metr_reply, _hlth_reply, _dump_reply)
from ..monitor import runtime as _monrt
from ..monitor import signals as _signals
from ..monitor.collector import ROLLOUT_ROLE
from ..resilience import faults as _faults
from ..trace import runtime as _trace
from .fleet import CANDIDATE_ROLE, Replica

__all__ = ["RolloutController", "RolloutServer", "ROLLOUT_ROLE",
           "fetch_verdicts"]


class RolloutServer:
    """Scrape + black-box + verdict endpoint of the rollout controller
    (METR / HLTH / DUMP / CLKS / VERD / EXIT on the shared frame
    protocol — all idempotent reads plus the admin EXIT). ``DUMP``
    replies via ``rpc._dump_reply`` with the controller's live state;
    ``VERD`` replies with the phase + per-phase verdict dict (a read
    of decided state: safe to re-issue, hence its ``idempotent``
    class in ``resilience.retry.VERB_CLASSES``)."""

    def __init__(self, state_fn, verdict_fn, host="127.0.0.1",
                 port=0):
        import socketserver
        self._state_fn = state_fn
        self._verdict_fn = verdict_fn
        outer = self

        def _serve(request, op, payload):
            if op == "METR":
                _metr_reply(request, payload, role=ROLLOUT_ROLE)
            elif op == "HLTH":
                _hlth_reply(request, role=ROLLOUT_ROLE)
            elif op == "DUMP":
                try:
                    state = outer._state_fn()
                except Exception as e:       # capture must not die
                    state = {"error": repr(e)}
                _dump_reply(request, payload, role=ROLLOUT_ROLE,
                            state=state)
            elif op == "VERD":
                try:
                    v = outer._verdict_fn()
                except Exception as e:
                    v = {"error": repr(e)}
                _send_msg(request, "VAL", "",
                          json.dumps(v, default=repr).encode())
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
                # same trace-header discipline as every dispatch loop:
                # a traced scrape nests under the caller's client span
                try:
                    while True:
                        op, name, payload, tctx = _recv_msg(
                            self.request, want_ctx=True)
                        trc = _trace._TRACER
                        if trc is not None and tctx is not None \
                                and op != "CLKS":
                            with trc.server_span("rollout." + op,
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
            name="ptpu-rollout-ctl")

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()


def fetch_verdicts(endpoint, timeout=2.0):
    """One VERD round trip: the controller's phase + per-phase verdict
    dict as served on the wire (tests and dashboards share it)."""
    import socket
    host, port = endpoint.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)),
                                    timeout=timeout)
    try:
        sock.settimeout(timeout)
        _send_msg(sock, "VERD")
        op, _, payload = _recv_msg(sock)
        if op != "VAL":
            raise ConnectionError("VERD reply %s" % op)
        return json.loads(bytes(payload).decode())
    finally:
        sock.close()


class RolloutController:
    """One verdict-gated rollout attempt: artifact directory in,
    ``run()`` drives boot -> shadow -> canary -> rolling to a terminal
    ``promoted`` or ``rolled-back`` phase. Synchronous by design — the
    state machine IS the call stack, and every transition lands a
    ``rollout`` flight-recorder row — with an internal wait loop that
    feeds the delta evaluator from the armed flight recorder, consults
    the chaos plan, and reconciles killed candidates while a verdict
    is pending.

    ``spec`` is an SLO spec dict carrying a ``"delta"`` block (or the
    delta block itself). The flight recorder must be armed
    (``monitor.session`` / ``--flag monitor_record``): the mirrored
    window's evidence comes from recorder rows, same rows ``monitor
    watch`` and the batch CLI read — no parallel plumbing."""

    def __init__(self, kv_endpoint, router, autoscaler, artifact,
                 spec, version=None, candidates=1,
                 shadow_fraction=None, canary_weight=None,
                 verdict_timeout=60.0, max_respawns=2,
                 cand_slot_span=4, slots=2, ttl=0.5, register=True,
                 control_slots=4, capture=False, capture_dir=None,
                 **engine_kwargs):
        if version is None and isinstance(artifact, str):
            import os
            version = os.path.basename(os.path.normpath(artifact))
        delta = spec.get("delta", spec) if isinstance(spec, dict) \
            else spec
        from .. import slo as _slo
        self.delta = _slo.validate_delta_spec(dict(delta))
        self.router = router
        self.autoscaler = autoscaler
        self.artifact = artifact
        self.version = str(version)
        self.candidates = int(candidates)
        self.shadow_fraction = shadow_fraction
        self.canary_weight = canary_weight
        self.verdict_timeout = float(verdict_timeout)
        self.max_respawns = int(max_respawns)
        self._cand_span = int(cand_slot_span)
        self._slots = int(slots)
        self._ttl = float(ttl)
        self._engine_kwargs = dict(engine_kwargs)
        self._capture = bool(capture)
        self._capture_dir = capture_dir
        self._kv_endpoint = kv_endpoint
        self._kv = KVClient(kv_endpoint)
        self._lock = threading.Lock()
        self.cells = []            # every incarnation (test teardown)
        self._cands = []           # live candidate cells
        self.phase = "idle"
        self.verdicts = {}         # phase -> verdict report dict
        self.respawns = 0
        self.kills = 0             # chaos kills this controller issued
        self.reason = None         # terminal detail (promoted too)
        self.convergence_s = None
        self._forced = None        # ("FAIL", reason) override
        self._cursor = None        # recorder cursor (evidence feed)
        self._t0 = None
        # forensics contract: scrapeable + black-box-dumpable
        self.control = RolloutServer(self.status,
                                     self.verdict_state).start()
        self._control_lease = None
        if register:
            try:
                _, self._control_lease = \
                    _membership.register_endpoint(
                        self._kv, ROLLOUT_ROLE, int(control_slots),
                        self.control.endpoint, ttl=2.0, timeout=5.0)
            except Exception as e:
                import sys
                print("paddle_tpu_torch.serving.rollout: control-lease "
                      "registration failed (%r); serving "
                      "unregistered on %s"
                      % (e, self.control.endpoint), file=sys.stderr)

    # -- introspection -----------------------------------------------------
    def status(self):
        """Controller state snapshot (also the DUMP verb's ``state``
        payload): phase, candidate cells, verdicts, respawn/kill
        ledger, terminal reason."""
        with self._lock:
            return {
                "phase": self.phase,
                "version": self.version,
                "candidates": [
                    {"slot": c.slot, "endpoint": c.endpoint,
                     "shadow": bool(getattr(c.engine, "shadow",
                                            False))}
                    for c in self._cands],
                "verdicts": {p: dict(v)
                             for p, v in self.verdicts.items()},
                "respawns": self.respawns,
                "kills": self.kills,
                "reason": self.reason,
                "convergence_s": self.convergence_s,
                "mirror": self.router.mirror_status()["mirror"],
            }

    def verdict_state(self):
        """The VERD verb's payload: terminal-or-live phase plus the
        per-phase verdict dicts decided so far."""
        with self._lock:
            return {"phase": self.phase, "version": self.version,
                    "verdicts": {p: dict(v)
                                 for p, v in self.verdicts.items()}}

    def force_fail(self, reason="forced"):
        """Force the NEXT pending verdict to FAIL (the operator's big
        red button, and the test hook proving a rollout aborted in
        shadow serves zero candidate-only tokens)."""
        with self._lock:
            self._forced = ("FAIL", str(reason))

    # -- the pipeline ------------------------------------------------------
    def run(self):
        """Drive the full rollout; returns the terminal ``status()``.
        Raises RuntimeError when no flight recorder is armed — the
        verdict's evidence chain is not optional."""
        rec = _monrt.recorder()
        if rec is None:
            raise RuntimeError(
                "rollout requires an armed flight recorder "
                "(monitor.session or --flag monitor_record): delta "
                "verdicts are decided from recorder rows")
        self._t0 = time.time()
        try:
            self._set_phase("boot")
            self._boot_candidates(self.candidates, shadow=True)

            verdict = self._phase_verdict("shadow", rec)
            if verdict != "PASS":
                return self._rollback("shadow verdict %s" % verdict)

            cdelta = self._canary_delta()
            if cdelta is not None:
                verdict = self._phase_verdict("canary", rec,
                                              delta=cdelta)
                if verdict != "PASS":
                    return self._rollback("canary verdict %s"
                                          % verdict)
            else:
                self.verdicts["canary"] = {
                    "verdict": "PASS", "skipped": True,
                    "reason": "no canary-evaluable objectives"}

            self._set_phase("rolling")
            # candidates were scoring cells, not fleet capacity: the
            # promotion path is the autoscaler's chaos-gated roll
            self.router.disarm_mirror()
            self._retire_candidates()
            self.autoscaler.roll(self.artifact, self.version)
            last = self.autoscaler.wait_roll(
                timeout=max(120.0, 4 * self.verdict_timeout))
            if last.get("aborted"):
                return self._finish(
                    "rolled-back",
                    "roll aborted: %s" % last.get("reason"))
            self.autoscaler.wait_steady(
                timeout=max(60.0, 2 * self.verdict_timeout))
            self.convergence_s = time.time() - self._t0
            return self._finish("promoted", "verdicts passed")
        except Exception as e:
            if self.phase not in ("promoted", "rolled-back"):
                self._rollback("controller error: %r" % e)
            raise

    # -- phases ------------------------------------------------------------
    def _set_phase(self, phase, detail=None):
        with self._lock:
            self.phase = phase
        try:
            mix = self.autoscaler.status()["version_mix"]
        except Exception:
            mix = None
        _monrt.on_rollout(phase, self.version, detail=detail,
                          version_mix=mix,
                          convergence_s=self.convergence_s)

    def _canary_delta(self):
        """The canary-phase delta block: token agreement dropped (no
        mirrored pairs join during a real-traffic split) and the pair
        gate zeroed. None when nothing evaluable remains."""
        objs = [dict(o) for o in self.delta["objectives"]
                if o["metric"] != "token_agreement"]
        if not objs:
            return None
        d = dict(self.delta)
        d["objectives"] = objs
        d["min_pairs"] = 0
        return d

    def _phase_verdict(self, phase, rec, delta=None):
        """Arm the mirror for ``phase``, feed the delta evaluator from
        the flight recorder until its exactly-once verdict lands (or
        the timeout forces FAIL), reconciling chaos-killed candidates
        along the way. Returns "PASS"/"FAIL"."""
        delta = delta if delta is not None else self.delta
        self._set_phase(phase)
        if phase == "shadow":
            self.router.arm_shadow(self.version,
                                   fraction=self.shadow_fraction)
        else:
            # order is the contract: the shadow mirror disarms FIRST —
            # dropping the queued copy backlog wholesale (best-effort
            # by contract; at high mirror fractions that backlog is
            # unbounded and can NEVER be drained in bounded time) —
            # then the copies already admitted at candidate engines
            # retire while those engines are still shadow-stamped, and
            # only THEN do the cells flip to real serving. Flipping
            # first would let the drained tail retire as shadow=False
            # rows stamped with the candidate version: counterfeit
            # "canary-served" evidence that can satisfy the verdict's
            # request gate before a single real canary request was
            # sampled.
            self.router.disarm_mirror()
            self._drain_candidate_inflight()
            for c in list(self._cands):
                self._mark_cell(c, shadow=False)
            self.router.arm_canary(self.version,
                                   weight=self.canary_weight)
        self.router.wait_for_candidates(1, timeout=30.0)

        rule = _signals.DeltaRule(delta, self.version, phase=phase)
        sig = _signals.Signals(rules=[rule])
        if self._capture:
            from ..monitor import forensics as _forensics
            _forensics.attach(sig, kv_endpoint=self._kv_endpoint,
                              out_dir=self._capture_dir)
        deadline = time.monotonic() + self.verdict_timeout
        while rule.verdict is None:
            with self._lock:
                forced = self._forced
            if forced is not None:
                rule.force(*forced)
            elif time.monotonic() > deadline:
                rule.force("FAIL", "verdict timeout (%gs)"
                           % self.verdict_timeout)
            self._feed(sig, rec)
            self._consult_chaos(phase)
            self._reconcile(shadow=(phase == "shadow"))
            sig.evaluate(now=time.time())
            if rule.verdict is None:
                time.sleep(0.02)
        report = dict(rule.report or {})
        report["verdict"] = rule.verdict
        with self._lock:
            self.verdicts[phase] = report
        return rule.verdict

    def _feed(self, sig, rec):
        self._cursor, rows, _lost = rec.events_since(self._cursor)
        if rows:
            sig.feed_events(rows)

    def _consult_chaos(self, phase):
        """Mid-phase kill gates: target ``shadow`` fires on joined
        mirror pairs, ``canary`` on canary-SAMPLED requests (the
        submit-time counter: the served counter trails the verdict's
        evidence rows, so a small ``after`` could lose the race
        against a fast verdict and never fire) — one live candidate
        cell hard-crashes (lease dies with it; the router's existing
        down/resubmission path takes over)."""
        plan = _faults._ACTIVE
        if plan is None or not self._cands:
            return
        value = self.router.stats["mirror_pairs"] \
            if phase == "shadow" \
            else self.router.stats["canary"]
        if plan.should_kill(phase, value):
            cell = self._cands[0]
            self.kills += 1
            cell.crash()

    def _reconcile(self, shadow):
        """Reap dead candidate cells; respawn (bounded) from the same
        artifact so the verdict's evidence keeps accumulating after a
        chaos kill."""
        for cell in list(self._cands):
            if cell.lease.lost or cell.lease._stop.is_set():
                with self._lock:
                    self._cands.remove(cell)
        while len(self._cands) < self.candidates \
                and self.respawns < self.max_respawns:
            self.respawns += 1
            try:
                self._spawn_candidate(shadow=shadow)
            except Exception:
                break              # no slot yet (tombstone TTL): retry
                                   # next loop round via the same gate

    def _boot_candidates(self, n, shadow):
        for _ in range(int(n)):
            self._spawn_candidate(shadow=shadow)

    def _spawn_candidate(self, shadow):
        cell = Replica(self._kv, self.artifact,
                       desired=self._cand_span, slots=self._slots,
                       ttl=self._ttl, role=CANDIDATE_ROLE,
                       version=self.version, shadow=shadow,
                       **self._engine_kwargs)
        try:
            # pre-pay the warm-up NOW, before the mirror feeds
            # the cell: a cold candidate stalls its first admissions
            # by its warm-up, and those stalls would land in the
            # candidate's TTFT samples — the delta verdict would then
            # judge the compiler, not the artifact
            cell.engine.warmup()
        except (AttributeError, RuntimeError):
            # factory engine without warmup, or a mirror copy raced
            # in through the already-registered lease: compile lazily
            pass
        self._prime(cell)
        with self._lock:
            self.cells.append(cell)
            self._cands.append(cell)
        return cell

    @staticmethod
    def _prime(cell, timeout=30.0):
        """Run ONE real request end-to-end through the fresh cell
        before it joins the mirror: warmup() covers the decode
        dispatch paths, but the first admission still pays the lazy
        prefill compile — seconds of TTFT that would otherwise land
        in the candidate's first (and, with a small ``min_pairs``
        gate, verdict-deciding) delta samples. The priming row is
        stamped version "__prime__" so delta_samples_from_events
        counts it on NEITHER side."""
        eng = cell.engine
        try:
            ver = eng.version
            eng.version = "__prime__"
        except AttributeError:
            return                 # factory engine: nothing to prime
        try:
            req = eng.submit([1], 2)
            deadline = time.monotonic() + timeout
            while not req.done() and time.monotonic() < deadline:
                time.sleep(0.01)
        except Exception:
            pass                   # priming is best-effort
        finally:
            eng.version = ver

    @staticmethod
    def _mark_cell(cell, shadow):
        cell.shadow = shadow
        try:
            cell.engine.shadow = shadow
        except AttributeError:
            pass

    def _drain_candidate_inflight(self, timeout=10.0):
        """Bounded wait for copies already ADMITTED at the candidate
        engines to retire before the cells flip to real serving —
        their rows must land while the engines are still
        shadow-stamped. Unlike the router's queued backlog (which
        disarm_mirror has already dropped), this set is bounded by
        the per-candidate mirror window, so the wait converges."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            busy = False
            for cell in list(self._cands):
                try:
                    with cell.server._lock:
                        busy = any(not j["req"].done()
                                   for j in cell.server._jobs.values())
                except Exception:
                    continue
                if busy:
                    break
            if not busy:
                return
            time.sleep(0.02)

    # -- terminal ----------------------------------------------------------
    def _rollback(self, reason):
        # order is the contract: the mirror disarms FIRST — sampling
        # stops and candidate slots leave dispatch — so a rollout
        # aborted in shadow has served ZERO candidate-only tokens, and
        # unfinished canary requests resubmit to incumbents via the
        # journal (exactly-once through the rollback)
        self.router.disarm_mirror()
        self._retire_candidates()
        return self._finish("rolled-back", reason)

    def _retire_candidates(self):
        with self._lock:
            cells, self._cands = self._cands, []
        for cell in cells:
            try:
                cell.shutdown()
            except Exception:
                pass

    def _finish(self, phase, reason):
        with self._lock:
            self.reason = reason
        self._set_phase(phase, detail=reason)
        return self.status()

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        if self.phase not in ("promoted", "rolled-back", "idle"):
            try:
                self._rollback("controller closed")
            except Exception:
                pass
        else:
            self._retire_candidates()
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
