"""Elastic data master: task queue with timeout/retry + disk snapshot.

The port's copy of ``paddle_tpu/distributed/master.py`` (pure Python).

Reference parity: go/master/service.go:49-56 (todo/pending/done/failed
queues, per-task timeout, max-retry), go/master/client.go (trainer-side
NextRecord loop). The Go master hands out file *chunks*; here a task is an
opaque payload (e.g. a file path, a chunk index, a shard id) and trainers
pull tasks, stream the records, and ack. At-least-once semantics: a trainer
that dies mid-task never acks, the lease times out, and the task returns to
todo (→ failed after max_retries). Every transition snapshots the queue
state to disk with the atomic temp+fsync+rename pattern (io.py checkpoint
parity), so a restarted master resumes where it stopped.

The wire protocol reuses distributed/rpc.py's length-prefixed framing —
verbs GETT / DONE / FAIL / PING / EXIT — instead of the reference's gRPC.
"""

import json
import os
import socket
import socketserver
import threading
import time

from .rpc import (_send_msg, _recv_msg, _clock_exchange, _clock_reply,
                  _metr_reply, _hlth_reply, _dump_reply)
from ..monitor import metrics as _metrics
from ..monitor import runtime as _mon
from ..resilience import faults as _faults
from ..resilience.retry import RETRYABLE
from ..trace import clock as _clock
from ..trace import runtime as _trace

__all__ = ["TaskQueue", "MasterServer", "MasterClient"]

_REG = _metrics.registry()
_TASKS = _REG.counter("ptpu_master_tasks_total",
                      "elastic-master task transitions", ("state",))


class TaskQueue:
    """In-process queue core (service.go taskQueues)."""

    def __init__(self, payloads=(), timeout_s=10.0, max_retries=3,
                 snapshot_path=None):
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.snapshot_path = snapshot_path
        self._lock = threading.Lock()
        self.todo = [{"id": i, "payload": p, "retries": 0}
                     for i, p in enumerate(payloads)]
        self.pending = {}    # id -> {task, owner, deadline}
        self.done = []
        self.failed = []
        if snapshot_path and os.path.exists(snapshot_path):
            self._load()

    # -- queue ops (all snapshot on transition) -------------------------------
    def get_task(self, owner):
        with self._lock:
            self._requeue_expired()
            if not self.todo:
                return None
            task = self.todo.pop(0)
            self.pending[task["id"]] = {
                "task": task, "owner": owner,
                "deadline": time.time() + self.timeout_s}
            self._snapshot()
            return dict(task)

    def task_done(self, task_id):
        with self._lock:
            ent = self.pending.pop(int(task_id), None)
            if ent is not None:
                self.done.append(ent["task"])
                _TASKS.inc(state="done")
                self._snapshot()
                return True
            return False

    def task_failed(self, task_id):
        with self._lock:
            ent = self.pending.pop(int(task_id), None)
            if ent is not None:
                self._fail_or_retry(ent["task"])
                _TASKS.inc(state="failed")
                self._snapshot()
                return True
            return False

    def counts(self):
        with self._lock:
            self._requeue_expired()
            return {"todo": len(self.todo), "pending": len(self.pending),
                    "done": len(self.done), "failed": len(self.failed)}

    def all_done(self):
        c = self.counts()
        return c["todo"] == 0 and c["pending"] == 0

    # -- internals ------------------------------------------------------------
    def _fail_or_retry(self, task):
        task["retries"] += 1
        if task["retries"] > self.max_retries:
            self.failed.append(task)
        else:
            self.todo.append(task)

    def _requeue_expired(self):
        # caller holds the lock (service.go checkTimeoutFunc)
        now = time.time()
        expired = [tid for tid, e in self.pending.items()
                   if e["deadline"] <= now]
        for tid in expired:
            ent = self.pending.pop(tid)
            self._fail_or_retry(ent["task"])
            _TASKS.inc(state="lease_expired")
        if expired:
            self._snapshot()

    def _snapshot(self):
        if not self.snapshot_path:
            return
        state = {"todo": self.todo,
                 "pending": [e["task"] for e in self.pending.values()],
                 "done": self.done, "failed": self.failed}
        tmp = self.snapshot_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.snapshot_path)

    def _load(self):
        with open(self.snapshot_path) as f:
            state = json.load(f)
        # pending tasks had live leases when the master died: back to todo
        self.todo = state["todo"] + state["pending"]
        self.pending = {}
        self.done = state["done"]
        self.failed = state["failed"]


class MasterServer:
    """TCP face of a TaskQueue (service.go + RPC layer)."""

    def __init__(self, queue, host="127.0.0.1", port=0, port_file=None):
        self.queue = queue
        self._shutdown = threading.Event()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        op, name, payload, tctx = _recv_msg(
                            self.request, want_ctx=True)
                        trc = _trace._TRACER
                        if trc is not None and tctx is not None \
                                and op != "CLKS":
                            with trc.server_span("master." + op, tctx,
                                                 op=op):
                                cont = outer._dispatch(
                                    self.request, op, name, payload)
                        else:
                            cont = outer._dispatch(self.request, op,
                                                   name, payload)
                        if not cont:
                            break
                except (ConnectionError, OSError):
                    pass

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        if port_file:
            with open(port_file, "w") as f:
                f.write(str(self.port))
        trc = _trace._TRACER
        if trc is not None:
            trc.record_server_port(self.port,
                                   "%s:%d" % (host, self.port))
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._shutdown.set()
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()

    def _dispatch(self, sock, op, name, payload):
        plan = _faults._ACTIVE
        if plan is not None and plan.has_kill("master") and \
                plan.should_kill("master", len(self.queue.done)):
            # hard crash: in-flight request unanswered, queue snapshot
            # (if configured) is what the restarted master resumes from
            threading.Thread(target=self.stop, daemon=True).start()
            raise ConnectionError("injected fault: master killed")
        if op == "GETT":
            task = self.queue.get_task(owner=name)
            if task is None:
                done = self.queue.all_done()
                _send_msg(sock, "NONE", "done" if done else "wait")
            else:
                _send_msg(sock, "TASK", str(task["id"]),
                          json.dumps(task["payload"]).encode())
        elif op == "DONE":
            self.queue.task_done(name)
            _send_msg(sock, "OK")
        elif op == "FAIL":
            self.queue.task_failed(name)
            _send_msg(sock, "OK")
        elif op == "PING":
            _send_msg(sock, "OK", "",
                      json.dumps(self.queue.counts()).encode())
        elif op == "CLKS":
            _clock_reply(sock)
        elif op == "METR":
            _metr_reply(sock, payload, role="master")
        elif op == "HLTH":
            _hlth_reply(sock, role="master")
        elif op == "DUMP":
            _dump_reply(sock, payload, role="master",
                        state={"queue": self.queue.counts()})
        elif op == "EXIT":
            _send_msg(sock, "OK")
            self.stop()
            return False
        else:
            _send_msg(sock, "ERR", "unknown op %s" % op)
        return True


class MasterClient:
    """Trainer-side client (go/master/client.go).

    retry / resolver: same contract as rpc.RPCClient — every master
    verb is safe to re-issue (GETT is at-least-once BY DESIGN: a
    re-leased task's first lease simply expires; DONE/FAIL are
    idempotent pops; PING reads), so with a retry Policy the client
    transparently reconnects — through the resolver when the master
    itself was replaced — and re-asks."""

    def __init__(self, endpoint, worker_id="trainer", timeout=30.0,
                 retry=None, resolver=None):
        host, port = endpoint.rsplit(":", 1)
        self._addr = (host, int(port))
        self._timeout = timeout
        self._retry = retry
        self._resolver = resolver
        self._sock = None
        self.worker_id = worker_id
        self._connect()

    def _connect(self):
        if self._resolver is not None:
            try:
                ep = self._resolver()
            except Exception:
                ep = None
            if ep:
                host, port = ep.rsplit(":", 1)
                self._addr = (host, int(port))
        s = socket.create_connection(self._addr, timeout=self._timeout)
        s.settimeout(self._timeout)
        self._sock = s
        if _trace._TRACER is not None:
            _trace.annotate(endpoint="%s:%d" % self._addr)

    def _drop_conn(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _retrying(self, what, body):
        trc = _trace._TRACER
        if trc is None:
            return self._retrying_inner(what, body)
        # one logical client span per master verb (attempt children
        # come from Policy.run, same shape as RPCClient)
        with trc.span(what, endpoint="%s:%d" % self._addr):
            out = self._retrying_inner(what, body)
        self._maybe_clock_probe(trc)
        return out

    def _retrying_inner(self, what, body):
        if self._retry is None:
            if self._sock is None:
                self._connect()
            return body()

        def attempt():
            if self._sock is None:
                self._connect()
                _mon.on_reconnect("master")
                _trace.annotate(reconnected=True)
            return body()

        return self._retry.run(
            attempt, what=what, retry_on=RETRYABLE,
            on_retry=lambda a, e: self._drop_conn())

    def _maybe_clock_probe(self, trc):
        """See RPCClient._maybe_clock_probe."""
        if self._sock is None:
            return
        try:
            _clock.probe(trc, "%s:%d" % self._addr,
                         lambda: _clock_exchange(self._sock))
        except (ConnectionError, OSError, ValueError, KeyError):
            self._drop_conn()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def get_task(self):
        """Returns (task_id, payload) or (None, status): status 'done' when
        the epoch is complete, 'wait' when tasks are pending elsewhere."""
        def body():
            _send_msg(self._sock, "GETT", self.worker_id)
            op, name, payload = _recv_msg(self._sock)
            if op == "NONE":
                return None, name
            return int(name), json.loads(payload.decode())
        return self._retrying("master.get_task", body)

    def task_done(self, task_id):
        def body():
            _send_msg(self._sock, "DONE", str(task_id))
            assert _recv_msg(self._sock)[0] == "OK"
        self._retrying("master.task_done", body)

    def task_failed(self, task_id):
        def body():
            _send_msg(self._sock, "FAIL", str(task_id))
            assert _recv_msg(self._sock)[0] == "OK"
        self._retrying("master.task_failed", body)

    def counts(self):
        def body():
            _send_msg(self._sock, "PING", "")
            op, _, payload = _recv_msg(self._sock)
            return json.loads(payload.decode())
        return self._retrying("master.counts", body)

    def shutdown_server(self):
        try:
            if self._sock is None:
                self._connect()
            _send_msg(self._sock, "EXIT", "")
            _recv_msg(self._sock)
        except (ConnectionError, OSError):
            pass

    def close(self):
        self._drop_conn()

    def records(self, load_fn, poll_s=0.05):
        """Generator over all records of all tasks (client.go NextRecord):
        pulls tasks until the master reports done, yields load_fn(payload)
        items, acks on completion, reports failure on exception."""
        while True:
            task_id, payload = self.get_task()
            if task_id is None:
                if payload == "done":
                    return
                time.sleep(poll_s)
                continue
            try:
                for rec in load_fn(payload):
                    yield rec
            except Exception:
                self.task_failed(task_id)
                raise
            self.task_done(task_id)
