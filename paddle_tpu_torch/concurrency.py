"""CSP concurrency shim: Go-style channels, `go`, and `select`; a copy of
``paddle_tpu/concurrency.py`` (it holds no jax).

Reference parity: paddle/fluid/framework/channel.h:33 (typed
buffered/unbuffered channels), operators/concurrency/go_op.cc:29 (spawn a
thread running a sub-computation), select_op.cc:36. The reference built
these INTO the graph as ops over C++ channel objects; SURVEY.md M6 ranks
an in-graph CSP runtime lowest-value on an accelerator (the compiled
step owns scheduling inside a step), so per the survey's prescription
this is a HOST-side shim: the same channel semantics for orchestrating
host work (readers, RPC pumps, multi-executor pipelines) around compiled
steps.

Semantics matched to channel.h / Go:
- unbuffered send rendezvouses: it returns only after a receiver has taken
  THIS item; buffered send blocks only while full;
- recv on a closed, drained channel returns (None, False);
- send on a closed channel raises ChannelClosed;
- select runs the first ready case without consuming from the others (no
  helper threads blocked on losing channels).
"""

import threading
import time


class ChannelClosed(Exception):
    pass


class _Item:
    __slots__ = ("value", "taken")

    def __init__(self, value):
        self.value = value
        self.taken = False


class Channel:
    """make_channel (channel.h MakeChannel): capacity 0 = unbuffered."""

    def __init__(self, capacity=0, dtype=None):
        self.capacity = capacity
        self.dtype = dtype   # kept for reference-API parity; not enforced
        self._closed = False
        self._cond = threading.Condition()
        self._items = []        # FIFO of _Item
        self._recv_waiting = 0  # receivers parked in recv()

    # -- blocking API ------------------------------------------------------
    def send(self, value):
        with self._cond:
            if self._closed:
                raise ChannelClosed("send on closed channel")
            while self.capacity > 0 and len(self._items) >= self.capacity:
                self._cond.wait(0.05)
                if self._closed:
                    raise ChannelClosed("send on closed channel")
            item = _Item(value)
            self._items.append(item)
            self._cond.notify_all()
            if self.capacity == 0:
                # rendezvous: complete only when THIS item is received
                while not item.taken:
                    if self._closed and item in self._items:
                        self._items.remove(item)
                        raise ChannelClosed("send on closed channel")
                    self._cond.wait(0.05)
            return True

    def recv(self):
        """Returns (value, ok). ok=False iff closed and drained."""
        with self._cond:
            while True:
                v, ok, ready = self._try_recv_locked()
                if ready:
                    return v, ok
                self._recv_waiting += 1
                try:
                    self._cond.wait(0.05)
                finally:
                    self._recv_waiting -= 1

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def __iter__(self):
        while True:
            v, ok = self.recv()
            if not ok:
                return
            yield v

    # -- non-blocking core (select uses these; no consuming threads) ------
    def _try_recv_locked(self):
        if self._items:
            item = self._items.pop(0)
            item.taken = True
            self._cond.notify_all()
            return item.value, True, True
        if self._closed:
            return None, False, True
        return None, False, False

    def try_recv(self):
        """(value, ok, ready): ready=False means would-block."""
        with self._cond:
            return self._try_recv_locked()

    def try_send(self, value):
        """(sent, ready): non-blocking. Buffered: succeeds while a slot is
        free. Unbuffered: succeeds only when a receiver is parked in
        recv() (it will take the item as soon as the lock is released) —
        a close approximation of rendezvous for select's retry loop; two
        racing try_sends against one receiver can both enqueue, in which
        case the second item waits for the next receiver. Raises
        ChannelClosed on a closed channel (Go panics there)."""
        with self._cond:
            if self._closed:
                raise ChannelClosed("send on closed channel")
            if self.capacity > 0:
                if len(self._items) < self.capacity:
                    self._items.append(_Item(value))
                    self._cond.notify_all()
                    return True, True
                return False, False
            if self._recv_waiting > len(self._items):
                self._items.append(_Item(value))
                self._cond.notify_all()
                return True, True
            return False, False


def make_channel(dtype=None, capacity=0):
    return Channel(capacity=capacity, dtype=dtype)


def channel_send(ch, value):
    try:
        ch.send(value)
        return True
    except ChannelClosed:
        return False


def channel_recv(ch):
    return ch.recv()


def channel_close(ch):
    ch.close()


def go(fn, *args, **kwargs):
    """go_op.cc:29 — run fn concurrently; returns the Thread (daemonized,
    like the reference's detached executor thread)."""
    t = threading.Thread(target=fn, args=args, kwargs=kwargs, daemon=True)
    t.start()
    return t


class _Case:
    def __init__(self, kind, ch, value=None, action=None):
        self.kind, self.ch, self.value, self.action = kind, ch, value, action


def case_recv(ch, action):
    """select case: on receive, call action(value, ok)."""
    return _Case("recv", ch, action=action)


def case_send(ch, value, action=None):
    """select case: when the send completes, call action()."""
    return _Case("send", ch, value=value, action=action)


def select(cases, timeout=None):
    """select_op.cc:36 — run the FIRST case that becomes ready.

    Polls the cases' non-blocking primitives (10k/s), so losing cases are
    never touched: no helper threads, nothing consumed from channels that
    didn't win. A closed channel makes a recv case ready with ok=False
    (Go semantics); a closed send case raises ChannelClosed. Returns the
    winning action's result, or None on timeout.
    """
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        for case in cases:
            if case.kind == "recv":
                v, ok, ready = case.ch.try_recv()
                if ready:
                    if case.action is None:
                        return ("recv", v, ok)
                    return case.action(v, ok)
            else:
                sent, ready = case.ch.try_send(case.value)
                if ready and sent:
                    if case.action is None:
                        return ("sent",)
                    return case.action()
        if deadline is not None and time.monotonic() >= deadline:
            return None
        time.sleep(1e-4)
