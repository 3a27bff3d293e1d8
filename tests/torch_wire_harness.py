"""Shared helpers of the port's wire tests (``tests/test_torch_*.py``
over ``paddle_tpu_torch.distributed``).

Every wait is bounded and event-driven: ``until`` polls a condition up
to a timeout (a lease expiry, a server's barrier count), and
``wait_serving`` polls an endpoint until it accepts a connection, so no
rendezvous rests on a fixed sleep and no assertion reads the clock.
"""

import os
import socket
import threading
import time

import numpy as np


def until(pred, timeout=10.0, every=0.01, what=None):
    """Poll ``pred()`` until it returns a truthy value (returned) or
    ``timeout`` seconds pass (AssertionError)."""
    end = time.monotonic() + timeout
    while True:
        got = pred()
        if got:
            return got
        if time.monotonic() > end:
            raise AssertionError("condition not reached in %.1f s: %s"
                                 % (timeout, what or pred))
        time.sleep(every)


def wait_serving(ep, timeout=10.0):
    """Block until ``host:port`` accepts a TCP connection."""
    host, port = ep.rsplit(":", 1)

    def ready():
        try:
            with socket.create_connection((host, int(port)), timeout=1.0):
                return True
        except OSError:
            return False

    until(ready, timeout, 0.01, "server at %s" % ep)


def wait_port_file(path, timeout=10.0):
    """Block until a server's port file holds its port; returns it."""
    def read():
        try:
            with open(path) as f:
                txt = f.read().strip()
        except OSError:
            return None
        return int(txt) if txt else None

    return until(read, timeout, 0.01, "port file %s" % path)


def probe_ports(n):
    """``n`` free localhost endpoints (bound once and released)."""
    socks, eps = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        eps.append("127.0.0.1:%d" % s.getsockname()[1])
    for s in socks:
        s.close()
    return eps


def boot_pservers(fluid, t, eps, tmpdir, init=None):
    """One pserver thread of package ``fluid`` a transpiled endpoint,
    each on ``fluid.CPUPlace()``: its startup program run, ``init``
    ({name: array}, a table given whole) loaded over it, then its
    listen_and_serv program. Returns ([(scope, thread)], errors): the
    call returns once every server has written its port file."""
    out, errors = [], []
    n = len(eps)
    for i, ep in enumerate(eps):
        pf = os.path.join(str(tmpdir), "port_%d_%s" % (
            i, ep.replace(":", "_")))
        prog = t.get_pserver_program(ep, port_file=pf)
        start = t.get_startup_program(ep, prog)
        scope = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(start, scope=scope)
        for name, arr in (init or {}).items():
            have = scope.find_var(name)
            if have is None:
                continue
            shape = tuple(np.shape(np.asarray(have)))
            arr = np.asarray(arr)
            if shape != arr.shape:          # a table's row shard
                shard = arr[i::n]
                pad = np.zeros((shape[0] - shard.shape[0],) + shape[1:],
                               arr.dtype)
                arr = np.concatenate([shard, pad])
            _set(fluid, scope, name, arr)

        def run(prog=prog, scope=scope):
            try:
                fluid.Executor(fluid.CPUPlace()).run(
                    prog, feed={}, fetch_list=[], scope=scope)
            except BaseException as e:      # surfaced by the caller
                errors.append(repr(e))

        th = threading.Thread(target=run, daemon=True)
        th.start()
        wait_port_file(pf)
        out.append((scope, th))
    return out, errors


def _set(fluid, scope, name, arr):
    if fluid.__name__ == "paddle_tpu_torch":
        fluid.load_numpy_state(scope, {name: arr}, "cpu")
    else:
        scope.set(name, arr)


def shutdown(eps, rpc_module, dist_ops, servers=()):
    """EXIT every endpoint, drop the cached clients, join the server
    threads (bounded)."""
    for ep in eps:
        try:
            cli = rpc_module.RPCClient(ep, timeout=5.0)
            cli.shutdown_server()
            cli.close()
        except OSError:
            pass
    dist_ops.reset_clients()
    for _, th in servers:
        th.join(timeout=10)


def table_from_shards(scopes, name, vocab, get):
    """The global [vocab, D] table from its mod-sharded row stores."""
    n = len(scopes)
    parts = [get(s, name) for s in scopes]
    table = np.zeros((vocab,) + parts[0].shape[1:], parts[0].dtype)
    for i, shard in enumerate(parts):
        for local in range(shard.shape[0]):
            g = local * n + i
            if g < vocab:
                table[g] = shard[local]
    return table
