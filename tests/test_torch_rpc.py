"""The port's wire against the JAX package's (paddle_tpu_torch.
distributed.rpc, a copy of paddle_tpu/distributed/rpc.py).

  * ``serialize_var`` of dense, LoD and SelectedRows values gives the
    same bytes in both packages, and each package reads the other's;
  * a port ``RPCClient`` against a JAX ``VariableServer``, and a JAX
    client against a port server, round-trip PUT, GET, SEND, PRFT, BARR
    and CHNK (a chunk-parallel push: the threshold is lowered so a small
    value takes that path);
  * a port client's trace context arrives as the parent of the JAX
    server's span (each package's tracer armed in this one process,
    each with its own span log).

Every server is started before its client connects (``start()`` binds
and listens), so no rendezvous waits.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import trace as ttrace
from paddle_tpu_torch.core.lod import LoDTensor as TLoD
from paddle_tpu_torch.core.selected_rows import SelectedRows as TSR
from paddle_tpu_torch.distributed import rpc as trpc

import paddle_tpu  # noqa: F401
from paddle_tpu import trace as jtrace
from paddle_tpu.core.lod import LoDTensor as JLoD
from paddle_tpu.core.selected_rows import SelectedRows as JSR
from paddle_tpu.distributed import rpc as jrpc

assert tfluid.__name__ == "paddle_tpu_torch"

DENSE = [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.arange(6, dtype=np.int64).reshape(2, 3),
    np.array([1.5, -2.0], np.float16),
    np.array([True, False, True]),
    np.array(3.25, np.float32),
    np.zeros((0, 5), np.float32),
    np.random.RandomState(0).rand(2, 3, 4).astype(np.float64),
]


@pytest.mark.parametrize("i", range(len(DENSE)))
def test_dense_bytes_match_the_jax_package(i):
    arr = DENSE[i]
    got = trpc.serialize_var(arr)
    assert got == jrpc.serialize_var(arr)
    # a tensor goes on the wire as its host copy: the same bytes
    assert trpc.serialize_var(torch.from_numpy(arr.copy())) == got
    back = trpc.deserialize_var(bytearray(jrpc.serialize_var(arr)))
    np.testing.assert_array_equal(back, arr)
    # a 0-d value travels as [1] (np.ascontiguousarray), in both
    want_shape = np.ascontiguousarray(arr).shape
    assert back.dtype == arr.dtype and back.shape == want_shape
    np.testing.assert_array_equal(jrpc.deserialize_var(bytearray(got)), arr)


def test_lod_bytes_match_the_jax_package():
    """A LoD value travels as its flat rows (the JAX package's wire has
    no LoD kind: the lengths ride as their own ``@LOD`` var)."""
    data = np.arange(10, dtype=np.float32).reshape(5, 2)
    lengths = [[2, 3]]
    t, j = TLoD(data, lengths), JLoD(data, lengths)
    assert trpc.serialize_var(t) == jrpc.serialize_var(j)
    np.testing.assert_array_equal(trpc.deserialize_var(
        bytearray(jrpc.serialize_var(j))), data)


@pytest.mark.parametrize("rows, width, height", [
    ([3, 0, 7, 3], 4, 10), ([], 2, 5), ([1], 1, 2)])
def test_selected_rows_bytes_match_the_jax_package(rows, width, height):
    rng = np.random.RandomState(len(rows))
    value = rng.rand(len(rows), width).astype(np.float32)
    t = TSR(torch.tensor(rows, dtype=torch.int64),
            torch.from_numpy(value), height)
    j = JSR(np.asarray(rows, np.int64), value, height)
    got = trpc.serialize_var(t)
    assert got == jrpc.serialize_var(j)
    back = trpc.deserialize_var(bytearray(jrpc.serialize_var(j)))
    assert isinstance(back, TSR) and back.height == height
    np.testing.assert_array_equal(back.rows.numpy(), rows)
    np.testing.assert_array_equal(back.value.numpy(), value)
    jback = jrpc.deserialize_var(bytearray(got))
    assert isinstance(jback, JSR) and jback.height == height
    np.testing.assert_array_equal(jback.value, value)


def test_frames_match_the_jax_package():
    """One frame of each kind, written by each package's ``_send_msg``
    into a socket pair: the same bytes."""
    import socket
    frames = [("GET", "w", b""), ("SEND", "w@GRAD||t0:i1:s0",
                                  trpc.serialize_var(DENSE[0])),
              ("BARR", "t0:i1:s0", b""), ("OK", "", b"")]
    for op, name, payload in frames:
        got = []
        for mod in (trpc, jrpc):
            a, b = socket.socketpair()
            try:
                mod._send_msg(a, op, name, payload)
                a.shutdown(socket.SHUT_WR)
                buf = b""
                while True:
                    chunk = b.recv(1 << 16)
                    if not chunk:
                        break
                    buf += chunk
                got.append(buf)
            finally:
                a.close()
                b.close()
        assert got[0] == got[1], op


def _sgd(store, grads):
    for k, g in grads.items():
        p = k.replace("@GRAD", "")
        if p not in store:
            continue
        if hasattr(g, "rows"):
            rows = np.asarray(g.rows.numpy() if hasattr(g.rows, "numpy")
                              else g.rows)
            val = np.asarray(g.value.numpy() if hasattr(g.value, "numpy")
                             else g.value)
            w = np.array(store[p])
            np.add.at(w, rows, -0.5 * val)
            store[p] = w
        else:
            store[p] = np.asarray(store[p]) - 0.5 * np.asarray(g)


def _round_trip(client_mod, server_mod, sr_cls, monkeypatch):
    server = server_mod.VariableServer(fan_in=1, optimize_fn=_sgd).start()
    ep = "127.0.0.1:%d" % server.port
    monkeypatch.setattr(client_mod, "_CHUNK_THRESHOLD", 1024)
    monkeypatch.setattr(client_mod, "_CHUNK_STREAMS", 3)
    try:
        with client_mod.RPCClient(ep) as cli:
            w = np.arange(8, dtype=np.float32).reshape(4, 2)
            cli.put_var("w", w)                                   # PUT
            np.testing.assert_array_equal(cli.get_var("w"), w)    # GET
            big = np.random.RandomState(1).rand(64, 64).astype(np.float32)
            chunked = client_mod._RPC_CHUNK_PUSHES.value()
            cli.put_var("big", big)                     # PUT over CHNK
            assert client_mod._RPC_CHUNK_PUSHES.value() == chunked + 1
            np.testing.assert_array_equal(cli.get_var("big"), big)
            # SEND + BARR: one tagged round applies the update once
            cli.send_var("w@GRAD", np.ones((4, 2), np.float32),
                         tag="t0:i0000000000000001ab:s0")
            cli.barrier(tag="t0:i0000000000000001ab:s0")
            np.testing.assert_allclose(cli.get_var("w"), w - 0.5)
            # a retried round is dropped (exactly-once)
            cli.send_var("w@GRAD", np.ones((4, 2), np.float32),
                         tag="t0:i0000000000000001ab:s0")
            cli.barrier(tag="t0:i0000000000000001ab:s0")
            np.testing.assert_allclose(cli.get_var("w"), w - 0.5)
            # a SelectedRows SEND (a sparse grad) and a PRFT of rows
            cli.put_var("emb", np.zeros((6, 3), np.float32))
            cli.send_var("emb@GRAD", sr_cls(
                *_sr_args(sr_cls, [1, 4], np.ones((2, 3), np.float32), 6)),
                tag="t0:i0000000000000001ab:s1")
            cli.barrier(tag="t0:i0000000000000001ab:s1")
            rows = cli.prefetch("emb", np.array([4, 0, 1], np.int64))
            got_rows = np.asarray(rows.rows.numpy()
                                  if hasattr(rows.rows, "numpy")
                                  else rows.rows)
            got_val = np.asarray(rows.value.numpy()
                                 if hasattr(rows.value, "numpy")
                                 else rows.value)
            np.testing.assert_array_equal(got_rows, [4, 0, 1])
            np.testing.assert_allclose(got_val, [[-0.5] * 3, [0] * 3,
                                                 [-0.5] * 3])
            assert server._round == 2      # the retried round: dropped
            with pytest.raises(KeyError):
                cli.get_var("absent")
    finally:
        server.stop()


def _sr_args(sr_cls, rows, value, height):
    if sr_cls is TSR:
        return (torch.tensor(rows, dtype=torch.int64),
                torch.from_numpy(value), height)
    return (np.asarray(rows, np.int64), value, height)


def test_port_client_against_jax_server(monkeypatch):
    _round_trip(trpc, jrpc, TSR, monkeypatch)


def test_jax_client_against_port_server(monkeypatch):
    _round_trip(jrpc, trpc, JSR, monkeypatch)


def test_port_client_against_port_server(monkeypatch):
    _round_trip(trpc, trpc, TSR, monkeypatch)


def test_port_trace_context_parents_the_jax_server_span(tmp_path):
    """The port's tracer (the client's) and the JAX package's (the
    server's) armed at once, each with its own log: the JAX server's
    ``pserver.GET`` span has the port client's ``rpc.get`` span as its
    parent, under the same trace id."""
    tlog, jlog = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    jtrace.enable(log_path=jlog, proc="pserver")
    server = jrpc.VariableServer().start()
    try:
        ttrace.enable(log_path=tlog, proc="trainer")
        try:
            with ttrace.span("round"):
                with trpc.RPCClient("127.0.0.1:%d" % server.port) as cli:
                    cli.put_var("w", np.ones(3, np.float32))
                    cli.get_var("w")
        finally:
            ttrace.disable()
    finally:
        server.stop()
        jtrace.disable()

    def spans(path):
        return [r for r in map(json.loads, open(path))
                if r.get("ev") == "span"]

    client = {s["span"]: s for s in spans(tlog)}
    gets = [s for s in spans(jlog) if s["name"] == "pserver.GET"]
    assert len(gets) == 1
    parent = client[gets[0]["parent"]]
    assert parent["name"] == "rpc.get"
    assert gets[0]["trace"] == parent["trace"]
    root = next(s for s in client.values() if s["name"] == "round")
    assert parent["trace"] == root["trace"]


def test_dump_reply_reads_only_ported_modules(tmp_path):
    """A DUMP capture (the JAX package's forensics verb) answers in full
    from the port: the pserver's state, the metrics snapshot, the flags
    that differ from their defaults, and the span ring, never an empty
    reply; a JAX client reads it."""
    import socket
    from paddle_tpu_torch import flags
    ttrace.enable(log_path=str(tmp_path / "t.jsonl"), proc="pserver")
    flags.set_flag("rpc_retry_deadline", 9.0)
    server = trpc.VariableServer(fan_in=2).start()
    try:
        with ttrace.span("round"):
            with trpc.RPCClient("127.0.0.1:%d" % server.port) as cli:
                cli.put_var("w", np.ones(2, np.float32))
        with socket.create_connection(("127.0.0.1", server.port),
                                      timeout=30) as s:
            jrpc._send_msg(s, "DUMP", "", json.dumps(
                {"spans_max": 64}).encode())
            op, _, payload = jrpc._recv_msg(s)
    finally:
        server.stop()
        flags.set_flag("rpc_retry_deadline", None)
        ttrace.disable()
    assert op == "VAL"
    body = json.loads(bytes(payload).decode())
    assert body["role"] == "pserver"
    assert body["state"]["vars"] == 1 and body["state"]["fan_in"] == 2
    assert body["flags"] == {"rpc_retry_deadline": 9.0}
    assert "ptpu_rpc_requests_total" in json.dumps(body["snapshot"])
    spans = [r for r in body["spans"] if r["ev"] == "span"]
    assert any(r["name"] == "pserver.PUT" for r in spans)
