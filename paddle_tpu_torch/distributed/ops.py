"""Distributed host ops: the wire (send, send_barrier, send_sparse,
recv, prefetch, listen_and_serv) and the SelectedRows ops (split_ids,
split_selected_rows, merge_selected_rows, lookup_sparse_table).

The counterpart of ``paddle_tpu/distributed/ops.py``
(operators/{send,send_vars,send_barrier,recv,prefetch,listen_and_serv,
split_ids,split_selected_rows,merge_selected_rows,lookup_sparse_table}
_op.cc). All are host ops (``register(..., host=True)``): a program that
holds one runs through ``Executor.run`` op by op, and
``Executor.run_steps`` refuses it.

The wire carries host numpy (``rpc.py``): ``send`` and ``send_sparse``
copy the trainer's gradients off its device at the send, ``recv`` and
``prefetch`` put what they fetch on the executor's device. The server
(``listen_and_serv``) keeps the JAX package's store: parameters and
optimizer state as numpy arrays; each round its optimize blocks run
through the port's lowerings on the pserver Executor's device (the card
unless the CPU was asked for), on tensors made from the store and the
merged gradients, and the updated state goes back into the store. The
SelectedRows ops keep their tensors on the executor's device; only the
row counts are read on the host.
"""

import threading
import weakref

import numpy as np
import torch

from ..core.registry import register
from ..core.scope import to_tensor
from ..core.selected_rows import SelectedRows, merge_rows
from ..resilience.retry import default_policy
from .rpc import RPCClient, StaleIncarnationError


# Per-THREAD connection cache: RPCClient is a plain socket with no
# framing lock, so two in-process trainers (threads) must not share one
# — each thread keeps its own connections, like two trainer processes
# would. The registry holds WEAK references: when a trainer thread
# dies, its cache is collected (closing the sockets via refcount)
# instead of pinning file descriptors forever. reset_clients() closes
# every live thread's connections.


class _Cache(dict):
    """dict subclass so the registry can hold weak references."""

    # dict disables hashing (value equality); the registry needs
    # identity hashing to hold caches in a WeakSet
    __hash__ = object.__hash__


_TLS = threading.local()
_ALL_CACHES = weakref.WeakSet()
_ALL_LOCK = threading.Lock()


def _client(ep):
    cache = getattr(_TLS, "clients", None)
    if cache is None:
        cache = _TLS.clients = _Cache()
        with _ALL_LOCK:
            _ALL_CACHES.add(cache)
    cli = cache.get(ep)
    if cli is None:
        # flag-gated transparent reconnect/retry (rpc_retry, default
        # on): the executor's tagged round sends are exactly-once
        # server-side, so a broken socket is re-issued instead of
        # killing the step — rpc.py documents which verbs qualify
        cli = cache[ep] = RPCClient(ep, retry=default_policy())
    return cli


def reset_clients():
    # close + clear every live thread's connections; threads reconnect
    # lazily on next use
    with _ALL_LOCK:
        caches = list(_ALL_CACHES)
    for cache in caches:
        for cli in cache.values():
            cli.close()
        cache.clear()


def _round_tag(ctx, op):
    """Idempotency tag for this trainer's current round:
    t<trainer>:i<incarnation>:s<seq>. The server replaces a retried
    (name, tag) send, drops sends/barriers of already-applied rounds,
    and evicts pending grads of a dead incarnation (rpc.py SEND/BARR).
    None when the executor doesn't track rounds."""
    seq = getattr(ctx, "run_seq", None)
    if seq is None:
        return None
    return "t%s:i%s:s%d" % (op.attr("trainer_id", 0),
                            getattr(ctx, "incarnation", "0"), seq)


def _bump_incarnation(ctx, exc):
    """A server judged this trainer's incarnation stale (clock skew
    after an elastic reschedule can make a LIVE replacement look like a
    dead straggler — rpc.StaleIncarnationError). Re-incarnate the
    executor past the server's max epoch and rebuild ctx.incarnation,
    preserving the per-program nonce suffix."""
    ex = getattr(ctx, "executor", None)
    old = getattr(ctx, "incarnation", "")
    exec_inc = getattr(ex, "_incarnation", "")
    if not exec_inc or not old.startswith(exec_inc):
        raise exc          # no executor-owned incarnation to renew
    program_nonce = old[len(exec_inc):]
    ctx.incarnation = ex._reincarnate(exc.max_epoch) + program_nonce


def _retrying_round(ctx, op, body):
    """Run `body(tag)` with stale-incarnation recovery.

    Re-incarnating changes the round tag, and the server's idempotency
    bookkeeping is keyed by it — so a retry must (a) replay EVERY
    tagged send body of this round, not just the failing op (an earlier
    op's pending grads under the old tag are evicted by the first
    new-tag message and would otherwise be silently lost), and (b) skip
    endpoints whose round barrier already completed (their round closed
    WITH our old-tag grads applied; a new-tag resend would bypass the
    seq dedup and double-apply). Bodies honor (b) via
    ``ctx.round_closed_eps``. Both records live on ctx, which is fresh
    per Executor.run, i.e. per round. Bounded attempts: several servers
    may each hold a higher max epoch, needing one bump per offender."""
    journal = getattr(ctx, "_round_journal", None)
    if journal is None:
        journal = ctx._round_journal = []
        ctx.round_closed_eps = set()
    journal.append(body)
    replay_from = len(journal) - 1       # first attempt: just this op
    for _ in range(5):
        try:
            tag = _round_tag(ctx, op)
            for b in journal[replay_from:]:
                b(tag)
            return
        except StaleIncarnationError as exc:
            _bump_incarnation(ctx, exc)
            replay_from = 0              # new tag: replay the full round
    raise RuntimeError(
        "send round still judged stale after 5 re-incarnations")


def _wire(value):
    """A scope or env value as the wire carries it: a SelectedRows as it
    is (rpc serializes its numpy view), anything else as a host numpy
    array."""
    if isinstance(value, SelectedRows):
        return value
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


@register("send", host=True)
def _send(ctx, op):
    """Push each input var to its endpoint (send_op.cc / send_vars)."""
    eps = op.attr("epmap") or op.attr("endpoints") or []
    names = op.input("X")
    # one copy off the device a gradient, made before the first byte is
    # sent (a stale-incarnation replay sends the same host copy again)
    values = [_wire(ctx.get(name)) for name in names]

    def round_body(tag):
        closed = getattr(ctx, "round_closed_eps", set())
        for i, name in enumerate(names):
            ep = eps[i % len(eps)]
            if ep in closed:
                continue    # that server's round already applied these
            _client(ep).send_var(op.attr("send_names", names)[i]
                                 if op.attr("send_names") else name,
                                 values[i], tag=tag)
        # barrier EVERY transpiled endpoint, not just the ones that
        # received a dense grad: a server owning only a sparse-table
        # shard still needs this trainer's round signal
        # (listen_and_serv fan_in semantics). Every trainer barriers the
        # endpoints in the transpiled order: an order of its own (a
        # set's, which follows the process's string hash seed) lets two
        # trainer processes each wait at a server the other has not
        # reached, and the round never closes
        if op.attr("sync", True):
            for ep in dict.fromkeys(op.attr("endpoints") or eps):
                if ep in closed:
                    continue
                _client(ep).barrier(tag=tag)
                closed.add(ep)

    _retrying_round(ctx, op, round_body)


@register("send_barrier", host=True)
def _send_barrier(ctx, op):
    for ep in (op.attr("endpoints") or []):
        _client(ep).barrier()


@register("send_sparse", host=True)
def _send_sparse(ctx, op):
    """Route a distributed embedding-table gradient to its shards: pair
    each prefetch's ids with the grad of its output rows, sum duplicate
    ids, split by ``id % num_shards`` and SEND each part as SelectedRows
    with GLOBAL row ids under ``grad_name`` (the reference trainer's
    split_ids + send-of-SelectedRows, distribute_transpiler.py:201-255).
    No barrier here — the program's trailing send barriers close the
    round for every endpoint. The sums run on the host in numpy, as in
    the JAX package (``np.add.at`` in id order)."""
    eps = op.attr("epmap") or op.attr("endpoints") or []
    grad_name = op.attr("grad_name")
    height = int(op.attr("height"))
    id_names = op.input("Ids")
    grad_names = op.input("Grads")
    all_ids = []
    all_rows = []
    for idn, gn in zip(id_names, grad_names):
        ids = _wire(ctx.env[idn]).reshape(-1).astype(np.int64)
        if ids.size == 0:
            continue
        g = _wire(ctx.env[gn])
        g = g.reshape(ids.size, -1)
        all_ids.append(ids)
        all_rows.append(g)
    if not all_ids:
        return            # an empty batch sends nothing this round
    ids = np.concatenate(all_ids)
    rows = np.concatenate(all_rows)
    # sum duplicate ids (a batch repeats hot ids; the update must see one
    # accumulated row per id, lookup_table_grad SelectedRows semantics)
    uniq, inv = np.unique(ids, return_inverse=True)
    acc = np.zeros((len(uniq), rows.shape[1]), rows.dtype)
    np.add.at(acc, inv, rows)
    n = max(1, len(eps))

    def round_body(tag):
        closed = getattr(ctx, "round_closed_eps", set())
        for i, ep in enumerate(eps):
            mask = (uniq % n) == i
            if not mask.any() or ep in closed:
                continue
            _client(ep).send_var(
                grad_name, SelectedRows(torch.from_numpy(uniq[mask]),
                                        torch.from_numpy(acc[mask]),
                                        height),
                tag=tag)

    _retrying_round(ctx, op, round_body)


@register("recv", host=True)
def _recv(ctx, op):
    """Fetch each output var from its endpoint onto the executor's
    device."""
    eps = op.attr("epmap") or op.attr("endpoints") or []
    outs = op.output("Out")
    fetch_names = op.attr("recv_names") or outs
    for i, out in enumerate(outs):
        ep = eps[i % len(eps)]
        ctx.env[out] = to_tensor(_client(ep).get_var(fetch_names[i]),
                                 ctx.device)


@register("prefetch", host=True)
def _prefetch(ctx, op):
    """Fetch embedding rows by id from the sharded table
    (prefetch_op.cc + distributed lookup table) onto the executor's
    device."""
    eps = op.attr("epmap") or op.attr("endpoints") or []
    table = op.attr("table_name")
    ids_arr = _wire(ctx.in1(op, "X"))
    ids = ids_arr.reshape(-1).astype(np.int64)
    # shard ids across endpoints like split_ids (round robin by id % n);
    # UNIQUE ids per shard — a batch repeats hot ids, and SelectedRows
    # merge would sum duplicate returned rows (it is a grad-accumulate)
    n = len(eps)
    parts = [np.unique(ids[ids % n == i]) for i in range(n)]
    got_rows, got_vals = [], []
    for ep, part in zip(eps, parts):
        if len(part) == 0:
            continue
        rows, vals = _client(ep).prefetch(table, part).numpy()
        got_rows.append(rows)
        got_vals.append(vals)
    if got_rows:
        rows = np.concatenate(got_rows)
        vals = np.concatenate(got_vals)
        width = vals.shape[1] if vals.ndim > 1 else 1
        # rows aligned with the request order (each id is held once)
        order = np.argsort(rows, kind="stable")
        pos = order[np.searchsorted(rows[order], ids)]
        out = vals.reshape(len(rows), width)[pos]
    else:
        width = 1
        out = np.zeros((0, width), np.float32)
    # embedding-layer output shape: ids shape (trailing 1 stripped) + [D]
    lead = ids_arr.shape
    if lead and lead[-1] == 1:
        lead = lead[:-1]
    ctx.set_out(op, "Out", to_tensor(out.reshape(tuple(lead) + (width,)),
                                     ctx.device))


@register("listen_and_serv", host=True)
def _listen_and_serv(ctx, op):
    """Run the parameter-server loop until shutdown
    (listen_and_serv_op.cc:76-239). The optimize step per round runs the
    op's sub-block through the port's lowerings on the executor's
    device, with the merged grads bound."""
    from .rpc import VariableServer
    from ..core.executor import _lower_op
    from ..core.registry import LowerContext

    fan_in = int(op.attr("Fanin", op.attr("fan_in", 1)))
    sync_mode = bool(op.attr("sync_mode", True))
    endpoint = op.attr("endpoint", "127.0.0.1:0")
    port_file = op.attr("port_file")
    param_names = op.attr("param_names") or []
    grad_names = op.attr("grad_names") or []
    sparse_tables = dict(op.attr("sparse_tables") or {})
    sparse_grad_of = {t + "@GRAD": t for t in sparse_tables}
    blocks = op.attr("optimize_blocks") or []
    if not isinstance(blocks, (list, tuple)):
        blocks = [blocks]
    device = ctx.device
    # every var the optimize blocks read or write, minus the per-round
    # gradients: params AND optimizer state (moments, beta pows, lr).
    # All of it must live in the server store ACROSS rounds — resetting
    # adam moments every round would silently break stateful optimizers
    # (ParameterServer2 keeps momentum buffers server-side the same way).
    state_names = set(param_names)
    for blk in blocks:
        for op2 in blk.ops:
            for coll in (op2.inputs, op2.outputs):
                for ns in coll.values():
                    state_names.update(ns)
    state_names -= set(grad_names)
    state_names -= {g for g in state_names if g.endswith("@GRAD")}

    def optimize_fn(store, merged_grads):
        env = {k: v for k, v in ctx.env.items()
               if not isinstance(v, VariableServer)}
        env.update({k: to_tensor(v, device) for k, v in store.items()})
        for g, val in merged_grads.items():
            tbl = sparse_grad_of.get(g)
            if tbl is not None and isinstance(val, SelectedRows):
                # sharded-table grad: global row ids → this shard's
                # compact local indices (g // n); KEEP SelectedRows so
                # the optimizer applies a sparse row update, never a
                # dense [V, D] materialization
                meta = sparse_tables[tbl]
                n = int(meta["num_shards"])
                local_h = int(np.asarray(store[tbl]).shape[0]) \
                    if tbl in store else -(-int(meta["height"]) // n)
                env[g] = SelectedRows(val.rows // n, val.value,
                                      local_h).to(device)
                continue
            env[g] = val.to_dense().to(device) \
                if isinstance(val, SelectedRows) else to_tensor(val, device)
        sctx = LowerContext(env, device, executor=ctx.executor,
                            seed_fn=ctx._seed_fn, rng_keys=ctx.rng_keys)
        # async mode delivers one grad at a time: skip optimize ops whose
        # grad input didn't arrive, and propagate the skip transitively so
        # consumers of a skipped op's outputs (e.g. clip → sgd chains)
        # don't run against missing/stale values
        tainted = {g for g in grad_names if g not in merged_grads}
        with torch.no_grad():
            for blk in blocks:
                for op2 in blk.ops:
                    refs = [n for ns in op2.inputs.values() for n in ns]
                    if any(n in tainted for n in refs):
                        tainted.update(n for ns in op2.outputs.values()
                                       for n in ns)
                        continue
                    _lower_op(sctx, op2)
        for p in state_names:
            if p in env and p not in tainted:
                store[p] = _wire(env[p])

    host, port = endpoint.rsplit(":", 1)
    server = VariableServer(host=host, port=int(port), fan_in=fan_in,
                            optimize_fn=optimize_fn, port_file=port_file,
                            sync=sync_mode, sparse_tables=sparse_tables)
    # publish initial params + optimizer state from the scope/env
    for p in state_names:
        if p in ctx.env:
            server.store[p] = _wire(ctx.env[p])
    server.start()
    ctx.env["@PSERVER@"] = server
    if op.attr("blocking", True):
        server._shutdown.wait()
        # EXIT's handler thread may still be closing the listener: close
        # it here too, so the endpoint is free when this op returns (a
        # next listen_and_serv on the same endpoint binds it again)
        server.stop()
    # commit updated params + state back
    for p in state_names:
        if p in server.store:
            ctx.env[p] = to_tensor(server.store[p], device)


@register("split_ids", host=True)
def _split_ids(ctx, op):
    """Ids split by id mod the number of outputs, each [n_i, 1] int64."""
    ids = ctx.in1(op, "Ids").reshape(-1).long()
    outs = op.output("Out")
    n = len(outs)
    for i, out in enumerate(outs):
        ctx.env[out] = ids[ids % n == i].reshape(-1, 1)


@register("split_selected_rows", host=True)
def _split_selected_rows(ctx, op):
    """X cut into row ranges (``height_sections``, else equal ranges of
    its height), each with its rows made local to its range."""
    sr = ctx.in1(op, "X")
    outs = op.output("Out")
    sections = op.attr("height_sections") or []
    if sections:
        bounds = [0]
        for h in sections:
            bounds.append(bounds[-1] + int(h))
    else:       # np.linspace(0, height, n + 1), truncated
        n = len(outs)
        bounds = [int(i * (sr.height / n)) for i in range(n)] + [sr.height]
    for i, out in enumerate(outs):
        lo, hi = bounds[i], bounds[i + 1]
        mask = (sr.rows >= lo) & (sr.rows < hi)
        ctx.env[out] = SelectedRows(sr.rows[mask] - lo, sr.value[mask],
                                    hi - lo)


@register("merge_selected_rows", host=True)
def _merge_selected_rows(ctx, op):
    """X with its duplicate rows summed, rows sorted; a dense X passes."""
    sr = ctx.in1(op, "X")
    if isinstance(sr, SelectedRows):
        sr = merge_rows(sr.rows, sr.value, sr.height)
    ctx.set_out(op, "Out", sr)


@register("lookup_sparse_table", host=True)
def _lookup_sparse_table(ctx, op):
    """The rows of a SelectedRows-stored table W at Ids (the last of a
    repeated row), zeros for an id it does not hold; a dense W is read
    at the ids clipped into it."""
    w = ctx.in1(op, "W")
    ids = ctx.in1(op, "Ids").reshape(-1).long()
    if isinstance(w, SelectedRows):
        ids = ids.to(w.device)
        hit = w.rows[None, :] == ids[:, None]               # [n, rows]
        found = hit.any(dim=1)
        pos = torch.where(hit, torch.arange(w.rows.shape[0],
                                            device=w.device), -1).amax(dim=1)
        rows = torch.where(found[:, None], w.value[pos],
                           torch.zeros((), dtype=w.value.dtype,
                                       device=w.device))
    else:
        rows = w[torch.clamp(ids, 0, w.shape[0] - 1)]
    ctx.set_out(op, "Out", rows)
