"""Pipeline parallelism over the ``pp`` mesh axis (GPipe + interleaved).

The counterpart of ``paddle_tpu/parallel/pipeline.py``. Stage parameters
are stacked on a leading [S, ...] axis sharded on ``pp``; every rank runs
the same stage function on its own parameter shard, and activations move
stage to stage by point-to-point sends. The schedules and microbatch
counts are the JAX package's:

  * ``gpipe``: S + M - 1 ticks for M microbatches; at tick t stage s
    runs microbatch t - s;
  * ``gpipe_interleaved``: Megatron virtual stages, each rank holding V
    chunks {d, d+S, ...}; microbatch i enters at tick i and makes V laps,
    one hop a tick, M - 1 + V*S ticks, M <= S.

The JAX tick loop runs every stage at every tick and masks the bubble
ticks out; here a stage computes only its live ticks (the masked work is
never used, so the result is the same), and a tick's activation goes only
where the next live tick reads it. The loop is one
``torch.autograd.Function`` per shard, ``_TickLoop``, whose backward
runs the ticks in reverse, sending each input's gradient back to the
stage that produced it: PyTorch's autograd runs each rank's own graph, in
which a non-final stage's loss does not depend on its activations, so the
reverse pipeline is written out as JAX derives it from the forward. Each
live tick's graph is kept from the forward (``recompute`` on the stage
body trims it).

The final stage's outputs reach every rank by a psum over ``pp`` (the
other stages hold zeros), where the JAX package slices the last stage's
buffer out of a pp-sharded result. The aux-loss reduction follows
``_aux_reduce``: psum over ``pp`` of the live ticks' aux sums / M, then a
pmean over the token-splitting axes.

Heterogeneous stages (a list of per-stage parameter pytrees, replicated)
pick their branch by stage index, as ``lax.switch`` does there.
"""

import functools

import torch
import torch.distributed as dist

from . import collective as C
from ._shard_map import shard_map
from .mesh import PartitionSpec as P


def _flatten(tree):
    """(leaves, rebuild) of a dict / list / tuple pytree of tensors."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda ls: ls[0]
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    else:
        keys = None
        parts = [_flatten(v) for v in tree]
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(ls):
        out, i = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(ls[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


class _Schedule:
    """The static tick table of one shard: for tick t, whether the stage
    is live, which microbatch, whether the input is injected from ``xs``
    (else received from the previous stage), the local chunk, whether
    the output is written to the result, and whether it is sent on."""

    def __init__(self, s_idx, n_stage, m, n_chunks=None):
        self.s, self.n, self.m, self.v = s_idx, n_stage, m, n_chunks
        self.ticks = (n_stage + m - 1 if n_chunks is None
                      else m - 1 + n_chunks * n_stage)

    def at(self, t):
        s, n, m = self.s, self.n, self.m
        if self.v is None:                       # gpipe
            mb = t - s
            live = 0 <= mb < m
            return dict(live=live, mb=mb, inject=s == 0, chunk=0,
                        write=live and s == n - 1,
                        send=live and s < n - 1)
        total = self.v * n                       # interleaved
        h = t - ((t - s) % n)
        mb = t - h
        live = h >= 0 and h < total and mb < m
        return dict(live=live, mb=mb, inject=h == 0,
                    chunk=min(max(h // n, 0), self.v - 1),
                    write=live and h == total - 1,
                    send=live and h < total - 1)

    def recv(self, t):
        """Whether this stage receives its tick-t input from the
        previous stage (sent at the end of tick t - 1)."""
        a = self.at(t)
        return a["live"] and not a["inject"]


def _exchange(group, sched, send, recv_like, back=False):
    """One tick boundary: send ``send`` (or None) to the next stage and
    receive into a buffer like ``recv_like`` (or None) from the previous
    one; ``back`` the other way (the backward's gradients). Returns the
    received tensor or None."""
    if send is None and recv_like is None:
        return None
    if group is None:                            # one stage: a loopback
        return send.clone() if recv_like is not None else None
    n, s = sched.n, sched.s
    to, frm = (s + 1) % n, (s - 1) % n
    if back:
        to, frm = frm, to
    stage = C._stages(group, [t for t in (send, recv_like)
                              if t is not None])
    ops, buf = [], None
    if send is not None:
        C._count("send", [send])
        x = send.contiguous()
        x = C._host(x) if stage else x
        ops.append(dist.P2POp(dist.isend, x,
                              dist.get_global_rank(group, to), group))
    if recv_like is not None:
        buf = (C._pinned_like(recv_like) if stage
               else torch.empty(recv_like.shape, dtype=recv_like.dtype,
                                device=recv_like.device))
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, frm), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if buf is not None and stage:
        buf = C._back(buf, recv_like)
    return buf


class _TickLoop(torch.autograd.Function):
    """The tick loop of one shard (see the module docstring). Inputs: the
    microbatches xs [M, mb, ...] and the flattened local parameters;
    outputs: the final stage's [M, mb, ...] (zeros elsewhere) and the
    live ticks' aux sum / M."""

    @staticmethod
    def forward(ctx, runner, xs, *params):
        sched, group = runner.sched, runner.group
        leaves = [p.detach().requires_grad_(p.requires_grad)
                  for p in params]
        outputs = torch.zeros_like(xs)
        aux_sum = torch.zeros((), dtype=torch.float32, device=xs.device)
        records = {}
        prev_out = None
        for t in range(sched.ticks):
            a = sched.at(t)
            got = _exchange(group, sched, prev_out,
                            xs[0] if sched.recv(t) else None)
            prev_out = None
            if not a["live"]:
                continue
            inp = (xs[a["mb"]] if a["inject"] else got).detach()
            inp.requires_grad_(True)
            with torch.enable_grad():
                res = runner.apply(leaves, a["chunk"], inp)
            out, aux = res if runner.with_aux else (res, None)
            records[t] = (inp, out, aux)
            if aux is not None:
                aux_sum = aux_sum + aux.detach().float()
            if a["write"]:
                outputs[a["mb"]] = out.detach()
            if a["send"]:
                prev_out = out.detach()
        ctx.runner, ctx.records, ctx.leaves = runner, records, leaves
        ctx.xs_like = xs
        return outputs, aux_sum / sched.m

    @staticmethod
    def backward(ctx, g_out, g_aux):
        runner, records, leaves = ctx.runner, ctx.records, ctx.leaves
        sched, group = runner.sched, runner.group
        g_xs = torch.zeros_like(ctx.xs_like)
        g_params = [None] * len(leaves)
        g_send = None          # the gradient of my input at tick t + 1
        for t in reversed(range(sched.ticks)):
            a = sched.at(t)
            # reversed boundary t -> t+1: my input's gradient goes back to
            # the stage that sent it; my output's comes from its reader
            sent_here = a["send"]
            got = _exchange(group, sched, g_send,
                            ctx.xs_like[0] if sent_here else None,
                            back=True)
            g_send = None
            if not a["live"]:
                continue
            inp, out, aux = records[t]
            g = got
            if a["write"]:
                g = g_out[a["mb"]] if g is None else g + g_out[a["mb"]]
            outs, gs = [], []
            if g is not None:
                outs.append(out)
                gs.append(g)
            if aux is not None and g_aux is not None:
                outs.append(aux)
                gs.append((g_aux / sched.m).to(aux.dtype))
            g_inp = None
            if outs:
                wrt = [inp] + [p for p in leaves if p.requires_grad]
                grads = torch.autograd.grad(outs, wrt, gs,
                                            allow_unused=True)
                g_inp = grads[0]
                j = 1
                for i, p in enumerate(leaves):
                    if not p.requires_grad:
                        continue
                    gp = grads[j]
                    j += 1
                    if gp is not None:
                        g_params[i] = gp if g_params[i] is None \
                            else g_params[i] + gp
            if g_inp is None:
                g_inp = torch.zeros_like(inp)
            if a["inject"]:
                g_xs[a["mb"]] += g_inp
            else:
                g_send = g_inp
        ctx.records = None
        # zeros, not None, for a parameter this stage did not use (a
        # heterogeneous pipeline's other stages): its gradient still
        # meets the same reductions on every rank
        return (None, g_xs) + tuple(
            torch.zeros_like(p) if g is None and p.requires_grad else g
            for p, g in zip(leaves, g_params))


class _Runner:
    def __init__(self, apply, sched, group, with_aux):
        self.apply, self.sched, self.group = apply, sched, group
        self.with_aux = with_aux


def _aux_reduce(aux, axis_name, aux_mean_axes):
    """Stage aux sums add over pp (total over layers); members along the
    token-splitting axes (dp/ep/sp) hold different token groups, so their
    auxes average — matching a dense fallback that means over groups."""
    aux = C.psum(aux, axis_name)
    for ax in aux_mean_axes or ():
        aux = C.pmean(aux, ax)
    return aux


def _run(params, xs, apply, axis_name, n_chunks, with_aux, aux_mean_axes):
    """The shard body shared by every schedule: the tick loop, the
    final stage's outputs to every stage, the aux reduction."""
    s_idx = C.axis_index(axis_name)
    n_stage = C.axis_size(axis_name)
    sched = _Schedule(s_idx, n_stage, xs.shape[0], n_chunks)
    group = C._mesh().group(axis_name)
    leaves, rebuild = _flatten(params)
    runner = _Runner(lambda ls, chunk, x: apply(rebuild(ls), chunk, x),
                     sched, group, with_aux)
    outputs, aux = _TickLoop.apply(runner, xs, *leaves)
    outputs = C.psum(outputs, axis_name)
    if with_aux:
        return outputs, _aux_reduce(aux, axis_name, aux_mean_axes)
    return outputs


def _gpipe_sharded(params, xs, stage_fn, axis_name, with_aux=False,
                   aux_mean_axes=()):
    """Stacked (homogeneous) path: params leaves arrive [1, ...] — this
    shard's slice of the [S, ...] stack."""
    local = _tree(lambda p: p[0], params)
    return _run(local, xs, lambda p, chunk, x: stage_fn(p, x), axis_name,
                None, with_aux, aux_mean_axes)


def _reblock(p, n_chunks, axis_name):
    """This stage's contiguous rows [V * per, ...] (global chunks
    d*V .. d*V + V - 1) as its interleaved chunks {d, d+S, ...}
    [V, per, ...], by one tiled all_to_all over the stages (V a multiple
    of S): chunk a*S + r goes to stage r, which receives stage d's at
    position d*V/S + a, global chunk r + S*(d*V/S + a)."""
    s = C.axis_size(axis_name)
    per = p.shape[0] // n_chunks
    x = p.reshape((n_chunks // s, s, per) + tuple(p.shape[1:]))
    x = C.all_to_all(x, axis_name, 1, 0)
    return x.reshape((n_chunks, per) + tuple(p.shape[1:]))


def _interleaved_sharded(params, xs, stage_fn, axis_name, n_chunks,
                         with_aux=False, aux_mean_axes=(), rows=()):
    """Interleaved path: params leaves arrive [1, V, ...] — this shard's
    V chunk slices — or, the leaves at the flat indices ``rows``, [1,
    L/S, ...], this stage's contiguous rows, re-blocked here
    (``_reblock``). stage_fn(chunk_params, x) runs ONE chunk."""
    leaves, rebuild = _flatten(params)
    local = rebuild([_reblock(p[0], n_chunks, axis_name) if i in rows
                     else p[0] for i, p in enumerate(leaves)])
    return _run(local, xs,
                lambda p, chunk, x: stage_fn(_tree(lambda q: q[chunk], p),
                                             x),
                axis_name, n_chunks, with_aux, aux_mean_axes)


def _gpipe_hetero(params_seq, xs, stage_fn, axis_name):
    """Heterogeneous path: a tuple of per-stage pytrees, replicated; this
    stage runs its own."""
    s_idx = C.axis_index(axis_name)
    return _run(params_seq, xs,
                lambda p, chunk, x: stage_fn(p[s_idx], x), axis_name, None,
                False, ())


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    return _flatten(tree)[0]


def _param_specs(params, param_specs, head):
    if param_specs is None:
        return _tree(lambda _: P(*head), params)
    return _tree_specs(lambda sp: P(*(head + tuple(sp))), param_specs)


def _tree_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _tree_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_tree_specs(fn, v) for v in specs]
    return fn(specs)     # a tuple (or P) is one leaf's spec tail


def _aux_axes(batch_axis, seq_axis, with_aux):
    if not with_aux:
        return ()
    out = []
    for a in (batch_axis, seq_axis):
        if isinstance(a, (tuple, list)):
            out.extend(x for x in a if x)
        elif a:
            out.append(a)
    return tuple(out)


def gpipe(stage_fn, stacked_params, microbatches, mesh, axis_name="pp",
          batch_axis=None, param_specs=None, seq_axis=None,
          with_aux=False):
    """Run ``stage_fn(params_i, x)`` as an S-stage pipeline.

    stacked_params: EITHER a pytree whose leaves have leading dim S
                    (= mesh[axis]) — sharded on ``axis_name``; a leaf
                    marked ``_shard_map.held`` on it is this rank's
                    [1, ...] row, taken as it is — OR a
                    list/tuple of S per-stage pytrees with arbitrary
                    per-stage shapes (replicated, selected by stage).
    microbatches:   [M, mb, T, ...] tensor of M microbatches.
    batch_axis:     mesh axis (or tuple of axes) the mb dim is sharded
                    on, None if replicated.
    param_specs:    optional pytree of spec tails for the non-leading
                    dims of the stacked params (tensor-parallel
                    composition: the stage_fn then psums its partial
                    sums over tp).
    seq_axis:       mesh axis the T (dim-2) activation dim is sharded on
                    (the stage_fn runs ring attention over it).
    with_aux:       stage_fn returns (out, aux_scalar); gpipe then
                    returns (outputs, aux).
    Returns [M, mb, ...] outputs of the final stage (with_aux: a tuple).
    """
    s = mesh.shape[axis_name]
    xspec = P(None, batch_axis, seq_axis)
    out_spec = P(None, batch_axis, seq_axis)
    aux_axes = _aux_axes(batch_axis, seq_axis, with_aux)
    out_specs = (out_spec, P()) if with_aux else out_spec

    if isinstance(stacked_params, (list, tuple)):
        if with_aux:
            raise NotImplementedError(
                "with_aux is not supported on the heterogeneous "
                "per-stage-params path")
        if len(stacked_params) != s:
            raise ValueError(
                "per-stage params list has %d entries != %d pipeline "
                "stages" % (len(stacked_params), s))
        params_seq = tuple(stacked_params)
        fn = shard_map(
            functools.partial(_gpipe_hetero, stage_fn=stage_fn,
                              axis_name=axis_name),
            mesh=mesh, in_specs=(P(), xspec), out_specs=out_spec)
        return fn(params_seq, microbatches)

    for leaf in _leaves(stacked_params):
        # a held block (``_shard_map.held``) is this stage's row of it
        rows = leaf.shape[0] * (s if (getattr(leaf, "_ptpu_held", None)
                                      or (None,))[0] == axis_name else 1)
        if rows != s:
            raise ValueError(
                "stacked_params leading dim %d != %d pipeline stages"
                % (rows, s))
    pspec = _param_specs(stacked_params, param_specs, (axis_name,))
    fn = shard_map(
        functools.partial(_gpipe_sharded, stage_fn=stage_fn,
                          axis_name=axis_name, with_aux=with_aux,
                          aux_mean_axes=aux_axes),
        mesh=mesh, in_specs=(pspec, xspec), out_specs=out_specs)
    return fn(stacked_params, microbatches)


def gpipe_interleaved(stage_fn, stacked_params, microbatches, mesh,
                      n_chunks, axis_name="pp", batch_axis=None,
                      param_specs=None, seq_axis=None, with_aux=False):
    """Interleaved virtual-stage pipeline: device d holds the V =
    n_chunks chunk param slices {d, d+S, ...}.

    stacked_params: pytree with leaves [S, V, per_chunk, ...]. A leaf
                    marked ``_shard_map.held`` on ``axis_name`` is this
                    stage's block as the pp placement holds it, its
                    contiguous rows [1, L/S, ...] (V a multiple of S):
                    the schedule re-blocks it with one all_to_all.
    microbatches:   [M, mb, ...], M <= S.
    stage_fn(chunk_params, x) runs ONE chunk (per_chunk layers).
    """
    s = mesh.shape[axis_name]
    m = microbatches.shape[0]
    if m > s:
        raise ValueError(
            "interleaved schedule needs microbatches M=%d <= S=%d "
            "pipeline stages (use gpipe for the large-M regime)" % (m, s))
    rows = set()
    for i, leaf in enumerate(_leaves(stacked_params)):
        if (getattr(leaf, "_ptpu_held", None) or (None,))[0] == axis_name:
            rows.add(i)
            if leaf.shape[0] != 1 or n_chunks % s or \
                    leaf.shape[1] % n_chunks:
                raise ValueError(
                    "a held interleaved leaf must be a stage's [1, L/S, "
                    "...] rows with V=%d a multiple of S=%d; got %s"
                    % (n_chunks, s, tuple(leaf.shape)))
        elif leaf.shape[0] != s or leaf.shape[1] != n_chunks:
            raise ValueError(
                "interleaved stacked_params leaves must be "
                "[S=%d, V=%d, ...]; got %s"
                % (s, n_chunks, tuple(leaf.shape)))
    xspec = P(None, batch_axis, seq_axis)
    out_spec = P(None, batch_axis, seq_axis)
    aux_axes = _aux_axes(batch_axis, seq_axis, with_aux)
    out_specs = (out_spec, P()) if with_aux else out_spec
    pspec = _param_specs(stacked_params, param_specs, (axis_name, None))
    fn = shard_map(
        functools.partial(_interleaved_sharded, stage_fn=stage_fn,
                          axis_name=axis_name, n_chunks=n_chunks,
                          with_aux=with_aux, aux_mean_axes=aux_axes,
                          rows=frozenset(rows)),
        mesh=mesh, in_specs=(pspec, xspec), out_specs=out_specs)
    return fn(stacked_params, microbatches)
