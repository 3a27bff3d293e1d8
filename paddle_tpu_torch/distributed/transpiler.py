"""DistributeTranspiler: rewrite a Program for distributed training.

The port's copy of ``paddle_tpu/distributed/transpiler.py`` (reference
parity: python/paddle/fluid/distribute_transpiler.py:138-1128): it
rewrites a Program into the same trainer, pserver and pserver-startup
programs as the JAX package, op for op and attribute for attribute.

Two modes:
  * ``mode="mesh"``: no program surgery. The transpiler annotates
    sharding hints — dense params replicated over ``dp``,
    ``is_distributed`` embedding tables row-sharded — and every trainer
    runs the SAME program under ParallelExecutor.
  * ``mode="pserver"`` (the default, reference-compat): real program
    surgery. The trainer program gets send/recv ops (and, for
    ``is_distributed`` tables, prefetch/send_sparse); get_pserver_program
    builds a listen_and_serv program whose optimize sub-block applies the
    merged gradients — served by distributed/rpc.VariableServer over TCP.
    Used for sparse-embedding service and the reference's localhost
    multi-process test pattern (test_dist_train.py).
"""

from ..core.program import (default_main_program, default_startup_program,
                            Program)
from ..core import unique_name

__all__ = ["DistributeTranspiler"]


def _clone_op_vars(src_block, dst_block, op, shape_map=None,
                   fallback_block=None):
    """Declare every var an op references into dst_block (persistable) so
    the cloned op can resolve them — shared by pserver/startup builders.
    shape_map overrides per-var shapes (sharded-table local shapes)."""
    shape_map = shape_map or {}
    for name in op.input_names + op.output_names:
        v = src_block.vars.get(name)
        if v is None and fallback_block is not None:
            v = fallback_block.vars.get(name)
        if v is not None and not dst_block.has_var(name):
            dst_block.create_var(name=name,
                                 shape=shape_map.get(name, v.shape),
                                 dtype=v.dtype, persistable=True)


class DistributeTranspiler:
    def __init__(self, mode="pserver"):
        self.mode = mode
        self._trainer_id = 0
        self._trainers = 1
        self._eps = []
        self._program = None
        self._startup = None
        self._param_grads = []
        self._dist_tables = {}
        self._table_opt = {}
        self._table_init_ops = []

    # ------------------------------------------------------------------
    def transpile(self, trainer_id, program=None, pservers="", trainers=1,
                  sync_mode=True, startup_program=None):
        program = program or default_main_program()
        self._program = program
        self._startup = startup_program or default_startup_program()
        self._trainer_id = trainer_id
        self._trainers = trainers
        self._eps = [e for e in pservers.split(",") if e]
        self._sync = sync_mode

        # find (param, grad) pairs from optimizer ops
        self._opt_ops = []
        self._param_grads = []
        for op in list(program.global_block().ops):
            if op.type in ("sgd", "momentum", "adam", "adagrad", "rmsprop",
                           "adamax", "adadelta", "ftrl", "decayed_adagrad"):
                p = op.input("Param")[0]
                g = op.input("Grad")[0]
                self._param_grads.append((p, g))
                self._opt_ops.append(op)

        # distributed lookup tables (lookup_table_op.cc `is_distributed`,
        # distribute_transpiler.py:201-255): table row-sharded over ALL
        # pservers, trainer replaces the lookup with a prefetch of just
        # the needed rows and sends SelectedRows grads per shard
        self._dist_tables = {}
        gb = program.global_block()
        for op in list(gb.ops):
            if op.type == "lookup_table" and op.attr("is_distributed"):
                w = op.input("W")[0]
                v = gb.vars[w]
                meta = self._dist_tables.setdefault(
                    w, {"height": int(v.shape[0]),
                        "dim": int(v.shape[-1]), "lookups": []})
                meta["lookups"].append(op)

        if self.mode == "mesh":
            for p, _ in self._param_grads:
                program._sharding_hints.setdefault(p, None)
            for v in program.list_vars():
                if getattr(v, "is_distributed", False):
                    program._sharding_hints[v.name] = ("mp", None)
            return self

        # pserver mode: strip optimizer ops from the trainer program and
        # append send/barrier/recv (distribute_transpiler.py:257ff).
        # Distributed tables leave the dense path entirely: their
        # optimizer ops go to EVERY pserver (each owns a row shard), the
        # trainer's lookups become prefetches, and the grads ride the
        # wire as SelectedRows.
        self._table_opt = {}      # table -> its optimizer op
        if self._dist_tables:
            kept_pg, kept_ops = [], []
            for (p, g), op in zip(self._param_grads, self._opt_ops):
                if p in self._dist_tables:
                    self._table_opt[p] = op
                else:
                    kept_pg.append((p, g))
                    kept_ops.append(op)
            self._param_grads, self._opt_ops = kept_pg, kept_ops

        for op in self._opt_ops + list(self._table_opt.values()):
            gb.ops.remove(op)
        self._rewrite_dist_lookups(gb)
        params = [p for p, _ in self._param_grads]
        grads = [g for _, g in self._param_grads]
        n = max(1, len(self._eps))
        for w, meta in self._dist_tables.items():
            gb.append_op(
                type="send_sparse",
                inputs={"Ids": meta["id_names"],
                        "Grads": [o + "@GRAD" for o in meta["out_names"]]},
                outputs={},
                attrs={"grad_name": w + "@GRAD", "epmap": self._eps,
                       "endpoints": self._eps, "height": meta["height"],
                       "trainer_id": self._trainer_id})
        gb.append_op(type="send", inputs={"X": grads}, outputs={},
                     attrs={"epmap": [self._eps[i % n]
                                      for i in range(len(grads))],
                            "sync": self._sync,
                            "endpoints": self._eps,
                            "trainer_id": self._trainer_id})
        gb.append_op(type="recv", inputs={},
                     outputs={"Out": params},
                     attrs={"epmap": [self._eps[i % n]
                                      for i in range(len(params))],
                            "recv_names": params,
                            "endpoints": self._eps})
        self._program._bump_version()
        return self

    def _rewrite_dist_lookups(self, gb):
        """Trainer-side table rewrite: each ``lookup_table`` on a
        distributed table becomes a ``prefetch`` (ids → rows from the
        sharded servers), the prefetched rows join the backward marker's
        wrt list (they are the gradient LEAF the sparse send reads), and
        the table/its accumulators drop out of the trainer's programs
        entirely — the trainer never materializes the [V, D] table."""
        # prefetches are HOISTED to the program head (after any producer
        # of their ids): the executor then sees one host block, then one
        # compute block holding every consumer of the prefetched rows up
        # to the grad marker — the shape _grad_leaves_concrete can
        # segment-compile with the rows as gradient leaves
        n_inserted = 0
        for w, meta in self._dist_tables.items():
            meta["id_names"] = []
            meta["out_names"] = []
            for op in meta["lookups"]:
                ids = op.input("Ids")[0]
                out = op.output("Out")[0]
                gb.ops.remove(op)
                prod = max((i for i, o in enumerate(gb.ops)
                            if any(ids in ns
                                   for ns in o.outputs.values())),
                           default=-1)
                newop = gb.append_op(
                    type="prefetch", inputs={"X": [ids]},
                    outputs={"Out": [out]},
                    attrs={"table_name": w, "epmap": self._eps,
                           "endpoints": self._eps})
                gb.ops.remove(newop)
                pos = max(n_inserted, prod + 1)
                gb.ops.insert(pos, newop)
                n_inserted = pos + 1
                meta["id_names"].append(ids)
                meta["out_names"].append(out)

        # rewrite the backward marker: grads w.r.t. prefetched rows, not
        # the (absent) table param
        table_names = set(self._dist_tables)
        for op in gb.ops:
            if op.type != "backward_marker":
                continue
            pnames = [p for p in (op.attr("param_names") or [])
                      if p not in table_names]
            new_wrt = [o for meta in self._dist_tables.values()
                       for o in meta["out_names"]]
            op.attrs["param_names"] = pnames + new_wrt
            gvars = [g for g in op.outputs.get("Grads", [])
                     if g.replace("@GRAD", "") not in table_names]
            for o in new_wrt:
                v = gb.vars.get(o)
                g = gb.create_var(name=o + "@GRAD",
                                  shape=v.shape if v is not None else None,
                                  dtype=v.dtype if v is not None
                                  else "float32",
                                  persistable=False, stop_gradient=True)
                gvars.append(g.name)
            op.outputs["Grads"] = gvars

        # drop trainer-side init ops for the table and its accumulators
        table_state = set(table_names)
        for op in self._table_opt.values():
            for ns in op.inputs.values():
                for nm in ns:
                    v = self._program.global_block().vars.get(nm)
                    if v is not None and getattr(v, "persistable", False) \
                            and nm not in ("@EMPTY@",):
                        if tuple(v.shape or ())[:1] == \
                                (self._dist_tables[op.input("Param")[0]]
                                 ["height"],):
                            table_state.add(nm)
        if self._startup is not None:
            sb = self._startup.global_block()
            removed = [o for o in sb.ops
                       if any(nm in table_state
                              for ns in o.outputs.values() for nm in ns)]
            # keep the removed init ops: get_startup_program clones them
            # (at shard shape) into each server's startup
            self._table_init_ops = removed
            for op in removed:
                sb.ops.remove(op)
            self._startup._bump_version()

    # ------------------------------------------------------------------
    def get_trainer_program(self):
        return self._program

    def _table_local_shapes(self):
        """For every dist table: {var_name: local_shape} covering the
        table itself and each same-height accumulator of its optimizer op
        — every shard holds rows {g : g % n == shard}, stored compactly
        as ceil(V/n) rows (same local shape on every server)."""
        n = max(1, len(self._eps))
        out = {}
        src_gb = self._program.global_block()
        for w, meta in self._dist_tables.items():
            local_h = -(-meta["height"] // n)
            opt = self._table_opt.get(w)
            names = [w] + ([nm for ns in opt.inputs.values() for nm in ns]
                           if opt is not None else [])
            for nm in names:
                v = src_gb.vars.get(nm)
                if v is not None and tuple(v.shape or ())[:1] == \
                        (meta["height"],):
                    out[nm] = (local_h,) + tuple(v.shape[1:])
        return out

    def get_pserver_program(self, endpoint, port_file=None):
        """Build the server program: one listen_and_serv op whose
        sub-block holds the optimizer ops for the params this endpoint
        owns (round-robin placement like distributed_splitter), plus —
        when distributed tables exist — the sparse optimizer op for this
        server's row shard of EVERY table (each server owns one shard,
        distribute_transpiler.py pserver-side table blocks)."""
        prog = Program()
        gb = prog.global_block()
        my = self._owned(endpoint)
        local_shapes = self._table_local_shapes()
        src_gb = self._program.global_block()

        opt_block = prog.create_block()
        for i, (p, g) in my:
            op = self._opt_ops[i]
            _clone_op_vars(src_gb, gb, op, shape_map=local_shapes)
            opt_block.append_op(op.type, dict(op.inputs), dict(op.outputs),
                                dict(op.attrs))
        table_params, table_grads = [], []
        for w in self._dist_tables:
            op = self._table_opt.get(w)
            if op is None:
                continue
            _clone_op_vars(src_gb, gb, op, shape_map=local_shapes)
            opt_block.append_op(op.type, dict(op.inputs), dict(op.outputs),
                                dict(op.attrs))
            table_params.append(op.input("Param")[0])
            table_grads.append(op.input("Grad")[0])
        prog.rollback()
        n = max(1, len(self._eps))
        shard = self._eps.index(endpoint) if endpoint in self._eps else 0
        sparse_tables = {w: {"shard": shard, "num_shards": n,
                             "height": meta["height"]}
                         for w, meta in self._dist_tables.items()}
        gb.append_op(
            type="listen_and_serv", inputs={}, outputs={},
            attrs={"endpoint": endpoint,
                   "Fanin": self._trainers,
                   "sync_mode": self._sync,
                   "param_names": [p for _, (p, g) in my] + table_params,
                   "grad_names": [g for _, (p, g) in my] + table_grads,
                   "sparse_tables": sparse_tables,
                   "optimize_blocks": [opt_block],
                   "port_file": port_file,
                   "blocking": True})
        return prog

    def get_startup_program(self, endpoint=None, pserver_program=None):
        """Server startup: a Program that initializes exactly the params
        this endpoint owns, by cloning the matching initializer ops out of
        the trainer's startup program (distribute_transpiler.py
        get_startup_program per-endpoint init parity). Distributed-table
        state (the shard + its optimizer accumulators) is initialized at
        the LOCAL shard shape ceil(V/n) — the [V, D] table never exists
        on any single process."""
        owned = set(self._owned_param_names(endpoint))
        # plus the optimizer STATE of the owned params (accumulators,
        # beta pows, learning rate) — the server applies the update, so
        # it must initialize the update's state
        for i, _pg in self._owned(endpoint):
            op = self._opt_ops[i]
            owned.update(nm for ns in op.inputs.values() for nm in ns)
        local_shapes = self._table_local_shapes()
        # table shard + every optimizer-state var of the table opt ops
        # (moments at local shape; scalar state like beta pows as-is)
        table_state = set(local_shapes)
        for op in getattr(self, "_table_opt", {}).values():
            table_state.update(nm for ns in op.inputs.values()
                               for nm in ns if nm not in owned)
        prog = Program()
        gb = prog.global_block()
        if self._startup is None:
            return prog
        src = self._startup.global_block()
        # trainer-side table init ops were dropped by transpile(); the
        # pre-transpile startup kept clones in _table_init_ops
        src_ops = list(src.ops) + list(getattr(self, "_table_init_ops", []))
        main_gb = self._program.global_block()
        for op in src_ops:
            out_names = [n for ns in op.outputs.values() for n in ns]
            if not any(n in owned or n in table_state for n in out_names):
                continue
            _clone_op_vars(src, gb, op, shape_map=local_shapes,
                           fallback_block=main_gb)
            attrs = dict(op.attrs)
            outs = [n for ns in op.outputs.values() for n in ns]
            patched = [n for n in outs if n in local_shapes]
            if patched and "shape" in attrs:
                attrs["shape"] = list(local_shapes[patched[0]])
            gb.append_op(op.type, dict(op.inputs), dict(op.outputs), attrs)
        return prog

    def _owned(self, endpoint=None):
        """Round-robin param placement (distributed_splitter parity):
        [(index, (param, grad))] owned by `endpoint`. The single source of
        truth for placement — get_pserver_program and get_startup_program
        must agree or a server would init a shard it doesn't serve."""
        n = max(1, len(self._eps))
        if endpoint is None:
            if n > 1:
                raise ValueError(
                    "endpoint is required when transpiling for %d pservers"
                    " %r — each server owns a different param shard"
                    % (n, self._eps))
            my_idx = 0
        else:
            try:
                my_idx = self._eps.index(endpoint)
            except ValueError:
                raise ValueError(
                    "endpoint %r is not one of the transpiled pserver "
                    "endpoints %r" % (endpoint, self._eps))
        return [(i, pg) for i, pg in enumerate(self._param_grads)
                if i % n == my_idx]

    def _owned_param_names(self, endpoint=None):
        return [p for _, (p, g) in self._owned(endpoint)]
