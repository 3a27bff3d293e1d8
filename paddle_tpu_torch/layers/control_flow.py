"""Control-flow layers: ``recompute`` regions.

The counterpart of ``paddle_tpu/layers/control_flow.py`` for
``BlockGuard`` and ``recompute``, emitting the same IR: the region's ops
in a sub-block, and one ``recompute_block`` op in the parent block whose
inputs are the region's external reads and whose outputs are every name
the region writes (``ops/control_flow.py`` lowers it). The other control
flow (While, IfElse, RNNs, tensor arrays) waits for its lowerings
(ROADMAP.md, queue 1 item 7).
"""

from ..core.program import default_main_program

__all__ = ["BlockGuard", "recompute"]


class BlockGuard:
    def __init__(self, program):
        self.program = program

    def __enter__(self):
        self.program.create_block()
        return self

    def __exit__(self, *exc):
        self.program.rollback()
        return False


class recompute(BlockGuard):
    """Rematerialization region (``with layers.recompute(): ...``): ops
    built inside the block re-run during the backward pass instead of
    storing their activations. Wrap each transformer layer to train
    longer sequences or bigger batches in the same device memory at
    about 1/3 extra forward work. Fetch intermediates OUTSIDE a region:
    only what later ops, the persistables and the fetch list read leaves
    it."""

    def __init__(self):
        super().__init__(default_main_program())

    def __exit__(self, *exc):
        program = self.program
        sub_block = program.current_block()
        super().__exit__(*exc)
        if exc[0] is None:
            # record the region's external reads and writes as REAL op
            # inputs/outputs so every name-based dependency scan (later
            # recompute regions, prune) sees them
            reads, created = [], set()
            for o in sub_block.ops:
                for ns in o.inputs.values():
                    reads.extend(n for n in ns if n not in created)
                for ns in o.outputs.values():
                    created.update(ns)
            program.current_block().append_op(
                type="recompute_block",
                inputs={"X": list(dict.fromkeys(reads))},
                outputs={"Out": sorted(created)},
                attrs={"sub_block": sub_block})
        return False
