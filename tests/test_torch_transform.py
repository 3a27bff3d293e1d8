"""paddle_tpu_torch.transform's pass framework against the JAX package's.

Twins of ``tests/test_transform.py`` (the per-pass goldens, the zoo
property gate, the armed executor path and the monitor integration;
its CLI tests wait with the CLI, ROADMAP.md queue 1 item 11(a) part
two), then against the JAX package:

  * every pass alone, and the default pipeline, rewrites every
    ``TRANSFORM_ZOO`` entry to the JAX package's Program JSON, with the
    same per-pass accounting;
  * the port's ``verify_bitwise`` holds on every zoo entry after the
    pipeline (the JAX package runs that sweep under ``-m slow``; the
    port's eager steps make it seconds), and catches a transform that
    changes what a program computes.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import transform as jtransform
from paddle_tpu.models import transform_zoo_entry as jzoo
import paddle_tpu_torch as fluid
from paddle_tpu_torch import flags, monitor
from paddle_tpu_torch.models import TRANSFORM_ZOO, transform_zoo_entry
from paddle_tpu_torch.transform import (
    CSEPass, ConstantFoldPass, DeadOpEliminationPass, PassManager,
    default_passes, resolve_passes, verify_bitwise)


def _ops(program):
    return [op.type for op in program.global_block().ops]


def _staged(build):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        fetches = build()
    return main, startup, fetches


# -- golden fixtures: one per pass -----------------------------------------

def test_cse_golden_dedups_identical_chain():
    def build():
        x = fluid.layers.data("x", [4])
        a = fluid.layers.scale(x, 2.0)
        b = fluid.layers.scale(x, 2.0)        # identical to a
        return fluid.layers.elementwise_add(a, b)

    main, startup, out = _staged(build)
    assert _ops(main) == ["scale", "scale", "elementwise_add"]
    result = PassManager([CSEPass()]).run(main, keep=[out.name])
    assert _ops(result.program) == ["scale", "elementwise_add"]
    assert result.stats["cse"] == 1
    add = result.program.global_block().ops[1]
    assert len(set(add.input("X") + add.input("Y"))) == 1

    def feeds(rng):
        return {"x": rng.rand(3, 4).astype(np.float32)}
    ok, detail = verify_bitwise(main, startup, feeds, [out.name],
                                result.program)
    assert ok, detail


def test_cse_protects_marker_attr_references():
    """Grad markers name their dataflow in ATTRS, which the rename map
    never rewrites: a producer of a marker-referenced name survives
    under its own name even when it duplicates an earlier op."""
    def build():
        x = fluid.layers.data("x", [4])
        y1 = fluid.layers.scale(x, 2.0)
        y2 = fluid.layers.scale(x, 2.0)      # identical, but...
        return y1, y2

    main, _, (y1, y2) = _staged(build)
    main.global_block().append_op(
        "calc_gradient_marker",
        attrs={"input_names": ["x"], "target_names": [y2.name]})
    result = PassManager([CSEPass()]).run(main, keep=[y1.name])
    assert _ops(result.program) == \
        ["scale", "scale", "calc_gradient_marker"]
    assert result.stats["cse"] == 0


def test_cse_never_touches_rng_or_inplace_ops():
    def build():
        x = fluid.layers.data("x", [4])
        a = fluid.layers.dropout(x, dropout_prob=0.5)
        b = fluid.layers.dropout(x, dropout_prob=0.5)  # distinct draws!
        return fluid.layers.elementwise_add(a, b)

    main, _, out = _staged(build)
    result = PassManager([CSEPass()]).run(main, keep=[out.name])
    assert _ops(result.program) == _ops(main)
    assert result.stats["cse"] == 0


def test_constant_fold_golden_folds_into_initialized_var():
    def build():
        x = fluid.layers.data("x", [2])
        one = fluid.layers.fill_constant([2], "float32", 1.5)
        two = fluid.layers.fill_constant([2], "float32", 2.0)
        s = fluid.layers.elementwise_add(one, two)   # 3.5, compile-time
        return fluid.layers.elementwise_add(x, s)

    main, startup, out = _staged(build)
    assert _ops(main) == ["fill_constant", "fill_constant",
                          "elementwise_add", "elementwise_add"]
    fold = PassManager([ConstantFoldPass()]).run(main, keep=[out.name])
    assert _ops(fold.program) == ["fill_constant", "fill_constant",
                                  "assign_value", "elementwise_add"]
    folded = fold.program.global_block().ops[2]
    np.testing.assert_array_equal(folded.attr("values"),
                                  np.full((2,), 3.5, np.float32))
    full = PassManager(default_passes()).run(main, keep=[out.name])
    assert _ops(full.program) == ["assign_value", "elementwise_add"]
    assert full.stats["constant_fold"] >= 1
    assert full.stats["dead_op"] >= 2

    def feeds(rng):
        return {"x": rng.rand(3, 2).astype(np.float32)}
    ok, detail = verify_bitwise(main, startup, feeds, [out.name],
                                full.program)
    assert ok, detail


def test_dead_op_golden_removes_chain_keeps_roots():
    def build():
        x = fluid.layers.data("x", [4])
        live = fluid.layers.scale(x, 2.0)
        d1 = fluid.layers.scale(x, 3.0)       # dead chain head
        d2 = fluid.layers.scale(d1, 4.0)      # dead chain tail
        d3 = fluid.layers.dropout(d2, dropout_prob=0.1)  # dead but RNG
        del d3
        return fluid.layers.elementwise_add(live, live)

    main, startup, out = _staged(build)
    result = PassManager([DeadOpEliminationPass()]).run(
        main, keep=[out.name])
    # the RNG op is a draw-ordinal root: it stays, and the chain it
    # consumes stays live through it
    assert _ops(result.program) == ["scale", "scale", "scale",
                                    "dropout", "elementwise_add"]

    def build2():
        x = fluid.layers.data("x", [4])
        live = fluid.layers.scale(x, 2.0)
        d1 = fluid.layers.scale(x, 3.0)
        d2 = fluid.layers.scale(d1, 4.0)
        del d2
        return fluid.layers.elementwise_add(live, live)

    main2, startup2, out2 = _staged(build2)
    r2 = PassManager([DeadOpEliminationPass()]).run(
        main2, keep=[out2.name])
    assert _ops(r2.program) == ["scale", "elementwise_add"]
    assert r2.stats["dead_op"] == 2


def test_dead_op_beyond_prune_keeps_training_semantics():
    """prune(fetches) slices the optimizer away; dead_op roots on side
    effects (persistable writes, markers) and removes exactly the dead
    chain, and the training step stays bitwise."""
    def build():
        x = fluid.layers.data("x", [4])
        y = fluid.layers.data("y", [1])
        h = fluid.layers.fc(x, 4)
        dead = fluid.layers.scale(h, 5.0)
        dead2 = fluid.layers.scale(dead, 5.0)
        del dead2
        cost = fluid.layers.mean(
            fluid.layers.square_error_cost(fluid.layers.fc(h, 1), y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
        return cost

    main, startup, cost = _staged(build)
    assert "sgd" not in _ops(main.prune([cost.name]))
    result = PassManager([DeadOpEliminationPass()]).run(
        main, keep=[cost.name])
    kept = _ops(result.program)
    assert kept.count("sgd") == _ops(main).count("sgd")
    assert "backward_marker" in kept
    assert kept.count("scale") == _ops(main).count("scale") - 2

    def feeds(rng):
        return {"x": rng.rand(4, 4).astype(np.float32),
                "y": rng.rand(4, 1).astype(np.float32)}
    ok, detail = verify_bitwise(main, startup, feeds, [cost.name],
                                result.program)
    assert ok, detail


def test_resolve_passes_grammar():
    assert [p.name for p in resolve_passes("all")] == \
        ["constant_fold", "cse", "dead_op", "fusion"]
    assert resolve_passes("none") == []
    assert [p.name for p in resolve_passes("cse,dead_op")] == \
        ["cse", "dead_op"]
    assert [p.name for p in resolve_passes("fusion,bf16_cast")] == \
        ["fusion", "bf16_cast"]
    with pytest.raises(ValueError):
        resolve_passes("cse,bogus")


# -- the zoo: property gate, JSON identity, execution identity ------------

@pytest.mark.parametrize("model", sorted(TRANSFORM_ZOO))
def test_zoo_program_survives_pipeline(model):
    main, startup, feed_fn, fetch_names = transform_zoo_entry(model)
    before = len(main.global_block().ops)
    result = PassManager(default_passes()).run(main, keep=fetch_names)
    assert result.ops_before == before
    assert result.ops_after <= result.ops_before
    assert result.ops_after == len(result.program.global_block().ops)
    meta = result.program._transform_meta
    assert meta["parent_version"] == main._version
    assert meta["version"] == result.program._version
    assert len(main.global_block().ops) == before


PASSES = ("constant_fold", "cse", "dead_op", "fusion", "all")


@pytest.mark.parametrize("which", PASSES)
@pytest.mark.parametrize("model", sorted(TRANSFORM_ZOO))
def test_zoo_pass_output_is_the_jax_program(model, which):
    """Each pass alone, and the whole pipeline to its fixed point,
    rewrites the entry to the JAX package's Program JSON byte for byte,
    with the same per-pass and per-pattern accounting."""
    with fluid.unique_name.guard():
        main, _, _, fetch = transform_zoo_entry(model)
    with jfluid.unique_name.guard():
        jmain, _, _, jfetch = jzoo(model)
    assert main.to_json() == jmain.to_json()
    mine = PassManager(resolve_passes(which)).run(main, keep=fetch)
    theirs = jtransform.PassManager(jtransform.resolve_passes(which)).run(
        jmain, keep=jfetch)
    assert mine.program.to_json() == theirs.program.to_json()
    assert mine.to_dict() == theirs.to_dict()


@pytest.mark.parametrize("which", PASSES)
@pytest.mark.parametrize("model", sorted(TRANSFORM_ZOO))
def test_zoo_bitwise_identity_full(model, which):
    """Each pass alone, and the pipeline, keeps every zoo entry's two
    training steps bitwise."""
    main, startup, feed_fn, fetch_names = transform_zoo_entry(model)
    result = PassManager(resolve_passes(which)).run(main, keep=fetch_names)
    ok, detail = verify_bitwise(main, startup, feed_fn, fetch_names,
                                result.program)
    assert ok, detail


def test_zoo_demonstrably_shrinks():
    """The MT transformer derives two attention biases from src_mask
    through identical chains: CSE removes the duplicates, and the step
    stays bitwise."""
    main, startup, feed_fn, fetch_names = \
        transform_zoo_entry("transformer_mt")
    result = PassManager(default_passes()).run(main, keep=fetch_names)
    assert result.ops_removed >= 3
    assert result.stats["cse"] >= 3
    ok, detail = verify_bitwise(main, startup, feed_fn, fetch_names,
                                result.program)
    assert ok, detail


def test_verify_bitwise_catches_a_wrong_transform():
    """The verifier is not vacuous: a fused clone whose first chain
    ends in another activation diverges, and is named."""
    main, startup, feed_fn, fetch_names = transform_zoo_entry("mlp")
    broken = PassManager(default_passes()).run(
        main, keep=fetch_names).program
    fused = next(o for o in broken.global_block().ops
                 if o.type == "fused_matmul_bias_act")
    fused.attrs["act_type"] = "sigmoid" if fused.attr("act_type") != \
        "sigmoid" else "tanh"
    ok, detail = verify_bitwise(main, startup, feed_fn, fetch_names,
                                broken)
    assert not ok and "diverged" in detail


# -- armed executor + monitor integration ---------------------------------

def _tiny_train(batch=4):
    x = fluid.layers.data("x", [4])
    y = fluid.layers.data("y", [1])
    one = fluid.layers.fill_constant([1], "float32", 1.0)
    two = fluid.layers.fill_constant([1], "float32", 1.0)  # CSE food
    h = fluid.layers.fc(x, 8, act="relu")
    dead = fluid.layers.scale(h, 2.0)
    del dead
    pred = fluid.layers.fc(h, 1)
    pred = fluid.layers.elementwise_add(
        pred, fluid.layers.elementwise_sub(one, two))      # +0, folds
    cost = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    return cost


def _tiny_feeds(rng, batch=4):
    return {"x": rng.rand(batch, 4).astype(np.float32),
            "y": rng.rand(batch, 1).astype(np.float32)}


def test_armed_executor_transforms_at_compile(tmp_path):
    """The flag ``transform``: the Executor builds each step from the
    transformed clone, losses identical to the unarmed run, the
    pipeline run once for three steps, counters and recorder rows
    land, and the compile is classified as the transform's."""
    from paddle_tpu_torch.monitor.runtime import (TRANSFORM_OPS_REMOVED,
                                                  TRANSFORM_PASSES)

    batches = [_tiny_feeds(np.random.RandomState(i)) for i in range(3)]

    def run_once():
        main, startup = fluid.Program(), fluid.Program()
        scope = fluid.Scope()
        with fluid.program_guard(main, startup):
            cost = _tiny_train()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        losses = [float(exe.run(main, feed=f, fetch_list=[cost],
                                scope=scope)[0]) for f in batches]
        return losses, main

    base_losses, _ = run_once()
    removed0 = sum(TRANSFORM_OPS_REMOVED.snapshot().values())
    passes0 = sum(TRANSFORM_PASSES.snapshot().values())
    log = tmp_path / "transform.jsonl"
    flags.set_flag("transform", True)
    try:
        with monitor.session(log_path=str(log)):
            armed_losses, main = run_once()
    finally:
        flags.set_flag("transform", None)
    assert armed_losses == base_losses
    # one pipeline run for the three steps: the clone is memoized
    assert len(main._transform_builds) == 1
    assert sum(TRANSFORM_PASSES.snapshot().values()) > passes0
    assert sum(TRANSFORM_OPS_REMOVED.snapshot().values()) > removed0
    rows = [r for r in monitor.read_jsonl(str(log))
            if r.get("ev") == "transform"]
    assert rows
    assert {"program", "version", "pass", "ops_before", "ops_after",
            "dt"} <= set(rows[0])
    assert [r for r in rows if r["pass"] == "constant_fold"
            and r["removed"]], "fold activity must show in removed"
    compiles = [r for r in monitor.read_jsonl(str(log))
                if r.get("ev") == "compile"]
    assert any(r["reason"] == "transformed_program"
               and "transform_of" in r for r in compiles)


def test_armed_transform_memoizes_per_version():
    from paddle_tpu_torch.monitor.runtime import TRANSFORM_PASSES

    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.program_guard(main, startup):
        cost = _tiny_train()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    flags.set_flag("transform", True)
    try:
        n0 = sum(TRANSFORM_PASSES.snapshot().values())
        exe.run(main, feed=_tiny_feeds(np.random.RandomState(0)),
                fetch_list=[cost], scope=scope)
        n1 = sum(TRANSFORM_PASSES.snapshot().values())
        assert n1 > n0                      # transformed once
        # a new feed signature builds a new step, from the memoized clone
        exe.run(main, feed=_tiny_feeds(np.random.RandomState(0), batch=6),
                fetch_list=[cost], scope=scope)
        assert sum(TRANSFORM_PASSES.snapshot().values()) == n1
        # program mutation -> version bump -> fresh transform
        with fluid.program_guard(main, startup):
            fluid.layers.scale(cost, 1.0)
        exe.run(main, feed=_tiny_feeds(np.random.RandomState(0)),
                fetch_list=[cost], scope=scope)
        assert sum(TRANSFORM_PASSES.snapshot().values()) > n1
    finally:
        flags.set_flag("transform", None)
    # a disarmed build of the same program drops the stale mirror
    assert getattr(main, "_transform_applied", None) is not None
    with fluid.program_guard(main, startup):
        fluid.layers.scale(cost, 1.0)
    exe.run(main, feed=_tiny_feeds(np.random.RandomState(0)),
            fetch_list=[cost], scope=scope)
    assert getattr(main, "_transform_applied", None) is None


def test_transformed_program_recompile_classified(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    log = tmp_path / "classify.jsonl"
    with fluid.program_guard(main, startup):
        cost = _tiny_train()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    result = PassManager(default_passes()).run(main, keep=[cost.name])
    with monitor.session(log_path=str(log)):
        exe.run(result.program, feed=_tiny_feeds(np.random.RandomState(0)),
                fetch_list=[cost.name], scope=scope)
    rows = [r for r in monitor.read_jsonl(str(log))
            if r.get("ev") == "compile"]
    assert rows and rows[0]["reason"] == "transformed_program"
    assert rows[0]["transform_of"] == \
        result.program._transform_meta["parent_version"]


def test_armed_run_steps_is_the_armed_run_bitwise():
    """``run_steps`` builds its step through the same hook, and keys it
    by the flag: the armed K=3 dispatch equals three armed ``run``
    calls, and both equal the unarmed steps."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        cost = _tiny_train()
    exe = fluid.Executor(fluid.CPUPlace())
    base = fluid.Scope()
    exe.run(startup, scope=base)
    init = {n: base.get_numpy(n) for n in base.local_var_names()
            if base.find_var(n) is not None}
    feeds = [_tiny_feeds(np.random.RandomState(i)) for i in range(3)]
    scopes = [fluid.Scope() for _ in range(3)]
    for s in scopes:
        fluid.load_numpy_state(s, init, "cpu")
    plain = [float(exe.run(main, feed=f, fetch_list=[cost],
                           scope=scopes[0])[0]) for f in feeds]
    flags.set_flag("transform", True)
    try:
        armed = [float(exe.run(main, feed=f, fetch_list=[cost],
                               scope=scopes[1])[0]) for f in feeds]
        steps = exe.run_steps(main, feeds=feeds, fetch_list=[cost],
                              scope=scopes[2])
    finally:
        flags.set_flag("transform", None)
    assert armed == plain == [float(s[0]) for s in steps]
    for n in init:
        assert np.array_equal(scopes[0].get_numpy(n),
                              scopes[2].get_numpy(n)), n
