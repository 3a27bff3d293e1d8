"""The port's feed-plan cache (``core/executor.FeedPlanCache``) and
``reader.DeviceLoader`` on the CPU: twins of ``tests/test_megastep.py``'s
loader tests and ``tests/test_serving.py``'s feed-plan tests.

* ``megabatches(k)`` stacks feed ``run_steps(feeds=stack, k=k)`` bitwise
  as the per-step ``run()`` calls; a trailing group keeps its length; LoD
  feeds are refused with the JAX package's message, and pass through the
  per-batch iterator intact.
* A second same-signature ``run()`` skips the derivation; a frozen feed
  commits one buffer and reuses it, a writeable one is never committed
  (an in-place mutation is honored); plan-cached LoD normalization gives
  the uncached and the JAX package's arrays and static table; the loader
  rides the cache.
* The loader's per-batch dicts and ``megabatches(k)`` stacks equal
  ``paddle_tpu.reader.DeviceLoader``'s on the same feeds, byte for byte.
* ``DeviceLoader`` without ``device=`` raises on a machine without a
  card; ``sharding=`` over a one-rank mesh stages whole batches
  (``tests/test_torch_parallel_ranks.py`` shards over two ranks).

The card's side (pinned staging, the side stream, events) runs in
``chip_smoke.py`` phase 17.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import executor as E
from paddle_tpu_torch.core.executor import FeedPlanCache, _normalize_feeds
from paddle_tpu_torch.reader import DeviceLoader, repeat_feed


def _build_mlp(prefix, seed=7):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    scope = fluid.Scope()
    with fluid.program_guard(main, startup), fluid.unique_name.guard(prefix):
        x = fluid.layers.data("x", [8])
        y = fluid.layers.data("y", [1])
        h = fluid.layers.fc(x, 16, act="tanh")
        pred = fluid.layers.fc(h, 1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    return main, scope, exe, loss


def _mlp_feeds(n=3, batch=8):
    rng = np.random.RandomState(0)
    return [{"x": rng.rand(batch, 8).astype(np.float32),
             "y": rng.rand(batch, 1).astype(np.float32)}
            for _ in range(n)]


def _lod(arr, lengths):
    t = fluid.LoDTensor(np.asarray(arr))
    t.set_recursive_sequence_lengths([list(lengths)])
    return t


# -- megabatches ------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3])
def test_device_loader_megabatches_feed_run_steps(k):
    feeds = _mlp_feeds(3)
    stacks = list(DeviceLoader(iter(feeds), device="cpu").megabatches(k))
    sizes = [int(st["x"].shape[0]) for st in stacks]
    assert sizes == [k] * (3 // k) + ([3 % k] if 3 % k else [])
    assert all(isinstance(st["x"], torch.Tensor) for st in stacks)
    m1, s1, e1, l1 = _build_mlp("ms_")
    seq = [e1.run(m1, feed=f, fetch_list=[l1], scope=s1)[0] for f in feeds]
    m2, s2, e2, l2 = _build_mlp("ms_")
    got = []
    for st in stacks:
        got += [o[0] for o in e2.run_steps(
            m2, feeds=st, k=int(st["x"].shape[0]), fetch_list=[l2],
            scope=s2)]
    np.testing.assert_array_equal(np.array(got), np.array(seq))
    for v in m1.global_block().vars.values():
        if v.persistable and s1.find_var(v.name) is not None:
            np.testing.assert_array_equal(s2.get_numpy(v.name),
                                          s1.get_numpy(v.name))


def test_device_loader_megabatches_narrow_like_the_executor():
    """int64 feeds arrive int32, as the Executor holds them; the stack
    is the loader's own copy."""
    ids = np.arange(12, dtype=np.int64).reshape(3, 4)
    [st] = list(DeviceLoader(iter([{"i": ids}] * 2),
                             device="cpu").megabatches(2))
    assert st["i"].dtype == torch.int32 and st["i"].shape == (2, 3, 4)
    ids[:] = 0
    assert int(st["i"].sum()) == 2 * 66


def test_device_loader_megabatches_reject_lod():
    feeds = [{"x": _lod(np.zeros((8, 4), np.float32), [3, 5])}]
    with pytest.raises(ValueError, match="per-step feed dicts"):
        list(DeviceLoader(iter(feeds), device="cpu").megabatches(2))
    with pytest.raises(ValueError, match="k >= 1"):
        DeviceLoader(iter(feeds), device="cpu").megabatches(0)


def test_device_loader_megabatches_reject_mixed_names():
    feeds = [{"x": np.zeros((2, 2), np.float32)},
             {"z": np.zeros((2, 2), np.float32)}]
    with pytest.raises(ValueError, match="mixes feed names"):
        list(DeviceLoader(iter(feeds), device="cpu").megabatches(2))


def test_device_loader_passes_lod_feeds_through_intact():
    t = _lod(np.random.RandomState(0).rand(8, 4).astype(np.float32),
             [3, 5])
    [batch] = list(DeviceLoader(iter([{"x": t, "d": np.ones(
        (2, 3), np.float32)}]), device="cpu"))
    assert batch["x"] is t
    assert batch["x"].recursive_sequence_lengths() == [[3, 5]]
    assert isinstance(batch["d"], torch.Tensor)
    assert batch["d"].device.type == "cpu"


def test_device_loader_propagates_source_errors():
    def source():
        yield {"x": np.zeros((2, 2), np.float32)}
        raise RuntimeError("source broke")
    it = iter(DeviceLoader(source(), device="cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="source broke"):
        next(it)


def test_device_loader_needs_a_card_by_default():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceLoader(iter([]))
    # sharding= over a mesh whose dp axis holds one rank (the rank tests
    # shard over two): the batches stay whole plain tensors
    from paddle_tpu_torch import parallel
    feed = {"x": np.arange(8, dtype=np.float32).reshape(4, 2)}
    got, = DeviceLoader([feed], device="cpu",
                        sharding=parallel.make_mesh({"dp": 1}, "cpu"))
    assert type(got["x"]) is torch.Tensor
    np.testing.assert_array_equal(got["x"].numpy(), feed["x"])


# -- the JAX package's loader on the same feeds ----------------------------

def _twin_feeds(lod_cls, lod):
    """Five seeded batches: float32 images, int64 ids, float64 weights,
    and with ``lod`` a LoD feed built with ``lod_cls``."""
    rng = np.random.RandomState(11)
    feeds = []
    for _ in range(5):
        f = {"img": rng.rand(4, 3, 2).astype(np.float32),
             "ids": rng.randint(0, 1 << 20, (4, 1)).astype(np.int64),
             "w": rng.rand(4).astype(np.float64)}
        if lod:
            lengths = [int(n) for n in rng.randint(1, 4, 3)]
            t = lod_cls(rng.rand(sum(lengths), 2).astype(np.float32))
            t.set_recursive_sequence_lengths([lengths])
            f["seq"] = t
        feeds.append(f)
    return feeds


@pytest.mark.parametrize("k,lod", [(None, False), (None, True), (2, False),
                                   (5, False)],
                         ids=["per_batch", "per_batch_lod", "megabatches_2",
                              "megabatches_5"])
def test_device_loader_matches_the_jax_loader(k, lod):
    """The port's loader yields what ``paddle_tpu.reader.DeviceLoader``
    yields for the same feeds: the same keys, the same leading k (a
    trailing group at its true length), the dense values byte-equal
    after narrowing, and the LoD values passed through unchanged."""
    from paddle_tpu.core.lod import LoDTensor as JLoDTensor
    from paddle_tpu.reader import DeviceLoader as JDeviceLoader
    mine, theirs = (_twin_feeds(fluid.LoDTensor, lod),
                    _twin_feeds(JLoDTensor, lod))
    a, b = (DeviceLoader(iter(mine), device="cpu"),
            JDeviceLoader(iter(theirs)))
    got, want = ((list(a), list(b)) if k is None else
                 (list(a.megabatches(k)), list(b.megabatches(k))))
    assert len(got) == len(want) == (5 if k is None else -(-5 // k))
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for n in w:
            if n == "seq":
                assert g[n] is mine[i][n]
                assert g[n].recursive_sequence_lengths() == \
                    w[n].recursive_sequence_lengths()
                np.testing.assert_array_equal(np.asarray(g[n].data),
                                              np.asarray(w[n].data))
                continue
            gn, wn = g[n].numpy(), np.asarray(w[n])
            assert gn.dtype == wn.dtype and gn.shape == wn.shape, n
            assert gn.tobytes() == wn.tobytes(), n
            if k is not None:
                assert gn.shape[0] == min(k, 5 - i * k)


# -- the feed-plan cache ----------------------------------------------------

def _tiny_program():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.fc(input=x, size=3)
        loss = fluid.layers.mean(y)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    return exe, main, scope, loss


def test_feed_plan_second_call_skips_normalization():
    exe, main, scope, loss = _tiny_program()
    rng = np.random.RandomState(0)
    a = rng.rand(2, 4).astype(np.float32)
    plans = exe._feed_plans
    m0, h0 = plans.misses, plans.hits
    r1 = exe.run(main, feed={"x": a}, fetch_list=[loss], scope=scope)
    assert (plans.misses, plans.hits) == (m0 + 1, h0)
    r2 = exe.run(main, feed={"x": a}, fetch_list=[loss], scope=scope)
    assert (plans.misses, plans.hits) == (m0 + 1, h0 + 1)
    np.testing.assert_array_equal(r1[0], r2[0])
    # a different signature derives a fresh plan (no false sharing)
    exe.run(main, feed={"x": rng.rand(5, 4).astype(np.float32)},
            fetch_list=[loss], scope=scope)
    assert plans.misses == m0 + 2


def test_feed_plan_committed_buffer_reuse_and_mutation_safety():
    exe, main, scope, loss = _tiny_program()
    rng = np.random.RandomState(1)
    frozen = rng.rand(2, 4).astype(np.float32)
    frozen.flags.writeable = False
    exe.run(main, feed={"x": frozen}, fetch_list=[loss], scope=scope)
    base = exe._feed_plans.buffer_reuses
    r1 = exe.run(main, feed={"x": frozen}, fetch_list=[loss], scope=scope)
    r2 = exe.run(main, feed={"x": frozen}, fetch_list=[loss], scope=scope)
    assert exe._feed_plans.buffer_reuses == base + 2
    np.testing.assert_array_equal(r1[0], r2[0])

    mut = rng.rand(2, 4).astype(np.float32)
    v1 = exe.run(main, feed={"x": mut}, fetch_list=[loss], scope=scope)[0]
    mut[:] = mut + 1.0              # in-place mutation, same object
    v2 = exe.run(main, feed={"x": mut}, fetch_list=[loss], scope=scope)[0]
    assert not np.allclose(v1, v2), \
        "mutated writeable feed served from a stale committed buffer"
    assert exe._feed_plans.buffer_reuses == base + 2


def test_feed_plan_capacity_evicts_least_recent():
    cache = FeedPlanCache(capacity=2)
    feeds = [{"x": np.zeros((n, 2), np.float32)} for n in (1, 2, 3)]
    for f in feeds + feeds[2:]:
        _normalize_feeds(f, plan_cache=cache)
    assert (cache.misses, cache.hits) == (3, 1)
    _normalize_feeds(feeds[0], plan_cache=cache)       # evicted: derives
    assert cache.misses == 4


def test_feed_plan_lod_parity():
    """Plan-cached LoD normalization (bucketing, @LOD, @MAXLEN) equals
    the uncached derivation and the JAX package's, hit or miss."""
    from paddle_tpu.core import executor as JE
    from paddle_tpu.core.lod import LoDTensor as JLoDTensor
    rng = np.random.RandomState(2)
    data = rng.rand(10, 3).astype(np.float32)
    t = _lod(data, [4, 6])
    jt = JLoDTensor(data)
    jt.set_recursive_sequence_lengths([[4, 6]])
    cache = FeedPlanCache()
    ref_a, ref_s = _normalize_feeds({"w": t})
    jax_a, jax_s = JE._normalize_feeds({"w": jt})
    for _ in range(2):                    # miss then hit
        hit_a, hit_s = _normalize_feeds({"w": t}, plan_cache=cache)
        assert hit_s == ref_s == jax_s
        assert sorted(hit_a) == sorted(ref_a) == sorted(jax_a)
        for k in ref_a:
            np.testing.assert_array_equal(hit_a[k], ref_a[k])
            np.testing.assert_array_equal(hit_a[k], np.asarray(jax_a[k]))
            assert hit_a[k].dtype == np.asarray(jax_a[k]).dtype
    assert cache.hits == 1 and cache.misses == 1
    # different lengths, same shapes: a different plan (lengths keyed)
    _, s2 = _normalize_feeds({"w": _lod(data, [6, 4])}, plan_cache=cache)
    assert cache.misses == 2
    assert s2["w@MAXLEN"] == 8            # bucketed max(6, 4)


def test_run_steps_list_rides_the_plan_cache():
    feeds = _mlp_feeds(3)
    m1, s1, e1, l1 = _build_mlp("ps_")
    seq = [e1.run(m1, feed=f, fetch_list=[l1], scope=s1)[0] for f in feeds]
    m2, s2, e2, l2 = _build_mlp("ps_")
    for f in feeds:
        for v in f.values():
            v.flags.writeable = False
    m0, h0 = e2._feed_plans.misses, e2._feed_plans.hits
    got = e2.run_steps(m2, feeds=feeds, fetch_list=[l2], scope=s2)
    assert e2._feed_plans.misses == m0 + 1
    assert e2._feed_plans.hits == h0 + 2
    np.testing.assert_array_equal(np.array([o[0] for o in got]),
                                  np.array(seq))


def test_device_loader_rides_plan_cache():
    frozen = np.random.RandomState(3).rand(2, 4).astype(np.float32)
    frozen.flags.writeable = False
    dl = DeviceLoader(repeat_feed({"x": frozen}, 4), device="cpu")
    batches = list(dl)
    assert len(batches) == 4
    assert all(isinstance(b["x"], torch.Tensor) for b in batches)
    assert dl._plans.misses == 1, \
        "loader re-derived the plan for repeated same-shape batches"
    assert dl._plans.hits == 3 and dl._plans.buffer_reuses == 3
    for b in batches:
        np.testing.assert_array_equal(b["x"].numpy(), frozen)


def test_device_loader_shares_the_executor_cache():
    exe, main, scope, loss = _tiny_program()
    feeds = [{"x": np.full((2, 4), i, np.float32)} for i in range(3)]
    m0 = exe._feed_plans.misses
    dl = DeviceLoader(iter(feeds), device="cpu", plan_cache=exe._feed_plans)
    got = [exe.run(main, feed=b, fetch_list=[loss], scope=scope)[0]
           for b in dl]
    want = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
            for f in feeds]
    np.testing.assert_array_equal(np.array(got), np.array(want))
    # one plan for the loader's numpy batches, one for the tensors it
    # yields; the executor's own numpy feeds hit the loader's plan
    assert exe._feed_plans.misses == m0 + 2
    off = DeviceLoader(iter(feeds), device="cpu", plan_cache=False)
    assert off._plans is None and len(list(off)) == 3


def test_device_loader_mixed_batch_normalizes_dense_subset():
    t = _lod(np.zeros((5, 2), np.float32), [2, 3])
    feeds = [{"x": t, "d": np.ones((2, 3), np.float32)}] * 3
    dl = DeviceLoader(iter(feeds), device="cpu")
    out = list(dl)
    assert (dl._plans.misses, dl._plans.hits) == (1, 2)
    assert all(b["x"] is t for b in out)


def test_executor_module_exports_the_cache():
    assert E.FeedPlanCache is FeedPlanCache
    assert "FeedPlanCache" in E.__all__
