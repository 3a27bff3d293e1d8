"""The port's host data plane against the JAX package: ``dataset``,
``reader``'s decorators, ``DataFeeder``, the reader layers and the
top-level names reference scripts use.

* Every dataset reader yields the JAX twin's samples for the same
  arguments, byte for byte (values and dtypes), and the image
  transforms give the same arrays.
* ``DataFeeder.feed`` and ``feed_parallel`` give the JAX package's
  arrays (dtype and shape) and LoD for dense, LoD and mixed feeds.
* The decorators give the JAX package's outputs for the same seeds.
* ``layers.create_parameter`` and ``autoincreased_step_counter`` build
  the JAX package's Program; the reader layers are host readers.
* The top-level names exist, ``import paddle_tpu_torch.fluid`` works and
  importing the port leaves jax unloaded; the ``data_home`` flag has the
  JAX package's default and environment name.
"""

import os
import random
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.dataset as jds
import paddle_tpu.reader as jreader
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.dataset as tds
import paddle_tpu_torch.reader as treader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (module, reader factory, kwargs): every reader of the 13 reader modules
READERS = [
    ("cifar", "train10", dict(n=20)), ("cifar", "test10", dict(n=20)),
    ("cifar", "train100", dict(n=20)), ("cifar", "test100", dict(n=20)),
    ("conll05", "train", dict(n=12)), ("conll05", "test", dict(n=12)),
    ("flowers", "train", dict(n=2)), ("flowers", "test", dict(n=2)),
    ("flowers", "valid", dict(n=2)),
    ("imdb", "train", dict(n=30)), ("imdb", "test", dict(n=30)),
    ("imikolov", "train", dict(samples=40)),
    ("imikolov", "test", dict(n=3, samples=40)),
    ("imikolov", "train", dict(data_type=2, samples=40)),
    ("mnist", "train", dict(n=30)), ("mnist", "test", dict(n=30)),
    ("movielens", "train", dict(n=40)), ("movielens", "test", dict(n=40)),
    ("mq2007", "train", dict(format="pointwise", n=4)),
    ("mq2007", "train", dict(format="pairwise", n=3)),
    ("mq2007", "test", dict(format="listwise", n=4)),
    ("sentiment", "train", dict(n=30)), ("sentiment", "test", dict(n=30)),
    ("uci_housing", "train", dict(n=40)),
    ("uci_housing", "test", dict(n=40)),
    ("voc2012", "train", dict(n=4)), ("voc2012", "test", dict(n=4)),
    ("voc2012", "val", dict(n=4)),
    ("wmt14", "train", dict(n=30)), ("wmt14", "test", dict(dict_size=50,
                                                           n=30)),
    ("wmt16", "train", dict(n=30)), ("wmt16", "test", dict(n=30)),
    ("wmt16", "validation", dict(src_dict_size=300, n=30)),
]


def _same(a, b):
    """Byte-for-byte equality of two samples: containers of the same
    kind and length, arrays of the same dtype, shape and bytes, Python
    scalars of the same type and value."""
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and \
            a.shape == b.shape and a.tobytes() == b.tobytes()
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("module, fn, kwargs", READERS,
                         ids=["%s.%s-%d" % (m, f, i)
                              for i, (m, f, _) in enumerate(READERS)])
def test_dataset_reader_matches_jax(module, fn, kwargs):
    got = list(getattr(getattr(tds, module), fn)(**kwargs)())
    want = list(getattr(getattr(jds, module), fn)(**kwargs)())
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert _same(g, w), (module, fn, i)


def test_dataset_tables_match_jax():
    assert tds.conll05.get_dict() == jds.conll05.get_dict()
    assert _same(tds.conll05.get_embedding(), jds.conll05.get_embedding())
    assert tds.imdb.word_dict() == jds.imdb.word_dict()
    assert tds.imikolov.build_dict() == jds.imikolov.build_dict()
    assert tds.sentiment.get_word_dict() == jds.sentiment.get_word_dict()
    assert tds.wmt14.get_dict(40) == jds.wmt14.get_dict(40)
    assert tds.wmt16.get_dict("de", 30, True) == \
        jds.wmt16.get_dict("de", 30, True)
    for m in ("movielens",):
        for f in ("max_user_id", "max_movie_id", "max_job_id",
                  "age_table"):
            assert getattr(getattr(tds, m), f)() == \
                getattr(getattr(jds, m), f)()
    assert tds.uci_housing.feature_names == jds.uci_housing.feature_names
    assert sorted(m for m in dir(tds) if not m.startswith("_")) == \
        sorted(m for m in dir(jds) if not m.startswith("_"))


def test_image_transforms_match_jax():
    img = np.random.RandomState(0).randint(0, 255, (40, 56, 3)).astype(
        np.uint8)
    for name, args in (("resize_short", (img, 24)), ("to_chw", (img,)),
                       ("center_crop", (img, 20)),
                       ("left_right_flip", (img,))):
        assert _same(getattr(tds.image, name)(*args),
                     getattr(jds.image, name)(*args)), name
    for train in (True, False):
        got = tds.image.simple_transform(
            img, 32, 24, train, mean=[1.0, 2.0, 3.0],
            rng=np.random.RandomState(5))
        want = jds.image.simple_transform(
            img, 32, 24, train, mean=[1.0, 2.0, 3.0],
            rng=np.random.RandomState(5))
        assert _same(got, want)


def test_download_refuses_without_the_file(tmp_path):
    from paddle_tpu_torch import flags
    flags.set_flag("data_home", str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="downloads are disabled"):
            tds.common.download("http://example.invalid/x.tgz", "m", "0")
        os.makedirs(tmp_path / "m")
        (tmp_path / "m" / "x.tgz").write_bytes(b"abc")
        assert tds.common.download("http://example.invalid/x.tgz", "m",
                                   "0") == str(tmp_path / "m" / "x.tgz")
        assert tds.common.md5file(str(tmp_path / "m" / "x.tgz")) == \
            jds.common.md5file(str(tmp_path / "m" / "x.tgz"))
    finally:
        flags.set_flag("data_home", None)


def test_data_home_flag_matches_jax():
    from paddle_tpu import flags as jflags
    from paddle_tpu_torch import flags as tflags
    t, j = tflags._FLAGS["data_home"], jflags._FLAGS["data_home"]
    assert (t.default, t.env, t.help) == (j.default, j.env, j.help)
    assert tflags.get_flag("data_home") == jflags.get_flag("data_home")


# --------------------------------------------------------------------------
# DataFeeder

def _feed_vars(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        dense = pkg.layers.data("img", [2, 3])
        label = pkg.layers.data("label", [1], dtype="int64")
        words = pkg.layers.data("words", [1], dtype="int64", lod_level=1)
        feats = pkg.layers.data("feats", [4], dtype="float32",
                                lod_level=1)
        scalar = pkg.layers.data("score", [1])
    return main, [dense, label, words, feats, scalar]


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ln = int(rng.randint(1, 5))
        out.append((rng.rand(6).astype(np.float32), int(rng.randint(0, 9)),
                    rng.randint(0, 50, ln).tolist(),
                    rng.rand(ln, 4).astype(np.float32),
                    float(rng.rand())))
    return out


def _same_feed(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        if hasattr(w, "recursive_sequence_lengths"):
            assert isinstance(g, tfluid.LoDTensor), k
            assert g.lod == w.lod, k
            assert _same(g.data, np.asarray(w.data)), k
        else:
            assert _same(g, w), k


@pytest.mark.parametrize("cols", [[0, 1], [2], [3], [0, 2, 3, 4],
                                  [0, 1, 2, 3, 4]],
                         ids=["dense", "ids", "lod-rows", "mixed", "all"])
def test_data_feeder_feed_matches_jax(cols):
    rows = [tuple(r[c] for c in cols) for r in _rows(7, 0)]
    jmain, jvars = _feed_vars(jfluid)
    tmain, tvars = _feed_vars(tfluid)
    jf = jfluid.DataFeeder([jvars[c] for c in cols], jfluid.CPUPlace(),
                           program=jmain)
    tf = tfluid.DataFeeder([tvars[c].name for c in cols],
                           tfluid.CPUPlace(), program=tmain)
    _same_feed(tf.feed(rows), jf.feed(rows))


@pytest.mark.parametrize("places", [1, 2, 3])
def test_data_feeder_feed_parallel_matches_jax(places):
    rows = _rows(5, 1)
    jmain, jvars = _feed_vars(jfluid)
    tmain, tvars = _feed_vars(tfluid)
    jparts = jfluid.DataFeeder(jvars, program=jmain).feed_parallel(
        rows, places)
    tparts = tfluid.DataFeeder(tvars, program=tmain).feed_parallel(
        rows, places)
    assert len(tparts) == len(jparts) == places
    for g, w in zip(tparts, jparts):
        _same_feed(g, w)


def test_data_feeder_feeds_the_executor():
    """A DataFeeder's mixed batch runs through the port's Executor as the
    JAX package's feed does through its own (same fetched values)."""
    def net(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), pkg.unique_name.guard():
            w = pkg.layers.data("words", [1], dtype="int64", lod_level=1)
            d = pkg.layers.data("img", [2, 3])
            emb = pkg.layers.embedding(w, size=[50, 4])
            pooled = pkg.layers.sequence_pool(emb, "sum")
            out = pkg.layers.elementwise_add(
                pooled, pkg.layers.fc(pkg.layers.reshape(d, [-1, 6]), 4))
        return main, startup, [w, d], out
    rows = [(r[2], r[0]) for r in _rows(6, 2)]
    jmain, jstart, jv, jout = net(jfluid)
    tmain, _, tv, tout = net(tfluid)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        want, = jexe.run(jmain, feed=jfluid.DataFeeder(
            jv, program=jmain).feed(rows), fetch_list=[jout])
    state = {v.name: np.asarray(jscope.find_var(v.name))
             for v in jmain.list_vars() if v.persistable
             and jscope.find_var(v.name) is not None}
    tscope = tfluid.Scope()
    tfluid.load_numpy_state(tscope, state, "cpu")
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=tfluid.DataFeeder(tv, program=tmain).feed(rows),
        fetch_list=[tout], scope=tscope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# the decorators

def _src(n=23, seed=0):
    rng = np.random.RandomState(seed)
    data = [(int(i), rng.rand(2).astype(np.float32)) for i in range(n)]
    return lambda: iter(data)


def _both(build, seed=11):
    """build(reader_module) -> reader; the outputs of both packages' with
    Python's global RNG at the same seed."""
    random.seed(seed)
    got = list(build(treader)())
    random.seed(seed)
    want = list(build(jreader)())
    return got, want


DECORATED = {
    "shuffle": lambda r: r.shuffle(_src(), 7),
    "shuffle_whole": lambda r: r.shuffle(_src(), 100),
    "batch": lambda r: r.batch(_src(), 5),
    "batch_drop_last": lambda r: r.batch(_src(), 5, drop_last=True),
    "shuffle_batch": lambda r: r.batch(r.shuffle(_src(), 10), 4),
    "map_readers": lambda r: r.map_readers(
        lambda a, b: (a[0] + b[0], a[1] * b[1]), _src(), _src(seed=1)),
    "chain": lambda r: r.chain(_src(5), _src(3, seed=2)),
    "compose": lambda r: r.compose(_src(6), _src(6, seed=3)),
    "compose_unchecked": lambda r: r.compose(_src(6), _src(4),
                                             check_alignment=False),
    "buffered": lambda r: r.buffered(_src(), 3),
    "firstn": lambda r: r.firstn(_src(), 9),
    "cache": lambda r: r.cache(r.shuffle(_src(), 5)),
    "xmap_ordered": lambda r: r.xmap_readers(
        lambda s: (s[0] * 2, s[1] + 1), _src(), 3, 4, order=True),
}


@pytest.mark.parametrize("name", sorted(DECORATED))
def test_decorator_matches_jax(name):
    got, want = _both(DECORATED[name])
    assert len(got) == len(want) > 0
    assert all(_same(g, w) for g, w in zip(got, want)), name


def test_xmap_unordered_and_compose_misaligned():
    got, want = _both(lambda r: r.xmap_readers(
        lambda s: s[0] + 100, _src(), 4, 2))
    assert sorted(got) == sorted(want) == list(range(100, 123))
    with pytest.raises(treader.ComposeNotAligned):
        list(treader.compose(_src(6), _src(4))())
    assert issubclass(treader.ComposeNotAligned, ValueError)


def test_buffered_propagates_errors():
    def bad():
        yield 1
        raise KeyError("boom")
    with pytest.raises(KeyError, match="boom"):
        list(treader.buffered(bad, 2)())


def test_cache_reads_the_source_once():
    calls = []

    def src():
        calls.append(1)
        return iter([1, 2, 3])
    c = treader.cache(src)
    assert list(c()) == list(c()) == [1, 2, 3]
    assert len(calls) == 1


def test_reader_layers_are_host_readers():
    random.seed(3)
    got = list(tfluid.layers.batch(tfluid.layers.shuffle(_src(), 6), 4)())
    random.seed(3)
    want = list(jfluid.layers.batch(jfluid.layers.shuffle(_src(), 6), 4)())
    assert all(_same(g, w) for g, w in zip(got, want))
    got = list(tfluid.layers.double_buffer(_src(4))())
    assert len(got) == 4 and all(_same(g, w)
                                 for g, w in zip(got, _src(4)()))
    assert tfluid.batch is treader.batch
    assert tfluid.reader.DeviceLoader is treader.DeviceLoader


# --------------------------------------------------------------------------
# front-end names

def _param_net(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        w = pkg.layers.create_parameter([3, 4], "float32", name="w")
        b = pkg.layers.create_parameter(
            [4], "float32", attr=pkg.ParamAttr(name="b"), is_bias=True)
        step = pkg.layers.autoincreased_step_counter(begin=1)
        x = pkg.layers.data("x", [3])
        out = pkg.layers.elementwise_add(pkg.layers.matmul(x, w), b)
    return main, startup, out, step


def test_create_parameter_and_step_counter_match_jax():
    jmain, jstart, _, _ = _param_net(jfluid)
    tmain, tstart, out, step = _param_net(tfluid)
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tstart, scope=scope)
    x = np.ones((2, 3), np.float32)
    steps = [float(exe.run(tmain, feed={"x": x}, fetch_list=[step],
                           scope=scope)[0][0]) for _ in range(3)]
    assert steps == [1.0, 2.0, 3.0]
    np.testing.assert_array_equal(scope.get_numpy("b"), np.zeros(4))
    assert scope.get_numpy("w").shape == (3, 4)


NAMES = ["DataFeeder", "dataset", "reader", "batch", "recordio",
         "switch_main_program", "switch_startup_program", "Block",
         "Operator", "Parameter", "Variable", "WeightNormParamAttr",
         "pack_sequences", "SelectedRows", "CUDAPinnedPlace",
         "is_compiled_with_cuda", "is_compiled_with_tpu", "fluid"]
LAYER_NAMES = ["create_parameter", "autoincreased_step_counter", "batch",
               "shuffle", "double_buffer", "open_recordio_file",
               "open_files"]


@pytest.mark.parametrize("name", NAMES + ["layers." + n
                                          for n in LAYER_NAMES])
def test_front_end_names_exist(name):
    jobj, tobj = jfluid, tfluid
    for part in name.split("."):
        jobj, tobj = getattr(jobj, part), getattr(tobj, part)
    assert callable(tobj) == callable(jobj)


def test_places_and_switches():
    import torch
    assert tfluid.fluid is tfluid
    assert isinstance(tfluid.CUDAPinnedPlace(), tfluid.CPUPlace)
    assert tfluid.CUDAPinnedPlace().torch_device().type == "cpu"
    assert tfluid.is_compiled_with_cuda() == torch.backends.cuda.is_built()
    assert tfluid.is_compiled_with_tpu() is False
    p = tfluid.Program()
    old = tfluid.switch_main_program(p)
    try:
        assert tfluid.default_main_program() is p
    finally:
        tfluid.switch_main_program(old)
    padded, lens = tfluid.pack_sequences([np.ones(2), np.ones(3)])
    assert padded.shape == (2, 3) and list(lens) == [2, 3]


def test_fluid_alias_imports_without_jax():
    code = ("import sys; import paddle_tpu_torch.fluid as fluid; "
            "import paddle_tpu_torch as p; assert fluid is p; "
            "fluid.DataFeeder; fluid.recordio.Writer; "
            "fluid.reader.DeviceLoader; fluid.dataset.cifar.train10; "
            "assert 'jax' not in sys.modules, 'jax loaded'; print('OK')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr
