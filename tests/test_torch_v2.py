"""``paddle_tpu_torch.v2`` against ``paddle_tpu.v2``.

Twins of ``tests/test_v2_api.py``'s four tests, run on the port, and of
the two v2 book scripts (``tests/book/test_v2_recognize_digits.py``,
``tests/book/test_v2_understand_sentiment.py``): each script's nets,
written against a v2 module argument, are built by both packages and
held by ``tests/torch_book_harness.py`` (identical Program JSON, the same
feeds, 3 steps from the JAX package's startup values within 2e-4), and
the scripts' event loops train on the port. Across the packages:
``paddle.infer`` agrees at rtol 1e-5, and a parameters tar written by
either loads in the other, byte for byte.

The device seam: ``paddle.init(use_gpu=False)`` (the scripts' call) runs
on the CPU; without ``use_gpu`` the trainer and ``infer`` ask for the
card, which this machine lacks.
"""

import io
import itertools

import numpy as np
import pytest

import paddle_tpu.v2 as jpaddle
import paddle_tpu_torch as tfluid
import paddle_tpu_torch.v2 as paddle
from paddle_tpu_torch.core import scope as tscope_mod

from torch_book_harness import book_parity


@pytest.fixture(autouse=True)
def _fresh_port_programs():
    """Fresh default programs, global scope and names for the port (the
    root conftest gives the JAX package its own), and init's choice
    forgotten after the test."""
    old_main = tfluid.switch_main_program(tfluid.Program())
    old_start = tfluid.switch_startup_program(tfluid.Program())
    old_scope = tscope_mod._global_scope
    tscope_mod._global_scope = tfluid.Scope()
    with tfluid.unique_name.guard():
        yield
    tfluid.switch_main_program(old_main)
    tfluid.switch_startup_program(old_start)
    tscope_mod._global_scope = old_scope
    paddle.init()
    jpaddle.init()


# -- twins of tests/test_v2_api.py ----------------------------------------

def _toy_reader(n=128, seed=0):
    rng = np.random.RandomState(seed)
    xs = rng.rand(n, 8).astype(np.float32)
    w = rng.rand(8).astype(np.float32)
    ys = (xs @ w > w.sum() / 2).astype(np.int64)

    def reader():
        for i in range(n):
            yield xs[i], int(ys[i])
    return reader


def _build_classifier(v2):
    images = v2.layer.data("x", v2.data_type.dense_vector(8))
    label = v2.layer.data("label", v2.data_type.integer_value(2))
    hidden = v2.layer.fc(images, 16, act="tanh")
    predict = v2.layer.fc(hidden, 2, act="softmax")
    cost = v2.layer.classification_cost(predict, label)
    return cost, predict


def test_v2_event_loop_trains_and_fires_events():
    paddle.init(use_gpu=False)
    cost, predict = _build_classifier(paddle)
    parameters = paddle.parameters.create(cost)
    trainer = paddle.trainer.SGD(
        cost=cost, parameters=parameters,
        update_equation=paddle.optimizer.Adam(learning_rate=0.05))

    events = {"begin_pass": 0, "end_pass": 0, "iters": 0}
    costs = []

    def event_handler(event):
        if isinstance(event, paddle.event.BeginPass):
            events["begin_pass"] += 1
        elif isinstance(event, paddle.event.EndPass):
            events["end_pass"] += 1
            costs.append(event.cost)
        elif isinstance(event, paddle.event.EndIteration):
            events["iters"] += 1
            assert np.isfinite(event.cost)

    trainer.train(paddle.batch(_toy_reader(), batch_size=16),
                  num_passes=8, event_handler=event_handler)
    assert events["begin_pass"] == events["end_pass"] == 8
    assert events["iters"] == 8 * 8
    assert costs[-1] < costs[0] * 0.5, costs

    assert len(parameters.keys()) >= 2
    for name in parameters:
        assert np.isfinite(parameters[name]).all()

    # test() leaves parameters untouched
    before = {n: parameters[n].copy() for n in parameters}
    result = trainer.test(paddle.batch(_toy_reader(seed=1), batch_size=16))
    assert np.isfinite(result.cost)
    for n in parameters:
        np.testing.assert_array_equal(parameters[n], before[n])

    # tar round-trip + infer parity
    buf = io.BytesIO()
    trainer.save_parameter_to_tar(buf)
    buf.seek(0)
    restored = paddle.parameters.Parameters.from_tar(buf)
    for n in parameters:
        np.testing.assert_array_equal(parameters[n], restored[n])

    probe = [tuple([np.random.RandomState(7).rand(8).astype(np.float32)])]
    p1 = paddle.infer(output_layer=predict, parameters=parameters,
                      input=probe)
    p2 = paddle.infer(output_layer=predict, parameters=restored,
                      input=probe)
    np.testing.assert_allclose(p1, p2, rtol=1e-6)
    assert p1.shape == (1, 2)


def test_v2_sequence_layers_compose():
    paddle.init(use_gpu=False)
    words = paddle.layer.data(
        "words", paddle.data_type.integer_value_sequence(50))
    label = paddle.layer.data("label", paddle.data_type.integer_value(2))
    emb = paddle.layer.embedding(words, size=8)
    pooled = paddle.layer.pooling(emb, pooling_type="max")
    predict = paddle.layer.fc(pooled, 2, act="softmax")
    cost = paddle.layer.classification_cost(predict, label)
    parameters = paddle.parameters.create(cost)
    trainer = paddle.trainer.SGD(
        cost=cost, parameters=parameters,
        update_equation=paddle.optimizer.Adam(learning_rate=0.05))

    rng = np.random.RandomState(0)
    samples = []
    for _ in range(32):
        n = rng.randint(2, 6)
        seq = rng.randint(0, 50, n).tolist()
        samples.append((seq, int(seq[0] % 2)))

    def reader():
        yield from samples

    seen = []
    trainer.train(paddle.batch(reader, batch_size=8), num_passes=10,
                  event_handler=lambda e: seen.append(e.cost)
                  if isinstance(e, paddle.event.EndPass) else None)
    assert seen[-1] < seen[0] * 0.7, seen


def test_v2_type_errors():
    cost, _ = _build_classifier(paddle)
    parameters = paddle.parameters.create(cost)
    with pytest.raises(TypeError):
        paddle.trainer.SGD(cost, {"not": "parameters"},
                           paddle.optimizer.SGD())
    with pytest.raises(TypeError):
        paddle.trainer.SGD(cost, parameters, "not-an-optimizer")
    with pytest.raises(TypeError):
        paddle.layer.data("x", [8])   # fluid-style shape is not a v2 type


def test_v2_ploter(tmp_path):
    from paddle_tpu_torch.v2.plot import Ploter
    p = Ploter("train", "test")
    for i in range(5):
        p.append("train", i, 1.0 / (i + 1))
    p.append("test", 0, 0.9)
    out = str(tmp_path / "curve.png")
    p.plot(out)
    import os
    assert os.path.exists(out) or os.path.exists(out + ".csv")
    p.save_csv(str(tmp_path / "c.csv"))
    lines = (tmp_path / "c.csv").read_text().strip().splitlines()
    assert len(lines) == 6
    p.reset()
    assert p.data["train"] == ([], [])


# -- the device seam -------------------------------------------------------

def test_init_chooses_the_device():
    """init(use_gpu=False) is the CPU; init() and init(use_gpu=True) are
    the card, which the trainer asks for when it is made (and this
    machine has none); place= overrides init."""
    cost, predict = _build_classifier(paddle)
    parameters = paddle.parameters.create(cost)
    opt = paddle.optimizer.SGD()
    for use_gpu in (None, True):
        paddle.init() if use_gpu is None else paddle.init(use_gpu=use_gpu)
        assert isinstance(paddle.default_place(), tfluid.CUDAPlace)
        with pytest.raises(Exception, match="(?i)cuda|card|device"):
            paddle.trainer.SGD(cost, parameters, opt)
        with pytest.raises(Exception, match="(?i)cuda|card|device"):
            paddle.infer(output_layer=predict, parameters=parameters,
                         input=[(np.zeros(8, np.float32),)])
    trainer = paddle.trainer.SGD(cost, parameters, opt,
                                 place=tfluid.CPUPlace())
    assert trainer.__exe__.device.type == "cpu"
    paddle.init(use_gpu=False)
    assert paddle.default_place() == tfluid.CPUPlace()


# -- across the packages: Programs, infer, tars ------------------------------

def _classifier_pair():
    """The classifier built by both packages under fresh names: (JAX
    cost, predict), (port cost, predict)."""
    import paddle_tpu as jfluid
    with jfluid.unique_name.guard():
        jcost, jpred = _build_classifier(jpaddle)
    with tfluid.unique_name.guard():
        tcost, tpred = _build_classifier(paddle)
    return (jcost, jpred), (tcost, tpred)


def test_v2_program_json_matches_jax():
    (jcost, _), (tcost, _) = _classifier_pair()
    assert tcost.block.program.to_json() == jcost.block.program.to_json()
    jparams = jpaddle.parameters.create(jcost)
    tparams = paddle.parameters.create(tcost)
    assert tparams.keys() == jparams.keys()


def test_v2_infer_and_tars_cross_package():
    """Train the classifier 2 passes in the JAX package, write its tar;
    the port loads it, infers what the JAX package infers (rtol 1e-5)
    and writes the same tar bytes back; the port then trains on, and
    the JAX package loads the port's tar and infers what the port
    infers."""
    jpaddle.init(use_gpu=False)
    paddle.init(use_gpu=False)
    (jcost, jpred), (tcost, tpred) = _classifier_pair()
    jparams = jpaddle.parameters.create(jcost)
    jtrainer = jpaddle.trainer.SGD(
        jcost, jparams, jpaddle.optimizer.Adam(learning_rate=0.05))
    jtrainer.train(jpaddle.batch(_toy_reader(), batch_size=16),
                   num_passes=2)
    jbuf = io.BytesIO()
    jtrainer.save_parameter_to_tar(jbuf)

    probe = [(x,) for x, _ in itertools.islice(_toy_reader(seed=3)(), 5)]
    tparams = paddle.parameters.Parameters.from_tar(
        io.BytesIO(jbuf.getvalue()))
    got = paddle.infer(output_layer=tpred, parameters=tparams, input=probe)
    want = jpaddle.infer(output_layer=jpred, parameters=jparams,
                         input=probe)
    assert got.shape == (5, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    tbuf = io.BytesIO()
    tparams.to_tar(tbuf)
    assert tbuf.getvalue() == jbuf.getvalue()

    # the port trains on from the loaded values; the JAX package loads
    # the port's tar
    tparams = paddle.parameters.create(tcost)
    tparams.init_from_tar(io.BytesIO(jbuf.getvalue()))
    ttrainer = paddle.trainer.SGD(
        tcost, tparams, paddle.optimizer.SGD(learning_rate=0.1))
    ttrainer.train(paddle.batch(_toy_reader(seed=2), batch_size=16),
                   num_passes=1)
    tbuf = io.BytesIO()
    ttrainer.save_parameter_to_tar(tbuf)
    jloaded = jpaddle.parameters.Parameters.from_tar(
        io.BytesIO(tbuf.getvalue()))
    for n in jloaded:
        np.testing.assert_array_equal(jloaded[n], tparams[n])
    got = paddle.infer(output_layer=tpred, parameters=tparams, input=probe)
    want = jpaddle.infer(output_layer=jpred, parameters=jloaded,
                         input=probe)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -- the v2 book scripts -------------------------------------------------------

def _v2(pkg):
    import importlib
    return importlib.import_module(pkg.__name__ + ".v2")


def softmax_regression(v2, img):
    return v2.layer.fc(input=img, size=10, act=v2.activation.Softmax())


def multilayer_perceptron(v2, img):
    hidden1 = v2.layer.fc(input=img, size=64, act=v2.activation.Relu())
    hidden2 = v2.layer.fc(input=hidden1, size=32,
                          act=v2.activation.Relu())
    return v2.layer.fc(input=hidden2, size=10,
                       act=v2.activation.Softmax())


def convolutional_neural_network(v2, img):
    conv_pool_1 = v2.networks.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=8, num_channel=1,
        pool_size=2, pool_stride=2, act=v2.activation.Relu())
    conv_pool_2 = v2.networks.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=16, num_channel=8,
        pool_size=2, pool_stride=2, act=v2.activation.Relu())
    return v2.layer.fc(input=conv_pool_2, size=10,
                       act=v2.activation.Softmax())


def _digits(net_fn, lr=0.05):
    """recognize_digits' v2 script, as a book_parity builder."""
    def build(pkg):
        v2 = _v2(pkg)
        images = v2.layer.data(name="pixel",
                               type=v2.data_type.dense_vector(784))
        label = v2.layer.data(name="label",
                              type=v2.data_type.integer_value(10))
        predict = net_fn(v2, images)
        cost = v2.layer.classification_cost(input=predict, label=label)
        v2.optimizer.Momentum(
            learning_rate=lr / 128.0, momentum=0.9,
            regularization=v2.optimizer.L2Regularization(rate=5e-4)
        )._make().minimize(cost)
        return [images, label], cost
    return build


DIGITS = [softmax_regression, multilayer_perceptron,
          convolutional_neural_network]


@pytest.mark.parametrize("net_fn", DIGITS, ids=lambda f: f.__name__)
def test_v2_recognize_digits_parity(net_fn):
    """Identical Program JSON, feeds and 3 Momentum steps within 2e-4 of
    the JAX package, at the script's batch of 64."""
    losses, _, _, feeds = book_parity(
        _digits(net_fn),
        paddle.reader.shuffle(paddle.dataset.mnist.train(n=512),
                              buf_size=512), batch_size=64)
    assert feeds[0]["pixel"].shape == (64, 784)


@pytest.mark.parametrize("net_fn,passes", [
    (softmax_regression, 4), (multilayer_perceptron, 4),
    (convolutional_neural_network, 3)], ids=lambda v: getattr(
        v, "__name__", ""))
def test_v2_recognize_digits_script(net_fn, passes):
    """The script's event loop on the port (init(use_gpu=False), as the
    script calls it): the cost falls, and paddle.infer over the test
    split gives 32 distributions."""
    paddle.init(use_gpu=False, trainer_count=1)
    images = paddle.layer.data(
        name="pixel", type=paddle.data_type.dense_vector(784))
    label = paddle.layer.data(
        name="label", type=paddle.data_type.integer_value(10))
    predict = net_fn(paddle, images)
    cost = paddle.layer.classification_cost(input=predict, label=label)
    parameters = paddle.parameters.create(cost)
    optimizer = paddle.optimizer.Momentum(
        learning_rate=0.05 / 128.0, momentum=0.9,
        regularization=paddle.optimizer.L2Regularization(rate=5e-4))
    trainer = paddle.trainer.SGD(cost=cost, parameters=parameters,
                                 update_equation=optimizer)
    costs = []
    trainer.train(
        reader=paddle.batch(
            paddle.reader.shuffle(paddle.dataset.mnist.train(n=512),
                                  buf_size=512), batch_size=64),
        num_passes=passes,
        event_handler=lambda e: costs.append(e.cost)
        if isinstance(e, paddle.event.EndPass) else None)
    assert costs[-1] < costs[0], costs
    test_data = [(s[0],) for s in paddle.dataset.mnist.test(n=32)()]
    probs = paddle.infer(output_layer=predict, parameters=parameters,
                         input=test_data)
    assert probs.shape == (32, 10)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-3)


def stacked_lstm_net(v2, data, class_dim=2, emb_dim=32, hid_dim=32,
                     stacked_num=3):
    fc_para_attr = v2.attr.Param(learning_rate=1.0)
    relu = v2.activation.Relu()
    linear = v2.activation.Linear()
    emb = v2.layer.embedding(input=data, size=emb_dim)
    fc1 = v2.layer.fc(input=emb, size=hid_dim, act=linear,
                      param_attr=fc_para_attr)
    lstm1 = v2.layer.lstmemory(input=fc1, act=relu)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = v2.layer.fc(input=inputs, size=hid_dim, act=linear,
                         param_attr=fc_para_attr)
        lstm = v2.layer.lstmemory(input=fc, reverse=(i % 2) == 0, act=relu)
        inputs = [fc, lstm]
    fc_last = v2.layer.pooling(input=inputs[0],
                               pooling_type=v2.pooling.Max())
    lstm_last = v2.layer.pooling(input=inputs[1],
                                 pooling_type=v2.pooling.Max())
    return v2.layer.fc(input=[fc_last, lstm_last], size=class_dim,
                       act=v2.activation.Softmax(), param_attr=fc_para_attr)


def convolution_net(v2, data, class_dim=2, emb_dim=32, hid_dim=32):
    emb = v2.layer.embedding(input=data, size=emb_dim)
    conv_3 = v2.networks.sequence_conv_pool(input=emb, context_len=3,
                                            hidden_size=hid_dim)
    conv_4 = v2.networks.sequence_conv_pool(input=emb, context_len=4,
                                            hidden_size=hid_dim)
    return v2.layer.fc(input=[conv_3, conv_4], size=class_dim,
                       act=v2.activation.Softmax())


def _sentiment(net_fn):
    """understand_sentiment's v2 script, as a book_parity builder."""
    def build(pkg):
        v2 = _v2(pkg)
        word_dict = v2.dataset.imdb.word_dict()
        data = v2.layer.data(name="word",
                             type=v2.data_type.integer_value_sequence(
                                 len(word_dict)))
        label = v2.layer.data(name="label",
                              type=v2.data_type.integer_value(2))
        cost = v2.layer.classification_cost(input=net_fn(v2, data),
                                            label=label)
        v2.optimizer.Adam(
            learning_rate=2e-3,
            regularization=v2.optimizer.L2Regularization(rate=8e-4)
        )._make().minimize(cost)
        return [data, label], cost
    return build


@pytest.mark.parametrize("net_fn", [stacked_lstm_net, convolution_net],
                         ids=lambda f: f.__name__)
def test_v2_understand_sentiment_parity(net_fn):
    """Identical Program JSON, LoD feeds and 3 Adam steps within 2e-4 of
    the JAX package, at the script's batch of 32."""
    word_dict = paddle.dataset.imdb.word_dict()
    losses, _, _, feeds = book_parity(
        _sentiment(net_fn),
        paddle.reader.shuffle(paddle.dataset.imdb.train(word_dict, n=96),
                              buf_size=96), batch_size=32)
    assert isinstance(feeds[0]["word"], tfluid.LoDTensor)


@pytest.mark.parametrize("net_fn", [stacked_lstm_net, convolution_net],
                         ids=lambda f: f.__name__)
def test_v2_understand_sentiment_script(net_fn):
    """The script's event loop on the port, over half its 256 reviews:
    the cost falls over 3 passes and test() gives a finite cost."""
    paddle.init(use_gpu=False, trainer_count=1)
    word_dict = paddle.dataset.imdb.word_dict()
    data = paddle.layer.data(
        name="word",
        type=paddle.data_type.integer_value_sequence(len(word_dict)))
    label = paddle.layer.data(name="label",
                              type=paddle.data_type.integer_value(2))
    cost = paddle.layer.classification_cost(input=net_fn(paddle, data),
                                            label=label)
    parameters = paddle.parameters.create(cost)
    trainer = paddle.trainer.SGD(
        cost=cost, parameters=parameters,
        update_equation=paddle.optimizer.Adam(
            learning_rate=2e-3,
            regularization=paddle.optimizer.L2Regularization(rate=8e-4)))
    costs = []
    trainer.train(
        reader=paddle.batch(paddle.reader.shuffle(
            paddle.dataset.imdb.train(word_dict, n=128), buf_size=128),
            batch_size=32),
        num_passes=3, event_handler=lambda e: costs.append(e.cost)
        if isinstance(e, paddle.event.EndPass) else None)
    assert costs[-1] < costs[0], costs
    result = trainer.test(reader=paddle.batch(
        paddle.dataset.imdb.test(word_dict, n=64), batch_size=32))
    assert np.isfinite(result.cost)
