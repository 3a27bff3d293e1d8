"""MNIST MLP and LeNet-style conv net (reference
benchmark/fluid/mnist.py), and the composed ``cnn_infer`` pipeline.

The counterpart of ``paddle_tpu/models/mlp.py`` but for its
``analysis_entry*`` functions, whose static-analysis harness is not
ported (ROADMAP.md, queue 1 item 11(b)). Built through the port's
``layers``, each emits the JAX package's Program.
"""

from .. import layers, optimizer


def mlp(img, label, hidden_sizes=(128, 64), num_classes=10):
    x = img
    for h in hidden_sizes:
        x = layers.fc(x, h, act="relu")
    prediction = layers.fc(x, num_classes, act="softmax")
    cost = layers.cross_entropy(prediction, label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(prediction, label)
    return prediction, avg_cost, acc


def cnn(img, label, num_classes=10):
    """LeNet-style conv net (mnist.py cnn_model: two conv-pool blocks and
    an fc softmax head)."""
    conv1 = layers.conv2d(img, num_filters=20, filter_size=5, act="relu")
    pool1 = layers.pool2d(conv1, pool_size=2, pool_stride=2)
    conv2 = layers.conv2d(pool1, num_filters=50, filter_size=5, act="relu")
    pool2 = layers.pool2d(conv2, pool_size=2, pool_stride=2)
    prediction = layers.fc(pool2, num_classes, act="softmax")
    cost = layers.cross_entropy(prediction, label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(prediction, label)
    return prediction, avg_cost, acc


def zoo_spec():
    """(build_fn, feed_fn) for the MLP Adam train step."""
    def build():
        img = layers.data("img", [784])
        label = layers.data("label", [1], dtype="int64")
        _, avg_cost, acc = mlp(img, label)
        optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
        return avg_cost, acc

    def feeds(rng):
        return {"img": rng.rand(8, 784).astype("float32"),
                "label": rng.randint(0, 10, (8, 1)).astype("int64")}

    return build, feeds


def zoo_spec_cnn():
    """(build_fn, feed_fn) for the LeNet CNN Adam train step."""
    def build():
        img = layers.data("img", [1, 28, 28])
        label = layers.data("label", [1], dtype="int64")
        _, avg_cost, acc = cnn(img, label)
        optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
        return avg_cost, acc

    def feeds(rng):
        return {"img": rng.rand(4, 1, 28, 28).astype("float32"),
                "label": rng.randint(0, 10, (4, 1)).astype("int64")}

    return build, feeds


def zoo_spec_cnn_infer():
    """(build_fn, feed_fn) for a composed inference pipeline: a raw uint8
    image feed normalized in the graph (cast, scale), a conv stage
    exported NHWC and read back NCHW (two inverse transposes), a flatten
    regrouped at once (a reshape of a reshape), and the fc softmax
    head."""
    def build():
        img = layers.data("img", [1, 28, 28], dtype="uint8")
        x = layers.cast(img, "float32")
        x = layers.scale(x, scale=1.0 / 255.0)
        conv = layers.conv2d(x, num_filters=8, filter_size=5, act="relu")
        pool = layers.pool2d(conv, pool_size=2, pool_stride=2)
        nhwc = layers.transpose(pool, [0, 2, 3, 1])
        nchw = layers.transpose(nhwc, [0, 3, 1, 2])
        flat = layers.reshape(nchw, [-1, 8 * 12 * 12])
        grouped = layers.reshape(flat, [-1, 8, 144])
        pred = layers.fc(grouped, 10, act="softmax")
        return (pred,)

    def feeds(rng):
        return {"img": rng.randint(
            0, 256, (4, 1, 28, 28)).astype("uint8")}

    return build, feeds
