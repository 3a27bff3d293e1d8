"""VGG-16 with batch norm and dropout (reference benchmark/fluid/vgg.py).

The counterpart of ``paddle_tpu/models/vgg.py`` but for its
``analysis_entry`` (ROADMAP.md, queue 1 item 11(b)). Built through the
port's ``nets`` and ``layers``, it emits the JAX package's Program; its
dropouts draw on the CUDA dropout kernel on the card.
"""

from .. import layers, optimizer
from ..nets import img_conv_group


def vgg16_bn_drop(input, num_classes=10):
    def group(x, num, filters):
        return img_conv_group(x, conv_num_filter=[filters] * num,
                              pool_size=2, pool_stride=2, conv_act="relu",
                              conv_with_batchnorm=True,
                              conv_batchnorm_drop_rate=[0.3] * (num - 1)
                              + [0.0])

    conv1 = group(input, 2, 64)
    conv2 = group(conv1, 2, 128)
    conv3 = group(conv2, 3, 256)
    conv4 = group(conv3, 3, 512)
    conv5 = group(conv4, 3, 512)
    drop = layers.dropout(conv5, dropout_prob=0.5)
    fc1 = layers.fc(drop, 512, act=None)
    bn = layers.batch_norm(fc1, act="relu")
    drop2 = layers.dropout(bn, dropout_prob=0.5)
    fc2 = layers.fc(drop2, 512, act=None)
    return layers.fc(fc2, num_classes, act="softmax")


def build_train_net(image_shape=(3, 32, 32), num_classes=10,
                    learning_rate=1e-3, image=None, label=None):
    if image is None:
        image = layers.data("data", list(image_shape))
    if label is None:
        label = layers.data("label", [1], dtype="int64")
    predict = vgg16_bn_drop(image, num_classes)
    cost = layers.cross_entropy(predict, label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(predict, label)
    optimizer.Adam(learning_rate=learning_rate).minimize(avg_cost)
    return image, label, avg_cost, acc


def zoo_spec():
    """(build_fn, feed_fn): VGG-16 Adam train step, dropout included."""
    def build():
        _, _, avg_cost, acc = build_train_net(image_shape=(3, 32, 32))
        return avg_cost, acc

    def feeds(rng):
        return {"data": rng.rand(2, 3, 32, 32).astype("float32"),
                "label": rng.randint(0, 10, (2, 1)).astype("int64")}

    return build, feeds
