"""ResNet for CIFAR-10 and ImageNet.

The counterpart of ``paddle_tpu/models/resnet.py`` (all its builders but
``analysis_entry``, whose static-analysis harness is not ported). Built
through the port's ``layers``, it emits the same Program as the JAX
package (``Program.to_json`` is identical under ``unique_name.guard()``).
With the flag ``fuse_conv_bn`` on, every 1x1 convolution feeding a
train-mode batch norm (36 of ResNet-50's 53 convolutions) runs on the
CUDA ``matmul_stats`` kernel on the card.
"""

from .. import layers, optimizer
from ..core.backward import append_backward


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu"):
    conv = layers.conv2d(input, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act=None, bias_attr=False)
    return layers.batch_norm(conv, act=act)


def shortcut(input, ch_out, stride):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None)
    return input


def basicblock(input, ch_out, stride):
    short = shortcut(input, ch_out, stride)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None)
    return layers.elementwise_add(short, conv2, act="relu")


def bottleneck(input, ch_out, stride):
    short = shortcut(input, ch_out * 4, stride)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None)
    return layers.elementwise_add(short, conv3, act="relu")


def layer_warp(block_func, input, ch_out, count, stride):
    res = block_func(input, ch_out, stride)
    for _ in range(1, count):
        res = block_func(res, ch_out, 1)
    return res


def resnet_cifar10(input, depth=32, num_classes=10):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, ch_out=16, filter_size=3, stride=1,
                          padding=1)
    res1 = layer_warp(basicblock, conv1, 16, n, 1)
    res2 = layer_warp(basicblock, res1, 32, n, 2)
    res3 = layer_warp(basicblock, res2, 64, n, 2)
    pool = layers.pool2d(res3, pool_type="avg", global_pooling=True)
    return layers.fc(pool, num_classes, act="softmax")


def resnet_imagenet(input, depth=50, num_classes=1000):
    cfg = {18: ([2, 2, 2, 1], basicblock),
           34: ([3, 4, 6, 3], basicblock),
           50: ([3, 4, 6, 3], bottleneck),
           101: ([3, 4, 23, 3], bottleneck),
           152: ([3, 8, 36, 3], bottleneck)}
    stages, block_func = cfg[depth]
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3)
    pool1 = layers.pool2d(conv1, pool_size=3, pool_stride=2,
                          pool_padding=1)
    res1 = layer_warp(block_func, pool1, 64, stages[0], 1)
    res2 = layer_warp(block_func, res1, 128, stages[1], 2)
    res3 = layer_warp(block_func, res2, 256, stages[2], 2)
    res4 = layer_warp(block_func, res3, 512, stages[3], 2)
    pool2 = layers.pool2d(res4, pool_type="avg", global_pooling=True)
    return layers.fc(pool2, num_classes, act="softmax")


def build_train_net(model="resnet_cifar10", depth=None, image_shape=(3, 32, 32),
                    num_classes=10, learning_rate=0.01, image=None,
                    label=None, optimize=True):
    """Returns (image, label, avg_cost, accuracy). Pass pre-built image/
    label vars to skip the feed layers; optimize=False builds fwd (+bwd
    via append_backward) without the optimizer."""
    if image is None:
        image = layers.data("data", list(image_shape))
    if label is None:
        label = layers.data("label", [1], dtype="int64")
    if model == "resnet_cifar10":
        predict = resnet_cifar10(image, depth or 32, num_classes)
    else:
        predict = resnet_imagenet(image, depth or 50, num_classes)
    cost = layers.cross_entropy(predict, label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(predict, label)
    if optimize:
        optimizer.Momentum(learning_rate=learning_rate,
                           momentum=0.9).minimize(avg_cost)
    else:
        append_backward(avg_cost)
    return image, label, avg_cost, acc


def zoo_spec():
    """(build_fn, feed_fn): ResNet-CIFAR10 Momentum train step."""
    def build():
        _, _, avg_cost, acc = build_train_net(
            model="resnet_cifar10", depth=8, image_shape=(3, 16, 16))
        return avg_cost, acc

    def feeds(rng):
        return {"data": rng.rand(4, 3, 16, 16).astype("float32"),
                "label": rng.randint(0, 10, (4, 1)).astype("int64")}

    return build, feeds
