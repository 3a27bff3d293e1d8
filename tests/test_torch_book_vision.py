"""Book models of ``tests/book/`` through the port against the JAX
package, part 1: fit_a_line, image_classification (ResNet and VGG) and
recommender_system, at narrow widths. Each net is built in both
packages from one builder, fed by the port's own ``dataset`` reader and
``DataFeeder`` (the JAX package's feeder gives the same feed), and
trained 3 steps from the JAX package's startup values: the losses and
every persistable value within 2e-4 (``torch_book_harness``).
"""

import numpy as np

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.dataset import cifar, movielens, uci_housing

from torch_book_harness import book_parity


def fit_a_line(pkg):
    x = pkg.layers.data("x", [13])
    y = pkg.layers.data("y", [1])
    y_predict = pkg.layers.fc(x, 1)
    avg_cost = pkg.layers.mean(pkg.layers.square_error_cost(y_predict, y))
    pkg.optimizer.SGD(learning_rate=0.01).minimize(avg_cost)
    return [x, y], avg_cost


def test_fit_a_line():
    losses, scope, main, feeds = book_parity(
        fit_a_line, tfluid.reader.shuffle(uci_housing.train(), 500),
        batch_size=20)
    assert feeds[0]["x"].shape == (20, 13) and feeds[0]["y"].shape == (20, 1)


def _classifier(net, optimizer):
    def build(pkg):
        images = pkg.layers.data("pixel", [3, 32, 32])
        label = pkg.layers.data("label", [1], dtype="int64")
        predict = net(pkg, images)
        avg_cost = pkg.layers.mean(pkg.layers.cross_entropy(predict, label))
        pkg.layers.accuracy(predict, label)
        optimizer(pkg).minimize(avg_cost)
        return [images, label], avg_cost
    return build


def _resnet(pkg, images):
    if pkg is tfluid:
        from paddle_tpu_torch.models import resnet
    else:
        from paddle_tpu.models import resnet
    return resnet.resnet_cifar10(images, depth=8)


def _momentum(pkg):
    return pkg.optimizer.Momentum(learning_rate=0.01, momentum=0.9)


def test_image_classification_resnet():
    """The book's ResNet-CIFAR at depth 8 (one basic block a stage: 16,
    32 and 64 channels, the two projection shortcuts), batch 8, with
    Momentum for the book's Adam: Adam's first steps divide each
    gradient element by its own magnitude, so an element near zero moves
    by about lr on either package's rounding (with Adam 8 of the first
    conv's 432 weights part by 4e-4 after 3 steps, twice the bound).
    The parameters and batch-norm statistics are held; the velocities
    are not (``torch_book_harness``)."""
    book_parity(_classifier(_resnet, _momentum),
                tfluid.reader.shuffle(cifar.train10(64), 64), batch_size=8,
                params_only=True)


def _vgg_bn_drop(pkg, images):
    """The book's vgg_bn_drop, narrow: two conv groups of 8 and 16
    channels (batch norm after each conv), then fc 32 with batch norm,
    fc 32 and the softmax; its dropouts at rate 0 (the packages' draws
    differ: threefry against Philox)."""
    def group(x, ch, n):
        return pkg.nets.img_conv_group(
            input=x, pool_size=2, pool_stride=2, conv_num_filter=[ch] * n,
            conv_filter_size=3, conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=[0.0] * n, pool_type="max")
    conv2 = group(group(images, 8, 2), 16, 2)
    drop = pkg.layers.dropout(conv2, dropout_prob=0.0)
    fc1 = pkg.layers.fc(drop, 32)
    bn = pkg.layers.batch_norm(fc1, act="relu")
    drop2 = pkg.layers.dropout(bn, dropout_prob=0.0)
    fc2 = pkg.layers.fc(drop2, 32)
    return pkg.layers.fc(fc2, 10, act="softmax")


def test_image_classification_vgg():
    """VGG with Momentum: its conv biases sit before a batch norm, so
    their true gradient is 0, and Adam's first step (lr * g / (|g| +
    eps)) would move each by +-lr on the sign of each package's own
    rounding noise (as ``tests/test_torch_zoo.py`` says of VGG-16).
    The parameters and batch-norm statistics are held; the velocities
    are not (``torch_book_harness``)."""
    book_parity(_classifier(_vgg_bn_drop, _momentum),
                tfluid.reader.shuffle(cifar.train10(64), 64), batch_size=8,
                params_only=True)


def recommender(pkg):
    ml = tfluid.dataset.movielens
    usr_id = pkg.layers.data("user_id", [1], dtype="int64")
    gender = pkg.layers.data("gender_id", [1], dtype="int64")
    age = pkg.layers.data("age_id", [1], dtype="int64")
    job = pkg.layers.data("job_id", [1], dtype="int64")

    def emb(x, n):
        return pkg.layers.fc(pkg.layers.embedding(x, size=[n, 8]), 8)
    usr = pkg.layers.fc(pkg.layers.concat(
        [emb(usr_id, ml.max_user_id() + 1), emb(gender, 2),
         emb(age, len(ml.age_table()) + 1), emb(job, ml.max_job_id() + 1)],
        axis=1), 16, act="tanh")

    mov_id = pkg.layers.data("movie_id", [1], dtype="int64")
    category = pkg.layers.data("category_id", [1], dtype="int64",
                               lod_level=1)
    title = pkg.layers.data("movie_title", [1], dtype="int64", lod_level=1)
    cat_pool = pkg.layers.sequence_pool(
        pkg.layers.embedding(category, size=[ml.CATEGORIES, 8]), "sum")
    title_pool = pkg.layers.sequence_pool(
        pkg.layers.embedding(title, size=[ml.TITLE_VOCAB + 1, 8]), "sum")
    mov = pkg.layers.fc(pkg.layers.concat(
        [emb(mov_id, ml.max_movie_id() + 1), cat_pool, title_pool],
        axis=1), 16, act="tanh")

    label = pkg.layers.data("score", [1])
    scale_infer = pkg.layers.scale(pkg.layers.cos_sim(usr, mov), scale=5.0)
    avg_cost = pkg.layers.mean(pkg.layers.square_error_cost(scale_infer,
                                                            label))
    pkg.optimizer.Adam(learning_rate=0.01).minimize(avg_cost)
    return [usr_id, gender, age, job, mov_id, category, title,
            label], avg_cost


def test_recommender_system():
    losses, _, _, feeds = book_parity(
        recommender, tfluid.reader.shuffle(movielens.train(256), 256),
        batch_size=16)
    assert isinstance(feeds[0]["movie_title"], tfluid.LoDTensor)
    assert feeds[0]["user_id"].shape == (16, 1)
    assert np.isfinite(losses).all()
