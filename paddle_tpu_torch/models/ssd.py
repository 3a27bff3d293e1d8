"""SSD object detector, the detection model family of the reference era
(reference layers/detection.py multi_box_head/ssd_loss; the SSD ops are
operators/{prior_box,box_coder,bipartite_match,mine_hard_examples,
multiclass_nms}_op.cc).

The counterpart of ``paddle_tpu/models/ssd.py`` but for its
``analysis_entry``, whose static-analysis harness is not ported
(ROADMAP.md, queue 1 item 11(b)), with ``make_batch``, a seeded batch of
images and ground truth. A compact VGG-ish backbone feeds two
detection feature maps; training uses the fused batch-aware
``ssd_loss`` op, inference decodes and NMSes with ``detection_output``.
"""

from .. import layers, optimizer


def _backbone(image):
    """Two detection feature maps at strides 8 and 16."""
    x = image
    for width in (16, 32):
        x = layers.conv2d(x, num_filters=width, filter_size=3, padding=1,
                          act="relu")
        x = layers.pool2d(x, pool_size=2, pool_stride=2)
    f1 = layers.conv2d(x, num_filters=64, filter_size=3, padding=1,
                       stride=2, act="relu")
    f2 = layers.conv2d(f1, num_filters=64, filter_size=3, padding=1,
                       stride=2, act="relu")
    return f1, f2


def _head(image, image_shape, num_classes):
    """Shared backbone + multi_box_head config: train and infer nets must
    agree on the prior grid and conv shapes or a trained checkpoint
    stops matching the inference net."""
    f1, f2 = _backbone(image)
    return layers.multi_box_head(
        inputs=[f1, f2], image=image, base_size=image_shape[-1],
        num_classes=num_classes, aspect_ratios=[[2.0], [2.0, 3.0]],
        min_sizes=[image_shape[-1] * 0.2, image_shape[-1] * 0.5],
        max_sizes=[image_shape[-1] * 0.5, image_shape[-1] * 0.9])


def build_ssd_train_net(image_shape=(3, 64, 64), num_classes=5,
                        learning_rate=1e-3):
    """Returns (image, gt_box, gt_label, loss). gt_box/gt_label are
    flat-LoD ([Ng, 4] / [Ng, 1] with per-image lengths)."""
    image = layers.data("image", list(image_shape))
    gt_box = layers.data("gt_box", [4], lod_level=1)
    gt_label = layers.data("gt_label", [1], dtype="int64", lod_level=1)
    locs, confs, boxes, vars_ = _head(image, image_shape, num_classes)
    loss = layers.mean(layers.ssd_loss(locs, confs, gt_box, gt_label,
                                       boxes, vars_))
    optimizer.Adam(learning_rate=learning_rate).minimize(loss)
    return image, gt_box, gt_label, loss


def build_ssd_infer_net(image_shape=(3, 64, 64), num_classes=5,
                        nms_threshold=0.45, score_threshold=0.01,
                        keep_top_k=50):
    """Returns (image, detections [N, keep_top_k, 6] rows of (label,
    score, x1, y1, x2, y2), -1-padded)."""
    image = layers.data("image", list(image_shape))
    locs, confs, boxes, vars_ = _head(image, image_shape, num_classes)
    # detection_output softmaxes the raw [N, M, C] scores itself
    # (reference detection_output contract)
    dets = layers.detection_output(
        locs, confs, boxes, vars_, nms_threshold=nms_threshold,
        score_threshold=score_threshold, keep_top_k=keep_top_k)
    return image, dets


def make_batch(fluid=None, batch=32, seed=0, image_shape=(3, 64, 64),
               num_classes=5):
    """(feed dict, ground-truth lengths): ``batch`` images in [0, 1) with
    1 to 4 ground-truth boxes each (sides 0.15 to 0.4 of the image) and
    labels 1 .. num_classes - 1, all from RandomState(seed); the flat
    ground truth carries the lengths as its LoD."""
    import numpy as np
    if fluid is None:
        import paddle_tpu_torch as fluid
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, 5, size=batch).tolist()
    lo = rng.uniform(0.0, 0.6, (sum(lens), 2))
    size = rng.uniform(0.15, 0.4, (sum(lens), 2))
    gt = np.concatenate([lo, np.minimum(lo + size, 1.0)], 1).astype(
        np.float32)
    lab = rng.randint(1, num_classes, (sum(lens), 1)).astype(np.int64)
    image = rng.rand(batch, *image_shape).astype(np.float32)
    return {"image": image, "gt_box": fluid.create_lod_tensor(gt, [lens]),
            "gt_label": fluid.create_lod_tensor(lab, [lens])}, lens


def zoo_spec():
    """(build_fn, feed_fn): SSD train step with LoD ground truth."""
    import numpy as np
    from ..core.lod import create_lod_tensor

    def build():
        _, _, _, loss = build_ssd_train_net(image_shape=(3, 64, 64))
        return (loss,)

    def feeds(rng):
        gt = np.array([[0.1, 0.1, 0.5, 0.5], [0.4, 0.4, 0.9, 0.9],
                       [0.2, 0.2, 0.6, 0.8]], np.float32)
        lab = np.array([[1], [2], [3]], np.int64)
        return {"image": rng.rand(2, 3, 64, 64).astype(np.float32),
                "gt_box": create_lod_tensor(gt, [[2, 1]]),
                "gt_label": create_lod_tensor(lab, [[2, 1]])}

    return build, feeds
