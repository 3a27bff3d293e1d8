"""Image preprocessing utilities — reference parity:
python/paddle/dataset/image.py (resize, crop, flip, to_chw, color
conversion) implemented with numpy only (no cv2 dependency)."""

import numpy as np

__all__ = ["resize_short", "to_chw", "center_crop", "random_crop",
           "left_right_flip", "simple_transform"]


def _resize_bilinear(img, h, w):
    """img HWC float/uint8 -> resized HWC (numpy bilinear)."""
    ih, iw = img.shape[:2]
    ys = (np.arange(h) + 0.5) * ih / h - 0.5
    xs = (np.arange(w) + 0.5) * iw / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, ih - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, iw - 1)
    y1 = np.clip(y0 + 1, 0, ih - 1)
    x1 = np.clip(x0 + 1, 0, iw - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    im = img.astype(np.float32)
    if im.ndim == 2:
        im = im[:, :, None]
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return out.astype(img.dtype) if img.dtype == np.uint8 else out


def resize_short(im, size):
    h, w = im.shape[:2]
    if h < w:
        return _resize_bilinear(im, size, int(w * size / h))
    return _resize_bilinear(im, int(h * size / w), size)


def to_chw(im, order=(2, 0, 1)):
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    y0 = (h - size) // 2
    x0 = (w - size) // 2
    return im[y0:y0 + size, x0:x0 + size]


def random_crop(im, size, is_color=True, rng=None):
    rng = rng or np.random
    h, w = im.shape[:2]
    y0 = rng.randint(0, h - size + 1)
    x0 = rng.randint(0, w - size + 1)
    return im[y0:y0 + size, x0:x0 + size]


def left_right_flip(im, is_color=True):
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None, rng=None):
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, rng=rng)
        if (rng or np.random).randint(0, 2) == 1:
            im = left_right_flip(im)
    else:
        im = center_crop(im, crop_size)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        im -= mean if mean.ndim >= 2 else mean[:, None, None]
    return im
