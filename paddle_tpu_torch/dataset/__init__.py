"""Built-in datasets (synthetic, egress-free) — parity with
python/paddle/dataset/ (15 datasets; see each module).

The counterpart of ``paddle_tpu/dataset/`` (a copy: numpy only): each
reader yields the same samples, byte for byte, as its JAX-package twin
for the same arguments."""

from . import (  # noqa: F401
    cifar, common, conll05, flowers, image, imdb, imikolov, mnist,
    movielens, mq2007, sentiment, uci_housing, voc2012, wmt14, wmt16,
)
