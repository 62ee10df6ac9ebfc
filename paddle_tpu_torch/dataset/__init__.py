"""Datasets.

Capability parity: `python/paddle/dataset/` (mnist, cifar, imdb, imikolov,
uci_housing, ...). The loaders never fetch: each serves deterministic
synthetic data with the real schema and shapes, and where the real files
are cached under ``common.DATA_HOME`` (one directory for this package and
paddle_tpu) it reads them instead. Every loader yields the samples
paddle_tpu's loader of the same name yields, bit for bit. Pure numpy.
"""

from paddle_tpu_torch.dataset import mnist, cifar, imdb, uci_housing, imikolov  # noqa
from paddle_tpu_torch.dataset import (  # noqa: F401
    movielens, conll05, wmt14, wmt16, flowers, voc2012, mq2007, sentiment)
from paddle_tpu_torch.dataset import common  # noqa: F401
