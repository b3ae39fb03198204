"""``gluon.data.vision`` (counterpart of
``mxnet_tpu/gluon/data/vision/``, reference
python/mxnet/gluon/data/vision/)."""

from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,
                       ImageRecordDataset, ImageFolderDataset,
                       ImageListDataset)
from . import transforms
