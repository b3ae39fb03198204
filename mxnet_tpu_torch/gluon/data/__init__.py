"""``gluon.data`` (counterpart of ``mxnet_tpu/gluon/data/``,
reference python/mxnet/gluon/data/)."""

from .dataset import (ArrayDataset, Dataset, RecordFileDataset,
                      SimpleDataset, _DownloadedDataset)
from .sampler import (BatchSampler, RandomSampler, Sampler,
                      SequentialSampler, FilterSampler, IntervalSampler,
                      SplitSampler)
from .dataloader import DataLoader
from . import vision
