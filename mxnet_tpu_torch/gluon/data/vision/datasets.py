"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``, reference
python/mxnet/gluon/data/vision/datasets.py).

MNIST, FashionMNIST, CIFAR10 and CIFAR100 read local files only (under
``root``, by default ``$MXNET_HOME/datasets/<name>``, the reference's
layout); nothing is downloaded. Their images are held on the host (a CPU
NDArray), so that a forked ``DataLoader`` worker can read them without
touching CUDA; the ``DataLoader`` puts each batch on the current context.
The record, folder and list datasets decode images through ``image`` and
``recordio``, which are not ported yet (ROADMAP A11): they raise.
"""

import gzip
import os
import pickle
import struct
import tarfile

import numpy as _np

from ....context import cpu
from ....ndarray.ndarray import array
from ..dataset import Dataset, RecordFileDataset, _DownloadedDataset


def _data_home():
    return os.environ.get('MXNET_HOME',
                          os.path.join(os.path.expanduser('~'), '.mxnet'))


class MNIST(_DownloadedDataset):
    """Reference datasets.py:MNIST (idx-format files)."""

    def __init__(self, root=None, train=True, transform=None):
        self._train = train
        root = root or os.path.join(_data_home(), 'datasets', 'mnist')
        self._train_data = ('train-images-idx3-ubyte.gz',)
        self._train_label = ('train-labels-idx1-ubyte.gz',)
        self._test_data = ('t10k-images-idx3-ubyte.gz',)
        self._test_label = ('t10k-labels-idx1-ubyte.gz',)
        super().__init__(root, transform)

    def _read_idx(self, path):
        opener = gzip.open if path.endswith('.gz') else open
        if not os.path.exists(path) and path.endswith('.gz') and \
                os.path.exists(path[:-3]):
            path, opener = path[:-3], open
        with opener(path, 'rb') as f:
            _, _, ndim = struct.unpack('>HBB', f.read(4))
            dims = struct.unpack('>' + 'I' * ndim, f.read(4 * ndim))
            return _np.frombuffer(f.read(), dtype=_np.uint8).reshape(dims)

    def _get_data(self):
        data_file = (self._train_data if self._train else self._test_data)[0]
        label_file = (self._train_label if self._train
                      else self._test_label)[0]
        data = self._read_idx(os.path.join(self._root, data_file))
        label = self._read_idx(os.path.join(self._root, label_file))
        self._data = array(data[..., None], ctx=cpu())
        self._label = label.astype(_np.int32)


class FashionMNIST(MNIST):
    def __init__(self, root=None, train=True, transform=None):
        root = root or os.path.join(_data_home(), 'datasets', 'fashion-mnist')
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """Reference datasets.py:CIFAR10 (python pickle batches)."""

    def __init__(self, root=None, train=True, transform=None):
        self._train = train
        root = root or os.path.join(_data_home(), 'datasets', 'cifar10')
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, 'rb') as f:
            batch = pickle.load(f, encoding='bytes')
        data = batch[b'data'].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        label = _np.array(batch.get(b'labels', batch.get(b'fine_labels')))
        return data, label

    def _get_data(self):
        base = os.path.join(self._root, 'cifar-10-batches-py')
        if not os.path.isdir(base):
            tar = os.path.join(self._root, 'cifar-10-python.tar.gz')
            if os.path.exists(tar):
                with tarfile.open(tar) as t:
                    t.extractall(self._root)
        files = [f'data_batch_{i}' for i in range(1, 6)] if self._train \
            else ['test_batch']
        datas, labels = [], []
        for fn in files:
            d, l = self._read_batch(os.path.join(base, fn))
            datas.append(d)
            labels.append(l)
        self._data = array(_np.concatenate(datas), ctx=cpu())
        self._label = _np.concatenate(labels).astype(_np.int32)


class CIFAR100(CIFAR10):
    def __init__(self, root=None, fine_label=False, train=True,
                 transform=None):
        self._fine = fine_label
        root = root or os.path.join(_data_home(), 'datasets', 'cifar100')
        CIFAR10.__init__(self, root, train, transform)

    def _get_data(self):
        base = os.path.join(self._root, 'cifar-100-python')
        files = ['train'] if self._train else ['test']
        datas, labels = [], []
        for fn in files:
            d, l = self._read_batch(os.path.join(base, fn))
            datas.append(d)
            labels.append(l)
        self._data = array(_np.concatenate(datas), ctx=cpu())
        self._label = _np.concatenate(labels).astype(_np.int32)


def _image_pending(name):
    raise NotImplementedError(
        f'{name} decodes images through image and recordio, which are not '
        f'ported yet (ROADMAP A11)')


class ImageRecordDataset(RecordFileDataset):
    """Images and labels from a RecordIO pack (reference
    datasets.py:ImageRecordDataset). Not ported yet (ROADMAP A11)."""

    def __init__(self, filename, flag=1, transform=None):
        _image_pending('ImageRecordDataset')


class ImageFolderDataset(Dataset):
    """A class-per-subfolder layout of image files (reference
    datasets.py:ImageFolderDataset). Not ported yet (ROADMAP A11)."""

    def __init__(self, root, flag=1, transform=None):
        _image_pending('ImageFolderDataset')


class ImageListDataset(Dataset):
    """Images named by a ``.lst`` file or a list (reference
    datasets.py:ImageListDataset). Not ported yet (ROADMAP A11)."""

    def __init__(self, root='.', imglist=None, flag=1):
        _image_pending('ImageListDataset')
