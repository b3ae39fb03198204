"""The port's data path (``gluon/data``, ``io``) against the JAX package's,
on the CPU.

The same numpy data through both packages gives the same samples and
batches: datasets and their views, every sampler, ``DataLoader`` in every
``last_batch`` mode with and without workers (forked processes that
build numpy only, and threads), shuffled under the same numpy seed;
``MNIST``, ``FashionMNIST``, ``CIFAR10`` and ``CIFAR100`` read from tiny
idx and pickle files written into ``tmp_path``; the ported vision
transforms under the same seeds; ``NDArrayIter`` in every
``last_batch_handle`` mode across resets; ``ResizeIter``,
``PrefetchingIter`` (with and without a CPU ``ctx`` and ``dtype``),
``CSVIter``, ``LibSVMIter`` and ``MNISTIter``. Every part that needs
``image`` or ``recordio`` raises naming ROADMAP A11.
"""

import gzip
import pickle
import random
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import io as jio
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as jtf
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data.vision import transforms as ttf


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, 'asnumpy') else np.asarray(x)


def _equal(got, want):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _arrays(n=10):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            np.arange(n, dtype=np.float32))


# ------------------------------------------------------------------ datasets
def test_dataset_views_equal_the_jax_ones():
    x, y = _arrays()
    for data in (jdata, tdata):
        ds = data.ArrayDataset(x, y)
        views = [ds, ds.shard(3, 1), ds.take(4),
                 ds.filter(lambda s: s[1] % 2 == 0),
                 ds.transform(lambda a, b: (a * 2, b + 1)),
                 ds.transform(lambda a, b: (a - 1, b), lazy=False),
                 ds.transform_first(lambda a: a + 3),
                 data.SimpleDataset(list(range(5))).transform(
                     lambda v: v * v)]
        got = [[_np(v[i]) for i in range(len(v))] for v in views]
        if data is jdata:
            want = got
    _equal(got, want)


@pytest.mark.parametrize('make', [
    lambda d: d.SequentialSampler(7, start=2),
    lambda d: d.RandomSampler(9),
    lambda d: d.IntervalSampler(10, 3),
    lambda d: d.IntervalSampler(10, 3, rollover=False),
    lambda d: d.SplitSampler(10, num_parts=3, part_index=1),
    lambda d: d.SplitSampler(10, 2, 0, shuffle=False),
    lambda d: d.FilterSampler(lambda v: v > 2, list(range(6))),
    lambda d: d.BatchSampler(d.SequentialSampler(10), 3, 'keep'),
    lambda d: d.BatchSampler(d.SequentialSampler(10), 3, 'discard'),
], ids=['sequential', 'random', 'interval', 'interval-no-rollover', 'split',
        'split-ordered', 'filter', 'batch-keep', 'batch-discard'])
def test_sampler_equals_the_jax_sampler(make):
    out = []
    for data in (jdata, tdata):
        np.random.seed(3)
        s = make(data)
        out.append((list(s), list(s), len(s)))
    assert out[1] == out[0]


def test_batch_sampler_rollover_carries_the_tail():
    out = []
    for data in (jdata, tdata):
        s = data.BatchSampler(data.SequentialSampler(10), 4, 'rollover')
        out.append([list(s), len(s), list(s)])
    assert out[1] == out[0]


@pytest.mark.parametrize('workers,threads', [(0, False), (2, False),
                                             (2, True)],
                         ids=['no-workers', 'processes', 'threads'])
@pytest.mark.parametrize('last_batch', ['keep', 'discard', 'rollover'])
def test_dataloader_batches_equal_the_jax_loader(workers, threads,
                                                 last_batch):
    x, y = _arrays(11)
    epochs, lengths = [], []
    for mx, data in ((jmx, jdata), (tmx, tdata)):
        np.random.seed(5)
        # the JAX loader always uses threads: it must not fork after JAX
        loader = data.DataLoader(
            data.ArrayDataset(x, y), batch_size=4, shuffle=True,
            last_batch=last_batch, num_workers=workers,
            thread_pool=threads or mx is jmx)
        epochs.append([[_np(b) for b in loader] for _ in range(2)])
        lengths.append(len(loader))
    _equal(epochs[1], epochs[0])
    assert lengths[1] == lengths[0]


def test_dataloader_batches_of_ndarray_samples_land_on_the_context():
    x, _ = _arrays(6)
    got = [b for b in tdata.DataLoader(
        tdata.SimpleDataset([tmx.np.array(r) for r in x]), batch_size=4)]
    assert [b.shape for b in got] == [(4, 3), (2, 3)]
    assert got[0].context == tmx.cpu()
    _equal(got, [x[:4], x[4:]])


def test_dataloader_resumable_restores_its_position():
    x, y = _arrays(10)
    out = []
    for data in (jdata, tdata):
        loader = data.DataLoader(data.ArrayDataset(x, y), batch_size=3,
                                 shuffle=True, last_batch='discard')
        it = loader.resumable(shuffle_seed=7)
        first = [_np(next(it)) for _ in range(4)]
        state = it.state_dict()
        rest = [_np(next(it)) for _ in range(3)]
        again = loader.resumable(shuffle_seed=0, state=state)
        out.append((first, rest, [_np(next(again)) for _ in range(3)],
                    state))
    _equal(out[1][:3], out[0][:3])
    _equal(out[1][1], out[1][2])
    assert out[1][3] == out[0][3]


# ----------------------------------------------------- datasets from files
def _idx(path, arr):
    with gzip.open(path, 'wb') as f:
        f.write(struct.pack('>HBB', 0, 8, arr.ndim))
        f.write(struct.pack('>' + 'I' * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def _mnist_files(root, n=5):
    rng = np.random.default_rng(1)
    root.mkdir(parents=True, exist_ok=True)
    for stem, count in (('train', n), ('t10k', n - 2)):
        _idx(root / f'{stem}-images-idx3-ubyte.gz',
             rng.integers(0, 256, (count, 28, 28)))
        _idx(root / f'{stem}-labels-idx1-ubyte.gz',
             rng.integers(0, 10, (count,)))


def _cifar_files(root, name, files, label_key, n=4):
    rng = np.random.default_rng(2)
    base = root / name
    base.mkdir(parents=True)
    for fn in files:
        batch = {b'data': rng.integers(0, 256, (n, 3072)).astype(np.uint8),
                 label_key: list(rng.integers(0, 10, n))}
        with open(base / fn, 'wb') as f:
            pickle.dump(batch, f)


@pytest.mark.parametrize('name,train', [('MNIST', True), ('MNIST', False),
                                        ('FashionMNIST', True),
                                        ('CIFAR10', True), ('CIFAR10', False),
                                        ('CIFAR100', True)])
def test_vision_dataset_reads_local_files_as_the_jax_one(tmp_path, name,
                                                         train):
    if 'MNIST' in name:
        _mnist_files(tmp_path)
    elif name == 'CIFAR10':
        _cifar_files(tmp_path, 'cifar-10-batches-py',
                     [f'data_batch_{i}' for i in range(1, 6)]
                     + ['test_batch'], b'labels')
    else:
        _cifar_files(tmp_path, 'cifar-100-python', ['train', 'test'],
                     b'fine_labels')
    jds = getattr(jdata.vision, name)(root=str(tmp_path), train=train)
    tds = getattr(tdata.vision, name)(root=str(tmp_path), train=train)
    assert len(tds) == len(jds)
    for i in range(len(jds)):
        _equal(tds[i], jds[i])
    shape = (28, 28, 1) if 'MNIST' in name else (32, 32, 3)
    assert tds[0][0].shape == shape
    assert tds[0][0].context == tmx.cpu()   # host data, fork-safe
    # transformed, through a loader with workers: forked processes for
    # MNIST, threads (whose default context is the card's) for the others
    tds = getattr(tdata.vision, name)(
        root=str(tmp_path), train=train,
        transform=lambda d, lab: (d.astype('float32') / 255, lab))
    batches = list(tdata.DataLoader(tds, batch_size=2, num_workers=2,
                                    thread_pool=name != 'MNIST'))
    np.testing.assert_allclose(
        batches[0][0].asnumpy(),
        np.stack([_np(jds[i][0]) for i in range(2)]) / 255, rtol=1e-6)


# ---------------------------------------------------------------- transforms
def _image(seed=0, shape=(6, 5, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.uint8)


TRANSFORMS = {
    'to_tensor': lambda t: t.ToTensor(),
    'cast': lambda t: t.Cast('float16'),
    'normalize': lambda t: t.Compose([
        t.ToTensor(), t.Normalize((0.4, 0.5, 0.6), (0.2, 0.3, 0.25))]),
    'flip_lr': lambda t: t.RandomFlipLeftRight(),
    'flip_tb': lambda t: t.RandomFlipTopBottom(),
    'brightness': lambda t: t.RandomBrightness(0.3),
    'contrast': lambda t: t.RandomContrast(0.3),
    'saturation': lambda t: t.RandomSaturation(0.3),
    'color_jitter': lambda t: t.RandomColorJitter(0.2, 0.2, 0.2),
    'lighting': lambda t: t.RandomLighting(0.1),
    'random_apply': lambda t: t.RandomApply(
        [t.RandomBrightness(0.5), t.Cast('float32')], p=0.5),
}


@pytest.mark.parametrize('name', list(TRANSFORMS))
def test_transform_equals_the_jax_transform(name):
    outs = []
    for mx, tf in ((jmx, jtf), (tmx, ttf)):
        t = TRANSFORMS[name](tf)
        got = []
        for seed in range(4):
            np.random.seed(seed)
            random.seed(seed)
            got.append(_np(t(mx.np.array(_image(seed), dtype='uint8'))))
        outs.append(got)
    for g, w in zip(*outs[::-1]):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5)


# -------------------------------------------------------------------- io
def _batches(it):
    return [(_np(b.data), _np(b.label), b.pad) for b in it]


@pytest.mark.parametrize('handle', ['pad', 'discard', 'roll_over'])
@pytest.mark.parametrize('shuffle', [False, True], ids=['ordered',
                                                        'shuffled'])
def test_ndarray_iter_equals_the_jax_iter(handle, shuffle):
    x, y = _arrays(10)
    out = []
    for io in (jio, tio):
        np.random.seed(11)
        it = io.NDArrayIter({'a': x, 'b': x * 2}, y, batch_size=4,
                            shuffle=shuffle, last_batch_handle=handle)
        epochs = [_batches(it)]
        for _ in range(2):
            it.reset()
            epochs.append(_batches(it))
        out.append((epochs, it.provide_data, it.provide_label))
    for (g, w) in zip(out[1][0], out[0][0]):
        assert [b[2] for b in g] == [b[2] for b in w]
        _equal([list(b[:2]) for b in g], [list(b[:2]) for b in w])
    assert out[1][1:] == out[0][1:]


def test_resize_iter_equals_the_jax_iter():
    x, y = _arrays(10)
    out = []
    for io in (jio, tio):
        it = io.ResizeIter(io.NDArrayIter(x, y, batch_size=4), 5)
        out.append([_batches(it)])
        it.reset()
        out[-1].append(_batches(it))
    for g, w in zip(out[1], out[0]):
        _equal([list(b[:2]) for b in g], [list(b[:2]) for b in w])


@pytest.mark.parametrize('placed', [False, True], ids=['as-is', 'ctx-dtype'])
def test_prefetching_iter_on_the_cpu_equals_the_jax_iter(placed):
    x, y = _arrays(10)
    out = []
    for mx, io in ((jmx, jio), (tmx, tio)):
        kw = dict(ctx=mx.cpu(), dtype='float16', depth=3) if placed else {}
        it = io.PrefetchingIter([io.NDArrayIter(x, y, batch_size=4),
                                 io.NDArrayIter(x * 3, batch_size=4)], **kw)
        epochs = [_batches(it)]
        with pytest.raises(StopIteration):
            next(it)
        it.reset()
        epochs.append(_batches(it))
        it.close()
        out.append(epochs)
    for g, w in zip(out[1], out[0]):
        _equal([list(b[:2]) for b in g], [list(b[:2]) for b in w])
        assert [b[0][0].dtype for b in g] == [b[0][0].dtype for b in w]


def test_prefetching_iter_surfaces_a_worker_failure():
    class Broken(tio.DataIter):
        def __next__(self):
            raise RuntimeError('bad batch')

    it = tio.PrefetchingIter(Broken(2))
    with pytest.raises(RuntimeError, match='bad batch'):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_text_iters_equal_the_jax_ones(tmp_path):
    rng = np.random.default_rng(4)
    data = rng.standard_normal((7, 6)).round(3)
    np.savetxt(tmp_path / 'd.csv', data, delimiter=',')
    np.savetxt(tmp_path / 'l.csv', np.arange(7.0), delimiter=',')
    with open(tmp_path / 'd.libsvm', 'w') as f:
        for i in range(5):
            f.write(f'{i % 2} 0:{i + 0.5} {i % 4 + 1}:{-i}\n')
    _mnist_files(tmp_path)
    kw = dict(batch_size=3)
    out = []
    for io in (jio, tio):
        np.random.seed(2)
        out.append([_batches(it) for it in (
            io.CSVIter(str(tmp_path / 'd.csv'), (2, 3),
                       label_csv=str(tmp_path / 'l.csv'), **kw),
            io.CSVIter(str(tmp_path / 'd.csv'), (6,), **kw),
            io.LibSVMIter(str(tmp_path / 'd.libsvm'), (5,), **kw),
            io.MNISTIter(str(tmp_path / 'train-images-idx3-ubyte.gz'),
                         str(tmp_path / 'train-labels-idx1-ubyte.gz'),
                         batch_size=2, shuffle=True, flat=True))])
    for g, w in zip(out[1], out[0]):
        _equal([list(b[:2]) for b in g], [list(b[:2]) for b in w])


# ------------------------------------------------------------- A11 stubs
@pytest.mark.parametrize('make', [
    lambda: tdata.RecordFileDataset('x.rec'),
    lambda: tdata.vision.ImageRecordDataset('x.rec'),
    lambda: tdata.vision.ImageFolderDataset('.'),
    lambda: tdata.vision.ImageListDataset('.', [(0, 'a.jpg')]),
    lambda: ttf.Resize(8),
    lambda: ttf.CenterCrop(8),
    lambda: ttf.RandomResizedCrop(8),
    lambda: tio.ThreadedRecordIter('x.rec', batch_size=2),
    lambda: tio.ImageRecordIter('x.rec', (3, 8, 8), 2),
], ids=['RecordFileDataset', 'ImageRecordDataset', 'ImageFolderDataset',
        'ImageListDataset', 'Resize', 'CenterCrop', 'RandomResizedCrop',
        'ThreadedRecordIter', 'ImageRecordIter'])
def test_parts_that_need_image_or_recordio_raise_naming_a11(make):
    with pytest.raises(NotImplementedError, match='A11'):
        make()
