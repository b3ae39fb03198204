"""``mx.io``: the DataIter interface (counterpart of
``mxnet_tpu/io/__init__.py``, reference python/mxnet/io/io.py and the C++
iterators of src/io/).

``NDArrayIter`` batches in-memory arrays onto the current context;
``PrefetchingIter`` runs its iterators on a worker thread up to ``depth``
batches ahead, and with a card as ``ctx`` stages each batch through
pinned host memory and copies it on a stream of its own, so that the copy
overlaps the consumer's work. ``CSVIter``, ``LibSVMIter`` and
``MNISTIter`` parse local files in Python (the JAX package's native
parsers are ROADMAP A11, as are ``ThreadedRecordIter`` and
``ImageRecordIter``, which need ``recordio`` and ``image``).
"""

import collections
import threading

import numpy as _np
import torch

from ..analysis import race as _race
from ..context import Context, cpu, current_context
from ..ndarray.ndarray import NDArray, array
from .. import _dtypes

DataDesc = collections.namedtuple('DataDesc', ['name', 'shape', 'dtype',
                                               'layout'])
DataDesc.__new__.__defaults__ = (_np.float32, 'NCHW')


class DataBatch:
    """One batch (reference io.py:DataBatch)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Base iterator (reference io.py:DataIter; C++ IIterator<DataBatch>
    include/mxnet/io.h:43)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference io.py:NDArrayIter)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle='pad', data_name='data',
                 label_name='softmax_label'):
        super().__init__(batch_size)
        self.data = self._init_data(data, data_name)
        self.label = self._init_data(label, label_name, allow_empty=True)
        self.num_data = self.data[0][1].shape[0] if self.data else 0
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        if last_batch_handle == 'discard':
            # reference NDArrayIter truncates the epoch to whole batches
            self.num_data -= self.num_data % batch_size
        self.cursor = -batch_size
        self.idx = _np.arange(self.num_data)
        if shuffle:
            _np.random.shuffle(self.idx)

    @staticmethod
    def _init_data(data, default_name, allow_empty=False):
        if data is None:
            assert allow_empty
            return []
        if isinstance(data, (NDArray, _np.ndarray)):
            data = [(default_name, data)]
        elif isinstance(data, (list, tuple)):
            data = [(f'{default_name}_{i}' if i else default_name, d)
                    for i, d in enumerate(data)]
        elif isinstance(data, dict):
            data = list(data.items())
        out = []
        for name, arr in data:
            if isinstance(arr, NDArray):
                arr = arr.asnumpy()
            out.append((name, _np.asarray(arr)))
        return out

    @property
    def provide_data(self):
        return [DataDesc(name, (self.batch_size,) + arr.shape[1:], arr.dtype)
                for name, arr in self.data]

    @property
    def provide_label(self):
        return [DataDesc(name, (self.batch_size,) + arr.shape[1:], arr.dtype)
                for name, arr in self.label]

    def reset(self):
        if self.last_batch_handle == 'roll_over' and \
                0 < self.num_data - self.cursor < self.batch_size:
            # remainder rolls into the next epoch's first batch (reference
            # io.py reset; the carried tail keeps its old positions, so
            # reshuffling is skipped for the carry epoch)
            # leftover L unseen samples: after iter_next's += batch_size the
            # window starts at -L, wrapping the carried tail
            self.cursor = -self.batch_size - (self.num_data - self.cursor)
        else:
            self.cursor = -self.batch_size
            if self.shuffle:
                _np.random.shuffle(self.idx)

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle in ('roll_over', 'discard'):
            return self.cursor + self.batch_size <= self.num_data or \
                (self.cursor < 0)
        return self.cursor < self.num_data

    def _take(self, arrays):
        end = self.cursor + self.batch_size
        out = []
        for _, arr in arrays:
            if self.cursor < 0:          # roll_over carry: wrap the tail
                chunk = _np.concatenate(
                    [arr[self.idx[self.cursor:]], arr[self.idx[:end]]],
                    axis=0)
            else:
                chunk = arr[self.idx[self.cursor:min(end, self.num_data)]]
                if end > self.num_data and self.last_batch_handle == 'pad':
                    pad = end - self.num_data
                    chunk = _np.concatenate(
                        [chunk, arr[self.idx[:pad]]], axis=0)
            out.append(array(chunk))
        return out

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        end = self.cursor + self.batch_size
        if self.last_batch_handle == 'pad' and end > self.num_data:
            return end - self.num_data
        return 0


class ResizeIter(DataIter):
    """Resize the epoch length of an iterator (reference io.py:ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Background prefetch over one or more iterators (reference
    io.py:PrefetchingIter; C++ PrefetcherIter src/io/iter_prefetcher.h). A
    worker thread stays up to ``depth`` batches ahead.

    ``ctx``/``dtype``: when given, the worker casts each batch's data to
    ``dtype`` and places data and label on ``ctx`` before queuing it. On a
    card the sub-iterators run under ``cpu()``, each host batch is copied
    into pinned memory and sent with a non-blocking copy on the worker's
    own stream, and the consumer's stream waits for that copy (an event)
    before it reads the batch, whose tensors are then marked as used on
    the consumer's stream (``record_stream``), so that the allocator does
    not hand their memory out while the consumer still reads it. Without
    ``ctx`` the sub-iterators run under the context that was current when
    the iterator was built."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 ctx=None, dtype=None, depth=2):
        self.iters = iters if isinstance(iters, list) else [iters]
        super().__init__(self.iters[0].batch_size)
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._ctx = None if ctx is None else Context(ctx)
        self._dtype = dtype
        self._depth = max(int(depth), 1)
        dev = None if ctx is None else self._ctx.to_torch()
        self._cuda = dev if dev is not None and dev.type == 'cuda' else None
        self._home = cpu() if self._cuda is not None else current_context()
        self._queue = None
        self._stop = None
        self._thread = None
        self._done = False
        self._start()

    def _place(self, batch, stream):
        """Cast and place one batch inside the worker thread; on a card,
        the copies are issued on ``stream``."""
        if self._ctx is None and self._dtype is None:
            return batch

        def conv(nd, cast):
            t = nd._data
            if cast and self._dtype is not None:
                t = t.to(_dtypes.to_torch(self._dtype))
            if self._cuda is not None and t.device.type == 'cpu':
                with torch.cuda.stream(stream):
                    t = t.pin_memory().to(self._cuda, non_blocking=True)
                return NDArray(t)
            nd = NDArray(t)
            return nd if self._ctx is None else nd.as_in_context(self._ctx)

        data = [conv(d, True) for d in (batch.data or [])]
        label = [conv(lb, False) for lb in (batch.label or [])]
        return DataBatch(data=data, label=label, pad=batch.pad,
                         index=batch.index)

    @staticmethod
    def _merge(batches):
        """Concatenate the sub-iterators' data/label lists into one batch
        (reference PrefetchingIter semantics for a list of iters)."""
        if len(batches) == 1:
            return batches[0]
        data, label = [], []
        for b in batches:
            data.extend(b.data or [])
            label.extend(b.label or [])
        first = batches[0]
        return DataBatch(data=data, label=label, pad=first.pad,
                         index=first.index)

    def _produce(self, q, stop):
        """The worker's loop: ``(batch, event)`` pairs into ``q``, then
        ``None`` at the end or the exception that ended it."""
        stream = None
        if self._cuda is not None:
            torch.cuda.set_device(self._cuda)
            stream = torch.cuda.Stream(self._cuda)
        fail = None
        try:
            with self._home:
                while not stop.is_set():
                    try:
                        batches = [next(it) for it in self.iters]
                    except StopIteration:
                        break
                    batch = self._place(self._merge(batches), stream)
                    event = None if stream is None else \
                        stream.record_event()
                    # happens-before edge for the race checker: the
                    # consumer's handoff_acquire in __next__ orders its
                    # reads after everything this thread did to the batch
                    _race.handoff_release(q)
                    q.put((batch, event))
        except Exception as e:      # noqa: BLE001 - re-raised by __next__
            fail = e
        finally:
            # a worker failure must surface at the consumer's next(), not
            # masquerade as a clean end of epoch
            if stop.is_set():
                try:                    # reset drains the old queue;
                    q.put_nowait(fail)  # never block a dying worker
                except Exception:       # noqa: BLE001
                    pass
            else:
                q.put(fail)

    def _start(self):
        import queue
        self._queue = queue.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(
            target=self._produce, args=(self._queue, self._stop),
            daemon=True)
        self._thread.start()

    def close(self):
        """Stop the worker and drop queued batches (and the device
        buffers they hold). Safe to call more than once."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except Exception:           # noqa: BLE001
                pass
            self._thread.join(timeout=0.01)
        self._done = True

    def reset(self):
        # signal, drain the old queue until its producer exits, then build
        # a fresh queue and thread: stale batches never leak across epochs
        self.close()
        for it in self.iters:
            it.reset()
        self._start()

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._queue.get()
        _race.handoff_acquire(self._queue)
        if item is None:
            self._done = True           # exhausted: further next() raises
            raise StopIteration
        if isinstance(item, Exception):
            self._done = True           # the worker died: re-raise here
            raise item
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self._cuda)
            consumer.wait_event(event)
            for nd in list(batch.data or []) + list(batch.label or []):
                if nd._data.device == self._cuda:
                    nd._data.record_stream(consumer)
        return batch

    next = __next__

    def iter_next(self):
        try:
            self._batch = self.__next__()
            return True
        except StopIteration:
            return False


def CSVIter(data_csv, data_shape, label_csv=None, label_shape=(1,),
            batch_size=1, **kwargs):
    """Reference src/io/iter_csv.cc: comma-separated rows, parsed with
    numpy, into an :class:`NDArrayIter`."""

    def load(path, shape):
        parsed = _np.loadtxt(path, delimiter=',', dtype=_np.float32,
                             ndmin=2)
        return parsed.reshape((-1,) + tuple(shape))

    data = load(data_csv, data_shape)
    label = load(label_csv, label_shape) if label_csv is not None else None
    return NDArrayIter(data, label, batch_size=batch_size, **kwargs)


def LibSVMIter(data_libsvm, data_shape, label_libsvm=None,
               label_shape=(1,), batch_size=1, **kwargs):
    """Reference src/io/iter_libsvm.cc: ``label idx:val`` lines into dense
    batches (a dense matrix on the device), parsed in Python."""

    def load_label_file():
        # separate label file: plain values per line (reference
        # iter_libsvm.cc label_libsvm layout), no idx:val tokens
        with open(label_libsvm) as f:
            lab = _np.asarray(
                [[float(v) for v in line.replace(',', ' ').split()]
                 for line in f if line.strip()], _np.float32)
        return lab.reshape((-1,) + tuple(label_shape))

    def parse(path, width):
        rows, labels = [], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append([float(v) for v in parts[0].split(',')])
                row = _np.zeros(width, _np.float32)
                for tok in parts[1:]:
                    idx, val = tok.split(':')
                    row[int(idx)] = float(val)
                rows.append(row)
        return _np.stack(rows), _np.asarray(labels, _np.float32)

    width = int(_np.prod(data_shape))
    data, inline_labels = parse(data_libsvm, width)
    data = data.reshape((-1,) + tuple(data_shape))
    if label_libsvm is not None:
        label = load_label_file()
    else:
        label = inline_labels.reshape((-1,) + tuple(label_shape))
    return NDArrayIter(data, label, batch_size=batch_size, **kwargs)


def MNISTIter(image, label, batch_size=1, shuffle=True, flat=False,
              silent=False, seed=0, **kwargs):
    """Reference src/io/iter_mnist.cc — reads idx-format MNIST files."""
    import gzip
    import struct

    def read_idx(path):
        opener = gzip.open if path.endswith('.gz') else open
        with opener(path, 'rb') as f:
            magic = struct.unpack('>HBB', f.read(4))
            ndim = magic[2]
            dims = struct.unpack('>' + 'I' * ndim, f.read(4 * ndim))
            return _np.frombuffer(f.read(), dtype=_np.uint8).reshape(dims)

    images = read_idx(image).astype(_np.float32) / 255.0
    labels = read_idx(label).astype(_np.float32)
    if flat:
        images = images.reshape(images.shape[0], -1)
    else:
        images = images[:, None, :, :]
    return NDArrayIter(images, labels, batch_size=batch_size,
                       shuffle=shuffle, **kwargs)


def _record_pending(name):
    raise NotImplementedError(
        f'{name} reads RecordIO through recordio and image, which are not '
        f'ported yet (ROADMAP A11)')


class ThreadedRecordIter(DataIter):
    """Batched RecordIO stream with a native background prefetch
    (reference src/io/iter_image_recordio_2.cc). Not ported yet: raises,
    naming ROADMAP A11."""

    def __init__(self, path, batch_size=32, **kwargs):
        _record_pending('ThreadedRecordIter')


class ImageRecordIter(DataIter):
    """Image-record iterator with the native decode and augment pipeline
    (reference src/io/iter_image_recordio_2.cc). Not ported yet: raises,
    naming ROADMAP A11."""

    def __init__(self, path_imgrec, data_shape, batch_size, **kwargs):
        _record_pending('ImageRecordIter')
