"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``,
reference python/mxnet/gluon/data/dataloader.py).

``num_workers=0`` batches in the caller. With ``num_workers > 0`` a pool
of forked processes (or threads, ``thread_pool=True``) reads and batches
samples into plain numpy arrays, and the caller makes the NDArrays: the
children touch no CUDA, which a process forked after CUDA was initialized
must not. A batch lands on the current context either way.
"""

import multiprocessing
import numpy as _np
import torch

from ...context import current_context
from ...ndarray.ndarray import NDArray, array
from .sampler import BatchSampler, RandomSampler, SequentialSampler


def default_batchify_fn(data):
    """Reference dataloader.py:default_batchify_fn: samples stacked into
    one NDArray (one per field of tuple samples) on the current
    context."""
    if isinstance(data[0], NDArray):
        return NDArray(torch.stack([d._data for d in data]).to(
            current_context().to_torch()))
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    data = _np.asarray(data)
    return array(data)


def _as_host(data):
    if isinstance(data, NDArray):
        return data.asnumpy()
    if isinstance(data, (list, tuple)):
        return type(data)(_as_host(d) for d in data)
    return data


# per-loader worker state, keyed so several thread-pool loaders in one
# process don't clobber each other (fork pools inherit a one-entry dict)
_worker_state = {}


def _default_worker_batchify(batch):
    if isinstance(batch[0], tuple):
        cols = list(zip(*batch))
        return tuple(_np.asarray([_as_host(c) for c in col]) for col in cols)
    return _np.asarray([_as_host(b) for b in batch])


def _worker_init(key, dataset, batchify_fn):
    _worker_state[key] = (dataset, batchify_fn)


def _worker_fn(key, samples):
    """Fetch + batchify host-side in the worker. A custom batchify_fn
    runs here too (it must be picklable for process pools and should
    return host arrays)."""
    dataset, batchify_fn = _worker_state[key]
    batch = [dataset[i] for i in samples]
    if batchify_fn is None:
        return _default_worker_batchify(batch)
    return batchify_fn(batch)


class DataLoader:
    """Reference dataloader.py:DataLoader."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=False, timeout=120):
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._thread_pool = thread_pool
        self._timeout = timeout
        # remembered for resumable(): the checkpointable iterator rebuilds
        # the per-epoch plan itself from (batch_size, shuffle, last_batch)
        self._batch_size = batch_size
        self._shuffle = bool(shuffle)
        self._last_batch = last_batch or 'keep'
        self._resumable_ok = (batch_sampler is None and sampler is None
                              and (last_batch or 'keep') in
                              ('keep', 'discard'))
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError('batch_size must be specified unless '
                                 'batch_sampler is specified')
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError('shuffle must not be specified if sampler '
                                 'is specified')
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or 'keep')
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError('batch_size, shuffle, sampler and last_batch '
                             'must not be specified if batch_sampler is '
                             'specified.')
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._prefetch = max(0, prefetch or 2 * self._num_workers)
        self._pool = None
        self._worker_key = id(self)
        if self._num_workers > 0:
            # workers run the user's batchify_fn (or the host-array default);
            # pass None for the default so unpicklable bound defaults never
            # cross the fork pipe
            worker_batchify = batchify_fn
            if thread_pool:
                from multiprocessing.pool import ThreadPool
                self._pool = ThreadPool(
                    self._num_workers, initializer=_worker_init,
                    initargs=(self._worker_key, dataset, worker_batchify))
            else:
                ctx = multiprocessing.get_context('fork')
                self._pool = ctx.Pool(
                    self._num_workers, initializer=_worker_init,
                    initargs=(self._worker_key, dataset, worker_batchify))

    def __iter__(self):
        if self._pool is None:
            for batch in self._batch_sampler:
                yield self._batchify_fn([self._dataset[i] for i in batch])
            return
        # pipelined pool: keep `prefetch` batches in flight
        results = []
        it = iter(self._batch_sampler)
        try:
            for _ in range(self._prefetch):
                results.append(self._pool.apply_async(
                    _worker_fn, (self._worker_key, next(it))))
        except StopIteration:
            pass
        while results:
            res = results.pop(0)
            try:
                results.append(self._pool.apply_async(
                    _worker_fn, (self._worker_key, next(it))))
            except StopIteration:
                pass
            raw = res.get(self._timeout)
            if isinstance(raw, tuple):
                yield [array(r) for r in raw]
            elif isinstance(raw, _np.ndarray):
                yield array(raw)
            else:
                yield raw          # custom batchify output passes through

    def __len__(self):
        return len(self._batch_sampler)

    def resumable(self, shuffle_seed=0, state=None):
        """Checkpointable iterator over this loader's dataset.

        Returns a :class:`_ResumableIter` — an infinite epoch-rolling
        iterator whose position is a tiny state dict
        ``{'epoch', 'batch_index', 'shuffle_seed'}`` (see
        ``state_dict()`` / ``load_state_dict()``). Shuffle order is a
        pure function of ``(shuffle_seed, epoch)``, so restoring the
        state reproduces the exact batch sequence, and the skip to the
        saved position is index arithmetic — no dataset reads for the
        replayed batches.

        Only the default-sampler configuration is resumable (custom
        ``sampler``/``batch_sampler`` objects hold opaque state;
        ``last_batch='rollover'`` carries leftovers across epochs).
        """
        if not self._resumable_ok:
            raise ValueError(
                'resumable() requires the default sampler configuration '
                "(no custom sampler/batch_sampler, last_batch in "
                "('keep', 'discard'))")
        it = _ResumableIter(self._dataset, self._batch_size,
                            self._shuffle, self._last_batch,
                            self._batchify_fn, shuffle_seed)
        if it.batches_per_epoch() == 0:
            raise ValueError(
                f'resumable() would yield no batches: '
                f'len(dataset)={len(self._dataset)} with '
                f'batch_size={self._batch_size} and '
                f'last_batch={self._last_batch!r}')
        if state is not None:
            it.load_state_dict(state)
        return it

    def __del__(self):
        if self._pool is not None:
            self._pool.terminate()


class _ResumableIter:
    """Infinite batch iterator with an explicit, restorable position.

    The epoch-``e`` batch plan is ``default_rng([seed, e])``'s
    permutation (or ``arange`` unshuffled) chunked by ``batch_size`` —
    derived from nothing but ``(seed, e)``, never from the global numpy
    stream, so data-augmentation RNG and shuffle order cannot perturb
    each other across a resume.
    """

    def __init__(self, dataset, batch_size, shuffle, last_batch,
                 batchify_fn, shuffle_seed):
        self._dataset = dataset
        self._batch_size = int(batch_size)
        self._shuffle = shuffle
        self._last_batch = last_batch
        self._batchify_fn = batchify_fn
        self._seed = int(shuffle_seed)
        self._epoch = 0
        self._batch_index = 0
        self._plan = None          # lazily built per epoch

    # ------------------------------------------------------------- position
    def state_dict(self):
        return {'epoch': self._epoch, 'batch_index': self._batch_index,
                'shuffle_seed': self._seed}

    def load_state_dict(self, state):
        self._seed = int(state['shuffle_seed'])
        self._epoch = int(state['epoch'])
        self._batch_index = int(state['batch_index'])
        self._plan = None
        return self

    # ------------------------------------------------------------- iteration
    def _epoch_plan(self):
        n = len(self._dataset)
        if self._shuffle:
            order = _np.random.default_rng(
                [self._seed, self._epoch]).permutation(n)
        else:
            order = _np.arange(n)
        bs = self._batch_size
        stop = n - n % bs if self._last_batch == 'discard' else n
        return [order[i:i + bs] for i in range(0, stop, bs)]

    def batches_per_epoch(self):
        n = len(self._dataset)
        if self._last_batch == 'discard':
            return n // self._batch_size
        return -(-n // self._batch_size)

    def __iter__(self):
        return self

    def __next__(self):
        if self.batches_per_epoch() == 0:
            raise ValueError(
                f'resumable iterator yields no batches: '
                f'len(dataset)={len(self._dataset)} with '
                f'batch_size={self._batch_size} and '
                f'last_batch={self._last_batch!r}')
        if self._plan is None:
            self._plan = self._epoch_plan()
        while self._batch_index >= len(self._plan):
            self._epoch += 1
            self._batch_index = 0
            self._plan = self._epoch_plan()
        batch = self._plan[self._batch_index]
        self._batch_index += 1
        return self._batchify_fn([self._dataset[int(i)] for i in batch])
