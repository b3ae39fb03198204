"""Samplers (counterpart of ``mxnet_tpu/gluon/data/sampler.py``, reference
python/mxnet/gluon/data/sampler.py); random ones draw from numpy's global
generator, as the reference's do."""

import numpy as _np


class Sampler:
    def __len__(self):
        raise NotImplementedError

    def __iter__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        indices = _np.arange(self._length)
        _np.random.shuffle(indices)
        return iter(indices.tolist())

    def __len__(self):
        return self._length


class IndexSampler(Sampler):
    def __init__(self, indices):
        self._indices = indices

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class FilterSampler(Sampler):
    def __init__(self, fn, dataset):
        self._indices = [i for i in range(len(dataset)) if fn(dataset[i])]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class IntervalSampler(Sampler):
    """Reference sampler.py:IntervalSampler."""

    def __init__(self, length, interval, rollover=True):
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            yield from range(i, self._length, self._interval)

    def __len__(self):
        return self._length


class SplitSampler(Sampler):
    """Shard + shuffle sampler for distributed data loading (reference
    example/distributed_training/cifar10_dist.py:59 — the canonical
    per-worker input sharding pattern)."""

    def __init__(self, length, num_parts=1, part_index=0, shuffle=True):
        self.part_len = length // num_parts
        self.start = self.part_len * part_index
        self.end = self.start + self.part_len
        self.shuffle = shuffle

    def __iter__(self):
        indices = _np.arange(self.start, self.end)
        if self.shuffle:
            _np.random.shuffle(indices)
        return iter(indices.tolist())

    def __len__(self):
        return self.part_len


class BatchSampler(Sampler):
    """Reference sampler.py:BatchSampler."""

    def __init__(self, sampler, batch_size, last_batch='keep'):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == 'keep':
                yield batch
            elif self._last_batch == 'discard':
                return
            elif self._last_batch == 'rollover':
                self._prev = batch
            else:
                raise ValueError(f'last_batch must be one of keep/discard/'
                                 f'rollover, got {self._last_batch}')

    def __len__(self):
        if self._last_batch == 'keep':
            return (len(self._sampler) + self._batch_size - 1) // \
                self._batch_size
        if self._last_batch == 'discard':
            return len(self._sampler) // self._batch_size
        if self._last_batch == 'rollover':
            return (len(self._prev) + len(self._sampler)) // self._batch_size
        raise ValueError(f'invalid last_batch {self._last_batch}')
