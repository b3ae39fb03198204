"""Contrib samplers (reference
``python/mxnet/gluon/contrib/data/sampler.py``)."""

from ...data.sampler import Sampler

__all__ = ['IntervalSampler']


class IntervalSampler(Sampler):
    """Sample i, i+interval, i+2*interval, ... then roll to i+1
    (reference IntervalSampler — truncated-BPTT batch layout)."""

    def __init__(self, length, interval, rollover=True):
        if interval > length:
            raise ValueError(
                f'interval {interval} must be <= length {length}')
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            yield from range(i, self._length, self._interval)

    def __len__(self):
        return self._length if self._rollover else \
            len(range(0, self._length, self._interval))
