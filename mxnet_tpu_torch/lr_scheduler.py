"""Learning-rate schedulers (reference python/mxnet/lr_scheduler.py).

A copy of ``mxnet_tpu/lr_scheduler.py``, which uses no JAX."""

import math

from .base import register, registry_create


class LRScheduler:
    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode='linear'):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == 'linear':
            inc = (self.warmup_final_lr - self.warmup_begin_lr) * \
                num_update / self.warmup_steps
            return self.warmup_begin_lr + inc
        if self.warmup_mode == 'constant':
            return self.warmup_begin_lr
        raise ValueError(self.warmup_mode)

    def __call__(self, num_update):
        raise NotImplementedError


register = register(LRScheduler)


def create(name, **kwargs):
    return registry_create(LRScheduler, name, **kwargs)


@register
class FactorScheduler(LRScheduler):
    """lr *= factor every `step` updates (reference FactorScheduler)."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 **kw):
        super().__init__(base_lr, **kw)
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr = max(self.base_lr * self.factor,
                               self.stop_factor_lr)
        return self.base_lr


@register
class MultiFactorScheduler(LRScheduler):
    def __init__(self, step, factor=1, base_lr=0.01, **kw):
        super().__init__(base_lr, **kw)
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                return self.base_lr
        return self.base_lr


@register
class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0, **kw):
        super().__init__(base_lr, **kw)
        self.power = pwr
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = self.final_lr + \
                (self.base_lr_orig - self.final_lr) * \
                pow(1 - (num_update - self.warmup_steps) / self.max_steps,
                    self.power)
        return self.base_lr


@register
class CosineScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, final_lr=0, **kw):
        super().__init__(base_lr, **kw)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = self.final_lr + \
                (self.base_lr_orig - self.final_lr) * \
                (1 + math.cos(math.pi * (num_update - self.warmup_steps)
                              / self.max_steps)) / 2
        return self.base_lr
