"""Estimator event handlers (reference
python/mxnet/gluon/contrib/estimator/event_handler.py — epoch/batch events,
checkpointing, early stopping)."""

import logging
import os
import time

import numpy as _np


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop on max epoch/batch (reference event_handler.py:StoppingHandler)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.max_epoch = self.max_epoch or estimator.max_epoch
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch == self.max_batch:
            self.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch == self.max_epoch:
            self.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    """Update training metrics per batch."""

    def __init__(self, metrics, priority=-1000):
        self.metrics = metrics or []
        self.priority = priority

    def epoch_begin(self, estimator, *args, **kwargs):
        for metric in self.metrics:
            metric.reset()

    def batch_end(self, estimator, *args, **kwargs):
        pred = kwargs.get('pred')
        label = kwargs.get('label')
        loss = kwargs.get('loss')
        from ....metric import Loss as LossMetric
        for metric in self.metrics:
            if isinstance(metric, LossMetric):
                metric.update(0, loss)
            else:
                metric.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    def __init__(self, val_data, eval_fn, epoch_period=1, batch_period=None,
                 priority=-1000):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.priority = priority
        self.current_batch = 0
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self.eval_fn(val_data=self.val_data)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self.eval_fn(val_data=self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchBegin,
                     BatchEnd):
    """Reference event_handler.py:LoggingHandler."""

    def __init__(self, log_interval='epoch', metrics=None, priority=_np.inf):
        self.log_interval = log_interval
        self.metrics = metrics or []
        self.priority = priority
        self.batch_index = 0
        self.current_epoch = 0
        self.processed_samples = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        logging.info('Training begin')

    def train_end(self, estimator, *args, **kwargs):
        train_time = time.time() - self.train_start
        logging.info('Train finished using total %ds', train_time)

    def epoch_begin(self, estimator, *args, **kwargs):
        if self.log_interval is not None:
            self.epoch_start = time.time()

    def epoch_end(self, estimator, *args, **kwargs):
        if self.log_interval is not None:
            msg = f'[Epoch {self.current_epoch}] finished in ' \
                f'{time.time() - self.epoch_start:.3f}s: '
            for metric in self.metrics:
                name, value = metric.get()
                msg += f'{name}: {value:.4f}, '
            logging.info(msg.rstrip(', '))
        self.current_epoch += 1
        self.batch_index = 0

    def batch_end(self, estimator, *args, **kwargs):
        if isinstance(self.log_interval, int):
            batch_size = kwargs.get('batch_size', 0)
            self.processed_samples += batch_size
            if self.batch_index % self.log_interval == 0:
                msg = f'[Epoch {self.current_epoch}][Batch ' \
                    f'{self.batch_index}] '
                for metric in self.metrics:
                    name, value = metric.get()
                    msg += f'{name}: {value:.4f}, '
                logging.info(msg.rstrip(', '))
        self.batch_index += 1


def _resolve_mode(mode, monitor):
    """'auto' infers the comparison direction from the monitor's name
    (reference event_handler.py: acc/f1/topk-style metrics maximize)."""
    if mode != 'auto':
        return mode
    name = getattr(monitor, 'name', str(monitor) if monitor else '') or ''
    name = name.lower()
    maximize = any(t in name for t in
                   ('acc', 'f1', 'mcc', 'auc', 'map', 'topk', 'pearson'))
    return 'max' if maximize else 'min'


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Periodic / best-k checkpointing (reference
    event_handler.py:CheckpointHandler)."""

    def __init__(self, model_dir, model_prefix='model', monitor=None,
                 verbose=0, save_best=False, mode='auto', epoch_period=1,
                 batch_period=None, max_checkpoints=5,
                 resume_from_checkpoint=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.save_best = save_best
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_epoch = 0
        self.current_batch = 0
        self.mode = _resolve_mode(mode, monitor)
        self.best = -_np.inf if self.mode == 'max' else _np.inf
        os.makedirs(model_dir, exist_ok=True)

    def train_begin(self, estimator, *args, **kwargs):
        self.current_epoch = 0
        self.current_batch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self._save(estimator)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self._save(estimator)
            if self.save_best and self.monitor is not None:
                name, value = self.monitor.get()
                improved = value > self.best if self.mode == 'max' else \
                    value < self.best
                if improved:
                    self.best = value
                    estimator.net.save_parameters(os.path.join(
                        self.model_dir, f'{self.model_prefix}-best.params.npz'))

    def _save(self, estimator):
        prefix = os.path.join(self.model_dir, self.model_prefix)
        estimator.net.save_parameters(
            f'{prefix}-epoch{self.current_epoch}.params.npz')
        if estimator.trainer is not None:
            estimator.trainer.save_states(
                f'{prefix}-epoch{self.current_epoch}.states')


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Reference event_handler.py:EarlyStoppingHandler."""

    def __init__(self, monitor, min_delta=0, patience=0, mode='auto',
                 baseline=None):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.mode = _resolve_mode(mode, monitor)
        self.baseline = baseline
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0
        self.best = self.baseline if self.baseline is not None else (
            -_np.inf if self.mode == 'max' else _np.inf)

    def epoch_end(self, estimator, *args, **kwargs):
        name, value = self.monitor.get()
        if self.mode == 'max':
            improved = value > self.best + self.min_delta
        else:
            improved = value < self.best - self.min_delta
        if improved:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = self.current_epoch
                self.stop_training = True
        self.current_epoch += 1

    def train_end(self, estimator, *args, **kwargs):
        if self.stopped_epoch > 0:
            logging.info('Epoch %d: early stopping', self.stopped_epoch)
