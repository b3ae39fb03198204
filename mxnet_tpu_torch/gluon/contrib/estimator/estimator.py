"""Estimator (reference
python/mxnet/gluon/contrib/estimator/estimator.py): a fit() loop over
DataLoaders with event handlers."""

from ....context import current_context
from ....metric import Accuracy, EvalMetric, Loss as LossMetric
from .event_handler import (BatchBegin, BatchEnd, EpochBegin, EpochEnd,
                            LoggingHandler, MetricHandler, StoppingHandler,
                            TrainBegin, TrainEnd, ValidationHandler)


class Estimator:
    """Reference estimator.py:Estimator."""

    def __init__(self, net, loss, train_metrics=None, val_metrics=None,
                 trainer=None, context=None, devices=None,
                 batch_processor=None):
        from .batch_processor import BatchProcessor
        self.net = net
        self.loss = loss
        self.batch_processor = batch_processor or BatchProcessor()
        tm = train_metrics or [Accuracy()]
        if not isinstance(tm, list):
            tm = [tm]
        # copy: never mutate the caller's list (and never double-append a
        # loss metric when the same list builds two estimators)
        self.train_metrics = list(tm) + [LossMetric(name='train loss')]
        self.val_metrics = val_metrics or []
        self.context = context or devices or [current_context()]
        if not isinstance(self.context, list):
            self.context = [self.context]
        self.trainer = trainer
        self.max_epoch = None

    def prepare_loss_and_metrics(self):
        return self.train_metrics, self.val_metrics

    def evaluate(self, val_data=None, batch_axis=0):
        for metric in self.val_metrics:
            metric.reset()
        for batch in val_data or []:
            data, label, pred, loss = \
                self.batch_processor.evaluate_batch(self, batch,
                                                    batch_axis)
            for metric in self.val_metrics:
                if isinstance(metric, LossMetric):
                    metric.update(0, loss)
                else:
                    metric.update(label, pred)

    def fit(self, train_data, val_data=None, epochs=None, event_handlers=None,
            batches=None, batch_axis=0):
        from ...trainer import Trainer

        self.max_epoch = epochs or 1
        if self.trainer is None:
            self.trainer = Trainer(self.net.collect_params(), 'adam')

        handlers = self._init_handlers(val_data, event_handlers, batches)
        train_begin, epoch_begin, batch_begin, batch_end, epoch_end, \
            train_end = self._categorize(handlers)
        # ANY handler may request a stop (EarlyStoppingHandler etc.), not
        # just the auto-added StoppingHandler
        def _should_stop():
            return any(getattr(h, 'stop_training', False) for h in handlers)

        for h in train_begin:
            h.train_begin(self)
        while not _should_stop():
            for h in epoch_begin:
                h.epoch_begin(self)
            for batch in train_data:
                for h in batch_begin:
                    h.batch_begin(self, batch=batch)
                data, label, pred, loss = \
                    self.batch_processor.fit_batch(self, batch,
                                                   batch_axis)
                self.trainer.step(data.shape[batch_axis])
                for h in batch_end:
                    h.batch_end(self, batch=batch, pred=pred, label=label,
                                loss=loss, batch_size=data.shape[batch_axis])
                if _should_stop():
                    break
            for h in epoch_end:
                h.epoch_end(self)
        for h in train_end:
            h.train_end(self)

    def _init_handlers(self, val_data, event_handlers, batches):
        handlers = list(event_handlers or [])
        if not any(isinstance(h, StoppingHandler) for h in handlers):
            handlers.append(StoppingHandler(self.max_epoch, batches))
        if not any(isinstance(h, MetricHandler) for h in handlers):
            handlers.append(MetricHandler(self.train_metrics))
        if val_data is not None and not any(
                isinstance(h, ValidationHandler) for h in handlers):
            handlers.append(ValidationHandler(val_data, self.evaluate))
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler(metrics=self.train_metrics))
        return handlers

    def _categorize(self, handlers):
        return ([h for h in handlers if isinstance(h, TrainBegin)],
                [h for h in handlers if isinstance(h, EpochBegin)],
                [h for h in handlers if isinstance(h, BatchBegin)],
                [h for h in handlers if isinstance(h, BatchEnd)],
                [h for h in handlers if isinstance(h, EpochEnd)],
                [h for h in handlers if isinstance(h, TrainEnd)])
