"""BatchProcessor (reference
``python/mxnet/gluon/contrib/estimator/batch_processor.py``) — the
per-batch fit/evaluate strategy object, overridable for non-standard
batch layouts (multi-input models, custom losses)."""

from .... import autograd

__all__ = ['BatchProcessor']


class BatchProcessor:
    """Default single-data/single-label batch processing."""

    def _get_data_and_label(self, batch, ctx=None, batch_axis=0):
        return batch[0], batch[1]

    def evaluate_batch(self, estimator, val_batch, batch_axis=0):
        """Returns (data, label, pred, loss) for one validation batch
        (reference BatchProcessor.evaluate_batch)."""
        data, label = self._get_data_and_label(val_batch)
        pred = estimator.net(data)
        loss = estimator.loss(pred, label)
        return data, label, pred, loss

    def fit_batch(self, estimator, train_batch, batch_axis=0):
        """Forward + backward for one train batch; the Estimator owns
        the trainer.step (reference BatchProcessor.fit_batch)."""
        data, label = self._get_data_and_label(train_batch)
        with autograd.record():
            pred = estimator.net(data)
            loss = estimator.loss(pred, label)
        loss.backward()
        return data, label, pred, loss
