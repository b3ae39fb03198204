"""Estimator framework (reference python/mxnet/gluon/contrib/estimator/)."""

from .estimator import Estimator
from .event_handler import (TrainBegin, TrainEnd, EpochBegin, EpochEnd,
                            BatchBegin, BatchEnd, StoppingHandler,
                            MetricHandler, ValidationHandler, LoggingHandler,
                            CheckpointHandler, EarlyStoppingHandler)
