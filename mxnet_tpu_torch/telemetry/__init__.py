"""``mx.telemetry`` for the PyTorch port: spans, trace context and the
flight recorder (:mod:`.trace`), and the metrics registry
(:mod:`.metrics`). Both are copies of the JAX package's stdlib-only
modules; the Chrome-trace exporter is not ported yet.
"""

from . import trace
from . import metrics

__all__ = ['trace', 'metrics']
