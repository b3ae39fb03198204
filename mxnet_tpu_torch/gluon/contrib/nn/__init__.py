"""Contrib layers (reference ``python/mxnet/gluon/contrib/nn/__init__.py``)."""

from .basic_layers import *  # noqa: F401,F403
from ...nn import SyncBatchNorm  # the reference keeps it here too
