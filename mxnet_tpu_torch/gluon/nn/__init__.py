"""``gluon.nn``: neural-network layers (counterpart of
``mxnet_tpu/gluon/nn/``). The convolution layers wait for ResNet
(ROADMAP A7)."""

from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
