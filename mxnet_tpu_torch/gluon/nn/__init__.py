"""``gluon.nn``: neural-network layers (counterpart of
``mxnet_tpu/gluon/nn/``)."""

from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
# the reference's nn namespace carries the block classes too
from ..block import Block, HybridBlock, SymbolBlock  # noqa: F401,E402
