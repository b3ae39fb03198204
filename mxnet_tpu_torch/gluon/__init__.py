"""Gluon of the PyTorch port (counterpart of ``mxnet_tpu/gluon/``):
:class:`Parameter`, :class:`Block` and :class:`HybridBlock` (whose
``hybridize()`` replays predict-mode calls from CUDA graphs on the card
and whose ``export()`` writes a symbol file), :class:`SymbolBlock`
(an imported symbol run as a block),
the layers of :mod:`.nn`, the losses of :mod:`.loss`, :mod:`.utils`, the
single-device :class:`Trainer`, :mod:`.data` (datasets, samplers,
``DataLoader``), ``gluon.metric`` (``mx.metric``), the model zoo (the
vision zoo, BERT and the Llama family on these blocks) and
``gluon.contrib`` (the estimator, ``DeformableConvolution``, the contrib
layers and datasets)."""

from .block import Block, HybridBlock, ParameterDict, SymbolBlock
from .parameter import Constant, DeferredInitializationError, Parameter
from .trainer import Trainer
from . import nn
from . import loss
from . import data
from . import utils
from . import model_zoo
from . import contrib
from .. import metric  # gluon.metric is the reference's home for metrics

__all__ = ['Block', 'HybridBlock', 'ParameterDict', 'SymbolBlock', 'Constant',
           'DeferredInitializationError', 'Parameter', 'Trainer', 'nn',
           'loss', 'data', 'utils', 'model_zoo', 'contrib', 'metric']
