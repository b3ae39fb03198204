"""``gluon.contrib`` of the port (counterpart of
``mxnet_tpu/gluon/contrib/``, reference python/mxnet/gluon/contrib/): the
estimator, ``DeformableConvolution``, the contrib layers and the contrib
datasets. ``contrib.rnn`` imports ``gluon/rnn`` and waits with it, as do
``contrib.data.vision``'s bounding-box transforms (ROADMAP A11)."""

from . import estimator
from . import cnn
from . import nn
from . import data
