"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu.

The JAX package ``mxnet_tpu`` stays the reference; this package mirrors
its module paths (``serve/decode.py``, ``gluon/model_zoo/llama.py``, ...)
and runs on an NVIDIA Hopper card. Every Pallas kernel on a ported path is
a hand-written CUDA kernel here (``csrc/``), built at first use by
``ops/kernels/_build.py``. The package imports neither ``jax`` nor
``mxnet_tpu``.

The imperative frontend is the reference's::

    import mxnet_tpu_torch as mx
    x = mx.np.ones((2, 3), ctx=mx.gpu())
    with mx.autograd.record():
        y = (x * x).sum()
    y.backward()

``mx.np``, ``mx.npx`` and ``mx.nd`` are generated from the op registry
(``ops/registry.py``); an NDArray holds one ``torch.Tensor``, and
``mx.autograd`` runs on ``torch.autograd``. ``mx.gluon`` has the blocks,
layers, losses and Trainer, ``mx.init`` (``mx.initializer``) the
initializers, ``mx.io`` the data iterators, ``mx.metric`` the
evaluation metrics, ``mx.amp`` mixed precision, ``mx.kvstore``
the key-value stores that data-parallel training reduces through (the
``dist_async`` parameter server among them) and ``mx.train`` the elastic
membership group that drives that server's worker-loss recovery.
"""

from .base import MXNetError
from .context import Context, cpu, gpu, num_gpus, current_context

from . import ops  # registers every ported op
from . import ndarray
from . import ndarray as nd
from . import numpy as np  # noqa: A004 - mirrors the reference's mx.np
from . import numpy_extension as npx
from . import autograd
from . import random
from .ndarray.ndarray import NDArray
from .ndarray import waitall
from . import initializer
from . import initializer as init
from . import model
from . import metric
from . import io
from . import gluon
from . import amp
from . import kvstore
from . import train

__all__ = ['MXNetError', 'Context', 'cpu', 'gpu', 'num_gpus',
           'current_context', 'np', 'npx', 'nd', 'autograd', 'random',
           'NDArray', 'waitall', 'initializer', 'init', 'model', 'metric',
           'io', 'gluon', 'amp', 'kvstore', 'train']
