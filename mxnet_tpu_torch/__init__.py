"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu.

The JAX package ``mxnet_tpu`` stays the reference; this package mirrors
its module paths (``serve/decode.py``, ``gluon/model_zoo/llama.py``, ...)
and runs on an NVIDIA Hopper card. Every Pallas kernel on a ported path is
a hand-written CUDA kernel here (``csrc/``), built at first use by
``ops/kernels/_build.py``. The package imports neither ``jax`` nor
``mxnet_tpu``.
"""

from .base import MXNetError
from .context import Context, cpu, gpu, num_gpus, current_context

__all__ = ['MXNetError', 'Context', 'cpu', 'gpu', 'num_gpus',
           'current_context']
