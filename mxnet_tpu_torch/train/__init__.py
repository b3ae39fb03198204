"""``mx.train`` of the port: training supervision.

Counterpart of ``mxnet_tpu/train/``: :class:`ElasticTrainer` (asynchronous
crash-consistent checkpoints and bit-exact resume), :class:`ElasticGroup`
(the ``dist_async`` elastic membership protocol: worker-loss recovery),
:class:`MeshElasticTrainer` (a sharded run that re-forms its mesh on the
surviving hosts) and :class:`ElasticHalted`, which stops a group that fell
below its minimum size.
"""

from .elastic import (ElasticGroup, ElasticHalted, ElasticTrainer,
                      MeshElasticTrainer)

__all__ = ['ElasticGroup', 'ElasticHalted', 'ElasticTrainer',
           'MeshElasticTrainer']
