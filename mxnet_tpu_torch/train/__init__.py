"""``mx.train`` of the port: training supervision.

Counterpart of ``mxnet_tpu/train/``: :class:`ElasticGroup` drives the
``dist_async`` elastic membership protocol (worker-loss recovery), and
:class:`ElasticHalted` stops a group that fell below its minimum size.
:class:`ElasticTrainer` (crash-consistent checkpoints, which need
``parallel/checkpoint.py``) and :class:`MeshElasticTrainer` (pod-scale
mesh re-formation, which needs ``sharding/``) are not ported yet
(ROADMAP A10 rest): making one raises.
"""

from .elastic import (ElasticGroup, ElasticHalted, ElasticTrainer,
                      MeshElasticTrainer)

__all__ = ['ElasticGroup', 'ElasticHalted', 'ElasticTrainer',
           'MeshElasticTrainer']
