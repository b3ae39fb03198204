"""``mx.sharding`` of the port: SPMD sharding for training and serving with
no change to the model's code.

Counterpart of ``mxnet_tpu/sharding/``, in two pieces, composed by the
hybridize cache (``gluon/block.py``):

* a **partition-rule registry** (:mod:`.rules`): ordered ``(regex,
  PartitionSpec)`` tables over the structural parameter names, per-arch
  tables for resnet, bert and llama in ``tp`` and ``fsdp`` modes, and
  :func:`register_rules` for more. First match wins, scalars replicate, an
  uncovered parameter errors naming the nearest rule;
* a **mesh-scoped context** (:mod:`.context`): ``with mx.sharding.mesh(
  dp=2, tp=2):`` shards every hybridized call inside it: parameters placed
  by the rules, each rank holding only its shards, the batch cut on the
  data axis, keyed by the mesh's fingerprint (a new mesh is a new key).

The JAX package partitions one program over every device with GSPMD. The
port runs one process per rank (``parallel.launch.spawn``), so a sharded
value is this rank's shard with its layout (:mod:`.dispatch`): its
``shape`` is global, ``asnumpy()`` gathers (every rank calls it), and an
eager op runs on the shards, with the collective GSPMD would insert
(:mod:`._collectives`, through the kvstore's ``CrossProcess`` over gloo
or NCCL). Consumers: ``gluon.Trainer``
splits optimizer slots on the data axis (ZeRO-1), ``serve.DecodeServer``
shards the Llama and its page pool (pages on ``dp``, KV heads on ``tp``),
``parallel.shard_params`` and ``parallel.checkpoint`` place and save
shards.
"""

from .rules import (PartitionSpec, match_partition_rules, match_spec,
                    resolve_spec, shard_factor, register_rules, rules_for,
                    list_archs, infer_arch, UnmatchedParamError)
from .context import (ShardingContext, MeshGroup, mesh, current,
                      constrain, batch_spec, use, lift_raws)
from . import dispatch

# let the eager dispatch see sharded arguments without a circular
# top-level import
from ..ops import registry as _registry
_registry._bind_sharding()
del _registry

__all__ = ['PartitionSpec', 'match_partition_rules', 'match_spec',
           'resolve_spec', 'shard_factor', 'register_rules', 'rules_for',
           'list_archs', 'infer_arch', 'UnmatchedParamError',
           'ShardingContext', 'MeshGroup', 'mesh', 'current', 'constrain',
           'batch_spec', 'use', 'lift_raws']
