"""``mx.parallel`` of the port: SPMD over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/``, for what the port has so
far: the mesh and ``split_and_load`` (:mod:`.mesh`), sharded placement
and data-parallel steps (:mod:`.sharded`: ``shard_params``,
``replicate``, ``make_sharded_train_step``), sharded checkpoints with a
crash-atomic manager (:mod:`.checkpoint`), sequence-parallel ring
attention with its backward (:mod:`.ring_attention`), and a local
launcher (:mod:`.launch`). The JAX package drives every device of a mesh
from one program; the port runs one process per rank, each holding its
own shards, and ranks meet through a process group (the kvstore's
``dist_sync`` and ``mx.sharding``'s collectives reduce over the same
world). ``pipeline``, ``gluon_pipeline`` and ``moe`` are not ported yet
(ROADMAP A10 rest).
"""

import datetime as _dt
import os as _os

from .mesh import (MeshConfig, make_mesh, data_parallel_mesh,
                   local_devices, split_and_load)
from .sharded import shard_params, replicate, make_sharded_train_step
from . import ring_attention
from . import launch
from . import checkpoint
from .checkpoint import (save_sharded, restore_sharded,
                         SharedCheckpointManager, restore_or_init)

__all__ = ['MeshConfig', 'make_mesh', 'data_parallel_mesh', 'local_devices',
           'split_and_load', 'ring_attention', 'launch', 'init_distributed',
           'DEFAULT_TIMEOUT_S', 'shard_params', 'replicate',
           'make_sharded_train_step', 'checkpoint', 'save_sharded',
           'restore_sharded', 'SharedCheckpointManager', 'restore_or_init']

#: how long a collective may wait for a peer before it fails
DEFAULT_TIMEOUT_S = 600


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     backend=None, timeout=DEFAULT_TIMEOUT_S):
    """Join the world of ranks; returns False (and does nothing) for one
    process, True once the process group is up.

    The arguments default to the ``MX_COORDINATOR``, ``MX_NPROC`` and
    ``MX_PROC_ID`` environment that ``tools/launch.py`` and
    :func:`.launch.spawn` set. ``coordinator`` is ``host:port`` (a TCP
    store on that host) or a ``torch.distributed`` init URL
    (``tcp://...``, ``file://...``).

    ``backend`` defaults to NCCL when the host has a CUDA card, for one
    card a rank (this rank takes card ``process_id % device_count``), and
    to gloo on the CPU. Several ranks on one card must pass
    ``backend='gloo'``: NCCL refuses two ranks on one device ("Duplicate
    GPU detected"), while gloo moves host tensors and does not care where
    a rank computes. ``timeout`` (seconds) bounds every collective, so a
    rank whose peer died fails instead of waiting forever.
    """
    import torch
    import torch.distributed as dist

    coordinator = coordinator or _os.environ.get('MX_COORDINATOR')
    num_processes = num_processes or int(_os.environ.get('MX_NPROC', '1'))
    process_id = process_id if process_id is not None else \
        int(_os.environ.get('MX_PROC_ID', '0'))
    if num_processes <= 1 or coordinator is None:
        return False
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    if backend == 'nccl':
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    url = coordinator if '://' in coordinator else f'tcp://{coordinator}'
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=_dt.timedelta(seconds=timeout))
    return True
