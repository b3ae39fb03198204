"""Mesh construction (counterpart of the JAX package's ``parallel/mesh.py``
:17-62).

The JAX mesh is an array of the devices one program drives. The port runs
one process per rank (SPMD over ``torch.distributed``), so its mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group, with named dims; ``mesh.get_group('sp')`` is the process group of
this rank's sequence-parallel ring. Under NCCL the mesh is a ``'cuda'``
mesh (one card a rank); under gloo it is a ``'cpu'`` mesh, since gloo moves
host tensors: a caller's CUDA tensors then pass through host buffers
(``ring_attention`` does that), and several ranks may share one card.
"""

import math

import torch
import torch.distributed as dist

from ..base import MXNetError

__all__ = ['MeshConfig', 'make_mesh', 'data_parallel_mesh', 'local_devices',
           'split_and_load']


class MeshConfig:
    """Named axis sizes for a parallelism plan: dp/tp/pp/sp/ep."""

    def __init__(self, dp=1, tp=1, pp=1, sp=1, ep=1):
        self.axes = {'dp': dp, 'tp': tp, 'pp': pp, 'sp': sp, 'ep': ep}

    def active_axes(self):
        return {k: v for k, v in self.axes.items() if v > 1} or {'dp': 1}


def local_devices():
    """The devices of this host: every CUDA card, else the CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device('cuda', i) for i in range(n)] or \
        [torch.device('cpu')]


def _world():
    if not dist.is_available() or not dist.is_initialized():
        raise MXNetError('parallel: no process group; the port runs one '
                         'process per rank, and each calls '
                         'parallel.init_distributed() (or runs under '
                         'parallel.launch.spawn) before building a mesh')
    return dist.get_world_size()


def make_mesh(config=None, **axes):
    """A ``DeviceMesh`` over the first ranks of the world, with one named
    dim per axis, e.g. ``make_mesh(dp=2, sp=2)`` (rank = dp_index * 2 +
    sp_index). Raises when the axes need more ranks than the world has."""
    world = _world()
    if config is not None:
        axes = config.active_axes()
    if not axes:
        axes = {'dp': world}
    sizes = [int(s) for s in axes.values()]
    n = math.prod(sizes)
    if n > world:
        raise MXNetError(f'mesh needs {n} ranks, have {world}')
    device_type = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, torch.arange(n).reshape(sizes),
                      mesh_dim_names=tuple(axes))


def data_parallel_mesh():
    """A one-dim ``'dp'`` mesh over every rank of the world."""
    return make_mesh(dp=_world())


def split_and_load(data, ctx_list=None, batch_axis=0, even_split=True,
                   mesh=None):
    """Split a batch across devices (reference gluon/utils.py
    split_and_load; JAX ``parallel/mesh.py:64-95``), in one of two forms:

    * ``ctx_list``: one slice a context, copied there (the reference's
      form; :func:`..gluon.utils.split_and_load`);
    * ``mesh``: this rank's shard of the batch (dim 0) over the mesh's
      ``'dp'`` dim, on the current context. The JAX package returns one
      global array sharded on ``dp``; one process a rank holds its shard,
      and the shards of the ranks in ``dp`` order are the batch. The
      batch must divide evenly, as a JAX sharding requires.
    """
    from ..ndarray.ndarray import NDArray, array
    if not isinstance(data, NDArray):
        data = array(data)
    if mesh is not None:
        names = tuple(mesh.mesh_dim_names or ())
        if 'dp' not in names:
            raise ValueError(f'mesh {names} has no axis \'dp\'')
        n, rank = mesh.size(names.index('dp')), \
            mesh.get_local_rank('dp')
        size = data.shape[0]
        if size % n:
            raise ValueError(f'a batch of {size} does not split evenly '
                             f'over dp = {n}')
        step = size // n
        return data[rank * step:(rank + 1) * step]
    if ctx_list is None:
        raise ValueError('need ctx_list or mesh')
    from ..gluon.utils import split_and_load as _split
    return _split(data, ctx_list, batch_axis, even_split)
