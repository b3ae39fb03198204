"""Mesh-scoped sharding context: ``with mx.sharding.mesh(dp=4, tp=2):``.

Counterpart of ``mxnet_tpu/sharding/context.py``. The JAX package drives
every device of the mesh from one program and lets GSPMD partition it; the
port runs one process per rank (``parallel.init_distributed``,
``parallel.launch.spawn``), and a :class:`ShardingContext` names the ranks
of the mesh, the sizes of its axes and the process group of each axis.
Inside the context a hybridized block places its parameters by the rule
registry (:mod:`.rules`) and keeps only this rank's shards, its batch is
cut on the data axis, the Trainer splits optimizer slots on ``dp``
(ZeRO-1) and ``DecodeServer`` shards its page pool; all with no change to
the model's code (``gluon/block.py`` reads the ambient context).

A context may instead be given a process group of its own (``group=``,
a formation's group: :class:`MeshGroup.context`): its ranks are then that
group's, and the groups of its axes are made inside it, each by the ranks
of one line only (``new_group(..., use_local_synchronization=True)``), so
that no call reaches a rank outside the formation. A ``DeviceMesh`` over
the default world would call ``new_group`` over every rank of the world,
which waits forever once one of them has died.

The context is thread-local and reentrant (a stack). Its
:meth:`ShardingContext.fingerprint` (axis names, sizes, ranks, mode, arch
and rule table) joins a hybridized block's cache key: the same mesh is
warm, a new mesh is a new key. The ``DeviceMesh`` and its process groups
are made at first use, which every rank reaches at the same call (SPMD).

Env overrides, the reference's own: ``MXNET_SHARDING_DP`` /
``MXNET_SHARDING_TP`` (axis sizes), ``MXNET_SHARDING_DISABLE=1`` (a
no-op context) and ``MXNET_SHARDING_STRICT=1`` (:func:`.rules.resolve_spec`).
"""

import math
import os
import threading
from contextlib import contextmanager

from . import rules as _rules
from .rules import PartitionSpec as P
from ..base import MXNetError

__all__ = ['ShardingContext', 'MeshGroup', 'mesh', 'current', 'constrain',
           'batch_spec', 'use', 'lift_raws', 'local_group', 'abandon',
           'abandoned']

_STACK = threading.local()
#: DeviceMeshes by (ranks, axis names, sizes): each is made once a process
_MESHES = {}
#: process groups given up after a peer died inside one of their
#: collectives: a gloo worker thread may wait in them for good, so the
#: process must not destroy them (``ProcessGroupGloo``'s destructor joins
#: its threads)
_ABANDONED = []


def local_group(ranks):
    """A new process group of ``ranks`` (world ranks), made by those ranks
    only: every one of them calls this at the same point, and no other
    rank takes part, dead or alive. Its rank order is ``sorted(ranks)``."""
    import torch.distributed as dist
    return dist.new_group(sorted(int(r) for r in ranks),
                          use_local_synchronization=True)


def abandon(group):
    """Give up ``group`` after a peer died in one of its collectives (it
    is kept referenced and never destroyed; see :func:`abandoned`)."""
    if group is not None:
        _ABANDONED.append(group)


def abandoned():
    """True when this process gave up a process group: it must leave
    without ``destroy_process_group`` (``os._exit``), whose join of the
    group's worker threads could wait for good."""
    return bool(_ABANDONED)


def _stack():
    if not hasattr(_STACK, 'items'):
        _STACK.items = []
    return _STACK.items


def current():
    """The innermost active :class:`ShardingContext`, or None."""
    items = _stack()
    return items[-1] if items else None


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ShardingContext:
    """One mesh (named axis sizes over a list of ranks), its rule table and
    the placement helpers. ``ranks`` default to the first ones of the
    world, or to ``group``'s ranks; rank ``ranks[i]`` sits at the
    row-major mesh coordinate ``i``. With ``group`` (a process group
    over exactly these ranks) the axes' groups are made inside it, by the
    ranks of each line alone (see the module docstring)."""

    def __init__(self, axis_sizes, ranks=None, rules=None, mode=None,
                 arch=None, data_axis='dp', group=None):
        sizes = {str(k): int(v) for k, v in axis_sizes.items()}
        self.axis_sizes = sizes
        self.axis_names = tuple(sizes)
        self.n_devices = math.prod(sizes.values())
        self.base_group = group
        self._lines = {}
        self._strides = {}
        if group is not None and ranks is None:
            import torch.distributed as dist
            ranks = dist.get_process_group_ranks(group)
        self.ranks = tuple(range(self.n_devices)) if ranks is None \
            else tuple(int(r) for r in ranks)
        if len(self.ranks) != self.n_devices:
            raise ValueError(f'{len(self.ranks)} ranks for a mesh of '
                             f'{self.n_devices}')
        if mode is None:
            mode = 'tp' if sizes.get('tp', 1) > 1 else 'fsdp'
        self.mode = mode
        self.arch = arch          # None -> inferred per block
        self._rules = rules       # explicit table beats the registry
        self.data_axis = data_axis if sizes.get(data_axis, 1) > 1 else None
        self._mesh = None
        self._fp = (self.axis_names, tuple(self.axis_sizes.values()),
                    self.ranks, self.mode, self.arch,
                    id(self._rules) if self._rules else None,
                    None if group is None else group.group_name)

    @classmethod
    def from_mesh(cls, mesh, **kwargs):
        """A context over a ``torch.distributed`` ``DeviceMesh`` with named
        dims (``parallel.make_mesh``)."""
        names = tuple(mesh.mesh_dim_names or ())
        ctx = cls({n: int(mesh.size(i)) for i, n in enumerate(names)},
                  ranks=mesh.mesh.flatten().tolist(), **kwargs)
        ctx._mesh = mesh
        _MESHES.setdefault((ctx.ranks, ctx.axis_names,
                            tuple(ctx.axis_sizes.values())), mesh)
        return ctx

    # ------------------------------------------------------------- identity
    def fingerprint(self):
        """Hashable identity for cache keys: axis names and sizes, ranks,
        mode, arch and the rule table's identity."""
        return self._fp

    def same_mesh(self, other):
        """True when ``other`` lays values out over the same ranks and
        axes (and process group)."""
        return other is self or (other is not None and
                                 self._fp[:3] == other._fp[:3] and
                                 self._fp[6] == other._fp[6])

    # ---------------------------------------------------------------- ranks
    @property
    def mesh(self):
        """The ``torch.distributed`` ``DeviceMesh`` over :attr:`ranks`,
        made at first use (every rank of the world makes it together)."""
        if self.base_group is not None:
            raise MXNetError('sharding: a context over a process group of '
                             'its own has no DeviceMesh; use group(axis)')
        if self._mesh is None:
            import torch
            import torch.distributed as dist
            world, _ = _world()
            if world == 1 and self.n_devices > 1:
                raise MXNetError(
                    f'sharding: a mesh of {self.n_devices} ranks needs a '
                    f'process group; run one process per rank '
                    f'(parallel.init_distributed or parallel.launch.spawn)')
            if max(self.ranks) >= world:
                raise MXNetError(f'sharding: mesh ranks {self.ranks} '
                                 f'outside a world of {world}')
            if world == 1:
                return None
            key = (self.ranks, self.axis_names,
                   tuple(self.axis_sizes.values()))
            if key not in _MESHES:
                from torch.distributed.device_mesh import DeviceMesh
                dtype = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
                _MESHES[key] = DeviceMesh(
                    dtype, torch.tensor(self.ranks).reshape(key[2]),
                    mesh_dim_names=self.axis_names)
            self._mesh = _MESHES[key]
        return self._mesh

    def size(self, axis):
        """The size of ``axis`` (1 for an axis the mesh does not have)."""
        return self.axis_sizes.get(axis, 1)

    def _stride(self, axis):
        """This rank's position in :attr:`ranks` and ``axis``'s stride,
        kept once a world of more than one rank gives them (the rank is
        fixed while its world lives, as the mesh and the lines are)."""
        got = self._strides.get(axis)
        if got is None:
            world, rank = _world()
            names = self.axis_names
            got = self.ranks.index(rank), math.prod(
                self.axis_sizes[n] for n in names[names.index(axis) + 1:])
            if world > 1:
                self._strides[axis] = got
        return got

    def coord(self, axis):
        """This rank's index along ``axis``."""
        if self.size(axis) == 1:
            return 0
        i, stride = self._stride(axis)
        return (i // stride) % self.axis_sizes[axis]

    def group(self, axis):
        """The process group of this rank's line along ``axis``."""
        g = self._lines.get(axis)
        if g is None and self.base_group is None:
            g = self._lines[axis] = self.mesh.get_group(axis)
        if g is None:
            i, stride = self._stride(axis)
            base = i - self.coord(axis) * stride
            line = [self.ranks[base + j * stride]
                    for j in range(self.axis_sizes[axis])]
            if line != sorted(line):
                raise MXNetError(f'sharding: the ranks of a line along '
                                 f'{axis!r} must ascend, got {line}')
            g = self.base_group if len(line) == len(self.ranks) \
                else local_group(line)
            self._lines[axis] = g
        return g


    # ------------------------------------------------------------ rule match
    def rules_for_block(self, block=None, arch=None):
        if self._rules is not None:
            return self._rules
        arch = arch or self.arch
        if arch is None and block is not None:
            arch = _rules.infer_arch(block)
        arch = arch or 'generic'
        try:
            return _rules.rules_for(arch, self.mode)
        except KeyError:
            if arch != 'generic' and self.mode == 'fsdp':
                return _rules.rules_for('generic', 'fsdp')
            raise

    def spec_for(self, name, shape, rules):
        """Resolved PartitionSpec for one named parameter (rule match +
        divisibility fallback against this mesh)."""
        spec = _rules.match_spec(name, shape, rules)
        return _rules.resolve_spec(spec, shape, self, name=name)

    # ------------------------------------------------------------ placement
    def place_params(self, block, each=None):
        """Place every parameter of ``block`` by this context's rules,
        names relative to ``block`` as the reference matches them, one at a
        time: ``each(p)``, where given, runs just before ``p`` is placed
        (an initialization: no rank then holds more than one parameter
        whole), and a deferred parameter is initialized first."""
        rules = self.rules_for_block(block)
        for name, p in block.collect_params().items():
            if each is not None:
                each(p)
            if p._var is None:
                p._finish_deferred_init()
            p._shard_to(self, self.spec_for(name, p.shape, rules))

    def batch_spec(self, shape):
        """Activation spec: leading (batch) dim on the data axis when it
        divides, otherwise replicated."""
        if self.data_axis is None or not shape:
            return P()
        if shape[0] % self.axis_sizes[self.data_axis]:
            return P()
        return P(self.data_axis)

    def zero1_spec(self, param_spec, shape):
        """Optimizer-slot spec: the parameter's layout plus the data axis
        on the first still-replicated divisible dim (ZeRO-1: each
        data-parallel rank updates only its slice)."""
        if self.data_axis is None:
            return param_spec
        extent = self.axis_sizes.get(self.data_axis, 1)
        entries = list(tuple(param_spec)) + [None] * (len(shape)
                                                      - len(param_spec))
        used = set()
        for e in entries:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    used.add(a)
        if self.data_axis in used:
            return param_spec
        sizes = self.axis_sizes
        for d, e in enumerate(entries):
            have = 1
            for a in ((e if isinstance(e, tuple) else (e,)) or ()):
                if a is not None:
                    have *= sizes.get(a, 1)
            if shape[d] % (have * extent) == 0 and shape[d] >= extent:
                if e is None:
                    entries[d] = self.data_axis
                elif isinstance(e, tuple):
                    entries[d] = e + (self.data_axis,)
                else:
                    entries[d] = (e, self.data_axis)
                while entries and entries[-1] is None:
                    entries.pop()
                return P(*entries)
        return param_spec

    def __repr__(self):
        ax = ', '.join(f'{k}={v}' for k, v in self.axis_sizes.items())
        return f'<ShardingContext {ax} mode={self.mode}>'


class MeshGroup:
    """Mesh topology separated from process topology (the pod layer).

    The reference's group maps emulated hosts to contiguous blocks of JAX
    devices; here a host owns a contiguous block of ranks (``devices``,
    default every rank of the world, or one when there is no process
    group). The group tracks the live host set and a re-formation
    ``generation``; it is immutable: :meth:`eject` returns a new group.
    :meth:`context` builds a :class:`ShardingContext` over the live hosts'
    ranks. ``n_procs`` defaults to ``MXNET_MESH_PROCS``."""

    def __init__(self, n_procs=None, devices=None, generation=0,
                 live=None):
        if n_procs is None:
            try:
                n_procs = int(os.environ.get('MXNET_MESH_PROCS', '1'))
            except ValueError:
                n_procs = 1
        n_procs = int(n_procs)
        devices = list(devices) if devices is not None \
            else list(range(_world()[0]))
        if n_procs < 1:
            raise ValueError(f'n_procs must be >= 1, got {n_procs}')
        if len(devices) % n_procs:
            raise ValueError(
                f'{len(devices)} ranks do not split evenly over '
                f'{n_procs} hosts')
        self.n_procs = n_procs
        self._devices = devices
        per = len(devices) // n_procs
        self.devices_per_proc = per
        self._owned = {r: tuple(devices[r * per:(r + 1) * per])
                       for r in range(n_procs)}
        self.generation = int(generation)
        live = sorted(set(range(n_procs)) if live is None else
                      {int(r) for r in live})
        for r in live:
            if not 0 <= r < n_procs:
                raise ValueError(f'live rank {r} outside 0..{n_procs - 1}')
        if not live:
            raise ValueError('a MeshGroup needs at least one live host')
        self._live = tuple(live)

    @property
    def live(self):
        """Live host ranks, ascending."""
        return self._live

    @property
    def leader(self):
        """Lowest live host: it drives re-formation."""
        return self._live[0]

    def host_of(self, device):
        """The host that owns rank ``device``."""
        return self._devices.index(int(device)) // self.devices_per_proc

    def devices_for(self, rank):
        """The contiguous block of ranks host ``rank`` owns (dead or
        alive: ownership is topology, liveness is membership)."""
        return self._owned[int(rank)]

    def live_devices(self):
        """The live hosts' ranks, in order: the re-formed mesh's ranks."""
        return [d for r in self._live for d in self._owned[r]]

    def eject(self, *ranks):
        """New group without ``ranks``, generation bumped."""
        gone = {int(r) for r in ranks}
        live = [r for r in self._live if r not in gone]
        if not live:
            raise ValueError(
                f'ejecting {sorted(gone)} would leave no live host')
        return MeshGroup(self.n_procs, self._devices,
                         generation=self.generation + 1, live=live)

    def context(self, tp=None, rules=None, mode=None, arch=None,
                group=None):
        """A :class:`ShardingContext` over the live hosts' ranks: ``dp`` =
        live ranks / ``tp`` (default tp=1). Enter it with :func:`use`.
        ``group`` is the formation's process group over exactly those
        ranks: the context's collectives then stay inside it."""
        devs = self.live_devices()
        tp = int(tp) if tp else 1
        if tp > 1 and len(devs) % tp:
            raise ValueError(
                f'tp={tp} does not divide {len(devs)} live ranks')
        dp = len(devs) // tp
        sizes = {}
        if dp > 1:
            sizes['dp'] = dp
        if tp > 1:
            sizes['tp'] = tp
        if not sizes:
            sizes = {'dp': len(devs)}
        return ShardingContext(sizes, ranks=devs, rules=rules, mode=mode,
                               arch=arch, group=group)

    def describe(self):
        """Registration-record form."""
        return {'n_procs': self.n_procs,
                'devices_per_proc': self.devices_per_proc,
                'n_devices': len(self._devices),
                'live': list(self._live),
                'generation': self.generation}

    def __repr__(self):
        return (f'<MeshGroup {len(self._live)}/{self.n_procs} hosts x '
                f'{self.devices_per_proc} ranks gen={self.generation}>')


def constrain(x, spec=None):
    """Lay ``x`` (an NDArray) out at ``spec`` under the active mesh (the
    batch spec for its shape by default): this rank's shard of it,
    gathering first where it is laid out otherwise. Identity when no
    context is active."""
    ctx = current()
    if ctx is None:
        return x
    from . import dispatch
    if spec is None:
        spec = ctx.batch_spec(x.shape)
    else:
        spec = _rules.resolve_spec(spec, x.shape, ctx)
    return dispatch.redistribute(x, ctx, spec)


def batch_spec(shape):
    """The active context's batch spec for ``shape`` (P() when none)."""
    ctx = current()
    return ctx.batch_spec(tuple(shape)) if ctx is not None else P()


def lift_raws(arrays):
    """Eager-op reconciliation (called by ``ops.registry.apply_op``):
    where sharded arrays meet fresh unsharded ones, the unsharded ones
    that share the sharded dims' global extents are cut to this rank's
    shard, so that eager loss and metric math composes with sharded
    outputs. Returns the list unchanged when nothing is sharded."""
    from . import dispatch
    return dispatch.lift(arrays)


def _env_axis(name, value):
    env = os.environ.get(name, '')
    if env:
        return int(env)
    return value


@contextmanager
def mesh(dp=None, tp=None, devices=None, rules=None, mode=None, arch=None,
         **axes):
    """Scoped sharding over a mesh of ranks built from axis sizes::

        with mx.sharding.mesh(dp=2, tp=2):
            net.hybridize()
            out = net(x)            # this rank's shard, no model change

    ``dp``/``tp`` (and any extra named axes) size the mesh;
    ``MXNET_SHARDING_DP``/``MXNET_SHARDING_TP`` override them, and
    ``MXNET_SHARDING_DISABLE=1`` makes the context a no-op. ``devices``
    names the ranks (default: the first ones of the world). ``rules`` pins
    an explicit rule table; otherwise the registry table for ``arch``
    (inferred per block) and the mode ('tp' when tp>1 else 'fsdp')."""
    if os.environ.get('MXNET_SHARDING_DISABLE', '') == '1':
        yield None
        return
    dp = _env_axis('MXNET_SHARDING_DP', dp)
    tp = _env_axis('MXNET_SHARDING_TP', tp)
    sizes = {}
    if dp and dp > 1:
        sizes['dp'] = dp
    if tp and tp > 1:
        sizes['tp'] = tp
    for k, v in axes.items():
        if v and v > 1:
            sizes[k] = v
    if not sizes:
        sizes = {'dp': len(devices) if devices is not None else _world()[0]}
    ctx = ShardingContext(sizes, ranks=devices, rules=rules, mode=mode,
                          arch=arch)
    _stack().append(ctx)
    try:
        yield ctx
    finally:
        _stack().pop()


@contextmanager
def use(ctx):
    """Re-enter an existing :class:`ShardingContext` (e.g. one captured by
    a server at construction)."""
    if ctx is None:
        yield None
        return
    _stack().append(ctx)
    try:
        yield ctx
    finally:
        _stack().pop()
