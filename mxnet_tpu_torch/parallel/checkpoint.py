"""Sharded (distributed) checkpoint and resume.

Counterpart of ``mxnet_tpu/parallel/checkpoint.py``. The reference's
checkpoints are rank-0 whole files; with sharded parameters every rank
writes its own shards and restore places them again, on the same mesh or
a new one. The JAX package wraps orbax, which the port does not have: a
checkpoint here is a directory of one ``torch.save`` file a rank
(``rank{r}.pt``: each leaf's shard and its layout, the unsharded leaves in
rank 0's only) and ``meta.json`` (the leaves' global shapes and dtypes and
the writing world), written by the ranks together.

Restore assembles each leaf's global value on the host from the writers'
shards (each shard's global indices follow from its layout, so any mesh
reads any other's checkpoint), then places it as the caller asks: host
numpy, this rank's shard under a template's layout, or under
``mesh`` + ``specs``.

:class:`SharedCheckpointManager` keeps the reference's step rotation and
crash-atomic commit protocol (staging write, rename, fsynced manifest,
prune), its crash hook and points (``ckpt.staged``, ``ckpt.cleared``,
``ckpt.renamed``, ``ckpt.committed``), ``max_to_keep`` and the scan of
integer step directories when the manifest is missing.
"""

import json as _json
import os as _os
import shutil as _shutil

import numpy as _np
import torch

__all__ = ['save_sharded', 'restore_sharded', 'SharedCheckpointManager',
           'save_params_sharded', 'load_params_sharded', 'restore_or_init',
           'install_crash_hook']

# Test-only crash hook: ``install_crash_hook(fn)`` makes the commit
# protocol call ``fn(point)`` at named points inside ``save``; a hook that
# raises stands for a kill at exactly that point.
_CRASH_HOOK = None


def install_crash_hook(fn):
    """Install (or with ``None`` remove) the crash-point hook; returns the
    previously installed hook."""
    global _CRASH_HOOK
    prev, _CRASH_HOOK = _CRASH_HOOK, fn
    return prev


def _crash_point(name):
    if _CRASH_HOOK is not None:
        _CRASH_HOOK(name)


def _world():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _barrier():
    import torch.distributed as dist
    if _world()[0] > 1:
        dist.barrier()


# ----------------------------------------------------------------- trees
def _flatten(tree, prefix=''):
    """``{path: leaf}`` of a nest of dicts, lists and tuples (a
    PartitionSpec is a leaf)."""
    from ..sharding.rules import PartitionSpec
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f'{prefix}{k}/'))
        return out
    if isinstance(tree, (list, tuple)) and \
            not isinstance(tree, PartitionSpec):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f'{prefix}{i}/'))
        return out
    return {prefix[:-1]: tree}


def _unflatten(flat):
    root = {}
    for path, v in flat.items():
        node = root
        parts = path.split('/')
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _leaf(x):
    """``(tensor, layout or None)`` of a leaf: a Parameter, an NDArray
    (sharded or not), a tensor or array-like."""
    from ..gluon.parameter import Parameter
    from ..ndarray.ndarray import NDArray
    if isinstance(x, Parameter):
        x = x.data()
    if isinstance(x, NDArray):
        return x._data.detach(), x._layout
    if torch.is_tensor(x):
        return x.detach(), None
    return torch.as_tensor(_np.asarray(x)), None


def _describe(layout):
    ctx = layout.ctx
    axes = {a for s in layout.spec for a in s}
    return {'spec': [list(s) for s in layout.spec],
            'blocks': [list(b) for b in layout.blocks],
            'coords': {a: ctx.coord(a) for a in axes},
            'sizes': {a: ctx.size(a) for a in axes}}


def _indices(n_global, axes, blocks, coords, sizes):
    """The global indices along one dim of the shard a writer held."""
    from ..sharding._collectives import take
    idx = torch.arange(n_global)
    for a, k in zip(axes, blocks):
        idx = take(idx, 0, sizes[a], coords[a], k)
    return idx.numpy()


# ------------------------------------------------------------ save/restore
def _write(directory, tree):
    """Every rank writes its shards under ``directory``; rank 0 the
    unsharded leaves and ``meta.json``."""
    world, rank = _world()
    _os.makedirs(directory, exist_ok=True)
    leaves, meta = {}, {}
    for path, x in _flatten(tree).items():
        t, lay = _leaf(x)
        gshape = list(lay.gshape) if lay is not None else list(t.shape)
        meta[path] = {'shape': gshape, 'dtype': str(t.dtype).split('.')[-1],
                      'sharded': lay is not None}
        if lay is not None:
            leaves[path] = dict(_describe(lay), data=t.cpu().clone())
        elif rank == 0:
            leaves[path] = {'data': t.cpu().clone()}
    torch.save(leaves, _os.path.join(directory, f'rank{rank}.pt'))
    if rank == 0:
        with open(_os.path.join(directory, 'meta.json'), 'w',
                  encoding='utf-8') as f:
            _json.dump({'world': world, 'leaves': meta}, f)
    _barrier()


def _read(directory):
    """``{path: numpy}``: every leaf's global value."""
    with open(_os.path.join(directory, 'meta.json'), encoding='utf-8') as f:
        meta = _json.load(f)
    files = [torch.load(_os.path.join(directory, f'rank{r}.pt'),
                        weights_only=False) for r in range(meta['world'])]
    out = {}
    for path, m in meta['leaves'].items():
        if not m['sharded']:
            out[path] = files[0][path]['data'].numpy()
            continue
        full = None
        for f in files:
            rec = f.get(path)
            if rec is None:
                continue
            local = rec['data'].numpy()
            if full is None:
                full = _np.empty(m['shape'], dtype=local.dtype)
            idx = [_indices(n, axes, blocks, rec['coords'], rec['sizes'])
                   for n, axes, blocks in zip(m['shape'], rec['spec'],
                                              rec['blocks'])]
            full[_np.ix_(*idx)] = local
        out[path] = full
    return out


def _place(value, like=None, ctx=None, spec=None):
    """A global numpy value placed as ``like`` (a template leaf: this
    rank's shard under its layout, on its device) or at ``spec`` on
    ``ctx``."""
    from ..ndarray.ndarray import NDArray
    from ..sharding.dispatch import Layout, cut, shard
    t = torch.from_numpy(_np.ascontiguousarray(value))
    if ctx is not None:
        from ..sharding.rules import resolve_spec
        lay = Layout(ctx, resolve_spec(spec, t.shape, ctx), t.shape)
        return shard(cut(t, lay).clone(), lay) if lay.sharded \
            else NDArray(t)
    tt, lay = _leaf(like)
    t = t.to(tt.device, tt.dtype)
    if lay is not None:
        lay = lay.replace(spec=lay.spec, blocks=lay.blocks)
        return shard(cut(t, lay).clone(), lay)
    if torch.is_tensor(like):
        return t
    return NDArray(t)


def save_sharded(directory, tree, force=True):
    """Write ``tree`` (a dict, possibly nested, of NDArrays, sharded or
    not, Parameters, tensors or arrays) under ``directory``, every rank
    its own shards; the ranks call it together. ``force`` replaces an
    existing checkpoint."""
    directory = _os.path.abspath(directory)
    if _world()[1] == 0 and force:
        _shutil.rmtree(directory, ignore_errors=True)
    _barrier()
    _write(directory, tree)


def restore_sharded(directory, template=None, mesh=None, specs=None):
    """Read a checkpoint of :func:`save_sharded`:

    * ``template`` (a tree like the saved one): each leaf placed as the
      template's (this rank's shard under its layout, on its device);
    * ``mesh`` (a ``ShardingContext`` or ``DeviceMesh``) and ``specs`` (a
      tree of PartitionSpecs): each leaf this rank's shard at its spec
      (``resolve_spec``'d: an axis that does not divide replicates);
    * neither: host numpy arrays.
    """
    flat = _read(_os.path.abspath(directory))
    if template is None and specs is None:
        return _unflatten(flat)
    if template is not None:
        tmpl = _flatten(template)
        return _unflatten({p: _place(v, like=tmpl[p])
                           for p, v in flat.items()})
    from .sharded import _context
    ctx = _context(mesh)
    sp = _flatten(specs)
    return _unflatten({p: _place(v, ctx=ctx, spec=sp[p])
                       for p, v in flat.items()})


class SharedCheckpointManager:
    """Step-based checkpoint rotation with a crash-atomic commit protocol
    (the reference's, over :func:`save_sharded`'s format).

    ``save(step, tree)`` keeps at most ``max_to_keep`` checkpoints;
    ``restore()`` reads the latest (or a given step). A kill at any point
    leaves ``latest_step()`` on the previous complete checkpoint:

    1. every rank writes to ``<dir>/.staging-<step>``,
    2. rank 0 renames it to ``<dir>/<step>`` (``os.replace``),
    3. rewrites the manifest (``.MANIFEST.tmp``, ``fsync``, ``os.replace``
       to ``MANIFEST.json``, a directory fsync),
    4. prunes the steps dropped from the manifest.

    ``latest_step()``/``all_steps()`` read only the manifest (or, without
    one, the integer step directories); staging left by a crashed save is
    swept at construction. The ranks of a world call ``save`` together;
    the others wait for rank 0's commit."""

    MANIFEST = 'MANIFEST.json'

    def __init__(self, directory, max_to_keep=5):
        self._dir = _os.path.abspath(directory)
        self._keep = int(max_to_keep) if max_to_keep else 0
        _os.makedirs(self._dir, exist_ok=True)
        if _world()[1] == 0:
            try:
                names = _os.listdir(self._dir)
            except OSError:
                names = []
            for n in names:
                p = _os.path.join(self._dir, n)
                if n.startswith('.staging-') or n == '.MANIFEST.tmp':
                    if _os.path.isdir(p):
                        _shutil.rmtree(p, ignore_errors=True)
                    else:
                        _os.unlink(p)

    def _manifest_steps(self):
        path = _os.path.join(self._dir, self.MANIFEST)
        try:
            with open(path, encoding='utf-8') as f:
                return sorted(int(s) for s in _json.load(f)['steps'])
        except (OSError, ValueError, KeyError, TypeError):
            pass
        if _os.path.exists(path):
            return []
        try:
            names = _os.listdir(self._dir)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and _os.path.isdir(_os.path.join(self._dir, n)))

    def _write_manifest(self, steps):
        tmp = _os.path.join(self._dir, '.MANIFEST.tmp')
        blob = _json.dumps({'steps': sorted(steps),
                            'latest': max(steps) if steps else None})
        with open(tmp, 'w', encoding='utf-8') as f:
            f.write(blob)
            f.flush()
            _os.fsync(f.fileno())
        _os.replace(tmp, _os.path.join(self._dir, self.MANIFEST))
        try:
            dfd = _os.open(self._dir, _os.O_RDONLY)
            try:
                _os.fsync(dfd)
            finally:
                _os.close(dfd)
        except OSError:
            pass                # a platform without directory fsync

    def save(self, step, tree):
        step = int(step)
        staging = _os.path.join(self._dir, f'.staging-{step}')
        final = _os.path.join(self._dir, str(step))
        primary = _world()[1] == 0
        if primary:
            _shutil.rmtree(staging, ignore_errors=True)
        _barrier()
        _write(staging, tree)
        _crash_point('ckpt.staged')
        if primary:
            committed = self._manifest_steps()
            if step in committed:
                # un-commit a step being saved again first, so that a kill
                # before the rename never leaves the manifest naming a
                # deleted directory
                self._write_manifest([s for s in committed if s != step])
            _shutil.rmtree(final, ignore_errors=True)
            _crash_point('ckpt.cleared')
            _os.replace(staging, final)
            _crash_point('ckpt.renamed')
            steps = sorted([s for s in self._manifest_steps() if s != step]
                           + [step])
            dropped = steps[:-self._keep] if self._keep else []
            kept = steps[-self._keep:] if self._keep else steps
            self._write_manifest(kept)
            _crash_point('ckpt.committed')
            for s in dropped:
                _shutil.rmtree(_os.path.join(self._dir, str(s)),
                               ignore_errors=True)
        _barrier()

    def restore(self, step=None, template=None, mesh=None, specs=None):
        if step is None:
            step = self.latest_step()
        if step is None:
            raise ValueError(f'no committed checkpoint under {self._dir}')
        return restore_sharded(_os.path.join(self._dir, str(int(step))),
                               template=template, mesh=mesh, specs=specs)

    def step_metadata(self, step):
        """``{path: {'shape', 'dtype', 'sharded'}}`` of the checkpoint at
        ``step`` (None when unreadable)."""
        try:
            with open(_os.path.join(self._dir, str(int(step)), 'meta.json'),
                      encoding='utf-8') as f:
                return _json.load(f)['leaves']
        except (OSError, ValueError, KeyError):
            return None

    def latest_step(self):
        """Newest committed step, read from the manifest only."""
        steps = self._manifest_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        return self._manifest_steps()

    def close(self):
        """Kept for the reference's API: the manager holds nothing open."""


def save_params_sharded(directory, block):
    """A Gluon block's parameters, every rank its shards (the sharded
    counterpart of ``save_parameters``)."""
    save_sharded(directory, dict(block.collect_params()))


def load_params_sharded(directory, block, mesh=None, specs=None):
    """Restore into an initialized block: each parameter keeps its current
    placement (this rank's shard, where it is sharded), or with ``mesh``
    and ``specs`` takes the global values to shard later."""
    params = dict(block.collect_params())
    values = restore_sharded(directory)
    for name, p in params.items():
        p.set_data(_np.asarray(values[name]))
    del mesh, specs
    return block


def restore_or_init(manager, init_fn, template=None):
    """Resume from the newest checkpoint, or start cold: ``(tree, step)``
    is the restored state and its step, or ``(init_fn(), -1)``. The
    template (default none: host numpy) decides the placement, so a
    checkpoint written on one mesh resumes on another."""
    latest = manager.latest_step()
    if latest is None:
        return init_fn(), -1
    return manager.restore(latest, template=template), latest
