"""``gluon.Trainer`` of the port: applies an :mod:`..optimizer` to a set of
Gluon :class:`.Parameter`s (``net.collect_params()``) or
``torch.nn.Parameter``s (the ``torch.nn`` Llama's) on one device.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (``__init__``,
``learning_rate``, ``set_learning_rate``, ``step``, ``allreduce_grads``,
``update``, the dense branch of ``_update`` with its fused update, the
kvstore path ``_init_kvstore``/``_init_params``/``_allreduce_grads`` and
``state_dict``/``load_state_dict``/``save_states``/``load_states``).
``step(batch_size)`` rescales the gradients by ``1 / batch_size``
(``rescale_grad``), reduces them through the kvstore and runs the
optimizer once per parameter; Adam and SGD with momentum each launch their
fused kernel once per parameter. Row-sparse gradients are not ported yet
(ROADMAP A3 rest). ``mx.amp.unscale`` arms
``_amp_skip_update`` after a gradient overflow, and the next step then
updates nothing, as the reference's ``_update`` skips
(``mxnet_tpu/gluon/trainer.py:234-237``): no weight, slot or update count
moves, and no captured update graph replays.

The kvstore (``mxnet_tpu/gluon/trainer.py:82-221``) is made at the first
step: ``kvstore='device'`` (the default) or ``'local'`` sums the gradients
of a parameter's replicas (``initialize(ctx=[...])``), ``'dist_sync'``
(``dist_tpu_sync``) also sums them over the processes of the default
``torch.distributed`` group, one rank a process, with rank 0's initial
weights broadcast to every rank first (``_init_params``). All dense
gradients go through one ``fused_pushpull`` with ``priority=-i``, which
writes the sums into the grad buffers in place, between ``backward()``
and the update. On a card the update is a captured graph (below) and the
collectives stay outside it: a collective under gloo cannot be captured
(it waits for the card on the host), and the transport refuses to run
inside a capture. With ``update_on_kvstore=True`` the kvstore runs the
optimizer on its own copy of the weights (under ``dist_sync`` with more
than one process, the ZeRO-1 update: each key on its owner rank) and
writes them into the parameters; ``_update`` then skips, and
``save_states``/``load_states`` go through the kvstore's updater.
``compression_params`` turn on the kvstore's 2-bit compression. With one
process, one replica a parameter, no compression and no update on the
kvstore, the reduction is the identity and is skipped.

``kvstore='dist_async'`` (the parameter server) is made on the
parameters' context, so its server updates on their card. It has no
fused path: each parameter is one ``pushpull`` (``priority=-i``), as in
the JAX Trainer. Under ``update_on_kvstore=True`` the first step sends
the optimizer to the server (pickled without its parameters or any
tensor), and every step pushes the gradients and pulls the updated
weights into the parameters in place; no update graph is captured.
``update_on_kvstore`` left to None means False, as in the JAX Trainer,
which then pushes each gradient into the server's copy of the weights
and takes the sum back as the gradient (ROADMAP C10); the port does the
same, so this store is never skipped.

A weight that is not fp32 (a net cast to bf16) is updated by the plain
version of its optimizer's kernel, in fp32, and its slots are fp32
from the start (``Optimizer.create_state_multi_precision``).

The JAX Trainer runs every parameter's update as one jitted call whose
hyperparameters are device vectors, uploaded only when they change
(``trainer.py:412-415``, :497-533). Here the step's ``lr``, ``wd`` and
update counts ``t`` live in static device buffers (one set for each set
of live parameters): ``lr`` and ``wd`` are uploaded when their values
change, and a uniform advance of ``t`` is one device add; the optimizer
computes its bias corrections from ``t`` on the card
(``Optimizer.fill_hyper``), and every kernel reads its row. On a card the
updates of all live Gluon parameters are one CUDA graph
(``_graphs.StepGraph``) for each key: the JAX key (the optimizer,
``rescale_grad``, ``clip_gradient``, shapes and dtypes) and the addresses
of the weights, grad buffers and slots, which all keep theirs. A key's
first step is the capture's warm-up and the real update, and its later
steps replay; ``capture_count`` counts captures. This holds for every
optimizer, SGLD and DCASGD too, where the JAX Trainer falls back to
per-parameter updates (``trainer.py:18``, :278; their steps do not trace
there): each of the port's updates is in place and reads its row, and the
graph registers the device's generator, so SGLD draws new noise on each
replay. A value written through
a handle (``p.data()[:] = v``, ``p.grad()[:] = 0``) is copied back into
the captured buffer before each step, and :meth:`load_states` writes the
slots and counts in place.

Under ``mx.sharding`` (the parameters placed by a hybridized call inside
a mesh; reference ``trainer.py:289``, :323, :363) the step is the
reference's sharded update in the port's one-process-a-rank form:

* each optimizer slot is split on ``dp`` by ``ShardingContext.zero1_spec``
  (ZeRO-1): this rank updates only its tile of the weight (a piece of its
  shard along the slot's split dim, copied once where it is not
  contiguous), through B5 for Adam and B6 for SGD with momentum;
* the gradients of the tiled parameters are summed over ``dp`` by one
  reduce-scatter that gives this rank the sum on its tiles only, and one
  all-gather over ``dp`` of the updated tiles writes every rank's weights
  (``kvstore.fusion.zero1_exchange``, the exchange of
  ``zero1_update_in_axis``); so after :meth:`step` such a parameter's
  gradient holds this rank's part, where :meth:`allreduce_grads` sums it
  whole in place before :meth:`update`;
* the gradients of the other parameters that are not split on the data
  axis are summed over it whole (one all-reduce); those split on it were
  summed by their gather's backward already.

The JAX package turns its Pallas optimizer kernels off under a mesh and
lets XLA partition the update (``ops/pallas/fused_optimizer.py:38-53``);
here the kernels run on the tiles, a difference by design. The sharded
update runs eagerly (the collectives stay out of any captured graph), and
the kvstore is not used. :meth:`Trainer.sharded_states` gives the slots as
sharded NDArrays, for ``parallel.checkpoint``.

A Gluon parameter is updated as the JAX Trainer updates it
(``mxnet_tpu/gluon/trainer.py:241-243``): every one whose ``grad_req`` is
not ``'null'`` and that is initialized, with whatever its grad buffer
holds (zeros for a parameter no backward reached, such as BERT's pooler
under an MLM loss), and with its ``lr_mult`` and ``wd_mult``. Its buffer
follows ``grad_req`` (the autograd hook overwrites it for ``'write'``),
so a loop needs no ``zero_grad``.

A ``torch.nn.Parameter`` has no grad buffer, only ``.grad``, into which
PyTorch's ``backward`` accumulates. So :meth:`Trainer.step` (and
:meth:`Trainer.update`) set the ``.grad`` of every such parameter it
updated to ``None`` after the update: the next backward writes a fresh
gradient, as MXNet's ``grad_req='write'`` does, and one without a
gradient since the last step raises unless ``ignore_stale_grad``. Since
PyTorch gives such a parameter a new ``.grad`` on every backward, a graph
could not read it at one address: these parameters (the ``torch.nn``
Llama's) keep one launch each from Python, reading the same device
vectors.
"""

import copy
import math
import pickle
import re

import numpy as np
import torch

from .. import _graphs, _rng
from ..base import MXNetError
from .. import optimizer as opt
from ..kvstore import create as _create_kvstore
from ..kvstore.base import KVStoreBase
from ..ndarray.ndarray import context_of
from ..ops.kernels.fused_optimizer import hyper_vector
from ..optimizer import states_into, states_to_host
from .parameter import Parameter

__all__ = ['Trainer']


def _jax_name(name):
    """The JAX package's name of a port parameter: Gluon names the i-th
    block of a list ``layers{i}``, ``torch.nn.ModuleList`` ``layers.{i}``
    (the inverse of the renaming in ``llama.from_jax_params``)."""
    return re.sub(r'\.(\d+)(?=\.)', r'\1', name)


class Trainer:
    """Apply ``optimizer`` (a name or an :class:`..optimizer.Optimizer`)
    to ``params``: a dict of named parameters (``net.collect_params()``,
    ``dict(net.named_parameters())``) or a list of them, all on the same
    contexts, their gradients reduced through ``kvstore`` (a name or a
    KVStore)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore='device', compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            names, params = list(params), list(params.values())
        elif isinstance(params, (list, tuple)):
            names, params = None, list(params)
        else:
            raise ValueError('params must be a dict/list of Parameters')
        for param in params:
            if not isinstance(param, (Parameter, torch.nn.Parameter)):
                raise ValueError(f'invalid parameter {param!r}')
        self._params = params
        self._names = names
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params or {})
        self._scale = self._optimizer.rescale_grad
        self._compression_params = compression_params
        self._kvstore_params = {'kvstore': kvstore,
                                'update_on_kvstore': update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
        self._params_to_init = list(params)

    def _check_contexts(self):
        """The contexts every parameter is on (reference trainer.py:
        _check_contexts); raises when two differ."""
        contexts = None
        for i, param in enumerate(self._params):
            if isinstance(param, Parameter):
                if param._var is None and param._deferred_init is None:
                    continue
                ctx = param.list_ctx()
            else:
                ctx = [context_of(param.device)]
            if contexts is not None and contexts != ctx:
                name = self._names[i] if self._names else f'#{i}'
                raise MXNetError(
                    f'All Parameters must be initialized on the same set of '
                    f'contexts, but Parameter {name} is on {ctx} while '
                    f'previous ones are on {contexts}.')
            contexts = ctx
        return contexts or []

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError('optimizer_params must be None if '
                                 'optimizer is an instance')
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._states = {}
        self._vectors = {}      # live indices -> _Vectors
        self._graphs = {}       # key -> StepGraph of the Gluon updates
        self._tiles = {}        # index -> ZeRO-1 tile plan under a mesh
        self._tiles_mesh = None     # the fingerprint the plans are for
        self._grads_reduced = False

    # ---------------------------------------------------------------- kvstore
    def _init_kvstore(self):
        """Make the kvstore and decide ``update_on_kvstore`` (reference
        trainer.py:188): none without a kvstore name or contexts."""
        kv = self._kvstore_params['kvstore']
        if kv is None or kv == '' or not self._contexts:
            self._kvstore = None
            self._update_on_kvstore = False
        else:
            if isinstance(kv, KVStoreBase):
                self._kvstore = kv
            else:       # dist_async's server takes the parameters' device
                with self._contexts[0]:
                    self._kvstore = _create_kvstore(kv)
            if self._compression_params:
                self._kvstore.set_gradient_compression(
                    self._compression_params)
            self._update_on_kvstore = \
                bool(self._kvstore_params['update_on_kvstore'])
            if self._update_on_kvstore:
                self._kvstore.set_optimizer(self._optimizer)
        self._kv_initialized = True

    def _reduces(self):
        """True when the kvstore has work: more than one process or
        replica, compression, the update on the kvstore, or a parameter
        server (``dist_async``: its push adds into the store whatever the
        world, so it is never skipped, as in the JAX Trainer)."""
        kv = self._kvstore
        return kv is not None and (
            kv.type == 'dist_async' or kv.num_workers > 1
            or len(self._contexts) > 1 or self._update_on_kvstore
            or kv.gradient_compression.active)

    def _init_params(self):
        """Broadcast the initial weights: rank 0's value, first replica,
        into every replica of every rank (reference trainer.py:
        _init_params). Parameters whose initialization is still deferred
        wait for a later step."""
        waiting = []
        for param in self._params_to_init:
            if isinstance(param, Parameter) and param._var is None:
                if param._deferred_init is not None:
                    waiting.append(param)
                continue
            if self._reduces():
                vals = _datas(param)
                self._kvstore.broadcast(self._index(param), vals[0], vals)
        self._params_to_init = waiting

    def _index(self, param):
        return next(i for i, p in enumerate(self._params) if p is param)

    def _prepare_kvstore(self):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._params_to_init:
            self._init_params()

    def _allreduce_grads(self):
        """Reduce every dense gradient with one ``fused_pushpull``
        (reference trainer.py:385, ``priority=-i``): the sums go into the
        grad buffers in place, or, with ``update_on_kvstore``, the updated
        weights into the parameters."""
        if not self._reduces():
            return
        keys, grads, outs = [], [], []
        for i, param in enumerate(self._params):
            if isinstance(param, Parameter):
                if param.grad_req == 'null' or param._var is None:
                    continue
                g = param._grad_buffers()
            elif param.requires_grad and param.grad is not None:
                g = [param.grad]
            else:
                continue
            keys.append(i)
            grads.append(g)
            outs.append(_datas(param))
        if not keys:
            return
        if hasattr(self._kvstore, 'fused_pushpull'):
            self._kvstore.fused_pushpull(
                keys, grads, outs=outs if self._update_on_kvstore else None,
                priorities=[-i for i in keys])
            return
        # a store without the fused path (dist_async): one pushpull a key,
        # the weights pulled into the parameters under update_on_kvstore
        # (reference trainer.py:385 out=data), else the result into the
        # gradients, as the JAX Trainer does (trainer.py:212-219)
        for i, g, o in zip(keys, grads, outs):
            self._kvstore.pushpull(
                i, g, out=o if self._update_on_kvstore else None,
                priority=-i)

    # ------------------------------------------------------------ properties
    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def capture_count(self):
        """Update graphs captured (one a key; 0 on the CPU)."""
        return sum(g.captures for g in self._graphs.values())

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    # ------------------------------------------------------------------ step
    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients through the kvstore and update every
        parameter with ``rescale_grad = scale / batch_size`` (reference
        trainer.py:334)."""
        ctx = self._shard_ctx()
        if ctx is not None:
            self._optimizer.rescale_grad = self._scale / batch_size
            self._update_sharded(ctx)
            return
        self._check_and_rescale_grad(self._scale / batch_size)
        self._prepare_kvstore()
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def _check_and_rescale_grad(self, scale):
        if self._update_on_kvstore and self._kv_initialized and \
                self._kvstore is not None and \
                self._optimizer.rescale_grad != scale:
            raise UserWarning('Possible change in the `batch_size` from '
                              'previous `step` detected.')
        self._optimizer.rescale_grad = scale

    def allreduce_grads(self):
        """Reduce the gradients only (reference trainer.py:
        allreduce_grads); :meth:`update` then applies them."""
        ctx = self._shard_ctx()
        if ctx is not None:
            self._reduce_sharded(ctx, self._sharded_live())
            self._grads_reduced = True
            return
        self._prepare_kvstore()
        self._allreduce_grads()

    def update(self, batch_size, ignore_stale_grad=False):
        """Update without reducing (reference trainer.py:update)."""
        ctx = self._shard_ctx()
        if ctx is not None:
            self._optimizer.rescale_grad = self._scale / batch_size
            self._update_sharded(ctx, reduce=False)
            return
        self._prepare_kvstore()
        if self._update_on_kvstore:
            raise MXNetError('update() cannot be called when '
                             'update_on_kvstore is set')
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        if self._update_on_kvstore:
            # the kvstore's updater wrote the weights
            for param in self._params:
                if not isinstance(param, Parameter):
                    param.grad = None            # grad_req='write'
            return
        if getattr(self, '_amp_skip_update', False):
            # amp.unscale found an overflow: this step updates nothing
            self._amp_skip_update = False
            return
        live = []           # (index, weight, grad, torch.nn leaf or None)
        for i, param in enumerate(self._params):
            if isinstance(param, Parameter):
                if param.grad_req != 'null' and param._var is not None:
                    live.append((i, param._sync().detach(),
                                 param._grad_buffer(), None))
                continue
            if not param.requires_grad:          # grad_req='null'
                continue
            if param.grad is None:
                if ignore_stale_grad:
                    continue
                name = self._names[i] if self._names else f'#{i}'
                raise MXNetError(
                    f'Gradient of Parameter `{name}` has not been computed '
                    f'by backward since the last step; call step with '
                    f'ignore_stale_grad=True to skip it')
            live.append((i, param.detach(), param.grad, param))
        if not live:
            return
        optim = self._optimizer
        for i, weight, _, _ in live:
            if i not in self._states:
                self._states[i] = \
                    optim.create_state_multi_precision(i, weight)
        indices = tuple(i for i, _, _, _ in live)
        device = live[0][1].device
        vec = self._vectors.get(indices)
        if vec is None:
            vec = self._vectors[indices] = _Vectors(len(live), device,
                                                    optim.hyper_width)
        vec.upload(*optim.step_values(indices))
        rows = list(enumerate(live))
        graphed = [(j, e) for j, e in rows
                   if e[3] is None and _graphs.can_capture(device)]
        eager = [(j, e) for j, e in rows
                 if e[3] is not None or not _graphs.can_capture(device)]
        if graphed:
            self._graphed_update(vec, graphed, device)
        else:
            optim.fill_hyper(vec.hyper, vec.ts)
        with torch.no_grad():
            for j, (i, weight, grad, leaf) in eager:
                optim.step(weight, grad, self._states[i], vec.hyper[j])
                if leaf is not None:
                    leaf.grad = None             # grad_req='write'
            for i, weight, _, leaf in live:      # the other replicas
                if leaf is None:
                    for r in self._params[i]._replicas:
                        r.sync(self._params[i].grad_req).copy_(weight)

    # --------------------------------------------------------------- sharded
    def _shard_ctx(self):
        """The mesh of the parameters, where a hybridized call sharded
        them over more than one rank; else None."""
        for p in self._params:
            ctx = getattr(p, '_sharding_mesh', None)
            if ctx is not None and ctx.n_devices > 1:
                return ctx
        return None

    def _sharded_live(self):
        return [(i, p) for i, p in enumerate(self._params)
                if isinstance(p, Parameter) and p.grad_req != 'null'
                and p._var is not None]

    def _reduce_sharded(self, ctx, live):
        """Sum over ``dp`` the gradients not split on it: one
        all-reduce of them all, written back in place."""
        from ..sharding import _collectives as C
        dp = ctx.data_axis
        if dp is None:
            return
        grads = [p._grad_buffer() for _, p in live
                 if p._layout is None or dp not in p._layout.axes()]
        if not grads:
            return
        flat = C.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                            ctx.group(dp))
        off = 0
        with torch.no_grad():
            for g in grads:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()

    def _tile_plan(self, ctx, p):
        """``(dim, n, index)``: the piece of this rank's shard that its
        ZeRO-1 slots cover (``zero1_spec``'s new split), or None for the
        whole shard."""
        from ..sharding.rules import PartitionSpec as P
        dp = ctx.data_axis
        spec = p._sharding_spec if p._sharding_spec is not None else P()
        z = ctx.zero1_spec(spec, p.shape)
        if dp is None or tuple(z) == tuple(spec):
            return None
        ent = list(spec) + [None] * (len(p.shape) - len(spec))
        zent = list(z) + [None] * (len(p.shape) - len(z))
        d = next(k for k in range(len(p.shape)) if ent[k] != zent[k])
        return d, ctx.size(dp), ctx.coord(dp)

    def _tile(self, i, t, index=None):
        """Piece ``index`` (default: this rank's) of ``t`` by parameter
        ``i``'s ZeRO-1 tile plan; ``t`` itself when it has none."""
        from ..sharding._collectives import take
        plan = self._tiles.get(i)
        if plan is None:
            return t
        d, n, idx = plan
        return take(t, d, n, idx if index is None else index)

    def _update_sharded(self, ctx, reduce=True):
        """The sharded step: see the module docstring."""
        from ..kvstore.fusion import CrossProcess, zero1_exchange
        if getattr(self, '_amp_skip_update', False):
            self._amp_skip_update = False
            return
        live = self._sharded_live()
        if not live:
            return
        if self._tiles_mesh != ctx.fingerprint():
            if self._states:
                raise MXNetError(
                    'Trainer: the optimizer slots are split for another '
                    'mesh; make a new Trainer for this one')
            self._tiles_mesh = ctx.fingerprint()
        for i, p in live:
            if i not in self._tiles:
                self._tiles[i] = self._tile_plan(ctx, p)
        reduce = reduce and not self._grads_reduced
        self._grads_reduced = False
        tiled = [(i, p) for i, p in live if self._tiles[i] is not None]
        rest = [(i, p) for i, p in live if self._tiles[i] is None]
        if reduce:
            self._reduce_sharded(ctx, rest)
        if not tiled:
            self._step_shards(live, {})
            return
        n = ctx.size(ctx.data_axis)
        grads = [p._grad_buffer() for _, p in tiled]
        if reduce:
            packed = torch.cat([self._tile(i, g, r).reshape(-1)
                                for r in range(n)
                                for (i, _), g in zip(tiled, grads)])
        else:
            packed = torch.cat([self._tile(i, g).reshape(-1)
                                for (i, _), g in zip(tiled, grads)])
        shapes = [self._tile(i, g).shape for (i, _), g in zip(tiled, grads)]

        def update(g_flat):
            tiles, off = {}, 0
            for (i, _), shape in zip(tiled, shapes):
                m = math.prod(shape)
                tiles[i] = g_flat[off:off + m].view(shape)
                off += m
            self._step_shards(live, tiles)
            return torch.cat([self._tile(i, p._sync().detach()).reshape(-1)
                              for i, p in tiled])
        with torch.no_grad():
            rows = zero1_exchange(CrossProcess.get(ctx.group(ctx.data_axis)),
                                  packed, update, reduce)
            off = 0
            for (i, p), shape in zip(tiled, shapes):
                m = math.prod(shape)
                parts = [rows[r, off:off + m].view(shape) for r in range(n)]
                off += m
                p._sync().detach().copy_(torch.cat(parts, self._tiles[i][0]))

    def _step_shards(self, live, tiles):
        """The optimizer on this rank's tile (or whole shard) of every
        live parameter: the gradient is ``tiles[i]``, or the tile of its
        grad buffer."""
        optim = self._optimizer
        work = []
        for i, p in live:
            w = self._tile(i, p._sync().detach())
            g = tiles[i] if i in tiles else self._tile(i, p._grad_buffer())
            if i not in self._states:
                self._states[i] = optim.create_state_multi_precision(
                    i, w.contiguous())
            work.append((i, w, g))
        indices = tuple(i for i, _, _ in work)
        vec = self._vectors.get(indices)
        if vec is None:
            vec = self._vectors[indices] = _Vectors(
                len(work), work[0][1].device, optim.hyper_width)
        vec.upload(*optim.step_values(indices))
        optim.fill_hyper(vec.hyper, vec.ts)
        with torch.no_grad():
            for j, (i, w, g) in enumerate(work):
                if w.is_contiguous() and g.is_contiguous():
                    optim.step(w, g, self._states[i], vec.hyper[j])
                else:
                    wc = w.contiguous()
                    optim.step(wc, g.contiguous(), self._states[i],
                               vec.hyper[j])
                    w.copy_(wc)

    def sharded_states(self):
        """The optimizer slots as sharded NDArrays (each laid out as its
        parameter, split on ``dp`` where ZeRO-1 tiles it), by
        ``'{name}/{slot}'``; unsharded NDArrays outside a mesh."""
        from ..ndarray.ndarray import NDArray
        from ..sharding.dispatch import shard
        out = {}
        for i, st in self._states.items():
            p = self._params[i]
            name = self._names[i] if self._names else str(i)
            lay = self._slot_layout(i, p)
            for j, t in enumerate(_flat_state(st)):
                out[f'{name}/{j}'] = shard(t, lay) if lay is not None \
                    else NDArray(t)
        return out

    def load_sharded_states(self, values):
        """Restore the optimizer slots from global host values keyed as
        :meth:`sharded_states` gives them (``'{name}/{slot}'``), the
        inverse of that method: under a mesh each is cut to this rank's
        piece on the parameters' current mesh, which may differ from the
        mesh that wrote them (a checkpoint restored after the mesh
        re-formed); outside one each is the whole slot. A slot that exists
        with that shape is written in place (a captured update reads it
        there). The counters come from :meth:`load_state_dict`."""
        from ..sharding.dispatch import cut
        ctx = self._shard_ctx()
        if ctx is not None:
            if self._states and self._tiles_mesh != ctx.fingerprint():
                raise MXNetError('Trainer: the optimizer slots are split '
                                 'for another mesh; make a new Trainer for '
                                 'this one')
            self._tiles_mesh = ctx.fingerprint()
            live = self._sharded_live()
        else:
            live = [(i, p) for i, p in enumerate(self._params)
                    if isinstance(p, Parameter) and p.grad_req != 'null'
                    and p._var is not None]
        optim = self._optimizer
        for i, p in live:
            name = self._names[i] if self._names else str(i)
            slots = sorted((int(k.rsplit('/', 1)[1]), v)
                           for k, v in values.items()
                           if k.rsplit('/', 1)[0] == name)
            if not slots:
                continue
            if ctx is not None and i not in self._tiles:
                self._tiles[i] = self._tile_plan(ctx, p)
            lay = self._slot_layout(i, p) if ctx is not None else None
            state = self._states.get(i)
            srcs = []
            for _, v in slots:
                src = torch.from_numpy(np.ascontiguousarray(v))
                srcs.append(cut(src, lay) if lay is not None else src)
            have = _flat_state(state)
            if len(have) != len(srcs) or any(
                    t.shape != src.shape for t, src in zip(have, srcs)):
                w = self._tile(i, p._sync().detach())
                state = optim.create_state_multi_precision(
                    i, w.contiguous())
            with torch.no_grad():
                for t, src in zip(_flat_state(state), srcs):
                    t.copy_(src.to(t.device, t.dtype))
            self._states[i] = state
        for vec in self._vectors.values():
            vec.forget()

    def _slot_layout(self, i, p):
        lay = getattr(p, '_layout', None)
        plan = self._tiles.get(i)
        if plan is None:
            return lay
        ctx = p._sharding_mesh
        from ..sharding.dispatch import Layout
        if lay is None:
            lay = Layout(ctx, (), p.shape, param=True)
        d = plan[0]
        spec = list(lay.spec)
        blocks = list(lay.blocks)
        spec[d] = spec[d] + (ctx.data_axis,)
        blocks[d] = blocks[d] + (1,)
        return lay.replace(spec=spec, blocks=blocks)

    def _graphed_update(self, vec, graphed, device):
        """The Gluon parameters' updates as one graph a key (see the module
        docstring): a key's first step captures, later ones replay."""
        optim = self._optimizer
        slots = [_flat_state(self._states[e[0]]) for _, e in graphed]
        key = (id(optim), optim.rescale_grad, optim.clip_gradient,
               tuple((tuple(e[1].shape), str(e[1].dtype))
                     for _, e in graphed),
               tuple((e[1].data_ptr(), e[2].data_ptr()) for _, e in graphed),
               tuple(t.data_ptr() for s in slots for t in s),
               vec.hyper.data_ptr())
        graph = self._graphs.get(key)
        if graph is not None:
            graph.replay()
            return
        work = [(j, e[1], e[2], self._states[e[0]]) for j, e in graphed]

        def body():
            optim.fill_hyper(vec.hyper, vec.ts)
            with torch.no_grad():
                for j, weight, grad, state in work:
                    optim.step(weight, grad, state, vec.hyper[j])

        graph = self._graphs[key] = _graphs.step_graph(
            body, device, _rng.graph_generators(device))
        graph.capture()

    # ---------------------------------------------------------- save / load
    def state_dict(self, states=True):
        """The trainer's state as host data, in the JAX package's format
        (``trainer.py:564-591``): the slots by parameter index (numpy, or
        tuples of numpy), the global and per-index update counts, and the
        learning-rate scheduler's attributes. ``states=False`` leaves the
        slots out (``load_state_dict`` then keeps the Trainer's own; a
        checkpoint carries them as ``sharded_states()``)."""
        optim = self._optimizer
        sd = {'num_update': int(optim.num_update),
              'index_update_count': {
                  int(i): int(c)
                  for i, c in optim._index_update_count.items()}}
        if states:
            sd['states'] = {i: states_to_host(st)
                            for i, st in self._states.items()}
        sch = getattr(optim, 'lr_scheduler', None)
        if sch is not None:
            sd['lr_scheduler'] = copy.deepcopy(sch.__dict__)
        return sd

    def load_state_dict(self, sd):
        """Restore :meth:`state_dict`'s data (from either package): the
        next step is the uninterrupted trainer's. Slots that exist are
        written in place, so that a captured update reads them; the device
        vectors are uploaded anew at the next step. Without ``'states'``
        (``state_dict(states=False)``) the slots stay as they are."""
        if 'states' in sd:
            states = {}
            for i, st in sd['states'].items():
                i = int(i)
                states[i] = states_into(st, self._states.get(i),
                                        _device(self._params[i]))
            self._states = states
        optim = self._optimizer
        optim.num_update = int(sd['num_update'])
        optim._index_update_count = {
            int(i): int(c)
            for i, c in sd.get('index_update_count', {}).items()}
        sch = getattr(optim, 'lr_scheduler', None)
        if sch is not None and 'lr_scheduler' in sd:
            sch.__dict__.update(sd['lr_scheduler'])
        for vec in self._vectors.values():
            vec.forget()

    def save_states(self, fname):
        """Reference trainer.py:482, as the JAX package pickles it
        (version 2); with ``update_on_kvstore`` the kvstore's updater
        states (rank-local under ZeRO-1)."""
        self._prepare_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=False)
            return
        with open(fname, 'wb') as f:
            pickle.dump({'version': 2, **self.state_dict()}, f)

    def load_states(self, fname):
        """Reference trainer.py:511: a file :meth:`save_states` of either
        package wrote, or the legacy ``(states, num_update)`` pickle; with
        ``update_on_kvstore`` the kvstore's updater states."""
        self._prepare_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, 'rb') as f:
            payload = pickle.load(f)
        if isinstance(payload, dict):
            self.load_state_dict(payload)
            return
        states, num_update = payload
        self.load_state_dict({'states': states, 'num_update': num_update,
                              'index_update_count': dict(
                                  self._optimizer._index_update_count)})

    # ---------------------------------------------------------- carry over
    def load_jax_state(self, states, counts):
        """Take over a JAX ``Trainer``'s optimizer state, as plain numpy.

        ``states`` maps the JAX package's parameter names
        (``model.layers0.self_attn.q_proj.weight``, ...) to the slots of
        that parameter, as the JAX Trainer's ``_states[i]`` holds them:
        Adam's ``(m, v)``, SGD-momentum's ``mom``, ``None`` for none.
        ``counts`` maps names to the update count ``t``
        (``optimizer._index_update_count[i]``), which Adam's bias
        correction reads. The Trainer must have been built from a dict of
        named parameters."""
        if self._names is None:
            raise MXNetError('load_jax_state needs a Trainer built from a '
                             'dict of named parameters')
        index = {_jax_name(n): i for i, n in enumerate(self._names)}
        unknown = sorted((set(states) | set(counts)) - set(index))
        if unknown:
            raise KeyError(f'no parameter of this Trainer is named '
                           f'{unknown}')
        for name, state in states.items():
            param = self._params[index[name]]
            self._states[index[name]] = _state_to_torch(name, state, param)
        optim = self._optimizer
        for name, t in counts.items():
            optim._index_update_count[index[name]] = int(t)
        optim.num_update = max([optim.num_update,
                                *optim._index_update_count.values()])
        for vec in self._vectors.values():
            vec.forget()


def _datas(param):
    """Every replica's weight tensor of a parameter, the first context's
    first."""
    if isinstance(param, Parameter):
        return param._datas()
    return [param.detach()]


def _device(param):
    """The device of a parameter; None for a Gluon parameter whose
    initialization is still deferred."""
    if isinstance(param, Parameter):
        return None if param._var is None else param._var.device
    return param.device


class _Vectors:
    """The device vectors of one set of live indices: ``hyper`` (``n x
    width``: ``lr``, ``wd``, ``bc1``, ``bc2`` and the optimizer's other
    functions of ``t``; the kernels read its rows) and the update counts
    ``ts``, with the host values last uploaded."""

    def __init__(self, n, device, width=4):
        self.hyper = torch.ones(n, width, dtype=torch.float32,
                                device=device)
        self.ts = torch.zeros(n, dtype=torch.float32, device=device)
        self.forget()

    def forget(self):
        self.lr_wd = self.t_vals = None

    def upload(self, lrs, wds, ts):
        """Bring the buffers to this step's values: ``lr`` and ``wd`` only
        when they changed, ``t`` by one device add when every count
        advanced by one (the JAX Trainer's ``_hyper_cache`` and
        ``_t_cache``). Uploads go through pinned memory, without waiting
        for the card."""
        if (lrs, wds) != self.lr_wd:
            _upload(self.hyper[:, :2], list(zip(lrs, wds)))
            self.lr_wd = (lrs, wds)
        if ts != self.t_vals:
            if self.t_vals is not None and all(
                    a == b + 1 for a, b in zip(ts, self.t_vals)):
                self.ts.add_(1.0)
            else:
                _upload(self.ts, ts)
            self.t_vals = ts


def _upload(dst, values):
    dst.copy_(hyper_vector(values, dst.device))


def _flat_state(state):
    if state is None:
        return []
    if torch.is_tensor(state):
        return [state]
    return [t for t in state if torch.is_tensor(t)]


def _state_to_torch(name, state, param):
    if state is None:
        return None
    if isinstance(state, (list, tuple)):
        return tuple(_state_to_torch(name, s, param) for s in state)
    arr = np.asarray(state, dtype=np.float32)
    if arr.shape != tuple(param.shape):
        raise ValueError(f'{name}: state shape {arr.shape}, the parameter '
                         f'is {tuple(param.shape)}')
    return torch.tensor(arr, device=_device(param))
