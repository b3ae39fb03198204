"""The Llama family (decoder-only causal LM) on the port's Gluon.

Counterpart of ``mxnet_tpu/gluon/model_zoo/llama.py``, with its structure
and parameter names: every part is a ``HybridBlock`` (``RMSNorm``,
``LlamaAttention``, ``LlamaMLP``, ``LlamaBlock``, ``LlamaModel`` with its
blocks registered as ``layers{i}``, ``LlamaForCausalLM``), the projections
are ``nn.Dense(flatten=False, use_bias=False)`` and the embedding
``nn.Embedding``, so ``collect_params()`` gives the JAX package's names and
weights carry across by name (:func:`from_jax_params`). Pre-norm blocks
with RMSNorm, interleaved rotary position embeddings, grouped-query
attention and a SwiGLU MLP, with the reference's numerics.

The net is built and initialized as a Gluon net: ``net = llama3_8b()``,
``net.initialize(init, ctx=)`` (the current context, the card by default;
:class:`LlamaInit` draws the seeded N(0, 0.02) weights that the tests and
``chip_smoke.py`` use), ``net.hybridize()``, ``Trainer(
net.collect_params(), 'adam')``, ``quantization.quantize_net``,
``net.cast('bfloat16')``. :func:`load_hf_state_dict` and
:func:`from_hf_pretrained` load HuggingFace-named weights from local files
with no ``transformers`` (``pytorch_model*.bin`` through ``torch.load``,
``model*.safetensors`` through :func:`read_safetensors`, sharded
checkpoints through their ``*.index.json``).

The norms go through the registered ``rms_norm`` op (the fused norm kernel
on the card), the projections through ``fully_connected`` (the int8
kernel once quantized), the full-sequence attention through
``flash_attention`` and the paged decode through
``paged_attention_decode``; the embedding lookup, RoPE, SiLU and the
attention over a gathered cache are plain PyTorch, as the reference leaves
them to XLA. Where autograd records, the norm and flash ops run their
``autograd.Function``s, so ``loss.backward()`` reaches every parameter.

Added over the reference, for the card: the dense KV cache
(:meth:`LlamaForCausalLM.init_caches`, prefill, lockstep and per-slot
decode), the paged pool (``init_paged_pool``, per-slot decode, chunked
prefill), all run in place and with the offset as a tensor read on the
device, so that a CUDA graph can capture them; the RoPE tables built once
a forward; ``generate()``, which replays one captured decode step a token
on the card (``_DecodeLoop``, ``graph_captures``, ``release_graphs``).
The cached calls (``net(tokens, caches=..., offset=..., pages=...)``)
always run ``forward``, with every child inline, as the reference runs
them through its own ``_param_run`` program and not the block's cache: a
hybridized net captures only its calls without a cache.

Under ``mx.sharding`` with a ``tp`` axis the parameters are placed by the
registry's ``('llama', 'tp')`` rules (Megatron's layout): q, k, v, gate
and up column-parallel, o and down row-parallel (the registered dense op
sums over ``tp`` after them), ``embed_tokens`` and ``lm_head``
vocab-parallel (a masked lookup and a sum; logits of this rank's
vocabulary slice, which :meth:`LlamaForCausalLM.pick` reduces to the
global greedy token, ties to the lowest id). Attention runs on the local
heads, the GQA ratio kept (``llama3_8b`` at tp = 2 holds 16 of 32 query
and 4 of 8 KV heads a rank). A net initialized inside such a mesh draws
each parameter whole in turn and keeps only its shard, so no rank ever
holds the whole net.
"""

import glob
import json
import os

import numpy as np
import torch

from ... import _graphs, initializer
from ...ndarray.ndarray import NDArray
from ...ops.contrib import flash_attention, paged_attention_decode
from ...ops.registry import invoke
from ..block import HybridBlock, _Tracing
from ..parameter import Parameter
from .. import nn

__all__ = ['LlamaConfig', 'RMSNorm', 'LlamaAttention', 'LlamaMLP',
           'LlamaBlock', 'LlamaModel', 'LlamaForCausalLM', 'LlamaInit',
           'llama_tiny', 'llama2_7b', 'llama3_8b', 'get_llama',
           'from_jax_params', 'llama_partition_rules', 'load_hf_state_dict',
           'from_hf_pretrained', 'read_safetensors']

_NEG_INF = -1e30


class LlamaConfig:
    """Architecture hyperparameters. ``rope_theta`` is 1e4 for Llama-2
    lineage, 5e5 for Llama-3 (long-context)."""

    def __init__(self, vocab_size=32000, units=4096, num_layers=32,
                 num_heads=32, num_kv_heads=None, hidden_size=11008,
                 max_length=4096, rope_theta=10000.0, rms_norm_eps=1e-5,
                 tie_word_embeddings=False):
        self.vocab_size = vocab_size
        self.units = units
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.hidden_size = hidden_size
        self.max_length = max_length
        self.rope_theta = rope_theta
        self.rms_norm_eps = rms_norm_eps
        self.tie_word_embeddings = tie_word_embeddings
        if units % num_heads or self.num_heads % self.num_kv_heads:
            raise ValueError(
                f'units {units} must split over {num_heads} heads and the '
                f'heads over {self.num_kv_heads} KV heads')


class LlamaInit(initializer.Initializer):
    """The port's seeded Llama weights: N(0, ``sigma``) for every
    projection and embedding, drawn in turn (``collect_params()`` order)
    from one ``torch.Generator`` seeded with ``seed`` on each device, and
    1 for the norm weights. ``net.initialize(LlamaInit(seed))`` gives the
    same values for the same seed on the same device, whole or sharded."""

    def __init__(self, seed=0, sigma=0.02):
        super().__init__(seed=seed, sigma=sigma)
        self._seed = int(seed)
        self._sigma = float(sigma)
        self._gens = {}

    def _init_weight(self, desc, arr):
        t = arr._data
        if str(desc).endswith('norm.weight'):
            self._init_one(desc, arr)
            return
        gen = self._gens.get(t.device)
        if gen is None:
            gen = self._gens[t.device] = torch.Generator(
                device=t.device).manual_seed(self._seed)
        with torch.no_grad():
            t.normal_(0.0, self._sigma, generator=gen)


def llama_partition_rules(axis='tp'):
    """Megatron tensor-parallel rules for the Llama (JAX ``llama.py:518``):
    the registry's ``('llama', 'tp')`` table with ``axis`` for ``tp``."""
    from ...sharding import rules as _rules
    P = _rules.PartitionSpec
    return [(pat, P(*(axis if e == 'tp' else e for e in spec)))
            for pat, spec in _rules.rules_for('llama', 'tp')]


def _raw(x):
    return x._data if isinstance(x, NDArray) else x


def _like(t, nd):
    """``t`` (this rank's piece) as an NDArray laid out as ``nd``."""
    lay = getattr(nd, '_layout', None)
    if lay is None:
        return NDArray(t)
    from ...sharding import dispatch
    return dispatch.shard(t, lay)


class RMSNorm(HybridBlock):
    """Root-mean-square norm (no mean subtraction, no bias)."""

    def __init__(self, units, epsilon=1e-5):
        super().__init__()
        self._eps = epsilon
        self.weight = Parameter('weight', shape=(units,),
                                init=initializer.One())

    def forward(self, x):
        return invoke('rms_norm', (x, self.weight.data()), {'eps': self._eps})


def _positions(offset, S, device):
    """Absolute positions ``offset .. offset + S - 1`` as a long tensor,
    for a Python int ``offset`` or a 0-dim tensor one (read on the device,
    with no host sync, so that a CUDA graph can capture it)."""
    if torch.is_tensor(offset):
        return offset.to(device, torch.long) + torch.arange(S, device=device)
    return int(offset) + torch.arange(S, device=device)


def _rope_tables(S, Dh, theta, offset, device):
    """The cos and sin tables of rotary position embeddings for ``S``
    positions from ``offset``, each ``(1|B, S, 1, Dh/2)`` fp32: ``offset``
    is a scalar (an int or a 0-dim tensor; prefill, lockstep decode) or a
    ``(B,)`` tensor of per-row positions (per-slot decode). Built once a
    forward and shared by every layer's q and k."""
    f32 = torch.float32
    inv = 1.0 / (theta ** (torch.arange(0, Dh, 2, dtype=f32,
                                        device=device) / Dh))
    off = torch.as_tensor(_raw(offset), dtype=f32, device=device)
    pos = torch.atleast_1d(off)[:, None] \
        + torch.arange(S, dtype=f32, device=device)
    ang = pos[..., None] * inv[None, None, :]          # (1|B, S, Dh/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def _rope(x, cos, sin):
    """Rotary position embeddings on (B, S, H, Dh) from
    :func:`_rope_tables`, interleaved even/odd pairs as in the
    reference."""
    xf1 = x[..., ::2].float()
    xf2 = x[..., 1::2].float()
    r1 = xf1 * cos - xf2 * sin
    r2 = xf2 * cos + xf1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


class LlamaAttention(HybridBlock):
    """Grouped-query attention with RoPE."""

    def __init__(self, cfg):
        super().__init__()
        self._h = cfg.num_heads
        self._kv = cfg.num_kv_heads
        self._dh = cfg.units // cfg.num_heads
        self._theta = cfg.rope_theta
        u = cfg.units
        self.q_proj = nn.Dense(self._h * self._dh, use_bias=False,
                               flatten=False, in_units=u)
        self.k_proj = nn.Dense(self._kv * self._dh, use_bias=False,
                               flatten=False, in_units=u)
        self.v_proj = nn.Dense(self._kv * self._dh, use_bias=False,
                               flatten=False, in_units=u)
        self.o_proj = nn.Dense(u, use_bias=False, flatten=False,
                               in_units=self._h * self._dh)

    def _heads(self):
        """The query and KV heads this rank holds (all of them unless the
        projections are split on ``tp``)."""
        def rows(dense):
            p = dense.weight if hasattr(dense, 'weight') else dense.qweight
            n = p._var.shape[0] if p._var is not None else p.shape[0]
            return n // self._dh
        return rows(self.q_proj), rows(self.k_proj)

    def forward(self, x, cache=None, offset=0, pages=None, rope=None):
        """Without ``cache``: causal attention over the sequence (flash
        kernel). With ``cache``, new K/V are written into it IN PLACE
        (index assignment; the reference donates the cache to a jitted
        step instead) and ``(out, cache)`` is returned.

        ``cache`` is either the dense per-row cache ``(k, v)``, each
        ``(B, max_length, kv_heads, dh)`` (``init_caches``), or, with
        ``pages`` the int32 block table ``(B, pages_per_seq)``, the global
        page pool ``(num_pages, page_size, kv_heads, dh)``
        (``init_paged_pool``), where logical position ``p`` of row ``b``
        lives at ``pool[pages[b, p // page_size], p % page_size]``.

        * per-slot decode: ``offset`` a ``(B,)`` tensor, S == 1; row b
          writes at ``offset[b]`` and attends positions ``<= offset[b]``
          (through the paged decode kernel on the pool);
        * scalar ``offset`` (prefill, lockstep decode): query i sits at
          absolute position ``offset + i`` and attends positions up to
          it. On the pool this is chunked prefill (B == 1), over the
          row's cache gathered out of the pool. A 0-dim int tensor
          ``offset`` is read on the device (no host sync), as a CUDA
          graph needs; a Python int is bounds-checked on the dense cache.

        ``rope`` is the ``(cos, sin)`` pair of :func:`_rope_tables` for
        these positions (``LlamaModel`` builds it once a forward); without
        it the layer builds its own.

        The heads are this rank's (the projections' local rows under
        ``tp``). The kernels take q, k, v as they come, fp32 or bf16, and
        return q's dtype, as the reference's kernels do. The caches keep
        their own dtype: the per-slot decode takes q in the pool's, and
        the gathered attention over a cache runs in fp32 and returns the
        input's dtype, as in the reference."""
        qn = self.q_proj(x)
        q, k, v = qn._data, self.k_proj(x)._data, self.v_proj(x)._data
        B, S = q.shape[0], q.shape[1]
        H, KV = q.shape[-1] // self._dh, k.shape[-1] // self._dh
        q = q.reshape(B, S, H, self._dh)
        k = k.reshape(B, S, KV, self._dh)
        v = v.reshape(B, S, KV, self._dh)
        dev = q.device
        if rope is None:
            rope = _rope_tables(S, self._dh, self._theta, offset, dev)
        q = _rope(q, *rope)
        k = _rope(k, *rope)
        rep = H // KV
        offset = _raw(offset)
        pages = _raw(pages)

        if cache is None:
            if rep > 1:
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True)
            out = out.transpose(1, 2).reshape(B, S, H * self._dh)
            return self.o_proj(_like(out, qn))

        k_cache, v_cache = cache
        per_slot = torch.is_tensor(offset) and offset.dim() == 1
        if per_slot and S != 1:
            raise ValueError('per-slot offsets decode one token per step')
        if pages is not None:
            psz = k_cache.shape[1]
            L = pages.shape[1] * psz
            if per_slot:
                off = offset.long()
                pid = pages[torch.arange(B, device=dev), off // psz].long()
                k_cache[pid, off % psz] = k[:, 0].to(k_cache.dtype)
                v_cache[pid, off % psz] = v[:, 0].to(v_cache.dtype)
                out = paged_attention_decode(
                    q[:, 0].to(k_cache.dtype), k_cache, v_cache, pages,
                    offset.to(torch.int32).contiguous(),
                    sm_scale=self._dh ** -0.5)
                out = out.to(q.dtype).reshape(B, S, H * self._dh)
                return self.o_proj(_like(out, qn)), (k_cache, v_cache)
            if B != 1:
                raise ValueError('chunked prefill fills one sequence')
            pos = _positions(offset, S, dev)
            pid = pages[0, pos // psz].long()
            k_cache[pid, pos % psz] = k[0].to(k_cache.dtype)
            v_cache[pid, pos % psz] = v[0].to(v_cache.dtype)
            idx = pages.long()
            kf = k_cache[idx].reshape(B, L, KV, self._dh)
            vf = v_cache[idx].reshape(B, L, KV, self._dh)
        else:
            L = k_cache.shape[1]
            if per_slot:
                rows = torch.arange(B, device=dev)
                k_cache[rows, offset.long()] = k[:, 0].to(k_cache.dtype)
                v_cache[rows, offset.long()] = v[:, 0].to(v_cache.dtype)
            elif torch.is_tensor(offset):
                pos = _positions(offset, S, dev)
                k_cache[:, pos] = k.to(k_cache.dtype)
                v_cache[:, pos] = v.to(v_cache.dtype)
            else:
                o = int(offset)
                if o < 0 or o + S > L:
                    raise ValueError(f'positions {o}..{o + S - 1} outside '
                                     f'the cache of length {L}')
                k_cache[:, o:o + S] = k.to(k_cache.dtype)
                v_cache[:, o:o + S] = v.to(v_cache.dtype)
            kf, vf = k_cache, v_cache
        if rep > 1:
            kf = kf.repeat_interleave(rep, dim=2)
            vf = vf.repeat_interleave(rep, dim=2)
        scores = torch.einsum('bshd,blhd->bhsl', q.float(),
                              kf.float()) * (self._dh ** -0.5)
        keys = torch.arange(L, device=dev)
        if per_slot:
            # row b's single query (position offset[b]) sees slots <= it
            mask = (keys[None, :] <= offset.long()[:, None])[:, None, None]
        else:
            qpos = _positions(offset, S, dev)
            mask = (keys[None, :] <= qpos[:, None])[None, None]
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum('bhsl,blhd->bshd', probs,
                           vf.float()).to(_raw(x).dtype)
        out = out.reshape(B, S, H * self._dh)
        return self.o_proj(_like(out, qn)), (k_cache, v_cache)


class LlamaMLP(HybridBlock):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, cfg):
        super().__init__()
        u, f = cfg.units, cfg.hidden_size
        self.gate_proj = nn.Dense(f, use_bias=False, flatten=False,
                                  in_units=u)
        self.up_proj = nn.Dense(f, use_bias=False, flatten=False,
                                in_units=u)
        self.down_proj = nn.Dense(u, use_bias=False, flatten=False,
                                  in_units=f)

    def forward(self, x):
        gate = invoke('silu', (self.gate_proj(x),), {})
        return self.down_proj(gate * self.up_proj(x))


class LlamaBlock(HybridBlock):
    """Pre-norm decoder block."""

    def __init__(self, cfg):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.units, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.units, cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, cache=None, offset=0, pages=None, rope=None):
        with _Tracing():
            if cache is None:
                x = x + self.self_attn(self.input_layernorm(x), rope=rope)
                return x + self.mlp(self.post_attention_layernorm(x))
            att, cache = self.self_attn(self.input_layernorm(x), cache=cache,
                                        offset=offset, pages=pages,
                                        rope=rope)
            x = x + att
            return x + self.mlp(self.post_attention_layernorm(x)), cache


def _tokens(token_ids):
    """Token ids as an NDArray (a tensor, an array or a nested list)."""
    if isinstance(token_ids, NDArray):
        return token_ids
    if not torch.is_tensor(token_ids):
        token_ids = torch.as_tensor(np.asarray(token_ids))
    return NDArray(token_ids)


class LlamaModel(HybridBlock):
    """Token embedding + decoder stack + final norm → hidden states."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.units)
        self.layers = []
        for i in range(cfg.num_layers):
            blk = LlamaBlock(cfg)
            self.register_child(blk, f'layers{i}')
            self.layers.append(blk)
        self.norm = RMSNorm(cfg.units, cfg.rms_norm_eps)

    def forward(self, token_ids, caches=None, offset=0, pages=None):
        cfg = self.cfg
        with _Tracing():
            x = self.embed_tokens(_tokens(token_ids))
            # one set of RoPE tables for every layer's q and k
            rope = _rope_tables(x.shape[1], cfg.units // cfg.num_heads,
                                cfg.rope_theta, offset if caches is not None
                                else 0, x._data.device)
            if caches is None:
                for blk in self.layers:
                    x = blk(x, rope=rope)
                return self.norm(x)
            new_caches = []
            for blk, cache in zip(self.layers, caches):
                x, cache = blk(x, cache=cache, offset=offset, pages=pages,
                               rope=rope)
                new_caches.append(cache)
            return self.norm(x), new_caches


def _vocab_part(logits):
    """``logits``' tensor here (this rank's vocabulary slice when the last
    dim is split on a model axis) and that axis as ``(group, n, index)``,
    or None."""
    t = _raw(logits)
    lay = getattr(logits, '_layout', None)
    if lay is None or not lay.spec[-1]:
        return t, None
    axis = lay.spec[-1][0]
    ctx = lay.ctx
    return t, (ctx.group(axis), ctx.size(axis), ctx.coord(axis))


class LlamaForCausalLM(HybridBlock):
    """Decoder LM head: (B, S) int tokens → (B, S, vocab) logits.

    ``net(tokens)`` is the Gluon call (a hybridized net replays it from a
    CUDA graph on the card); ``net(tokens, caches=..., offset=...,
    pages=...)`` is a cached call, which always runs :meth:`forward` and
    returns ``(logits, caches)``. Tokens may be an NDArray, a tensor or an
    array. ``graph_captures`` counts the decode steps ``generate()``
    captured."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.model = LlamaModel(cfg)
        if not cfg.tie_word_embeddings:
            self.lm_head = nn.Dense(cfg.vocab_size, use_bias=False,
                                    flatten=False, in_units=cfg.units)
        self._decode_loops = {}     # generate()'s graphs, by key
        self.graph_captures = 0     # their captures, as compiles count

    def __call__(self, *args, **kwargs):
        if kwargs or len(args) > 1:
            return self.forward(*args, **kwargs)
        return super().__call__(*(_tokens(a) for a in args))

    def forward(self, token_ids, caches=None, offset=0, pages=None):
        with _Tracing():
            if caches is None:
                h = self.model(token_ids)
            else:
                h, caches = self.model(token_ids, caches=caches,
                                       offset=offset, pages=pages)
            if self.cfg.tie_word_embeddings:
                emb = self.model.embed_tokens.weight.data()
                logits = invoke('matmul', (h, emb.T), {})
            else:
                logits = self.lm_head(h)
        return logits if caches is None else (logits, caches)

    # --------------------------------------------------------------- state
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (the current context by
        default). Inside an ``mx.sharding`` mesh with a ``tp`` axis each
        parameter is drawn whole in turn and only this rank's shard is
        kept, by the context's rules."""
        from ...sharding import current
        mesh = current()
        if mesh is None or mesh.n_devices == 1:
            return super().initialize(init, ctx, verbose, force_reinit)
        self._ctx = ctx
        mesh.place_params(self, lambda p: p.initialize(
            init=init, ctx=ctx, force_reinit=force_reinit))
        return None

    def cast(self, dtype):
        self.release_graphs()       # they read the weights they had
        return super().cast(dtype)

    def reset_ctx(self, ctx):
        self.release_graphs()
        return super().reset_ctx(ctx)

    def _device(self):
        return self.model.embed_tokens.weight.data()._data.device

    def _sharded(self):
        return any(p._layout is not None
                   for p in self.collect_params().values())

    def _kv_heads(self):
        """KV heads of a cache here: this rank's share under ``tp``."""
        if not self.model.layers:
            return self.cfg.num_kv_heads
        return self.model.layers[0].self_attn._heads()[1]

    def init_caches(self, batch_size, max_length=None, dtype='float32'):
        """Allocate the dense per-layer KV caches on the parameters'
        device: a list of ``(k, v)`` zero tensors, each ``(batch_size,
        max_length, kv_heads, dh)`` (``max_length`` defaults to
        ``cfg.max_length``). A cached call writes them in place."""
        cfg = self.cfg
        L = max_length or cfg.max_length
        shape = (batch_size, L, self._kv_heads(), cfg.units // cfg.num_heads)
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        dev = self._device()
        return [(torch.zeros(shape, dtype=dt, device=dev),
                 torch.zeros(shape, dtype=dt, device=dev))
                for _ in range(cfg.num_layers)]

    def init_paged_pool(self, num_pages, page_size, dtype='float32'):
        """Allocate the paged-KV pool on the parameters' device: per
        layer, (k, v) zero tensors of shape ``(num_pages, page_size,
        kv_heads, dh)``. Every sequence's cache is a set of pages it
        names through its block table (``pages=``)."""
        cfg = self.cfg
        shape = (num_pages, page_size, self._kv_heads(),
                 cfg.units // cfg.num_heads)
        dev = self._device()
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        return [(torch.zeros(shape, dtype=dt, device=dev),
                 torch.zeros(shape, dtype=dt, device=dev))
                for _ in range(cfg.num_layers)]

    # ------------------------------------------------------------ picking
    def gather_logits(self, logits):
        """The logits of the whole vocabulary (a collective over ``tp``
        where they are this rank's slice), as a tensor."""
        t, tp = _vocab_part(logits)
        if tp is None:
            return t
        from ...sharding import _collectives as C
        return C.all_gather(t.contiguous(), tp[0], t.dim() - 1)

    def pick(self, logits, last=None):
        """The greedy token of each row of ``logits`` ``(B, S, V)`` (an
        NDArray, this rank's vocabulary slice under ``tp``) at its last
        position, or with ``last`` (a ``(k,)`` index tensor) at those
        positions of row 0: the fp32 argmax over the whole vocabulary,
        ties to the lowest id."""
        t, tp = _vocab_part(logits)
        rows = t[:, -1] if last is None else t[0].index_select(0, last)
        rows = rows.float()
        if tp is None:
            return torch.argmax(rows, dim=-1)
        from ...sharding import _collectives as C
        val, idx = rows.max(dim=-1)
        idx = idx + tp[2] * rows.shape[-1]
        vals = C.all_gather(val[None].contiguous(), tp[0], 0)
        idxs = C.all_gather(idx[None].contiguous(), tp[0], 0)
        best = torch.argmax(vals, dim=0)       # the first rank of a tie
        return idxs.gather(0, best[None])[0]

    def _next(self, logits, temperature, gen):
        if temperature <= 0.0:
            return self.pick(logits)
        return _pick(self.gather_logits(logits), temperature, gen)

    # ----------------------------------------------------------- generate
    @torch.no_grad()
    def generate(self, token_ids, max_new_tokens=32, max_length=None,
                 temperature=0.0, seed=0, batch_bucket=None, graph=True):
        """Autoregressive generation over the dense KV cache.

        One prefill call over the whole prompt, then one ``(B, 1)`` decode
        step per new token. Greedy (fp32 argmax of the last position) when
        ``temperature == 0``; otherwise sampling from ``softmax(logits /
        temperature)`` with a ``torch.Generator`` seeded with ``seed`` on
        the net's device (``torch.multinomial``'s draw: deterministic for
        a seed, but not the reference's ``jax.random`` draws).

        On a CUDA net the decode loop runs as the reference's one
        ``lax.scan`` program does: one decode step captured in a CUDA
        graph (per-row offsets over the dense cache), replayed once a
        token with no host sync in between. The graph and its caches are
        kept for the reference's key ``(B, S, L, temperature, n_pad)``,
        at most 16 of them (:meth:`release_graphs` drops them). They read
        the weights at the addresses they had at capture: updates in
        place are seen, new leaves are not (``quantize_net``, ``cast``
        and ``reset_ctx`` drop them). Sampling is captured only where
        this torch registers a generator with a graph
        (:func:`mxnet_tpu_torch._graphs.captures_generators`); otherwise,
        on the CPU, on a sharded net and with ``graph=False`` the steps
        run eagerly, at a shared Python-int offset.

        token_ids: ``(B, S)`` prompt tokens (NDArray, tensor, array or
        nested list). ``batch_bucket`` pads the batch with dummy rows up
        to that size (they are sliced off; causal rows are independent,
        so they cannot change the real ones). The cache holds
        ``max_length`` positions, by default ``min(cfg.max_length, S +
        2**ceil(log2(max(max_new_tokens - 1, 1))) + 1)`` as in the
        reference. Returns ``(B, S + max_new_tokens)`` int64 tokens, a
        tensor on the net's device."""
        dev = self._device()
        toks = _raw(_tokens(token_ids)).to(dev, torch.long)
        B_req, S = toks.shape
        if batch_bucket is not None:
            if batch_bucket < B_req:
                raise ValueError(f'batch_bucket={batch_bucket} smaller than '
                                 f'the actual batch {B_req}')
            toks = torch.cat([toks, toks.new_zeros(batch_bucket - B_req, S)])
        n_pow2 = 1
        while n_pow2 < max(max_new_tokens - 1, 1):
            n_pow2 *= 2
        L = max_length or min(self.cfg.max_length, S + n_pow2 + 1)
        if S + max_new_tokens > L:
            raise ValueError(f'max_length {L} too small for {S} prompt '
                             f'and {max_new_tokens} new tokens')
        n_rest = max_new_tokens - 1
        B = toks.shape[0]
        if graph and dev.type == 'cuda' and n_rest > 0 and \
                not self._sharded() and (
                    temperature <= 0.0 or _graphs.captures_generators()):
            key = (B, S, L, float(temperature), min(n_pow2, L - S - 1))
            loop = self._decode_loops.get(key)
            if loop is None:
                if len(self._decode_loops) >= 16:   # bound as the reference
                    self._decode_loops.pop(
                        next(iter(self._decode_loops))).graph.release()
                loop = self._decode_loops[key] = _DecodeLoop(
                    self, B, L, key[-1], temperature)
                self.graph_captures += 1
            nxt, rest = loop.run(self, toks, n_rest, seed)
            return torch.cat([toks, nxt[:, None], rest], dim=1)[:B_req]

        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=dev).manual_seed(int(seed))
        caches = self.init_caches(B, L)
        logits, caches = self(toks, caches=caches, offset=0)
        nxt = self._next(logits, temperature, gen)
        out = [toks, nxt[:, None]]
        for off in range(S, S + n_rest):
            logits, caches = self(nxt[:, None], caches=caches, offset=off)
            nxt = self._next(logits, temperature, gen)
            out.append(nxt[:, None])
        return torch.cat(out, dim=1)[:B_req]

    def release_graphs(self):
        """Drop the CUDA graphs of :meth:`generate` and their caches."""
        for loop in self._decode_loops.values():
            loop.graph.release()
        self._decode_loops.clear()


def _pick(logits, temperature, gen):
    """The next token of every row from the last position's logits (a
    tensor ``(B, S, V)``): the fp32 argmax, or with ``temperature > 0`` a
    draw from ``softmax(logits / temperature)``. The draw is
    ``torch.multinomial(probs, 1, generator=gen)``'s own (an exponential
    race, the same calls on the same generator) without its host-side
    check of ``probs``, which a CUDA graph cannot capture."""
    last = logits[:, -1, :].float()
    if temperature <= 0.0:
        return torch.argmax(last, dim=-1)
    probs = torch.softmax(last / float(temperature), dim=-1)
    q = torch.empty_like(probs).exponential_(1, generator=gen)
    return torch.argmax(probs / q, dim=-1)


class _DecodeLoop:
    """``generate()``'s decode loop for one key, on the card: the dense
    caches, the token, per-row offset and step buffers, the ``(n_pad, B)``
    output, and one decode step captured over them. The step picks the
    next token, writes it into the token buffer and into row ``step`` of
    the output, and advances the offsets and ``step``, so that replays
    follow each other with nothing from the host."""

    def __init__(self, net, B, L, n_pad, temperature):
        dev = net._device()
        self.temperature = temperature
        self.caches = net.init_caches(B, L)
        self.tok = torch.zeros(B, dtype=torch.long, device=dev)
        self.offset = torch.zeros(B, dtype=torch.int32, device=dev)
        self.step = torch.zeros(1, dtype=torch.long, device=dev)
        self.out = torch.zeros(n_pad, B, dtype=torch.long, device=dev)
        self.gen = torch.Generator(device=dev) if temperature > 0.0 \
            else None

        def body():
            logits, _ = net(self.tok[:, None], caches=self.caches,
                            offset=self.offset)
            nxt = _pick(logits._data, temperature, self.gen)
            self.tok.copy_(nxt)
            self.out.index_copy_(0, self.step, nxt[None])
            self.offset.add_(1)
            self.step.add_(1)

        self.graph = _graphs.StepGraph(
            body, dev, () if self.gen is None else (self.gen,))
        self.graph.capture()

    def run(self, net, toks, n_rest, seed):
        """Prefill ``toks`` eagerly, then replay the step ``n_rest``
        times; returns the first picked token ``(B,)`` and the rest
        ``(B, n_rest)``, on the card, unsynchronised."""
        for k, v in self.caches:     # as fresh as the eager loop's
            k.zero_()
            v.zero_()
        if self.gen is not None:
            self.gen.manual_seed(int(seed))
        logits, _ = net(toks, caches=self.caches, offset=0)
        nxt = _pick(logits._data, self.temperature, self.gen)
        self.tok.copy_(nxt)
        self.offset.fill_(toks.shape[1])
        self.step.zero_()
        self.graph.replay(n_rest)
        return nxt, self.out[:n_rest].T


_LLAMA_CONFIGS = {
    # test-scale config (CI, unit tests)
    'llama_tiny': dict(vocab_size=256, units=64, num_layers=2, num_heads=4,
                       num_kv_heads=2, hidden_size=128, max_length=128,
                       rope_theta=10000.0),
    'llama2_7b': dict(vocab_size=32000, units=4096, num_layers=32,
                      num_heads=32, num_kv_heads=32, hidden_size=11008,
                      max_length=4096, rope_theta=10000.0),
    'llama3_8b': dict(vocab_size=128256, units=4096, num_layers=32,
                      num_heads=32, num_kv_heads=8, hidden_size=14336,
                      max_length=8192, rope_theta=500000.0),
}


def get_llama(name, **kwargs):
    """Build a named configuration (``kwargs`` override its fields); call
    ``initialize()`` on the result."""
    cfg = dict(_LLAMA_CONFIGS[name])
    cfg.update(kwargs)
    return LlamaForCausalLM(LlamaConfig(**cfg))


def llama_tiny(**kwargs):
    """2-layer test-scale Llama (unit tests / smoke runs)."""
    return get_llama('llama_tiny', **kwargs)


def llama2_7b(**kwargs):
    """Llama-2-7B shapes."""
    return get_llama('llama2_7b', **kwargs)


def llama3_8b(**kwargs):
    """Llama-3-8B shapes (GQA 32/8, 500k rope theta)."""
    return get_llama('llama3_8b', **kwargs)


def _load(net, named, ctx):
    """Check every ``(name, array)`` of ``named`` against ``net``'s
    parameters, then set them (initializing the net on ``ctx`` first if it
    is not). Every parameter must be named once."""
    own = net.collect_params()
    named = dict(named)
    for name, value in named.items():
        if name not in own:
            raise KeyError(f'{name} is not a parameter of the net')
        shape = tuple(value.shape)
        if shape != tuple(own[name].shape):
            raise ValueError(f'{name}: shape {shape}, the net wants '
                             f'{tuple(own[name].shape)}')
    missing = sorted(set(own) - set(named))
    if missing:
        raise ValueError(f'parameters missing: {missing}')
    if any(p._var is None for p in own.values()):
        net.initialize(initializer.Zero(), ctx=ctx)
    for name, p in own.items():
        p.set_data(named[name])
    return net


def from_jax_params(net, params, ctx=None):
    """Load the JAX net's parameters into ``net``, in place; returns it.

    ``params`` maps the JAX package's parameter names (the same as
    ``net.collect_params()``'s: ``model.layers0.self_attn.q_proj.weight``,
    ...) to numpy arrays, as ``{n: p.data().asnumpy() for n, p in
    jnet.collect_params().items()}`` gives them. An unknown name raises
    KeyError, a wrong shape or a missing parameter ValueError. A net that
    is not initialized yet is initialized on ``ctx`` first (under a mesh:
    each rank keeps its shards of the values)."""
    return _load(net, ((n, np.asarray(v)) for n, v in params.items()), ctx)


# ------------------------------------------------------------ HF weights
def _hf_to_interleaved(w, num_heads, head_dim):
    """Permute q/k projection rows from HF rotate-half RoPE layout to the
    interleaved even/odd-pair layout :func:`_rope` uses: per head,
    interleaved row 2j is HF row j, row 2j+1 is HF row j + head_dim/2
    (both conventions then rotate pair j with the same frequency
    theta^(-2j/d)). ``w`` is a tensor or an array; returns a tensor."""
    w = torch.as_tensor(w)
    half = head_dim // 2
    perm = torch.empty(head_dim, dtype=torch.long)
    perm[0::2] = torch.arange(half)
    perm[1::2] = torch.arange(half) + half
    w = w.reshape(num_heads, head_dim, -1)[:, perm.to(w.device)]
    return w.reshape(num_heads * head_dim, -1)


def _hf_name(hf_name):
    """HF ``model.layers.{i}.`` → the Gluon child name
    ``model.layers{i}.``."""
    name = hf_name
    while '.layers.' in name:
        head, rest = name.split('.layers.', 1)
        idx, rest = rest.split('.', 1)
        name = f'{head}.layers{idx}.{rest}'
    return name


def _hf_items(net, state_dict):
    """``(our name, tensor)`` for each HF-named entry, q and k permuted."""
    cfg = net.cfg
    dh = cfg.units // cfg.num_heads
    for hf_name, value in state_dict.items():
        name = _hf_name(hf_name)
        v = value.detach() if torch.is_tensor(value) \
            else torch.as_tensor(np.asarray(value))
        if name.endswith('self_attn.q_proj.weight'):
            v = _hf_to_interleaved(v, cfg.num_heads, dh)
        elif name.endswith('self_attn.k_proj.weight'):
            v = _hf_to_interleaved(v, cfg.num_kv_heads, dh)
        yield hf_name, name, v


def _hf_set(net, state_dict, loaded):
    params = net.collect_params()
    for hf_name, name, v in _hf_items(net, state_dict):
        if name not in params:
            raise KeyError(f'{hf_name} has no target parameter ({name})')
        p = params[name]
        if tuple(p.shape) != tuple(v.shape):
            raise ValueError(f'{hf_name}: shape {tuple(v.shape)} vs '
                             f'parameter {tuple(p.shape)}')
        p.set_data(v)
        loaded.add(name)


def load_hf_state_dict(net, state_dict):
    """Load HuggingFace-Transformers Llama weights (a mapping of HF names
    to tensors or arrays, read locally) into an initialized
    :class:`LlamaForCausalLM` (reference ``llama.py:610``): q/k
    projections are re-permuted for the interleaved RoPE (see
    :func:`_hf_to_interleaved`), everything else maps 1:1 with
    ``layers.{i}`` → ``layers{i}``. An unknown name raises KeyError; a
    wrong shape or a parameter the dict does not hold, ValueError."""
    loaded = set()
    _hf_set(net, state_dict, loaded)
    missing = set(net.collect_params()) - loaded
    if missing:
        raise ValueError(f'checkpoint missing parameters: {sorted(missing)}')
    return net


_ST_DTYPES = {'F64': torch.float64, 'F32': torch.float32,
              'F16': torch.float16, 'BF16': torch.bfloat16,
              'I64': torch.int64, 'I32': torch.int32, 'I16': torch.int16,
              'I8': torch.int8, 'U8': torch.uint8, 'BOOL': torch.bool}


def read_safetensors(path):
    """The tensors of a ``.safetensors`` file, by name, on the host: an
    8-byte little-endian header length, the JSON header (each name's
    ``dtype``, ``shape`` and ``data_offsets`` into the data that follows),
    then the raw little-endian tensors. No ``safetensors`` package."""
    out = {}
    with open(path, 'rb') as f:
        n = int.from_bytes(f.read(8), 'little')
        header = json.loads(f.read(n))
        base = 8 + n
        for name, meta in header.items():
            if name == '__metadata__':
                continue
            dtype = _ST_DTYPES.get(meta['dtype'])
            if dtype is None:
                raise ValueError(f'{path}: {name} has dtype '
                                 f'{meta["dtype"]}, not read here')
            lo, hi = meta['data_offsets']
            f.seek(base + lo)
            buf = bytearray(f.read(hi - lo))
            t = torch.frombuffer(buf, dtype=dtype) if buf else \
                torch.empty(0, dtype=dtype)
            out[name] = t.reshape(meta['shape'])
    return out


def _hf_files(model_path):
    """The weight files of a local HF checkpoint directory, in order:
    those its ``*.index.json`` names, else ``model*.safetensors``, else
    ``pytorch_model*.bin``."""
    for index, pattern in (('model.safetensors.index.json', None),
                           ('pytorch_model.bin.index.json', None),
                           (None, 'model*.safetensors'),
                           (None, 'pytorch_model*.bin')):
        if index is not None:
            ipath = os.path.join(model_path, index)
            if os.path.exists(ipath):
                with open(ipath) as f:
                    files = sorted(set(json.load(f)['weight_map'].values()))
                return [os.path.join(model_path, n) for n in files]
            continue
        files = sorted(glob.glob(os.path.join(model_path, pattern)))
        if files:
            return files
    raise FileNotFoundError(f'{model_path}: no model*.safetensors or '
                            f'pytorch_model*.bin weights')


def from_hf_pretrained(model_path, ctx=None, **config_overrides):
    """Build a :class:`LlamaForCausalLM` from a local HuggingFace
    checkpoint directory (reference ``llama.py:657``): ``config.json``
    gives the configuration (``config_overrides`` replace its fields) and
    the weights come from ``model*.safetensors`` or ``pytorch_model*.bin``
    (sharded through their ``*.index.json``), one file at a time, with no
    ``transformers``. The net lives on ``ctx``, the current context by
    default (the card); inside a ``tp`` mesh each rank keeps its shards.
    Never downloads."""
    with open(os.path.join(model_path, 'config.json')) as f:
        hf_cfg = json.load(f)
    cfg = dict(
        vocab_size=hf_cfg['vocab_size'], units=hf_cfg['hidden_size'],
        num_layers=hf_cfg['num_hidden_layers'],
        num_heads=hf_cfg['num_attention_heads'],
        num_kv_heads=hf_cfg.get('num_key_value_heads',
                                hf_cfg['num_attention_heads']),
        hidden_size=hf_cfg['intermediate_size'],
        max_length=hf_cfg.get('max_position_embeddings', 4096),
        rope_theta=hf_cfg.get('rope_theta', 10000.0),
        rms_norm_eps=hf_cfg.get('rms_norm_eps', 1e-5),
        tie_word_embeddings=hf_cfg.get('tie_word_embeddings', False))
    cfg.update(config_overrides)
    net = LlamaForCausalLM(LlamaConfig(**cfg))
    net.initialize(initializer.Zero(), ctx=ctx)
    loaded = set()
    for path in _hf_files(model_path):
        if path.endswith('.safetensors'):
            sd = read_safetensors(path)
        else:
            sd = torch.load(path, map_location='cpu', weights_only=True)
        _hf_set(net, sd, loaded)
        del sd
    missing = set(net.collect_params()) - loaded
    if missing:
        raise ValueError(f'{model_path}: checkpoint missing parameters: '
                         f'{sorted(missing)}')
    return net
