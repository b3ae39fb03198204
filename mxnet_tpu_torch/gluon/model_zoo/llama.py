"""Llama model family (decoder-only causal LM) in PyTorch.

Counterpart of ``mxnet_tpu/gluon/model_zoo/llama.py``: pre-norm blocks with
RMSNorm, interleaved rotary position embeddings, grouped-query attention
and a SwiGLU MLP, with the same parameter names (``layers{i}`` becomes
``layers.{i}``) and the same numerics. The norms, the full-sequence
attention and the paged decode attention go through the port's CUDA
kernels on the card (``ops/kernels/``); the projections, the embedding
lookup, RoPE, SiLU and the chunked-prefill attention are plain PyTorch,
as the reference leaves them to XLA.

Ported here: the no-cache forward, the dense KV cache (``init_caches``,
prefill, lockstep and per-slot decode), the paged per-slot decode and the
paged chunked prefill, ``init_paged_pool``, ``generate()`` and
:func:`from_jax_params`. Every cached path also takes its offset as a tensor
read on the device, so that a CUDA graph can capture it, and the RoPE
tables are built once a forward. On the card ``generate()`` replays one
captured decode step once a token, as the reference runs its decode loop
as one ``lax.scan`` program, and keeps the graphs under the reference's
key (``_graphs.StepGraph``); its prefill stays one eager call. A net
quantized by :func:`mxnet_tpu_torch.quantization.quantize_net` runs every
path unchanged, with bf16 activations between its int8 layers.

Under ``mx.sharding`` with a ``tp`` axis (:meth:`LlamaForCausalLM.shard`,
or a net built inside the context) every rank holds its shard of the
weights by :func:`llama_partition_rules` (Megatron's layout): q, k, v,
gate and up column-parallel, o and down row-parallel with a sum over
``tp`` after each, ``embed_tokens`` and ``lm_head`` vocab-parallel (a
masked lookup and a sum; logits of this rank's vocabulary slice, which
:meth:`LlamaForCausalLM.pick` reduces to the global greedy token, ties to
the lowest id as ``torch.argmax``). Attention runs on the local heads, the
GQA ratio kept: ``llama3_8b`` at tp = 2 holds 16 of 32 query heads and 4
of 8 KV heads a rank. The net keeps the spec's ``tp`` splits only and
holds every other axis whole (data-parallel serving replicates it).

The no-cache forward also trains: where autograd records, the norms and
the flash attention go through their ``autograd.Function``s
(``FusedNormFunction``, ``FlashAttentionFunction``), whose forward is the
kernel and whose backward is the reference's ``custom_vjp`` backward, so
``loss.backward()`` reaches every parameter. ``repeat_interleave`` carries
the gradient of the repeated KV heads back to the ``num_kv_heads`` of
``k_proj`` and ``v_proj``. A train step takes ``gluon.Trainer``.
"""

import re

import numpy as np
import torch
from torch import nn

from ... import _graphs
from ...context import resolve_device
from ...ops import nn as nn_ops
from ...ops.contrib import flash_attention, paged_attention_decode

__all__ = ['LlamaConfig', 'LlamaModel', 'LlamaForCausalLM', 'llama_tiny',
           'llama2_7b', 'llama3_8b', 'get_llama', 'from_jax_params',
           'llama_partition_rules', 'shard_params_for']

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


def llama_partition_rules(axis='tp'):
    """Megatron tensor-parallel rules for the Llama (JAX ``llama.py:518``):
    the registry's ``('llama', 'tp')`` table with ``axis`` for ``tp``."""
    from ...sharding import rules as _rules
    P = _rules.PartitionSpec
    return [(pat, P(*(axis if e == 'tp' else e for e in spec)))
            for pat, spec in _rules.rules_for('llama', 'tp')]


def _tp_sum(t, tp):
    """``t`` summed over the ranks of ``tp`` (a ``(group, n, index)``
    triple, or None for one rank)."""
    if tp is None:
        return t
    from ...sharding import _collectives as C
    return C.sum_over(t, tp[0])


class RMSNorm(nn.Module):
    """Root-mean-square norm (no mean subtraction, no bias)."""

    def __init__(self, units, epsilon=1e-5):
        super().__init__()
        self._eps = epsilon
        self.weight = nn.Parameter(torch.ones(units))

    def forward(self, x):
        return nn_ops.rms_norm(x, self.weight, eps=self._eps)


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
    off = torch.as_tensor(offset, dtype=f32, device=device)
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


class LlamaAttention(nn.Module):
    """Grouped-query attention with RoPE."""

    def __init__(self, cfg):
        super().__init__()
        self._h = cfg.num_heads
        self._kv = cfg.num_kv_heads
        self._dh = cfg.units // cfg.num_heads
        self._theta = cfg.rope_theta
        self.q_proj = nn.Linear(cfg.units, self._h * self._dh, bias=False)
        self.k_proj = nn.Linear(cfg.units, self._kv * self._dh, bias=False)
        self.v_proj = nn.Linear(cfg.units, self._kv * self._dh, bias=False)
        self.o_proj = nn.Linear(self._h * self._dh, cfg.units, bias=False)
        self._tp = None     # (group, n, index) once sharded on tp

    def _heads(self):
        """The query and KV heads this rank holds."""
        if self._tp is None:
            return self._h, self._kv
        return self._h // self._tp[1], self._kv // self._tp[1]

    def forward(self, x, cache=None, offset=0, pages=None, rope=None):
        """Without ``cache``: causal attention over the sequence (flash
        kernel). With ``cache``, new K/V are written into it IN PLACE
        (index assignment; the reference donates the cache to a jitted
        step instead) and ``(out, cache)`` is returned.

        ``cache`` is either the dense per-row cache ``(k, v)``, each
        ``(B, max_length, kv_heads, dh)`` (:meth:`init_caches`), or, with
        ``pages`` the int32 block table ``(B, pages_per_seq)``, the global
        page pool ``(num_pages, page_size, kv_heads, dh)``
        (:meth:`init_paged_pool`), where logical position ``p`` of row
        ``b`` lives at ``pool[pages[b, p // page_size], p % page_size]``.

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

        The kernels take q, k, v as they come, fp32 or bf16 (a net cast
        to bf16, or the bf16 projections of a quantized net), and return
        q's dtype, as the reference's kernels do. The caches keep their
        own dtype: the per-slot decode takes q in the pool's (fp32 for
        the server's pool, the reference's fp32 step), and the gathered
        attention over a cache runs in fp32, as in the reference."""
        B, S, _ = x.shape
        H, KV = self._heads()
        q = self.q_proj(x).reshape(B, S, H, self._dh)
        k = self.k_proj(x).reshape(B, S, KV, self._dh)
        v = self.v_proj(x).reshape(B, S, KV, self._dh)
        if rope is None:
            rope = _rope_tables(S, self._dh, self._theta, offset, x.device)
        q = _rope(q, *rope)
        k = _rope(k, *rope)
        rep = H // KV

        if cache is None:
            if rep > 1:
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=True)
            out = out.transpose(1, 2).reshape(B, S, H * self._dh)
            return _tp_sum(self.o_proj(out), self._tp)

        k_cache, v_cache = cache
        per_slot = torch.is_tensor(offset) and offset.dim() == 1
        if per_slot and S != 1:
            raise ValueError('per-slot offsets decode one token per step')
        if pages is not None:
            psz = k_cache.shape[1]
            L = pages.shape[1] * psz
            if per_slot:
                off = offset.long()
                pid = pages[torch.arange(B, device=x.device),
                            off // psz].long()
                k_cache[pid, off % psz] = k[:, 0].to(k_cache.dtype)
                v_cache[pid, off % psz] = v[:, 0].to(v_cache.dtype)
                out = paged_attention_decode(
                    q[:, 0].to(k_cache.dtype), k_cache, v_cache, pages,
                    offset.to(torch.int32).contiguous(),
                    sm_scale=self._dh ** -0.5)
                out = out.to(q.dtype).reshape(B, S, H * self._dh)
                return _tp_sum(self.o_proj(out), self._tp), \
                    (k_cache, v_cache)
            if B != 1:
                raise ValueError('chunked prefill fills one sequence')
            pos = _positions(offset, S, x.device)
            pid = pages[0, pos // psz].long()
            k_cache[pid, pos % psz] = k[0].to(k_cache.dtype)
            v_cache[pid, pos % psz] = v[0].to(v_cache.dtype)
            idx = pages.long()
            kf = k_cache[idx].reshape(B, L, KV, self._dh)
            vf = v_cache[idx].reshape(B, L, KV, self._dh)
        else:
            L = k_cache.shape[1]
            if per_slot:
                rows = torch.arange(B, device=x.device)
                k_cache[rows, offset.long()] = k[:, 0].to(k_cache.dtype)
                v_cache[rows, offset.long()] = v[:, 0].to(v_cache.dtype)
            elif torch.is_tensor(offset):
                pos = _positions(offset, S, x.device)
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
        keys = torch.arange(L, device=x.device)
        if per_slot:
            # row b's single query (position offset[b]) sees slots <= it
            mask = (keys[None, :] <= offset.long()[:, None])[:, None, None]
        else:
            qpos = _positions(offset, S, x.device)
            mask = (keys[None, :] <= qpos[:, None])[None, None]
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum('bhsl,blhd->bshd', probs, vf.float()).to(x.dtype)
        out = out.reshape(B, S, H * self._dh)
        return _tp_sum(self.o_proj(out), self._tp), (k_cache, v_cache)


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x))."""

    def __init__(self, cfg):
        super().__init__()
        self.gate_proj = nn.Linear(cfg.units, cfg.hidden_size, bias=False)
        self.up_proj = nn.Linear(cfg.units, cfg.hidden_size, bias=False)
        self.down_proj = nn.Linear(cfg.hidden_size, cfg.units, bias=False)
        self._tp = None

    def forward(self, x):
        return _tp_sum(self.down_proj(nn_ops.silu(self.gate_proj(x))
                                      * self.up_proj(x)), self._tp)


class LlamaBlock(nn.Module):
    """Pre-norm decoder block."""

    def __init__(self, cfg):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.units, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.units, cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, cache=None, offset=0, pages=None, rope=None):
        if cache is None:
            x = x + self.self_attn(self.input_layernorm(x), rope=rope)
            return x + self.mlp(self.post_attention_layernorm(x))
        att, cache = self.self_attn(self.input_layernorm(x), cache=cache,
                                    offset=offset, pages=pages, rope=rope)
        x = x + att
        return x + self.mlp(self.post_attention_layernorm(x)), cache


class LlamaModel(nn.Module):
    """Token embedding + decoder stack + final norm → hidden states."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.units)
        self.layers = nn.ModuleList(LlamaBlock(cfg)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.units, cfg.rms_norm_eps)
        self._tp = None

    def embed(self, token_ids):
        """The token embeddings: a vocab-parallel table looks up the rows
        this rank holds and sums over ``tp``."""
        if self._tp is None:
            return self.embed_tokens(token_ids)
        from ...sharding.dispatch import vocab_lookup
        return vocab_lookup(token_ids, self.embed_tokens.weight,
                            self._tp[0], self._tp[2])

    def forward(self, token_ids, caches=None, offset=0, pages=None):
        x = self.embed(token_ids)
        cfg = self.cfg
        # one set of RoPE tables for every layer's q and k
        rope = _rope_tables(x.shape[1], cfg.units // cfg.num_heads,
                            cfg.rope_theta, offset if caches is not None
                            else 0, x.device)
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


class LlamaForCausalLM(nn.Module):
    """Decoder LM head: (B, S) int tokens → (B, S, vocab) logits.

    ``device`` is where the parameters live (default: the current
    context, ``gpu(0)``; raises when there is no card and the caller did
    not pass ``device='cpu'``). ``device='meta'`` builds shapes only.
    Parameters are drawn from a ``torch.Generator`` seeded with ``seed``:
    projections and embeddings N(0, 0.02), norm weights 1.
    ``graph_captures`` counts the decode steps ``generate()`` captured."""

    def __init__(self, cfg, device=None, seed=0):
        super().__init__()
        self._decode_loops = {}     # generate()'s graphs, by key
        self.graph_captures = 0     # their captures, as compiles count
        meta = isinstance(device, (str, torch.device)) \
            and torch.device(device).type == 'meta'
        dev = None if meta else resolve_device(device)
        self.cfg = cfg
        self._tp = None
        self._shard_ctx = None
        with torch.device('meta'):
            self.model = LlamaModel(cfg)
            if not cfg.tie_word_embeddings:
                self.lm_head = nn.Linear(cfg.units, cfg.vocab_size,
                                         bias=False)
        from ...sharding import current
        ctx = current()
        if dev is not None and ctx is not None and ctx.size('tp') > 1:
            # this rank's shards only, each drawn whole in turn from the
            # seeded generator (the values of the unsharded net)
            self._draw_sharded(ctx, dev, seed)
        elif dev is not None:
            self.to_empty(device=dev)
            self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        """Redraw every parameter from a generator seeded with ``seed``
        on the parameters' device."""
        dev = self._device()
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith('norm.weight'):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)

    # -------------------------------------------------------------- sharding
    def _specs(self, ctx):
        """Each parameter's spec by the context's rules (the Llama's ``tp``
        table by default), its ``tp`` splits only: ``{name: spec}``."""
        from ...sharding.rules import PartitionSpec as P, match_spec, \
            resolve_spec
        rules = ctx.rules_for_block(self) if ctx.mode == 'tp' else \
            llama_partition_rules()
        out = {}
        for name, p in self.named_parameters():
            spec = resolve_spec(match_spec(name, p.shape, rules), p.shape,
                                ctx, name=name)
            out[name] = P(*('tp' if e == 'tp' or (isinstance(e, tuple)
                                                  and 'tp' in e) else None
                            for e in spec))
        return out

    def _mark(self, ctx):
        tp = (ctx.group('tp'), ctx.size('tp'), ctx.coord('tp'))
        self._tp = self.model._tp = tp
        for blk in self.model.layers:
            blk.self_attn._tp = blk.mlp._tp = tp
        self._shard_ctx = ctx
        self.release_graphs()

    @torch.no_grad()
    def _draw_sharded(self, ctx, dev, seed):
        specs = self._specs(ctx)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        for name, p in list(self.named_parameters()):
            full = torch.empty(p.shape, dtype=p.dtype, device=dev)
            if name.endswith('norm.weight'):
                full.fill_(1.0)
            else:
                full.normal_(0.0, 0.02, generator=gen)
            local = _cut(full, specs[name], ctx)
            del full
            self._set_param(name, local)
        self._mark(ctx)

    def _set_param(self, name, value):
        mod = self
        *path, leaf = name.split('.')
        for part in path:
            mod = getattr(mod, part)
        setattr(mod, leaf, nn.Parameter(value, requires_grad=True))

    @torch.no_grad()
    def shard(self, ctx=None):
        """Keep this rank's ``tp`` shard of every weight (a net holding
        whole weights; the whole ones are freed). ``ctx`` defaults to the
        active ``mx.sharding`` context; a mesh without ``tp`` changes
        nothing. Returns the net."""
        from ...sharding import current
        ctx = ctx or current()
        if ctx is None or ctx.size('tp') == 1 or self._tp is not None:
            return self
        specs = self._specs(ctx)
        for name, p in list(self.named_parameters()):
            whole = p.detach()
            local = _cut(whole, specs[name], ctx)
            if local is not whole:
                self._set_param(name, local)
        self._mark(ctx)
        return self

    def gather_logits(self, logits):
        """The logits of the whole vocabulary from this rank's slice (a
        collective over ``tp``); the logits themselves unsharded."""
        if self._tp is None:
            return logits
        from ...sharding import _collectives as C
        return C.all_gather(logits.contiguous(), self._tp[0],
                            logits.dim() - 1)

    def pick(self, last):
        """The greedy token of each row of ``last`` (``(B, V)`` logits, or
        this rank's vocabulary slice of them): the fp32 argmax, over the
        whole vocabulary, ties to the lowest id."""
        last = last.float()
        if self._tp is None:
            return torch.argmax(last, dim=-1)
        from ...sharding import _collectives as C
        val, idx = last.max(dim=-1)
        idx = idx + self._tp[2] * last.shape[-1]
        vals = C.all_gather(val[None].contiguous(), self._tp[0], 0)
        idxs = C.all_gather(idx[None].contiguous(), self._tp[0], 0)
        best = torch.argmax(vals, dim=0)       # the first rank of a tie
        return idxs.gather(0, best[None])[0]

    def forward(self, token_ids, caches=None, offset=0, pages=None):
        if caches is None:
            h = self.model(token_ids)
        else:
            h, caches = self.model(token_ids, caches=caches, offset=offset,
                                   pages=pages)
        if self.cfg.tie_word_embeddings:
            logits = h @ self.model.embed_tokens.weight.T
        else:
            logits = self.lm_head(h)
        return logits if caches is None else (logits, caches)

    def _device(self):
        return self.model.embed_tokens.weight.device

    def init_caches(self, batch_size, max_length=None, dtype='float32'):
        """Allocate the dense per-layer KV caches on the parameters'
        device: a list of ``(k, v)`` zero tensors, each ``(batch_size,
        max_length, kv_heads, dh)`` (``max_length`` defaults to
        ``cfg.max_length``). ``forward(..., caches=...)`` writes them in
        place."""
        cfg = self.cfg
        L = max_length or cfg.max_length
        kv = cfg.num_kv_heads // (self._tp[1] if self._tp else 1)
        shape = (batch_size, L, kv, cfg.units // cfg.num_heads)
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        return [(torch.zeros(shape, dtype=dt, device=self._device()),
                 torch.zeros(shape, dtype=dt, device=self._device()))
                for _ in range(cfg.num_layers)]

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
        place are seen, a swapped module is not (``quantize_net`` and
        ``.to()`` drop them). Sampling is captured only where this torch
        registers a generator with a graph
        (:func:`mxnet_tpu_torch._graphs.captures_generators`); otherwise,
        on the CPU and with ``graph=False`` the steps run eagerly, at a
        shared Python-int offset.

        token_ids: ``(B, S)`` prompt tokens (tensor, array or nested
        list). ``batch_bucket`` pads the batch with dummy rows up to that
        size (they are sliced off; causal rows are independent, so they
        cannot change the real ones). The cache holds ``max_length``
        positions, by default ``min(cfg.max_length, S + 2**ceil(log2(
        max(max_new_tokens - 1, 1))) + 1)`` as in the reference. Returns
        ``(B, S + max_new_tokens)`` int64 tokens on the net's device."""
        dev = self._device()
        toks = token_ids if torch.is_tensor(token_ids) \
            else torch.as_tensor(np.asarray(token_ids))
        toks = toks.to(dev, torch.long)
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
        if self._tp is not None:
            graph = False       # the picks hold collectives
        if graph and dev.type == 'cuda' and n_rest > 0 and (
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

    def _next(self, logits, temperature, gen):
        if self._tp is None:
            return _pick(logits, temperature, gen)
        if temperature <= 0.0:
            return self.pick(logits[:, -1])
        return _pick(self.gather_logits(logits), temperature, gen)

    def release_graphs(self):
        """Drop the CUDA graphs of :meth:`generate` and their caches."""
        for loop in self._decode_loops.values():
            loop.graph.release()
        self._decode_loops.clear()

    def _apply(self, fn, *args, **kwargs):
        # moving or casting the parameters moves what the graphs read
        self.release_graphs()
        return super()._apply(fn, *args, **kwargs)

    def init_paged_pool(self, num_pages, page_size, dtype='float32'):
        """Allocate the paged-KV pool on the parameters' device: per
        layer, (k, v) zero tensors of shape ``(num_pages, page_size,
        kv_heads, dh)``. Every sequence's cache is a set of pages it
        names through its block table (``forward(..., pages=...)``)."""
        cfg = self.cfg
        dh = cfg.units // cfg.num_heads
        kv = cfg.num_kv_heads // (self._tp[1] if self._tp else 1)
        shape = (num_pages, page_size, kv, dh)
        dev = self._device()
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        return [(torch.zeros(shape, dtype=dt, device=dev),
                 torch.zeros(shape, dtype=dt, device=dev))
                for _ in range(cfg.num_layers)]


def _pick(logits, temperature, gen):
    """The next token of every row from the last position's logits: the
    fp32 argmax, or with ``temperature > 0`` a draw from
    ``softmax(logits / temperature)``. The draw is
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
            nxt = _pick(logits, temperature, self.gen)
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
        nxt = _pick(logits, self.temperature, self.gen)
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


def get_llama(name, device=None, seed=0, **kwargs):
    """Build a named configuration (``kwargs`` override its fields)."""
    cfg = dict(_LLAMA_CONFIGS[name])
    cfg.update(kwargs)
    return LlamaForCausalLM(LlamaConfig(**cfg), device=device, seed=seed)


def llama_tiny(**kwargs):
    """2-layer test-scale Llama (unit tests / smoke runs)."""
    return get_llama('llama_tiny', **kwargs)


def llama2_7b(**kwargs):
    """Llama-2-7B shapes."""
    return get_llama('llama2_7b', **kwargs)


def llama3_8b(**kwargs):
    """Llama-3-8B shapes (GQA 32/8, 500k rope theta)."""
    return get_llama('llama3_8b', **kwargs)


def from_jax_params(params, cfg):
    """The port's ``state_dict`` for the JAX net's parameters.

    ``params`` maps the JAX package's parameter names
    (``model.layers0.self_attn.q_proj.weight``, ...) to numpy arrays, as
    ``{n: p.data().asnumpy() for n, p in net.collect_params().items()}``
    gives them. Gluon ``Dense`` stores ``(out, in)`` like ``nn.Linear``,
    so only the names change: ``layers{i}`` becomes ``layers.{i}``.
    Load the result with ``net.load_state_dict(...)``."""
    shapes = {k: tuple(v.shape) for k, v in
              LlamaForCausalLM(cfg, device='meta').state_dict().items()}
    out = {}
    for name, value in params.items():
        key = re.sub(r'\.layers(\d+)\.', r'.layers.\1.', name)
        if key not in shapes:
            raise KeyError(f'{name} has no counterpart in the port ({key})')
        arr = np.asarray(value)
        if arr.shape != shapes[key]:
            raise ValueError(f'{name}: shape {arr.shape}, the port wants '
                             f'{shapes[key]}')
        out[key] = torch.tensor(arr)
    missing = sorted(set(shapes) - set(out))
    if missing:
        raise ValueError(f'parameters missing: {missing}')
    return out


def shard_params_for(params, spec_of, ctx):
    """This rank's shard of each whole numpy parameter (``{name: array}``,
    as :func:`from_jax_params` or ``collect_params()`` give them) under the
    spec ``spec_of(name, shape)`` returns on the ``mx.sharding`` context
    ``ctx``: the values a sharded net holds, to feed the JAX package's
    weights to the port's ranks."""
    out = {}
    for name, value in params.items():
        t = torch.as_tensor(np.asarray(value))
        out[name] = _cut(t, spec_of(name, tuple(t.shape)), ctx)
    return out


def _cut(t, spec, ctx):
    """This rank's shard of the whole tensor ``t`` under ``spec`` on the
    ``mx.sharding`` context ``ctx``, a copy (a piece of dim 0 would be a
    view that keeps all of ``t``); ``t`` itself where the spec splits
    nothing."""
    from ...sharding.dispatch import Layout, cut
    lay = Layout(ctx, spec, t.shape)
    return cut(t, lay).clone() if lay.sharded else t
