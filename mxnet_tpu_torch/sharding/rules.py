"""Partition-rule registry: regex -> PartitionSpec over named parameters.

Counterpart of ``mxnet_tpu/sharding/rules.py``, value for value: the one
matcher behind every sharded surface of the port (``mx.sharding.mesh`` and
the hybridize cache, ``parallel.shard_params``, the sharded serving pool,
the Trainer's ZeRO-1 slots). A rule table is an ordered list of
``(pattern, PartitionSpec)`` pairs; a parameter's structural name
(``collect_params()`` keys, e.g. ``encoder.cell0.attention.qkv.weight``)
is matched with ``re.search`` against each pattern in order, and the first
match wins. Scalars (0-d) replicate without consulting the table. A
parameter no rule covers is an error naming the nearest rule
(``parallel.shard_params`` passes ``on_unmatched='replicate'``). Patterns
may also be ``pred(name, shape) -> bool`` callables.

Per-architecture tables ship for ``resnet``, ``bert`` and ``llama`` in two
modes, ``tp`` (Megatron tensor parallelism: column-parallel kernels shard
the output dim on ``tp``, row-parallel ones the input dim, embeddings the
vocab dim) and ``fsdp`` (every weight's leading dim on ``dp``, small 1-d
parameters replicated), plus ``generic`` ``fsdp``. ``resolve_spec`` adapts
a matched spec to a concrete (shape, mesh): an axis that does not divide
its dim is dropped unless ``MXNET_SHARDING_STRICT=1``.

:class:`PartitionSpec` is the port's own: a tuple whose entries are mesh
axis names, tuples of them, or None, with ``jax.sharding.PartitionSpec``'s
repr and tuple equality. A mesh is anything with ``axis_names`` and
``axis_sizes`` (:class:`.context.ShardingContext`) or a
``torch.distributed`` ``DeviceMesh`` with named dims.
"""

import difflib
import os
import re



class PartitionSpec(tuple):
    """How each dim of a value is laid out over the mesh: one entry a dim
    (an axis name, a tuple of names, or None for replicated); missing
    trailing entries are None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f'PartitionSpec{tuple.__repr__(self)}'.replace(',)', ')')

    def __reduce__(self):
        return (PartitionSpec, tuple(self))


P = PartitionSpec

__all__ = ['PartitionSpec', 'P', 'match_partition_rules', 'match_spec', 'resolve_spec',
           'register_rules', 'rules_for', 'list_archs', 'infer_arch',
           'UnmatchedParamError']


class UnmatchedParamError(ValueError):
    """A parameter matched no rule in the table (and the caller asked
    for errors, the registry default)."""


# --------------------------------------------------------------- the matcher
def _matches(pattern, name, shape):
    if isinstance(pattern, re.Pattern):
        return pattern.search(name) is not None
    if callable(pattern):
        return bool(pattern(name, shape))
    return re.search(pattern, name) is not None


def _pattern_label(pattern):
    if isinstance(pattern, re.Pattern):
        return pattern.pattern
    if callable(pattern):
        return getattr(pattern, '__name__', repr(pattern))
    return str(pattern)


def _shape_of(value):
    shape = getattr(value, 'shape', None)
    if shape is None and isinstance(value, (tuple, list)) and all(
            isinstance(d, int) for d in value):
        shape = tuple(value)
    if shape is None:
        raise TypeError(f'cannot read a shape from {type(value).__name__}')
    return tuple(shape)


def match_spec(name, shape_or_value, rules, on_unmatched='error'):
    """PartitionSpec for one parameter: first matching rule wins;
    0-d scalars replicate unconditionally.

    ``on_unmatched``: ``'error'`` raises :class:`UnmatchedParamError`
    naming the nearest rule (the registry contract); ``'replicate'``
    returns ``P()`` (the legacy ``shard_params`` contract).
    """
    shape = _shape_of(shape_or_value)
    if len(shape) == 0:
        return P()
    for pattern, spec in rules or []:
        if _matches(pattern, name, shape):
            return spec
    if on_unmatched == 'replicate':
        return P()
    labels = [_pattern_label(p) for p, _ in rules or []]
    near = difflib.get_close_matches(name, labels, n=1, cutoff=0.0)
    hint = f"; nearest rule: '{near[0]}'" if near else ''
    raise UnmatchedParamError(
        f"no partition rule matches parameter '{name}' "
        f'(shape {shape}){hint}. Add a rule via '
        "mx.sharding.register_rules(...) or pass rules=[...] "
        "covering it (scalars auto-replicate; an explicit "
        "(r'.*', PartitionSpec()) tail replicates the rest).")


def match_partition_rules(rules, params, on_unmatched='error'):
    """Match a whole param mapping (name -> shaped value / shape tuple)
    to ``{name: PartitionSpec}`` through one pass of the matcher."""
    return {name: match_spec(name, value, rules, on_unmatched=on_unmatched)
            for name, value in params.items()}


def strict_enabled():
    return os.environ.get('MXNET_SHARDING_STRICT', '') == '1'


def mesh_sizes(mesh):
    """``{axis name: size}`` of a :class:`.context.ShardingContext` or a
    ``DeviceMesh`` with named dims."""
    sizes = getattr(mesh, 'axis_sizes', None)
    if sizes is not None:
        return dict(sizes)
    names = tuple(mesh.mesh_dim_names or ())
    return {n: int(mesh.size(i)) for i, n in enumerate(names)}


def resolve_spec(spec, shape, mesh, name='<param>', strict=None):
    """Adapt a matched spec to a concrete (shape, mesh): axes whose mesh
    extent does not evenly divide the dim are dropped (that dim
    replicates), and axes missing from the mesh are dropped too. Under
    ``MXNET_SHARDING_STRICT=1`` (or ``strict=True``) a non-dividing
    axis raises instead."""
    if strict is None:
        strict = strict_enabled()
    sizes = mesh_sizes(mesh)
    out = []
    for d, entry in enumerate(tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a in sizes and sizes[a] > 1)
        extent = 1
        for a in axes:
            extent *= sizes[a]
        if extent > 1 and shape[d] % extent:
            if strict:
                raise ValueError(
                    f'{name}: dim {d} of shape {tuple(shape)} is not '
                    f'divisible by mesh axes {axes} (extent {extent}) '
                    '— MXNET_SHARDING_STRICT=1 forbids the replicate '
                    'fallback')
            axes = ()
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def shard_factor(spec, shape, mesh):
    """Number of devices one shard of this buffer is divided across:
    the product of resolved mesh-axis extents — the divisor for the
    per-device byte accounting (the reference's ``mx.analysis.costs``)."""
    resolved = resolve_spec(spec, shape, mesh, strict=False)
    sizes = mesh_sizes(mesh)
    factor = 1
    for entry in resolved:
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            factor *= sizes.get(a, 1)
    return factor


# ----------------------------------------------------------- per-arch tables
# gluon Dense stores weight as (units_out, units_in): the output dim is
# axis 0 (column-parallel -> P('tp', None)); conv weight is
# (O, I, kh, kw).
_ARCH_RULES = {
    'llama': {
        'tp': [
            (r'(q_proj|k_proj|v_proj|gate_proj|up_proj)\.weight$',
             P('tp', None)),
            (r'(o_proj|down_proj)\.weight$', P(None, 'tp')),
            (r'(embed_tokens|lm_head)\.weight$', P('tp', None)),
            (r'(layernorm|norm)\.weight$', P()),
            (r'\.bias$', P()),
        ],
        'fsdp': [
            (r'(layernorm|norm)\.weight$', P()),
            (r'\.bias$', P()),
            (r'\.weight$', P('dp')),
        ],
    },
    'resnet': {
        # TP for convnets: shard output channels; BN stats/scales and
        # biases are per-channel 1-d — replicate (a (64,) gather costs
        # more than it saves).
        'tp': [
            (r'(conv|downsample).*weight$', P('tp')),
            (r'(dense|fc|output).*weight$', P('tp', None)),
            (r'(batchnorm|bn|norm)', P()),
            (r'(gamma|beta|running_mean|running_var)$', P()),
            (r'\.bias$', P()),
        ],
        'fsdp': [
            (r'(batchnorm|bn|norm)', P()),
            (r'(gamma|beta|running_mean|running_var)$', P()),
            (r'\.bias$', P()),
            (r'weight$', P('dp')),
        ],
    },
    'bert': {
        'tp': [
            (r'attention.*(query|key|value).*weight$', P('tp', None)),
            (r'(intermediate|ffn_1|ffn1).*weight$', P('tp', None)),
            (r'attention.*(proj|output|out_proj).*weight$', P(None, 'tp')),
            (r'(ffn_2|ffn2|output).*weight$', P(None, 'tp')),
            (r'(word_embed|token_embed|embed|position_weight)',
             P('tp', None)),
            (r'(layer_norm|layernorm|norm)', P()),
            (r'(gamma|beta)$', P()),
            (r'\.bias$', P()),
        ],
        'fsdp': [
            (r'(layer_norm|layernorm|norm)', P()),
            (r'(gamma|beta)$', P()),
            (r'\.bias$', P()),
            (r'weight$', P('dp')),
        ],
    },
    # zero-config fallback for arbitrary blocks: FSDP-style leading-dim
    # sharding for tensors, replicate the 1-d odds and ends. TP has no
    # generic answer — an unknown arch under mode='tp' must bring rules.
    'generic': {
        'fsdp': [
            (lambda name, shape: len(shape) <= 1, P()),
            (r'.*', P('dp')),
        ],
    },
}


def register_rules(arch, mode, rules):
    """Register (or replace) a rule table: ``register_rules('mymodel',
    'tp', [(r'attn.*weight', P('tp', None)), ...])``. Patterns are
    regexes (or ``pred(name, shape)`` callables); first match wins."""
    _ARCH_RULES.setdefault(arch, {})[mode] = list(rules)


def rules_for(arch, mode='tp'):
    """The registered rule table for (arch, mode). Raises KeyError with
    the available tables listed when there is none."""
    tables = _ARCH_RULES.get(arch)
    if tables is None or mode not in tables:
        have = sorted(f'{a}:{m}' for a, ms in _ARCH_RULES.items()
                      for m in ms)
        raise KeyError(
            f'no partition rules registered for arch={arch!r} '
            f'mode={mode!r}; have {have}. Register a table with '
            'mx.sharding.register_rules(arch, mode, rules).')
    return list(tables[mode])


def list_archs():
    return {a: sorted(ms) for a, ms in _ARCH_RULES.items()}


_ARCH_HINTS = (
    ('llama', 'llama'), ('bert', 'bert'), ('resnet', 'resnet'),
)


def infer_arch(block):
    """Best-effort architecture tag for a Gluon block (class-name match
    down the child tree); ``'generic'`` when nothing matches."""
    seen, stack = set(), [block]
    while stack:
        b = stack.pop()
        if id(b) in seen:
            continue
        seen.add(id(b))
        cls = type(b).__name__.lower()
        for hint, arch in _ARCH_HINTS:
            if hint in cls:
                return arch
        stack.extend(getattr(b, '_children', {}).values())
    return 'generic'
