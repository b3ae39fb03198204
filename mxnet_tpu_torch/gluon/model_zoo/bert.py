"""The BERT family on the port's Gluon.

Counterpart of ``mxnet_tpu/gluon/model_zoo/bert.py``, with the same
structure and parameter names (cells registered as ``cell{i}``, one
fused ``qkv`` projection, the MLM decoder tied to the word embedding), so
that weights carry across by name. Every block is a ``HybridBlock``:
``hybridize()`` replays a predict-mode call from a CUDA graph on the card.

On the card the net reaches three of the port's kernels through
registered ops: the fused norm's LayerNorm mode (``BERTLayerNorm``, eps
1e-12: two a cell, the embedding's and the decoder's), flash attention's
forward (``npx.multi_head_attention`` without a mask, one a cell; its
head dim must be one the kernel is built for, 32, 64 or 128), and, through
the Trainer, the fused Adam or SGD-momentum step. With ``valid_length``
the attention takes the masked plain path, as the reference leaves it to
XLA.

Under ``mx.sharding`` with tensor parallelism the fused ``qkv`` weight is
laid out in three blocks (``shard_blocks``): each rank of ``tp`` holds its
heads of Q, K and V, so that the split and the attention stay local (6 of
BERT-base's 12 heads a rank at tp = 2). The registry's ``('bert', 'tp')``
table, copied from the JAX package, matches no rule for ``qkv``, the pooler,
the MLM transform, the classifier or ``decoder_bias``, and its ``fsdp``
table none for ``decoder_bias`` (ROADMAP C12): :func:`bert_partition_rules`
is the table with ``qkv`` column-parallel and the rest replicated.
"""

from ..block import HybridBlock
from ..parameter import Parameter
from .. import nn
from ... import initializer

__all__ = ['BERTLayerNorm', 'BERTSelfAttention', 'BERTEncoderCell',
           'BERTEncoder', 'BERTModel', 'get_bert_model', 'bert_12_768_12',
           'bert_24_1024_16', 'load_hf_state_dict', 'bert_partition_rules']


def bert_partition_rules(mode='tp'):
    """The registry's ``('bert', mode)`` rules, for ``tp`` with the fused
    ``qkv`` projection column-parallel first, and every parameter they
    leave unmatched replicated last."""
    from ...sharding import rules as _rules
    P = _rules.PartitionSpec
    table = [(r'attention.*qkv.*weight$', P('tp', None))] \
        if mode == 'tp' else []
    return table + _rules.rules_for('bert', mode) + [(r'.*', P())]


class BERTLayerNorm(nn.LayerNorm):
    """LayerNorm with BERT's epsilon."""

    def __init__(self, in_channels=0, epsilon=1e-12, **kwargs):
        super().__init__(epsilon=epsilon, in_channels=in_channels, **kwargs)


class BERTSelfAttention(HybridBlock):
    """Multi-head self-attention, Q, K and V from one fused projection."""

    def __init__(self, units, num_heads, dropout=0.0):
        super().__init__()
        self._units = units
        self._num_heads = num_heads
        self.qkv = nn.Dense(3 * units, flatten=False)
        # Q, K and V each split alike when the rows are sharded
        self.qkv.weight.shard_blocks = {0: 3}
        self.qkv.bias.shard_blocks = {0: 3}
        self.proj = nn.Dense(units, flatten=False)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x, mask=None):
        from ... import npx
        q, k, v = npx.split(self.qkv(x), 3, axis=-1)
        out = npx.multi_head_attention(q, k, v, self._num_heads, mask=mask)
        out = self.proj(out)
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class BERTEncoderCell(HybridBlock):
    """Post-LN encoder cell: attention, add and norm, FFN, add and norm."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0):
        super().__init__()
        self.attention = BERTSelfAttention(units, num_heads, dropout)
        self.ln1 = BERTLayerNorm(in_channels=units)
        self.ffn1 = nn.Dense(hidden_size, flatten=False)
        self.act = nn.GELU()
        self.ffn2 = nn.Dense(units, flatten=False)
        self.ln2 = BERTLayerNorm(in_channels=units)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x, mask=None):
        x = self.ln1(x + self.attention(x, mask))
        h = self.ffn2(self.act(self.ffn1(x)))
        if self.dropout is not None:
            h = self.dropout(h)
        return self.ln2(x + h)


class BERTEncoder(HybridBlock):
    """A stack of encoder cells (position embeddings live in
    :class:`BERTModel`)."""

    def __init__(self, num_layers, units, hidden_size, num_heads,
                 max_length=512, dropout=0.0):
        super().__init__()
        self._max_length = max_length
        self._units = units
        self.dropout = nn.Dropout(dropout) if dropout else None
        self.cells = []
        for i in range(num_layers):
            cell = BERTEncoderCell(units, hidden_size, num_heads, dropout)
            self.register_child(cell, f'cell{i}')
            self.cells.append(cell)

    def forward(self, x, mask=None):
        if self.dropout is not None:
            x = self.dropout(x)
        for cell in self.cells:
            x = cell(x, mask)
        return x


class BERTModel(HybridBlock):
    """BERT with the MLM and NSP heads.

    Inputs ``token_ids (B, T)``, ``token_types (B, T)`` and an optional
    ``valid_length (B,)``. Outputs the sequence encoding ``(B, T, U)``;
    with ``use_pooler`` the pooled ``[CLS]`` ``(B, U)``, with
    ``use_decoder`` the MLM logits ``(B, T, vocab)``, with
    ``use_classifier`` the NSP logits ``(B, 2)``.
    """

    def __init__(self, vocab_size=30522, token_type_vocab_size=2,
                 units=768, hidden_size=3072, num_layers=12, num_heads=12,
                 max_length=512, dropout=0.1, use_pooler=True,
                 use_decoder=True, use_classifier=True, **kwargs):
        super().__init__()
        if use_classifier and not use_pooler:
            raise ValueError(
                'use_classifier=True requires use_pooler=True (the NSP head '
                'classifies the pooled [CLS] representation)')
        self._units = units
        self.word_embed = nn.Embedding(vocab_size, units)
        self.token_type_embed = nn.Embedding(token_type_vocab_size, units)
        self.position_weight = Parameter(
            'position_weight', shape=(max_length, units),
            init=initializer.Normal(0.02))
        self.embed_ln = BERTLayerNorm(in_channels=units)
        self.encoder = BERTEncoder(num_layers, units, hidden_size,
                                   num_heads, max_length, dropout)
        self.use_pooler = use_pooler
        self.use_decoder = use_decoder
        self.use_classifier = use_classifier
        if use_pooler:
            self.pooler = nn.Dense(units, activation='tanh', flatten=False)
        if use_decoder:
            # the MLM head's output projection is the word embedding's
            self.decoder_transform = nn.Dense(units, flatten=False)
            self.decoder_act = nn.GELU()
            self.decoder_ln = BERTLayerNorm(in_channels=units)
            self.decoder_bias = Parameter(
                'decoder_bias', shape=(vocab_size,),
                init=initializer.Zero())
        if use_classifier:
            self.classifier = nn.Dense(2, flatten=False)

    @staticmethod
    def _attention_mask(token_ids, valid_length):
        from ... import np as mnp
        if valid_length is None:
            return None
        t = token_ids.shape[1]
        pos = mnp.arange(t, ctx=token_ids.context).reshape(1, t)
        valid = pos < mnp.expand_dims(valid_length, -1)          # (B, T)
        return mnp.expand_dims(mnp.expand_dims(valid, 1), 1)    # (B,1,1,T)

    def forward(self, token_ids, token_types=None, valid_length=None):
        from ... import np as mnp
        x = self.word_embed(token_ids)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        # positions are added before the embedding LayerNorm (BERT's order)
        pos = self.position_weight.data()[:token_ids.shape[1]]
        x = self.embed_ln(x + mnp.expand_dims(pos, 0))
        seq = self.encoder(x, self._attention_mask(token_ids, valid_length))
        outputs = [seq]
        if self.use_pooler:
            pooled = self.pooler(seq[:, 0, :])
            outputs.append(pooled)
        if self.use_decoder:
            h = self.decoder_ln(self.decoder_act(self.decoder_transform(seq)))
            emb = self.word_embed.weight.data()
            outputs.append(mnp.matmul(h, emb.T) + self.decoder_bias.data())
        if self.use_classifier and self.use_pooler:
            outputs.append(self.classifier(pooled))
        return tuple(outputs) if len(outputs) > 1 else outputs[0]


_BERT_CONFIGS = {
    'bert_12_768_12': dict(units=768, hidden_size=3072, num_layers=12,
                           num_heads=12),
    'bert_24_1024_16': dict(units=1024, hidden_size=4096, num_layers=24,
                            num_heads=16),
}


def get_bert_model(model_name='bert_12_768_12', vocab_size=30522,
                   max_length=512, dropout=0.1, **kwargs):
    cfg = dict(_BERT_CONFIGS[model_name])
    cfg.update(kwargs)
    return BERTModel(vocab_size=vocab_size, max_length=max_length,
                     dropout=dropout, **cfg)


def bert_12_768_12(**kwargs):
    """BERT-base (110 M parameters)."""
    return get_bert_model('bert_12_768_12', **kwargs)


def bert_24_1024_16(**kwargs):
    """BERT-large (340 M parameters)."""
    return get_bert_model('bert_24_1024_16', **kwargs)


def _hf_names(n_layers):
    """``[(our name, HF name or tuple of the HF names concatenated on
    axis 0)]`` for a net of ``n_layers`` cells and its heads."""
    pairs = [('word_embed.weight', 'embeddings.word_embeddings.weight'),
             ('token_type_embed.weight',
              'embeddings.token_type_embeddings.weight'),
             ('embed_ln.gamma', 'embeddings.LayerNorm.weight'),
             ('embed_ln.beta', 'embeddings.LayerNorm.bias')]
    for i in range(n_layers):
        hf, ours = f'encoder.layer.{i}.', f'encoder.cell{i}.'
        att = hf + 'attention.self.'
        pairs += [
            (ours + 'attention.qkv.weight',
             tuple(att + n + '.weight' for n in ('query', 'key', 'value'))),
            (ours + 'attention.qkv.bias',
             tuple(att + n + '.bias' for n in ('query', 'key', 'value'))),
            (ours + 'attention.proj.weight',
             hf + 'attention.output.dense.weight'),
            (ours + 'attention.proj.bias', hf + 'attention.output.dense.bias'),
            (ours + 'ln1.gamma', hf + 'attention.output.LayerNorm.weight'),
            (ours + 'ln1.beta', hf + 'attention.output.LayerNorm.bias'),
            (ours + 'ffn1.weight', hf + 'intermediate.dense.weight'),
            (ours + 'ffn1.bias', hf + 'intermediate.dense.bias'),
            (ours + 'ffn2.weight', hf + 'output.dense.weight'),
            (ours + 'ffn2.bias', hf + 'output.dense.bias'),
            (ours + 'ln2.gamma', hf + 'output.LayerNorm.weight'),
            (ours + 'ln2.beta', hf + 'output.LayerNorm.bias')]
    return pairs


def load_hf_state_dict(net, state_dict):
    """Load HuggingFace-Transformers BERT weights (a state dict of tensors
    or arrays, read locally) into an initialized :class:`BERTModel`
    (reference ``bert.py:214``): HF's separate query, key and value
    projections concatenate into ``qkv``; the pooler, MLM and NSP heads
    load where the net has them and the dict holds them."""
    import numpy as _np

    def to_np(v):
        if hasattr(v, 'detach'):
            v = v.detach().cpu().float().numpy()
        return _np.asarray(v, _np.float32)

    sd = {(k[len('bert.'):] if k.startswith('bert.') else k): to_np(v)
          for k, v in state_dict.items()}
    params = net.collect_params()

    def put(name, value):
        p = params[name]
        if tuple(p.shape) != value.shape:
            raise ValueError(f'{name}: {value.shape} vs {tuple(p.shape)}')
        p.set_data(value)

    for ours, hf in _hf_names(len(net.encoder.cells)):
        put(ours, _np.concatenate([sd[n] for n in hf], 0)
            if isinstance(hf, tuple) else sd[hf])
    pos = sd['embeddings.position_embeddings.weight']
    put('position_weight', pos[:params['position_weight'].shape[0]])
    heads = []
    if net.use_pooler and 'pooler.dense.weight' in sd:
        heads += [('pooler.weight', 'pooler.dense.weight'),
                  ('pooler.bias', 'pooler.dense.bias')]
    if net.use_decoder and 'cls.predictions.transform.dense.weight' in sd:
        t = 'cls.predictions.transform.'
        heads += [('decoder_transform.weight', t + 'dense.weight'),
                  ('decoder_transform.bias', t + 'dense.bias'),
                  ('decoder_ln.gamma', t + 'LayerNorm.weight'),
                  ('decoder_ln.beta', t + 'LayerNorm.bias'),
                  ('decoder_bias', 'cls.predictions.bias')]
    if net.use_classifier and 'cls.seq_relationship.weight' in sd:
        heads += [('classifier.weight', 'cls.seq_relationship.weight'),
                  ('classifier.bias', 'cls.seq_relationship.bias')]
    for ours, hf in heads:
        put(ours, sd[hf])
    return net
