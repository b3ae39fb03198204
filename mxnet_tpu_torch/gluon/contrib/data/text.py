"""Contrib text datasets (counterpart of
``mxnet_tpu/gluon/contrib/data/text.py``, reference
``python/mxnet/gluon/contrib/data/text.py``: the WikiText language-model
datasets).

The datasets load from local files only (``root`` holding
``wiki.{train,validation,test}.tokens``); where the reference downloads,
a missing file raises. The token count and the vocabulary are copies of
the JAX package's ``contrib/text`` (``utils.count_tokens_from_str``,
``vocab.Vocabulary``): index 0 the unknown token, then the tokens by
count (descending) and then lexically, so both packages give a token the
same id.
"""

import collections
import os
import re

import numpy as onp

from ...data.dataset import SimpleDataset

__all__ = ['WikiText2', 'WikiText103']


def _count_tokens(source_str, token_delim=' ', seq_delim='\n'):
    """Token counts of a delimited string (reference utils.py:31)."""
    return collections.Counter(
        filter(None, re.split(token_delim + '|' + seq_delim, source_str)))


class _Vocabulary:
    """Tokens indexed by count (reference vocab.py:30): index 0 the
    unknown token, then the tokens of ``counter`` with at least
    ``min_freq`` occurrences, by count (descending) and then lexically."""

    def __init__(self, counter, min_freq=1, unknown_token='<unk>'):
        self.unknown_token = unknown_token
        pairs = sorted(((t, c) for t, c in counter.items()
                        if t != unknown_token),
                       key=lambda tc: (-tc[1], tc[0]))
        self.idx_to_token = [unknown_token] + [t for t, c in pairs
                                               if c >= min_freq]
        self.token_to_idx = {t: i for i, t in enumerate(self.idx_to_token)}

    def __len__(self):
        return len(self.idx_to_token)

    def to_indices(self, tokens):
        """Index of each token (0 for an unknown one)."""
        return [self.token_to_idx.get(t, 0) for t in tokens]


class _LanguageModelDataset(SimpleDataset):
    """Token-id sequence dataset cut into `seq_len` windows (reference
    _LanguageModelDataset + _WikiText behavior)."""

    def __init__(self, root, segment, seq_len, namespace, vocab=None):
        self._root = os.path.expanduser(root)
        self._segment = segment
        self._seq_len = seq_len
        self._namespace = namespace
        path = self._find_file()
        tokens = self._tokenize(path)
        if vocab is None:
            vocab = _Vocabulary(_count_tokens(' '.join(tokens)))
        # shared across segments: pass the train split's vocabulary when
        # building validation/test so token ids line up (reference
        # _LanguageModelDataset vocab parameter)
        self.vocabulary = vocab
        ids = onp.asarray(self.vocabulary.to_indices(tokens),
                          dtype=onp.int32)
        n = (len(ids) - 1) // seq_len
        data = ids[:n * seq_len].reshape(n, seq_len)
        target = ids[1:n * seq_len + 1].reshape(n, seq_len)
        super().__init__(list(zip(data, target)))

    def _find_file(self):
        for name in (f'wiki.{self._segment}.tokens',
                     f'{self._segment}.txt'):
            p = os.path.join(self._root, name)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(
            f'{self._namespace}: no local data under {self._root!r} '
            f'(place wiki.{self._segment}.tokens there; the reference '
            f'would download it)')

    @staticmethod
    def _tokenize(path):
        with open(path, encoding='utf-8') as f:
            return f.read().replace('\n', ' <eos> ').split()


class WikiText2(_LanguageModelDataset):
    """WikiText-2 (reference contrib/data/text.py:WikiText2)."""

    def __init__(self, root='~/.mxnet/datasets/wikitext-2',
                 segment='train', seq_len=35, vocab=None):
        super().__init__(root, segment, seq_len, 'wikitext-2',
                         vocab=vocab)


class WikiText103(_LanguageModelDataset):
    """WikiText-103 (reference contrib/data/text.py:WikiText103)."""

    def __init__(self, root='~/.mxnet/datasets/wikitext-103',
                 segment='train', seq_len=35, vocab=None):
        super().__init__(root, segment, seq_len, 'wikitext-103',
                         vocab=vocab)
