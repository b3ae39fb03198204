"""Shape-bucket helpers for the serving runtime.

The decode server loads prompts in fixed-size chunks (:func:`chunk_spans`),
so every prefill dispatch has one shape whatever the prompt length.
``MXNET_SERVE_BUCKETS`` declares the batch buckets of the batching tier
(:func:`default_buckets`).
"""

import os

__all__ = ['parse_buckets', 'default_buckets', 'chunk_spans']

_DEFAULT = '1,2,4,8'


def parse_buckets(spec):
    """Parse ``"1,2,4,8"`` into a sorted, deduplicated tuple of ints."""
    try:
        vals = sorted({int(tok) for tok in str(spec).split(',')
                       if tok.strip()})
    except ValueError:
        raise ValueError(
            f'bad bucket spec {spec!r}: want comma-separated ints, '
            f'e.g. "1,2,4,8" (MXNET_SERVE_BUCKETS)') from None
    if not vals or vals[0] < 1:
        raise ValueError(f'bad bucket spec {spec!r}: buckets must be >= 1')
    return tuple(vals)


def default_buckets():
    """Buckets from ``MXNET_SERVE_BUCKETS`` (default ``1,2,4,8``)."""
    return parse_buckets(os.environ.get('MXNET_SERVE_BUCKETS', _DEFAULT))


def chunk_spans(n, chunk):
    """Fixed-size chunk spans covering ``n`` positions: a list of
    ``(start, length)`` with every length == ``chunk`` except possibly
    the last. Chunked prefill (decode server) dispatches one span per
    scheduler iteration."""
    if n < 1:
        raise ValueError(f'need at least one position, got {n}')
    if chunk < 1:
        raise ValueError(f'chunk must be >= 1, got {chunk}')
    return [(s, min(chunk, n - s)) for s in range(0, n, chunk)]
