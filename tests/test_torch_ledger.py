"""``mxnet_tpu_torch/ops/ledger.py`` accounts for every name of the JAX
package's op registry exactly once: registered in the port, or pending
under a ROADMAP label that ROADMAP.md names; and ``mx.np`` resolves no
pending name to its host-numpy fallback."""

from pathlib import Path

import numpy as np
import pytest

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import ledger, registry as treg

ROOT = Path(__file__).resolve().parents[1]


def test_every_jax_op_is_registered_or_pending_exactly_once():
    jax_names = set(jreg.list_ops())
    ported = set(treg.list_ops())
    pending = ledger.pending()
    assert not (set(pending) & ported), sorted(set(pending) & ported)
    assert sum(len(v) for v in ledger.PENDING.values()) == len(pending), \
        'a name is pending under two labels'
    assert set(pending) <= jax_names, sorted(set(pending) - jax_names)
    missing = jax_names - ported - set(pending)
    assert not missing, sorted(missing)
    assert ported <= jax_names, sorted(ported - jax_names)


def test_pending_labels_are_roadmap_items():
    text = (ROOT / 'ROADMAP.md').read_text()
    for label in ledger.LABELS:
        assert f'**{label}' in text, label


def test_ported_ops_reach_their_namespaces():
    import mxnet_tpu_torch as mx
    for name, op in treg.list_ops().items():
        if name != op.name:
            continue
        if 'np' in op.namespaces:
            assert hasattr(mx.np, name) and hasattr(mx.npx, name), name
        if 'nd' in op.namespaces:
            assert hasattr(mx.nd, name), name


def test_pending_put_along_axis_raises_instead_of_a_host_copy():
    # numpy's put_along_axis on a host copy would return None and leave
    # the array as it was
    import mxnet_tpu_torch as mx
    with mx.cpu():
        a = mx.np.zeros((2, 3))
        with pytest.raises(NotImplementedError, match='A3 rest'):
            mx.np.put_along_axis(a, mx.np.zeros((2, 1), dtype='int32'),
                                 1.0, 1)
    assert not hasattr(mx.np, 'put_along_axis')


def test_no_pending_name_reaches_the_host_fallback():
    import mxnet_tpu_torch as mx
    for name, label in ledger.pending().items():
        with pytest.raises(ledger.PendingOpError, match=label):
            getattr(mx.np, name)
    # a name the reference does not register keeps the host fallback
    got = mx.np.extract(np.array([True, False, True]),
                        mx.np.array(np.arange(3.0), ctx=mx.cpu()))
    np.testing.assert_array_equal(got.asnumpy(), [0.0, 2.0])
