"""``mxnet_tpu_torch/ops/ledger.py`` accounts for every name of the JAX
package's op registry exactly once: registered in the port, or pending
under a ROADMAP label that ROADMAP.md names; and ``mx.np`` resolves no
pending name to its host-numpy fallback.

The reference's names come from a fresh interpreter that imports
``mxnet_tpu.ops.registry`` and nothing else: the registry the JAX package
ships. Other tests register ops of their own into the live registry of
their process (``tests/test_extensions.py`` loads an extension), and a
test that shares that process must not see them."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import ledger, registry as treg

ROOT = Path(__file__).resolve().parents[1]

_SHIPPED = ('import json\n'
            'from mxnet_tpu.ops.registry import list_ops\n'
            'print(json.dumps(sorted(list_ops())))\n')


@pytest.fixture(scope='module')
def jax_names():
    """The op names of the JAX package's registry as it ships."""
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    out = subprocess.run([sys.executable, '-c', _SHIPPED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _check_ledger(jax_names):
    ported = set(treg.list_ops())
    pending = ledger.pending()
    assert not (set(pending) & ported), sorted(set(pending) & ported)
    assert sum(len(v) for v in ledger.PENDING.values()) == len(pending), \
        'a name is pending under two labels'
    assert set(pending) <= jax_names, sorted(set(pending) - jax_names)
    missing = jax_names - ported - set(pending)
    assert not missing, sorted(missing)
    assert ported <= jax_names, sorted(ported - jax_names)


def test_every_jax_op_is_registered_or_pending_exactly_once(jax_names):
    _check_ledger(jax_names)


def test_ledger_ignores_an_extension_loaded_into_the_live_registry(
        jax_names, tmp_path):
    """An op that an extension registers into this process's JAX registry
    (as ``tests/test_extensions.py`` does) is not one the reference ships:
    the ledger check still passes, and the op is unregistered again."""
    from mxnet_tpu import library
    ext = tmp_path / 'ledger_ext.py'
    ext.write_text('from mxnet_tpu.ops.registry import register\n'
                   "@register('ledger_ext_triple')\n"
                   'def ledger_ext_triple(x):\n'
                   '    return 3 * x\n')
    path = os.path.abspath(str(ext))
    try:
        library.load(path)
        assert 'ledger_ext_triple' in jreg.list_ops()
        _check_ledger(jax_names)
    finally:
        jreg._OPS.pop('ledger_ext_triple', None)
        library._loaded.pop(path, None)
    assert 'ledger_ext_triple' not in jreg.list_ops()


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
    """``put_along_axis``, once pending so that no host copy stood in for
    it, is a registered op of the port: a device op, not the host
    fallback, whose result is the JAX package's."""
    import mxnet_tpu as jmx
    import mxnet_tpu_torch as mx
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    idx = np.array([[2], [0]], np.int32)
    want = jmx.np.put_along_axis(jmx.np.array(a), jmx.np.array(idx), 9.0,
                                 1).asnumpy()
    with mx.cpu():
        got = mx.np.put_along_axis(mx.np.array(a), mx.np.array(idx), 9.0, 1)
    assert 'put_along_axis' in treg.list_ops()
    assert not (mx.np.put_along_axis.__doc__ or '').startswith(
        'Official-numpy HOST')
    np.testing.assert_array_equal(got.asnumpy(), want)


def test_no_pending_name_reaches_the_host_fallback():
    import mxnet_tpu_torch as mx
    for name, label in ledger.pending().items():
        with pytest.raises(ledger.PendingOpError, match=label):
            getattr(mx.np, name)
    # a name the reference does not register keeps the host fallback
    got = mx.np.extract(np.array([True, False, True]),
                        mx.np.array(np.arange(3.0), ctx=mx.cpu()))
    np.testing.assert_array_equal(got.asnumpy(), [0.0, 2.0])
