"""``mxnet_tpu_torch.amp`` against the JAX package's ``mx.amp``, on the CPU.

The op lists, ``amp_cast``/``amp_multicast`` over float, integer and
mixed inputs, the policy calls, a ``DynamicLossScaler`` through a
sequence with overflows (the scale halves on each and doubles after a
clean window) and its one-sync overflow check, ``scale_loss`` then
``unscale`` then ``Trainer.step`` in both packages: a clean step
unscales the gradients and updates, and a step after an overflow zeroes
the gradients and updates nothing (weights, momentum slots and update
counts as they were), as ``tests/test_misc.py`` holds the JAX package to.
``convert_hybrid_block`` casts every parameter. ``convert_symbol`` and
``convert_model`` on ``tests/test_profiler_amp.py``'s traced MLP put their
casts where the JAX package's do (excluded and conditional nodes too),
drop them from the file unless told to keep them, compute in bf16 within
bf16 tolerance of the JAX package, and cast the same optional parameters.
"""

import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp, autograd as jag, gluon as jgl
from mxnet_tpu.ops.registry import invoke as jinvoke

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as tamp, gluon as tgl
from mxnet_tpu_torch.ops.registry import invoke as tinvoke


@pytest.fixture(autouse=True)
def amp_state():
    """Each test starts with AMP off in both packages and leaves it so."""
    saved = [dict(m._state) for m in (jamp, tamp)]
    for m in (jamp, tamp):
        m._state.update(enabled=False, dtype='bfloat16', loss_scale=1.0)
    with tmx.cpu():
        yield
    for m, st in zip((jamp, tamp), saved):
        m._state.clear()
        m._state.update(st)


def test_lists_are_the_jax_packages():
    for name in ('TARGET_DTYPE_OPS', 'FP32_OPS', 'WIDEST_TYPE_CASTS'):
        assert getattr(tamp.lists, name) == getattr(jamp.lists, name)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'float16',
                                   'int32'])
@pytest.mark.parametrize('to', ['bfloat16', 'float32'])
def test_amp_cast_matches(dtype, to):
    """Floats take the target dtype with the same values; integer ids
    pass through unchanged."""
    x = np.array([1.5, -2.25, 3.0], np.float32).astype(dtype)
    want = jinvoke('amp_cast', (jmx.np.array(x).astype(dtype),),
                   {'dtype': to})
    got = tinvoke('amp_cast', (tmx.np.array(x).astype(dtype),),
                  {'dtype': to})
    assert str(got.dtype) == str(want.dtype)
    np.testing.assert_array_equal(got.asnumpy().astype(np.float64),
                                  want.asnumpy().astype(np.float64))


@pytest.mark.parametrize('dtypes', [('float32', 'bfloat16'),
                                    ('bfloat16', 'float16', 'float32'),
                                    ('bfloat16', 'bfloat16')])
@pytest.mark.parametrize('narrow', [False, True])
def test_amp_multicast_matches(dtypes, narrow):
    """The widest dtype (or the narrowest with ``cast_narrow``, the first
    of a tie), as the JAX op picks it."""
    xs = [np.full((2,), i + 0.5, np.float32).astype(d)
          for i, d in enumerate(dtypes)]
    want = jinvoke('amp_multicast', [jmx.np.array(x).astype(d)
                                     for x, d in zip(xs, dtypes)],
                   {'cast_narrow': narrow})
    got = tinvoke('amp_multicast', [tmx.np.array(x).astype(d)
                                    for x, d in zip(xs, dtypes)],
                  {'cast_narrow': narrow})
    assert [str(g.dtype) for g in got] == [str(w.dtype) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.asnumpy().astype(np.float64),
                                      w.asnumpy().astype(np.float64))


def test_policy_calls_match():
    for m in (jamp, tamp):
        assert not m.is_enabled() and m.compute_dtype() == 'float32'
        m.init()
        assert m.is_enabled() and m.compute_dtype() == 'bfloat16'
        m.init(target_dtype='float16')
        assert m.compute_dtype() == 'float16'
        p = m.Policy()
        assert (p.compute_dtype, p.param_dtype, p.output_dtype) == (
            'bfloat16', 'float32', 'float32')


def test_dynamic_loss_scaler_follows_the_jax_one():
    """The same overflow sequence gives the same scales."""
    seq = [False, True, False, False, False, True, True, False, False]
    scales = []
    for m in (jamp, tamp):
        s = m.DynamicLossScaler(init_scale=2.0 ** 4, scale_window=3)
        got = []
        for overflow in seq:
            s.update_scale(overflow)
            got.append(s.loss_scale)
        scales.append(got)
    assert scales[0] == scales[1]


def _dense_pair():
    jnet = jgl.nn.Dense(3, in_units=4)
    jnet.initialize()
    tnet = tgl.nn.Dense(3, in_units=4)
    tnet.initialize()
    tnet.load_dict({k: p.data().asnumpy()
                    for k, p in jnet.collect_params().items()})
    return jnet, tnet


def _state(trainer, net):
    weights = {k: p.data().asnumpy().copy()
               for k, p in net.collect_params().items()}
    slots = {i: np.asarray(s.asnumpy() if hasattr(s, 'asnumpy')
                           else s.numpy()).copy()
             for i, s in trainer._states.items()}
    return weights, slots, dict(trainer.optimizer._index_update_count)


def test_scale_unscale_and_a_skipped_step_match_the_jax_trainer():
    """fp16 loss scaling in both packages: a clean step unscales the
    gradients (equal to the unscaled ones) and updates; after an overflow
    ``unscale`` zeroes the gradients, halves the scale and arms the skip,
    and the next ``step`` leaves weights, momenta and update counts as
    they were; the step after that updates again."""
    jnet, tnet = _dense_pair()
    x = np.random.default_rng(0).uniform(-1, 1, (2, 4)).astype(np.float32)
    runs = []
    for mx, amp, ag, gl, net in ((jmx, jamp, jag, jgl, jnet),
                                 (tmx, tamp, tmx.autograd, tgl, tnet)):
        amp.init(target_dtype='float16')
        trainer = gl.Trainer(net.collect_params(), 'sgd',
                             {'learning_rate': 0.1, 'momentum': 0.9,
                              'wd': 0.1})
        amp.init_trainer(trainer)
        scaler = trainer._amp_loss_scaler
        s0 = scaler.loss_scale
        log = []

        def step(poison):
            with ag.record():
                out = net(mx.np.array(x))
                with amp.scale_loss((out ** 2).mean(), trainer) as scaled:
                    loss = scaled
            loss.backward()
            if poison:
                g = net.weight.grad()
                g[:] = mx.np.array(np.full(g.shape, np.inf, np.float32))
            ok = amp.unscale(trainer)
            grad = net.weight.grad().asnumpy().copy()
            trainer.step(2)
            log.append((ok, scaler.loss_scale, grad,
                        _state(trainer, net)))

        step(False)
        step(True)
        step(False)
        runs.append((s0, log))
    (js0, jlog), (ts0, tlog) = runs
    assert js0 == ts0 > 1.0
    assert [(ok, s) for ok, s, _, _ in tlog] == \
        [(ok, s) for ok, s, _, _ in jlog] == \
        [(True, js0), (False, js0 / 2), (True, js0 / 2)]
    for (_, _, tg, (tw, tsl, tc)), (_, _, jg, (jw, jsl, jc)) in zip(tlog,
                                                                   jlog):
        np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)
        assert tc == jc
        for k in jw:
            np.testing.assert_allclose(tw[k], jw[k], rtol=1e-5, atol=1e-6)
        for i in jsl:
            np.testing.assert_allclose(tsl[i], jsl[i], rtol=1e-5, atol=1e-6)
    # the skipped step moved nothing, and its gradient was zeroed
    _, _, g, (w1, s1, c1) = tlog[0]
    _, _, g2, (w2, s2, c2) = tlog[1]
    assert (g2 == 0).all() and np.abs(g).max() < 10
    assert c1 == c2
    for k in w1:
        np.testing.assert_array_equal(w1[k], w2[k])
    for i in s1:
        np.testing.assert_array_equal(s1[i], s2[i])
    assert tlog[2][3][2] != c2


def test_overflow_check_is_one_host_sync_over_every_gradient():
    """``has_overflow`` sees an inf in any gradient, of a Gluon parameter
    or a ``torch.nn`` one."""
    _, tnet = _dense_pair()
    with tmx.autograd.record():
        loss = tnet(tmx.np.ones((1, 4))).sum()
    loss.backward()
    scaler = tamp.DynamicLossScaler()
    params = list(tnet.collect_params().values())
    assert not scaler.has_overflow(params)
    leaf = torch.nn.Parameter(torch.ones(3))
    leaf.grad = torch.tensor([1.0, float('nan'), 0.0])
    assert scaler.has_overflow(params + [leaf])
    tnet.bias.grad()[:] = tmx.np.array(np.array([0, np.inf, 0], 'f'))
    assert scaler.has_overflow(params)


def test_convert_hybrid_block_casts_as_the_jax_one():
    jnet, tnet = _dense_pair()
    jamp.convert_hybrid_block(jnet)
    assert tamp.convert_hybrid_block(tnet) is tnet
    assert {k: str(p.data().dtype) for k, p in
            tnet.collect_params().items()} == \
        {k: str(p.data().dtype) for k, p in jnet.collect_params().items()} \
        == {'weight': 'bfloat16', 'bias': 'bfloat16'}
    x = np.ones((2, 4), np.float32)
    got = tnet(tmx.np.array(x).astype('bfloat16'))
    want = jnet(jmx.np.array(x).astype('bfloat16'))
    np.testing.assert_allclose(got.asnumpy().astype(np.float32),
                               want.asnumpy().astype(np.float32),
                               rtol=1e-2)


def _traced_mlp():
    """``tests/test_profiler_amp.py``'s traced MLP (Dense, LayerNorm,
    Dense) in both packages with the JAX net's weights."""
    nets = []
    for mx, gl in ((jmx, jgl), (tmx, tgl)):
        net = gl.nn.HybridSequential(
            gl.nn.Dense(16, in_units=8), gl.nn.LayerNorm(),
            gl.nn.Dense(4, in_units=16))
        net.initialize()
        nets.append((mx, net))
    x = np.random.default_rng(2).standard_normal((2, 8)).astype(np.float32)
    (jm, jnet), (tm, tnet) = nets
    jnet(jm.np.array(x))
    tnet(tm.np.array(x))
    tnet.load_dict({k: p.data().asnumpy()
                    for k, p in jnet.collect_params().items()})
    return [(mx, net, net._trace_symbol(mx.np.array(x)),
             {k: p.data() for k, p in net.collect_params().items()}, x)
            for mx, net in nets]


def _casts(sym):
    """Each op node's inputs as (source op, cast dtype) pairs, by node
    order: where the rewrite put its casts."""
    return [(n.op, [(i.op, str(i.kwargs.get('dtype'))
                     if i.op == 'amp_cast' else None) for i, _ in n.inputs])
            for n in sym._topo() if n.op != 'null']


@pytest.mark.parametrize('fn', ['convert_symbol', 'convert_model'])
def test_symbol_passes_match_the_jax_package(fn):
    """``convert_symbol`` puts the casts where the JAX package does
    (fully_connected's inputs to bf16, layer_norm's to fp32, one cast per
    source and dtype), leaving the input symbol as it was;
    ``convert_model``'s converted graph computes in bf16 within bf16
    tolerance of the JAX package's, its parameters fp32 at rest."""
    runs = []
    for mx, net, sym, params, x in _traced_mlp():
        mod = jamp if mx is jmx else tamp
        if fn == 'convert_symbol':
            csym = mod.convert_symbol(sym, target_dtype='bfloat16')
            assert 'amp_cast' not in [n.op for n in sym._topo()]
            runs.append(_casts(csym))
        else:
            csym, cargs, caux = mod.convert_model(sym, params)
            assert caux == {}
            assert {str(v.dtype) for v in cargs.values()} == {'float32'}
            got = csym.eval(**cargs, data=mx.np.array(x))[0]
            want = net(mx.np.array(x)).asnumpy()
            assert not np.array_equal(got.asnumpy(), want)     # bf16 ran
            runs.append(got.asnumpy().astype(np.float32))
    if fn == 'convert_symbol':
        assert runs[1] == runs[0]
        assert ('fully_connected', [('amp_cast', 'bfloat16')] * 3) in runs[1]
        assert ('layer_norm', [('amp_cast', 'float32')] * 3) in runs[1]
    else:
        np.testing.assert_allclose(runs[1], runs[0], rtol=1e-2, atol=1e-2)


def test_excluded_and_conditional_match_the_jax_package():
    got = []
    for mx, net, sym, params, x in _traced_mlp():
        mod = jamp if mx is jmx else tamp
        fc = [n.name for n in sym._topo() if n.op == 'fully_connected']
        got.append((
            _casts(mod.convert_symbol(sym, excluded_sym_names=[fc[0]])),
            _casts(mod.convert_symbol(sym, conditional_fp32_ops=[
                ('fully_connected', 'num_hidden', [4])]))))
    assert got[1] == got[0]
    excluded, conditional = got[1]
    assert excluded[0] == ('fully_connected', [('null', None)] * 3)
    assert conditional[-1] == ('fully_connected',
                               [('amp_cast', 'float32')] * 3)


def test_tojson_removes_amp_cast_as_the_jax_package():
    files = []
    for mx, net, sym, params, x in _traced_mlp():
        mod = jamp if mx is jmx else tamp
        csym = mod.convert_symbol(sym)
        clean = json.loads(csym.tojson())
        kept = json.loads(csym.tojson(remove_amp_cast=False))
        assert all(n['op'] != 'amp_cast' for n in clean['nodes'])
        assert any(n['op'] == 'amp_cast' for n in kept['nodes'])
        files.append([[{k: v for k, v in n.items() if k != 'name'}
                       for n in d['nodes']] for d in (clean, kept)])
    assert files[1] == files[0]


def test_convert_model_cast_optional_params_as_the_jax_package():
    """Only parameters whose every consumer is a bf16 cast are cast: the
    LayerNorm's gamma and beta stay fp32."""
    dtypes = []
    for mx, net, sym, params, x in _traced_mlp():
        mod = jamp if mx is jmx else tamp
        _, cargs, _ = mod.convert_model(sym, params,
                                        cast_optional_params=True)
        dtypes.append({k: str(v.dtype) for k, v in cargs.items()})
    assert dtypes[1] == dtypes[0]
    assert dtypes[1]['0.weight'] == 'bfloat16'
    assert dtypes[1]['1.gamma'] == dtypes[1]['1.beta'] == 'float32'
