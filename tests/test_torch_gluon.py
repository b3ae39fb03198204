"""The port's Gluon core against the JAX package's, on the CPU.

The same numpy inputs and weights go through both packages: parameters
(deferred initialization, ``grad_req``, ``set_data`` in place, the zero
grad buffer), blocks (structural names, hooks, ``apply``,
``share_parameters``, ``cast``, ``summary``, the npz format both ways),
every ported layer's forward with weights carried across by name (1e-5:
the same fp32 operations, summed in another order by two libraries),
BatchNorm's running statistics, Dropout, ``hybridize``'s cache keys
(``compile_count`` over the same call sequence), the initializers (the
reference's Xavier and MSRA scales exactly; each distribution's sample
mean and standard deviation), ``gluon.utils`` and the Trainer's
``lr_mult``/``wd_mult``/``grad_req``. The port runs under ``mx.cpu()``;
with no card, an entry point not told so raises.
"""

import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgl, initializer as jinit
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, gluon as tgl
from mxnet_tpu_torch.gluon import nn as tnn

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _rng(seed=0):
    return np.random.default_rng(seed)


def _x(shape, seed=0, scale=1.0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _carry(jnet, tnet, x_shapes, seed=1):
    """Initialize both nets, give both the same numpy weights (N(0, 0.5),
    variances positive), and return them."""
    xs = [_x(s, 7 + i) for i, s in enumerate(x_shapes)]
    jnet.initialize()
    jnet(*[jmx.np.array(x) for x in xs])
    tnet.initialize(ctx=tmx.cpu())
    tnet(*[tmx.np.array(x) for x in xs])
    rng = _rng(seed)
    weights = {}
    for name, p in jnet.collect_params().items():
        w = (rng.standard_normal(p.shape) * 0.5).astype(np.float32)
        if name.endswith(('running_var', 'gamma')):
            w = np.abs(w) + 0.5
        p.set_data(w)
        weights[name] = w
    tnet.load_dict(weights)
    return weights


# ------------------------------------------------------------- parameters
def test_parameter_deferred_init_and_grad_buffer():
    p = tgl.Parameter('weight', shape=(3, 0), allow_deferred_init=True)
    p.initialize(ctx=tmx.cpu())
    with pytest.raises(tgl.DeferredInitializationError):
        p.data()
    p.shape = (3, 4)
    p._finish_deferred_init()
    assert p.data().shape == (3, 4)
    np.testing.assert_array_equal(p.grad().asnumpy(), np.zeros((3, 4)))
    assert p.list_ctx() == [tmx.cpu()]
    with pytest.raises(ValueError, match='incompatible'):
        p.shape = (5, 4)


@pytest.mark.parametrize('req', ['write', 'add', 'null'])
def test_parameter_grad_req_matches_the_jax_parameter(req):
    w = _x((3, 4))
    outs = []
    for mx, P in ((jmx, jgl.Parameter), (tmx, tgl.Parameter)):
        p = P('w', shape=(3, 4), grad_req=req)
        p.initialize()
        p.set_data(mx.np.array(w))
        grads = []
        for k in (1.0, 3.0):
            with mx.autograd.record():
                y = (p.data() * k).sum()
            if req == 'null':
                assert p.list_grad() == []
                continue
            y.backward()
            grads.append(p.grad().asnumpy())
        outs.append(grads)
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, **TOL)


def test_set_data_is_in_place_and_zeroes_the_grad():
    p = tgl.Parameter('w', shape=(4,))
    p.initialize()
    leaf, ptr = p._var, p._var.data_ptr()
    with tmx.autograd.record():
        y = (p.data() * 2).sum()
    y.backward()
    assert float(p.grad().asnumpy().sum()) == 8.0
    p.set_data(np.arange(4, dtype=np.float32))
    assert p._var is leaf and p._var.data_ptr() == ptr
    np.testing.assert_array_equal(p.data().asnumpy(), np.arange(4))
    np.testing.assert_array_equal(p.grad().asnumpy(), np.zeros(4))
    # a write through the NDArray handle lands in the same leaf
    d = p.data()
    d[1] = 7.0
    np.testing.assert_array_equal(p.data().asnumpy(), [0, 7, 2, 3])
    assert p._var is leaf and p.data()._data is leaf
    p.zero_grad()
    p.grad_req = 'null'
    assert p.list_grad() == [] and not p._var.requires_grad


def test_constant_is_not_differentiable():
    c = tgl.Constant(np.ones((2, 2)))
    c.initialize()
    assert c.grad_req == 'null' and c.data().dtype == np.float32


# ----------------------------------------------------------------- blocks
def _nested(nn):
    class Inner(nn.HybridSequential):
        def __init__(self):
            super().__init__()
            self.proj = nn.Dense(5, in_units=4)
            self.norm = nn.LayerNorm(in_channels=5)

        def forward(self, x):
            return self.norm(self.proj(x))

    net = nn.HybridSequential()
    net.add(nn.Dense(4, in_units=3, activation='relu'), Inner(),
            nn.BatchNorm(in_channels=5))
    return net


def test_collect_params_names_equal_the_jax_blocks():
    jnet, tnet = _nested(jgl.nn), _nested(tnn)
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    assert list(tnet.collect_params('.*weight')) == \
        list(jnet.collect_params('.*weight'))
    assert repr(tnet) == repr(jnet)


def test_hooks_apply_share_cast_and_summary(capsys):
    net = _nested(tnn)
    net.initialize()
    seen = []
    net.register_forward_pre_hook(lambda b, a: seen.append('pre'))
    net.register_forward_hook(lambda b, a, o: seen.append(o.shape))
    x = tmx.np.array(_x((2, 3)))
    net(x)
    assert seen == ['pre', (2, 5)]
    names = []
    net.apply(lambda b: names.append(type(b).__name__))
    assert names[-1] == 'HybridSequential' and 'Dense' in names
    other = _nested(tnn)
    other.initialize()
    net.share_parameters(other.collect_params('.*proj'))
    assert net.collect_params()['1.proj.weight'] is \
        other.collect_params()['1.proj.weight']
    net.cast('float16')
    assert all(p.data().dtype == np.float16
               for p in net.collect_params().values())
    net.cast('float32')
    table = net.summary(x)
    assert 'Total params: ' in table and '1.proj.weight' in capsys.readouterr().out


def test_save_load_round_trip_and_across_packages(tmp_path):
    jnet, tnet = _nested(jgl.nn), _nested(tnn)
    _carry(jnet, tnet, [(2, 3)])
    x = _x((2, 3), 3)
    # a file the JAX package saved loads into the port ...
    jnet.save_parameters(str(tmp_path / 'jax.npz'))
    fresh = _nested(tnn)
    fresh.load_parameters(str(tmp_path / 'jax.npz'), ctx=tmx.cpu())
    np.testing.assert_allclose(fresh(tmx.np.array(x)).asnumpy(),
                               jnet(jmx.np.array(x)).asnumpy(), **TOL)
    # ... and the other way round, and the port's own round trip
    fresh.save_parameters(str(tmp_path / 'port.npz'))
    back = _nested(jgl.nn)
    back.load_parameters(str(tmp_path / 'port.npz'))
    np.testing.assert_allclose(back(jmx.np.array(x)).asnumpy(),
                               jnet(jmx.np.array(x)).asnumpy(), **TOL)
    with pytest.raises(KeyError, match='missing'):
        _nested(tnn).load_dict({'0.weight': np.zeros((4, 3), np.float32)})
    with pytest.raises(KeyError, match='not parameters'):
        tnet.load_dict({'nope': np.zeros(1)}, allow_missing=True)


def test_ndarray_map_files_cross_packages(tmp_path):
    a = {'w': _x((2, 3)), 'b': np.arange(4, dtype=np.int32)}
    jmx.npx.save(str(tmp_path / 'j.npz'), {k: jmx.np.array(v)
                                           for k, v in a.items()})
    got = tmx.npx.load(str(tmp_path / 'j.npz'), ctx=tmx.cpu())
    for k, v in a.items():
        np.testing.assert_array_equal(got[k].asnumpy(), v)
    tmx.nd.save(str(tmp_path / 't.npz'), [tmx.np.array(a['w'])])
    np.testing.assert_array_equal(
        jmx.nd.load(str(tmp_path / 't.npz'))[0].asnumpy(), a['w'])


# ----------------------------------------------------------------- layers
def _layers(nn):
    return {
        'dense': (lambda: nn.Dense(6, activation='tanh'), [(2, 3, 4)]),
        'dense_noflatten': (lambda: nn.Dense(6, flatten=False,
                                             use_bias=False), [(2, 3, 4)]),
        'batchnorm': (lambda: nn.BatchNorm(), [(2, 3, 4, 4)]),
        'batchnorm_relu': (lambda: nn.BatchNormReLU(), [(2, 3, 4)]),
        'layernorm': (lambda: nn.LayerNorm(), [(2, 5, 8)]),
        'layernorm_axis1': (lambda: nn.LayerNorm(axis=1), [(2, 5, 8)]),
        'rmsnorm': (lambda: nn.RMSNorm(), [(2, 5, 8)]),
        'groupnorm': (lambda: nn.GroupNorm(num_groups=2), [(2, 4, 3, 3)]),
        'instancenorm': (lambda: nn.InstanceNorm(), [(2, 3, 5)]),
        'flatten': (lambda: nn.Flatten(), [(2, 3, 4)]),
        'identity': (lambda: nn.Identity(), [(2, 3)]),
        'hybrid_lambda': (lambda: nn.HybridLambda('tanh'), [(2, 3)]),
        'lambda': (lambda: nn.Lambda(lambda x: x * 2 + 1), [(2, 3)]),
        'sequential': (lambda: nn.Sequential(nn.Dense(4), nn.Dense(2)),
                       [(2, 3)]),
        'concatenate': (lambda: _concat(nn, nn.Concatenate), [(2, 3)]),
        'hybrid_concatenate': (lambda: _concat(nn, nn.HybridConcatenate),
                               [(2, 3)]),
        'dropout_predict': (lambda: nn.Dropout(0.5), [(2, 3)]),
        'relu': (lambda: nn.Activation('relu'), [(2, 3)]),
        'sigmoid': (lambda: nn.Activation('sigmoid'), [(2, 3)]),
        'softrelu': (lambda: nn.Activation('softrelu'), [(2, 3)]),
        'leaky': (lambda: nn.LeakyReLU(0.1), [(2, 3)]),
        'prelu': (lambda: nn.PReLU(in_channels=3), [(2, 3, 4)]),
        'elu': (lambda: nn.ELU(0.7), [(2, 3)]),
        'selu': (lambda: nn.SELU(), [(2, 3)]),
        'gelu_erf': (lambda: nn.GELU(), [(2, 3)]),
        'gelu_tanh': (lambda: nn.GELU('tanh'), [(2, 3)]),
        'silu': (lambda: nn.SiLU(), [(2, 3)]),
    }


def _concat(nn, cls):
    net = cls(axis=-1)
    net.add(nn.Dense(2))
    net.add(nn.Dense(3))
    return net


LAYERS = sorted(_layers(tnn))


@pytest.mark.parametrize('layer', LAYERS)
def test_layer_forward_matches_the_jax_layer(layer):
    make_j, shapes = _layers(jgl.nn)[layer]
    make_t, _ = _layers(tnn)[layer]
    jnet, tnet = make_j(), make_t()
    if jnet.collect_params():
        _carry(jnet, tnet, shapes)
    xs = [_x(s, 3 + i) for i, s in enumerate(shapes)]
    want = jnet(*[jmx.np.array(x) for x in xs]).asnumpy()
    got = tnet(*[tmx.np.array(x) for x in xs]).asnumpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_embedding_matches_the_jax_layer():
    jnet, tnet = jgl.nn.Embedding(10, 4), tnn.Embedding(10, 4)
    jnet.initialize()
    tnet.initialize()
    w = _x((10, 4))
    jnet.weight.set_data(w)
    tnet.weight.set_data(w)
    ids = np.array([[1, 9, 0], [3, 3, 2]], np.int32)
    np.testing.assert_allclose(tnet(tmx.np.array(ids)).asnumpy(),
                               jnet(jmx.np.array(ids)).asnumpy(), **TOL)
    # sparse_grad=True: a recorded lookup gives a row-sparse gradient, one
    # entry a token occurrence, whose dense value is the JAX layer's
    sparse = []
    for mx, nn_, ag in ((jmx, jgl.nn, jag), (tmx, tnn, tmx.autograd)):
        net = nn_.Embedding(10, 4, sparse_grad=True)
        net.initialize()
        net.weight.set_data(w)
        with ag.record():
            loss = (net(mx.np.array(ids)) ** 2).sum()
        loss.backward()
        sparse.append(net.weight.grad())
    jg, tg = sparse
    assert type(tg).__name__ == 'RowSparseNDArray' and \
        tg._may_have_duplicates and tg.data.shape == (6, 4)
    np.testing.assert_allclose(tg.asnumpy(), jg.asnumpy(), **TOL)
    # SyncBatchNorm in one process is BatchNorm, as in the JAX package:
    # the training-mode output and the running statistics at TOL
    x = _x((4, 3, 5), 9)
    jbn, tbn = jgl.nn.SyncBatchNorm(in_channels=3), \
        tnn.SyncBatchNorm(in_channels=3)
    jbn.initialize()
    tbn.initialize()
    with jag.record():
        jout = jbn(jmx.np.array(x))
    with tmx.autograd.record():
        tout = tbn(tmx.np.array(x))
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), **TOL)
    for name in ('running_mean', 'running_var'):
        np.testing.assert_allclose(
            getattr(tbn, name).data().asnumpy(),
            getattr(jbn, name).data().asnumpy(), **TOL)


def test_instancenorm_on_the_last_axis_is_the_moved_axis_1():
    # the JAX layer fails on a channel axis other than 1 (it calls an
    # NDArray.moveaxis that does not exist), so the port is held to itself
    last, first = tnn.InstanceNorm(axis=-1, scale=True), \
        tnn.InstanceNorm(scale=True)
    x = _x((2, 5, 3))
    last.initialize()
    first.initialize()
    last(tmx.np.array(x))
    first(tmx.np.array(x.transpose(0, 2, 1)))
    g, b = _x((3,), 1), _x((3,), 2)
    for net in (last, first):
        net.gamma.set_data(g)
        net.beta.set_data(b)
    np.testing.assert_allclose(
        last(tmx.np.array(x)).asnumpy(),
        first(tmx.np.array(x.transpose(0, 2, 1))).asnumpy().transpose(
            0, 2, 1), **TOL)


def test_batchnorm_running_statistics_match_in_train_mode():
    jnet, tnet = jgl.nn.BatchNorm(momentum=0.8), tnn.BatchNorm(momentum=0.8)
    _carry(jnet, tnet, [(4, 3, 5)])
    x = _x((4, 3, 5), 11, scale=2.0)
    with jag.record():
        jy = jnet(jmx.np.array(x))
    with tmx.autograd.record():
        ty = tnet(tmx.np.array(x))
    np.testing.assert_allclose(ty.asnumpy(), jy.asnumpy(), **TOL)
    for name in ('running_mean', 'running_var'):
        np.testing.assert_allclose(
            tnet.collect_params()[name].data().asnumpy(),
            jnet.collect_params()[name].data().asnumpy(), **TOL)


def test_dropout_statistics_and_identity():
    x = tmx.np.ones((200, 500))
    drop = tnn.Dropout(0.3)
    np.testing.assert_array_equal(drop(x).asnumpy(), x.asnumpy())
    with tmx.autograd.train_mode():
        y = drop(x).asnumpy()
        np.testing.assert_array_equal(tnn.Dropout(0.0)(x).asnumpy(),
                                      x.asnumpy())
    kept = y != 0
    # 100000 Bernoulli(0.7) draws: the kept share within 5 sigma of 0.7
    assert abs(kept.mean() - 0.7) < 5 * np.sqrt(0.21 / kept.size)
    np.testing.assert_allclose(y[kept], 1 / 0.7, rtol=1e-6)


# -------------------------------------------------------------- hybridize
class _TwoArgs:
    """A block whose forward takes ``(x, y=None)``."""

    @staticmethod
    def make(nn):
        class TwoArgs(nn.HybridSequential):
            def __init__(self):
                super().__init__()
                self.d = nn.Dense(3)
                self.bn = nn.BatchNorm()

            def forward(self, x, y=None):
                h = self.bn(self.d(x))
                return h if y is None else (h, h * y)
        return TwoArgs()


def _calls(mx, net):
    """The call sequence: shapes, train mode, recording, and an argument
    that is ``None`` or an array; returns the outputs."""
    a, b = mx.np.array(_x((2, 5))), mx.np.array(_x((3, 5), 1))
    y = mx.np.array(_x((2, 3), 2))
    outs = [net(a), net(a), net(b), net(a, y), net(a, None)]
    with mx.autograd.train_mode():
        outs.append(net(a))
    with mx.autograd.record():
        outs.append(net(a))
        outs.append(net(a, y))
    with mx.autograd.record(train_mode=False):
        outs.append(net(b))
    outs.append(net(b))
    counts = [net.compile_count]
    return outs, counts


def test_compile_count_keys_equal_the_jax_blocks():
    jnet, tnet = _TwoArgs.make(jgl.nn), _TwoArgs.make(tnn)
    _carry(jnet, tnet, [(2, 5)])
    jnet.hybridize()
    tnet.hybridize()
    jouts, jcount = _calls(jmx, jnet)
    touts, tcount = _calls(tmx, tnet)
    assert tcount == jcount and tcount[0] > 1
    for jo, to in zip(jouts, touts):
        jo = jo if isinstance(jo, tuple) else (jo,)
        to = to if isinstance(to, tuple) else (to,)
        for a, b in zip(jo, to):
            np.testing.assert_allclose(b.asnumpy(), a.asnumpy(), **TOL)
    assert tnet.capture_count == 0          # no card: every call is eager


def test_hybridized_equals_eager_and_sees_writes():
    net = _nested(tnn)
    net.initialize()
    x = tmx.np.array(_x((2, 3)))
    eager = net(x).asnumpy()
    net.hybridize()
    np.testing.assert_allclose(net(x).asnumpy(), eager, **TOL)
    np.testing.assert_allclose(net(x).asnumpy(), eager, **TOL)
    bias = net.collect_params()['1.norm.beta']
    bias.set_data(bias.data() + 1.0)
    np.testing.assert_allclose(net(x).asnumpy(), eager + 1.0, **TOL)
    with pytest.raises(ValueError, match='keyword'):
        net(x=x)
    assert net.compile_count == 1


def test_data_dependent_shapes_switch_to_eager_as_in_jax():
    def body(mx):
        return lambda x: mx.np.boolean_mask(x, x[:, 0] > 0) \
            if hasattr(mx.np, 'boolean_mask') else \
            mx.npx.boolean_mask(x, x[:, 0] > 0)
    x = _x((6, 2))
    counts, outs = [], []
    for mx, nn in ((jmx, jgl.nn), (tmx, tnn)):
        net = nn.HybridLambda(body(mx))
        net.hybridize()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter('always')
            outs.append([net(mx.np.array(x)).asnumpy() for _ in range(3)])
        counts.append(net.compile_count)
        assert any('data-dependent' in str(e.message) for e in w)
    assert counts[0] == counts[1]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)


# ----------------------------------------------------------- initializers
def _capture_scale(monkeypatch, init, shape):
    """The bound or sigma the JAX initializer hands numpy for ``shape``."""
    got = {}

    def uniform(lo, hi, size):
        got['scale'] = hi
        return np.zeros(size)

    def normal(mu, sigma, size):
        got['scale'] = sigma
        return np.zeros(size)
    monkeypatch.setattr(jinit._np.random, 'uniform', uniform)
    monkeypatch.setattr(jinit._np.random, 'normal', normal)
    init._init_weight('w', jmx.np.zeros(shape))
    monkeypatch.undo()
    return got['scale']


@pytest.mark.parametrize('make', [
    lambda m: m.Xavier(), lambda m: m.Xavier('gaussian', 'in', 2),
    lambda m: m.Xavier(factor_type='out', magnitude=6),
    lambda m: m.MSRAPrelu(), lambda m: m.MSRAPrelu('in', 0.1)],
    ids=['xavier', 'xavier_gauss_in', 'xavier_out', 'msra', 'msra_in'])
@pytest.mark.parametrize('shape', [(64, 32), (16, 8, 3, 3), (10,)])
def test_xavier_and_msra_scales_equal_the_references(monkeypatch, make,
                                                     shape):
    want = _capture_scale(monkeypatch, make(jinit), shape)
    assert make(tmx.init).scale(shape) == want


@pytest.mark.parametrize('name,make,mean,std', [
    ('uniform', lambda m: m.Uniform(0.2), 0.0, 0.2 / np.sqrt(3)),
    ('normal', lambda m: m.Normal(0.3), 0.0, 0.3),
    ('xavier', lambda m: m.Xavier(), 0.0,
     np.sqrt(3 / 300) / np.sqrt(3)),
    ('msra', lambda m: m.MSRAPrelu(), 0.0,
     np.sqrt(2 / (1 + 0.25 ** 2) / 300)),
    ('constant', lambda m: m.Constant(0.5), 0.5, 0.0),
    ('zeros', lambda m: m.create('zeros'), 0.0, 0.0),
    ('ones', lambda m: m.create('ones'), 1.0, 0.0)])
def test_initializer_sample_statistics(name, make, mean, std):
    """200 x 400 draws: the sample mean within 5 standard errors, the
    sample std within 2 % (Chi at 80000 degrees of freedom: 0.25 %)."""
    tmx.random.seed(3)
    arr = tmx.np.zeros((200, 400))
    make(tmx.init)(tmx.init.InitDesc('w'), arr)
    a = arr.asnumpy()
    assert abs(a.mean() - mean) <= 5 * std / np.sqrt(a.size) + 1e-7
    np.testing.assert_allclose(a.std(), std, rtol=0.02, atol=1e-7)


@pytest.mark.parametrize('make,shape', [
    (lambda m: m.Bilinear(), (2, 1, 4, 4)),
    (lambda m: m.LSTMBias(2.0), (8,)),
    (lambda m: m.Constant(3.0), (2, 3))], ids=['bilinear', 'lstm', 'const'])
def test_deterministic_initializers_equal_the_references(make, shape):
    j, t = jmx.np.zeros(shape), tmx.np.zeros(shape)
    make(jinit)._init_weight('w', j)
    make(tmx.init)._init_weight('w', t)
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6)


def test_orthogonal_mixed_and_suffix_rules():
    arr = tmx.np.zeros((6, 4))
    tmx.init.Orthogonal(scale=1.0)('w', arr)
    q = arr.asnumpy()
    np.testing.assert_allclose(q.T @ q, np.eye(4), atol=1e-5)
    mixed = tmx.init.Mixed(['fc1', '.*'], [tmx.init.Constant(1.0),
                                           tmx.init.Constant(2.0)])
    w1, w2, b = tmx.np.zeros((3,)), tmx.np.zeros((3,)), tmx.np.ones((3,))
    mixed(tmx.init.InitDesc('fc1.weight'), w1)
    mixed(tmx.init.InitDesc('fc2.weight'), w2)
    mixed(tmx.init.InitDesc('fc1.bias'), b)     # a bias is zeroed
    assert w1.asnumpy().tolist() == [1, 1, 1] and w2.asnumpy()[0] == 2
    assert b.asnumpy().tolist() == [0, 0, 0]
    g = tmx.np.zeros((3,))
    tmx.init.Xavier()(tmx.init.InitDesc('ln.gamma'), g)
    assert g.asnumpy().tolist() == [1, 1, 1]


# ------------------------------------------------------------------ utils
def test_utils_match_the_jax_package(tmp_path):
    from mxnet_tpu.gluon import utils as ju
    from mxnet_tpu_torch.gluon import utils as tu
    x = _x((6, 4))
    for a, b in zip(ju.split_data(jmx.np.array(x), 3),
                    tu.split_data(tmx.np.array(x), 3)):
        np.testing.assert_array_equal(b.asnumpy(), a.asnumpy())
    with pytest.raises(ValueError):
        tu.split_data(tmx.np.array(x), 4)
    assert tu.split_and_load(x, [tmx.cpu()])[0].shape == (6, 4)
    ja = [jmx.np.array(x * 3), jmx.np.array(x[:2] * 3)]
    ta = [tmx.np.array(x * 3), tmx.np.array(x[:2] * 3)]
    assert tu.clip_global_norm(ta, 1.0) == pytest.approx(
        ju.clip_global_norm(ja, 1.0), rel=1e-5)
    for a, b in zip(ja, ta):
        np.testing.assert_allclose(b.asnumpy(), a.asnumpy(), **TOL)
    (tmp_path / 'f').write_bytes(b'abc')
    assert tu.check_sha1(str(tmp_path / 'f'),
                         'a9993e364706816aba3e25717850c26c9cd0d89d')
    assert tu.shape_is_known((2, 3)) and not tu.shape_is_known((2, 0))


# ---------------------------------------------------------------- trainer
def _train(mx, gl, net, x, steps=2):
    trainer = gl.Trainer(net.collect_params(), 'sgd',
                         {'learning_rate': 0.1, 'momentum': 0.9,
                          'wd': 0.01})
    for _ in range(steps):
        with mx.autograd.record():
            loss = (net(mx.np.array(x)) ** 2).sum()
        loss.backward()
        trainer.step(2)
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def test_trainer_honours_lr_mult_wd_mult_and_grad_req():
    nets = []
    for nn in (jgl.nn, tnn):
        net = nn.HybridSequential()
        net.add(nn.Dense(4), nn.Dense(3), nn.LayerNorm())
        nets.append(net)
    _carry(*nets, [(2, 5)])
    for net in nets:
        p = net.collect_params()
        p['0.weight'].lr_mult = 0.5
        p['1.weight'].wd_mult = 0.0
        p['1.bias'].grad_req = 'null'
    x = _x((2, 5), 5)
    want = _train(jmx, jgl, nets[0], x)
    got = _train(tmx, tgl, nets[1], x)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL)


def test_trainer_takes_a_list_of_gluon_parameters_and_add_accumulates():
    net = tnn.Dense(2, in_units=3)
    net.initialize()
    for p in net.collect_params().values():
        p.grad_req = 'add'
    x = tmx.np.array(_x((4, 3)))
    for _ in range(2):
        with tmx.autograd.record():
            y = net(x).sum()
        y.backward()
    np.testing.assert_allclose(net.bias.grad().asnumpy(), [8.0, 8.0])
    trainer = tgl.Trainer(list(net.collect_params().values()), 'sgd',
                          {'learning_rate': 1.0})
    before = net.bias.data().asnumpy()
    trainer.step(1)
    np.testing.assert_allclose(net.bias.data().asnumpy(), before - 8.0)


# ------------------------------------------------------------ no fallback
def test_no_card_and_no_ctx_raises(on_cpu):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    net = tnn.Dense(2, in_units=3)
    with pytest.raises(MXNetError, match='CUDA'):
        net.initialize(ctx=tmx.gpu())
    with tmx.gpu():
        with pytest.raises(MXNetError, match='CUDA'):
            tnn.Dense(2, in_units=3).initialize()
    # two host contexts are two replicas, as the JAX package's virtual
    # CPU devices are (tests/test_torch_dist.py holds them to it)
    net.initialize(ctx=[tmx.cpu(), tmx.cpu(1)])
    assert net.weight.list_ctx() == [tmx.cpu(0), tmx.cpu(1)]
    assert len(net.weight.list_data()) == 2


def test_cpu_arrays_never_reach_a_kernel():
    from mxnet_tpu_torch.ops import kernels
    net = tnn.HybridSequential(tnn.Dense(8), tnn.LayerNorm(), tnn.RMSNorm())
    net.initialize()
    net.hybridize()
    before = kernels.launch_counts()
    with tmx.autograd.record():
        y = net(tmx.np.array(_x((2, 4)))).sum()
    y.backward()
    tgl.Trainer(net.collect_params(), 'adam').step(1)
    assert kernels.launch_counts() == before
