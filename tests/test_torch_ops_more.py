"""Parity of the port's registered ops that ``benchmark/opperf.py`` has no
rule for, against the JAX package on the CPU: hand-made small inputs,
the same numpy arrays through both packages' ``np``/``npx`` functions.
Floats within rtol 1e-5 and atol 1e-6 (the ``_ULP`` cases, whose torch
and XLA formulas round differently, within rtol 1e-4), integers and
bools exact, dtypes and shapes equal. The random ops are held by shape,
dtype and their sample mean (their streams are torch's, not JAX's)."""

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

from test_torch_ops_sweep import assert_same

R = np.random.default_rng(5)
F = R.uniform(0.5, 1.5, (4, 5)).astype('float32')
G = R.uniform(-2.0, 2.0, (4, 5)).astype('float32')
V = R.uniform(-1.0, 1.0, (7,)).astype('float32')
I = R.integers(-5, 6, (4, 5)).astype('int32')
B = R.uniform(size=(4, 5)) > 0.5
IMG = R.uniform(-1, 1, (2, 4, 6, 6)).astype('float32')
SEQ = R.uniform(-1, 1, (5, 3, 4)).astype('float32')

#: name -> (args, kwargs); NDArray arguments are numpy arrays here
CASES = {
    # elementwise
    'floor_divide': ((G, 0.7), {}), 'fmod': ((G, F), {}),
    'remainder': ((I, 3), {}), 'mod': ((G, F), {}),
    'copysign': ((F, G), {}), 'fmax': ((F, G), {}), 'fmin': ((F, G), {}),
    'float_power': ((F, 2.5), {}), 'ldexp': ((F, I), {}),
    'heaviside': ((G, F), {}), 'gcd': ((I, 4), {}), 'lcm': ((I, 3), {}),
    'bitwise_and': ((I, 6), {}), 'bitwise_or': ((I, 6), {}),
    'bitwise_xor': ((I, 6), {}), 'left_shift': ((np.abs(I), 2), {}),
    'right_shift': ((np.abs(I), 1), {}), 'nextafter': ((F, G), {}),
    'equal': ((I, 1), {}), 'not_equal': ((I, 1), {}), 'less': ((G, F), {}),
    'less_equal': ((G, 0.0), {}), 'greater': ((G, F), {}),
    'greater_equal': ((I, 0), {}), 'logical_and': ((B, G > 0), {}),
    'logical_or': ((B, G > 0), {}), 'logical_xor': ((B, G > 0), {}),
    'absolute': ((G,), {}), 'fabs': ((I,), {}), 'trunc': ((G,), {}),
    'fix': ((G,), {}), 'exp2': ((G,), {}), 'log10': ((F,), {}),
    'log2': ((F,), {}), 'tan': ((G,), {}), 'arcsin': ((V,), {}),
    'arccos': ((V,), {}), 'arctan': ((G,), {}), 'sinh': ((G,), {}),
    'cosh': ((G,), {}), 'arcsinh': ((G,), {}), 'arccosh': ((F + 1,), {}),
    'arctanh': ((V * 0.9,), {}), 'degrees': ((G,), {}),
    'radians': ((G,), {}), 'deg2rad': ((G,), {}), 'rad2deg': ((G,), {}),
    'logical_not': ((B,), {}), 'invert': ((I,), {}),
    'bitwise_not': ((I,), {}), 'positive': ((G,), {}),
    'conjugate': ((G,), {}), 'conj': ((G,), {}), 'real': ((G,), {}),
    'imag': ((G,), {}), 'angle': ((G,), {}), 'i0': ((G,), {}),
    'sinc': ((G,), {}), 'signbit': ((G,), {}), 'spacing': ((G,), {}),
    'isnan': ((G,), {}), 'isinf': ((G / 0,), {}), 'isfinite': ((G,), {}),
    'isposinf': ((G / 0,), {}), 'isneginf': ((G / 0,), {}),
    'iscomplex': ((G,), {}), 'isreal': ((G,), {}),
    'divide': ((G, F), {}), 'rtruediv': ((F, G), {}),
    'cast': ((G,), {'dtype': 'int32'}), 'round': ((G * 10,), {}),
    'erfinv': ((V,), {}), 'erfc': ((G,), {}), 'gamma': ((F,), {}),
    'gammaln': ((F,), {}), 'digamma': ((F,), {}), 'relu6': ((G * 5,), {}),
    'rsqrt': ((F,), {}), 'rcbrt': ((F,), {}), 'logit': ((F / 2,), {}),
    'nan_to_num': ((np.where(B, np.nan, G).astype('float32'),), {}),
    'stop_gradient': ((G,), {}), 'smooth_l1': ((G,), {'scalar': 1.5}),
    # reductions
    'nanprod': ((F,), {'axis': 1}), 'nanmax': ((G,), {'axis': 0}),
    'nanmin': ((G,), {}), 'nanargmax': ((G,), {'axis': 1}),
    'nanargmin': ((G,), {}), 'average': ((G,), {'axis': 1}),
    'all': ((B,), {'axis': 1}), 'any': ((B,), {}),
    'norm': ((G,), {}), 'quantile': ((G, 0.3), {'axis': 0}),
    'histogram': ((V,), {'bins': 4}), 'bincount': ((np.abs(I[0]),), {}),
    'argmax_channel': ((G,), {}),
    # manipulation
    'moveaxis': ((IMG, 1, 3), {}), 'rollaxis': ((IMG, 3, 1), {}),
    'ravel': ((G,), {}), 'flatten': ((IMG,), {}),
    'vstack': (([F, G],), {}), 'hstack': (([F, G],), {}),
    'dstack': (([F, G],), {}), 'column_stack': (([V, V],), {}),
    'array_split': ((V, 3), {}), 'hsplit': ((G, [1, 3]), {}),
    'vsplit': ((G, 2), {}), 'dsplit': ((IMG, 2), {}),
    'fliplr': ((G,), {}), 'flipud': ((G,), {}),
    'rot90': ((G,), {'k': 3}),
    'pad': ((G,), {'pad_width': ((1, 2), (3, 0)), 'mode': 'reflect'}),
    'scatter_nd': ((V[:3], np.array([[0, 2, 2], [1, 0, 1]], 'int32'),
                    (3, 2)), {}),
    'slice_axis': ((G, 1, 1, -1), {}), 'slice_like': ((G, F[:2, :3]), {}),
    'where_nd': ((B, G, F), {}), 'diag': ((V,), {'k': 1}),
    'diagflat': ((V[:3],), {}), 'argwhere': ((B,), {}),
    'nonzero': ((B,), {}), 'flatnonzero': ((B,), {}),
    'boolean_mask': ((G, B[:, 0]), {}),
    'sequence_mask': ((SEQ, np.array([2, 5, 0], 'int32')),
                      {'use_sequence_length': True, 'value': -1.0}),
    'reverse': ((G, 1), {}), 'meshgrid': ((V[:3], V[:4]), {}),
    'broadcast_arrays': ((G, V[:5]), {}), 'atleast_1d': ((np.float32(2),),
                                                        {}),
    'atleast_2d': ((V,), {}), 'atleast_3d': ((G,), {}),
    'insert': ((V, 2, np.array([9.0, 8.0], 'float32')), {}),
    'delete': ((G, np.array([0, 2], 'int32')), {'axis': 1}),
    'append': ((G, F), {'axis': 0}), 'resize': ((V, 12), {}),
    'interp': ((np.linspace(-0.5, 3.5, 9).astype('float32'),
                np.array([0, 1, 2, 3], 'float32'),
                np.array([1, 3, 2, 0], 'float32')), {}),
    'fill_diagonal': ((G, 7.0), {}), 'ediff1d': ((V,), {'to_end': 1.0}),
    'cross': ((G[:, :3], F[:, :3]), {}), 'trapz': ((G,), {}),
    'isclose': ((G, G + 1e-6), {}), 'allclose': ((G, G), {}),
    'array_equal': ((G, G), {}),
    'unravel_index': ((np.array([1, 7, 11], 'int32'), (3, 4)), {}),
    'ravel_multi_index': ((np.array([[0, 2], [3, 1]], 'int32'), (3, 4)),
                          {}),
    'unwrap': ((np.cumsum(np.abs(V) * 4).astype('float32'),), {}),
    'convolve': ((V, V[:3]), {}), 'correlate': ((V, V[:3]), {'mode':
                                                                'same'}),
    'cov': ((G,), {}), 'corrcoef': ((G,), {}),
    'arange_like': ((G,), {'start': 1.0, 'step': 0.5}),
    'around': ((G,), {'decimals': 1}), 'reshape_like': ((G, G.T), {}),
    'broadcast_like': ((V[:5], G), {}), 'size_array': ((G,), {}),
    'add_n': ((G, F, G), {}),
    'batch_take': ((G, np.array([0, 4, 2, 1], 'int32')), {}),
    'tril_indices': ((4,), {'k': 1}), 'triu_indices': ((3,), {}),
    'diag_indices_from': ((F[:4, :4],), {}),
    'triu_indices_from': ((F[:4, :4],), {}),
    'polyval': ((V[:3], G), {}),
    'index_update': ((G, np.array([[0, 3], [1, 4]], 'int32'),
                      np.float32(5.0)), {}),
    'constraint_check': ((B,), {}), 'empty_like': ((G,), {}),
    'vander': ((V[:4],), {}), 'zeros_like': ((G,), {}),
    'ones_like': ((I,), {}), 'full_like': ((G, 3.0), {}),
    'copy': ((G,), {}),
    # nn
    'deconvolution': ((IMG, R.uniform(-1, 1, (4, 3, 3, 3)).astype(
        'float32')), {'kernel': (3, 3), 'stride': (2, 2), 'pad': (1, 1),
                      'adj': (1, 1), 'num_filter': 3, 'no_bias': True}),
    'adaptive_avg_pooling': ((IMG,), {'output_size': 3}),
    'activation': ((G,), {'act_type': 'softrelu'}),
    'softmin': ((G,), {'axis': 0}), 'masked_log_softmax': ((G, B), {}),
    'softmax_cross_entropy': ((G, np.array([0, 4, 2, 1], 'int32')), {}),
    'batch_norm_train': ((IMG, F[0, :4], G[0, :4]), {}),
    'upsampling': ((IMG,), {'scale': 2}),
    'interp_resize': ((IMG,), {'height': 12, 'width': 12}),
    'topk_accuracy_helper': ((G, np.array([0, 4, 2, 1], 'int32')),
                             {'k': 2}),
    'col2im': ((R.uniform(-1, 1, (2, 36, 36)).astype('float32'),),
               {'output_size': (6, 6), 'kernel': (3, 3), 'pad': (1, 1)}),
    'multi_head_attention': ((SEQ, SEQ, SEQ), {'num_heads': 2,
                                               'causal': True}),
}
#: torch and XLA take other formulas or roundings here
_ULP = {'spacing', 'i0', 'gamma', 'digamma', 'logit', 'erfinv', 'cov',
        'corrcoef', 'unwrap', 'interp_resize', 'deconvolution',
        'multi_head_attention', 'float_power', 'rcbrt'}


def _call(mx, name, args, kwargs):
    def conv(a):
        if isinstance(a, np.ndarray):
            return mx.np.array(a)
        if isinstance(a, list) and a and isinstance(a[0], np.ndarray):
            return [conv(e) for e in a]
        return a
    fn = getattr(mx.npx, name, None) or getattr(mx.np, name, None) or \
        getattr(mx.nd, name)
    out = fn(*[conv(a) for a in args], **kwargs)
    return [o.asnumpy() for o in (out if isinstance(out, (tuple, list))
                                  else [out])]


@pytest.mark.parametrize('name', sorted(CASES))
def test_forward_matches_jax(name):
    args, kwargs = CASES[name]
    want = _call(jmx, name, args, kwargs)
    with tmx.cpu():
        got = _call(tmx, name, args, kwargs)
    assert len(got) == len(want)
    rtol = 1e-4 if name in _ULP else 1e-5
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, rtol, 1e-6, f'{name} output {i}')


def test_every_case_is_a_registered_op():
    from mxnet_tpu_torch.ops import registry
    assert set(CASES) <= set(registry.list_ops())


#: name -> (kwargs, mean of the distribution)
RANDOM = {
    'uniform': ({'low': -1.0, 'high': 3.0}, 1.0),
    'normal': ({'loc': 2.0, 'scale': 0.5}, 2.0),
    'exponential': ({'scale': 2.0}, 2.0),
    'poisson': ({'lam': 3.0}, 3.0),
    'laplace': ({'loc': 1.0, 'scale': 0.5}, 1.0),
    'gumbel': ({'loc': 0.0, 'scale': 1.0}, 0.5772156649),
    'logistic': ({'loc': 1.5, 'scale': 0.5}, 1.5),
    'pareto': ({'a': 4.0}, 1.0 / 3.0),
    'power_sample': ({'a': 3.0}, 0.75),
    'rayleigh': ({'scale': 1.0}, 1.2533141373),
    'weibull': ({'a': 2.0}, 0.8862269255),
    'lognormal': ({'mean': 0.0, 'sigma': 0.25}, 1.0317434075),
    'bernoulli': ({'prob': 0.3}, 0.3),
}


@pytest.mark.parametrize('name', sorted(RANDOM))
def test_random_ops_shape_dtype_and_mean(name):
    kwargs, mean = RANDOM[name]
    n = 40000
    j = getattr(jmx.np.random, name, None) or getattr(jmx.npx, name)
    want = j(size=(n,), **kwargs).asnumpy()
    with tmx.cpu():
        tmx.random.seed(3)
        t = getattr(tmx.np.random, name, None) or getattr(tmx.npx, name)
        got = t(size=(n,), **kwargs).asnumpy()
        tmx.random.seed(3)
        again = t(size=(n,), **kwargs).asnumpy()
    np.testing.assert_array_equal(got, again)
    assert got.dtype == want.dtype and got.shape == want.shape
    sd = max(float(want.std()), 1e-3)
    assert abs(got.mean() - mean) < 6 * sd / np.sqrt(n), (got.mean(), mean)
    assert abs(want.mean() - mean) < 6 * sd / np.sqrt(n)


def test_random_index_ops():
    with tmx.cpu():
        tmx.random.seed(4)
        p = tmx.np.array(np.array([[0.1, 0.9, 0.0], [0.5, 0.0, 0.5]],
                                  'float32'))
        s = tmx.npx.random_multinomial(p, shape=(2000,))
        assert s.shape == (2, 2000) and s.dtype == np.int32
        a = s.asnumpy()
        assert set(np.unique(a[0])) <= {0, 1} and abs((a[0] == 1).mean()
                                                       - 0.9) < 0.05
        assert set(np.unique(a[1])) <= {0, 2}
        c = tmx.npx.random_categorical(tmx.np.log(p + 1e-9), num_samples=7)
        assert c.shape == (2, 7)
        perm = tmx.np.random.permutation(tmx.np.arange(10)).asnumpy()
        assert sorted(perm.tolist()) == list(range(10))
        sh = tmx.np.random.shuffle(tmx.np.arange(6)).asnumpy()
        assert sorted(sh.tolist()) == list(range(6))
        ch = tmx.np.random.choice(5, size=(3,), replace=False).asnumpy()
        assert len(set(ch.tolist())) == 3 and ch.max() < 5
        mv = tmx.np.random.multivariate_normal(
            tmx.np.array(np.array([1.0, -1.0], 'float32')),
            tmx.np.array(np.array([[1.0, 0.5], [0.5, 2.0]], 'float32')),
            size=(20000,)).asnumpy()
        np.testing.assert_allclose(np.cov(mv.T), [[1.0, 0.5], [0.5, 2.0]],
                                   atol=0.1)
        r = tmx.np.random.randn(3, 4)
        assert r.shape == (3, 4) and r.dtype == np.float32
