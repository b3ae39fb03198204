"""Random sampling ops.

Counterpart of ``mxnet_tpu/ops/random_ops.py`` (reference
src/operator/random/). Each op is registered ``stochastic``: the dispatch
passes ``key=``, the ``torch.Generator`` of the op's device
(:mod:`.._rng`), so user code never handles generator state, and
``mx.random.seed`` makes a run reproduce. The streams are torch's, not
JAX's: the same seed gives other numbers than the reference, from the same
distributions. The gamma family (``gamma``, ``beta``, ``chisquare``,
``negative_binomial``) draws through :func:`standard_gamma`, Marsaglia and
Tsang's rejection method over the same generator (``torch._standard_gamma``
takes none).
"""

import math

import numpy as _np
import torch

from .. import _dtypes, _rng
from .registry import register


def _shape(size, *params):
    if size is None:
        return tuple(torch.broadcast_shapes(*[
            tuple(p.shape) if torch.is_tensor(p) else () for p in params])) \
            if params else ()
    if isinstance(size, int):
        return (size,)
    return tuple(size)


def _t(v, dtype, dev):
    return _dtypes.tensor_of(v, dtype, dev)


def _uniform01(shape, dtype, key):
    return torch.rand(shape, generator=key, device=key.device,
                      dtype=_dtypes.to_torch(dtype))


def _normal01(shape, dtype, key):
    return torch.randn(shape, generator=key, device=key.device,
                       dtype=_dtypes.to_torch(dtype))


def _open01(u):
    """``u`` moved off 0, where a log would overflow."""
    return u.clamp_min(torch.finfo(u.dtype).tiny)


@register('random_uniform', stochastic=True, differentiable=False,
          aliases=('uniform',))
def uniform(low=0.0, high=1.0, size=None, dtype='float32', key=None):
    dt = _dtypes.to_torch(dtype)
    low, high = _t(low, dt, key.device), _t(high, dt, key.device)
    return _uniform01(_shape(size, low, high), dtype, key) * (high - low) \
        + low


@register('random_normal', stochastic=True, differentiable=False,
          aliases=('normal',))
def normal(loc=0.0, scale=1.0, size=None, dtype='float32', key=None):
    dt = _dtypes.to_torch(dtype)
    loc, scale = _t(loc, dt, key.device), _t(scale, dt, key.device)
    return _normal01(_shape(size, loc, scale), dtype, key) * scale + loc


@register('random_randn', stochastic=True, differentiable=False,
          aliases=('randn',))
def randn(*shape, dtype='float32', key=None):
    return _normal01(shape, dtype, key)


@register('random_rand', stochastic=True, differentiable=False,
          aliases=('rand',))
def rand(*shape, dtype='float32', key=None):
    return _uniform01(shape, dtype, key)


@register('random_randint', stochastic=True, differentiable=False,
          aliases=('randint',))
def randint(low, high=None, size=None, dtype='int32', key=None):
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), _shape(size), generator=key,
                         device=key.device, dtype=_dtypes.to_torch(dtype))


@register('random_exponential', stochastic=True, differentiable=False,
          aliases=('exponential',))
def exponential(scale=1.0, size=None, dtype='float32', key=None):
    dt = _dtypes.to_torch(dtype)
    scale = _t(scale, dt, key.device)
    u = _uniform01(_shape(size, scale), dtype, key)
    return -torch.log1p(-u) * scale


@register('random_poisson', stochastic=True, differentiable=False,
          aliases=('poisson',))
def poisson(lam=1.0, size=None, dtype='float32', key=None):
    lam = _t(lam, torch.float32, key.device)
    rate = torch.broadcast_to(lam, _shape(size, lam)).contiguous()
    return torch.poisson(rate, generator=key).to(_dtypes.to_torch(dtype))


@register('random_laplace', stochastic=True, differentiable=False,
          aliases=('laplace',))
def laplace(loc=0.0, scale=1.0, size=None, dtype='float32', key=None):
    dt = _dtypes.to_torch(dtype)
    loc, scale = _t(loc, dt, key.device), _t(scale, dt, key.device)
    u = _uniform01(_shape(size, loc, scale), dtype, key) - 0.5
    return loc - scale * torch.sign(u) * torch.log1p(-2 * u.abs())


@register('random_gumbel', stochastic=True, differentiable=False,
          aliases=('gumbel',))
def gumbel(loc=0.0, scale=1.0, size=None, dtype='float32', key=None):
    dt = _dtypes.to_torch(dtype)
    loc, scale = _t(loc, dt, key.device), _t(scale, dt, key.device)
    u = _open01(_uniform01(_shape(size, loc, scale), dtype, key))
    return loc - scale * torch.log(-torch.log(u))


@register('random_logistic', stochastic=True, differentiable=False,
          aliases=('logistic',))
def logistic(loc=0.0, scale=1.0, size=None, dtype='float32', key=None):
    dt = _dtypes.to_torch(dtype)
    loc, scale = _t(loc, dt, key.device), _t(scale, dt, key.device)
    u = _open01(_uniform01(_shape(size, loc, scale), dtype, key))
    return loc + scale * (torch.log(u) - torch.log1p(-u))


@register('random_pareto', stochastic=True, differentiable=False,
          aliases=('pareto',))
def pareto(a, size=None, dtype='float32', key=None):
    """Pareto II (Lomax), numpy's and the reference's."""
    a = _t(a, _dtypes.to_torch(dtype), key.device)
    u = _uniform01(_shape(size, a), dtype, key)
    return torch.exp(-torch.log1p(-u) / a) - 1.0


@register('random_power', stochastic=True, differentiable=False,
          aliases=('power_sample',))
def power_sample(a, size=None, dtype='float32', key=None):
    a = _t(a, _dtypes.to_torch(dtype), key.device)
    return _uniform01(_shape(size, a), dtype, key) ** (1.0 / a)


@register('random_rayleigh', stochastic=True, differentiable=False,
          aliases=('rayleigh',))
def rayleigh(scale=1.0, size=None, dtype='float32', key=None):
    scale = _t(scale, _dtypes.to_torch(dtype), key.device)
    u = _uniform01(_shape(size, scale), dtype, key)
    return scale * torch.sqrt(-2.0 * torch.log1p(-u))


@register('random_weibull', stochastic=True, differentiable=False,
          aliases=('weibull',))
def weibull(a, size=None, dtype='float32', key=None):
    a = _t(a, _dtypes.to_torch(dtype), key.device)
    u = _uniform01(_shape(size, a), dtype, key)
    return (-torch.log1p(-u)) ** (1.0 / a)


@register('random_lognormal', stochastic=True, differentiable=False,
          aliases=('lognormal',))
def lognormal(mean=0.0, sigma=1.0, size=None, dtype='float32', key=None):
    dt = _dtypes.to_torch(dtype)
    mean, sigma = _t(mean, dt, key.device), _t(sigma, dt, key.device)
    return torch.exp(_normal01(_shape(size, mean, sigma), dtype, key)
                     * sigma + mean)


@register('random_multinomial', stochastic=True, differentiable=False,
          aliases=('sample_multinomial',))
def multinomial(data, shape=None, get_prob=False, dtype='int32', key=None):
    """Category indices drawn from (batched) probabilities ``data``;
    the samples go on trailing axes (reference
    src/operator/random/sample_multinomial_op.cc)."""
    sample_shape = () if shape is None else (
        (shape,) if isinstance(shape, int) else tuple(shape))
    batch = tuple(data.shape[:-1])
    k = data.shape[-1]
    n = math.prod(sample_shape)
    probs = data.reshape(-1, k).float().clamp_min(0)
    idx = torch.multinomial(probs, max(n, 1), replacement=True,
                            generator=key)[:, :n]
    idx = idx.reshape(batch + sample_shape)
    out = idx.to(_dtypes.to_torch(dtype))
    if get_prob:
        logp = torch.log_softmax(torch.log(data.float().clamp_min(1e-30)),
                                 dim=-1).reshape(-1, k)
        lp = torch.gather(logp, 1, idx.reshape(logp.shape[0], -1))
        return out, lp.reshape(idx.shape)
    return out


@register('random_categorical', stochastic=True, differentiable=False,
          aliases=('categorical',))
def categorical(logits, num_samples=None, key=None):
    probs = torch.softmax(logits.float(), dim=-1).reshape(
        -1, logits.shape[-1])
    n = num_samples or 1
    idx = torch.multinomial(probs, n, replacement=True, generator=key)
    batch = tuple(logits.shape[:-1])
    return idx.reshape(batch + (n,)) if num_samples else idx.reshape(batch)


@register('random_choice', stochastic=True, differentiable=False,
          aliases=('choice',))
def choice(a, size=None, replace=True, p=None, key=None):
    pool = torch.arange(int(a), device=key.device) if isinstance(
        a, (int, _np.integer)) else a
    m = pool.shape[0]
    shp = _shape(size)
    n = math.prod(shp)
    w = torch.ones(m, device=key.device) if p is None else \
        torch.as_tensor(p, device=key.device).float()
    idx = torch.multinomial(w, n, replacement=replace, generator=key)
    return pool[idx].reshape(shp)


@register('random_shuffle', stochastic=True, differentiable=False,
          aliases=('shuffle',))
def shuffle(x, key=None):
    return x[torch.randperm(x.shape[0], generator=key, device=key.device)]


@register('random_permutation', stochastic=True, differentiable=False,
          aliases=('permutation',))
def permutation(x, key=None):
    if isinstance(x, (int, _np.integer)):
        return torch.randperm(int(x), generator=key, device=key.device)
    return shuffle(x, key=key)


@register('random_bernoulli', stochastic=True, differentiable=False,
          aliases=('bernoulli',))
def bernoulli(prob=0.5, size=None, dtype='float32', key=None):
    prob = _t(prob, torch.float32, key.device)
    u = _uniform01(_shape(size, prob), 'float32', key)
    return (u < prob).to(_dtypes.to_torch(dtype))


@register('random_multivariate_normal', stochastic=True,
          differentiable=False, aliases=('multivariate_normal',))
def multivariate_normal(mean, cov, size=None, key=None):
    shp = _shape(size) if size is not None else tuple(mean.shape[:-1])
    chol = torch.linalg.cholesky(cov.float())
    z = _normal01(shp + (mean.shape[-1],), 'float32', key)
    return mean + (chol @ z[..., None])[..., 0]


# ------------------------------------------------------------ gamma family
def standard_gamma(shape_param, key):
    """Gamma(``shape_param``, 1) draws of ``shape_param``'s shape (a
    float tensor on the generator's device), by Marsaglia and Tsang's
    rejection (ACM TOMS 26(3), 2000) over ``key``: a shape below 1 draws at
    shape + 1 and scales by ``U**(1/shape)``. Each round draws for every
    element and keeps the first acceptance; rounds go on until every
    element has one (each accepts with probability above 0.95)."""
    a = shape_param.float()
    boost = a < 1
    d = torch.where(boost, a + 1, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while bool(todo.any()):
        x = _normal01(a.shape, 'float32', key)
        u = _open01(_uniform01(a.shape, 'float32', key))
        v = (1 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~take
    u = _open01(_uniform01(a.shape, 'float32', key))
    return torch.where(boost, out * u ** (1.0 / a), out)


@register('random_gamma', stochastic=True, differentiable=False,
          aliases=('gamma_sample',))
def gamma_sample(shape_param=1.0, scale=1.0, size=None, dtype='float32',
                 key=None):
    k = _t(shape_param, torch.float32, key.device)
    scale = _t(scale, torch.float32, key.device)
    shp = _shape(size, k, scale)
    g = standard_gamma(torch.broadcast_to(k, shp).contiguous(), key)
    return (g * scale).to(_dtypes.to_torch(dtype))


@register('random_negative_binomial', stochastic=True, differentiable=False)
def negative_binomial(k=1, p=0.5, size=None, dtype='float32', key=None):
    """Failures before the ``k``-th success: Poisson of a Gamma(k)
    rate scaled by ``(1 - p) / p``."""
    shp = _shape(size)
    kk = torch.full(shp, float(k), device=key.device)
    lam = standard_gamma(kk, key) * ((1 - p) / p)
    return torch.poisson(lam, generator=key).to(_dtypes.to_torch(dtype))


@register('random_beta', stochastic=True, differentiable=False,
          aliases=('beta_sample',))
def beta_sample(a, b, size=None, dtype='float32', key=None):
    """``X / (X + Y)`` of X ~ Gamma(a) and Y ~ Gamma(b)."""
    a = _t(a, torch.float32, key.device)
    b = _t(b, torch.float32, key.device)
    shp = _shape(size, a, b)
    x = standard_gamma(torch.broadcast_to(a, shp).contiguous(), key)
    y = standard_gamma(torch.broadcast_to(b, shp).contiguous(), key)
    return (x / (x + y)).to(_dtypes.to_torch(dtype))


@register('random_chisquare', stochastic=True, differentiable=False,
          aliases=('chisquare',))
def chisquare(df, size=None, dtype='float32', key=None):
    """``2 Gamma(df / 2)``."""
    df = _t(df, torch.float32, key.device)
    shp = _shape(size, df)
    g = standard_gamma(torch.broadcast_to(df / 2, shp).contiguous(), key)
    return (2 * g).to(_dtypes.to_torch(dtype))


def seed(seed_state, ctx='all'):
    """mx.random.seed (reference python/mxnet/random.py:seed)."""
    _rng.seed(seed_state, ctx)
    _np.random.seed(int(seed_state) & 0x7fffffff)
