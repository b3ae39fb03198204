"""``mx.sym`` and deferred compute of the port against the JAX package's,
on the CPU.

Each test is one of ``tests/test_symbol.py``'s oracles (all but the three
that need ``gluon/rnn`` or ``test_utils``, ROADMAP A11), run in both
packages on the same seeded numpy inputs and weights (a JAX net's weights
carried into the port's by name): the outputs agree at 1e-6 relative, and
a traced or declared symbol's ``infer_shape``/``infer_type`` give the same
shapes and dtypes, the port's by abstract evaluation on meta tensors.
Node names come from a process-wide counter, so graphs are compared by
op, attributes, wiring and variable names.
"""

import json
import os
import types

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon import SymbolBlock as JSymbolBlock, nn as jnn

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.gluon import SymbolBlock as TSymbolBlock, nn as tnn

RTOL = 1e-6

J = types.SimpleNamespace(mx=jmx, nn=jnn, SymbolBlock=JSymbolBlock,
                          autograd=jag, name='jax')
T = types.SimpleNamespace(mx=tmx, nn=tnn, SymbolBlock=TSymbolBlock,
                          autograd=tag, name='torch')


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _weights(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _carry(P, net, w):
    """Give the port's net the JAX net's weights ``w``."""
    if P is T and w is not None:
        net.load_dict(w)


def _graph(sym):
    """Op, attributes, wiring and variable names of a symbol's file."""
    d = json.loads(sym.tojson())
    nodes = [{k: v for k, v in n.items() if k != 'name' or n['op'] == 'null'}
             for n in d['nodes']]
    return nodes, d['arg_nodes'], d['heads']


def _close(got, want):
    assert type(got) is type(want), (got, want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b)
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    else:
        assert got == want


def _both(case, tmp_path=None):
    """``case(P, w, tmp)`` in the JAX package, then the port given the
    weights the JAX run returned; the results agree."""
    jt = tmp_path / 'jax' if tmp_path is not None else None
    tt = tmp_path / 'torch' if tmp_path is not None else None
    for d in (jt, tt):
        if d is not None:
            d.mkdir()
    want, w = case(J, None, jt)
    got, _ = case(T, w, tt)
    _close(got, want)
    return got


def _inferred(sym, **shapes):
    """``infer_shape``/``infer_type`` of a symbol, as plain values."""
    a, o, x = sym.infer_shape(**shapes)
    ta, to, _ = sym.infer_type() if not shapes else (None, None, None)
    res = [[tuple(s) for s in a], [tuple(s) for s in o], list(x)]
    if ta is not None:
        res += [[str(t) for t in ta], [str(t) for t in to]]
    return res


# ------------------------------------------------------- symbolic graphs
def test_variable_and_compose():
    def case(P, w, tmp):
        x, y = P.mx.sym.var('x'), P.mx.sym.var('y')
        z = x + y * 2.0
        out = z.eval(x=P.mx.np.array(_rand((2, 2))),
                     y=P.mx.np.array(_rand((2, 2), 1)))
        return [sorted(z.list_arguments()), out[0].asnumpy(),
                _inferred(z, x=(2, 2), y=(2, 2))], None
    got = _both(case)
    np.testing.assert_allclose(got[1], _rand((2, 2)) + 2 * _rand((2, 2), 1),
                               rtol=RTOL)


def test_symbol_op_namespace():
    def case(P, w, tmp):
        x = P.mx.sym.var('x')
        y = P.mx.sym.np.tanh(x) + P.mx.sym.np.exp(x)
        (res,) = y.eval(x=P.mx.np.array(_rand((3,))))
        return [res.asnumpy(), _inferred(y, x=(3,))], None
    _both(case)


def test_infer_shape():
    def case(P, w, tmp):
        x, wv = P.mx.sym.var('x'), P.mx.sym.var('w')
        y = P.mx.sym.np.matmul(x, wv)
        res = y.eval(x=P.mx.np.array(_rand((4, 8))),
                     w=P.mx.np.array(_rand((8, 3), 1)))
        return [_inferred(y, x=(4, 8), w=(8, 3)), res[0].asnumpy()], None
    got = _both(case)
    assert got[0][:2] == [[(4, 8), (8, 3)], [(4, 3)]]


def test_infer_type():
    def case(P, w, tmp):
        x = P.mx.sym.var('x', shape=(2, 2))
        y = P.mx.sym.np.sum(x)
        _, out_types, _ = y.infer_type(x='float32')
        return [[str(t) for t in out_types], _inferred(y)], None
    assert _both(case)[0] == ['float32']


def test_tojson_roundtrip():
    def case(P, w, tmp):
        x = P.mx.sym.var('x')
        y = (x * x).reshape((4,))
        y2 = P.mx.sym.fromjson(y.tojson())
        a = P.mx.np.array(_rand((2, 2)))
        return [y.eval(x=a)[0].asnumpy(), y2.eval(x=a)[0].asnumpy(),
                _graph(y2)], None
    got = _both(case)
    np.testing.assert_array_equal(got[0], got[1])


def test_group_and_getitem():
    def case(P, w, tmp):
        x = P.mx.sym.var('x')
        g = P.mx.sym.Group([x + 1.0, x * 3.0])
        a = P.mx.np.array(_rand((2,)))
        outs = g.eval(x=a)
        return [g.num_outputs, outs[0].asnumpy(), outs[1].asnumpy(),
                g[1].eval(x=a)[0].asnumpy()], None
    got = _both(case)
    assert got[0] == 2


def test_executor_forward_backward():
    def case(P, w, tmp):
        x = P.mx.sym.var('x')
        y = (x * x).sum()
        exe = y.bind(args={'x': P.mx.np.array(_rand((3,)))})
        out = exe.forward(is_train=True)
        exe.backward()
        return [out[0].asnumpy(), exe.grad_dict['x'].asnumpy()], None
    got = _both(case)
    np.testing.assert_allclose(got[1], 2 * _rand((3,)), rtol=RTOL)


def test_compose_substitution():
    def case(P, w, tmp):
        x = P.mx.sym.var('x')
        y = x * 2.0
        z = P.mx.sym.var('z')
        y2 = y.compose(x=z + 1.0)
        (res,) = y2.eval(z=P.mx.np.array(_rand((2,))))
        return [res.asnumpy(), y2.list_arguments()], None
    got = _both(case)
    np.testing.assert_allclose(got[0], (_rand((2,)) + 1) * 2, rtol=RTOL)


def test_symbol_multi_output_split():
    def case(P, w, tmp):
        x = P.mx.sym.var('x')
        parts = P.mx.sym.np.split(x, 2)
        outs = parts.eval(x=P.mx.np.arange(4.0).reshape(4, 1))
        return [parts.num_outputs, [o.asnumpy() for o in outs],
                _inferred(parts, x=(4, 1))], None
    got = _both(case)
    np.testing.assert_allclose(got[1][1], [[2.0], [3.0]])


def test_compose_no_duplicate_shared_nodes():
    def case(P, w, tmp):
        x = P.mx.sym.var('x')
        shared = P.mx.sym.np.matmul(x, x)
        g = P.mx.sym.Group([shared + 1.0, shared * 1.0])
        g2 = g.compose(x=P.mx.sym.var('z'))
        n = len([nd for nd in g2._topo() if nd.op == 'matmul'])
        outs = g2.eval(z=P.mx.np.array(_rand((3, 3))))
        return [n, [o.asnumpy() for o in outs]], None
    assert _both(case)[0] == 1


def test_symbol_qr_positional_mode():
    def case(P, w, tmp):
        a = P.mx.sym.var('a')
        r_only = P.mx.sym.np.linalg_qr(a, 'r')
        qr = P.mx.sym.np.linalg_qr(a)
        return [r_only.num_outputs, qr.num_outputs,
                _inferred(qr, a=(4, 3))], None
    assert _both(case)[:2] == [1, 2]


def test_topk_positional_ret_typ():
    def case(P, w, tmp):
        x = P.mx.sym.var('x')
        both = P.mx.sym.np.topk(x, -1, 2, 'both')
        outs = both.eval(x=P.mx.np.array(_rand((3, 5))))
        return [both.num_outputs, [o.asnumpy() for o in outs]], None
    assert _both(case)[0] == 2


def test_compose_carries_aux_bindings():
    def case(P, w, tmp):
        x = P.mx.sym.var('x')
        inner = x * 2.0
        inner._aux['const_c'] = P.mx.np.array(np.array([5.0], 'f'))
        head = P.mx.sym.var('h') + P.mx.sym.var('const_c')
        composed = head(h=inner)
        out = composed.eval(x=P.mx.np.array(np.array([1.0], 'f')))
        return [out[0].asnumpy()], None
    assert float(_both(case)[0][0]) == 7.0


def test_infer_shape_positional():
    def case(P, w, tmp):
        x, y = P.mx.sym.var('x'), P.mx.sym.var('y')
        a_shapes, o_shapes, _ = (x + y).infer_shape((2, 3), (2, 3))
        return [[tuple(s) for s in a_shapes],
                [tuple(s) for s in o_shapes]], None
    assert _both(case) == [[(2, 3), (2, 3)], [(2, 3)]]


def test_symbol_kwarg_list_of_symbols():
    def case(P, w, tmp):
        a, b = P.mx.sym.var('a'), P.mx.sym.var('b')
        s = P.mx.sym.concat(a, b, axis=0)
        av, bv = P.mx.np.array(_rand((1, 2))), P.mx.np.array(_rand((1, 2), 1))
        s2 = P.mx.sym.fromjson(s.tojson())
        return [s.eval(a=av, b=bv)[0].asnumpy(),
                s2.eval(a=av, b=bv)[0].asnumpy(), _graph(s)], None
    assert _both(case)[0].shape == (2, 2)


# --------------------------------------------------- traced from blocks
def _mlp(P, w, units=(5, 2), act='relu'):
    net = P.nn.HybridSequential()
    net.add(P.nn.Dense(units[0], activation=act), P.nn.Dense(units[1]))
    net.initialize()
    return net


def test_trace_symbol_from_block():
    def case(P, w, tmp):
        net = _mlp(P, w)
        x = P.mx.np.array(_rand((3, 4)))
        net(x)
        _carry(P, net, w)
        ref = net(x)
        sym = net._trace_symbol(x)
        bindings = {'data': x}
        for name, p in net.collect_params().items():
            bindings[name] = p.data()
        out = sym.eval(**bindings)[0]
        return [ref.asnumpy(), out.asnumpy(), _graph(sym),
                _inferred(sym)], _weights(net)
    got = _both(case)
    assert 'data' in got[2][0][0]['name']


def test_export_imports_roundtrip(tmp_path):
    def case(P, w, tmp):
        net = _mlp(P, w, (8, 3), 'tanh')
        x = P.mx.np.array(_rand((2, 6)))
        net(x)
        _carry(P, net, w)
        net.hybridize()
        ref = net(x).asnumpy()
        sym_file, param_file = net.export(str(tmp / 'model'))
        loaded = P.SymbolBlock.imports(sym_file, 'data', param_file)
        return [ref, loaded(x).asnumpy()], _weights(net)
    got = _both(case, tmp_path)
    np.testing.assert_allclose(got[1], got[0], rtol=RTOL)


def test_export_conv_bn_graph(tmp_path):
    def case(P, w, tmp):
        net = P.nn.HybridSequential()
        net.add(P.nn.Conv2D(4, 3, padding=1), P.nn.BatchNorm(),
                P.nn.Activation('relu'))
        net.initialize()
        x = P.mx.np.array(_rand((1, 2, 8, 8)))
        net(x)
        _carry(P, net, w)
        sym_file, param_file = net.export(str(tmp / 'conv'),
                                          input_shapes=[x])
        loaded = P.SymbolBlock.imports(sym_file, 'data', param_file)
        with open(sym_file) as f:
            graph = _graph(P.mx.sym.fromjson(f.read()))
        return [net(x).asnumpy(), loaded(x).asnumpy(), graph], _weights(net)
    _both(case, tmp_path)


def test_imported_block_supports_autograd(tmp_path):
    def case(P, w, tmp):
        net = P.nn.Dense(2)
        net.initialize()
        x = P.mx.np.array(_rand((3, 4)))
        net(x)
        _carry(P, net, w)
        net.hybridize()
        net(x)
        sym_file, param_file = net.export(str(tmp / 'g'))
        loaded = P.SymbolBlock.imports(sym_file, 'data', param_file)
        xg = P.mx.np.array(_rand((3, 4), 1))
        xg.attach_grad()
        with P.autograd.record():
            y = loaded(xg).sum()
        y.backward()
        grads = {k: p.grad().asnumpy()
                 for k, p in loaded.collect_params().items()}
        return [y.asnumpy(), xg.grad.asnumpy(), grads], _weights(net)
    _both(case, tmp_path)


def test_stochastic_op_not_baked():
    def case(P, w, tmp):
        net = P.nn.HybridSequential()
        net.add(P.nn.Dense(4), P.nn.Dropout(0.5))
        net.initialize()
        x = P.mx.np.array(_rand((2, 3)))
        net(x)
        sym = net._trace_symbol(x)
        sym.tojson()
        baked = [n.op for n in sym._topo() if 'key' in n.kwargs]
        return [baked, _graph(sym)], None
    assert _both(case)[0] == []


def test_setitem_recorded_in_export():
    def case(P, w, tmp):
        class SetBlock(P.nn.HybridBlock):
            def forward(self, x):
                y = x * 2.0
                y[0] = 99.0
                return y + 0.0

        net = SetBlock()
        x = P.mx.np.array(_rand((2, 2)))
        ref = net(x).asnumpy()
        sym = net._trace_symbol(x)
        return [ref, sym.eval(data=x)[0].asnumpy(), _graph(sym)], None
    got = _both(case)
    assert got[1][0, 0] == 99.0


def test_getitem_recorded_in_export():
    def case(P, w, tmp):
        class SliceBlock(P.nn.HybridBlock):
            def __init__(self):
                super().__init__()
                self.d = P.nn.Dense(4)

            def forward(self, x):
                return self.d(x)[:, :2]

        net = SliceBlock()
        net.initialize()
        x = P.mx.np.array(_rand((3, 5)))
        net(x)
        _carry(P, net, w)
        sym2 = P.mx.sym.fromjson(net._trace_symbol(x).tojson())
        bindings = {'data': x}
        for name, p in net.collect_params().items():
            bindings[name] = p.data()
        return [net(x).asnumpy(), sym2.eval(**bindings)[0].asnumpy(),
                _graph(sym2)], _weights(net)
    _both(case)


def test_big_constant_hoisted_to_params(tmp_path):
    table = _rand((1, 32, 64), 3)

    def case(P, w, tmp):
        class PosBlock(P.nn.HybridBlock):
            def __init__(self):
                super().__init__()
                self.table = P.mx.np.array(table)

            def forward(self, x):
                return x + self.table

        net = PosBlock()
        x = P.mx.np.array(_rand((2, 32, 64)))
        ref = net(x).asnumpy()
        sym_file, param_file = net.export(str(tmp / 'pos'),
                                          input_shapes=[x])
        small = os.path.getsize(sym_file) < 10_000
        loaded = P.SymbolBlock.imports(sym_file, 'data', param_file)
        with open(sym_file) as f:
            graph = _graph(P.mx.sym.fromjson(f.read()))
        return [small, ref, loaded(x).asnumpy(), graph], None
    assert _both(case, tmp_path)[0] is True
