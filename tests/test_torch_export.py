"""Export, import, checkpoints and symbol files across the two packages,
on the CPU.

* The committed files under ``tests/fixtures/format/`` (written by the
  JAX package) load into the port: its parameters re-save bit-exactly,
  its forward reproduces the recorded output at 1e-5 and the exported
  symbol through ``SymbolBlock.imports`` at 1e-4, the tolerances of
  ``tests/test_format_fixtures.py``; the port's own export of the same
  net is the fixture's graph node for node.
* A net exported by either package imports into the other, outputs
  equal at 1e-5, for an MLP, a conv-BN net and a 2-layer BERT of width
  64; the two ``-symbol.json`` files of one net agree node for node (op,
  attributes, wiring, variable names) apart from the counters' names.
* ``export()`` of a hybridized net that has taken graphed train steps
  (``_graphs.emulated()``), then another graphed step: the exported
  parameters equal the trained weights, the step after it reads them,
  and the weights follow the JAX package's run of the same steps.
* ``save_checkpoint``/``load_checkpoint`` round-trip against the JAX
  package's files; ROADMAP C16's witness: the JAX ``load_checkpoint``
  returns ``None`` for the symbol, the port the loaded symbol.
* ``tests/test_models.py::test_export_import`` and
  ``tests/test_transformer.py``'s two symbol cases, against the JAX runs.
"""

import json
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgl, model as jmodel
from mxnet_tpu.gluon import SymbolBlock as JSymbolBlock
from mxnet_tpu.gluon.model_zoo import bert as jbert

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _graphs, autograd as tag, gluon as tgl
from mxnet_tpu_torch import model as tmodel
from mxnet_tpu_torch.gluon import SymbolBlock as TSymbolBlock
from mxnet_tpu_torch.gluon.model_zoo import bert as tbert

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'fixtures', 'format')
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def on_cpu():
    with tmx.cpu():
        yield


def fix(name):
    return os.path.join(FIXDIR, name)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _graph(text):
    """Op, attributes, wiring and variable names of a symbol file."""
    d = json.loads(text)
    nodes = [{k: v for k, v in n.items() if k != 'name' or n['op'] == 'null'}
             for n in d['nodes']]
    return d['format'], nodes, d['arg_nodes'], d['heads']


def _read(path):
    with open(path) as f:
        return f.read()


# ------------------------------------------------------------- fixtures
def _mlp(gl):
    net = gl.nn.HybridSequential()
    net.add(gl.nn.Dense(16, activation='relu'), gl.nn.Dense(4))
    return net


def _mobilenet(gl):
    return gl.model_zoo.vision.get_model('mobilenet0.25', classes=4)


CASES = [('mlp', _mlp), ('mobilenet0_25', _mobilenet)]
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize('tag,build', CASES, ids=IDS)
def test_params_load_bit_exact_roundtrip(tag, build, tmp_path):
    net = build(tgl)
    net.load_parameters(fix(f'{tag}.params.npz'), ctx=tmx.cpu())
    out = str(tmp_path / 'resaved.npz')
    net.save_parameters(out)
    with np.load(fix(f'{tag}.params.npz')) as want, np.load(out) as got:
        assert sorted(want.files) == sorted(got.files)
        for k in want.files:
            assert want[k].dtype == got[k].dtype, k
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)


@pytest.mark.parametrize('tag,build', CASES, ids=IDS)
def test_params_npz_carries_format_magic(tag, build, tmp_path):
    assert tmodel._MAGIC_KEY == jmodel._MAGIC_KEY
    sym_file, param_file = _export_fixture_net(tag, build, tmp_path)
    for path in (fix(f'{tag}.params.npz'), param_file):
        with np.load(path) as z:
            assert list(z[tmodel._MAGIC_KEY]) == [2, 0]


@pytest.mark.parametrize('tag,build', CASES, ids=IDS)
def test_forward_matches_recorded_output(tag, build):
    net = build(tgl)
    net.load_parameters(fix(f'{tag}.params.npz'), ctx=tmx.cpu())
    x = tmx.np.array(np.load(fix(f'{tag}.input.npy')))
    want = np.load(fix(f'{tag}.output.npy'))
    np.testing.assert_allclose(net(x).asnumpy(), want, rtol=1e-5, atol=0)


@pytest.mark.parametrize('tag,build', CASES, ids=IDS)
def test_exported_symbol_imports_and_executes(tag, build):
    loaded = TSymbolBlock.imports(fix(f'{tag}-symbol.json'), 'data',
                                  fix(f'{tag}-0000.params.npz'))
    x = tmx.np.array(np.load(fix(f'{tag}.input.npy')))
    want = np.load(fix(f'{tag}.output.npy'))
    np.testing.assert_allclose(loaded(x).asnumpy(), want, rtol=1e-4,
                               atol=1e-20)


def _export_fixture_net(tag, build, tmp_path):
    net = build(tgl)
    net.load_parameters(fix(f'{tag}.params.npz'), ctx=tmx.cpu())
    net(tmx.np.array(np.load(fix(f'{tag}.input.npy'))))
    return net.export(str(tmp_path / tag))


def test_symbol_json_format_tag(tmp_path):
    sym = json.loads(_read(fix('mlp-symbol.json')))
    assert sym['format'] == 'mxnet_tpu-symbol-v1'
    assert [sym['nodes'][i]['name'] for i in sym['arg_nodes']][0] == 'data'
    for tag, build in CASES:
        sym_file, _ = _export_fixture_net(tag, build, tmp_path)
        assert _graph(_read(sym_file)) == \
            _graph(_read(fix(f'{tag}-symbol.json')))


# ---------------------------------------------------- across the packages
def _convbn(gl):
    net = gl.nn.HybridSequential()
    net.add(gl.nn.Conv2D(4, 3, padding=1), gl.nn.BatchNorm(),
            gl.nn.Activation('relu'))
    return net


TINY_BERT = dict(vocab_size=200, num_layers=2, units=64, hidden_size=128,
                 num_heads=4, max_length=32, dropout=0.1)


def _bert(gl):
    mod = jbert if gl is jgl else tbert
    return mod.get_bert_model('bert_12_768_12', **TINY_BERT)


def _inputs(kind):
    if kind == 'mlp':
        return [_rand((2, 8))]
    if kind == 'convbn':
        return [_rand((2, 2, 8, 8))]
    rng = np.random.default_rng(4)
    return [rng.integers(0, 200, (2, 12)).astype(np.int32),
            rng.integers(0, 2, (2, 12)).astype(np.int32)]


NETS = {'mlp': _mlp, 'convbn': _convbn, 'bert': _bert}


def _net_pair(kind):
    """The JAX net and the port's with its weights, BatchNorm's running
    statistics moved off their defaults."""
    xs = _inputs(kind)
    jnet = NETS[kind](jgl)
    jnet.initialize()
    jnet(*[jmx.np.array(x) for x in xs])
    rng = np.random.default_rng(5)
    for name, p in jnet.collect_params().items():
        if name.endswith(('running_mean', 'running_var')):
            p.set_data(np.abs(rng.standard_normal(p.shape)).astype('f')
                       + 0.5)
    w = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnet = NETS[kind](tgl)
    tnet.initialize()
    tnet(*[tmx.np.array(x) for x in xs])
    tnet.load_dict(w)
    return jnet, tnet, xs


def _outs(res):
    res = res if isinstance(res, (list, tuple)) else [res]
    return [r.asnumpy() for r in res]


@pytest.mark.parametrize('kind', list(NETS))
@pytest.mark.parametrize('way', ['jax_to_port', 'port_to_jax'])
def test_exported_file_runs_in_the_other_package(kind, way, tmp_path):
    jnet, tnet, xs = _net_pair(kind)
    names = 'data' if len(xs) == 1 else [f'data{i}' for i in range(len(xs))]
    want = _outs(jnet(*[jmx.np.array(x) for x in xs]))
    if way == 'jax_to_port':
        files = jnet.export(str(tmp_path / kind))
        got = _outs(TSymbolBlock.imports(*files[:1], names, files[1])(
            *[tmx.np.array(x) for x in xs]))
    else:
        files = tnet.export(str(tmp_path / kind))
        got = _outs(JSymbolBlock.imports(*files[:1], names, files[1])(
            *[jmx.np.array(x) for x in xs]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize('kind', list(NETS))
def test_symbol_files_agree_node_for_node(kind, tmp_path):
    jnet, tnet, xs = _net_pair(kind)
    jfiles = jnet.export(str(tmp_path / 'j'))
    tfiles = tnet.export(str(tmp_path / 't'))
    assert _graph(_read(tfiles[0])) == _graph(_read(jfiles[0]))
    with np.load(jfiles[1]) as a, np.load(tfiles[1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_export_import():
    """tests/test_models.py::test_export_import in both packages: the
    files exist and hold the same parameter names."""
    import tempfile
    paths = {}
    for name, mx, gl in (('jax', jmx, jgl), ('port', tmx, tgl)):
        net = gl.nn.HybridSequential()
        net.add(gl.nn.Dense(4), gl.nn.Dense(2))
        net.initialize()
        net.hybridize()
        x = mx.np.ones((1, 3))
        net(x)
        net(x)
        d = tempfile.mkdtemp()
        sym_file, param_file = net.export(os.path.join(d, 'model'))
        assert os.path.exists(param_file) and os.path.exists(sym_file)
        with np.load(param_file) as z:
            paths[name] = (sorted(z.files), _graph(_read(sym_file)))
    assert paths['port'] == paths['jax']


# ------------------------------------------------------- transformer cases
def test_symbolblock_from_traced_symbol_with_aux():
    table = _rand((1, 32, 16), 6)
    x = _rand((2, 32, 16), 7)
    outs = []
    for mx, gl in ((jmx, jgl), (tmx, tgl)):
        class PosBlock(gl.HybridBlock):
            def __init__(self):
                super().__init__()
                self.table = mx.np.array(table)

            def forward(self, x):
                return x + self.table

        net = PosBlock()
        ref = net(mx.np.array(x)).asnumpy()
        blk = gl.SymbolBlock(net._trace_symbol(mx.np.array(x)), 'data')
        got = blk(mx.np.array(x)).asnumpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6)
        outs.append(got)
    np.testing.assert_array_equal(outs[1], outs[0])


def test_symbol_unique_positional_flags():
    counts = [mx.sym.np.unique(mx.sym.var('x'), True).num_outputs
              for mx in (jmx, tmx)]
    assert counts == [2, 2]


# ------------------------------------------------------------ checkpoints
def _traced_mlp():
    jnet, tnet, xs = _net_pair('mlp')
    jsym = jnet._trace_symbol(jmx.np.array(xs[0]))
    tsym = tnet._trace_symbol(tmx.np.array(xs[0]))
    args = {k: p.data() for k, p in tnet.collect_params().items()}
    return jnet, tnet, jsym, tsym, args, xs[0]


@pytest.mark.parametrize('way', ['jax_to_port', 'port_to_jax'])
def test_checkpoint_roundtrip_across_packages(way, tmp_path):
    jnet, tnet, jsym, tsym, targs, x = _traced_mlp()
    jargs = {k: p.data() for k, p in jnet.collect_params().items()}
    aux = {'extra': np.arange(3, dtype=np.float32)}
    prefix = str(tmp_path / 'ck')
    if way == 'jax_to_port':
        jmodel.save_checkpoint(prefix, 3, jsym, jargs,
                               {'extra': jmx.np.array(aux['extra'])})
        sym, args, auxs = tmodel.load_checkpoint(prefix, 3)
        got = sym.eval(data=tmx.np.array(x), **args)[0].asnumpy()
    else:
        tmodel.save_checkpoint(prefix, 3, tsym, targs,
                               {'extra': tmx.np.array(aux['extra'])})
        _, args, auxs = jmodel.load_checkpoint(prefix, 3)
        sym = jmx.sym.load(f'{prefix}-symbol.json')
        got = sym.eval(data=jmx.np.array(x), **args)[0].asnumpy()
    with np.load(f'{prefix}-0003.params.npz') as z:
        assert sorted(z.files) == sorted(
            ['__mxnet_tpu_format__', 'arg:0.weight', 'arg:0.bias',
             'arg:1.weight', 'arg:1.bias', 'aux:extra'])
    assert sorted(args) == sorted(jargs)
    for k, v in jargs.items():
        np.testing.assert_array_equal(args[k].asnumpy(), v.asnumpy())
    np.testing.assert_array_equal(auxs['extra'].asnumpy(), aux['extra'])
    np.testing.assert_allclose(got, jnet(jmx.np.array(x)).asnumpy(), **TOL)


def test_C16_jax_load_checkpoint_drops_the_symbol(tmp_path, capsys):
    """ROADMAP C16: MXNet's ``load_checkpoint`` returns the symbol it
    loads; the JAX package's returns ``None`` in its place although it
    wrote ``{prefix}-symbol.json``. The port returns the symbol."""
    _, _, jsym, tsym, targs, x = _traced_mlp()
    prefix = str(tmp_path / 'c16')
    tmodel.save_checkpoint(prefix, 0, tsym, targs, {})
    assert os.path.exists(f'{prefix}-symbol.json')
    jgot, _, _ = jmodel.load_checkpoint(prefix, 0)
    tgot, _, _ = tmodel.load_checkpoint(prefix, 0)
    with capsys.disabled():
        print(f'\n[C16] JAX load_checkpoint symbol: {jgot!r}; port: '
              f'{tgot!r}')
    assert jgot is None
    assert tgot.list_arguments() == tsym.list_arguments()
    assert _graph(tgot.tojson()) == _graph(tsym.tojson())


# ------------------------------------------------- export after training
def _train(mx, gl, ag, net, steps, x, y, trainer):
    for _ in range(steps):
        with ag.record():
            loss = ((net(mx.np.array(x)) - mx.np.array(y)) ** 2).mean()
        loss.backward()
        trainer.step(1)


def test_export_after_graphed_training_reads_the_trained_weights(tmp_path):
    jnet, tnet, xs = _net_pair('mlp')
    x, y = xs[0], _rand((2, 4), 9)
    jtr = jgl.Trainer(jnet.collect_params(), 'adam', {'learning_rate': 0.01})
    ttr = tgl.Trainer(tnet.collect_params(), 'adam', {'learning_rate': 0.01})
    jnet.hybridize()
    tnet.hybridize()
    with _graphs.emulated():
        _train(jmx, jgl, jag, jnet, 2, x, y, jtr)
        _train(tmx, tgl, tag, tnet, 2, x, y, ttr)
        assert tnet.capture_count == 2 and ttr.capture_count == 1
        trained = {k: p.data().asnumpy()
                   for k, p in tnet.collect_params().items()}
        _, param_file = tnet.export(str(tmp_path / 'after'))
        with np.load(param_file) as z:
            for k, v in trained.items():
                np.testing.assert_array_equal(z[k], v, err_msg=k)
        _train(jmx, jgl, jag, jnet, 1, x, y, jtr)
        _train(tmx, tgl, tag, tnet, 1, x, y, ttr)
        assert tnet.capture_count == 2 and ttr.capture_count == 1
    for k, p in tnet.collect_params().items():
        got = p.data().asnumpy()
        assert not np.array_equal(got, trained[k]), k
        np.testing.assert_allclose(
            got, jnet.collect_params()[k].data().asnumpy(), **TOL)
