"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points go to the card unless told otherwise."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / 'mxnet_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'mxnet_tpu')


def test_importing_every_module_loads_no_jax():
    code = (
        'import importlib, pkgutil, sys\n'
        'import mxnet_tpu_torch as pkg\n'
        'for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):\n'
        '    importlib.import_module(m.name)\n'
        'bad = sorted(n for n in sys.modules\n'
        '             if n.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))\n'
        'print("LOADED", bad)\n')
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == 'LOADED []'


def test_the_package_exports_the_frontend_and_loads_no_jax():
    code = (
        'import sys\n'
        'import mxnet_tpu_torch as mx\n'
        'names = ("np", "npx", "nd", "autograd", "random", "NDArray", '
        '"waitall")\n'
        'print("MISSING", [n for n in names if not hasattr(mx, n)])\n'
        'bad = sorted(n for n in sys.modules\n'
        '             if n.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))\n'
        'print("LOADED", bad)\n')
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-2:] == ['MISSING []',
                                                    'LOADED []']


def test_the_sparse_fft_and_control_flow_surfaces_load_no_jax():
    code = (
        'import sys\n'
        'import mxnet_tpu_torch as mx\n'
        'have = [mx.nd.sparse.RowSparseNDArray, mx.nd.sparse.csr_matrix,\n'
        '        mx.np.fft.fft, mx.np.linalg.eigh, mx.npx.foreach,\n'
        '        mx.npx.while_loop, mx.nd.contrib.cond,\n'
        '        mx.np.random.gamma]\n'
        'bad = sorted(n for n in sys.modules\n'
        '             if n.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))\n'
        'print("LOADED", bad)\n')
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == 'LOADED []'


def test_the_symbol_export_and_engine_surfaces_load_no_jax():
    code = (
        'import sys\n'
        'import mxnet_tpu_torch as mx\n'
        'from mxnet_tpu_torch import _bulk, _deferred_compute, engine\n'
        'have = [mx.sym.var, mx.symbol.Group, mx.sym.np.matmul,\n'
        '        mx.gluon.SymbolBlock.imports, mx.gluon.HybridBlock.export,\n'
        '        mx.model.save_checkpoint, mx.model.load_checkpoint,\n'
        '        mx.amp.convert_symbol, mx.amp.convert_model,\n'
        '        engine.bulk, engine.naive_engine, engine.bulk_stats,\n'
        '        _bulk.try_record, _deferred_compute.get_symbol]\n'
        'bad = sorted(n for n in sys.modules\n'
        '             if n.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))\n'
        'print("LOADED", bad)\n')
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == 'LOADED []'


@pytest.mark.parametrize('path', sorted(
    str(p.relative_to(ROOT)) for p in PACKAGE.rglob('*.py')))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split('.')[0] not in FORBIDDEN, \
                f'{path}:{node.lineno} imports {name}'


def test_no_card_means_an_error_not_the_cpu(monkeypatch):
    from mxnet_tpu_torch import MXNetError, context
    from mxnet_tpu_torch.gluon.model_zoo.llama import llama_tiny
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert context.current_context() == context.gpu(0)
    with pytest.raises(MXNetError):
        llama_tiny().initialize()
    with pytest.raises(MXNetError):
        context.resolve_device('cuda:0')
    assert context.resolve_device('cpu') == torch.device('cpu')
    with context.cpu():
        net = llama_tiny()
        net.initialize()
        assert net.lm_head.weight.data()._data.device.type == 'cpu'


def test_the_frontend_with_no_card_and_no_context_raises(monkeypatch):
    import mxnet_tpu_torch as mx
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert mx.current_context() == mx.gpu(0)
    with pytest.raises(mx.MXNetError):
        mx.np.ones((2, 3))
    with pytest.raises(mx.MXNetError):
        mx.np.array([1.0])
    with pytest.raises(mx.MXNetError):
        mx.np.random.normal(size=(2,))
    with mx.cpu():
        assert mx.np.ones((2, 3)).context == mx.cpu()


def test_the_kvstore_package_is_checked_and_loads_no_jax():
    """``mx.kvstore`` (ported from the JAX package's ``kvstore/``) is
    among the sources checked above, and importing it with the
    distributed layers loads no JAX."""
    kv = sorted(p.name for p in (PACKAGE / 'kvstore').glob('*.py'))
    assert {'__init__.py', 'base.py', 'kvstore.py', 'fusion.py',
            'gradient_compression.py', 'tpu.py', 'plugins.py'} <= set(kv)
    code = (
        'import sys\n'
        'from mxnet_tpu_torch import kvstore, parallel\n'
        'from mxnet_tpu_torch.gluon import Trainer, nn\n'
        'assert kvstore.create("dist_sync").type == "dist_tpu_sync"\n'
        'bad = sorted(n for n in sys.modules\n'
        '             if n.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))\n'
        'print("LOADED", bad)\n')
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == 'LOADED []'


def test_the_parameter_server_and_train_are_checked_and_load_no_jax():
    """The parameter server (``kvstore/faults.py``, ``rpc.py``,
    ``dist_async.py``) and ``train/`` are among the sources checked above,
    and making a ``dist_async`` store and an ``ElasticGroup`` class loads
    no JAX."""
    kv = {p.name for p in (PACKAGE / 'kvstore').glob('*.py')}
    assert {'faults.py', 'rpc.py', 'dist_async.py'} <= kv
    assert {p.name for p in (PACKAGE / 'train').glob('*.py')} == {
        '__init__.py', 'elastic.py'}
    code = (
        'import sys\n'
        'from mxnet_tpu_torch import kvstore, train\n'
        'from mxnet_tpu_torch.kvstore import dist_async, faults, rpc\n'
        'kv = kvstore.create("dist_async", device="cpu")\n'
        'assert kv.type == "dist_async" and train.ElasticGroup\n'
        'bad = sorted(n for n in sys.modules\n'
        '             if n.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))\n'
        'print("LOADED", bad)\n')
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == 'LOADED []'


def test_sharding_and_the_sharded_parallel_modules_load_no_jax():
    """``mx.sharding`` (``sharding/*``), ``parallel/sharded.py`` and
    ``parallel/checkpoint.py`` are among the sources checked above, and
    using them (rules, a mesh context, a checkpoint manager) loads no
    JAX."""
    assert {p.name for p in (PACKAGE / 'sharding').glob('*.py')} == {
        '__init__.py', 'rules.py', 'context.py', 'dispatch.py',
        '_collectives.py'}
    par = {p.name for p in (PACKAGE / 'parallel').glob('*.py')}
    assert {'sharded.py', 'checkpoint.py'} <= par
    code = (
        'import sys, tempfile\n'
        'import mxnet_tpu_torch as mx\n'
        'from mxnet_tpu_torch import parallel, sharding\n'
        'from mxnet_tpu_torch.parallel import checkpoint, sharded\n'
        'P = sharding.PartitionSpec\n'
        'assert sharding.match_spec("a.weight", (4, 4), '
        '[(r".*", P("dp"))]) == P("dp")\n'
        'with sharding.mesh(dp=1) as ctx:\n'
        '    assert sharding.current() is ctx\n'
        'with tempfile.TemporaryDirectory() as d:\n'
        '    m = parallel.SharedCheckpointManager(d)\n'
        '    m.save(0, {"w": [1.0, 2.0]})\n'
        '    assert m.latest_step() == 0\n'
        'bad = sorted(n for n in sys.modules\n'
        '             if n.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))\n'
        'print("LOADED", bad)\n')
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == 'LOADED []'


def test_elastic_pipeline_and_moe_modules_load_no_jax():
    """``train/elastic.py`` (``ElasticTrainer``, ``MeshElasticTrainer``),
    ``parallel/pipeline.py``, ``parallel/gluon_pipeline.py`` and
    ``parallel/moe.py`` are among the sources checked above, and using them
    in one process (a checkpointed save and restore, one-stage schedules,
    an ep = 1 MoE) loads no JAX."""
    par = {p.name for p in (PACKAGE / 'parallel').glob('*.py')}
    assert {'pipeline.py', 'gluon_pipeline.py', 'moe.py'} <= par
    code = (
        'import sys, tempfile, torch\n'
        'import mxnet_tpu_torch as mx\n'
        'from mxnet_tpu_torch import parallel, train\n'
        'from mxnet_tpu_torch.sharding import ShardingContext\n'
        'assert train.MeshElasticTrainer and parallel.PipelineTrainer\n'
        'with mx.cpu(), tempfile.TemporaryDirectory() as d:\n'
        '    net = mx.gluon.nn.Dense(4, in_units=4)\n'
        '    net.initialize(ctx=mx.cpu())\n'
        '    et = train.ElasticTrainer(dict(net.collect_params()), None,\n'
        '                              parallel.SharedCheckpointManager(d))\n'
        '    et.save(0, block=True)\n'
        '    assert et.restore() == 0\n'
        '    et.close()\n'
        '    one = ShardingContext({"pp": 1})\n'
        '    w = parallel.stack_stage_params([{"w": torch.eye(3)}])\n'
        '    xs = torch.ones(2, 1, 3)\n'
        '    y = parallel.pipeline_apply(lambda p, x: x @ p["w"], w, xs, one)\n'
        '    assert torch.equal(y._data, xs)\n'
        '    g, l = parallel.pipeline_train_1f1b(\n'
        '        lambda p, x: x @ p["w"], lambda y, t: ((y - t).pow(2).sum(),\n'
        '        2 * (y - t)), w, xs, xs, one)\n'
        '    assert float(l) == 0.0\n'
        '    y, aux = parallel.moe_ffn(torch.ones(4, 2), torch.ones(2, 2),\n'
        '                              torch.ones(2, 2, 3),\n'
        '                              torch.ones(2, 3, 2), None)\n'
        '    assert y.shape == (4, 2) and float(aux) > 0\n'
        'bad = sorted(n for n in sys.modules\n'
        '             if n.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))\n'
        'print("LOADED", bad)\n')
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == 'LOADED []'


def test_the_gluon_llama_and_its_hf_import_load_no_jax():
    """The Llama family on the Gluon blocks, its HF import and the int8
    Gluon walk are among the sources checked above, and using them (a
    ``llama_tiny`` initialized, hybridized, called and quantized; a
    safetensors file read back) loads no JAX."""
    code = (
        'import sys, tempfile, os, torch\n'
        'import mxnet_tpu_torch as mx\n'
        'from mxnet_tpu_torch import quantization\n'
        'from mxnet_tpu_torch.gluon.model_zoo import llama\n'
        'import chip_smoke\n'
        'with mx.cpu():\n'
        '    net = llama.llama_tiny()\n'
        '    net.initialize(llama.LlamaInit(0))\n'
        '    net.hybridize()\n'
        '    toks = mx.nd.array([[1, 2, 3]], dtype="int32")\n'
        '    assert net(toks).shape == (1, 3, 256)\n'
        '    quantization.quantize_net(net, calib_data=[toks],\n'
        '                              calib_mode="naive")\n'
        'with tempfile.TemporaryDirectory() as d:\n'
        '    f = os.path.join(d, "m.safetensors")\n'
        '    chip_smoke.write_safetensors(f, {"a": torch.ones(2)})\n'
        '    assert llama.read_safetensors(f)["a"].tolist() == [1.0, 1.0]\n'
        'bad = sorted(n for n in sys.modules\n'
        '             if n.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))\n'
        'print("LOADED", bad)\n')
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == 'LOADED []'
