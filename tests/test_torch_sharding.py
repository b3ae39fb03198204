"""``mx.sharding`` of the port against the JAX package's.

- The rule registry: the six rule cases of ``tests/test_sharding.py``
  against the JAX functions, the resolved spec of every parameter of
  BERT-base, ``resnet50_v1`` and ``llama_tiny`` under every (arch, mode)
  table on a dp 4 x tp 2 mesh (both raise ``UnmatchedParamError`` or both
  give the same spec), ``zero1_spec`` over a set of shapes, the env
  overrides and the three ``MeshGroup`` cases of
  ``tests/test_mesh_elastic.py`` (the port's group maps hosts to ranks).
- ROADMAP C12's witness: the JAX package's ``bert`` tables match no rule
  for five of its own BERT's parameters; the port's copy is value for
  value, and ``bert_partition_rules`` covers them.
- One world of four gloo ranks on the CPU (``parallel.launch.spawn``)
  runs the sharded cases, and the JAX package runs the same on four of
  conftest's virtual CPU devices: the two-layer MLP's FSDP forward (bit
  for bit against the port's one process: no contraction is split; 1e-5
  against XLA's GEMM) and TP forward with that test's
  ``tp_rules`` (1e-5: the row-parallel product sums over ``tp``), two
  FSDP Adam steps (each step's gradient summed over the mesh at 1e-5 and
  ``GRAD_ATOL``, the weights at 1e-5 where Adam's update is well
  conditioned, see ``ADAM_ILL``; ZeRO-1 slots a quarter of a bias a
  rank),
  no new key after warm-up and a new key for a new mesh, eager loss on a
  sharded output (1e-6), ``shard_params`` (and its
  ``UnmatchedParamError``), the tiny BERT at dp 2 x tp 2 through two Adam
  steps against the JAX Trainer under the same mesh (gradients and
  weights as the FSDP steps), ``llama_tiny``'s sharded ``DecodeServer``
  at dp 2 x tp 2 with the JAX ``generate()``'s tokens (the JAX test's
  prompt; the net initialized inside the mesh, each rank keeping its
  shards, and loaded by ``from_jax_params``; its defaults, a scheduler
  thread, and a deadline raise under the mesh), ``tests/test_llama.py``'s
  tensor-parallel forward of ``llama_tiny`` at dp 2 x tp 2 against the
  JAX net's one-device logits (2e-4),
  ``zero1_update_in_axis`` / ``bucketed_allreduce_in_axis`` against
  the JAX forms under ``shard_map`` (1e-6), BatchNorm trained on a split
  batch (1e-5), ``make_sharded_train_step`` against the JAX step (1e-6),
  ``constrain``/``lift_raws``, a value of a sharded weight, and the
  check that raises where a parameter or the batch meets a value made
  whole from that batch.

The rank worker imports nothing of JAX (a ``spawn`` child imports this
module to find it); JAX is imported inside the tests only.
"""

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import sharding as tsh
from mxnet_tpu_torch.parallel import launch
from mxnet_tpu_torch.sharding.rules import PartitionSpec as TP

TOL = dict(rtol=1e-5, atol=1e-5)
RANKS = 4
BERT_TINY = dict(vocab_size=200, num_layers=2, units=32, hidden_size=64,
                 num_heads=4, max_length=32, dropout=0.0,
                 use_classifier=False)
PROMPT = [3, 1, 4, 1, 5]
IN_AXIS_SHAPES = [(17,), (4, 5), (129,), (3, 3)]


#: Adam's update g / (sqrt(v) + eps) turns an absolute gradient error
#: into a relative one: an element whose gradient is nonzero and below
#: this at some step (the small difference of larger terms, which two
#: GEMM orders round apart by ~1e-8) is held to Adam's step bound, not
#: to TOL; a gradient that is exactly 0 (a dead unit, an unused row) is 0
#: in both runs. The gradients themselves are held to GRAD_ATOL first,
#: so that a fault confined to such elements shows there
ADAM_ILL = 1e-6
#: the absolute bound of a gradient element against the JAX package's:
#: TOL's rtol of the tensor's largest element (a sum over the batch's
#: tokens rounds each element to the size of the terms it sums, not of
#: the sum), and at least a tenth of ADAM_ILL (two GEMM orders round a
#: gradient that is rounding noise, such as the key bias's, ~1e-8 apart)
GRAD_ATOL = 1e-7


def _adam_close(got, want, grads, got_grads, lr, name):
    """Weights after ``len(grads)`` Adam steps at ``lr`` against the
    reference's, and each step's gradient (``got_grads``, the port's
    summed over the mesh) against the reference's (``grads``) at TOL's
    rtol and GRAD_ATOL's absolute bound. The weights at TOL wherever
    every step's reference gradient is 0 or at least ADAM_ILL, and within
    the steps' bound (``lr`` a step) where one is not (such as the key
    bias, whose gradient is rounding noise: softmax does not see it).
    Returns those elements' count and the size; the callers hold the
    count under 5 % of all."""
    ill = np.zeros(want.shape, bool)
    for t, (g, mine) in enumerate(zip(grads, got_grads)):
        atol = max(GRAD_ATOL, TOL['rtol'] * float(np.abs(g).max()))
        np.testing.assert_allclose(mine, g, rtol=TOL['rtol'], atol=atol,
                                   err_msg=f'{name} gradient, step {t}')
        ill |= (np.abs(g) < ADAM_ILL) & (g != 0)
    np.testing.assert_allclose(got[~ill], want[~ill], **TOL, err_msg=name)
    assert np.all(np.abs(got[ill] - want[ill]) <= 2 * lr * len(grads)), name
    return int(ill.sum()), ill.size


def _summed_grads(net):
    """Every parameter's gradient as the reference holds it: summed over
    the active mesh's data axis where the parameter is not split on it
    (the Trainer's step sums only its ZeRO-1 tile), and gathered; a
    collective, so every rank calls it."""
    from mxnet_tpu_torch.sharding import _collectives as C
    from mxnet_tpu_torch.sharding.dispatch import gather_tensor
    ctx = tsh.current()
    dp = ctx.data_axis
    out = {}
    for k, p in net.collect_params().items():
        g, lay = p._grad_buffer(), p._layout
        if dp is not None and (lay is None or dp not in lay.axes()):
            g = C.all_reduce(g, ctx.group(dp))
        out[k] = (gather_tensor(g, lay) if lay is not None else g).numpy()
    return out


def _jax_p(spec):
    from jax.sharding import PartitionSpec as P
    return P(*tuple(spec))


def _tp_rules(P):
    return [(lambda name, shape: len(shape) <= 1, P()),
            (r'.*0\.weight', P('tp', None)),
            (r'.*1\.weight', P(None, 'tp')),
            (r'.*', P())]


# ------------------------------------------------------------ registry
def test_first_match_wins():
    from mxnet_tpu.sharding import match_spec
    from jax.sharding import PartitionSpec as P
    rules = [(r'.*\.weight', P('tp', None)), (r'.*', P('dp'))]
    trules = [(r'.*\.weight', TP('tp', None)), (r'.*', TP('dp'))]
    for name, shape in (('encoder.0.weight', (8, 8)),
                        ('encoder.0.bias', (8,))):
        assert tuple(tsh.match_spec(name, shape, trules)) == \
            tuple(match_spec(name, shape, rules))
    assert repr(TP('tp', None)) == repr(P('tp', None))


def test_scalars_replicate_unconditionally():
    from mxnet_tpu.sharding import match_spec
    from jax.sharding import PartitionSpec as P
    assert tuple(tsh.match_spec('temperature', (), [(r'.*', TP('dp'))])) \
        == tuple(match_spec('temperature', (), [(r'.*', P('dp'))])) == ()


def test_unmatched_errors_naming_nearest_rule():
    from mxnet_tpu.sharding import UnmatchedParamError, match_spec
    from jax.sharding import PartitionSpec as P
    with pytest.raises(UnmatchedParamError) as want:
        match_spec('decoder.0.weight', (8, 8),
                   [(r'encoder\..*\.weight', P('tp', None))])
    with pytest.raises(tsh.UnmatchedParamError) as got:
        tsh.match_spec('decoder.0.weight', (8, 8),
                       [(r'encoder\..*\.weight', TP('tp', None))])
    assert str(got.value).replace('PartitionSpec', '') == \
        str(want.value).replace('PartitionSpec', '')
    assert 'encoder' in str(got.value)
    assert tsh.match_spec('decoder.0.weight', (8, 8),
                          [(r'encoder\..*\.weight', TP('tp', None))],
                          on_unmatched='replicate') == TP()


def test_register_custom_arch_table():
    tsh.register_rules('sharding_test_arch', 'tp',
                       [(r'.*proj.*', TP(None, 'tp')), (r'.*', TP())])
    got = tsh.rules_for('sharding_test_arch', 'tp')
    assert got[0][1] == TP(None, 'tp')
    assert 'sharding_test_arch' in tsh.list_archs()
    with pytest.raises(KeyError):
        tsh.rules_for('no_such_arch', 'tp')


def test_resolve_spec_drops_nondividing_axis(monkeypatch):
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.sharding import resolve_spec
    from jax.sharding import PartitionSpec as P
    jmesh = jpar.make_mesh(dp=8)
    tmesh = tsh.ShardingContext({'dp': 8})
    for spec, shape in ((('dp',), (7, 4)), (('tp',), (8, 4)),
                        (('dp',), (8, 4)), (('dp', None), (16, 3))):
        assert tuple(tsh.resolve_spec(TP(*spec), shape, tmesh)) == \
            tuple(resolve_spec(P(*spec), shape, jmesh))
    monkeypatch.setenv('MXNET_SHARDING_STRICT', '1')
    with pytest.raises(ValueError):
        tsh.resolve_spec(TP('dp'), (7, 4), tmesh, name='w')


def test_shard_factor():
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.sharding import shard_factor
    from jax.sharding import PartitionSpec as P
    jmesh = jpar.make_mesh(dp=4, tp=2)
    tmesh = tsh.ShardingContext({'dp': 4, 'tp': 2})
    for spec, shape in ((('dp',), (16, 8)), (('dp', 'tp'), (16, 8)),
                        ((), (16, 8)), (('dp',), (7, 8)),
                        ((('dp', 'tp'),), (16, 8))):
        assert tsh.shard_factor(TP(*spec), shape, tmesh) == \
            shard_factor(P(*spec), shape, jmesh)


@pytest.fixture(scope='module')
def zoo_shapes():
    """``{model: {name: shape}}`` of BERT-base and ``resnet50_v1`` (the
    port's nets, whose names and shapes are the JAX package's:
    ``tests/test_torch_bert.py``, ``tests/test_torch_vision.py``) and the
    JAX package's ``llama_tiny``."""
    import mxnet_tpu as jmx
    from mxnet_tpu.gluon.model_zoo.llama import llama_tiny
    from mxnet_tpu_torch.gluon.model_zoo import bert, vision
    out = {}
    with tmx.cpu():
        b = bert.bert_12_768_12(dropout=0.0)
        b.initialize()
        z = tmx.np.zeros((1, 4), dtype='int32')
        b(z, z)
        out['bert'] = {k: tuple(p.shape)
                       for k, p in b.collect_params().items()}
        r = vision.get_model('resnet50_v1')
        r.initialize()
        r(tmx.np.zeros((1, 3, 32, 32)))
        out['resnet'] = {k: tuple(p.shape)
                         for k, p in r.collect_params().items()}
    ll = llama_tiny()
    ll.initialize()
    ll(jmx.np.zeros((1, 2), dtype='int32'))
    out['llama'] = {k: tuple(p.shape)
                    for k, p in ll.collect_params().items()}
    return out


TABLES = [('llama', 'tp'), ('llama', 'fsdp'), ('resnet', 'tp'),
          ('resnet', 'fsdp'), ('bert', 'tp'), ('bert', 'fsdp'),
          ('generic', 'fsdp')]


@pytest.mark.parametrize('model', ['bert', 'resnet', 'llama'])
@pytest.mark.parametrize('arch,mode', TABLES)
def test_resolved_specs_equal_the_jax_packages(zoo_shapes, model, arch,
                                               mode):
    from mxnet_tpu import parallel as jpar, sharding as jsh
    jmesh = jpar.make_mesh(dp=4, tp=2)
    tmesh = tsh.ShardingContext({'dp': 4, 'tp': 2})
    jrules, trules = jsh.rules_for(arch, mode), tsh.rules_for(arch, mode)
    assert len(jrules) == len(trules)
    for name, shape in zoo_shapes[model].items():
        try:
            want = tuple(jsh.resolve_spec(jsh.match_spec(
                name, shape, jrules), shape, jmesh))
        except jsh.UnmatchedParamError:
            want = 'unmatched'
        try:
            got = tuple(tsh.resolve_spec(tsh.match_spec(
                name, shape, trules), shape, tmesh))
        except tsh.UnmatchedParamError:
            got = 'unmatched'
        assert got == want, (name, shape)


def test_infer_arch_finds_every_family():
    from mxnet_tpu_torch.gluon.model_zoo import bert, vision
    from mxnet_tpu_torch.gluon.model_zoo.llama import LlamaForCausalLM, \
        LlamaConfig
    assert tsh.infer_arch(bert.get_bert_model(**BERT_TINY)) == 'bert'
    assert tsh.infer_arch(vision.get_model('resnet18_v1')) == 'resnet'
    net = LlamaForCausalLM(LlamaConfig(vocab_size=16, units=8, num_layers=1,
                                       num_heads=2, hidden_size=16))
    assert tsh.infer_arch(net) == 'llama'
    assert tsh.infer_arch(net.model) == 'llama'
    assert tsh.infer_arch(tmx.gluon.nn.Dense(2)) == 'generic'


def test_zero1_spec_equals_the_jax_packages():
    from mxnet_tpu import parallel as jpar, sharding as jsh
    from jax.sharding import PartitionSpec as P
    jctx = jsh.ShardingContext(jpar.make_mesh(dp=4, tp=2))
    tctx = tsh.ShardingContext({'dp': 4, 'tp': 2})
    cases = [((), (16,)), ((), (3,)), ((), (6, 8)), (('tp', None), (8, 6)),
             ((None, 'tp'), (6, 8)), (('dp',), (8, 4)), ((), (2, 3, 8)),
             (('tp',), (4, 4)), ((), (1024, 768)), ((None, 'tp'), (3, 4))]
    for spec, shape in cases:
        assert tuple(tctx.zero1_spec(TP(*spec), shape)) == \
            tuple(jctx.zero1_spec(P(*spec), shape)), (spec, shape)


def test_mesh_env_overrides(monkeypatch):
    monkeypatch.setenv('MXNET_SHARDING_DP', '4')
    with tsh.mesh(dp=8) as ctx:
        assert ctx.axis_sizes == {'dp': 4}
        assert tsh.current() is ctx and ctx.mode == 'fsdp'
    monkeypatch.setenv('MXNET_SHARDING_TP', '2')
    with tsh.mesh(dp=8, tp=8) as ctx:
        assert ctx.axis_sizes == {'dp': 4, 'tp': 2} and ctx.mode == 'tp'
    monkeypatch.setenv('MXNET_SHARDING_DISABLE', '1')
    with tsh.mesh(dp=8) as ctx:
        assert ctx is None
        assert tsh.current() is None


def test_fingerprint_same_mesh_equal_new_mesh_differs():
    a = tsh.ShardingContext({'dp': 4})
    b = tsh.ShardingContext({'dp': 4})
    c = tsh.ShardingContext({'dp': 2, 'tp': 2})
    assert a.fingerprint() == b.fingerprint() != c.fingerprint()
    assert a.batch_spec((8, 3)) == TP('dp') and a.batch_spec((7,)) == TP()
    with tsh.use(c):
        assert tsh.batch_spec((8,)) == TP('dp')
    assert tsh.batch_spec((8,)) == TP()


# ---------------------------------------------------- MeshGroup units
def test_mesh_group_topology_and_eject():
    g = tsh.MeshGroup(4, devices=list(range(8)))
    assert g.n_procs == 4 and g.devices_per_proc == 2
    assert g.live == (0, 1, 2, 3) and g.leader == 0
    assert len(g.live_devices()) == 8
    assert g.devices_for(2) == tuple(g.live_devices()[4:6])

    g2 = g.eject(3)
    assert g2.live == (0, 1, 2) and g2.generation == 1
    assert g.live == (0, 1, 2, 3) and g.generation == 0
    assert len(g2.live_devices()) == 6
    assert g2.devices_for(3) == g.devices_for(3)
    g3 = g2.eject(0)
    assert g3.leader == 1 and g3.generation == 2

    d = g2.describe()
    assert d['live'] == [0, 1, 2] and d['generation'] == 1
    assert d['devices_per_proc'] == 2

    with pytest.raises(ValueError):
        tsh.MeshGroup(3, devices=list(range(8)))
    with pytest.raises(ValueError):
        g2.eject(0, 1, 2)


def test_mesh_group_context_over_live_devices():
    g = tsh.MeshGroup(4, devices=list(range(8))).eject(3)
    ctx = g.context()
    assert ctx.n_devices == 6 and ctx.axis_sizes == {'dp': 6}
    assert ctx.ranks == (0, 1, 2, 3, 4, 5)
    ctx2 = g.context(tp=2)
    assert ctx2.axis_sizes == {'dp': 3, 'tp': 2}
    with pytest.raises(ValueError):
        g.context(tp=4)


def test_mesh_group_env_default(monkeypatch):
    monkeypatch.setenv('MXNET_MESH_PROCS', '2')
    g = tsh.MeshGroup(devices=list(range(8)))
    assert g.n_procs == 2 and g.devices_per_proc == 4


# ------------------------------------------------- C12 (JAX package)
C12_NAMES = {'tp': {'decoder_bias', 'encoder.cell0.attention.qkv.weight',
                    'pooler.weight', 'decoder_transform.weight',
                    'classifier.weight'},
             'fsdp': {'decoder_bias'}}


@pytest.mark.parametrize('mode', ['tp', 'fsdp'])
def test_c12_bert_tables_miss_bert_parameters(mode):
    """ROADMAP C12: the JAX package's own ``bert`` tables raise
    ``UnmatchedParamError`` on parameters of its own BERT, so that
    ``mx.sharding.mesh(...)`` over a BERT needs an explicit table; the
    port's copy raises on the same names, and ``bert_partition_rules``
    matches every one."""
    import mxnet_tpu as jmx
    from mxnet_tpu import sharding as jsh
    from mxnet_tpu.gluon.model_zoo import bert as jbert
    from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
    net = jbert.get_bert_model('bert_12_768_12', num_layers=1,
                               dropout=0.0)
    net.initialize()
    z = jmx.np.zeros((1, 4), dtype='int32')
    net(z, z)
    shapes = {k: tuple(p.shape) for k, p in net.collect_params().items()}
    missed = set()
    for name, shape in shapes.items():
        try:
            jsh.match_spec(name, shape, jsh.rules_for('bert', mode))
        except jsh.UnmatchedParamError:
            missed.add(name)
            with pytest.raises(tsh.UnmatchedParamError):
                tsh.match_spec(name, shape, tsh.rules_for('bert', mode))
        tsh.match_spec(name, shape, tbert.bert_partition_rules(mode))
    print(f'\nC12: the JAX bert:{mode} table misses {sorted(missed)}')
    assert missed == C12_NAMES[mode]


# ------------------------------------------------------ the rank world
def _port_mlp(weights):
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation='relu', in_units=64),
            nn.Dense(16, in_units=32))
    net.initialize(ctx=tmx.cpu())
    for k, p in net.collect_params().items():
        p.set_data(weights[k])
    net.hybridize()
    return net


def _mlp_cases(mx, inp, rank):
    from mxnet_tpu_torch import autograd, gluon, parallel
    out = {}
    x = mx.np.array(inp['x'])
    net = _port_mlp(inp['mlp'])
    with mx.sharding.mesh(dp=RANKS):
        got = net(x)
        w = net[0].weight
        out['fsdp_local'] = tuple(w._var.shape)
        out['fsdp_spec'] = tuple(w._sharding_spec)
        out['fsdp'] = got.asnumpy()
    with mx.sharding.mesh(tp=RANKS, rules=_tp_rules(TP)):
        out['tp'] = net(x).asnumpy()
        out['tp_local'] = (tuple(net[0].weight._var.shape),
                           tuple(net[1].weight._var.shape))
    out['after'] = net(x).asnumpy()      # outside: gathered back
    # two FSDP Adam steps
    net = _port_mlp(inp['mlp2'])
    tr = gluon.Trainer(net.collect_params(), 'adam',
                       {'learning_rate': 0.05})
    out['grads'] = []
    with mx.sharding.mesh(dp=RANKS):
        for a, b in zip(inp['xs'], inp['ys']):
            a, b = mx.np.array(a), mx.np.array(b)
            with autograd.record():
                loss = ((net(a) - b) ** 2).mean()
            loss.backward()
            out['grads'].append(_summed_grads(net))
            tr.step(a.shape[0])
        out['trained'] = {k: p.data().asnumpy()
                          for k, p in net.collect_params().items()}
    bias = [(i, p) for i, p in enumerate(tr._params) if len(p.shape) == 1]
    out['slots'] = [(int(p.shape[0]), [int(t.numel()) for t in
                                       tr._states[i]]) for i, p in bias]
    # keys: warm on one mesh, a new key on another
    net = _port_mlp(inp['mlp'])
    with mx.sharding.mesh(dp=RANKS):
        net(x)
        net(x)
        warm = net.compile_count
        for _ in range(3):
            net(x)
        out['keys'] = (warm, net.compile_count)
    with mx.sharding.mesh(dp=2, tp=2, mode='fsdp'):
        net(x)
        net(x)
        out['keys_new_mesh'] = net.compile_count
    out['eager_calls'] = net.eager_call_count
    # eager loss on a sharded output, with a fresh label
    with mx.sharding.mesh(dp=RANKS):
        o = net(x)
        label = mx.np.array(inp['label'])
        out['eager_loss'] = float(((o - label) ** 2).mean().asnumpy())
    with mx.sharding.mesh(dp=RANKS):
        c = mx.sharding.constrain(x)
        lifted = mx.sharding.lift_raws([c, mx.np.array(inp['x'])])
        out['constrain'] = (c.shape, tuple(c._data.shape),
                            tuple(c._layout.pspec()),
                            tuple(lifted[1]._data.shape), c.asnumpy())
    # a parameter after a gather of the batch raises while recording
    with mx.sharding.mesh(dp=RANKS):
        with autograd.record():
            o = net(x)
            whole = o.T                   # gathers the batch
            try:
                mx.np.dot(whole, net[1].weight.data())
                out['whole'] = None
            except mx.MXNetError as e:
                out['whole'] = str(e)
            out['whole_loss'] = float((whole * 2).sum().asnumpy())
            try:
                o - o.mean(axis=0)        # the batch's own mean: raises
                out['centred'] = None
            except mx.MXNetError as e:
                out['centred'] = str(e)
    # shard_params
    mesh = parallel.make_mesh(tp=RANKS)
    rules = [(r'.*\.weight', TP('tp', None)), (r'.*', TP())]
    placed = parallel.shard_params(
        {'a.weight': mx.np.array(inp['a_w']), 'a.bias': mx.np.array(
            inp['a_b'])}, mesh, rules=rules)
    out['placed'] = (tuple(placed['a.weight']._layout.pspec()),
                     placed['a.bias']._layout, placed['a.weight'].shape,
                     tuple(placed['a.weight']._data.shape),
                     placed['a.weight'].asnumpy())
    try:
        parallel.shard_params({'x': mx.np.array(inp['a_w'])}, mesh,
                              rules=[(r'nomatch', TP())],
                              on_unmatched='error')
        out['unmatched'] = None
    except tsh.UnmatchedParamError as e:
        out['unmatched'] = str(e)
    return out


def _bert_case(mx, inp):
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo import bert
    net = bert.get_bert_model('bert_12_768_12', **BERT_TINY)
    net.initialize(ctx=mx.cpu())
    ids, tt, labels = (mx.np.array(inp['bert'][k])
                       for k in ('ids', 'tt', 'labels'))
    net(ids, tt)
    net.load_dict(inp['bert_w'])
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), 'adam', {'learning_rate': 1e-3})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses, grads = [], []
    with mx.sharding.mesh(dp=2, tp=2, rules=bert.bert_partition_rules()):
        for _ in range(2):
            with autograd.record():
                _, _, mlm = net(ids, tt)
                loss = loss_fn(mlm, labels).sum()
            loss.backward()
            grads.append(_summed_grads(net))
            tr.step(ids.shape[0])
            losses.append(float(loss.asnumpy()))
        qkv = net.encoder.cells[0].attention.qkv.weight
        local = tuple(qkv._var.shape)
        weights = {k: p.data().asnumpy()
                   for k, p in net.collect_params().items()}
    return {'losses': losses, 'weights': weights, 'qkv_local': local,
            'grads': grads}


def _decode_case(mx, inp):
    from mxnet_tpu_torch.gluon.model_zoo.llama import from_jax_params, \
        llama_tiny
    from mxnet_tpu_torch.serve import DecodeServer, ServeError
    refused = []
    with mx.sharding.mesh(dp=2, tp=2):
        net = llama_tiny()
        net.initialize()
        # the defaults start a scheduler thread, whose wake-ups would
        # order the ranks' collectives apart; a deadline reads each
        # rank's own clock: both are refused under the mesh
        for kw in ({}, {'start': False, 'deadline_ms': 50.0}):
            try:
                DecodeServer(net, **kw)
                refused.append(None)
            except ServeError as e:
                refused.append(str(e))

        from_jax_params(net, inp['llama_w'])
        ds = DecodeServer(net, slots=2, max_length=32, page_size=4,
                          num_pages=66, prefill_chunk=8, start=False)
        k0 = tuple(ds._pool[0][0].shape)
        try:
            ds.submit(PROMPT, max_new_tokens=6, deadline_ms=50.0)
            refused.append(None)
        except ServeError as e:
            refused.append(str(e))
        f = ds.submit(PROMPT, max_new_tokens=6)
        for _ in range(12):
            if f.done():
                break
            ds.step_once()
        got = f.result(1)
        st = ds.stats()
        rep = ds.audit_donation()
        heads = net.model.layers[0].self_attn._heads()
        ds.close()
    return {'tokens': got, 'pool': k0, 'spec': tuple(ds.pool_spec),
            'recompiles': st['recompiles'], 'audit': dict(rep.stats),
            'heads': heads, 'refused': refused}


def _llama_tp_case(mx, inp):
    """``llama_tiny`` built and loaded inside ``mesh(dp=2, tp=2)``, each
    rank holding its shards from the start, then one hybridized forward:
    the batch split on ``dp``, the heads on ``tp``."""
    from mxnet_tpu_torch.gluon.model_zoo.llama import from_jax_params, \
        llama_tiny
    with mx.sharding.mesh(dp=2, tp=2):
        net = from_jax_params(llama_tiny(), inp['llama_w'])
        params = net.collect_params()
        local = {k: tuple(params[k]._var.shape) for k in (
            'model.layers0.self_attn.q_proj.weight',
            'model.layers0.self_attn.o_proj.weight',
            'model.embed_tokens.weight', 'model.norm.weight')}
        net.hybridize()
        logits = net(mx.np.array(inp['llama_toks'])).asnumpy()
    return {'logits': logits, 'local': local}


def _in_axis_case(mx, inp, rank):
    from mxnet_tpu_torch.kvstore import fusion
    from mxnet_tpu_torch.ops.optimizer_ops import sgd_mom_update
    with mx.sharding.mesh(dp=RANKS):
        grads = [torch.from_numpy(g[rank]) for g in inp['grads']]
        weights = [torch.from_numpy(w) for w in inp['weights']]
        sizes = [int(np.prod(s)) for s in IN_AXIS_SHAPES]
        _, _, lmax, _ = fusion.zero1_layout(sizes, RANKS)

        def upd(w, g, m):
            return sgd_mom_update(w, g, m, lr=0.1, momentum=0.9)
        new_ws, new_m = fusion.zero1_update_in_axis(
            grads, weights, torch.zeros(lmax), 'dp', RANKS, upd)
        summed = fusion.bucketed_allreduce_in_axis(
            [torch.from_numpy(v[rank]) for v in inp['bucket_vals']], 'dp',
            limit=256)
    return {'zero1': [w.numpy() for w in new_ws], 'mom': new_m.numpy(),
            'buckets': [s.numpy() for s in summed]}


def _param_value_case(mx, inp):
    """The gradient of a weight used through a value of it (``w * 2``)
    under ``mesh(dp=4)``, gathered, and in one process."""
    import contextlib
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.sharding.dispatch import gather_tensor

    class Scaled(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.d = nn.Dense(8, in_units=64)

        def forward(self, x):
            return mx.np.dot(x, (self.d.weight.data() * 2).T)

    x = mx.np.array(inp['x'])
    grads = []
    for axes in (None, {'dp': RANKS}):
        mx.random.seed(0)
        net = Scaled()
        net.initialize()
        net.hybridize()
        net(x)
        with mx.sharding.mesh(**axes) if axes else \
                contextlib.nullcontext():
            with autograd.record():
                loss = (net(x) ** 2).sum()
            loss.backward()
            p = net.d.weight
            g = p._grad_buffer()
            grads.append((gather_tensor(g, p._layout) if p._layout
                          else g).numpy())
    return grads


def _port_bn(mx, weights):
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=64), nn.BatchNorm(in_channels=16),
            nn.Dense(4, in_units=16))
    net.initialize(ctx=mx.cpu())
    for k, p in net.collect_params().items():
        p.set_data(weights[k])
    net.hybridize()
    return net


def _bn_case(mx, inp):
    """A Dense-BatchNorm-Dense net, one SGD step in train mode under
    ``mesh(dp=4)``: the batch statistics over every rank's rows."""
    from mxnet_tpu_torch import autograd, gluon
    net = _port_bn(mx, inp['bn_w'])
    tr = gluon.Trainer(net.collect_params(), 'sgd', {'learning_rate': 0.1})
    x, y = mx.np.array(inp['x']), mx.np.array(inp['bn_y'])
    with mx.sharding.mesh(dp=RANKS):
        with autograd.record():
            out = net(x)
            loss = ((out - y) ** 2).mean()
        loss.backward()
        tr.step(1)
        return {'out': out.asnumpy(), 'loss': float(loss.asnumpy()),
                'weights': {k: p.data().asnumpy()
                            for k, p in net.collect_params().items()}}


def _step_case(mx, inp, rank):
    """``make_sharded_train_step`` on this rank's quarter of the batch,
    ``cross_replica_mean`` and ``replicate``."""
    from mxnet_tpu_torch import parallel
    mesh = parallel.make_mesh(dp=RANKS)

    def loss_fn(p, batch):
        x, y = batch
        return ((x @ p['w'] + p['b'] - y) ** 2).mean()

    def sgd(p, g, state, lr):
        return {k: p[k] - lr * g[k] for k in p}, state
    step = parallel.make_sharded_train_step(loss_fn, sgd, mesh)
    rows = slice(rank * 4, (rank + 1) * 4)
    params = {k: torch.from_numpy(v) for k, v in inp['lin'].items()}
    batch = (torch.from_numpy(inp['lin_x'][rows]),
             torch.from_numpy(inp['lin_y'][rows]))
    losses = []
    for _ in range(2):
        params, _, loss = step(params, None, batch, 0.1)
        losses.append(float(loss))
    with mx.sharding.mesh(dp=RANKS):
        mean = parallel.sharded.cross_replica_mean(
            torch.tensor([float(rank)]))
    rep = parallel.replicate({'a': mx.np.array(inp['a_b'])}, mesh)
    return {'params': {k: v.numpy() for k, v in params.items()},
            'losses': losses, 'mean': float(mean),
            'rep': rep['a'].asnumpy()}


def _world(inp):
    """Every sharded case in one world of ``RANKS`` gloo ranks."""
    import torch.distributed as dist
    torch.set_num_threads(1)    # four ranks beside the other test workers
    with tmx.cpu():
        rank = dist.get_rank()
        out = {'mlp': _mlp_cases(tmx, inp, rank),
               'step': _step_case(tmx, inp, rank),
               'param_value': _param_value_case(tmx, inp),
               'bn': _bn_case(tmx, inp),
               'bert': _bert_case(tmx, inp),
               'decode': _decode_case(tmx, inp),
               'llama_tp': _llama_tp_case(tmx, inp),
               'in_axis': _in_axis_case(tmx, inp, rank)}
    return out


def _inputs():
    rng = np.random.default_rng(21)

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)
    inp = {'x': rng.random((16, 64), dtype=np.float32),
           'xs': [rng.random((16, 64), dtype=np.float32) for _ in range(2)],
           'ys': [rng.random((16, 16), dtype=np.float32) for _ in range(2)],
           'label': rng.random((16, 16), dtype=np.float32),
           'a_w': f(16, 8), 'a_b': f(16),
           'grads': [f(RANKS, *s) for s in IN_AXIS_SHAPES],
           'weights': [f(*s) for s in IN_AXIS_SHAPES],
           'bucket_vals': [f(RANKS, *s) for s in [(33,), (5, 7), (128,),
                                                  (2, 3, 4), (513,)]],
           'bn_w': {'0.weight': f(16, 64) * 0.1, '0.bias': f(16) * 0.1,
                    '1.gamma': 1 + 0.1 * f(16), '1.beta': 0.1 * f(16),
                    '1.running_mean': np.zeros(16, np.float32),
                    '1.running_var': np.ones(16, np.float32),
                    '2.weight': f(4, 16) * 0.3, '2.bias': f(4) * 0.1},
           'bn_y': f(16, 4),
           'lin': {'w': f(8, 3), 'b': f(3)}, 'lin_x': f(16, 8),
           'lin_y': f(16, 3),
           'llama_toks': rng.integers(0, 256, (2, 8)).astype(np.int32),
           'bert': {'ids': rng.integers(0, 200, (8, 12)).astype(np.int32),
                    'tt': np.zeros((8, 12), np.int32),
                    'labels': rng.integers(0, 200, (8, 12)).astype(
                        np.int32)}}
    for key in ('mlp', 'mlp2'):
        inp[key] = {'0.weight': f(32, 64) * 0.1, '0.bias': f(32) * 0.1,
                    '1.weight': f(16, 32) * 0.1, '1.bias': f(16) * 0.1}
    return inp


def _jax_mlp(jmx, weights):
    from mxnet_tpu.gluon import nn
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation='relu', in_units=64),
            nn.Dense(16, in_units=32))
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(jmx.np.array(weights[k]))
    net.hybridize()
    return net


@pytest.fixture(scope='module')
def world():
    """The JAX package's weights and oracles, and the port's four ranks'
    results on the same inputs."""
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu.gluon.model_zoo import bert as jbert
    from mxnet_tpu.gluon.model_zoo.llama import llama_tiny
    inp = _inputs()
    jb = jbert.get_bert_model('bert_12_768_12', **BERT_TINY)
    jb.initialize()
    z = np.zeros((1, 12), np.int32)
    jb(jmx.np.array(z), jmx.np.array(z))
    inp['bert_w'] = {k: p.data().asnumpy()
                     for k, p in jb.collect_params().items()}
    jl = llama_tiny()
    jl.initialize()
    jl(jmx.np.zeros((1, 2), dtype='int32'))
    inp['llama_w'] = {k: p.data().asnumpy()
                      for k, p in jl.collect_params().items()}
    want = jl.generate(jmx.np.array([PROMPT]), max_new_tokens=6)
    oracle = {'tokens': [int(t) for t in
                         want.asnumpy()[0, len(PROMPT):]],
              'llama_logits': jl(jmx.np.array(inp['llama_toks'])).asnumpy(),
              'devices': jax.devices()[:RANKS]}
    ranks = launch.spawn(_world, RANKS, inp, timeout=240)
    return inp, oracle, ranks


def test_fsdp_forward_bit_equal(world):
    import mxnet_tpu as jmx
    from mxnet_tpu import sharding as jsh
    inp, oracle, ranks = world
    net = _jax_mlp(jmx, inp['mlp'])
    x = jmx.np.array(inp['x'])
    ref = net(x).asnumpy()
    with jsh.mesh(dp=RANKS, devices=oracle['devices']):
        want = net(x).asnumpy()
    # (XLA's own sharded forward differs from its one-device one in the
    # last bit here, at 4 rows a device: its GEMM blocks by rows too)
    np.testing.assert_allclose(want, ref, rtol=1e-6, atol=1e-6)
    for r in ranks:
        # bit for bit against the port's one process (the gathered net
        # after the mesh); against JAX at 1e-5, since torch's CPU GEMM
        # and XLA's round differently whatever the sharding
        np.testing.assert_array_equal(r['mlp']['fsdp'], r['mlp']['after'])
        np.testing.assert_allclose(r['mlp']['fsdp'], want, **TOL)
        assert r['mlp']['fsdp_spec'] == ('dp',)
        assert r['mlp']['fsdp_local'] == (32 // RANKS, 64)


def test_tp_forward_allclose(world):
    import mxnet_tpu as jmx
    from mxnet_tpu import sharding as jsh
    from jax.sharding import PartitionSpec as P
    inp, oracle, ranks = world
    net = _jax_mlp(jmx, inp['mlp'])
    x = jmx.np.array(inp['x'])
    with jsh.mesh(tp=RANKS, rules=_tp_rules(P), devices=oracle['devices']):
        want = net(x).asnumpy()
    for r in ranks:
        np.testing.assert_allclose(r['mlp']['tp'], want, **TOL)
        assert r['mlp']['tp_local'] == ((32 // RANKS, 64),
                                        (16, 32 // RANKS))


def test_fsdp_adam_steps_and_zero1_slots(world):
    import mxnet_tpu as jmx
    from mxnet_tpu import autograd, gluon, sharding as jsh
    inp, oracle, ranks = world
    net = _jax_mlp(jmx, inp['mlp2'])
    tr = gluon.Trainer(net.collect_params(), 'adam',
                       {'learning_rate': 0.05})
    grads = []
    with jsh.mesh(dp=RANKS, devices=oracle['devices']):
        for a, b in zip(inp['xs'], inp['ys']):
            a, b = jmx.np.array(a), jmx.np.array(b)
            with autograd.record():
                loss = ((net(a) - b) ** 2).mean()
            loss.backward()
            grads.append({k: p.grad().asnumpy()
                          for k, p in net.collect_params().items()})
            tr.step(a.shape[0])
    want = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    for r in ranks:
        counts = [_adam_close(r['mlp']['trained'][k], w,
                              [g[k] for g in grads],
                              [g[k] for g in r['mlp']['grads']], 0.05, k)
                  for k, w in want.items()]
        print('fsdp mlp: under ADAM_ILL', sum(c for c, _ in counts), 'of',
              sum(n for _, n in counts))
        assert sum(c for c, _ in counts) < 0.05 * sum(n for _, n in counts)
        # ZeRO-1: a bias (replicated by the fsdp rules) holds a quarter
        # of its slots a rank
        for n, slots in r['mlp']['slots']:
            assert slots == [n // RANKS] * 2, (n, slots)


def test_no_new_key_after_warmup_and_new_mesh_new_key(world):
    _, _, ranks = world
    for r in ranks:
        warm, after = r['mlp']['keys']
        assert warm == after == 1
        assert r['mlp']['keys_new_mesh'] == 2
        assert r['mlp']['eager_calls'] >= 7


def test_eager_loss_on_a_sharded_output(world):
    import mxnet_tpu as jmx
    from mxnet_tpu import sharding as jsh
    inp, oracle, ranks = world
    net = _jax_mlp(jmx, inp['mlp'])
    x = jmx.np.array(inp['x'])
    with jsh.mesh(dp=RANKS, devices=oracle['devices']):
        out = net(x)
        label = jmx.np.array(inp['label'])
        want = float(((out - label) ** 2).mean().asnumpy())
    for r in ranks:
        assert np.isfinite(r['mlp']['eager_loss'])
        np.testing.assert_allclose(r['mlp']['eager_loss'], want,
                                   rtol=1e-6)


def test_shard_params_and_unmatched(world):
    from mxnet_tpu import parallel as jpar
    from jax.sharding import PartitionSpec as P
    import mxnet_tpu as jmx
    inp, _, ranks = world
    mesh = jpar.make_mesh(tp=RANKS)
    placed = jpar.shard_params(
        {'a.weight': jmx.np.array(inp['a_w']),
         'a.bias': jmx.np.array(inp['a_b'])}, mesh,
        rules=[(r'.*\.weight', P('tp', None)), (r'.*', P())])
    for r in ranks:
        spec, bias_layout, gshape, local, full = r['mlp']['placed']
        assert spec == tuple(placed['a.weight'].sharding.spec) == \
            ('tp',)
        assert bias_layout is None
        assert gshape == (16, 8) and local == (16 // RANKS, 8)
        np.testing.assert_array_equal(full, inp['a_w'])
        assert r['mlp']['unmatched'] is not None and \
            'nomatch' in r['mlp']['unmatched']


def test_tiny_bert_dp2_tp2_trains_as_the_jax_trainer(world):
    import mxnet_tpu as jmx
    from mxnet_tpu import autograd, gluon, sharding as jsh
    from mxnet_tpu.gluon.model_zoo import bert as jbert
    from mxnet_tpu_torch.gluon.model_zoo import bert as tbert
    inp, oracle, ranks = world
    net = jbert.get_bert_model('bert_12_768_12', **BERT_TINY)
    net.initialize()
    ids, tt, labels = (jmx.np.array(inp['bert'][k])
                       for k in ('ids', 'tt', 'labels'))
    net(ids, tt)
    for k, p in net.collect_params().items():
        p.set_data(jmx.np.array(inp['bert_w'][k]))
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), 'adam', {'learning_rate': 1e-3})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rules = [(pat, _jax_p(spec))
             for pat, spec in tbert.bert_partition_rules()]
    losses, grads = [], []
    with jsh.mesh(dp=2, tp=2, rules=rules, devices=oracle['devices']):
        for _ in range(2):
            with autograd.record():
                _, _, mlm = net(ids, tt)
                loss = loss_fn(mlm, labels).sum()
            loss.backward()
            grads.append({k: p.grad().asnumpy()
                          for k, p in net.collect_params().items()})
            tr.step(ids.shape[0])
            losses.append(float(loss.asnumpy()))
    want = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    for r in ranks:
        got = r['bert']
        np.testing.assert_allclose(got['losses'], losses, **TOL)
        counts = [_adam_close(got['weights'][k], w, [g[k] for g in grads],
                              [g[k] for g in got['grads']], 1e-3, k)
                  for k, w in want.items()]
        print('tiny bert dp2 x tp2: under ADAM_ILL',
              sum(c for c, _ in counts), 'of', sum(n for _, n in counts))
        assert sum(c for c, _ in counts) < 0.05 * sum(n for _, n in counts)
        # each rank holds its heads of Q, K and V: a half of qkv's rows
        assert got['qkv_local'] == (3 * 32 // 2, 32)


def test_llama_sharded_decode_dp2_tp2_token_parity(world):
    _, oracle, ranks = world
    for r in ranks:
        d = r['decode']
        assert d['tokens'] == oracle['tokens']
        assert d['spec'] == ('dp', None, 'tp')
        # 66 pages split on dp, llama_tiny's 2 KV heads on tp
        assert d['pool'] == (33, 4, 1, 16)
        assert d['heads'] == (2, 1)
        assert d['recompiles'] == 0
        assert d['audit']['aliased_args'] == d['audit']['donated_args'] \
            == 4
        thread, deadline, submit_deadline = d['refused']
        assert thread is not None and 'step_once' in thread
        assert deadline is not None and 'deadline' in deadline
        assert submit_deadline is not None and 'deadline' in submit_deadline


def test_tp_sharded_forward_matches_single_device(world):
    """tests/test_llama.py's tensor-parallel forward: the port's
    ``llama_tiny`` under ``mesh(dp=2, tp=2)`` (Megatron's layout: q and the
    embedding split on their rows, o on its columns, the norms whole), the
    logits gathered, against the JAX net's one-device forward."""
    _, oracle, ranks = world
    for r in ranks:
        t = r['llama_tp']
        assert t['local'] == {
            'model.layers0.self_attn.q_proj.weight': (32, 64),
            'model.layers0.self_attn.o_proj.weight': (64, 32),
            'model.embed_tokens.weight': (128, 64),
            'model.norm.weight': (64,)}
        np.testing.assert_allclose(t['logits'], oracle['llama_logits'],
                                   rtol=2e-4, atol=2e-4)


def test_in_axis_forms_equal_the_jax_shard_map_forms(world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from mxnet_tpu.kvstore import fusion
    from mxnet_tpu.ops.optimizer_ops import sgd_mom_update
    inp, oracle, ranks = world
    mesh = Mesh(np.array(oracle['devices']), ('dp',))
    sizes = [int(np.prod(s)) for s in IN_AXIS_SHAPES]
    _, _, lmax, _ = fusion.zero1_layout(sizes, RANKS)

    def upd(w, g, m):
        return sgd_mom_update(w, g, m, lr=0.1, momentum=0.9)

    def f(ws, gs, mom_tile):
        new_ws, new_m = fusion.zero1_update_in_axis(
            list(g[0] for g in gs), list(ws), mom_tile, 'dp', RANKS, upd)
        return tuple(new_ws), new_m

    sm = fusion._shard_map(mesh=mesh, in_specs=(P(), P('dp'), P('dp')),
                           out_specs=(P(), P('dp')))(f)
    new_ws, new_m = jax.jit(sm)(
        tuple(jnp.asarray(w) for w in inp['weights']),
        tuple(jnp.asarray(g) for g in inp['grads']),
        jnp.zeros((RANKS * lmax,), jnp.float32))
    new_m = np.asarray(new_m).reshape(RANKS, lmax)

    def g(xs):
        return tuple(fusion.bucketed_allreduce_in_axis(
            [x[0] for x in xs], 'dp', limit=256))
    sb = fusion._shard_map(mesh=mesh, in_specs=P('dp'), out_specs=P())(g)
    sums = jax.jit(sb)(tuple(jnp.asarray(v) for v in inp['bucket_vals']))
    for i, r in enumerate(ranks):
        got = r['in_axis']
        for a, b in zip(got['zero1'], new_ws):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_allclose(got['mom'], new_m[i], rtol=1e-6,
                                   atol=1e-6)
        for a, b in zip(got['buckets'], sums):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-6)


def test_make_sharded_train_step_equals_the_jax_step(world):
    """Two SGD steps of a linear model: each rank on its quarter of the
    batch, gradients meaned over dp, against the JAX step over the whole
    batch (1e-6); ``cross_replica_mean`` and ``replicate``."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu import parallel as jpar
    inp, _, ranks = world

    def loss_fn(p, batch):
        x, y = batch
        return jnp.mean((x @ p['w'] + p['b'] - y) ** 2)

    def sgd(p, g, state, lr):
        return jax.tree.map(lambda a, b: a - lr * b, p, g), state
    mesh = jpar.make_mesh(dp=RANKS)
    step = jpar.make_sharded_train_step(loss_fn, sgd, mesh,
                                        donate_params=False)
    params = {k: jnp.asarray(v) for k, v in inp['lin'].items()}
    batch = (jnp.asarray(inp['lin_x']), jnp.asarray(inp['lin_y']))
    losses = []
    for _ in range(2):
        params, _, loss = step(params, None, batch, 0.1)
        losses.append(float(loss))
    for r in ranks:
        got = r['step']
        for k, v in params.items():
            np.testing.assert_allclose(got['params'][k], np.asarray(v),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got['losses'], losses, rtol=1e-6)
        assert got['mean'] == sum(range(RANKS)) / RANKS
        np.testing.assert_array_equal(got['rep'], inp['a_b'])


def test_constrain_and_lift_raws(world):
    """``constrain`` lays an unsharded batch out at the batch spec (this
    rank's rows, the global shape kept) and ``lift_raws`` cuts a fresh
    array of a sharded peer's shape alike."""
    inp, _, ranks = world
    for r in ranks:
        gshape, local, spec, lifted, full = r['mlp']['constrain']
        assert gshape == (16, 64) and local == (16 // RANKS, 64)
        assert spec == ('dp',) and lifted == local
        np.testing.assert_array_equal(full, inp['x'])


def test_a_parameter_after_a_gathered_batch_raises(world):
    """Under ``mesh(dp=4)`` and ``autograd.record()``, a transpose of the
    batch gathers it whole; ops on that value run, but a parameter meeting
    it raises (its gradient would count every dp rank), as does the batch
    meeting its own mean over dp (each rank would miss the others'
    gradient through the mean)."""
    _, _, ranks = world
    for r in ranks:
        assert r['mlp']['whole'] is not None and 'dp' in r['mlp']['whole']
        assert np.isfinite(r['mlp']['whole_loss'])
        assert r['mlp']['centred'] is not None


def test_a_value_of_a_sharded_weight_keeps_its_gradient(world):
    """``w * 2`` of a weight split on dp stays a parameter's value: its
    gather sums the gradient over dp, which then equals one process's
    (1e-5, the sum's order)."""
    _, _, ranks = world
    for r in ranks:
        one, sharded = r['param_value']
        np.testing.assert_allclose(sharded, one, rtol=1e-5, atol=1e-5)


def test_batchnorm_trains_on_a_split_batch_as_the_jax_package(world):
    """BatchNorm in train mode under ``mesh(dp=4)``: the statistics of the
    whole batch from the rows each rank holds, one SGD step (output,
    loss, weights and running statistics) against the JAX package under
    the same mesh at 1e-5."""
    import mxnet_tpu as jmx
    from mxnet_tpu import autograd, gluon, sharding as jsh
    from mxnet_tpu.gluon import nn
    inp, oracle, ranks = world
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=64), nn.BatchNorm(in_channels=16),
            nn.Dense(4, in_units=16))
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(jmx.np.array(inp['bn_w'][k]))
    net.hybridize()
    tr = gluon.Trainer(net.collect_params(), 'sgd', {'learning_rate': 0.1})
    x, y = jmx.np.array(inp['x']), jmx.np.array(inp['bn_y'])
    with jsh.mesh(dp=RANKS, devices=oracle['devices']):
        with autograd.record():
            out = net(x)
            loss = ((out - y) ** 2).mean()
        loss.backward()
        tr.step(1)
    want = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    for r in ranks:
        got = r['bn']
        np.testing.assert_allclose(got['out'], out.asnumpy(), **TOL)
        np.testing.assert_allclose(got['loss'], float(loss.asnumpy()),
                                   rtol=1e-5)
        for k, w in want.items():
            np.testing.assert_allclose(got['weights'][k], w, **TOL,
                                       err_msg=k)
