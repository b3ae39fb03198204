"""The PyTorch port's ``DecodeServer`` against the JAX package's.

Both servers run ``llama_tiny`` with the same weights (numpy, from a seed,
carried across by ``from_jax_params``), with ``slots=2, max_length=32,
page_size=4, prefill_chunk=8``, and are driven by ``step_once`` with no
scheduler thread. Three prompts over two slots make one slot retire and
take the third request, and the third repeats the first prompt's full
first chunk, so it is served from the prefix cache. The greedy tokens
must be identical and the scheduler's counts equal.
"""

import numpy as onp
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import llama as jax_llama
from mxnet_tpu.serve import DecodeServer as JaxDecodeServer

from mxnet_tpu_torch import cpu, serve
from mxnet_tpu_torch.gluon.model_zoo import llama as torch_llama
from mxnet_tpu_torch.serve import DecodeServer

SERVER = dict(slots=2, max_length=32, page_size=4, prefill_chunk=8,
              start=False)


def _nets(seed=0):
    jnet = jax_llama.llama_tiny()
    jnet.initialize()
    jnet(mx.np.zeros((1, 2)))
    rng = onp.random.default_rng(seed)
    params = {}
    for name, p in jnet.collect_params().items():
        w = rng.standard_normal(p.shape).astype(onp.float32) * 0.1
        params[name] = w + 1.0 if name.endswith('norm.weight') else w
        p.set_data(params[name])
    tnet = torch_llama.from_jax_params(torch_llama.llama_tiny(), params,
                                       ctx=cpu())
    return jnet, tnet


def _serve(server, requests):
    futs = [server.submit(p, n) for p, n in requests]
    for _ in range(200):
        if all(f.done() for f in futs):
            break
        server.step_once()
    out = [f.result(timeout=0) for f in futs]
    stats = server.stats()
    server.close()
    return out, stats


def test_decode_server_tokens_match_the_reference():
    rng = onp.random.default_rng(1)
    shared = rng.integers(1, 256, 8).tolist()          # one full chunk
    requests = [(shared + rng.integers(1, 256, 5).tolist(), 6),
                (rng.integers(1, 256, 3).tolist(), 4),
                (shared + rng.integers(1, 256, 2).tolist(), 5)]
    jnet, tnet = _nets()
    want, jstats = _serve(JaxDecodeServer(jnet, **SERVER), requests)
    got, tstats = _serve(DecodeServer(tnet, **SERVER), requests)
    assert [len(t) for t in got] == [6, 4, 5]
    assert got == want
    for key in ('completed', 'prefix_hit', 'prefix_miss', 'prefill_chunks',
                'steps', 'pages_in_use'):
        assert tstats[key] == jstats[key], key
    assert tstats['prefix_hit'] >= 1
    assert tstats['compile_count'] == tstats['recompiles'] == 0
    assert set(tstats) == set(jstats)


def test_decode_server_runs_on_the_device_of_the_net():
    _, tnet = _nets()
    ds = DecodeServer(tnet, **SERVER)
    assert ds.device == torch.device('cpu')
    assert all(k.device.type == 'cpu' for k, _ in ds._pool)
    assert ds._pool[0][0].shape == (ds.stats()['pages_total'], 4, 2, 16)
    assert ds._metrics_name in serve.stats()
    ds.close()
    assert ds._metrics_name not in serve.stats()
