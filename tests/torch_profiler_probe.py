"""Does ``torch.profiler`` lose kernel events on the card? (ROADMAP C5)

    python3 tests/torch_profiler_probe.py       # on a machine with a card

A script, not a test (pytest does not collect it): each case counts the
port's kernel events in a ``torch.profiler`` session, named as
``chip_smoke.kernel_events`` names them, against the launch counters'
change over the session, and prints both:

- 110 Adam launches (B5) from the main thread or from another thread, on
  the current stream or a side stream, and from a long-lived thread made
  before the session (as a ``dist_async`` server's handler is);
- the same 110 launches in this process while a second process launches
  B5 on the card the whole time (``parallel.launch.spawn``, gloo);
- a BERT-base Adam step through ``Trainer(kvstore='dist_async',
  update_on_kvstore=True)`` with its server in this process, and through
  a local Trainer, each with the session closing after 5 ms, after
  200 ms, or after a no-op on the server's stream; with the runtime's
  launch calls and all kernel events of the session beside them.
"""

import os
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

N = 110


def _adam_case(torch, fo, dev):
    ws = [torch.randn(200_000 + 1000 * i, device=dev) for i in range(N)]
    slots = [(torch.randn_like(w), torch.zeros_like(w), torch.zeros_like(w))
             for w in ws]
    hyper = torch.tensor([1e-4, 0.0, 1.0, 1.0], device=dev)

    def launch_all(stream=None):
        with torch.cuda.stream(stream or torch.cuda.current_stream(dev)):
            for w, (g, m, v) in zip(ws, slots):
                fo.adam_step(w, g, m, v, hyper, beta1=0.9, beta2=0.999,
                             epsilon=1e-8)
    return launch_all


def _session(torch, fn, counter, pre=0.005, post=0.005):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    before = counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pre)
        fn()
        torch.cuda.synchronize()
        time.sleep(post)
    return prof, counter() - before


def threads_and_streams(torch):
    from mxnet_tpu_torch.ops.kernels import fused_optimizer as fo
    dev = torch.device('cuda', 0)
    launch_all = _adam_case(torch, fo, dev)
    launch_all()
    side = torch.cuda.Stream(dev)

    def in_thread(fn):
        t = threading.Thread(target=fn)
        t.start()
        t.join()

    req, done = threading.Event(), threading.Event()

    def server():
        own = torch.cuda.Stream(dev)
        while True:
            req.wait()
            req.clear()
            launch_all(own)
            done.set()

    threading.Thread(target=server, daemon=True).start()

    def via_server():
        req.set()
        done.wait()
        done.clear()

    cases = {'main thread, current stream': launch_all,
             'main thread, side stream': lambda: launch_all(side),
             'another thread, current stream':
                 lambda: in_thread(launch_all),
             'another thread, side stream':
                 lambda: in_thread(lambda: launch_all(side)),
             'a thread made before the session, its own stream':
                 via_server}
    for what, fn in cases.items():
        for rep in range(2):
            prof, n = _session(torch, fn, lambda: fo.adam_step.launches)
            ev = chip_smoke.kernel_events(prof).get('adam', 0)
            print(f'[probe] {what} (try {rep + 1}): {ev} B5 events for {n} '
                  f'launches', flush=True)


def _rank(mode):
    import torch
    import torch.distributed as dist
    from mxnet_tpu_torch.ops.kernels import fused_optimizer as fo
    dev = torch.device('cuda', 0)
    launch_all = _adam_case(torch, fo, dev)
    launch_all()
    torch.cuda.synchronize()
    out = []
    for _ in range(3):
        dist.barrier()
        if dist.get_rank() == 1:
            t = time.perf_counter()
            while mode == 'busy' and time.perf_counter() - t < 1.5:
                launch_all()
                time.sleep(0.0005)
            torch.cuda.synchronize()
        else:
            time.sleep(0.05)
            prof, n = _session(torch, launch_all,
                               lambda: fo.adam_step.launches)
            out.append((chip_smoke.kernel_events(prof).get('adam', 0), n))
        dist.barrier()
    return out


def second_process(torch):
    from mxnet_tpu_torch.parallel import launch
    for mode in ('idle', 'busy'):
        res = launch.spawn(_rank, 2, mode, backend='gloo', timeout=300)
        print(f'[probe] a second process {mode} on the card: (B5 events, '
              f'launches) of three sessions {res[0]}', flush=True)


def server_step(torch):
    from torch.autograd import DeviceType
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.kvstore import dist_async
    from mxnet_tpu_torch.ops import kernels
    from mxnet_tpu_torch.parallel import launch
    chip_smoke.full_fp32(torch)
    dev = torch.device('cuda', 0)
    os.environ.update(MX_COORDINATOR=f'127.0.0.1:{launch.free_ports(1)}',
                      MX_NPROC='1', MX_PROC_ID='0',
                      MXNET_KVSTORE_ASYNC_PORT=str(launch.free_ports(1)))
    mx.random.seed(0)
    net = bert.bert_12_768_12(max_length=128, dropout=0.0,
                              use_classifier=False)
    net.initialize(ctx=mx.gpu(0))
    ids, tt, labels = chip_smoke.bert_batch(mx, 0, 16, 128, 30522)
    net(ids, tt)
    net.hybridize(static_alloc=True)
    params = net.collect_params()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    for kv in ('dist_async', None):
        trainer = gluon.Trainer(params, 'adam', {'learning_rate': 1e-4},
                                kvstore=kv,
                                update_on_kvstore=True if kv else None)

        def step():
            with mx.autograd.record():
                _, _, mlm = net(ids, tt)
                loss = loss_fn(mlm, labels).mean()
            loss.backward()
            trainer.step(1)

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        srv = next(iter(dist_async._SERVERS.values())) if kv else None

        def step_then_noop():
            step()
            if srv is not None:
                with torch.cuda.stream(srv._stream):
                    torch.zeros(1, device=dev).add_(1)

        for what, fn, post in (('5 ms', step, 0.005),
                               ('200 ms', step, 0.2),
                               ('5 ms after a no-op on the server stream',
                                step_then_noop, 0.005)):
            torch.cuda.synchronize()
            before = kernels.launch_counts()
            prof, _ = _session(torch, fn, lambda: 0, post=post)
            after = kernels.launch_counts()
            n = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
            runtime = sum(e.count for e in prof.key_averages()
                          if e.device_type == DeviceType.CPU
                          and e.key.startswith('cudaLaunchKernel'))
            events = sum(e.count for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA)
            print(f'[probe] BERT-base step, kvstore {kv}, session closed '
                  f'{what} after the sync: launches {n}, events '
                  f'{chip_smoke.kernel_events(prof)}; {runtime} runtime '
                  f'launch calls, {events} kernel events', flush=True)
        if kv:
            trainer._kvstore.close()


def main():
    import torch
    if not torch.cuda.is_available():
        chip_smoke.fail('needs a CUDA card')
    chip_smoke.phase_build()
    print(f'[probe] {chip_smoke.smi_line()}', flush=True)
    threads_and_streams(torch)
    second_process(torch)
    server_step(torch)


if __name__ == '__main__':
    main()
