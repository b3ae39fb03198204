"""Start N ranks on this host: the counterpart of ``tools/launch.py -n N
--launcher local`` for the port.

:func:`spawn` starts one process per rank with the ``spawn`` start method
(a fresh interpreter, so CUDA is initialised in each rank and never
inherited), gives each the ``MX_COORDINATOR``/``MX_NPROC``/``MX_PROC_ID``
environment, joins the world through a ``file://`` store in a temporary
directory (no TCP port to clash with another run on the host), runs
``fn(*args)`` in every rank and hands back each rank's return value.
"""

import multiprocessing
import multiprocessing.connection
import os
import sys
import tempfile
import time
import traceback

__all__ = ['spawn']


def _rank_main(fn, args, rank, nprocs, store, backend, timeout, outdir):
    import torch
    os.environ.update(MX_COORDINATOR=store, MX_NPROC=str(nprocs),
                      MX_PROC_ID=str(rank))
    out = os.path.join(outdir, f'{rank}.pt')
    try:
        from . import init_distributed
        init_distributed(backend=backend, timeout=timeout)
        result = ('ok', fn(*args))
    except BaseException:       # the parent raises it, with this traceback
        result = ('error', traceback.format_exc())
    torch.save(result, out + '.tmp')
    os.replace(out + '.tmp', out)
    import torch.distributed as dist
    if result[0] == 'ok' and dist.is_initialized():
        dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0 if result[0] == 'ok' else 1)


def spawn(fn, nprocs, *args, backend='gloo', timeout=600):
    """Run ``fn(*args)`` in ``nprocs`` new processes, one rank each, in one
    world (``backend``, default gloo); returns the list of their return
    values, rank by rank (passed back through ``torch.save``, so tensors
    may be among them).

    ``fn`` must be importable by name (a module-level function). The ranks
    must finish within ``timeout`` seconds, which also bounds each
    collective. If a rank fails or the time runs out, every rank still
    running is killed and :class:`MXNetError` is raised with the failed
    rank's traceback."""
    from ..base import MXNetError
    import torch

    ctx = multiprocessing.get_context('spawn')
    with tempfile.TemporaryDirectory(prefix='mx_spawn_') as tmp:
        store = f'file://{os.path.join(tmp, "store")}'
        procs = [ctx.Process(
            target=_rank_main, name=f'mx-rank-{r}',
            args=(fn, args, r, nprocs, store, backend, timeout, tmp))
            for r in range(nprocs)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            while True:
                bad = [(r, p.exitcode) for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    r, code = bad[0]
                    path = os.path.join(tmp, f'{r}.pt')
                    why = torch.load(path, weights_only=False)[1] \
                        if os.path.exists(path) else 'no traceback'
                    raise MXNetError(f'rank {r} of {nprocs} failed (exit '
                                     f'{code}):\n{why}')
                running = [p for p in procs if p.exitcode is None]
                if not running:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise MXNetError(
                        f'ranks {[p.name for p in running]} did not '
                        f'finish within {timeout} s')
                multiprocessing.connection.wait(
                    [p.sentinel for p in running], timeout=min(left, 1.0))
            return [torch.load(os.path.join(tmp, f'{r}.pt'),
                               weights_only=False)[1]
                    for r in range(nprocs)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                if p.pid is not None:
                    p.join()
