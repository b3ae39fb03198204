"""Start N ranks on this host: the counterpart of ``tools/launch.py -n N
--launcher local`` for the port.

:func:`spawn` starts one process per rank with the ``spawn`` start method
(a fresh interpreter, so CUDA is initialised in each rank and never
inherited), gives each the ``MX_COORDINATOR``/``MX_NPROC``/``MX_PROC_ID``
environment, joins the world through a ``file://`` store in a temporary
directory (no TCP port to clash with another run on the host), runs
``fn(*args)`` in every rank and hands back each rank's return value.

A ``file://`` coordinator names no host and port for the ``dist_async``
parameter server, which ``tools/launch.py``'s ranks find at
``MX_COORDINATOR``'s ``host:port`` (+ 29, or ``MXNET_KVSTORE_ASYNC_PORT``).
So unless the caller's environment sets ``MXNET_KVSTORE_ASYNC_PORT``,
:func:`spawn` gives its ranks loopback ports that were free when it
started: a base port and the ``nprocs - 1`` after it (server s listens at
base + s).
"""

import multiprocessing
import multiprocessing.connection
import os
import socket
import sys
import tempfile
import time
import traceback

__all__ = ['spawn', 'free_ports', 'die', 'DIED']

#: the exit code of a rank that left through :func:`die`
DIED = 75


def free_ports(n, host='127.0.0.1', tries=50):
    """A port ``p`` of ``host`` such that ``p .. p + n - 1`` could all be
    bound just now (the OS picks ``p``; nothing is held afterwards)."""
    for _ in range(tries):
        held = []
        try:
            s = socket.socket()
            held.append(s)
            s.bind((host, 0))
            base = s.getsockname()[1]
            for p in range(base + 1, base + n):
                s = socket.socket()
                held.append(s)
                s.bind((host, p))
            return base
        except OSError:
            continue
        finally:
            for s in held:
                s.close()
    raise OSError(f'no {n} consecutive free ports on {host}')


def die():
    """Leave this rank at once, as a killed host does: no result, no
    cleanup, its sockets closed by the exit. :func:`spawn` with
    ``may_die=True`` reports the rank's result as None."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(DIED)


def _rank_main(fn, args, rank, nprocs, store, backend, timeout, outdir,
               env):
    import torch
    os.environ.update(env, MX_COORDINATOR=store, MX_NPROC=str(nprocs),
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
    from ..sharding.context import abandoned
    if result[0] == 'ok' and dist.is_initialized() and not abandoned():
        dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0 if result[0] == 'ok' else 1)


def spawn(fn, nprocs, *args, backend='gloo', timeout=600, may_die=False):
    """Run ``fn(*args)`` in ``nprocs`` new processes, one rank each, in one
    world (``backend``, default gloo); returns the list of their return
    values, rank by rank (passed back through ``torch.save``, so tensors
    may be among them).

    ``fn`` must be importable by name (a module-level function). The ranks
    must finish within ``timeout`` seconds, which also bounds each
    collective. If a rank fails or the time runs out, every rank still
    running is killed and :class:`MXNetError` is raised with the failed
    rank's traceback. With ``may_die``, a rank that left through
    :func:`die` is no failure: its result is None."""
    from ..base import MXNetError
    import torch

    ctx = multiprocessing.get_context('spawn')
    env = {} if 'MXNET_KVSTORE_ASYNC_PORT' in os.environ else \
        {'MXNET_KVSTORE_ASYNC_PORT': str(free_ports(nprocs))}
    with tempfile.TemporaryDirectory(prefix='mx_spawn_') as tmp:
        store = f'file://{os.path.join(tmp, "store")}'
        procs = [ctx.Process(
            target=_rank_main, name=f'mx-rank-{r}',
            args=(fn, args, r, nprocs, store, backend, timeout, tmp, env))
            for r in range(nprocs)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            while True:
                ok = (None, 0, DIED) if may_die else (None, 0)
                bad = [(r, p.exitcode) for r, p in enumerate(procs)
                       if p.exitcode not in ok]
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
            return [None if p.exitcode == DIED else
                    torch.load(os.path.join(tmp, f'{r}.pt'),
                               weights_only=False)[1]
                    for r, p in enumerate(procs)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                if p.pid is not None:
                    p.join()
