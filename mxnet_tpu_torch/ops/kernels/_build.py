"""Build the port's CUDA kernels and bind them with ``ctypes``.

Each ``mxnet_tpu_torch/csrc/<name>.cu`` is compiled on its own by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, under
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``).
The library's file name carries a hash of its sources, so an edited kernel
is rebuilt and a built one is reused. Nothing is built when a module is
imported: :func:`function` builds on the first launch, and
:func:`build_all` builds every source at once, one ``nvcc`` process each,
all started together.

Every C entry point takes raw pointers and a ``cudaStream_t`` (all bound as
``c_void_p``, so ``ctypes`` passes 64 bits) and returns the
``cudaError_t`` of its launch; :func:`check` turns a nonzero code into an
:class:`MXNetError`. :func:`on_device` makes a launch go to its tensors'
card. :func:`sm_count` and :func:`counters` serve the wrappers whose plans
split a kernel's work across blocks.

:func:`count` is how every wrapper counts a launch (or an update sent to
its plain version): on the wrapper's plain-integer counters, and in the
tally that :func:`tally` keeps open for the stream the launch went to. A
graph capture opens one for its stream, so that it takes back exactly the
launches it recorded, whatever another thread (a ``dist_async`` server
applying pushes on a stream of its own) launches meanwhile.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ...base import MXNetError

__all__ = ['CSRC', 'BUILD_DIR', 'NVCC_FLAGS', 'sources', 'build_all', 'count',
           'tally',
           'function', 'check', 'on_device', 'sm_count', 'counters']

CSRC = Path(__file__).resolve().parents[2] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_libs = {}          # kernel name -> ctypes.CDLL
_funcs = {}         # (kernel name, symbol) -> bound ctypes function


def sources():
    """Names of the kernel sources (``csrc/<name>.cu``), sorted."""
    return sorted(p.stem for p in CSRC.glob('*.cu'))


def _nvcc():
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    cands = [os.path.join(home, 'bin', 'nvcc')] if home else []
    cands += [shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc']
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise MXNetError('nvcc not found: the CUDA kernels are built from '
                     'mxnet_tpu_torch/csrc/ at first use and need the '
                     'CUDA toolkit (set CUDA_HOME)')


def _target(name):
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in [CSRC / f'{name}.cu'] + sorted(CSRC.glob('*.cuh')):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def _start(name):
    """Start ``nvcc`` for one source; returns (process, tmp path, target)
    or ``None`` when the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name, started):
    """Wait for one build; returns the compiler's output."""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise MXNetError(f'nvcc failed on csrc/{name}.cu '
                         f'(exit {proc.returncode}):\n{log}')
    os.replace(tmp, out)
    return log


def build_all():
    """Build every kernel source that is not built yet, one ``nvcc`` each,
    all in parallel. Returns ``{name: (seconds, compiler output)}`` for
    the sources it compiled (``ptxas`` reports registers, shared memory
    and spills for each kernel)."""
    with _lock:
        t0 = time.perf_counter()
        started = {n: _start(n) for n in sources()}
        logs, errors = {}, []
        for n, s in started.items():
            if s is None:
                continue
            try:        # wait for every nvcc before raising the first fault
                log = _finish(n, s)
            except MXNetError as e:
                errors.append(e)
                continue
            logs[n] = (time.perf_counter() - t0, log)
        if errors:
            raise errors[0]
        return logs


def _load(name):
    lib = _libs.get(name)
    if lib is None:
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        lib.mx_error_string.argtypes = [ctypes.c_int]
        lib.mx_error_string.restype = ctypes.c_char_p
    return lib


def function(name, symbol, argtypes, restype=ctypes.c_int):
    """The C entry ``symbol`` of ``csrc/<name>.cu``, built and loaded at
    first use, with ``argtypes`` and ``restype`` set."""
    key = (name, symbol)
    fn = _funcs.get(key)
    if fn is None:
        with _lock:
            fn = _funcs.get(key)
            if fn is None:
                fn = getattr(_load(name), symbol)
                fn.argtypes = list(argtypes)
                fn.restype = restype
                _funcs[key] = fn
    return fn


def check(name, rc, what):
    """Raise if a C entry of ``csrc/<name>.cu`` returned a CUDA error."""
    if rc != 0:
        msg = _libs[name].mx_error_string(rc).decode()
        raise MXNetError(f'{what}: CUDA error {rc} ({msg})')


def on_device(device):
    """A context in which ``device`` (a CUDA ``torch.device``) is the
    current device, for a launch on its tensors. A stream handle (the
    default stream's is 0 on every card) and ``cudaGetDevice`` in the C
    entries both mean the current device, so without it a tensor on
    ``cuda:1`` would launch on whatever card the thread has current. Entered
    only when the current device differs: the common case costs one
    compare."""
    if torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


_tallies = {}       # cudaStream_t -> {(wrapper, design, plain): count}


def count(fn, device=None, path=None, plain=False, stream=None):
    """Count one launch of ``fn``'s kernel (``fn.launches``, and
    ``fn.launches_by_path[path]`` for a design), or with ``plain`` one
    update it sent to its plain version (``fn.plain_updates``), and add it
    to the tally open for its stream: ``stream`` (a ``cudaStream_t``), or
    ``device``'s current stream."""
    if plain:
        fn.plain_updates += 1
    else:
        fn.launches += 1
        if path is not None:
            fn.launches_by_path[path] += 1
    if not _tallies:
        return
    if stream is None:
        if device is None or torch.device(device).type != 'cuda':
            return
        stream = torch.cuda.current_stream(device).cuda_stream
    tally_ = _tallies.get(stream)
    if tally_ is not None:
        key = (fn, path, plain)
        tally_[key] = tally_.get(key, 0) + 1


@contextlib.contextmanager
def tally(stream):
    """Inside the block, :func:`count` also adds the launches on
    ``stream`` (a ``torch.cuda.Stream``) to the dict it yields, keyed by
    ``(wrapper, design, plain)``."""
    tally_ = _tallies[stream.cuda_stream] = {}
    try:
        yield tally_
    finally:
        del _tallies[stream.cuda_stream]


_sm_counts = {}     # device index -> SMs
_counters = {}      # (kernel name, device index, stream) -> [int32 counters]


def sm_count(device):
    """The SMs of a CUDA ``device``, read once."""
    n = _sm_counts.get(device.index)
    if n is None:
        n = _sm_counts[device.index] = \
            torch.cuda.get_device_properties(device).multi_processor_count
    return n


def counters(name, device, stream, n):
    """At least ``n`` int32 counters on ``device`` for the kernels of
    ``csrc/<name>.cu`` that split their work, launched on ``stream`` (a
    ``cudaStream_t`` as an integer), zero at rest: made once with
    ``torch.zeros``, and set back to zero by the block that finishes each
    tile. One set per stream, so that split calls on two streams never
    count each other's blocks; calls on one stream run one after another.

    When a call needs more, a larger set takes over, and every set handed
    out stays alive for the life of the process: a CUDA graph that
    captured a smaller one keeps its address and counts there on every
    replay, so that memory must never go back to the allocator for
    something else to take. An old set is still zero at rest, so it stays
    right for the calls its graphs replay."""
    key = (name, device.index, stream)
    sets = _counters.setdefault(key, [])
    if not sets or sets[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise MXNetError(f'{name}: the first split call of this size on '
                             f'a stream cannot be captured in a CUDA graph; '
                             f'run it once before capturing')
        sets.append(torch.zeros(max(n, 4096), dtype=torch.int32,
                                device=device))
    return sets[-1]
