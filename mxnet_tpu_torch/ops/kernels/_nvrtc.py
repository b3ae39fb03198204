"""NVRTC and the CUDA driver API through ``ctypes``: the binding under
:mod:`mxnet_tpu_torch.rtc`, which compiles a user's CUDA C source at run
time and launches its kernels on PyTorch's current stream.

``libnvrtc`` is taken from the CUDA toolkit that :mod:`._build` finds (the
directory of ``nvcc``, or ``CUDA_HOME``), else from the one PyTorch's CUDA
build ships, else by its name; ``libcuda.so.1`` is the driver's. Nothing
is loaded when the module is imported.

Every driver call runs in PyTorch's primary context of the tensors'
device: :func:`make_current` retains it and makes it current in the
calling thread first, so the modules and functions loaded here belong to
the context that PyTorch's allocations and streams live in.
"""

import ctypes
import glob
import os
import threading

from ...base import MXNetError
from . import _build

__all__ = ['compile_cubin', 'load_module', 'get_function',
           'set_dynamic_shared', 'launch', 'make_current']

_lock = threading.Lock()
_libs = {}
_contexts = {}      # device index -> retained primary CUcontext

# CUfunction_attribute CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES
_MAX_DYNAMIC_SHARED = 8


def _nvrtc_candidates():
    dirs = []
    try:
        dirs.append(os.path.dirname(os.path.dirname(_build._nvcc())))
    except MXNetError:
        pass
    for var in ('CUDA_HOME', 'CUDA_PATH'):
        if os.environ.get(var):
            dirs.append(os.environ[var])
    libdirs = [os.path.join(d, sub) for d in dirs
               for sub in ('lib64', 'lib', 'targets/x86_64-linux/lib')]
    import torch
    site = os.path.dirname(os.path.dirname(torch.__file__))
    libdirs += [os.path.join(site, 'nvidia', 'cuda_nvrtc', 'lib'),
                os.path.join(os.path.dirname(torch.__file__), 'lib')]
    found = []
    for d in libdirs:
        for pat in ('libnvrtc.so*', 'libnvrtc-*.so*'):   # the latter: wheels
            found += sorted(p for p in glob.glob(os.path.join(d, pat))
                            if 'builtins' not in os.path.basename(p))
    major = (torch.version.cuda or '12').split('.')[0]
    return found + [f'libnvrtc.so.{major}', 'libnvrtc.so']


def _nvrtc():
    lib = _libs.get('nvrtc')
    if lib is not None:
        return lib
    tried = []
    for cand in _nvrtc_candidates():
        # libnvrtc opens its builtins library by name; load the one beside
        # it first, so that the pair comes from one toolkit
        for b in sorted(glob.glob(os.path.join(os.path.dirname(cand),
                                               'libnvrtc-builtins.so*'))):
            try:
                ctypes.CDLL(b, mode=ctypes.RTLD_GLOBAL)
                break
            except OSError:
                continue
        try:
            lib = ctypes.CDLL(cand)
        except OSError as e:
            tried.append(f'{cand}: {e}')
            continue
        lib.nvrtcGetErrorString.restype = ctypes.c_char_p
        lib.nvrtcGetErrorString.argtypes = [ctypes.c_int]
        _libs['nvrtc'] = lib
        return lib
    raise MXNetError('rtc: libnvrtc not found (CUDA toolkit or PyTorch\'s '
                     'CUDA build):\n' + '\n'.join(tried))


def _cuda():
    lib = _libs.get('cuda')
    if lib is None:
        try:
            lib = ctypes.CDLL('libcuda.so.1')
        except OSError as e:
            raise MXNetError(f'rtc: the CUDA driver (libcuda.so.1) is not '
                             f'there: {e}') from None
        lib.cuLaunchKernel.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_uint] * 7
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
        _libs['cuda'] = lib
    return lib


def _check_cu(rc, what):
    if rc != 0:
        msg = ctypes.c_char_p()
        _cuda().cuGetErrorString(rc, ctypes.byref(msg))
        text = msg.value.decode() if msg.value else 'unknown error'
        raise MXNetError(f'rtc: {what}: CUDA driver error {rc} ({text})')


def _check_nvrtc(rc, what):
    if rc != 0:
        raise MXNetError(f'rtc: {what}: NVRTC error {rc} '
                         f'({_nvrtc().nvrtcGetErrorString(rc).decode()})')


def compile_cubin(source, names, options):
    """Compile CUDA C ``source`` with NVRTC; returns ``(cubin bytes,
    {name: lowered name})`` for the kernel ``names``. ``options`` are
    NVRTC's (``--gpu-architecture=sm_90a``, ...). A source that does not
    compile raises :class:`MXNetError` with NVRTC's log."""
    lib = _nvrtc()
    prog = ctypes.c_void_p()
    _check_nvrtc(lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), b'mx_rtc.cu', 0, None, None),
        'nvrtcCreateProgram')
    try:
        for n in names:
            _check_nvrtc(lib.nvrtcAddNameExpression(prog, n.encode()),
                         f'nvrtcAddNameExpression({n})')
        opts = [o.encode() for o in options]
        rc = lib.nvrtcCompileProgram(prog, len(opts),
                                     (ctypes.c_char_p * len(opts))(*opts))
        size = ctypes.c_size_t()
        lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
        log = ctypes.create_string_buffer(size.value)
        lib.nvrtcGetProgramLog(prog, log)
        if rc != 0:
            raise MXNetError(
                f'rtc: the source does not compile (NVRTC error {rc}, '
                f'{lib.nvrtcGetErrorString(rc).decode()}):\n'
                f'{log.value.decode(errors="replace")}')
        _check_nvrtc(lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     'nvrtcGetCUBINSize')
        cubin = ctypes.create_string_buffer(size.value)
        _check_nvrtc(lib.nvrtcGetCUBIN(prog, cubin), 'nvrtcGetCUBIN')
        lowered = {}
        for n in names:
            out = ctypes.c_char_p()
            _check_nvrtc(lib.nvrtcGetLoweredName(prog, n.encode(),
                                                 ctypes.byref(out)),
                         f'nvrtcGetLoweredName({n})')
            lowered[n] = out.value.decode()
        return cubin.raw, lowered
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


def make_current(device_index):
    """Retain PyTorch's primary context of CUDA device ``device_index``
    and make it current in this thread."""
    cu = _cuda()
    with _lock:
        ctx = _contexts.get(device_index)
        if ctx is None:
            _check_cu(cu.cuInit(0), 'cuInit')
            dev = ctypes.c_int()
            _check_cu(cu.cuDeviceGet(ctypes.byref(dev), device_index),
                      'cuDeviceGet')
            ctx = ctypes.c_void_p()
            _check_cu(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                      'cuDevicePrimaryCtxRetain')
            _contexts[device_index] = ctx
    cur = ctypes.c_void_p()
    _check_cu(cu.cuCtxGetCurrent(ctypes.byref(cur)), 'cuCtxGetCurrent')
    if cur.value != ctx.value:
        _check_cu(cu.cuCtxSetCurrent(ctx), 'cuCtxSetCurrent')


def load_module(cubin):
    """``cuModuleLoadData`` in the current context; returns the module."""
    mod = ctypes.c_void_p()
    _check_cu(_cuda().cuModuleLoadData(ctypes.byref(mod), cubin),
              'cuModuleLoadData')
    return mod


def get_function(module, name):
    """The kernel ``name`` (a lowered name) of ``module``."""
    fn = ctypes.c_void_p()
    _check_cu(_cuda().cuModuleGetFunction(ctypes.byref(fn), module,
                                          name.encode()),
              f'cuModuleGetFunction({name})')
    return fn


def set_dynamic_shared(fn, shared_mem):
    """Allow ``fn`` ``shared_mem`` bytes of dynamic shared memory (needed
    above 48 KB)."""
    _check_cu(_cuda().cuFuncSetAttribute(fn, _MAX_DYNAMIC_SHARED,
                                         ctypes.c_int(shared_mem)),
              'cuFuncSetAttribute(MAX_DYNAMIC_SHARED_SIZE_BYTES)')


def launch(fn, grid, block, shared_mem, stream, params):
    """``cuLaunchKernel`` of ``fn`` over ``grid`` x ``block`` (3-tuples) on
    ``stream`` (a ``cudaStream_t`` as an int); ``params`` are the kernel's
    arguments as ``ctypes`` values, in order. Counts in
    ``launch.launches``."""
    ptrs = (ctypes.c_void_p * max(len(params), 1))(
        *[ctypes.addressof(p) for p in params])
    _check_cu(_cuda().cuLaunchKernel(
        fn, *grid, *block, shared_mem, stream, ptrs, None),
        'cuLaunchKernel')
    launch.launches += 1


launch.launches = 0
