"""Runtime kernel compilation: ``mx.rtc.CudaModule``.

Counterpart of the JAX package's ``rtc.py`` (``PallasKernel.launch`` :39,
``get_kernel`` :105, ``CudaModule`` :116), which takes a user's Pallas
source. The reference MXNet compiled raw CUDA source at run time with
NVRTC (``python/mxnet/rtc.py:41``, ``src/common/rtc.cc:35-52``); on a CUDA
card the port does that again. The source is CUDA C with ``extern "C"
__global__`` kernels::

    mod = CudaModule(r'''
    extern "C" __global__ void axpy(const float* x, float* y, float a,
                                    int n) {
      int i = blockIdx.x * blockDim.x + threadIdx.x;
      if (i < n) y[i] = a * x[i];
    }''')
    n = x.numel()
    (y,) = mod.get_kernel('axpy').launch(
        [x, 2.0, n], grid=(n + 255) // 256, block=256, out_shapes=[x.shape])

The outputs are allocated from ``out_shapes``/``out_dtypes`` and passed
after the inputs, in the order of the kernel's parameters, as in the JAX
package; ``launch`` returns them as a new tuple. The source is compiled
with NVRTC for ``sm_90a`` at the first launch on a card, and the kernel
runs on PyTorch's current stream (the binding is
:mod:`.ops.kernels._nvrtc`). There is no plain version of a user's CUDA
source, so a CPU tensor raises :class:`MXNetError`: nothing runs in its
place.
"""

import ctypes
import re
import threading

import torch

from .base import MXNetError

__all__ = ['CudaModule', 'CudaKernel']

#: NVRTC options every module gets (the user's ``options`` follow)
DEFAULT_OPTIONS = ('--gpu-architecture=sm_90a', '--std=c++17')

# C parameter type -> (torch dtype of a pointer to it, ctypes scalar type)
_TYPES = {
    'float': (torch.float32, ctypes.c_float),
    'double': (torch.float64, ctypes.c_double),
    '__half': (torch.float16, None), 'half': (torch.float16, None),
    '__nv_bfloat16': (torch.bfloat16, None),
    'char': (torch.int8, ctypes.c_byte),
    'signed char': (torch.int8, ctypes.c_byte),
    'int8_t': (torch.int8, ctypes.c_byte),
    'unsigned char': (torch.uint8, ctypes.c_ubyte),
    'uint8_t': (torch.uint8, ctypes.c_ubyte),
    'short': (torch.int16, ctypes.c_short),
    'int16_t': (torch.int16, ctypes.c_short),
    'int': (torch.int32, ctypes.c_int), 'int32_t': (torch.int32, ctypes.c_int),
    'signed': (torch.int32, ctypes.c_int),
    'unsigned': (None, ctypes.c_uint), 'unsigned int': (None, ctypes.c_uint),
    'uint32_t': (None, ctypes.c_uint),
    'long long': (torch.int64, ctypes.c_longlong),
    'long': (torch.int64, ctypes.c_long),
    'int64_t': (torch.int64, ctypes.c_int64),
    'unsigned long long': (None, ctypes.c_ulonglong),
    'uint64_t': (None, ctypes.c_uint64), 'size_t': (None, ctypes.c_size_t),
    'bool': (torch.bool, ctypes.c_bool),
    'void': (None, None),
}
_QUALIFIERS = {'const', 'volatile', '__restrict__', 'restrict',
               '__restrict'}
_KERNEL = re.compile(
    r'__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?'
    r'([A-Za-z_]\w*)\s*\(([^)]*)\)')


class _Param:
    """One kernel parameter: ``pointer`` (a tensor) or a scalar."""

    def __init__(self, text):
        self.text = ' '.join(text.split())
        body = self.text.replace('*', ' * ')
        self.pointer = body.count('*')
        if self.pointer > 1:
            raise MXNetError(f'rtc: parameter {text!r}: pointers to '
                             f'pointers are not taken')
        words = [w for w in body.replace('*', ' ').split()
                 if w not in _QUALIFIERS]
        ctype = ' '.join(words)
        if ctype not in _TYPES and len(words) > 1:
            ctype = ' '.join(words[:-1])        # the last word is a name
        if ctype not in _TYPES:
            raise MXNetError(f'rtc: parameter {text!r}: unknown type '
                             f'{ctype!r}')
        self.ctype = ctype
        self.dtype, self.scalar = _TYPES[ctype]
        if not self.pointer and self.scalar is None:
            raise MXNetError(f'rtc: parameter {text!r}: a scalar of type '
                             f'{ctype!r} is not taken')

    def __repr__(self):
        return self.text


def _strip_comments(source):
    source = re.sub(r'/\*.*?\*/', ' ', source, flags=re.S)
    return re.sub(r'//[^\n]*', ' ', source)


def parse_params(signature):
    """The parameters of a C parameter list (``'const float* x, int n'``;
    names may be left out, as in the reference's ``signature``)."""
    text = signature.strip()
    if text in ('', 'void'):
        return []
    return [_Param(p) for p in text.split(',')]


def parse_kernels(source):
    """``{name: parameter list}`` of the ``__global__`` kernels in
    ``source``, each list as the source writes it."""
    return {m.group(1): m.group(2)
            for m in _KERNEL.finditer(_strip_comments(source))}


def _dims(x, what):
    dims = (x,) if isinstance(x, int) else tuple(int(v) for v in x)
    if not 1 <= len(dims) <= 3 or min(dims) < 1:
        raise MXNetError(f'rtc: {what} must be 1 to 3 positive ints, got '
                         f'{x!r}')
    return dims + (1,) * (3 - len(dims))


def _dtype(d):
    if isinstance(d, torch.dtype):
        return d
    dt = getattr(torch, str(d), None)
    if not isinstance(dt, torch.dtype):
        raise MXNetError(f'rtc: unknown dtype {d!r}')
    return dt


class CudaModule:
    """CUDA C source whose ``__global__`` kernels are launched at run time
    (the reference's ``rtc.CudaModule``). ``options`` are added to NVRTC's
    (after ``DEFAULT_OPTIONS``); ``exports``, when given, are the only
    names :meth:`get_kernel` hands out. The source is compiled at the
    first launch, once, and loaded once per device."""

    def __init__(self, source, options=(), exports=()):
        self.source = source
        self.options = DEFAULT_OPTIONS + tuple(options)
        self._exports = tuple(exports)
        self._kernels = parse_kernels(source)
        for name in self._exports:
            if name not in self._kernels:
                raise KeyError(f'exported name {name!r} is no __global__ '
                               f'kernel of the source')
        self._lock = threading.Lock()
        self._cubin = self._lowered = None
        self._modules = {}          # device index -> CUmodule
        self._functions = {}        # (device index, name) -> CUfunction

    def get_kernel(self, name, signature=None):
        """The kernel ``name`` as a :class:`CudaKernel`. Its parameters
        are read from the source, or from ``signature`` (a C parameter
        list) when given. An unknown or unexported name raises
        ``KeyError``."""
        if self._exports and name not in self._exports:
            raise KeyError(f'{name} not exported from this module')
        if name not in self._kernels:
            raise KeyError(f'no kernel {name!r} in module source')
        return CudaKernel(self, name, parse_params(
            self._kernels[name] if signature is None else signature))

    def _function(self, name, device):
        """The loaded kernel on ``device`` (compiled at the first call)."""
        from .ops.kernels import _nvrtc
        key = (device.index, name)
        with self._lock:
            _nvrtc.make_current(device.index)
            fn = self._functions.get(key)
            if fn is None:
                if self._cubin is None:
                    names = list(self._exports or self._kernels)
                    self._cubin, self._lowered = _nvrtc.compile_cubin(
                        self.source, names, self.options)
                mod = self._modules.get(device.index)
                if mod is None:
                    mod = self._modules[device.index] = _nvrtc.load_module(
                        self._cubin)
                fn = self._functions[key] = _nvrtc.get_function(
                    mod, self._lowered[name])
            return fn


class CudaKernel:
    """One launchable kernel of a :class:`CudaModule` (the reference's
    ``rtc.CudaKernel``)."""

    def __init__(self, module, name, params):
        self.module = module
        self.name = name
        self.params = params

    def __repr__(self):
        return f'CudaKernel({self.name}({", ".join(map(str, self.params))}))'

    def launch(self, args, grid, block, out_shapes, out_dtypes=None,
               shared_mem=0):
        """Run the kernel over ``args`` (tensors for pointer parameters,
        Python numbers for scalars) followed by new outputs of
        ``out_shapes`` (one shape or a list of shapes) and ``out_dtypes``
        (default: the pointer's type, float32 for ``void*``), with
        ``grid`` and ``block`` of 1 to 3 dims and ``shared_mem`` bytes of
        dynamic shared memory. Returns the outputs as a tuple."""
        from .ops.kernels import _nvrtc
        if out_shapes is None:
            raise ValueError('out_shapes= is required')
        single = isinstance(out_shapes, torch.Size) or (
            isinstance(out_shapes, (list, tuple)) and out_shapes
            and isinstance(out_shapes[0], int))
        if single:
            out_shapes = [tuple(out_shapes)]
        n_out = len(out_shapes)
        args = list(args)
        if len(args) + n_out != len(self.params):
            raise MXNetError(
                f'rtc: {self.name} takes {len(self.params)} arguments '
                f'({self}), got {len(args)} inputs and {n_out} outputs')
        out_params = self.params[len(args):]
        if any(not p.pointer for p in out_params):
            raise MXNetError(f'rtc: {self.name}: the last {n_out} '
                             f'parameters must be pointers, to take the '
                             f'outputs')
        if out_dtypes is None:
            out_dtypes = [p.dtype or torch.float32 for p in out_params]
        elif isinstance(out_dtypes, (str, torch.dtype)):
            out_dtypes = [out_dtypes] * n_out
        out_dtypes = [_dtype(d) for d in out_dtypes]

        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        devices = {t.device for t in tensors}
        if any(d.type != 'cuda' for d in devices):
            raise MXNetError(
                f'rtc: {self.name} got a tensor on {sorted(map(str, devices))}'
                f': a user\'s CUDA source runs only on a CUDA device, and '
                f'there is no plain version to run in its place')
        if len(devices) > 1:
            raise MXNetError(f'rtc: {self.name}: tensors on several '
                             f'devices {sorted(map(str, devices))}')
        if not devices and not torch.cuda.is_available():
            raise MXNetError(f'rtc: {self.name} needs a CUDA device and '
                             f'none is available')
        device = devices.pop() if devices else torch.device(
            'cuda', torch.cuda.current_device())
        outs = tuple(torch.empty(tuple(s), dtype=dt, device=device)
                     for s, dt in zip(out_shapes, out_dtypes))

        values = []
        for i, (p, a) in enumerate(zip(self.params, args + list(outs))):
            if p.pointer:
                if not isinstance(a, torch.Tensor):
                    raise MXNetError(f'rtc: {self.name} argument {i} '
                                     f'({p}) wants a tensor, got '
                                     f'{type(a).__name__}')
                if p.dtype is not None and a.dtype != p.dtype:
                    raise MXNetError(f'rtc: {self.name} argument {i} ({p}) '
                                     f'wants {p.dtype}, got {a.dtype}')
                if not a.is_contiguous():
                    raise MXNetError(f'rtc: {self.name} argument {i} ({p}) '
                                     f'must be contiguous')
                values.append(ctypes.c_void_p(a.data_ptr()))
            else:
                if isinstance(a, torch.Tensor):
                    raise MXNetError(f'rtc: {self.name} argument {i} ({p}) '
                                     f'is a scalar; pass a Python number')
                values.append(p.scalar(a))
        grid, block = _dims(grid, 'grid'), _dims(block, 'block')
        fn = self.module._function(self.name, device)
        if shared_mem > 48 * 1024:
            _nvrtc.set_dynamic_shared(fn, shared_mem)
        _nvrtc.launch(fn, grid, block, int(shared_mem),
                      torch.cuda.current_stream(device).cuda_stream, values)
        return outs
