"""``mxnet_tpu_torch.rtc`` on the CPU: what it reads from a user's CUDA
source, which names it hands out, and that it refuses to run on the host.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``
compiles, launches and holds them bit-equal to their torch twins;
``chip_smoke.py`` does so at full size). Where the JAX package's
``rtc.PallasModule`` has the same behaviour (an unknown or unexported
kernel name raises ``KeyError``, ``tests/test_extensions.py:77-80``) the
two are held to it side by side.
"""

import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.rtc import CudaModule, parse_params

SOURCE = r'''
// a comment that names __global__ void not_a_kernel(int x)
extern "C" __global__ void double_kernel(const float* __restrict__ x,
                                         int n, float* y) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] * 2.0f;
}

/* extern "C" __global__ void commented_out(float* y) {} */
extern "C" __global__ void __launch_bounds__(256)
axpy_two(const float *x, const float *y, float a, long long n,
         float *out, int *sign) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) {
    out[i] = a * x[i] + y[i];
    sign[i] = x[i] < 0.f ? -1 : 1;
  }
}
'''
PALLAS_SOURCE = '''
def double_kernel(x_ref, o_ref):
    o_ref[...] = x_ref[...] * 2.0

def axpy_two(x_ref, y_ref, o_ref):
    o_ref[...] = x_ref[...] + y_ref[...]
'''


def test_parameters_are_read_from_the_source():
    mod = CudaModule(SOURCE)
    assert sorted(mod._kernels) == ['axpy_two', 'double_kernel']
    k = mod.get_kernel('double_kernel')
    assert [(p.ctype, p.pointer, p.dtype) for p in k.params] == [
        ('float', 1, torch.float32), ('int', 0, torch.int32),
        ('float', 1, torch.float32)]
    k = mod.get_kernel('axpy_two')
    assert [(p.ctype, bool(p.pointer)) for p in k.params] == [
        ('float', True), ('float', True), ('float', False),
        ('long long', False), ('float', True), ('int', True)]


def test_a_signature_overrides_the_source():
    """The reference's ``signature`` form: a C parameter list, with or
    without names."""
    k = CudaModule(SOURCE).get_kernel('double_kernel',
                                      'const float *, int, float *')
    assert [(p.ctype, p.pointer) for p in k.params] == [
        ('float', 1), ('int', 0), ('float', 1)]
    assert [str(p) for p in parse_params('const double* a, size_t n')] == [
        'const double* a', 'size_t n']
    assert parse_params('void') == []
    with pytest.raises(MXNetError, match='unknown type'):
        parse_params('struct foo* p')
    with pytest.raises(MXNetError, match='pointers to pointers'):
        parse_params('float** p')


@pytest.mark.parametrize('name,exports', [
    ('nope', ()), ('axpy_two', ('double_kernel',)),
    ('not_a_kernel', ()), ('commented_out', ())])
def test_unknown_or_unexported_names_raise_key_error_as_in_jax(name,
                                                               exports):
    from mxnet_tpu import rtc as jax_rtc
    with pytest.raises(KeyError):
        CudaModule(SOURCE, exports=exports).get_kernel(name)
    if name in ('nope', 'axpy_two'):      # names the Pallas source has
        with pytest.raises(KeyError):
            jax_rtc.PallasModule(PALLAS_SOURCE,
                                 exports=exports).get_kernel(name)
    with pytest.raises(KeyError, match='no __global__'):
        CudaModule(SOURCE, exports=('nope',))


def test_exports_hand_out_the_exported_kernel():
    k = CudaModule(SOURCE, exports=('double_kernel',)).get_kernel(
        'double_kernel')
    assert k.name == 'double_kernel' and len(k.params) == 3


def test_launching_on_cpu_tensors_raises_and_counts_nothing():
    kernels.reset_launch_counts()
    k = CudaModule(SOURCE).get_kernel('double_kernel')
    x = torch.arange(8.0)
    with pytest.raises(MXNetError, match='no plain version'):
        k.launch([x, 8], grid=1, block=8, out_shapes=(8,))
    with pytest.raises(MXNetError, match='no plain version'):
        CudaModule(SOURCE).get_kernel('axpy_two').launch(
            [x, x, 2.0, 8], grid=1, block=8, out_shapes=[(8,), (8,)],
            out_dtypes=['float32', 'int32'])
    assert kernels.launch_counts()['rtc'] == 0


def test_launch_checks_its_arguments_before_the_card():
    k = CudaModule(SOURCE).get_kernel('double_kernel')
    x = torch.empty(8, device='meta')
    with pytest.raises(MXNetError, match='must be pointers'):
        k.launch([x], grid=1, block=8, out_shapes=[(8,), (8,)])
    with pytest.raises(ValueError, match='out_shapes'):
        k.launch([x, 8], grid=1, block=8, out_shapes=None)
    with pytest.raises(MXNetError, match='takes 3 arguments'):
        k.launch([x], grid=1, block=8, out_shapes=(8,))
    with pytest.raises(MXNetError, match='no plain version'):
        k.launch([x, 8], grid=1, block=8, out_shapes=(8,))
