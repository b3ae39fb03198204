"""Hand-written CUDA kernels of the port, one module each beside its plain
PyTorch version: :mod:`.fused_norms`, :mod:`.flash_attention` (both
forms), :mod:`.paged_attention`, :mod:`.fused_optimizer`,
:mod:`.int8_matmul`. :mod:`._build` compiles ``csrc/`` and binds it;
:mod:`._nvrtc` compiles and launches a user's CUDA source for
:mod:`mxnet_tpu_torch.rtc` (counted as ``'rtc'``).

Each kernel's wrapper counts its launches in a plain integer attribute
(``fused_norm.launches`` ...); :func:`launch_counts` reads them,
:func:`reset_launch_counts` sets them to 0, and :func:`add_launch_counts`
adds what a CUDA graph's replay launched. The norm, the int8 product,
both flash forms and paged decode also count by the design their plan
took (``launches_by_path``), which :func:`path_counts` reads. The
optimizer wrappers count apart, in ``plain_updates``, the updates that
their dtype rule sent to the plain version (a weight that is not fp32):
:func:`plain_update_counts` reads them, and the other three functions set
and add them beside the launches.

A wrapper given meta tensors inside an abstract evaluation (the trace of
an export, ``infer_shape``: :mod:`mxnet_tpu_torch._deferred_compute`)
takes its plain version's path, which on meta tensors computes its
output's shape and dtype and nothing else (``_build.plain_here``): no
value is made there, so it is no fallback from the kernel, and nothing is
counted. Outside one a meta tensor raises, as any tensor off the CPU that
the kernel cannot take.
"""

import torch

from .fused_norms import fused_norm
from .flash_attention import flash_attention_fwd, flash_attention_stats
from .paged_attention import paged_attention_decode
from .fused_optimizer import adam_step, sgd_mom_step
from . import int8_matmul as _int8     # the module keeps its name here
from . import _nvrtc

__all__ = ['KERNELS', 'PLAIN_UPDATES', 'launch_counts', 'path_counts',
           'plain_update_counts', 'reset_launch_counts', 'add_launch_counts',
           'needs_grad']

#: kernel name -> the wrapper that launches it
KERNELS = {'fused_norm': fused_norm,
           'flash_attention': flash_attention_fwd,
           'paged_attention_decode': paged_attention_decode,
           'adam': adam_step,
           'sgd_mom': sgd_mom_step,
           'int8_matmul': _int8.int8_matmul,
           'flash_attention_stats': flash_attention_stats,
           'rtc': _nvrtc.launch}
#: kernel name -> the optimizer wrapper whose ``plain_updates`` counts the
#: updates it sent to the plain version by dtype
PLAIN_UPDATES = {'adam': adam_step, 'sgd_mom': sgd_mom_step}


def launch_counts():
    """``{kernel name: launches so far}``."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def path_counts():
    """``{kernel name: {design: launches so far}}`` for the kernels whose
    wrappers plan a design."""
    return {name: dict(fn.launches_by_path) for name, fn in KERNELS.items()
            if hasattr(fn, 'launches_by_path')}


def plain_update_counts():
    """``{kernel name: updates sent to its plain version by dtype}``."""
    return {name: fn.plain_updates for name, fn in PLAIN_UPDATES.items()}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, 'launches_by_path'):
            fn.launches_by_path = dict.fromkeys(fn.launches_by_path, 0)
    for fn in PLAIN_UPDATES.values():
        fn.plain_updates = 0


def add_launch_counts(counts, paths=None, times=1, plain=None):
    """Add ``times`` x ``counts`` (``{kernel name: launches}``), ``paths``
    (``{kernel name: {design: launches}}``) and ``plain`` (``{kernel
    name: plain updates}``) to the counters: what a CUDA graph's replay
    ran, which no wrapper sees (:class:`mxnet_tpu_torch._graphs.
    StepGraph`)."""
    for name, n in (plain or {}).items():
        PLAIN_UPDATES[name].plain_updates += times * n
    for name, n in counts.items():
        KERNELS[name].launches += times * n
    for name, by_design in (paths or {}).items():
        fn = KERNELS[name]
        for design, n in by_design.items():
            fn.launches_by_path[design] += times * n


def needs_grad(*tensors):
    """True when autograd records: grad mode is on and one of ``tensors``
    (``None`` allowed) requires grad. The ops take a kernel's
    ``autograd.Function`` only then, so that inference pays nothing for
    it."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
