"""Hand-written CUDA kernels of the port, one module each beside its plain
PyTorch version: :mod:`.fused_norms`, :mod:`.flash_attention`,
:mod:`.paged_attention`. :mod:`._build` compiles ``csrc/`` and binds it.

Each kernel's wrapper counts its launches in a plain integer attribute
(``fused_norm.launches`` ...); :func:`launch_counts` reads them and
:func:`reset_launch_counts` sets them to 0.
"""

from .fused_norms import fused_norm
from .flash_attention import flash_attention_fwd
from .paged_attention import paged_attention_decode

__all__ = ['KERNELS', 'launch_counts', 'reset_launch_counts']

#: kernel name -> the wrapper that launches it
KERNELS = {'fused_norm': fused_norm,
           'flash_attention': flash_attention_fwd,
           'paged_attention_decode': paged_attention_decode}


def launch_counts():
    """``{kernel name: launches so far}``."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0
