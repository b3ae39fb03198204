"""Model zoo of the PyTorch port."""

from . import llama

__all__ = ['llama']
