"""Core shared definitions of the PyTorch port: the error hierarchy."""


class MXNetError(RuntimeError):
    """Base error type for the framework (reference: python/mxnet/error.py)."""
