"""Operators of the PyTorch port: :mod:`.nn` and :mod:`.contrib` hold the
ops the Llama path calls, :mod:`.optimizer_ops` the fused optimizer steps;
:mod:`.kernels` holds the hand-written CUDA kernels beneath them."""
