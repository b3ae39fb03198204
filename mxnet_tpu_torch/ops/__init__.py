"""Operators of the PyTorch port: :mod:`.nn` and :mod:`.contrib` hold the
ops the Llama serving path calls; :mod:`.kernels` holds the hand-written
CUDA kernels beneath them."""
