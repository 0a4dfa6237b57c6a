"""PyTorch/CUDA port of the LM serving path of ``repro`` for one NVIDIA H100.

The package imports ``torch`` and never ``jax`` or anything of ``repro``;
where it needs code from ``repro`` it keeps its own copy.  Kernels on the
path are hand-written CUDA C++ (``kernels/csrc``) with plain PyTorch
versions beside them (``kernels/ref.py``) that run for CPU tensors.
Importing this package imports nothing heavy.
"""
