"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100: the LM serving path
and the paper's dataflow simulator (``core.simulate_batch``).

The package imports ``torch`` and never ``jax`` or anything of ``repro``;
where it needs code from ``repro`` it keeps its own copy.  Kernels on the
path are hand-written CUDA C++ (``kernels/csrc``) with plain PyTorch
versions beside them (``kernels/ref.py``) that run for CPU tensors.
Importing this package imports nothing heavy.
"""
