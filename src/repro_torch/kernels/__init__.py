"""Kernels of the serving path: hand-written CUDA C++ in ``csrc/`` behind
thin wrappers, with plain PyTorch versions in ``ref.py``.  Importing this
package builds nothing and imports no compiler."""
