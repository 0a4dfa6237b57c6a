"""Kernels of the serving path and the simulator's sweep: hand-written
CUDA C++ in ``csrc/`` behind thin wrappers, with plain PyTorch versions in
``ref.py``.  Importing this package builds nothing and imports no
compiler."""
