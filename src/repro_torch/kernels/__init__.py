"""Hand-written Hopper kernels of the port, one package per kernel family:
``ref.py`` (plain PyTorch version), ``kernel.py`` + ``csrc/`` (the CUDA
kernels and their launchers), ``ops.py`` (dispatch by device).
:mod:`.cuda_build` builds and loads every family's sources and counts the
launches."""
