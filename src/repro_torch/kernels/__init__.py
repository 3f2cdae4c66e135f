"""Hand-written Hopper kernels of the port, one package per kernel family:
``ref.py`` (plain PyTorch version), ``kernel.py`` + ``csrc/`` (the CUDA
kernels and their loader), ``ops.py`` (dispatch by device)."""
