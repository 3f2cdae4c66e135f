"""GraphCage on PyTorch + CUDA: the port of the ``repro`` JAX package to an
NVIDIA H100.

It mirrors ``repro``'s layout (``core/``, ``kernels/``, ``obs/``) and public
names, imports neither ``jax`` nor ``repro``, and places data on the card
unless a caller passes ``device="cpu"``.
"""
