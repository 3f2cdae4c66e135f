"""Synthetic data of the port: the reference's generators, on the same
numpy streams, returning torch tensors."""
