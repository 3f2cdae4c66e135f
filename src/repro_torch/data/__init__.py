"""Synthetic data of the port: the reference's generators, on the same
numpy streams, returning torch tensors (tokens, recsys cloze batches,
graphs and the neighbour sampler)."""
