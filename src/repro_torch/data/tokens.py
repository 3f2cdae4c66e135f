"""Synthetic LM token stream (the reference's ``data/tokens.py``): tokens
drawn through a fixed bigram table, so the stream has local n-gram
structure and a loss on it decreases.

The numbers come from the same numpy ``Generator`` calls in the same order,
so a batch equals the reference's element for element; it is returned as
torch tensors on ``device`` (the card by default).  With ``mesh=`` (a
``DeviceMesh``) every rank draws the same global batch and keeps its
block of it, split as the rules split ``"batch"`` (over ``("pod",
"data")``): the ranks' blocks, put together in rank order, are the
reference's batch.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.dist.sharding import local_block

__all__ = ["synthetic_lm_batches"]


def synthetic_lm_batches(batch: int, seq_len: int, vocab: int, seed: int = 0,
                         grad_accum: int = 0, device=None,
                         mesh=None) -> Iterator[dict]:
    """Yields ``{"tokens": int32 (B, S+1)}`` (``(A, B, S+1)`` with
    ``grad_accum``) on ``device``; on ``mesh``, this rank's block of the
    batch axis."""
    device = torch.device("cuda") if device is None else torch.device(device)
    rng = np.random.default_rng(seed)
    # fixed bigram table gives the stream learnable structure
    n_ctx = 64
    table = rng.integers(0, vocab, (n_ctx, 8))
    while True:
        shape = (grad_accum, batch) if grad_accum else (batch,)
        state = rng.integers(0, n_ctx, shape)
        toks = np.empty(shape + (seq_len + 1,), np.int32)
        for t in range(seq_len + 1):
            choice = rng.integers(0, 8, shape)
            toks[..., t] = table[state, choice] % vocab
            state = (state * 31 + toks[..., t]) % n_ctx
        out = torch.from_numpy(toks)
        if mesh is not None:
            lead = (None, "batch") if grad_accum else ("batch",)
            out = local_block(out, lead + (None,), mesh)
        yield {"tokens": out.to(device)}
