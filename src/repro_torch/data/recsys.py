"""Synthetic BERT4Rec data: Zipf-popularity item sequences + cloze masking
(the reference's ``data/recsys.py``).

The numbers come from the same numpy ``Generator`` calls in the same order,
so a batch equals the reference's element for element; it is returned as
torch tensors on ``device`` (the card by default).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

__all__ = ["synthetic_recsys_batches", "make_cloze_batch"]


def make_cloze_batch(rng: np.random.Generator, batch: int, seq_len: int,
                     vocab: int, mask_id: int, mask_prob: float = 0.15,
                     step_range: int = 50, device=None) -> dict:
    """``{"items": int32 (B, L) with mask_id at the masked positions,
    "labels": int32 (B, L), "label_mask": fp32 (B, L)}``; the last position
    is always masked (next-item evaluation)."""
    # Zipf-ish popularity with session coherence (random-walk over item
    # space); smaller ``step_range`` → more predictable sessions
    start = rng.zipf(1.3, size=(batch, 1)) % vocab
    steps = rng.integers(-step_range, step_range + 1, (batch, seq_len))
    items = ((start + np.cumsum(steps, axis=1)) % vocab).astype(np.int32)
    mask = rng.random((batch, seq_len)) < mask_prob
    mask[:, -1] = True
    masked = np.where(mask, mask_id, items).astype(np.int32)
    device = torch.device("cuda") if device is None else torch.device(device)
    return {
        "items": torch.from_numpy(masked).to(device),
        "labels": torch.from_numpy(items).to(device),
        "label_mask": torch.from_numpy(mask.astype(np.float32)).to(device),
    }


def synthetic_recsys_batches(batch: int, seq_len: int, vocab: int,
                             mask_id: int, seed: int = 0,
                             mask_prob: float = 0.15, step_range: int = 50,
                             device=None) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    while True:
        yield make_cloze_batch(rng, batch, seq_len, vocab, mask_id,
                               mask_prob, step_range, device=device)
