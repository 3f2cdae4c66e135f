"""The port's synthetic LM token stream (``repro_torch.data.tokens``)
equals the reference's ``repro.data.tokens`` array for array: the same
numpy calls in the same order, returned as torch tensors."""
import itertools

import numpy as np
import pytest
import torch

from repro.data.tokens import synthetic_lm_batches as r_batches
from repro_torch.data.tokens import synthetic_lm_batches


@pytest.mark.parametrize("grad_accum", [0, 2])
@pytest.mark.parametrize("vocab", [512, 49155])
def test_batches_equal_reference(grad_accum, vocab):
    ours = synthetic_lm_batches(3, 17, vocab, seed=5, grad_accum=grad_accum,
                                device="cpu")
    ref = r_batches(3, 17, vocab, seed=5, grad_accum=grad_accum)
    lead = (grad_accum, 3) if grad_accum else (3,)
    for mine, theirs in itertools.islice(zip(ours, ref), 3):
        assert set(mine) == set(theirs) == {"tokens"}
        t = mine["tokens"]
        assert t.device == torch.device("cpu") and t.dtype == torch.int32
        assert tuple(t.shape) == lead + (18,)
        assert np.array_equal(t.numpy(), theirs["tokens"])
        assert int(t.min()) >= 0 and int(t.max()) < vocab


def test_seed_changes_the_stream():
    a = next(synthetic_lm_batches(2, 8, 512, seed=0, device="cpu"))
    b = next(synthetic_lm_batches(2, 8, 512, seed=1, device="cpu"))
    assert not torch.equal(a["tokens"], b["tokens"])
