"""The port's checkpoints (``repro_torch.train.checkpoint``): bitwise round
trips (bf16 included), keep-k with the async writer, torn and bit-rotted
steps skipped, a chaos fault retried, and checkpoints that cross between
the two packages bit for bit (the on-disk format is the reference's)."""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train import checkpoint as R
from repro_torch.obs.metrics import registry
from repro_torch.resilience import chaos
from repro_torch.train import checkpoint as T
from repro_torch.train.tree import tree_leaves, tree_paths


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layers": [{"w": rng.standard_normal((3, 4)).astype(np.float32),
                    "b": rng.standard_normal(4).astype(np.float32)}
                   for _ in range(2)],
        "embed": rng.standard_normal((5, 4)).astype(ml_dtypes.bfloat16),
        "count": np.asarray(7, np.int32),
        "mask": rng.random(6) > 0.5,
    }


def _to_torch(tree):
    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        if isinstance(a, list):
            return [conv(v) for v in a]
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return conv(tree)


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _bits_np(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _assert_bit_equal(port_tree, ref_tree):
    a, b = tree_leaves(port_tree), jax.tree.leaves(ref_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_bits(x), _bits_np(y))


def test_roundtrip_bitwise_with_bf16(tmp_path):
    tree = _to_torch(_np_tree())
    T.save(str(tmp_path), 3, tree, extra={"note": "x"})
    zero = {k: v for k, v in tree.items()}
    zero["embed"] = torch.zeros_like(tree["embed"])
    out, step, extra = T.restore(str(tmp_path), zero)
    assert step == 3 and extra == {"note": "x"}
    for x, y in zip(tree_leaves(out), tree_leaves(tree)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))
    manifest = json.loads((tmp_path / "step_00000003" /
                           "manifest.json").read_text())
    assert manifest["paths"] == tree_paths(tree)
    assert manifest["paths"][0] == "['count']"
    assert "['layers'][0]['b']" in manifest["paths"]
    assert manifest["dtypes"][manifest["paths"].index("['embed']")] == \
        "bfloat16"


def test_paths_match_jax_keystr():
    tree = _np_tree()
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    assert tree_paths(_to_torch(tree)) == [jax.tree_util.keystr(kp)
                                           for kp, _ in flat]


def test_checkpoint_manager_keep_k_and_async(tmp_path):
    mgr = T.CheckpointManager(str(tmp_path), keep=2)
    tree = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": tree["x"] + s})
    mgr.wait()
    assert T.valid_steps(str(tmp_path)) == [3, 4]
    out, step, _ = mgr.restore(tree)
    assert step == 4 and out["x"].tolist() == [4.0] * 3


def test_manager_surfaces_async_errors(tmp_path):
    mgr = T.CheckpointManager(str(tmp_path / "f"), keep=2)
    (tmp_path / "f").write_text("not a directory")
    mgr.save(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        mgr.wait()


def test_torn_and_corrupted_steps_are_skipped(tmp_path):
    d = str(tmp_path)
    tree = {"x": torch.arange(4.0)}
    for s in (1, 2, 3):
        T.save(d, s, {"x": tree["x"] * s})
    # step 3: bit rot in the arrays; step 2: a torn write (no manifest)
    arr = tmp_path / "step_00000003" / "arrays.npz"
    data = dict(np.load(arr))
    data["leaf_0"] = data["leaf_0"] + 1
    np.savez(arr, **data)
    os.remove(tmp_path / "step_00000002" / "manifest.json")
    before = registry.counter("ckpt.skipped").value(reason="checksum")
    assert T.latest_step(d) == 1
    assert registry.counter("ckpt.skipped").value(reason="checksum") == \
        before + 1
    out, step, _ = T.restore(d, tree)
    assert step == 1 and out["x"].tolist() == [0.0, 1.0, 2.0, 3.0]
    with pytest.raises(T.CheckpointError, match="checksum"):
        T.restore(d, tree, step=3)
    # a half-written tmp dir is never a candidate
    shutil.copytree(tmp_path / "step_00000001", tmp_path / "step_00000009.tmp")
    assert T.valid_steps(d) == [1]


def test_chaos_fault_is_retried(tmp_path):
    chaos.reset()
    before = registry.counter("resilience.retries").value(
        site="ckpt.save", error="ChaosError")
    chaos.inject("ckpt.save", times=2)
    chaos.inject("ckpt.restore", times=1)
    try:
        T.save(str(tmp_path), 5, {"x": torch.ones(2)})
        out, step, _ = T.restore(str(tmp_path), {"x": torch.zeros(2)})
    finally:
        chaos.reset()
    assert step == 5 and out["x"].tolist() == [1.0, 1.0]
    assert registry.counter("resilience.retries").value(
        site="ckpt.save", error="ChaosError") == before + 2


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _np_tree(1)
    R.save(str(tmp_path), 11, jax.tree.map(jnp.asarray, tree),
           extra={"by": "reference"})
    out, step, extra = T.restore(str(tmp_path), _to_torch(_np_tree(2)))
    assert step == 11 and extra == {"by": "reference"}
    _assert_bit_equal(out, tree)
    assert out["embed"].dtype == torch.bfloat16
    assert out["count"].dtype == torch.int32 and out["mask"].dtype == \
        torch.bool


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _np_tree(3)
    T.save(str(tmp_path), 12, _to_torch(tree), extra={"by": "port"})
    target = jax.tree.map(jnp.asarray, _np_tree(4))
    out, step, extra = R.restore(str(tmp_path), target)
    assert step == 12 and extra == {"by": "port"}
    _assert_bit_equal(_to_torch(jax.tree.map(np.asarray, out)), tree)
    # and the reference's validation reads the port's checksums
    assert R.valid_steps(str(tmp_path)) == [12]


def test_restore_places_leaves_on_the_target_device(tmp_path):
    T.save(str(tmp_path), 1, {"x": torch.ones(2)})
    out, _, _ = T.restore(str(tmp_path), {"x": torch.zeros(2,
                                                           device="meta")})
    assert out["x"].device.type == "meta"
    with pytest.raises(ValueError, match="leaves"):
        T.restore(str(tmp_path), {"x": torch.zeros(2), "y": torch.zeros(1)})


def test_python_scalars_round_trip(tmp_path):
    """A leaf that is no tensor (a step count kept as a Python int) is
    stored as numpy stores it and comes back as a tensor."""
    T.save(str(tmp_path), 2, {"step": 7, "x": torch.ones(2)})
    out, _, _ = T.restore(str(tmp_path), {"step": 0, "x": torch.zeros(2)})
    assert int(out["step"]) == 7 and out["x"].tolist() == [1.0, 1.0]
