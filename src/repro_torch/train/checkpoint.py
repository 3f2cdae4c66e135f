"""Checkpointing of the port: atomic, async, keep-k, in the reference's
on-disk format (``train/checkpoint.py``), so that a checkpoint of a plain
dict/list tree written by either package restores in the other, bit for
bit.

Layout per step::

    <dir>/step_00000042/
        manifest.json      # paths, shapes, dtypes, per-leaf crc32, step, extra
        arrays.npz         # leaf_0 .. leaf_{n-1}, in the tree's leaf order
    <dir>/LATEST           # atomic pointer file

Leaves are taken in JAX's pytree order (dict keys sorted; :mod:`.tree`) and
named by ``jax.tree_util.keystr`` paths (``['layers'][0]['w']``).  bf16 and
fp8 leaves are stored as a ``uint8`` view with a trailing byte axis, as the
reference stores them.  Writes go to ``step_X.tmp`` then ``os.replace``: a
crash mid-write never corrupts the LATEST checkpoint.  Every leaf's crc32
(of the stored bytes) is in the manifest; :func:`latest_step` and
:func:`restore` skip a step with a missing file, an unparsable manifest or
a checksum mismatch.  Save and restore retry transient faults
(:data:`IO_POLICY`, the chaos sites ``ckpt.save`` / ``ckpt.restore``)
through the port's :mod:`repro_torch.resilience`.  :func:`restore` places
each leaf on the device of the matching leaf of the target tree, or, with
``shardings=``, onto a ``DeviceMesh`` (the elastic restore onto a mesh of
another size).

On several ranks (``torch.distributed`` initialised, world size > 1) a
save is collective: every rank calls it, each DTensor leaf is gathered to
its full tensor, rank 0 alone writes, and every rank waits on a barrier
before the step counts as written; the format on disk is the same.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.dist.elastic import is_pair, place, spec_leaves
from repro_torch.dist.sharding import current_mesh
from repro_torch.obs.metrics import registry as _obs
from repro_torch.resilience import chaos as _chaos
from repro_torch.resilience.retry import Policy

from .tree import tree_leaves, tree_paths, tree_unflatten

__all__ = [
    "save", "restore", "latest_step", "valid_steps", "CheckpointError",
    "CheckpointManager", "IO_POLICY",
]


class CheckpointError(RuntimeError):
    """A checkpoint step exists but failed validation (torn write, checksum
    mismatch, unparsable manifest)."""


#: retry policy for checkpoint IO: transient faults (disk hiccups, injected
#: chaos) get three attempts with a short backoff before surfacing.
IO_POLICY = Policy(max_attempts=3, base_delay=0.05,
                   retry_on=(OSError, _chaos.ChaosError))

#: dtypes numpy cannot hold: stored as raw bytes, named as ml_dtypes names
#: them (what the reference's manifests say)
_EXOTIC = {"bfloat16": torch.bfloat16,
           "float8_e4m3fn": torch.float8_e4m3fn,
           "float8_e5m2": torch.float8_e5m2}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(x) -> np.ndarray:
    """A leaf as the array the reference would store (before the exotic
    byte view): a tensor's values on the host, bf16/fp8 as uint8 bytes."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if isinstance(x, DTensor):
        x = x.full_tensor()  # collective: every rank of its mesh calls it
    t = x.detach().to("cpu", copy=True).contiguous()  # a snapshot
    if _dtype_name(t) in _EXOTIC:
        return t.view(torch.uint8).numpy().reshape(
            tuple(t.shape) + (t.element_size(),))
    return t.numpy()


def _leaf_crc(a: np.ndarray) -> int:
    """crc32 of a *storable* leaf's bytes (what actually hits disk)."""
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _multi_rank() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of several, or the
    only one."""
    return not _multi_rank() or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[dict] = None) -> str:
    """Write ``tree`` as step ``step``; the step's directory.  Collective
    on several ranks (rank 0 writes, all wait on a barrier)."""
    snapshot = _snapshot(tree)
    final = _write(ckpt_dir, step, snapshot, extra) if _writes() else \
        _step_dir(ckpt_dir, step)
    if _multi_rank():
        dist.barrier()
    return final


def _snapshot(tree) -> tuple:
    """(paths, host arrays as stored, shapes, dtype names) of ``tree``."""
    leaves = tree_leaves(tree)
    host = [_to_host(x) for x in leaves]
    tensor = [isinstance(x, torch.Tensor) for x in leaves]
    dtypes = [_dtype_name(x) if t else str(a.dtype)
              for x, a, t in zip(leaves, host, tensor)]
    shapes = [list(x.shape if t else a.shape)
              for x, a, t in zip(leaves, host, tensor)]
    return tree_paths(tree), host, shapes, dtypes


def _write(ckpt_dir: str, step: int, snapshot: tuple,
           extra: Optional[dict]) -> str:
    return IO_POLICY.call(_save_once, ckpt_dir, step, snapshot, extra,
                          site="ckpt.save")


def _save_once(ckpt_dir: str, step: int, snapshot: tuple,
               extra: Optional[dict]) -> str:
    _chaos.maybe_raise("ckpt.save")
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    paths, host, shapes, dtypes = snapshot
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": a for i, a in enumerate(host)})
    manifest = {
        "step": step,
        "paths": paths,
        "shapes": shapes,
        "dtypes": dtypes,
        "checksums": [_leaf_crc(a) for a in host],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic commit
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(str(step))
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def _validate_step(ckpt_dir: str, step: int) -> Optional[str]:
    """None if the step directory is a loadable checkpoint, else the reason
    it isn't (``"partial"`` / ``"manifest"`` / ``"arrays"`` /
    ``"checksum"``)."""
    d = _step_dir(ckpt_dir, step)
    mpath = os.path.join(d, "manifest.json")
    apath = os.path.join(d, "arrays.npz")
    if not (os.path.isfile(mpath) and os.path.isfile(apath)):
        return "partial"
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        n_leaves = len(manifest["paths"])
        sums = manifest.get("checksums")
    except (OSError, ValueError, KeyError, TypeError):
        return "manifest"
    try:
        with np.load(apath) as data:
            for i in range(n_leaves):
                a = data[f"leaf_{i}"]
                if sums is not None and _leaf_crc(a) != int(sums[i]):
                    return "checksum"
    except Exception:
        return "arrays"
    return None


def valid_steps(ckpt_dir: str) -> list:
    """All steps on disk that pass validation, ascending."""
    return [s for s in _list_steps(ckpt_dir)
            if _validate_step(ckpt_dir, s) is None]


def _list_steps(ckpt_dir: str) -> list:
    try:
        names = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return []
    steps = []
    for nm in names:
        if nm.startswith("step_") and not nm.endswith(".tmp"):
            try:
                steps.append(int(nm.split("_")[1]))
            except ValueError:
                pass
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest *valid* step: the LATEST pointer if it checks out, else the
    newest on-disk step that does.  Invalid candidates (torn writes,
    checksum failures) are skipped with a ``ckpt.skipped`` counter."""
    candidates = []
    p = os.path.join(ckpt_dir, "LATEST")
    if os.path.exists(p):
        try:
            with open(p) as f:
                candidates.append(int(f.read().strip()))
        except (OSError, ValueError):
            pass
    for s in reversed(_list_steps(ckpt_dir)):
        if s not in candidates:
            candidates.append(s)
    for s in candidates:
        reason = _validate_step(ckpt_dir, s)
        if reason is None:
            return s
        _obs.counter(
            "ckpt.skipped", "checkpoint steps skipped as invalid on load"
        ).inc(1, reason=reason)
    return None


def restore(ckpt_dir: str, target: Any, step: Optional[int] = None,
            shardings: Any = None) -> tuple:
    """Restore into the structure of ``target`` → (tree, step, extra).
    Each leaf keeps its stored dtype and goes to the device of ``target``'s
    leaf in its place (a DTensor target leaf: its mesh and placements).

    ``shardings`` re-places the leaves onto a mesh: a tree matching
    ``target`` of ``(DeviceMesh, placements)`` pairs, or of logical-axis
    tuples resolved against the mesh of ``use_mesh_rules``, or a single
    one for every leaf — the elastic restore onto a mesh of another size.

    With ``step=None`` the newest *valid* checkpoint is loaded — partial or
    checksum-failing steps are skipped.  An explicit ``step`` is validated
    and raises :class:`CheckpointError` if it doesn't check out."""
    return IO_POLICY.call(_restore_once, ckpt_dir, target, step, shardings,
                          site="ckpt.restore")


def _from_stored(a: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype in _EXOTIC:
        return torch.from_numpy(np.ascontiguousarray(a).reshape(-1)).view(
            _EXOTIC[dtype]).reshape(tuple(shape))
    return torch.from_numpy(np.ascontiguousarray(a)).reshape(tuple(shape))


def _reshard(t: torch.Tensor, tgt, spec):
    """A restored leaf placed as ``spec`` says, else as ``tgt`` is."""
    if spec is None and isinstance(tgt, DTensor):
        spec = (tgt.device_mesh, tgt.placements)
    if spec is None:
        return t.to(tgt.device if isinstance(tgt, torch.Tensor) else "cpu")
    mesh = spec[0] if is_pair(spec) else current_mesh()
    if mesh is None:
        raise ValueError(f"shardings {spec}: logical axes need a mesh "
                         "installed by use_mesh_rules")
    return place(t, mesh, spec)


def _restore_once(ckpt_dir: str, target: Any, step: Optional[int],
                  shardings: Any) -> tuple:
    _chaos.maybe_raise("ckpt.restore")
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint in {ckpt_dir}")
    else:
        reason = _validate_step(ckpt_dir, step)
        if reason is not None:
            raise CheckpointError(
                f"checkpoint step {step} in {ckpt_dir} failed validation "
                f"({reason})")
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    targets = tree_leaves(target)
    n = len(manifest["paths"])
    if len(targets) != n:
        raise ValueError(f"checkpoint has {n} leaves, target expects "
                         f"{len(targets)}")
    specs = [None] * n if shardings is None else spec_leaves(shardings, n)
    leaves = []
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for i, (tgt, spec) in enumerate(zip(targets, specs)):
            t = _from_stored(data[f"leaf_{i}"], manifest["dtypes"][i],
                             manifest["shapes"][i])
            leaves.append(_reshard(t, tgt, spec))
    return tree_unflatten(target, leaves), step, manifest["extra"]


class CheckpointManager:
    """Async writer with keep-k GC and crash-safe commits.

    A failure on the background writer thread is recorded and re-raised on
    the next :meth:`save` / :meth:`wait` / :meth:`restore` call — async
    write errors are surfaced, never swallowed."""

    def __init__(self, ckpt_dir: str, keep: int = 3, async_write: bool = True):
        self.dir = ckpt_dir
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        """Join the writer; on several ranks every rank then waits on a
        barrier, so no rank reads a step rank 0 has not finished."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _multi_rank():
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _do_save(self, step, snapshot, extra):
        try:
            _write(self.dir, step, snapshot, extra)
            self._gc()
        except BaseException as e:  # surfaced on next wait()
            _obs.counter(
                "ckpt.async_errors", "failures on the async checkpoint writer"
            ).inc(1, error=type(e).__name__)
            self._error = e

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        # the copy to the host happens here (a consistent snapshot, the
        # DTensors gathered on every rank); rank 0's disk write overlaps
        # the next training steps
        snapshot = _snapshot(tree)
        if not _writes():
            return
        if self.async_write:
            self._thread = threading.Thread(
                target=self._do_save, args=(step, snapshot, extra),
                daemon=True)
            self._thread.start()
        else:
            self._do_save(step, snapshot, extra)

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore(self, target, shardings=None):
        self.wait()
        return restore(self.dir, target, shardings=shardings)

