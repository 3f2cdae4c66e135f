"""Persistent tuning database: schema-versioned JSON under
``experiments/tune/`` plus an in-process plan cache.

One file (``TUNE_DB.json``) holds every tuned entry, keyed by
``graph-fingerprint / device-kind / dtype / workload`` — the same identity
axes XLA's autotuning cache uses; the device half is the card's name
(``nvidia-h100-80gb-hbm3``) or ``cpu``, so the port's plans never collide
with the reference's TPU entries, and one file can hold both packages'
entries (the schema is the reference's).  Writes go through
:func:`repro_torch.obs.export.write_json` (atomic replace) and carry the
run fingerprint, so a cached DB can be told apart from one tuned on
different hardware.

The DB is a *cache, not a source of truth* — so IO hardening is allowed to
be lossy in one direction only: a file that can't be parsed (corrupt JSON,
wrong schema) is **quarantined** to ``TUNE_DB.json.corrupt-<ts>`` and the
DB rebuilt empty (``tune.db_recovered{reason}`` counter); a *transient*
read fault (disk hiccup, injected chaos) is retried and, on exhaustion,
served as an empty DB for that call — the on-disk file is left untouched
so good data is never destroyed by a passing fault.  A separate top-level
``poisoned`` table records tuner candidates that crashed or timed out, so
later sweeps skip them (:func:`mark_poisoned` / :func:`poisoned_for`).
"""
from __future__ import annotations

import os
import time
from typing import Optional

import torch

from repro_torch.obs import export as obs_export
from repro_torch.obs.metrics import registry as _obs
from repro_torch.resilience import chaos as _chaos
from repro_torch.resilience.retry import Policy

__all__ = [
    "DB_SCHEMA",
    "DB_FILENAME",
    "default_dir",
    "db_path",
    "device_key",
    "entry_key",
    "load",
    "save",
    "get_entry",
    "put_entry",
    "mark_poisoned",
    "poisoned_for",
    "clear_cache",
]

#: retry policy for DB IO — transient faults only; parse errors are not
#: retried (they quarantine instead).
IO_POLICY = Policy(max_attempts=3, base_delay=0.02,
                   retry_on=(OSError, _chaos.ChaosError))

#: bump on any incompatible change to the TUNE_DB.json layout
DB_SCHEMA = "repro.tune.db/v1"
DB_FILENAME = "TUNE_DB.json"

# (abspath -> (mtime, db dict)) — the in-process cache; schedule="auto"
# resolution must not re-read the file per engine call.
_CACHE: dict = {}


def default_dir() -> str:
    """DB directory: ``$REPRO_TUNE_DIR`` or ``experiments/tune`` (cwd)."""
    return os.environ.get("REPRO_TUNE_DIR") or os.path.join(
        "experiments", "tune")


def db_path(db_dir: Optional[str] = None) -> str:
    return os.path.join(db_dir or default_dir(), DB_FILENAME)


def device_key(device=None) -> str:
    """Device identity half of the entry key: the name of the card
    ``device`` names (the card by default), spaces sanitized —
    ``torch.cuda.get_device_name`` "NVIDIA H100 80GB HBM3" becomes
    ``nvidia-h100-80gb-hbm3`` — or ``cpu`` for the host (the reference's
    key on its CPU backend)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev.type
    kind = torch.cuda.get_device_name(dev)
    return str(kind).strip().replace(" ", "-").lower()


def entry_key(graph_fp: str, device: Optional[str] = None,
              dtype: str = "float32", workload: str = "pagerank") -> str:
    """``fingerprint/device/dtype/workload``; ``device`` is a
    :func:`device_key` string (the card's by default)."""
    return f"{graph_fp}/{device or device_key()}/{dtype}/{workload}"


def _empty() -> dict:
    """The DB a read returns when there is none to read: no run
    fingerprint (taking one starts ``nvidia-smi``, too slow for the
    engine's ``"auto"`` lookup); :func:`save` stamps it."""
    return {"schema": DB_SCHEMA, "entries": {}}


def _mtime(path: str) -> int:
    try:
        return os.stat(path).st_mtime_ns
    except OSError:
        return -1


def _quarantine(path: str, reason: str) -> Optional[str]:
    """Move an unusable DB file aside and count the recovery.  Returns the
    quarantine path (None if the move itself failed)."""
    qpath = f"{path}.corrupt-{int(time.time())}"
    try:
        os.replace(path, qpath)
    except OSError:
        qpath = None
    _CACHE.pop(path, None)
    _obs.counter(
        "tune.db_recovered",
        "tuning-db files recovered by quarantine-and-rebuild",
    ).inc(reason=reason)
    return qpath


def _read(path: str) -> dict:
    _chaos.maybe_raise("tune.db_load")
    return obs_export.read_json(path)


def load(path: Optional[str] = None, use_cache: bool = True) -> dict:
    """Read the DB (empty shell if the file doesn't exist).  Cached by
    (path, mtime): touching the file invalidates, in-process writers update
    the cache themselves via :func:`save`.

    Never raises on a bad file: corrupt JSON or a wrong schema quarantines
    the file (``TUNE_DB.json.corrupt-<ts>``) and returns an empty DB; a
    transient read fault is retried and on exhaustion returns an empty DB
    *without* touching the file."""
    path = os.path.abspath(path or db_path())
    mtime = _mtime(path)
    if use_cache:
        hit = _CACHE.get(path)
        if hit is not None and hit[0] == mtime:
            _obs.counter("tune.db_reads", "tuning-db loads").inc(source="cache")
            return hit[1]
    if mtime == -1:
        return _empty()
    try:
        db = IO_POLICY.call(_read, path, site="tune.db_load")
    except (OSError, _chaos.ChaosError):
        # Transient IO exhausted its retries: the file may be fine — serve
        # empty for this call, leave the data alone.
        _obs.counter(
            "tune.db_recovered",
            "tuning-db files recovered by quarantine-and-rebuild",
        ).inc(reason="io")
        return _empty()
    except ValueError:  # unparsable JSON — genuinely corrupt
        _quarantine(path, "corrupt")
        return _empty()
    if not isinstance(db, dict) or db.get("schema") != DB_SCHEMA:
        _quarantine(path, "schema")
        return _empty()
    _CACHE[path] = (mtime, db)
    _obs.counter("tune.db_reads", "tuning-db loads").inc(source="disk")
    return db


def _write(path: str, db: dict):
    _chaos.maybe_raise("tune.db_save")
    obs_export.write_json(path, db)


def save(db: dict, path: Optional[str] = None) -> str:
    """Write ``db`` (stamped with the run fingerprint on its first save)
    and refresh the in-process cache."""
    path = os.path.abspath(path or db_path())
    if "fingerprint" not in db:
        db = {**obs_export.versioned_payload(DB_SCHEMA, "tune_db"), **db}
    IO_POLICY.call(_write, path, db, site="tune.db_save")
    _CACHE[path] = (_mtime(path), db)
    _obs.counter("tune.db_writes", "tuning-db saves").inc()
    return path


def get_entry(key: str, path: Optional[str] = None) -> Optional[dict]:
    return load(path).get("entries", {}).get(key)


def _save_best_effort(db: dict, path: str):
    """Persist, degrading to the in-process cache when the disk write fails
    (retries exhausted) — callers in a sweep keep seeing the new data and
    the next successful save flushes it."""
    try:
        save(db, path)
    except Exception as e:
        _CACHE[path] = (_mtime(path), db)
        _obs.counter(
            "tune.db_save_failed",
            "tuning-db saves degraded to in-process cache only",
        ).inc(error=type(e).__name__)


def put_entry(key: str, entry: dict, path: Optional[str] = None,
              persist: bool = True) -> dict:
    """Insert/replace one entry (stamped with key + creation time) and, by
    default, persist immediately — a crashed sweep keeps finished work.
    A failed disk write degrades to the in-process cache (counted) rather
    than aborting the sweep."""
    path = os.path.abspath(path or db_path())
    db = load(path)
    entry = dict(entry, key=key, created=entry.get("created") or time.time())
    db.setdefault("entries", {})[key] = entry
    if persist:
        _save_best_effort(db, path)
    return entry


def mark_poisoned(key: str, cand_key: str, error: str,
                  path: Optional[str] = None) -> dict:
    """Record a tuner candidate that crashed or timed out for ``key`` so
    later sweeps skip it without re-running the failure."""
    path = os.path.abspath(path or db_path())
    db = load(path)
    rec = {"error": error, "ts": time.time()}
    db.setdefault("poisoned", {}).setdefault(key, {})[cand_key] = rec
    _save_best_effort(db, path)
    _obs.counter(
        "tune.poisoned", "tuner candidates marked poisoned"
    ).inc(key=key)
    return rec


def poisoned_for(key: str, path: Optional[str] = None) -> dict:
    """``{candidate key -> record}`` of poisoned candidates for ``key``."""
    return load(path).get("poisoned", {}).get(key, {})


def clear_cache():
    """Drop the in-process DB cache (tests / cross-process refresh)."""
    _CACHE.clear()
