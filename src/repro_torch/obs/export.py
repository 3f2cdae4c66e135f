"""Exporters: run-metadata fingerprint and schema-versioned JSON/JSONL.

The port's copy of ``repro.obs.export``, with the same payload layout
(``repro.obs.bench/v1``), so ``repro.obs.report`` and
:mod:`repro_torch.obs.report` render and diff the port's artifacts.  The
fingerprint names torch, CUDA and the card (with its power limit, which
sets the card's speed under load) in place of the JAX fields, so a diff
can tell "the code got slower" apart from "the environment changed"."""
from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
from typing import Iterable, Optional

__all__ = [
    "BENCH_SCHEMA",
    "git_sha",
    "power_limit_w",
    "run_fingerprint",
    "versioned_payload",
    "bench_payload",
    "write_json",
    "write_jsonl",
    "read_json",
]

#: bump on any incompatible change to the BENCH_*.json layout
BENCH_SCHEMA = "repro.obs.bench/v1"


def git_sha(root: Optional[str] = None) -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=root or os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10)
        return out.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def power_limit_w() -> Optional[float]:
    """The first card's power limit in watts as ``nvidia-smi`` reports it,
    or None where there is no ``nvidia-smi`` or it says nothing usable."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    try:
        return float(out.stdout.split("\n")[0])
    except ValueError:
        return None


def run_fingerprint() -> dict:
    """Environment identity for artifact provenance."""
    import torch

    cuda = torch.cuda.is_available()
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "power_limit_w": power_limit_w() if cuda else None,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "git_sha": git_sha(),
    }


def versioned_payload(schema: str, name: str, **sections) -> dict:
    """Skeleton of every schema-versioned artifact: schema tag + name +
    environment fingerprint, then the caller's sections (``None``-valued
    sections are dropped)."""
    payload = {"schema": schema, "name": name,
               "fingerprint": run_fingerprint()}
    payload.update((k, v) for k, v in sections.items() if v is not None)
    return payload


def bench_payload(name: str, records: Iterable[dict],
                  metrics: Optional[dict] = None,
                  spans: Optional[list] = None) -> dict:
    """Schema-versioned benchmark artifact.

    ``records`` — the per-measurement rows (name + numeric fields);
    ``metrics`` — a registry snapshot; ``spans`` — trace events."""
    return versioned_payload(BENCH_SCHEMA, name, records=list(records),
                             metrics=metrics, spans=spans)


def write_json(path: str, payload: dict) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, default=str, sort_keys=False)
        f.write("\n")
    os.replace(tmp, path)  # atomic: readers never see a torn artifact
    return path


def write_jsonl(path: str, rows: Iterable[dict]) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r, default=str) + "\n")
    return path


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
