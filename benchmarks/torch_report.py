"""Render the port's dry-run, roofline and paper-figure tables from its
artifacts: ``experiments/dryrun_torch/``, ``experiments/roofline_torch/``
and the ``BENCH_*.json`` under ``experiments/bench`` (through
``repro_torch.obs.report.render``).  Run after the sweeps:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    PYTHONPATH=src python benchmarks/torch_roofline.py
    PYTHONPATH=src python benchmarks/torch_report.py

Every number in these tables is a count on meta tensors (FLOPs, bytes,
collectives, live bytes) or the datasheet arithmetic on it, not a time.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(d: str, root: str = ROOT) -> list:
    recs = []
    p = os.path.join(root, "experiments", d)
    if not os.path.isdir(p):
        return recs
    for f in sorted(os.listdir(p)):
        if f.endswith(".json") and not f.endswith(".collectives.json"):
            with open(os.path.join(p, f)) as fh:
                recs.append(json.load(fh))
    return recs


def _fmt(x, digits=3):
    return f"{x:.{digits}e}" if isinstance(x, float) else str(x)


def _pair(recs, key, fmt) -> str:
    """``key`` of each mesh's record as ``a / b``, one value when equal."""
    vals = [fmt(r[key]) for r in recs]
    return vals[0] if len(set(vals)) == 1 else " / ".join(vals)


def _gib(v) -> str:
    return f"{v / 2**30:.3g}"


def dryrun_table(root: str = ROOT) -> str:
    """One row an arch, one cell a shape, the meshes' numbers as ``a / b``
    (``h100x32x8`` / ``h100x2x32x8``): the dominant term, its bound (s),
    the args and the peak a rank (GiB) and the useful FLOP fraction."""
    recs = _load("dryrun_torch", root)
    meshes = sorted({r["mesh"] for r in recs}, key=len)
    by_arch: dict = {}
    for r in recs:
        by_arch.setdefault(r["arch"], {}).setdefault(r["shape"], {})[
            r["mesh"]] = r
    width = max((len(v) for v in by_arch.values()), default=0)
    head = "shape: " + " / ".join(meshes)
    lines = [f"| arch | {' | '.join([head] * width)} |",
             "|---|" + "---|" * width]
    for arch, shapes in sorted(by_arch.items()):
        cols = []
        for shape, row in sorted(shapes.items()):
            got = [row[m] for m in meshes if m in row]
            bad = [r for r in got if not r.get("ok")]
            if bad or len(got) < len(meshes):
                err = bad[0].get("error", "?") if bad else "missing"
                cols.append(f"**{shape}** FAIL: {err}")
                continue
            cols.append(
                f"**{shape}** {_pair(got, 'dominant', str)} "
                f"{_pair(got, 'bound_seconds', lambda v: f'{v:.3g}')} s; "
                f"args {_pair(got, 'arg_bytes_per_device', _gib)}, "
                f"peak {_pair(got, 'peak_bytes_per_device', _gib)} GiB; "
                f"useful {_pair(got, 'useful_flop_frac', lambda v: f'{v:.3f}')}")
        cols += [""] * (width - len(cols))
        lines.append(f"| {arch} | " + " | ".join(cols) + " |")
    return "\n".join(lines)


def roofline_table(root: str = ROOT) -> str:
    recs = _load("roofline_torch", root)
    lines = ["| arch | shape | T_compute (s) | T_memory (s) | T_collective (s)"
             " | dominant | MODEL_FLOPs | useful frac | roofline frac |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt(r['t_compute'])} | "
            f"{_fmt(r['t_memory'])} | {_fmt(r['t_collective'])} | "
            f"**{r['dominant']}** | {_fmt(r.get('model_flops', 0.0))} | "
            f"{r.get('useful_flop_frac', 0):.3f} | "
            f"{r.get('roofline_fraction', 0):.4f} |")
    return "\n".join(lines)


def bench_tables(root: str = ROOT) -> str:
    """Every BENCH_*.json under experiments/bench via repro_torch.obs."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.obs.report import render
    p = os.path.join(root, "experiments", "bench")
    if not os.path.isdir(p):
        return ("(no experiments/bench artifacts — run "
                "benchmarks/torch_paper_figs.py first)")
    out = []
    for f in sorted(os.listdir(p)):
        if f.startswith("BENCH_") and f.endswith(".json"):
            with open(os.path.join(p, f)) as fh:
                out.append(render(json.load(fh)))
    return "\n\n".join(out) or "(no BENCH_*.json artifacts)"


def main() -> str:
    text = "\n".join([
        "## Dry-run matrix\n", dryrun_table(),
        "\n## Roofline table (single-pod h100x32x8)\n", roofline_table(),
        "\n## Paper-figure benches\n", bench_tables()])
    print(text)
    return text


if __name__ == "__main__":
    main()
