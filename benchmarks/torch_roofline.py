"""Roofline harness of the port: three-term analysis per (arch × shape) on
the single-pod production mesh (``h100x32x8``), on any host, no card.

Method.  Each cell is built on meta tensors (``repro_torch.launch.cells``)
and its step runs once under ``repro_torch.launch.hlo_analysis``'s
counting mode, rank 0 of a 256-rank fake process group: FLOPs, bytes and
collective wire bytes of one rank, times the ranks.  The reference fits
two unrolled depths because XLA's cost analysis counts a scanned layer
body once; the port's eager step runs every layer, so every cell is
measured at full depth (``tests/test_torch_roofline.py`` shows the count
is linear in depth, the property the fit relied on).  The terms use the
H100 constants of ``hlo_analysis``.

Run:  PYTHONPATH=src python benchmarks/torch_roofline.py [--arch A --shape S]
Writes experiments/roofline_torch/<arch>__<shape>.json + a summary table.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import all_cells  # noqa: E402
from repro_torch.dist.sharding import use_mesh_rules  # noqa: E402
from repro_torch.launch.cells import build_cell  # noqa: E402
from repro_torch.launch.dryrun import _world, fake_world  # noqa: E402
from repro_torch.launch.hlo_analysis import (roofline_terms,  # noqa: E402
                                             run_counted)
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

OUT_DIR = os.path.join(ROOT, "experiments", "roofline_torch")


def _measure(arch_id, shape_name, mesh, overrides=None) -> dict:
    with use_mesh_rules(mesh):
        cell = build_cell(arch_id, shape_name, mesh, overrides=overrides)
        count = run_counted(cell.fn, cell.args, mesh)
    n = mesh.size()
    coll = count.collectives()
    return {
        "flops": float(count.flops) * n,
        "bytes": float(count.bytes) * n,
        "wire": coll.wire_bytes,
        "coll_bytes": coll.total_bytes,
        "counts": coll.counts,
        "coll": coll,
        "model_flops": cell.model_flops,
        "flops_by_scope": {k: float(v) * n
                           for k, v in count.flops_by_scope.items()},
    }


def measure_cell(arch_id: str, shape_name: str, mesh) -> dict:
    """The cell's whole-program counts at full depth (no fit)."""
    return _measure(arch_id, shape_name, mesh)


def analyse(arch_id: str, shape_name: str, mesh=None,
            overrides=None) -> dict:
    if mesh is None:
        mesh = make_production_mesh(device_type="cuda")
    n = mesh.size()
    t0 = time.time()
    m = (measure_cell(arch_id, shape_name, mesh) if overrides is None
         else _measure(arch_id, shape_name, mesh, overrides=overrides))
    rl = roofline_terms(m["flops"], m["bytes"], m["coll"], n,
                        model_flops=m["model_flops"])
    rl.pop("wire_bytes", None)
    return dict(arch=arch_id, shape=shape_name, num_devices=int(n),
                flops_total=m["flops"], bytes_total=m["bytes"],
                wire_bytes=m["wire"], flops_by_scope=m["flops_by_scope"],
                elapsed_s=round(time.time() - t0, 1), **rl)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    with fake_world(_world(False)):
        os.makedirs(args.out, exist_ok=True)
        cells = ([(args.arch, args.shape)] if args.arch else
                 [(a, c.name) for a, c, _ in all_cells()])
        mesh = make_production_mesh(device_type="cuda")
        for arch_id, shape_name in cells:
            try:
                rec = analyse(arch_id, shape_name, mesh)
                path = os.path.join(args.out, f"{arch_id}__{shape_name}.json")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=str)
                print(f"{arch_id:22s} {shape_name:14s} "
                      f"dom={rec['dominant']:10s} "
                      f"T_c={rec['t_compute']:.3e} "
                      f"T_m={rec['t_memory']:.3e} "
                      f"T_x={rec['t_collective']:.3e} "
                      f"roofline={rec.get('roofline_fraction', 0):.3f}",
                      flush=True)
            except Exception as e:
                print(f"{arch_id:22s} {shape_name:14s} FAILED: {e}")


if __name__ == "__main__":
    main()
