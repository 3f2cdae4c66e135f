"""Multi-pod dry-run of the port: trace every (arch × shape × mesh) cell on
meta tensors and count its roofline terms, on any host, without a card.

The reference sets ``XLA_FLAGS`` for 512 host devices, then lowers and
compiles each cell.  The port opens a ``"fake"`` process group instead
(``FakeStore``: 256 ranks, or 512 with ``--multi-pod``), builds the
production mesh on it (``launch/mesh.py``: ``(32, 8)`` over ("data",
"model"), ``(2, 32, 8)`` with "pod"; named ``h100x32x8`` and
``h100x2x32x8``), places the cell's meta arguments on it
(``launch/cells.py``) and runs the step once under
``launch.hlo_analysis.CountingMode``, as rank 0.  The collectives run on
the fake group, which moves nothing.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Per cell this writes ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
with the reference's keys, except: ``trace_s`` (the time to build and run
the cell on meta) takes the place of ``lower_s`` and ``compile_s``,
``peak_bytes_per_device`` (live local storages during the step, on top of
the arguments; see ``CountingMode``) that of ``memory_analysis``, and
``ops`` (ops dispatched on rank 0) that of ``hlo_ops``.  FLOPs count the
plain attention and decode routes (the meta tensors' route), the masked
half of a causal score matrix included; ``flops_by_scope`` says how much.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

#: the port's mesh names (the reference's pod16x16 / pod2x16x16 are TPU
#: tori; these are H100 pods of HGX nodes)
MESH_NAMES = {False: "h100x32x8", True: "h100x2x32x8"}


@contextlib.contextmanager
def fake_world(world: int):
    """A ``"fake"`` process group of ``world`` ranks (this process rank 0)
    for the block; an open group of that size is used as it is."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is open; the dry-run wants {world}")
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _world(multi_pod: bool) -> int:
    from repro_torch.launch.mesh import POD_CHIPS
    return POD_CHIPS * (2 if multi_pod else 1)


def run_cell(arch_id: str, shape_name: str, multi_pod: bool = False,
             out_dir: str = OUT_DIR, save_hlo: bool = False) -> dict:
    """Build and count one cell on the production mesh; writes and
    returns its record.  ``save_hlo`` writes the cell's collectives
    (kind, bytes, group size, axes; the port's counterpart of the HLO
    text) beside it."""
    from repro_torch.dist.sharding import use_mesh_rules
    from repro_torch.launch.cells import arg_bytes_per_device, build_cell
    from repro_torch.launch.hlo_analysis import roofline_terms, run_counted
    from repro_torch.launch.mesh import make_production_mesh

    mesh_name = MESH_NAMES[bool(multi_pod)]
    t0 = time.time()
    rec = dict(arch=arch_id, shape=shape_name, mesh=mesh_name,
               num_devices=_world(multi_pod), ok=False)
    try:
        with fake_world(_world(multi_pod)):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cuda")
            n_dev = mesh.size()
            with use_mesh_rules(mesh):
                cell = build_cell(arch_id, shape_name, mesh)
                rec["description"] = cell.description
                rec["model_flops"] = cell.model_flops
                count = run_counted(cell.fn, cell.args, mesh)
            t_trace = time.time() - t0
            coll = count.collectives()
            rl = roofline_terms(count.flops * n_dev, count.bytes * n_dev,
                                coll, n_dev, model_flops=cell.model_flops)
            rec.update(
                ok=True,
                trace_s=round(t_trace, 2),
                flops_per_device=float(count.flops),
                bytes_per_device=float(count.bytes),
                arg_bytes_per_device=arg_bytes_per_device(cell.args, n_dev),
                peak_bytes_per_device=float(count.peak_bytes),
                flops_by_scope={k: float(v) for k, v in
                                count.flops_by_scope.items()},
                ops=count.ops,
                **rl,
            )
            if save_hlo:
                os.makedirs(out_dir, exist_ok=True)
                with open(os.path.join(
                        out_dir, f"{arch_id}__{shape_name}__{mesh_name}"
                                 ".collectives.json"), "w") as f:
                    json.dump(count.records, f)
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 2)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch_id}__{shape_name}__{mesh_name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="also write each cell's collectives")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    with fake_world(_world(args.multi_pod)):
        from repro_torch.configs import all_cells, get_arch

        cells = []
        if args.all:
            for arch_id, cell, _ in all_cells():
                cells.append((arch_id, cell.name))
        else:
            if not (args.arch and args.shape):
                ap.error("--arch/--shape or --all")
            cells = [(args.arch, args.shape)]

        n_ok = 0
        for arch_id, shape_name in cells:
            spec = get_arch(arch_id)
            if shape_name in spec.skip_shapes:
                print(f"SKIP {arch_id} × {shape_name} (the arch's "
                      "skip_shapes)")
                continue
            rec = run_cell(arch_id, shape_name, args.multi_pod, args.out,
                           args.save_hlo)
            if rec["ok"]:
                n_ok += 1
                print(f"OK   {arch_id} × {shape_name} [{rec['mesh']}] "
                      f"trace={rec['trace_s']}s "
                      f"dom={rec['dominant']} "
                      f"bound={rec['bound_seconds']:.3e}s "
                      f"args/dev={rec['arg_bytes_per_device']/2**30:.2f}GiB",
                      flush=True)
            else:
                print(f"FAIL {arch_id} × {shape_name} [{rec['mesh']}]: "
                      f"{rec['error']}", flush=True)
        print(f"\n{n_ok}/{len(cells)} cells traced")


if __name__ == "__main__":
    main()
