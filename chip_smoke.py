#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of GraphCage (``src/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure raises and the script exits non-zero:

1. Print the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and build the CUDA kernels from ``src/`` (``nvcc``, seconds).
2. Kernel vs plain: ``fused_pull`` / ``fused_push`` CUDA kernels against
   their plain PyTorch versions on the card, on ``rmat_graph(18, 16)``, for
   every semiring, ``(n,)`` and ``(n, 8)`` values, weighted and unweighted,
   with and without the epilogue, on two block sizes (the shared-memory and
   the global-memory push paths).
3. Main path: a Graph500 Kronecker graph (``rmat_graph(24, 16, seed=1,
   weights=True)``: 16.8 M vertices, ranks larger than the 50 MB L2) →
   ``build_blocked`` pull and push on the card → PageRank ``base``,
   ``gc-pull`` / ``gc-push`` fused, ``gc-pull`` slab to ``tol=1e-6``, and
   SpMV ``gc-pull`` fused with ``scale=``; the fused results are checked
   against the flat ``base`` path, and the kernels' launch counts against
   zero.
4. Each kernel timed at the main path's shapes beside its plain version,
   its byte bound and a ``torch.sparse`` CSR product of the same matrix.

Output: one JSON record per line; the last two lines are the kernels'
record and ``{"ok": true, "device": {...}}``.  ``--log PATH`` appends the
detail (each case's error, the compiler's register report) to PATH.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet) for the bounds: HBM3 bytes/s and
#: fp32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

#: sum tolerance, kernel vs plain: both add fp32 terms in different orders
#: (atomics vs index_add_).  For positive terms the rounding error of a
#: k-term sum in random order grows like √k·2⁻²⁴ of the sum: 1.3e-5 at
#: k = 5·10⁴, past the largest in-degree of these graphs' typical rows.
SUM_RTOL = 1e-4
#: the absolute part scales with the data: one fp32 ulp (2⁻²³) of the mean
#: |entry|.  A fixed atol would swamp PageRank's outputs, which are ~1/n
#: (6e-8 at scale 24), and let a kernel that is wrong on most rows pass.
SUM_ATOL_ULPS_OF_MEAN = 2.0 ** -23

#: PageRank: the fused runs follow base's iterates up to fp32 summation
#: order, and may stop one iteration apart (±1), which moves the ranks by
#: less than tol = 1e-6 in L1.  The H100 runs of this script read 2.9e-7 to
#: 4.4e-7; 5e-6 is about 10× the worst of them.
PR_L1_TOL = 5e-6

#: R-MAT scale of the main path's graph: Graph500 scale 24, whose 67 MB of
#: ranks exceed the H100's 50 MB L2, the regime the blocking is for
SCALE = 24

#: seed of every graph and input the script makes (numpy / torch streams)
SEED = 1

REPLACES = {
    "fused_pull": "src/repro/kernels/tocab_fused/kernel.py:137",
    "fused_push": "src/repro/kernels/tocab_fused/kernel.py:247",
}


def emit(record: dict):
    print(json.dumps(record), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# --------------------------------------------------------------------- #
# phase 2: kernels vs plain versions
# --------------------------------------------------------------------- #
def sum_atol(ref) -> float:
    """Absolute part of the sum tolerance for reference output ``ref``."""
    finite = ref[ref.isfinite()]
    return SUM_ATOL_ULPS_OF_MEAN * float(finite.abs().mean()) \
        if finite.numel() else 0.0


def check_close(what: str, out, ref, reduce: str):
    """Raise unless ``out`` matches ``ref`` (sum: within ``SUM_RTOL`` and
    ``sum_atol(ref)``; min/max: exactly).  Returns (max abs error, the atol
    used, share of the sum tolerance used by the worst entry)."""
    import torch

    atol = sum_atol(ref) if reduce == "sum" else 0.0
    if reduce == "sum":
        torch.testing.assert_close(out, ref, rtol=SUM_RTOL, atol=atol,
                                   msg=lambda m: f"{what}: {m}")
    elif not torch.equal(out, ref):
        bad = int((out != ref).sum())
        raise AssertionError(f"{what}: {bad} entries differ ({reduce} must "
                             "match exactly)")
    finite = torch.isfinite(ref)
    diff = (out - ref).abs()[finite]
    if not diff.numel():
        return 0.0, atol, 0.0
    bound = atol + SUM_RTOL * ref.abs()[finite]
    used = torch.where(diff == 0, 0.0, diff / bound)
    return float(diff.max()), atol, float(used.max())


def phase_kernels(seed: int, log) -> dict:
    """Every kernel configuration against its plain version; returns the
    largest error seen per kernel."""
    import numpy as np
    import torch

    from repro_torch.core import UNWEIGHTED, build_blocked, rmat_graph
    from repro_torch.kernels.tocab_fused import fused_pull, fused_push
    from repro_torch.kernels.tocab_fused.ref import (fused_pull_ref,
                                                     fused_push_ref)

    t0 = time.perf_counter()
    g = rmat_graph(18, 16, seed=seed, weights=True)
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    worst = {"fused_pull": 0.0, "fused_push": 0.0}
    tol_used = {"fused_pull": 0.0, "fused_push": 0.0}
    cases = 0
    for block_size in (4096, 65536):
        for direction in ("pull", "push"):
            bg = build_blocked(g, block_size=block_size, direction=direction)
            fused, plain = ((fused_pull, fused_pull_ref)
                            if direction == "pull"
                            else (fused_push, fused_push_ref))
            name = f"fused_{direction}"
            for d in (None, 8):
                shape = (g.n,) if d is None else (g.n, d)
                pos = torch.from_numpy(
                    rng.random(shape, dtype=np.float32)).to(dev)
                signed = torch.from_numpy(
                    rng.standard_normal(shape).astype(np.float32)).to(dev)
                for reduce in ("sum", "min", "max"):
                    x = pos if reduce == "sum" else signed
                    eps_opts = [None]
                    if reduce == "sum":
                        eps_opts.append(
                            (0.85, torch.tensor(0.01, device=dev)))
                    for weighted in (True, False):
                        combine = None if weighted else UNWEIGHTED
                        for eps in eps_opts:
                            out = fused(bg, x, reduce, combine, eps)
                            ref = plain(bg, x, reduce, combine, eps)
                            torch.cuda.synchronize()
                            what = (f"{name} B={block_size} d={d} {reduce} "
                                    f"weighted={weighted} eps={eps is not None}")
                            err, atol, used = check_close(what, out, ref,
                                                          reduce)
                            worst[name] = max(worst[name], err)
                            tol_used[name] = max(tol_used[name], used)
                            cases += 1
                            log(f"ok {what} max_abs_err={err:.3g} "
                                f"atol={atol:.3g} tolerance_used={used:.3g}")
            del bg
    torch.cuda.synchronize()
    emit({"phase": "kernels_vs_plain", "graph": "rmat_graph(18, 16)",
          "n": g.n, "m": g.m, "cases": cases, "max_abs_err": worst,
          "sum_rtol": SUM_RTOL,
          "sum_atol": f"{SUM_ATOL_ULPS_OF_MEAN!r} * mean|ref|",
          "sum_tolerance_used": tol_used,
          "seconds": time.perf_counter() - t0})
    return worst


# --------------------------------------------------------------------- #
# phase 3: the main path
# --------------------------------------------------------------------- #
def phase_main(scale: int, seed: int, log) -> dict:
    import torch

    from repro_torch.core import (DeviceGraph, build_blocked, pagerank,
                                  rmat_graph, spmv)
    from repro_torch.kernels.tocab_fused import kernel

    t0 = time.perf_counter()
    g = rmat_graph(scale, 16, seed=seed, weights=True)
    t_rmat = time.perf_counter() - t0
    emit({"phase": "host_graph", "generator": f"rmat_graph({scale}, 16, "
          f"seed={seed}, weights=True)", "n": g.n, "m": g.m,
          "host_seconds": t_rmat})
    builds = {}
    layouts = {}
    for direction in ("pull", "push"):
        t0 = time.perf_counter()
        layouts[direction] = build_blocked(g, direction=direction)
        torch.cuda.synchronize()
        builds[direction] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dg = DeviceGraph.from_host(g)
    torch.cuda.synchronize()
    builds["device_graph"] = time.perf_counter() - t0
    bp, bq = layouts["pull"], layouts["push"]
    emit({"phase": "build_blocked", "block_size": bp.block_size,
          "num_blocks": bp.num_blocks,
          "edge_budget": {"pull": bp.edge_budget, "push": bq.edge_budget},
          "local_budget": {"pull": bp.local_budget,
                           "push": bq.local_budget},
          "padding_fraction": {"pull": bp.padding_fraction(),
                               "push": bq.padding_fraction()},
          "seconds": builds})
    n, m = g.n, g.m
    del g

    runs = (("base", None, "slab"), ("gc-pull", bp, "fused"),
            ("gc-push", bq, "fused"), ("gc-pull", bp, "slab"))
    results = {}
    torch.cuda.synchronize()
    kernel.reset_launches()  # counts of the main path's run only
    for variant, bg, impl in runs:
        t0 = time.perf_counter()
        rank, iters = pagerank(dg, bg, variant=variant, impl=impl, tol=1e-6)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        results[(variant, impl)] = (rank, iters)
        emit({"phase": "pagerank", "variant": variant, "impl": impl,
              "iterations": iters, "seconds": secs,
              "ms_per_iteration": 1e3 * secs / iters,
              "gteps": m * iters / secs / 1e9})
    x = torch.rand(n, generator=torch.Generator().manual_seed(seed)).cuda()
    t0 = time.perf_counter()
    y = spmv(dg, bp, x, variant="gc-pull", impl="fused", scale=2.5)
    torch.cuda.synchronize()
    t_spmv = time.perf_counter() - t0
    launches = dict(kernel.launches)
    y_base = spmv(dg, None, x, variant="base", scale=2.5)
    emit({"phase": "spmv", "variant": "gc-pull", "impl": "fused",
          "scale": 2.5, "seconds": t_spmv, "gteps": m / t_spmv / 1e9})
    emit({"phase": "main_path_launches", "launches": launches})
    for name in ("fused_pull", "fused_push"):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"main path never launched {name}")

    # --- outputs: finite, right shape, and equal to the flat base path ---
    base_rank, base_iters = results[("base", "slab")]
    checks = {}
    for (variant, impl), (rank, iters) in results.items():
        if rank.shape != (n,) or not bool(torch.isfinite(rank).all()):
            raise AssertionError(f"{variant}/{impl}: bad ranks")
        l1 = float((rank - base_rank).abs().sum())
        total = float(rank.sum())
        checks[f"{variant}/{impl}"] = {"l1_vs_base": l1, "rank_sum": total,
                                       "iterations": iters,
                                       "base_iterations": base_iters}
        if l1 > PR_L1_TOL or abs(iters - base_iters) > 1 \
                or abs(total - 1.0) > 1e-3:
            raise AssertionError(f"{variant}/{impl} disagrees with base: "
                                 f"{checks[f'{variant}/{impl}']}")
    err, atol, used = check_close("spmv gc-pull/fused vs base", y, y_base,
                                  "sum")
    checks["spmv gc-pull/fused"] = {"max_abs_err_vs_base": err,
                                    "atol": atol, "tolerance_used": used}
    emit({"phase": "checks", "pr_l1_tol": PR_L1_TOL, "results": checks})
    rank = results[("gc-pull", "fused")][0]
    return {"dg": dg, "pull": bp, "push": bq, "rank": rank,
            "launches": launches, "n": n, "m": m}


# --------------------------------------------------------------------- #
# phase 4: kernels at the main path's shapes
# --------------------------------------------------------------------- #
def phase_timing(main: dict, log) -> list:
    import torch

    from repro_torch.kernels.tocab_fused.kernel import (fused_pull_cuda,
                                                        fused_push_cuda)
    from repro_torch.core import UNWEIGHTED
    from repro_torch.kernels.tocab_fused.ref import (fused_pull_ref,
                                                     fused_push_ref)

    dg, n, m = main["dg"], main["n"], main["m"]
    rank = main["rank"]
    deg = dg.out_degree
    contrib = torch.where(deg > 0, rank / deg.clamp(min=1), 0.0)
    dangling = torch.where(deg > 0, 0.0, rank).sum()
    eps = (0.85, 0.15 / n + 0.85 * dangling / n)  # PageRank's epilogue

    # library yardstick: y = Aᵀ·c as one cuSPARSE CSR product (rows = dst)
    order = torch.sort(dg.dst, stable=True).indices
    crow = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(torch.bincount(dg.dst, minlength=n), 0)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a_t = torch.sparse_csr_tensor(
            crow, dg.src[order].long(), torch.ones(m, device="cuda"), (n, n),
            check_invariants=False)
    del order
    library_ms = cuda_ms(lambda: a_t @ contrib, reps=5)
    lib_out = a_t @ contrib
    del a_t

    records = []
    for name, launch, plain, bg in (
            ("fused_pull", fused_pull_cuda, fused_pull_ref, main["pull"]),
            ("fused_push", fused_push_cuda, fused_push_ref, main["push"])):
        x2 = contrib[:, None]

        def run():
            return launch(x2, bg.window_idx, bg.compact_idx, None,
                          bg.edge_mask, bg.id_map, block_size=bg.block_size,
                          reduce="sum", epilogue=eps)

        ms = cuda_ms(run, reps=10, warmup=2)
        plain_ms = cuda_ms(lambda: plain(bg, x2, "sum", UNWEIGHTED, eps),
                           reps=3)
        out, ref = run(), plain(bg, x2, "sum", UNWEIGHTED, eps)
        torch.cuda.synchronize()
        err, atol, used = check_close(f"{name} at main shapes", out, ref,
                                      "sum")
        lib_err = float((out[:, 0] - (lib_out * eps[0] + eps[1])).abs().max())
        # least bytes: each real edge's widx, cidx, mask (unweighted: no
        # edge values), each real id_map entry, the values read once, the
        # output written once
        live_ids = int(bg.n_local.sum())
        nbytes = m * (4 + 4 + 1) + 4 * live_ids + 4 * n + 4 * n
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        # operations: one add per edge, plus the epilogue's mul and add
        ops_ms = 1e3 * (m + 2 * n) / FP32_OPS_PER_S
        records.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/tocab_fused/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": main["launches"].get(name, 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "rtol": SUM_RTOL, "atol": atol, "tolerance_used": used,
        })
        log(f"{name}: bytes={nbytes} "
            f"max_abs_err_vs_library={lib_err:.3g}")
    emit({"phase": "memory",
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log", type=Path, default=None,
                    help="append per-case detail to this file")
    args = ap.parse_args(argv)

    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 3

    def log(msg: str):
        if args.log is not None:
            with open(args.log, "a") as f:
                f.write(msg + "\n")

    card = card_line()
    print(card, flush=True)
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    from repro_torch.kernels.tocab_fused import kernel

    t0 = time.perf_counter()
    logs = kernel.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs)})
    for nm, text in logs.items():
        log(f"--- nvcc {nm} ---\n{text}")

    phase_kernels(SEED, log)
    main_state = phase_main(SCALE, SEED, log)
    records = phase_timing(main_state, log)
    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
