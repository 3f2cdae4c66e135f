#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of GraphCage (``src/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure raises and the script exits non-zero:

1. Print the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and build every CUDA kernel from ``src/`` (``nvcc``, all
   sources at once, seconds).
2. Kernel vs plain, on ``rmat_graph(18, 16)``: the ``fused_pull`` /
   ``fused_push`` kernels against their plain PyTorch versions for every
   semiring, ``(n,)`` and ``(n, 8)`` values, every message mode (weighted
   ``combine=None``, ``UNWEIGHTED``, ``ADD_EDGE`` on the weighted layout
   and on the same layout without edge values), with and without the
   epilogue, on two block sizes (the shared-memory and the global-memory
   push paths), one launch a call; the ``tocab_spmm`` kernel against its plain
   version on both block sizes, every block dense (thresholds ``(0, 0)``)
   and the ``"auto"`` dense bin (a ``block_ids`` subset at the bin's
   budget), ``(n,)`` and ``(n, 8)``, weighted and unweighted, and with a
   NaN that only padding slots read.  Both families also on an edge-case
   graph (three blocks of 65536 rows, the middle one with no edge, a hub
   whose runs are longer than a warp chunk, slabs padded to no multiple of
   a chunk or a step): both fused kernels as on the R-MAT graph, and
   ``tocab_spmm`` over every block, the empty one included.
3. The attention kernels against their plain versions:
   ``flash_attention`` over GQA groups 1, 4 and 8, causal and
   bidirectional, window 0 and 64, softcap 0 and 30, ragged lengths and
   Sq ≠ Skv, fp32 (the FMA kernel) and bf16 (head dims 64, 128 and 256 on
   the tensor-core kernel, each launch counted there; 16 and 32 on the FMA
   kernel); ``flash_decode`` at kv_len = S, inside a split, on a split
   boundary and 1, splits auto / 1 / 8, softcap, MQA, one launch a call;
   its split-count invariance, its empty splits, and bit-identical repeats
   at the serve shape and a 32768-slot cache; an fp32 query beside a bf16
   cache (a serving path with ``compute_dtype="float32"``), held to
   rtol 2⁻¹³ (``FP32_Q_RTOL``, which the same q rounded to bf16 is checked
   to fail), and a bf16 query beside an fp32 cache at the bf16 tolerance,
   one launch a call; ``flash_attention`` at the
   8 × 2048 prefill in fp32 (FMA) and bf16 (tensor cores), ``flash_decode``
   in fp32 at a 32768-slot cache.  fp32 at rtol = atol = 2e-5, bf16 at one
   bf16 ulp relative plus two of the mean |entry|.
4. Main path: a Graph500 Kronecker graph (``rmat_graph(24, 16, seed=1,
   weights=True)``: 16.8 M vertices, ranks larger than the 50 MB L2) →
   ``build_blocked`` pull and push on the card, with per-graph
   (``"auto"``) sparsity bins, whose summaries are printed (the pull
   layout must have a dense block).  Two paths, each with the launch counts
   set to 0 just before it and read just after: (a) PageRank ``base``,
   ``gc-pull`` / ``gc-push`` fused, ``gc-pull`` slab to ``tol=1e-6``, and
   SpMV ``gc-pull`` fused with ``scale=``; (b) PageRank ``gc-pull`` /
   ``gc-push`` and SpMV ``gc-pull`` on ``schedule="balanced"``.  Every
   result is checked against the flat ``base`` path, and each path's
   kernels' launch counts against zero (``tocab_spmm``: at least once per
   balanced ``gc-pull`` iteration and once for the SpMV).
5. Each graph kernel timed at the main path's shapes beside its plain
   version, its bound and a ``torch.sparse`` CSR product of the same matrix;
   and beside its earlier design
   (``previous_ms``, built from ``benchmarks/torch_graph_kernel_variants.py``'s
   copy of them), and each graph kernel beside the floors of
   ``benchmarks/torch_graph_kernel_variants.py`` at its own sizes: random
   reductions (push) or gathers (pull, SpMM) into a window-sized array,
   and its slot streams read alone.
6. LM serving, TinyLlama-1.1B at its published width (22 layers, d 2048,
   32/4 heads, random weights from ``SEED`` on the card): (a) fp32
   ``forward`` (flash_attention) against 256 ``serve_decode`` steps
   (flash_decode) for 2 requests, logits, and greedy tokens equal; (b) the
   serving loop, 8 requests × (512-token prompt + 64 new tokens), bf16,
   with ``flash_decode`` launched exactly 22 times per decode step and
   ``flash_attention`` never; (c) ``serve_prefill`` on 8 × 2048 tokens,
   bf16, with ``flash_attention`` launched exactly 22 times, all on the
   tensor-core kernel.  Then both kernels timed at those shapes (and
   ``flash_decode`` at a 32768-slot cache, device time under CUDA-graph
   replay at both) beside their bounds, plain versions and
   ``scaled_dot_product_attention``; ``flash_attention`` also beside the
   FMA kernel's bf16 time at the prefill shape (``previous_ms``).
7. ``embedding_bag`` against its plain version: d 16, 24, 33 (the scalar
   path) and 64, sum and mean, weights and none, fp32 and bf16 tables,
   int32 and int64 ids, a zero-weight bag, out-of-range ids beside NaN
   guard rows, at 300 bags of 17 ids (the split route) and 20,000 bags of
   100 (the groups route; d = 33 the scalar one at both); the small cases
   must reach every route of ``kernel.ROUTES``.  Then the main path, the
   entry point on BERT4Rec's 1,000,002 × 64 item table with cloze-label
   bags at ``serve_p99`` (512 × 200) and ``train_batch`` (65,536 × 200),
   launched exactly once per call, held against the plain version,
   bit-identical on a second launch, and timed (``ms``; ``device_ms``
   under CUDA-graph replay) beside its byte bound, the plain version,
   ``F.embedding_bag``, the earlier kernel (``previous_ms``, built from
   ``benchmarks/torch_embedding_bag_variants.py``'s copy) and that
   benchmark's floors (the id and weight streams read alone; the same row
   reads without weights); ``design`` names the route each shape took.
8. BERT4Rec serving at its published width (random weights from ``SEED``):
   (a) the fp32 encoder of 8 users on the card vs on the CPU; (b)
   ``score_loop`` at 512 users, top-10 of 10⁶ items, 20 reps, every id
   checked tie-aware against fp32 scores, recall of the fp32 top-10
   reported; (c) ``bert4rec_retrieve`` over 10⁶ candidates vs float64.  No
   port kernel runs here: every launch count must stay 0.

Output: one JSON record per line; the last two lines are the kernels'
record and ``{"ok": true, "device": {...}}``.  ``--log PATH`` appends the
detail (each case's error, the compiler's register report) to PATH.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import subprocess
import sys
import tempfile
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
    "tocab_spmm": "src/repro/kernels/tocab_spmm/kernel.py:81",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:97",
    "flash_decode": "src/repro/kernels/flash_attention/decode_kernel.py:65",
    "embedding_bag": "src/repro/kernels/embedding_bag/kernel.py:60",
}

SOURCES = {
    "fused_pull": "src/repro_torch/kernels/tocab_fused/csrc/fused_pull.cu",
    "fused_push": "src/repro_torch/kernels/tocab_fused/csrc/fused_push.cu",
    "tocab_spmm": "src/repro_torch/kernels/tocab_spmm/csrc/tocab_spmm.cu",
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention_wgmma.cu",
    "flash_attention_fma":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "flash_decode":
        "src/repro_torch/kernels/flash_attention/csrc/flash_decode.cu",
    "embedding_bag":
        "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
}

#: where the graph kernels' earlier designs, timed as ``previous_ms``, live
PREVIOUS_SOURCE = "benchmarks/torch_graph_kernel_variants.py (PREVIOUS_SRC)"
#: and embedding_bag's earlier kernel
EMBEDDING_BAG_PREVIOUS = ("benchmarks/torch_embedding_bag_variants.py "
                          "(PREVIOUS_SRC)")

#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), the operation
#: bound of attention at bf16
BF16_OPS_PER_S = 989e12

#: attention and embedding-bag kernels vs their plain versions in fp32: the
#: reference's own kernel tolerance (tests/test_kernels.py), rtol = atol =
#: 2e-5
FP32_KERNEL_TOL = 2e-5
#: in bf16 the plain version computes in fp32 and rounds the output to bf16
#: once.  The kernels hold scores, sums and accumulators in fp32 too; the
#: tensor-core ones (flash_attention's bf16 route, flash_decode's bf16 one)
#: must feed P to the product as bf16, so they split it, P = P_hi + P_lo,
#: and add both products: their P is exact to 2⁻¹⁶, and their fp32 output
#: differs from the plain version's by far less than a bf16 ulp.  The two
#: outputs then differ by one bf16 ulp where a rounding boundary falls
#: between their fp32 results: rtol 2⁻⁷, one ulp at 1.0.
#: The absolute part scales with the data, as SUM_ATOL does: two such ulps
#: of the mean |entry|.  Both are tighter than the reference's bf16 2e-2, a
#: fixed atol that exceeds the typical entry of a 32768-slot decode
#: (~0.009).
BF16_RTOL = 2.0 ** -7
BF16_ATOL_OF_MEAN = 2.0 ** -6
#: flash_decode with an fp32 query beside a bf16 cache, output fp32: the
#: plain version computes in fp32 from the same bf16 cache values; the
#: tensor-core route splits q (and P) into two bf16 halves, held to 2⁻¹⁶.
#: rtol 2⁻¹³ and atol 2⁻¹³ of the mean |entry|: three bits above the
#: halves, four below bf16's 2⁻⁹, so that a q rounded to bf16 fails it
#: (phase 3 checks that it does, in every case with more than one slot).
FP32_Q_RTOL = 2.0 ** -13
FP32_Q_ATOL_OF_MEAN = 2.0 ** -13

#: full-width fp32 prefill (forward, flash_attention) vs 256 decode steps
#: (serve_decode, flash_decode): the reference's test_lm_prefill_matches_
#: decode tolerance (tests/test_models.py)
LM_RTOL, LM_ATOL = 1e-3, 1e-4

#: the LM phases: TinyLlama-1.1B at its published width (22 layers)
LM_ARCH = "tinyllama-1.1b"

#: BERT4Rec's fp32 encoder, card vs CPU: rtol = atol = 1e-4, the port's
#: parity tolerance for fp32 models (fp32 sums in another order)
B4_RTOL = 1e-4
#: serving ids, tie-aware: the bf16 path's ids must have fp32 scores at
#: least the fp32 k-th score minus 2⁻⁵ of the user's largest |fp32 score|
#: (four to eight bf16 ulps of it).  The bf16 path rounds the hidden state,
#: the table and the score to bf16, so a returned id's bf16 and fp32 scores
#: differ by E (a few ulps) and the check needs 2E.
SCORE_TOL_OF_MAX = 2.0 ** -5
#: retrieval, fp32 scores vs a float64 recomputation of the same 64-term
#: dot products (|score| < 1: fp32 errors ~1e-7)
RETRIEVE_TOL = 1e-5


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


def graph_ms(fn, calls: int = 20) -> float:
    """Device time of one ``fn()`` with the host taken out: ``calls`` calls
    captured in a CUDA graph, the graph replayed and timed with events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, reps=5, warmup=1) / calls


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


def edge_case_graph(seed: int, block: int = 65536):
    """Three blocks of ``block`` rows: the middle one holds no edge in
    either direction, source 5 pushes to 6000 destinations and destination
    7 pulls from 6000 sources (runs of one compact id longer than a warp
    chunk), over 200,000 random edges among the outer blocks."""
    import numpy as np

    from repro_torch.core import from_edges

    rng = np.random.default_rng(seed)
    n = 3 * block
    outer = np.concatenate([np.arange(block), np.arange(2 * block, n)])
    src = np.concatenate([rng.choice(outer, 200_000), np.full(6000, 5),
                          rng.choice(outer, 6000)])
    dst = np.concatenate([rng.choice(outer, 200_000), rng.choice(outer, 6000),
                          np.full(6000, 7)])
    keep = src != dst
    return from_edges(n, src[keep], dst[keep],
                      vals=rng.random(int(keep.sum()), dtype=np.float32),
                      dedup=True)


def phase_kernels(seed: int, log) -> dict:
    """Every kernel configuration against its plain version; returns the
    largest error seen per kernel."""
    import numpy as np
    import torch

    from repro_torch.core import (ADD_EDGE, UNWEIGHTED, build_blocked,
                                  rmat_graph)
    from repro_torch.kernels import cuda_build
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
    # B 4096: push's shared-memory window; 65536: its global one; the
    # edge-case graph: an empty block, runs longer than a warp chunk, slabs
    # padded to no multiple of a chunk or a step (pad_edges_to=1)
    edge = edge_case_graph(seed)
    for graph, block_size, pad in ((g, 4096, 128), (g, 65536, 128),
                                   (edge, 65536, 1)):
        for direction in ("pull", "push"):
            bg = build_blocked(graph, block_size=block_size,
                               direction=direction, pad_edges_to=pad)
            # the kernels' four message modes: v*ev, v, v + ev, v + 1
            modes = (("mul", bg, None), ("none", bg, UNWEIGHTED),
                     ("add_ev", bg, ADD_EDGE),
                     ("add_one", dataclasses.replace(bg, edge_vals=None),
                      ADD_EDGE))
            fused, plain = ((fused_pull, fused_pull_ref)
                            if direction == "pull"
                            else (fused_push, fused_push_ref))
            name = f"fused_{direction}"
            for d in (None, 8):
                shape = (graph.n,) if d is None else (graph.n, d)
                pos = torch.from_numpy(
                    rng.random(shape, dtype=np.float32)).to(dev)
                signed = torch.from_numpy(
                    rng.standard_normal(shape).astype(np.float32)).to(dev)
                # min: some sources unreached (+inf), as SSSP's distances;
                # inf plus a weight stays inf under the float-bit atomics
                unreached = signed.clone()
                unreached.view(-1)[::97] = float("inf")
                for reduce in ("sum", "min", "max"):
                    x = {"sum": pos, "min": unreached, "max": signed}[reduce]
                    eps_opts = [None]
                    if reduce == "sum":
                        eps_opts.append(
                            (0.85, torch.tensor(0.01, device=dev)))
                    for mode, layout, combine in modes:
                        for eps in eps_opts:
                            before = cuda_build.launches[name]
                            out = fused(layout, x, reduce, combine, eps)
                            launched = cuda_build.launches[name] - before
                            ref = plain(layout, x, reduce, combine, eps)
                            torch.cuda.synchronize()
                            what = (f"{name} B={block_size} pad={pad} "
                                    f"n={graph.n} d={d} {reduce} "
                                    f"message={mode} eps={eps is not None}")
                            if launched != 1:
                                raise AssertionError(
                                    f"{what}: {launched} launches, not 1")
                            err, atol, used = check_close(what, out, ref,
                                                          reduce)
                            worst[name] = max(worst[name], err)
                            tol_used[name] = max(tol_used[name], used)
                            cases += 1
                            log(f"ok {what} max_abs_err={err:.3g} "
                                f"atol={atol:.3g} tolerance_used={used:.3g}")
            del bg, modes
    torch.cuda.synchronize()
    emit({"phase": "kernels_vs_plain", "graph": "rmat_graph(18, 16)",
          "n": g.n, "m": g.m, "cases": cases,
          "messages": ["mul", "none", "add_ev", "add_one"],
          "max_abs_err": worst,
          "sum_rtol": SUM_RTOL,
          "sum_atol": f"{SUM_ATOL_ULPS_OF_MEAN!r} * mean|ref|",
          "sum_tolerance_used": tol_used,
          "seconds": time.perf_counter() - t0})
    return worst


def phase_spmm_kernel(seed: int, log) -> float:
    """The ``tocab_spmm`` kernel against its plain version; returns the
    largest error seen."""
    import numpy as np
    import torch

    from repro_torch.core import build_blocked, from_edges, rmat_graph
    from repro_torch.core import balance as TB
    from repro_torch.kernels.tocab_spmm import tocab_spmm_partials

    t0 = time.perf_counter()
    g = rmat_graph(18, 16, seed=seed, weights=True)
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    worst = tol_used = 0.0
    cases = 0

    def check(what, x, bg, **kw):
        nonlocal worst, tol_used, cases
        out = tocab_spmm_partials(bg, x, **kw)
        ref = tocab_spmm_partials(bg, x, use_ref=True, **kw)
        torch.cuda.synchronize()
        err, atol, used = check_close(what, out, ref, "sum")
        worst, tol_used = max(worst, err), max(tol_used, used)
        cases += 1
        log(f"ok {what} max_abs_err={err:.3g} atol={atol:.3g} "
            f"tolerance_used={used:.3g}")
        return out

    bins = {}
    for block_size in (4096, 65536):
        for thresholds in ((0.0, 0.0), "auto"):
            bg = build_blocked(g, block_size=block_size,
                               bin_thresholds=thresholds)
            ids, budget = None, None  # (0, 0): every block, full width
            if thresholds == "auto":
                ids = bg.schedule.blocks_in(TB.BIN_DENSE)
                budget = TB._compact_budget(bg.schedule, TB.BIN_DENSE,
                                            bg.local_budget)
                if not 0 < len(ids) < bg.num_blocks:
                    raise AssertionError(f"B={block_size}: the auto dense "
                                         f"bin is not a subset: {ids}")
            bins[f"B={block_size} {thresholds}"] = (
                bg.num_blocks if ids is None else len(ids))
            for d in (None, 8):
                shape = (g.n,) if d is None else (g.n, d)
                x = torch.from_numpy(
                    rng.random(shape, dtype=np.float32)).to(dev)
                for unweighted in (False, True):
                    check(f"tocab_spmm B={block_size} bins={thresholds} "
                          f"d={d} unweighted={unweighted}", x, bg,
                          block_ids=ids, local_budget=budget,
                          unweighted=unweighted)
            del bg

    # the edge-case graph, every block dense: the empty middle block, a
    # run longer than a warp chunk, a slab padded to no chunk multiple
    edge = edge_case_graph(seed)
    bg = build_blocked(edge, block_size=65536, bin_thresholds=(0.0, 0.0),
                       pad_edges_to=1)
    if int(bg.n_edges[1]) != 0:
        raise AssertionError("the edge-case graph's middle block has edges")
    for d in (None, 8):
        shape = (edge.n,) if d is None else (edge.n, d)
        x = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)
        for unweighted in (False, True):
            out = check(f"tocab_spmm edge-case graph d={d} "
                        f"unweighted={unweighted}", x, bg,
                        unweighted=unweighted)
            if bool(out[1].any()):
                raise AssertionError("tocab_spmm: the empty block's slab "
                                     "is not 0")
    bins["edge-case graph B=65536 (0, 0)"] = bg.num_blocks
    del bg

    # a NaN that only padding slots read (window offset 0 of every block,
    # a vertex with no out-edges) must stay out of the slab
    n, block = 4096, 512
    src, dst = rng.integers(0, n, 65536), rng.integers(0, n, 65536)
    keep = (src % block != 0) & (src != dst)
    small = from_edges(n, src[keep], dst[keep],
                       vals=rng.random(int(keep.sum()), dtype=np.float32),
                       dedup=True)
    bg = build_blocked(small, block_size=block)
    if bool(bg.edge_mask.all()):
        raise AssertionError("the NaN case's layout has no padding slots")
    clean = torch.from_numpy(rng.random((n, 2), dtype=np.float32)).to(dev)
    dirty = clean.clone()
    dirty[::block], clean[::block] = float("nan"), 0.0
    out = tocab_spmm_partials(bg, dirty)
    ref = tocab_spmm_partials(bg, clean, use_ref=True)
    torch.cuda.synchronize()
    if not bool(out.isfinite().all()):
        raise AssertionError("tocab_spmm: a NaN read only by padding "
                             "reached the slab")
    err, _, used = check_close("tocab_spmm NaN in padding", out, ref, "sum")
    worst, tol_used, cases = max(worst, err), max(tol_used, used), cases + 1
    torch.cuda.synchronize()
    emit({"phase": "tocab_spmm_vs_plain", "graph": "rmat_graph(18, 16)",
          "cases": cases, "blocks_run": bins, "max_abs_err": worst,
          "sum_rtol": SUM_RTOL,
          "sum_atol": f"{SUM_ATOL_ULPS_OF_MEAN!r} * mean|ref|",
          "sum_tolerance_used": tol_used,
          "seconds": time.perf_counter() - t0})
    return worst


# --------------------------------------------------------------------- #
# phase 4: the main path
# --------------------------------------------------------------------- #
def phase_main(scale: int, seed: int, log) -> dict:
    import torch

    from repro_torch.core import (DeviceGraph, build_blocked, pagerank,
                                  rmat_graph, spmv)
    from repro_torch.core.balance import BIN_DENSE
    from repro_torch.kernels import cuda_build

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
        # per-graph bin thresholds: under the defaults (4, 32) all three
        # blocks of this graph (13-19 edges per row) fall in the medium bin
        layouts[direction] = build_blocked(g, direction=direction,
                                           bin_thresholds="auto")
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
    for direction, bg in layouts.items():
        sched = bg.schedule
        emit({"phase": "schedule", "direction": direction,
              "thresholds": sched.thresholds, "bins": sched.bins,
              "summary": sched.summary(),
              "row_budget_per_bin": sched.row_budget_per_bin,
              "compact_budget_per_bin": sched.compact_budget_per_bin})
    if not bp.schedule.blocks_in(BIN_DENSE):
        raise AssertionError("the pull layout has no dense block: the "
                             "balanced path would never reach tocab_spmm")
    n, m = g.n, g.m
    del g
    x = torch.rand(n, generator=torch.Generator().manual_seed(seed)).cuda()
    results = {}

    def run_pagerank(variant, bg, impl="slab", schedule="uniform"):
        t0 = time.perf_counter()
        rank, iters = pagerank(dg, bg, variant=variant, impl=impl,
                               schedule=schedule, tol=1e-6)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        label = "balanced" if schedule == "balanced" else impl
        results[(variant, label)] = (rank, iters)
        emit({"phase": "pagerank", "variant": variant, "impl": impl,
              "schedule": schedule, "iterations": iters, "seconds": secs,
              "ms_per_iteration": 1e3 * secs / iters,
              "gteps": m * iters / secs / 1e9})

    def run_spmv(label, **kw):
        t0 = time.perf_counter()
        y = spmv(dg, bp, x, variant="gc-pull", scale=2.5, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        emit({"phase": "spmv", "variant": "gc-pull", "scale": 2.5, **kw,
              "seconds": secs, "gteps": m / secs / 1e9})
        return y

    # (a) the fused and slab engines (slice 1's path)
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    run_pagerank("base", None)
    run_pagerank("gc-pull", bp, impl="fused")
    run_pagerank("gc-push", bq, impl="fused")
    run_pagerank("gc-pull", bp)
    y_fused = run_spmv("fused", impl="fused")
    launches_a = dict(cuda_build.launches)
    emit({"phase": "main_path_launches", "path": "fused+slab",
          "launches": launches_a})
    for name in ("fused_pull", "fused_push"):
        if launches_a.get(name, 0) == 0:
            raise AssertionError(f"main path never launched {name}")

    # (b) the sparsity-balanced engines
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    run_pagerank("gc-pull", bp, schedule="balanced")
    run_pagerank("gc-push", bq, schedule="balanced")
    y_bal = run_spmv("balanced", schedule="balanced")
    launches_b = dict(cuda_build.launches)
    emit({"phase": "main_path_launches", "path": "balanced",
          "launches": launches_b})
    want = results[("gc-pull", "balanced")][1] + 1
    if launches_b.get("tocab_spmm", 0) < want:
        raise AssertionError(
            f"balanced path launched tocab_spmm "
            f"{launches_b.get('tocab_spmm', 0)} times, fewer "
            f"than once per gc-pull iteration plus the SpMV ({want})")

    # --- outputs: finite, right shape, and equal to the flat base path ---
    base_rank, base_iters = results[("base", "slab")]
    y_base = spmv(dg, None, x, variant="base", scale=2.5)
    checks = {}
    for (variant, label), (rank, iters) in results.items():
        if rank.shape != (n,) or not bool(torch.isfinite(rank).all()):
            raise AssertionError(f"{variant}/{label}: bad ranks")
        l1 = float((rank - base_rank).abs().sum())
        total = float(rank.sum())
        checks[f"{variant}/{label}"] = {"l1_vs_base": l1, "rank_sum": total,
                                        "iterations": iters,
                                        "base_iterations": base_iters}
        if l1 > PR_L1_TOL or abs(iters - base_iters) > 1 \
                or abs(total - 1.0) > 1e-3:
            raise AssertionError(f"{variant}/{label} disagrees with base: "
                                 f"{checks[f'{variant}/{label}']}")
    for label, y in (("fused", y_fused), ("balanced", y_bal)):
        if y.shape != (n,) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"spmv gc-pull/{label}: bad output")
        err, atol, used = check_close(f"spmv gc-pull/{label} vs base", y,
                                      y_base, "sum")
        checks[f"spmv gc-pull/{label}"] = {"max_abs_err_vs_base": err,
                                           "atol": atol,
                                           "tolerance_used": used}
    emit({"phase": "checks", "pr_l1_tol": PR_L1_TOL, "results": checks})
    rank = results[("gc-pull", "fused")][0]
    launches = {"fused_pull": launches_a.get("fused_pull", 0),
                "fused_push": launches_a.get("fused_push", 0),
                "tocab_spmm": launches_b.get("tocab_spmm", 0)}
    return {"dg": dg, "pull": bp, "push": bq, "rank": rank,
            "launches": launches, "n": n, "m": m}


# --------------------------------------------------------------------- #
# phase 5: kernels at the main path's shapes
# --------------------------------------------------------------------- #
def graph_floors(floors, window: int, slabs, ops: int, kind: str) -> dict:
    """The floors of a graph kernel at its own sizes, each measured alone
    (``benchmarks/torch_graph_kernel_variants.py``'s probes): ``ops``
    random reductions (``kind="red"``) or 4-byte gathers (``"gather"``)
    into an array of ``window`` floats, without and with the L2 evict-last
    hint, and its ``slabs`` (widx, cidx, mask) read once."""
    probe = floors.red if kind == "red" else floors.gather
    return {f"random_{kind}_ms": probe(window, ops, hint=False),
            f"random_{kind}_l2_evict_last_ms": probe(window, ops, hint=True),
            "random_ops": ops, "streams_ms": floors.streams(*slabs),
            "stream_slots": slabs[0].numel()}


def phase_timing(main: dict, log, floors, previous) -> list:
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
    for name, launch, plain, bg, kind in (
            ("fused_pull", fused_pull_cuda, fused_pull_ref, main["pull"],
             "gather"),
            ("fused_push", fused_push_cuda, fused_push_ref, main["push"],
             "red")):
        x2 = contrib[:, None]

        def run():
            return launch(x2, bg.window_idx, bg.compact_idx, None,
                          bg.edge_mask, bg.id_map, block_size=bg.block_size,
                          reduce="sum", epilogue=eps)

        ms = cuda_ms(run, reps=10, warmup=2)

        def run_previous():  # the earlier design
            return getattr(previous, name)(x2, bg, epilogue=eps)

        extra = {"previous_ms": cuda_ms(run_previous, reps=10, warmup=2),
                 "previous_source": PREVIOUS_SOURCE}
        err_prev, _, _ = check_close(f"{name} previous at main shapes",
                                     run_previous(), plain(
                                         bg, x2, "sum", UNWEIGHTED, eps),
                                     "sum")
        extra["previous_max_abs_err"] = err_prev
        extra["floors"] = graph_floors(
            floors, bg.block_size,
            (bg.window_idx, bg.compact_idx, bg.edge_mask), m, kind)
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
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": main["launches"].get(name, 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "rtol": SUM_RTOL, "atol": atol, "tolerance_used": used,
            **extra,
        })
        log(f"{name}: bytes={nbytes} "
            f"max_abs_err_vs_library={lib_err:.3g}")
    records.append(time_spmm(main, contrib, log, floors, previous))
    time_balanced_bins(main, contrib)
    emit({"phase": "memory",
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    return records


def time_spmm(main: dict, contrib, log, floors, previous) -> dict:
    """``tocab_spmm`` on the balanced pull layout's dense bin at the main
    path's shapes: PageRank contributions, unweighted; beside its earlier
    design and its floors."""
    import torch

    from repro_torch.core.balance import BIN_DENSE, _compact_budget
    from repro_torch.kernels.tocab_spmm.kernel import tocab_spmm_cuda
    from repro_torch.kernels.tocab_spmm.ref import tocab_spmm_ref

    bg, n = main["pull"], main["n"]
    B = bg.block_size
    ids = bg.schedule.blocks_in(BIN_DENSE)
    budget = _compact_budget(bg.schedule, BIN_DENSE, bg.local_budget)
    ids_t = torch.tensor(ids, dtype=torch.int32, device="cuda")
    x2 = contrib[:, None]
    args = (x2, bg.window_idx, bg.compact_idx, bg.edge_mask, None, ids_t)
    kw = dict(block_size=B, local_budget=budget)
    ms = cuda_ms(lambda: tocab_spmm_cuda(*args, **kw), reps=10, warmup=2)
    previous_ms = cuda_ms(lambda: previous.tocab_spmm(*args, **kw), reps=10,
                          warmup=2)
    plain_ms = cuda_ms(lambda: tocab_spmm_ref(*args, **kw), reps=3)
    out, ref = tocab_spmm_cuda(*args, **kw), tocab_spmm_ref(*args, **kw)
    torch.cuda.synchronize()
    err, atol, used = check_close("tocab_spmm at main shapes", out, ref,
                                  "sum")
    err_prev, _, _ = check_close("tocab_spmm previous at main shapes",
                                 previous.tocab_spmm(*args, **kw),
                                 ref, "sum")
    del ref

    # library yardstick: the bin's blocks as one block-diagonal CSR matrix
    # (rows: block j's compact ids at j·budget; columns: its window at
    # j·B) times the windows laid end to end
    k = len(ids)
    sel = torch.tensor(ids, dtype=torch.long, device="cuda")
    mask = bg.edge_mask[sel]
    edges = int(mask.sum())
    spmm_floors = graph_floors(
        floors, B, (bg.window_idx[sel], bg.compact_idx[sel], mask), edges,
        "gather")
    offs = torch.arange(k, device="cuda")[:, None]
    rows = (bg.compact_idx[sel].long() + offs * budget)[mask]
    cols = (bg.window_idx[sel].long() + offs * B)[mask]
    del mask
    crow = torch.zeros(k * budget + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=k * budget), 0)
    del rows
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_csr_tensor(crow, cols, torch.ones_like(
            cols, dtype=torch.float32), (k * budget, k * B),
            check_invariants=False)
    windows = torch.zeros(k * B, device="cuda")
    width = 0
    for j, b in enumerate(ids):
        w = contrib[b * B: min((b + 1) * B, n)]
        windows[j * B: j * B + w.numel()] = w
        width += w.numel()
    library_ms = cuda_ms(lambda: a @ windows, reps=5)
    lib_err = float((out.view(-1) - a @ windows).abs().max())
    del a, cols, crow

    # least bytes: each real edge's widx, cidx, mask (unweighted: no edge
    # values), the windows read once, the slab written once
    nbytes = 9 * edges + 4 * width + 4 * k * budget
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * edges / FP32_OPS_PER_S  # one add per edge
    log(f"tocab_spmm: blocks={list(ids)} edges={edges} budget={budget} "
        f"bytes={nbytes} max_abs_err_vs_library={lib_err:.3g}")
    return {
        "name": "tocab_spmm", "route": "cuda", "source": SOURCES["tocab_spmm"],
        "replaces": REPLACES["tocab_spmm"],
        "launches": main["launches"].get("tocab_spmm", 0),
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms, "previous_ms": previous_ms,
        "previous_source": PREVIOUS_SOURCE,
        "previous_max_abs_err": err_prev, "floors": spmm_floors,
        "rtol": SUM_RTOL, "atol": atol, "tolerance_used": used,
        "dense_blocks": list(ids), "edges": edges, "local_budget": budget,
    }


def time_balanced_bins(main: dict, contrib):
    """Where a balanced PageRank gather goes: each pull bin's phase-2
    partials (``bin_pull_partials``, its own strategy) and the whole
    balanced pull and push, at the main path's shapes."""
    from repro_torch.core import UNWEIGHTED
    from repro_torch.core.balance import (BIN_NAMES, balanced_pull,
                                          balanced_push, bin_pull_partials)

    bp, bq = main["pull"], main["push"]
    bins = {}
    for bin_id, name in enumerate(BIN_NAMES):
        bins[name] = cuda_ms(lambda: bin_pull_partials(
            bp, bin_id, contrib, "sum", UNWEIGHTED), reps=3)
    emit({"phase": "balanced_bins", "pull_bin_partials_ms": bins,
          "balanced_pull_ms": cuda_ms(
              lambda: balanced_pull(bp, contrib, "sum", UNWEIGHTED), reps=3),
          "balanced_push_ms": cuda_ms(
              lambda: balanced_push(bq, contrib, "sum", UNWEIGHTED), reps=3)})


# --------------------------------------------------------------------- #
# phase 3: the attention kernels vs their plain versions
# --------------------------------------------------------------------- #
def tol_share(out, ref, bf16: bool = False, fp32_q: bool = False):
    """Max |out - ref|, the worst entry's share of ``atol + rtol·|ref|``,
    and that (rtol, atol): :data:`FP32_KERNEL_TOL` for an fp32 ``out``,
    :data:`BF16_RTOL` and :data:`BF16_ATOL_OF_MEAN` of mean |ref| for bf16
    (or when ``bf16`` says the inputs were), :data:`FP32_Q_RTOL` and
    :data:`FP32_Q_ATOL_OF_MEAN` of mean |ref| when ``fp32_q`` says the
    output is that of an fp32 query beside a bf16 cache.  All in fp32."""
    import torch

    ref = ref.float()
    if fp32_q:
        rtol = FP32_Q_RTOL
        atol = FP32_Q_ATOL_OF_MEAN * float(ref.abs().mean())
    elif out.dtype == torch.float32 and not bf16:
        rtol = atol = FP32_KERNEL_TOL
    else:
        rtol, atol = BF16_RTOL, BF16_ATOL_OF_MEAN * float(ref.abs().mean())
    diff = (out.float() - ref).abs()
    share = diff / (atol + rtol * ref.abs())
    return float(diff.max()), float(share.max()), rtol, atol


def phase_attention_kernels(seed: int, log) -> dict:
    """``flash_attention`` and ``flash_decode`` against their plain versions
    (``attention_ref``, ``flash_decode_ref``) over GQA groups, masks,
    windows, softcaps, ragged lengths and both dtypes; the decode kernel's
    split-count invariance and its empty splits; both kernels in fp32 at
    the main path's shapes."""
    import torch

    from repro_torch.kernels.flash_attention.decode_kernel import (
        NEG_INF, flash_decode, flash_decode_partials_cuda, flash_decode_ref,
        split_length)
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention.kernel import (
        attention_route, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    names = ("flash_attention", "flash_decode")
    worst = {n: {"float32": (0.0, 0.0), "bfloat16": (0.0, 0.0)}
             for n in names}
    for mixed in ("q_fp32_cache_bf16", "q_bf16_cache_fp32"):
        worst["flash_decode"][mixed] = (0.0, 0.0)
    cases = {n: 0 for n in names}

    def record(name, what, out, ref, mixed=None):
        err, share, rtol, atol = tol_share(
            out, ref, bf16=mixed == "q_bf16_cache_fp32",
            fp32_q=mixed == "q_fp32_cache_bf16")
        log(f"{name} {what}: max_abs_err={err:.3g} rtol={rtol:.3g} "
            f"atol={atol:.3g} tolerance_used={share:.3g}")
        if not share <= 1.0:  # NaN fails too
            raise AssertionError(f"{name} {what}: max_abs_err={err} is "
                                 f"{share:.3g}× the tolerance")
        dt = mixed or str(out.dtype)[6:]
        w = worst[name][dt]
        worst[name][dt] = (max(w[0], err), max(w[1], share))
        cases[name] += 1

    shapes = (  # (B, Hq, Hkv, Sq, Skv, D): groups 1, 4, 8; ragged; Sq ≠ Skv
        (1, 4, 4, 128, 128, 64), (2, 8, 2, 200, 200, 64),
        (1, 8, 1, 130, 130, 128), (2, 32, 4, 256, 256, 64),
        (2, 4, 4, 77, 77, 16), (1, 4, 2, 64, 96, 32))
    # bf16 only: the tensor-core kernel's other head dims over the same
    # groups, ragged lengths and Sq ≠ Skv
    tc_shapes = (
        (1, 4, 4, 77, 77, 128), (2, 8, 2, 200, 200, 128),
        (1, 4, 2, 64, 96, 128), (1, 4, 4, 77, 77, 256),
        (1, 8, 2, 130, 130, 256), (1, 8, 1, 200, 200, 256),
        (1, 4, 2, 64, 96, 256))
    modes = ((True, 0, 0.0), (True, 64, 0.0), (False, 0, 0.0),
             (True, 0, 30.0), (True, 64, 30.0), (False, 64, 0.0))
    on_tc = 0  # bf16 cases the tensor-core kernel took
    for dtype in (torch.float32, torch.bfloat16):
        for B, Hq, Hkv, Sq, Skv, D in shapes + (
                tc_shapes if dtype == torch.bfloat16 else ()):
            q = rand(B, Hq, Sq, D, dtype=dtype)
            k, v = (rand(B, Hkv, Skv, D, dtype=dtype) for _ in range(2))
            route = attention_route(dtype, D)
            for causal, window, cap in modes:
                if causal and Sq != Skv:
                    continue
                kw = dict(causal=causal, window=window, softcap=cap)
                n_tc = cuda_build.launches["flash_attention_wgmma"]
                out = flash_attention_cuda(q, k, v, **kw)
                ref = attention_ref(q, k, v, **kw)
                torch.cuda.synchronize()
                took = cuda_build.launches["flash_attention_wgmma"] - n_tc
                if took != (route == "wgmma"):
                    raise AssertionError(f"flash_attention {dtype} D={D}: "
                                         f"route {route}, {took} tensor-"
                                         "core launches")
                on_tc += took
                record("flash_attention", f"{dtype} q={tuple(q.shape)} "
                       f"kv={tuple(k.shape)} {kw} {route}", out, ref)

    dshapes = (  # (B, Hq, Hkv, S, D): the serve shape, GQA, MQA
        (8, 32, 4, 576, 64), (2, 8, 2, 256, 64), (2, 4, 1, 128, 128),
        (1, 8, 1, 300, 16), (1, 2, 2, 128, 64))
    for dtype in (torch.float32, torch.bfloat16):
        for B, Hq, Hkv, S, D in dshapes:
            q = rand(B, Hq, 1, D, dtype=dtype)
            k, v = (rand(B, Hkv, S, D, dtype=dtype) for _ in range(2))
            for splits in (None, 1, 8):
                split = split_length(B, Hkv, S, splits, dev)
                # the whole cache, inside a split, on a split boundary, 1
                lens = sorted({S, min(S, split + split // 2),
                               min(S, 2 * split), 1})
                for kv_len in lens:
                    for cap in (0.0, 30.0):
                        kw = dict(kv_len=kv_len, softcap=cap)
                        n0 = cuda_build.launches["flash_decode"]
                        out = flash_decode(q, k, v, kv_splits=splits, **kw)
                        if cuda_build.launches["flash_decode"] != n0 + 1:
                            raise AssertionError("flash_decode: not one "
                                                 "launch a call")
                        ref = flash_decode_ref(q, k, v, **kw)
                        torch.cuda.synchronize()
                        record("flash_decode", f"{dtype} q={tuple(q.shape)} "
                               f"kv={tuple(k.shape)} splits={splits} {kw}",
                               out, ref)

    # a query whose dtype differs from the cache's: fp32 beside bf16 (a
    # serving path with compute_dtype="float32"; the tensor-core route
    # splits q into two bf16 halves), held to FP32_Q_RTOL, which the same
    # q rounded to bf16 must fail; and bf16 beside fp32, whose bf16 output
    # is held to the bf16 tolerance.  Output in q's dtype, one launch a call
    rounded_q_share = float("inf")  # the least over the fp32-q cases
    for q_dtype, c_dtype in ((torch.float32, torch.bfloat16),
                             (torch.bfloat16, torch.float32)):
        mixed = ("q_fp32_cache_bf16" if q_dtype == torch.float32
                 else "q_bf16_cache_fp32")
        for B, Hq, Hkv, S, D in dshapes:
            q = rand(B, Hq, 1, D, dtype=q_dtype)
            k, v = (rand(B, Hkv, S, D, dtype=c_dtype) for _ in range(2))
            for kv_len in sorted({S, S // 2 + 1, 1}):
                for cap in (0.0, 30.0):
                    kw = dict(kv_len=kv_len, softcap=cap)
                    n0 = cuda_build.launches["flash_decode"]
                    out = flash_decode(q, k, v, **kw)
                    if cuda_build.launches["flash_decode"] != n0 + 1:
                        raise AssertionError("flash_decode: not one launch "
                                             "a call")
                    if out.dtype != q_dtype:
                        raise AssertionError(f"flash_decode: output "
                                             f"{out.dtype}, q {q_dtype}")
                    ref = flash_decode_ref(q, k, v, **kw)
                    torch.cuda.synchronize()
                    what = (f"q {q_dtype} cache {c_dtype} q={tuple(q.shape)} "
                            f"kv={tuple(k.shape)} {kw}")
                    record("flash_decode", what, out, ref, mixed=mixed)
                    if mixed == "q_fp32_cache_bf16" and kv_len > 1:
                        # one slot's softmax weight is 1 whatever q is
                        _, share, _, _ = tol_share(flash_decode_ref(
                            q.to(torch.bfloat16).float(), k, v, **kw), ref,
                            fp32_q=True)
                        if not share > 1.0:
                            raise AssertionError(
                                f"flash_decode {what}: q rounded to bf16 "
                                f"passes the fp32-q tolerance ({share:.3g})")
                        rounded_q_share = min(rounded_q_share, share)

    # the main path's shapes in fp32: TinyLlama's prefill of 8 × 2048 tokens
    # (32 query / 4 KV heads of 64, causal) and a 32768-slot decode cache
    f32 = torch.float32
    q = rand(8, 32, 2048, 64, dtype=f32)
    k, v = (rand(8, 4, 2048, 64, dtype=f32) for _ in range(2))
    out = flash_attention_cuda(q, k, v, causal=True)
    ref = attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    record("flash_attention", f"{f32} q={tuple(q.shape)} kv={tuple(k.shape)} "
           "causal fma", out, ref)
    del q, k, v, out, ref
    # and in bf16 on the tensor cores, the LM's own prefill
    bf16 = torch.bfloat16
    q = rand(8, 32, 2048, 64, dtype=bf16)
    k, v = (rand(8, 4, 2048, 64, dtype=bf16) for _ in range(2))
    n_tc = cuda_build.launches["flash_attention_wgmma"]
    out = flash_attention_cuda(q, k, v, causal=True)
    ref = attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    if cuda_build.launches["flash_attention_wgmma"] != n_tc + 1:
        raise AssertionError("flash_attention: the bf16 prefill did not take "
                             "the tensor-core kernel")
    on_tc += 1
    record("flash_attention", f"{bf16} q={tuple(q.shape)} kv={tuple(k.shape)} "
           "causal wgmma", out, ref)
    del q, k, v, out, ref
    q = rand(8, 32, 1, 64, dtype=f32)
    k, v = (rand(8, 4, 32768, 64, dtype=f32) for _ in range(2))
    out = flash_decode(q, k, v)
    ref = flash_decode_ref(q, k, v)
    torch.cuda.synchronize()
    record("flash_decode", f"{f32} q={tuple(q.shape)} kv={tuple(k.shape)}",
           out, ref)
    del q, k, v, out, ref
    torch.cuda.empty_cache()

    # one launch a call, the same bits on every call (the merge order is
    # fixed and there are no float atomics): the serve shape, 32768 slots
    repeats = {}
    for slots in (576, 32768):
        q = rand(8, 32, 1, 64, dtype=bf16)
        k, v = (rand(8, 4, slots, 64, dtype=bf16) for _ in range(2))
        n0 = cuda_build.launches["flash_decode"]
        outs = [flash_decode(q, k, v) for _ in range(3)]
        torch.cuda.synchronize()
        if cuda_build.launches["flash_decode"] != n0 + 3:
            raise AssertionError("flash_decode: not one launch a call")
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"flash_decode at {slots} slots: repeats "
                                 "differ")
        record("flash_decode", f"{bf16} q={tuple(q.shape)} "
               f"kv={tuple(k.shape)}", outs[0], flash_decode_ref(q, k, v))
        repeats[slots] = "bit-identical x3"
        del q, k, v, outs
    torch.cuda.empty_cache()

    # split-count invariance: the log-sum-exp merge is exact
    q = rand(1, 8, 1, 64, dtype=torch.float32)
    k, v = (rand(1, 2, 1024, 64, dtype=torch.float32) for _ in range(2))
    outs = [flash_decode(q, k, v, kv_splits=s, kv_len=1000)
            for s in (1, 4, 16, 64, None)]
    spread = max(float((o - outs[0]).abs().max()) for o in outs[1:])
    if not spread <= 2e-6:
        raise AssertionError(f"flash_decode depends on the split count: "
                             f"{spread}")
    # splits wholly past kv_len read nothing: m = -1e30, l = 0, o = 0
    m, l, o = flash_decode_partials_cuda(q, k, v, scale=0.125, kv_len=100,
                                         split=64, softcap=0.0)
    torch.cuda.synchronize()
    if not (bool((m[:, :, 2:] == NEG_INF).all())
            and bool((l[:, :, 2:] == 0).all())
            and bool((o[:, :, 2:] == 0).all())
            and bool((l[:, :, :2] > 0).all())):
        raise AssertionError("flash_decode: empty splits are not empty")
    emit({"phase": "attention_kernels_vs_plain", "cases": cases,
          "tolerance": {"float32": {"rtol": FP32_KERNEL_TOL,
                                    "atol": FP32_KERNEL_TOL},
                        "bfloat16": {"rtol": BF16_RTOL,
                                     "atol_of_mean_abs": BF16_ATOL_OF_MEAN},
                        "q_fp32_cache_bf16": {
                            "rtol": FP32_Q_RTOL,
                            "atol_of_mean_abs": FP32_Q_ATOL_OF_MEAN},
                        "q_bf16_cache_fp32": "bfloat16's"},
          "max_abs_err": {n: {dt: e for dt, (e, _) in w.items()}
                          for n, w in worst.items()},
          "tolerance_used": {n: {dt: u for dt, (_, u) in w.items()}
                             for n, w in worst.items()},
          "split_invariance_max_diff": spread,
          "q_rounded_to_bf16_least_tolerance_used": rounded_q_share,
          "flash_attention_tensor_core_cases": on_tc,
          "flash_decode_repeats": repeats,
          "seconds": time.perf_counter() - t0})
    return worst


# --------------------------------------------------------------------- #
# phase 6: LM serving at full TinyLlama-1.1B width
# --------------------------------------------------------------------- #
def phase_lm(seed: int, log) -> dict:
    """TinyLlama-1.1B at its published width, random weights from a seeded
    generator on the card, through the port's entry points: (a) fp32
    forward (flash_attention) against 256 decode steps (flash_decode);
    (b) the serving loop, 8 requests × (512 + 64) tokens, bf16; (c)
    serve_prefill on 8 × 2048 tokens, bf16.  Launch counts are set to 0
    just before (b) and (c) and read just after."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda_build
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models import transformer as tfm

    dev = torch.device("cuda")
    cfg = get_arch(LM_ARCH).make_model_cfg()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    master = tfm.init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    n_params = tfm.param_count(master)
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, the config says "
                             f"{cfg.param_count()}")
    emit({"phase": "lm_init", "arch": LM_ARCH, "config": dataclasses.asdict(
        cfg), "params": n_params, "seconds": time.perf_counter() - t0})
    rng = np.random.default_rng(seed)

    # (a) fp32: forward's logits at every position vs one decode step each
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    B, S = 2, 256
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).to(dev)
    t0 = time.perf_counter()
    full, _ = tfm.forward(master, tokens, cfg32)
    cache = tfm.init_cache(cfg32, B, S, dtype=torch.float32, device=dev)
    steps = []
    for t in range(S):
        lg, cache = tfm.serve_decode(master, tokens[:, t:t + 1], t, cache,
                                     cfg32)
        steps.append(lg)
    dec = torch.stack(steps, dim=1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    del cache, steps
    if not (bool(full.isfinite().all()) and bool(dec.isfinite().all())):
        raise AssertionError("fp32 prefill/decode logits are not finite")
    diff = (dec - full).abs()
    err = float(diff.max())
    share = float((diff / (LM_ATOL + LM_RTOL * full.abs())).max())
    # the greedy tokens must be equal; the forward's smallest margin
    # between its top two logits says how near a tie came
    differ = full.argmax(-1) != dec.argmax(-1)
    top2 = full.topk(2, dim=-1).values
    rec_a = {"phase": "lm_prefill_vs_decode_fp32", "requests": B,
             "tokens": S, "max_abs_err": err, "rtol": LM_RTOL,
             "atol": LM_ATOL, "tolerance_used": share,
             "greedy_tokens_differ": int(differ.sum()),
             "min_top2_margin": float((top2[..., 0] - top2[..., 1]).min()),
             "logit_abs_max": float(full.abs().max()), "seconds": secs}
    emit(rec_a)
    if not share <= 1.0 or bool(differ.any()):
        raise AssertionError(f"fp32 prefill and decode disagree: {rec_a}")
    del full, dec, diff, top2, differ

    # (b) serving, bf16: 8 requests × (512-token prompt + 64 new tokens)
    params = tfm.cast_params(master, cfg)
    Bs, P, new = 8, 512, 64
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (Bs, P))).to(dev)
    serve_loop(params, prompts[:, :8], cfg, 4)  # warm-up: builds, allocator
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    res = serve_loop(params, prompts, cfg, new)
    launches_b = dict(cuda_build.launches)
    want = cfg.n_layers * res.decode_steps
    toks = res.tokens
    if toks.shape != (Bs, new) or not bool(((toks >= 0)
                                             & (toks < cfg.vocab)).all()):
        raise AssertionError(f"serve: bad tokens {toks.shape}")
    if launches_b.get("flash_decode", 0) != want \
            or launches_b.get("flash_attention", 0) != 0:
        raise AssertionError(f"serve launched {launches_b}; want "
                             f"flash_decode = {want}, flash_attention = 0")
    step_ms = sorted(1e3 * s for s in res.step_seconds)
    emit({"phase": "lm_serve", "requests": Bs, "prompt_len": P,
          "max_new": new, "decode_steps": res.decode_steps,
          "prefill_seconds": res.prefill_seconds,
          "prefill_ms_per_step": 1e3 * res.prefill_seconds / (P - 1),
          "decode_ms_per_step": 1e3 * res.decode_seconds / new,
          "decode_step_ms_p50": step_ms[len(step_ms) // 2],
          "decode_step_ms_max": step_ms[-1],
          "tokens_per_s": res.tokens_per_s,
          "decode_tokens_per_s": res.decode_tokens_per_s,
          "launches": launches_b})

    # (c) prefill, bf16: serve_prefill on 8 × 2048 tokens
    Bp, Sp = 8, 2048
    ptoks = torch.from_numpy(rng.integers(0, cfg.vocab, (Bp, Sp))).to(dev)
    tfm.serve_prefill(params, ptoks[:1, :256], cfg)  # warm-up
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    last = tfm.serve_prefill(params, ptoks, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches_c = dict(cuda_build.launches)
    if launches_c.get("flash_attention", 0) != cfg.n_layers \
            or launches_c.get("flash_attention_wgmma", 0) != cfg.n_layers \
            or launches_c.get("flash_decode", 0) != 0:
        raise AssertionError(f"serve_prefill launched {launches_c}; want "
                             f"flash_attention = {cfg.n_layers}, all on the "
                             "tensor cores (flash_attention_wgmma), "
                             "flash_decode = 0")
    if last.shape != (Bp, cfg.vocab) or not bool(last.isfinite().all()):
        raise AssertionError("serve_prefill: bad logits")
    emit({"phase": "lm_prefill", "requests": Bp, "tokens": Sp,
          "seconds": secs, "tokens_per_s": Bp * Sp / secs,
          "launches": launches_c})
    del master, params
    return {"launches": {"flash_decode": launches_b.get("flash_decode", 0),
                         "flash_attention":
                             launches_c.get("flash_attention", 0),
                         "flash_attention_wgmma":
                             launches_c.get("flash_attention_wgmma", 0)},
            "cfg": cfg, "serve_shape": (Bs, P + new),
            "prefill_shape": (Bp, Sp)}


def attention_timing(lm: dict, seed: int, log) -> list:
    """``flash_attention`` at the prefill shape and ``flash_decode`` at the
    serve shape and at a 32768-slot cache, beside their bounds, their plain
    versions and ``scaled_dot_product_attention`` (the yardstick: the port
    never calls it); ``flash_attention`` also beside the FMA kernel at the
    same bf16 shape (``previous_ms``: the kernel this route replaced)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention.decode_kernel import (
        flash_decode, flash_decode_ref)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda, flash_attention_fma_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    cfg = lm["cfg"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf16 = torch.bfloat16
    H, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    # flash_attention at (c): q (8, 32, 2048, 64), causal, GQA 8
    B, S = lm["prefill_shape"]
    q, k, v = rand(B, H, S, D), rand(B, Hk, S, D), rand(B, Hk, S, D)
    ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=True), reps=10,
                 warmup=2)
    plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=True), reps=2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=10, warmup=2)
    previous_ms = cuda_ms(lambda: flash_attention_fma_cuda(q, k, v,
                                                           causal=True),
                          reps=3)
    out = flash_attention_cuda(q, k, v, causal=True)
    err, share, rtol, atol = tol_share(out,
                                       attention_ref(q, k, v, causal=True))
    lib_err = float((out.float() - F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True).float()).abs().max())
    flops = 4 * B * H * S * S * D / 2  # causal: half the score matrix
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel())
    ops_ms, bytes_ms = 1e3 * flops / BF16_OPS_PER_S, 1e3 * nbytes / \
        HBM_BYTES_PER_S
    log(f"flash_attention: flops={flops} bytes={nbytes} "
        f"max_abs_err_vs_sdpa={lib_err:.3g}")
    if not share <= 1.0:
        raise AssertionError(f"flash_attention at the prefill shape: "
                             f"{share}× the tolerance")
    fa = {"name": "flash_attention", "route": "cuda",
          "source": SOURCES["flash_attention"],
          "replaces": REPLACES["flash_attention"],
          "launches": lm["launches"]["flash_attention"],
          "launches_tensor_core": lm["launches"]["flash_attention_wgmma"],
          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
          "bound_ms": max(ops_ms, bytes_ms),
          "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
          "library_ms": lib_ms, "previous_ms": previous_ms,
          "previous_source": SOURCES["flash_attention_fma"],
          "rtol": rtol, "atol": atol, "tolerance_used": share,
          "shape": {"q": list(q.shape), "kv": list(k.shape),
                    "causal": True},
          "tflops": flops / (ms * 1e-3) / 1e12,
          "bound_share": max(ops_ms, bytes_ms) / ms}
    del q, k, v, out
    torch.cuda.empty_cache()

    def decode_case(batch, slots):
        q = rand(batch, H, 1, D)
        kc, vc = rand(batch, Hk, slots, D), rand(batch, Hk, slots, D)
        kv_len = slots
        ms = cuda_ms(lambda: flash_decode(q, kc, vc, kv_len=kv_len), reps=50,
                     warmup=3)
        device_ms = graph_ms(lambda: flash_decode(q, kc, vc, kv_len=kv_len))
        n0 = cuda_build.launches["flash_decode"]
        flash_decode(q, kc, vc, kv_len=kv_len)
        per_call = cuda_build.launches["flash_decode"] - n0
        if per_call != 1:
            raise AssertionError(f"flash_decode: {per_call} launches a call")
        plain_ms = cuda_ms(lambda: flash_decode_ref(q, kc, vc, kv_len=kv_len),
                           reps=5)
        ks, vs = kc[:, :, :kv_len], vc[:, :, :kv_len]
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, ks, vs, enable_gqa=True), reps=50, warmup=3)
        lib_device_ms = graph_ms(lambda: F.scaled_dot_product_attention(
            q, ks, vs, enable_gqa=True))
        out = flash_decode(q, kc, vc, kv_len=kv_len)
        err, share, rtol, atol = tol_share(
            out, flash_decode_ref(q, kc, vc, kv_len=kv_len))
        if not share <= 1.0:
            raise AssertionError(f"flash_decode at {slots} slots: {share}× "
                                 "the tolerance")
        # K/V of the live slots read once, q read, out written, bf16
        nbytes = 2 * (2 * batch * Hk * kv_len * D + 2 * q.numel())
        flops = 4 * batch * H * kv_len * D
        return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "library_device_ms": lib_device_ms,
                "launches_per_call": per_call,
                "bound_share_device": max(1e3 * nbytes / HBM_BYTES_PER_S,
                                          1e3 * flops / BF16_OPS_PER_S)
                / device_ms,
                "bytes_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                "ops_ms": 1e3 * flops / BF16_OPS_PER_S,
                "max_abs_err": err, "rtol": rtol, "atol": atol,
                "tolerance_used": share,
                "shape": {"q": list(q.shape), "kv": list(kc.shape),
                          "kv_len": kv_len},
                "tb_per_s_device": nbytes / (device_ms * 1e-3) / 1e12}

    serve = decode_case(*lm["serve_shape"])
    long = decode_case(8, 32768)
    fd = {"name": "flash_decode", "route": "cuda",
          "source": SOURCES["flash_decode"],
          "replaces": REPLACES["flash_decode"],
          "launches": lm["launches"]["flash_decode"],
          "max_abs_err": serve["max_abs_err"], "ms": serve["ms"],
          "plain_ms": serve["plain_ms"],
          "bound_ms": max(serve["bytes_ms"], serve["ops_ms"]),
          "bound_by": ("bytes" if serve["bytes_ms"] >= serve["ops_ms"]
                       else "operations"),
          "library_ms": serve["library_ms"],
          "rtol": serve["rtol"], "atol": serve["atol"],
          "tolerance_used": serve["tolerance_used"],
          "device_ms": serve["device_ms"],
          "library_device_ms": serve["library_device_ms"],
          "launches_per_call": serve["launches_per_call"],
          "bound_share_device": serve["bound_share_device"],
          "shape": serve["shape"],
          "tb_per_s_device": serve["tb_per_s_device"],
          "long_cache": {**long, "bound_ms": max(long["bytes_ms"],
                                                 long["ops_ms"])}}
    return [fa, fd]


# --------------------------------------------------------------------- #
# phase 7: embedding_bag at the BERT4Rec table size
# --------------------------------------------------------------------- #
def phase_embedding_bag(seed: int, log, probes, previous) -> list:
    """The ``embedding_bag`` kernel against its plain version: small cases
    over widths, modes, weights, table and id types, an all-zero-weight
    bag and out-of-range ids (a NaN guard row on each side of the table:
    reading one would show), at bag counts that reach every route; then
    the main path — the entry point on the BERT4Rec item table with
    cloze-label bags at ``serve_p99`` and ``train_batch``, launch counts
    set to 0 just before and read just after — its checks, repeat launches
    bit for bit, and each shape timed beside its bound, its plain version,
    ``F.embedding_bag``, the earlier kernel (``previous``) and the floor
    ``probes`` (``benchmarks/torch_embedding_bag_variants.py``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.data.recsys import make_cloze_batch
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_ref)
    from repro_torch.kernels.embedding_bag import kernel as ek
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    worst = {"float32": (0.0, 0.0), "bfloat16": (0.0, 0.0)}
    cases = 0

    def check(what, out, ref):
        nonlocal cases
        err, share, rtol, atol = tol_share(out, ref)
        log(f"embedding_bag {what}: max_abs_err={err:.3g} rtol={rtol:.3g} "
            f"atol={atol:.3g} tolerance_used={share:.3g}")
        if not share <= 1.0:  # NaN fails too
            raise AssertionError(f"embedding_bag {what}: max_abs_err={err} "
                                 f"is {share:.3g}× the tolerance")
        dt = str(out.dtype)[6:]
        worst[dt] = (max(worst[dt][0], err), max(worst[dt][1], share))
        cases += 1
        return err, share

    def launch(*args, **kw):
        before = cuda_build.launches["embedding_bag"]
        out = embedding_bag(*args, **kw)
        if cuda_build.launches["embedding_bag"] != before + 1:
            raise AssertionError("embedding_bag did not launch exactly once")
        return out

    # 300 bags of 17: the split route; 20,000 of 100: the groups route
    # (d = 33: the scalar route at both)
    V = 5000
    ek.routes.clear()
    for (B, L), d in itertools.product(((300, 17), (20000, 100)),
                                       (16, 24, 33, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            guarded = torch.full((V + 2, d), float("nan"), device=dev,
                                 dtype=dtype)
            guarded[1:V + 1] = torch.from_numpy(
                rng.standard_normal((V, d), dtype=np.float32)).to(dev, dtype)
            table = guarded[1:V + 1]  # rows -1 and V are the NaN guards
            ids = rng.integers(0, V, (B, L))
            ids[0, :2], ids[1, 3], ids[2, 0] = (-1, V), V + 1000, -7
            w = rng.random((B, L), dtype=np.float32)
            w[5] = 0.0  # a bag of zero weight
            wt = torch.from_numpy(w).to(dev)
            # the large bags in sum only: the modes differ in the wrapper
            modes = ("sum", "mean") if B < 1000 else ("sum",)
            for id_dtype in (torch.int32, torch.int64):
                it = torch.from_numpy(ids).to(dev, id_dtype)
                for mode in modes:
                    for weights in (wt, None):
                        out = launch(table, it, weights, mode=mode)
                        ref = embedding_bag_ref(table, it, weights, mode=mode)
                        torch.cuda.synchronize()
                        what = (f"B={B} L={L} d={d} {dtype} "
                                f"ids={id_dtype} {mode} "
                                f"weights={weights is not None}")
                        if out.dtype != dtype or out.shape != (B, d):
                            raise AssertionError(f"{what}: {out.dtype} "
                                                 f"{tuple(out.shape)}")
                        if not bool(out.isfinite().all()):
                            raise AssertionError(f"{what}: an out-of-range "
                                                 "id's guard row was read")
                        check(what, out, ref)
                        if weights is not None and bool(out[5].any()):
                            raise AssertionError(f"{what}: the zero-weight "
                                                 "bag is not 0")
                        if not torch.equal(out, launch(table, it, weights,
                                                       mode=mode)):
                            raise AssertionError(f"{what}: two launches "
                                                 "differ")
    small_cases = cases
    small_routes = dict(ek.routes)
    if set(small_routes) != set(ek.ROUTES):
        raise AssertionError(f"the small cases took the routes "
                             f"{small_routes}; want all of {ek.ROUTES}")

    # the main path: BERT4Rec's item table, bags of cloze labels
    cfg = get_arch("bert4rec").make_model_cfg()
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((cfg.table_size, cfg.d_model), generator=gen,
                        device=dev) * 0.02  # as init_bert4rec scales it
    shapes = {c.name: c.batch for c in get_arch("bert4rec").shapes
              if c.name in ("serve_p99", "train_batch")}
    bags = {}
    for name, batch in shapes.items():
        labels = make_cloze_batch(rng, batch, cfg.max_len, cfg.vocab,
                                  cfg.mask_id, device=dev)["labels"]
        w = torch.from_numpy(rng.random((batch, cfg.max_len),
                                        dtype=np.float32)).to(dev)
        bags[name] = (labels, w)
    modes = ("sum", "mean")
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    ek.routes.clear()
    outs, launches, designs = {}, {}, {}
    for name, (ids, w) in bags.items():
        before = cuda_build.launches["embedding_bag"]
        routes_before = dict(ek.routes)
        for mode in modes:
            outs[name, mode] = embedding_bag(table, ids, w, mode=mode)
        launches[name] = cuda_build.launches["embedding_bag"] - before
        designs[name] = sorted(r for r in ek.ROUTES
                               if ek.routes[r] != routes_before.get(r, 0))
    torch.cuda.synchronize()
    counted = dict(cuda_build.launches)
    emit({"phase": "embedding_bag_main_path_launches", "launches": counted,
          "designs": designs})
    if any(len(v) != 1 for v in designs.values()):
        raise AssertionError(f"a shape's calls took several routes: "
                             f"{designs}")
    if counted != {"embedding_bag": len(bags) * len(modes)}:
        raise AssertionError(f"the embedding_bag path launched {counted}; "
                             f"want embedding_bag = {len(bags) * len(modes)}")

    records, full = [], {}
    for name, (ids, w) in bags.items():
        batch = ids.shape[0]
        errs = {}
        for mode in modes:
            ref = embedding_bag_ref(table, ids, w, mode=mode)
            errs[mode] = check(f"{name} {mode}", outs[name, mode], ref)
            del ref
            if not torch.equal(outs[name, mode],
                               embedding_bag(table, ids, w, mode=mode)):
                raise AssertionError(f"embedding_bag {name} {mode}: two "
                                     "launches differ")
        def run():
            return embedding_bag_cuda(table, ids, w)

        def run_previous():
            return previous(table, ids, w)

        ids64 = ids.long()  # F.embedding_bag's documented id type

        def run_library():
            return F.embedding_bag(ids64, table, per_sample_weights=w,
                                   mode="sum")

        # in turns: kernel, previous, previous, kernel (host loop), then
        # each under CUDA-graph replay (device time, the host taken out)
        ms_a = cuda_ms(run, reps=20, warmup=2)
        prev_a = cuda_ms(run_previous, reps=20, warmup=2)
        prev_b = cuda_ms(run_previous, reps=20, warmup=2)
        ms_b = cuda_ms(run, reps=20, warmup=2)
        ms, previous_ms = (ms_a + ms_b) / 2, (prev_a + prev_b) / 2
        device_ms = graph_ms(run)
        previous_device_ms = graph_ms(run_previous)
        plain_ms = cuda_ms(lambda: embedding_bag_ref(table, ids, w), reps=3)
        lib_ms = cuda_ms(run_library, reps=20, warmup=2)
        lib_device_ms = graph_ms(run_library)
        lib_err = float((outs[name, "sum"] - run_library()).abs().max())
        err_prev, share_prev = check(f"{name} previous", run_previous(),
                                     embedding_bag_ref(table, ids, w))
        del ids64
        floors = {"streams_ms": probes.streams(ids, w),
                  "gathers_ms": probes.gathers(table, ids, hint=False),
                  "gathers_l2_evict_last_ms": probes.gathers(table, ids,
                                                             hint=True)}
        # least bytes: each distinct row once, the ids and weights once, the
        # output once; 2 flops per gathered element
        unique_rows = int(torch.unique(ids).numel())
        d = cfg.d_model
        nbytes = unique_rows * d * 4 + ids.numel() * (4 + 4) + batch * d * 4
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * 2 * ids.numel() * d / FP32_OPS_PER_S
        err, share = errs["sum"]
        log(f"embedding_bag {name}: bytes={nbytes} unique_rows={unique_rows}"
            f" max_abs_err_vs_library={lib_err:.3g}")
        full[name] = {"bags": batch, "bag_len": cfg.max_len,
                      "unique_rows": unique_rows,
                      "max_abs_err": {m: e for m, (e, _) in errs.items()},
                      "tolerance_used": {m: u for m, (_, u) in errs.items()}}
        records.append({
            "name": "embedding_bag", "route": "cuda",
            "source": SOURCES["embedding_bag"],
            "replaces": REPLACES["embedding_bag"],
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": lib_ms, "rtol": FP32_KERNEL_TOL,
            "atol": FP32_KERNEL_TOL, "tolerance_used": share,
            "shape": {"cell": name, "table": list(table.shape),
                      "ids": list(ids.shape), "unique_rows": unique_rows},
            "design": designs[name][0], "device_ms": device_ms,
            "previous_ms": previous_ms,
            "previous_device_ms": previous_device_ms,
            "previous_source": EMBEDDING_BAG_PREVIOUS,
            "previous_max_abs_err": err_prev,
            "previous_tolerance_used": share_prev,
            "library_device_ms": lib_device_ms, "floors": floors,
            "library_max_abs_err": lib_err,
            "gathered_tb_per_s": ids.numel() * d * 4 / (ms * 1e-3) / 1e12})
    del outs, bags, table
    torch.cuda.empty_cache()
    emit({"phase": "embedding_bag_vs_plain", "cases": cases,
          "small_cases": small_cases, "small_case_routes": small_routes,
          "full": full,
          "tolerance": {"float32": {"rtol": FP32_KERNEL_TOL,
                                    "atol": FP32_KERNEL_TOL},
                        "bfloat16": {"rtol": BF16_RTOL,
                                     "atol_of_mean_abs": BF16_ATOL_OF_MEAN}},
          "max_abs_err": {dt: e for dt, (e, _) in worst.items()},
          "tolerance_used": {dt: u for dt, (_, u) in worst.items()},
          "seconds": time.perf_counter() - t0})
    return records


# --------------------------------------------------------------------- #
# phase 8: BERT4Rec serving at its published width
# --------------------------------------------------------------------- #
def phase_bert4rec(seed: int, log) -> dict:
    """BERT4Rec at its published width (d 64, 2 blocks, 2 heads, L 200,
    10⁶ items), random weights from a seeded generator on the card, through
    the port's entry points: (a) the fp32 encoder on the card against the
    same function on the CPU; (b) the serving loop (``score_loop``) at 512
    users, top-10, 20 reps, its ids checked tie-aware against fp32 scores;
    (c) ``bert4rec_retrieve`` over 10⁶ candidates against a float64
    recomputation.  No port kernel runs on this path: the launch counts,
    set to 0 before (a) and read after (c), must all be 0."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.recsys import make_cloze_batch
    from repro_torch.kernels import cuda_build
    from repro_torch.launch.serve import score_loop
    from repro_torch.models import bert4rec as b4

    dev = torch.device("cuda")
    cfg = get_arch("bert4rec").make_model_cfg()
    t_phase = t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = b4.init_bert4rec(cfg, gen, dev)
    torch.cuda.synchronize()
    n_params = b4.param_count(params)
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, the config says "
                             f"{cfg.param_count()}")
    emit({"phase": "bert4rec_init", "config": dataclasses.asdict(cfg),
          "params": n_params, "seconds": time.perf_counter() - t0})
    rng = np.random.default_rng(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()

    # (a) fp32 encoder, card vs CPU, 8 cloze users
    items = make_cloze_batch(rng, 8, cfg.max_len, cfg.vocab, cfg.mask_id,
                             device=dev)["items"]
    t0 = time.perf_counter()
    h = b4.bert4rec_encode(params, items, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    host = {k: ([{n: t.cpu() for n, t in b.items()} for b in v]
                if k == "blocks" else v.cpu()) for k, v in params.items()}
    h_cpu = b4.bert4rec_encode(host, items.cpu(), cfg)
    del host
    diff = (h.cpu() - h_cpu).abs()
    share = float((diff / (B4_RTOL + B4_RTOL * h_cpu.abs())).max())
    rec_a = {"phase": "bert4rec_encode_card_vs_cpu", "users": 8,
             "seq_len": cfg.max_len, "max_abs_err": float(diff.max()),
             "rtol": B4_RTOL, "atol": B4_RTOL, "tolerance_used": share,
             "card_seconds": secs}
    emit(rec_a)
    if h.shape != (8, cfg.max_len, cfg.d_model) or not share <= 1.0:
        raise AssertionError(f"fp32 encoder, card vs CPU: {rec_a}")
    del h, h_cpu, diff

    # (b) the serving loop: 512 users (serve_p99), top-10 over the table
    users = make_cloze_batch(rng, 512, cfg.max_len, cfg.vocab, cfg.mask_id,
                             device=dev)["items"]
    k = 10
    res = score_loop(params, users, cfg, top_k=k, reps=20)
    user32 = b4.bert4rec_encode(params, users, cfg)[:, -1, :]
    s32 = user32 @ params["item_emb"][: cfg.vocab].T  # fp32, no TF32
    top32 = s32.topk(k, dim=-1)
    tol = SCORE_TOL_OF_MAX * s32.abs().amax(dim=-1, keepdim=True)
    got = s32.gather(1, res.ids)
    margin = got - (top32.values[:, -1:] - tol)
    distinct = all(len(set(r)) == k for r in res.ids.tolist())
    hits = (res.ids[:, :, None] == top32.indices[:, None, :]).any(-1)
    rep_ms = sorted(1e3 * s for s in res.rep_seconds)
    rec_b = {"phase": "bert4rec_serve", "users": users.shape[0],
             "items": cfg.vocab, "top_k": k, "reps": len(rep_ms),
             "ms_per_batch": 1e3 * res.seconds_per_batch,
             "ms_p50": rep_ms[len(rep_ms) // 2], "ms_max": rep_ms[-1],
             "users_per_s": res.users_per_s,
             "recall_of_fp32_top10": float(hits.float().mean()),
             "score_tol_of_max": SCORE_TOL_OF_MAX,
             "score_tol_range": [float(tol.min()), float(tol.max())],
             "min_margin_over_tol": float(margin.min()),
             "bf16_score_err_max": float((res.scores - got).abs().max()),
             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    emit(rec_b)
    if res.ids.shape != (512, k) or not distinct \
            or not bool((margin >= 0).all()) \
            or not bool(res.scores.isfinite().all()):
        raise AssertionError(f"serving ids fail the tie-aware check: {rec_b}")
    del s32, top32, got, margin, hits, user32
    emit({"phase": "bert4rec_serve_breakdown",
          "ms": serve_breakdown(params, users, cfg, k)})

    # (c) retrieval: 1 user against 10⁶ candidates (retrieval_cand), top-5
    cell = {c.name: c for c in get_arch("bert4rec").shapes}["retrieval_cand"]
    cands = torch.from_numpy(rng.permutation(cfg.vocab)[:cell.n_candidates]
                             .astype(np.int32)).to(dev)
    one = users[:1]
    b4.bert4rec_retrieve(params, one, cands, cfg, top_k=5)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals, ids = b4.bert4rec_retrieve(params, one, cands, cfg, top_k=5)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    user = b4.bert4rec_encode(params, one, cfg)[0, -1].double()
    ref = params["item_emb"][cands.long()].double() @ user
    by_item = torch.full((cfg.table_size,), float("-inf"), device=dev,
                         dtype=torch.float64)
    by_item[cands.long()] = ref
    rv = ref.topk(5).values
    err = float((vals.double() - rv).abs().max())
    ok_ids = bool((by_item[ids.long()] >= rv[-1] - RETRIEVE_TOL).all()) \
        and len(set(ids.tolist())) == 5
    rec_c = {"phase": "bert4rec_retrieve", "candidates": cands.numel(),
             "top_k": 5, "seconds": secs, "max_abs_err_vs_float64": err,
             "atol": RETRIEVE_TOL}
    emit(rec_c)
    if not (err <= RETRIEVE_TOL and ok_ids):
        raise AssertionError(f"retrieval disagrees with float64: {rec_c}")
    torch.cuda.synchronize()
    launches = {name: cuda_build.launches.get(name, 0)
                for name in cuda_build.SOURCES}
    emit({"phase": "bert4rec_launches", "launches": launches,
          "seconds": time.perf_counter() - t_phase})
    if any(launches.values()):
        raise AssertionError(f"the BERT4Rec path launched {launches}; it "
                             "runs no port kernel")
    del params, users, cands, by_item, ref
    torch.cuda.empty_cache()
    return rec_b


def serve_breakdown(params: dict, users, cfg, k: int) -> dict:
    """Device ms (CUDA events) of each step of one ``bert4rec_score`` call,
    run step by step as the function runs them."""
    import torch

    from repro_torch.models import bert4rec as b4

    bf16 = torch.bfloat16
    p = b4.cast_params(params, bf16)
    user = b4.bert4rec_encode(p, users, cfg, dtype=bf16)[:, -1, :]
    table = p["item_emb"][: cfg.vocab]
    scores = user @ table.T
    scores32 = scores.float()
    return {
        "cast_params_bf16": cuda_ms(lambda: b4.cast_params(params, bf16),
                                    reps=5),
        "encode_bf16": cuda_ms(lambda: b4.bert4rec_encode(
            p, users, cfg, dtype=bf16), reps=5),
        "scores_matmul_bf16": cuda_ms(lambda: user @ table.T, reps=5),
        "scores_to_fp32": cuda_ms(lambda: scores.float(), reps=5),
        "topk": cuda_ms(lambda: torch.topk(scores32, k, dim=-1), reps=5),
        "whole_call": cuda_ms(lambda: b4.bert4rec_score(params, users, cfg,
                                                        top_k=k), reps=5)}


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

    # fp32 matmuls at full precision on every check path (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    from benchmarks import torch_embedding_bag_variants as ebv
    from benchmarks.torch_graph_kernel_variants import (
        PREVIOUS_SRC, PROBE_SRC, Floors, Previous, finish_build, start_build)
    from repro_torch.kernels import cuda_build

    t0 = time.perf_counter()
    probe_dir = tempfile.TemporaryDirectory()
    probe = start_build({"floor_probes": PROBE_SRC,
                         "previous_designs": PREVIOUS_SRC,
                         "embedding_bag_probes": ebv.PROBE_SRC,
                         "embedding_bag_previous": ebv.PREVIOUS_SRC},
                        Path(probe_dir.name))
    logs = cuda_build.build()
    probe_libs = finish_build(probe)
    floors = Floors(probe_libs["floor_probes"])
    previous = Previous(probe_libs["previous_designs"])
    eb_probes = ebv.Probes(probe_libs["embedding_bag_probes"])
    eb_previous = ebv.Previous(probe_libs["embedding_bag_previous"])
    probe_dir.cleanup()  # the libraries stay loaded
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(logs) + sorted(probe_libs)})
    for nm, text in logs.items():
        log(f"--- nvcc {nm} ---\n{text}")

    phase_kernels(SEED, log)
    phase_spmm_kernel(SEED, log)
    phase_attention_kernels(SEED, log)
    main_state = phase_main(SCALE, SEED, log)
    records = phase_timing(main_state, log, floors, previous)
    del main_state
    torch.cuda.empty_cache()
    lm = phase_lm(SEED, log)
    records += attention_timing(lm, SEED, log)
    records += phase_embedding_bag(SEED, log, eb_probes, eb_previous)
    phase_bert4rec(SEED, log)
    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
