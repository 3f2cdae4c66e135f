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
   bf16 ulp relative plus two of the mean |entry|.  Then the attention
   gradient through ``attention``'s autograd path, the backward that
   ``attention_bwd_route`` picks (bf16 D 64/128: ``flash_attention_bwd_
   wgmma`` on the tensor cores, one launch counted in both
   ``flash_attention_bwd`` and ``flash_attention_bwd_wgmma``; fp32:
   ``flash_attention_bwd``, FMA) against torch autograd of
   ``attention_ref`` (fp32, on the same values) at TinyLlama's training
   shape (bf16, 8 × 32/4 heads × 512 × 64, causal), the same as the
   transposed (B, S, H, D) views the LM passes, a Gemma-2-27B local layer
   (bf16, 1 × 32/16 heads × 4608 × 128, window 4096, softcap 50, the
   scores spread over the cap's range), a ragged one (bf16, 2 × 8/2 ×
   1000 × 64, bidirectional, window 300) and a smoke shape (fp32, D 16,
   bidirectional): max |error| of dq, dk and dv over their largest
   magnitude, at most 2⁻⁷ (bf16) and 1e-4 (fp32); a gradient without the
   softcap's tanh derivative must fail the Gemma case.  The tensor-core
   forward's logsumexp against ``attention_lse_ref`` at every bf16 case
   (``LSE_RTOL``), its output bit-equal with and without it; repeats of
   the tensor-core backward bit-equal; then the kernel timed at the
   TinyLlama shape beside its bound (2.5× the forward's flops), the PR 23
   FMA backward on the same operands (``previous_ms``), autograd of the
   plain version and SDPA's backward alone (``torch.autograd.grad`` of a
   retained forward, the median of 5 timed loops, its backend named from
   the profiler's kernel names); the kernel's and SDPA's backward's device
   time from ``torch.profiler`` beside them (SDPA's timed loop is
   host-bound when the host enqueues slower than the card runs).
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
9. Traversal on phase 4's graph, before phase 6 frees it
   (``repro_torch.core.traversal``): BFS from 8 Graph500 search keys
   drawn from ``SEED`` among vertices of out-degree ≥ 1, ``impl="fused"``
   and flat (``bg_pull=None``), and from the first key on the slab
   engine; BC from that key, fused, flat and ``schedule="balanced"`` (its
   σ pull reaches ``tocab_spmm``); BFS and BC on the layout's unweighted
   view (``edge_vals=None``: with ``combine=None`` they multiply by the
   edge value, so a weight-0 edge would not carry); SSSP from that key on
   the weighted layout (``ADD_EDGE``), fused and flat; CC fused and flat,
   with Gᵀ sorted on the card.  Depths, levels, direction counts,
   distances and labels equal the flat path's exactly, BC's σ and scores
   pass ``assert_close`` at fp32 defaults, and every result meets
   invariants over all edges (BFS: a parent one level up, no edge skips
   a level; SSSP: no edge relaxes, a tight in-edge per reached vertex;
   CC: equal labels across every edge, each label its own root).  Some
   BFS takes both Beamer directions; ``fused_pull`` launches at least
   once per fused pull (BFS pull levels, BC's levels and pull levels,
   SSSP and CC iterations), ``tocab_spmm`` at least once in balanced BC,
   each path's counts set to 0 just before it.  ``traversal`` lines give
   ms per traversal, levels or iterations, push/pull counts, GTEPS
   (out-edges of the reached vertices over seconds, Graph500's TEPS) and
   ms per push and per pull level (the time between two frontier reads).
10. Resilience and the tuner (``repro_torch.resilience``,
   ``repro_torch.tune``).  (a) On phase 4's layouts, right after phase 11:
   on the card the ladder stays off — an injected ``kernel.tocab_fused``
   fault makes PageRank ``gc-pull`` / ``gc-push`` ``impl="fused"`` raise
   ``ChaosError`` with ``allow_fallback=True`` as without it (no fallback
   recorded, no verdict memoized), and the opted-in run without a fault
   launches the kernel every iteration, ranks within ``PR_L1_TOL`` of
   ``base``; balanced SpMV with an injected ``kernel.tocab_spmm`` fault
   raises under the opt-in too, and launches ``tocab_spmm`` without one;
   ``impl="reference"`` SpMV; ``"auto"`` with an empty tuning DB (SpMV
   and BFS: a plan miss, uniform slab, α 15).  Exactly 5 resilience
   events (the 5 injected faults).
   (b) ``repro_torch.tune.tune`` on the card over the reference's suite
   (rmat14–16, grid256; values in L2, so the trials are launch-bound),
   workloads pagerank, spmv and bfs, budget ``small`` with the bin
   thresholds ``(4, 32)`` and ``"auto"`` (the first gives these graphs no
   dense block), in a temporary DB: entries keyed by the card's name,
   ``fused_pull``, ``fused_push`` and ``tocab_spmm`` launched, a second
   sweep served from the DB, and ``"auto"`` equal to the chosen candidate
   given explicitly (sums at ``SUM_RTOL``, PageRank at ``PR_L1_TOL``, BFS
   depths exactly); one ``tune`` line a graph.  (c) After phase 6: a short
   TinyLlama decode run (2 × (16 + 8) tokens, bf16) with one
   ``serve.batch`` fault, injected before a step and raised after a
   decode step has written the KV cache in place, gives the greedy tokens
   of the run without it, one retry each; after phase 8: ``score_loop``
   with a fault gives phase 8's ids and scores.
11. The paper's §3.1 ablations on phase 4's graph, right after phase 9
   (``repro_torch.core.ablations``): the 2D-blocked layout built on the
   card from ``dg``'s edge lists (CSR order) at phase 4's block, 3 × 3
   tiles (build seconds, ``edge_budget``, edges a tile, slots and peak
   memory printed); then one SpMV-shaped pull of phase 4's ``x`` through
   flat ``base``, ``tocab_pull`` slab and fused, ``tocab_pull_2d`` and
   ``propagation_blocking_pull`` at 16 bins (4 MB of fp32 a bin), each in
   ``sum`` (``SUM_RTOL`` and ``sum_atol``), ``min`` and ``max`` (exactly)
   against ``base``.  ``fused_pull`` launches once a fused call and no
   other engine launches a kernel.  One ``ablation`` line an engine: the
   median of 5 synchronised host-clock calls (ms, GTEPS), blocks, slots,
   and one call's device time by kernel (``torch.profiler``).  The layout
   is freed before phase 10(a).
12. MoE serving at full width, after phase 8 (``models/moe.py``: sorted
   binning, capacity slabs, expert ``bmm``, a fixed-order combine; random
   weights from ``SEED``, prompts from ``data.tokens``).  (a)
   Granite-MoE-3B-A800M at its published config (32 layers, d 1536, 40
   experts top-8): parameters equal ``cfg.param_count()``; fp32 forward
   vs one decode step a position on 2 × 128 tokens at capacity factor
   E / top_k (no drop), at ``LM_RTOL`` / ``LM_ATOL`` with equal greedy
   tokens; layer 0's MoE block at the published capacity factor 1.25 on
   8 × 2048 tokens of layer-0 activations, fp32, against a dense
   per-expert oracle written here (expert ids and kept set exactly,
   outputs at ``LM_RTOL`` / ``LM_ATOL``; dropped pairs printed); the
   serving loop 8 × (128 + 32), bf16, ``flash_decode`` exactly 32 times a
   decode step and ``flash_attention`` never; ``serve_prefill`` 8 × 2048,
   ``flash_attention`` exactly 32 times, all on the tensor cores; a
   repeated decode step bit-equal.  (b) Mixtral-8x22B at its published
   width (d 6144, 48/8 heads, D 128, 8 experts top-2, window 4096), depth
   cut to 2 layers (56 would be ~281 GB in bf16): fp32 forward vs decode;
   ``serve_prefill`` on 1 × 8192 tokens (the windowed tensor-core route at
   D 128), ``flash_attention`` exactly 2 times; the serving loop
   8 × (128 + 32), ``flash_decode`` exactly 2 times a step.  (c) Between
   the two: phase 10(c)'s retried decode run on Granite.  One
   ``moe_serve`` line an arch (ms a decode step, tokens/s, prefill
   seconds, the decode step's byte bound, one decode step's and one
   prefill's device time by op from ``torch.profiler``); the ``kernels``
   record's rows 4-5 gain each arch's launches (``moe``).
13. Training, after phase 12 (``repro_torch.train``, ``launch/train.py``,
   ``models/gnn.py``).  (a) TinyLlama-1.1B at its published config (fp32
   params, bf16 compute), AdamW with the cosine schedule, batch 8 × 512:
   step 0's gradient has every leaf finite and non-zero, and its loss and
   gradient norm agree with the same step on ``backend="torch"`` attention
   (2e-3 and 2e-2 relative); one step profiled (device idle share, and
   device time by kernel class); then
   ``launch.train.main`` for 12 steps, all losses finite,
   ``flash_attention``, ``flash_attention_wgmma``, ``flash_attention_bwd``
   and ``flash_attention_bwd_wgmma`` each launched exactly 22 times a step
   (step ms the median of steps 2-11, tokens/s, peak memory).  (b) An
   exact resume on the smoke TinyLlama: 6 steps against 4, a restore
   from ``LATEST`` and 2 more, losses and params bit-equal (under
   ``torch.use_deterministic_algorithms``).  (c) GAT-Cora (d_in 1433, 8 ×
   8 heads) for 100 steps on ``cora_like()`` through the TOCAB slab
   engines (``build_blocked(g, block_size=512)``), its flat and TOCAB
   forwards on the trained params within ``SUM_RTOL`` of the largest
   logit; GIN-TU (5 × 64) on the same layout for 20 steps;
   GraphSAGE-Reddit (602 → 128 → 41) on ``NeighborSampler`` batches of 512
   seeds (25-10) over ``reddit_like()``, 20 steps; DimeNet (6 × 128) on
   ``molecule_batch()``, 5 steps; no kernel launches, and ``fused_pull``
   on an input that requires grad raises.  (d) BERT4Rec at 10⁶ items: one
   sampled-softmax loss and backward on the card against the CPU (1e-4),
   and ``binned_embedding_grad`` against the flat sum (``SUM_RTOL`` of each
   row's sum of magnitudes).  The ``kernels`` record gains the
   ``flash_attention_bwd`` row, its launches from (a)'s 12 steps.
14. Distribution, after phase 13 (``repro_torch.dist``,
   ``train/trainer.py`` on a mesh): a one-rank NCCL group on the card
   (``FileStore``, no network; NCCL that cannot start fails the phase, no
   gloo fallback) and ``make_mesh_for()``, a (1, 1) ("data", "model")
   mesh on ``cuda``.  (a) ``dist_train``: TinyLlama-1.1B at its published
   config, 8 × 512, AdamW, 3 steps through ``Trainer(mesh=mesh)`` (every
   gradient leaf through ``all_reduce`` over the ``data`` group) against
   ``Trainer(mesh=None)`` from the same seed, both under
   ``torch.use_deterministic_algorithms``: losses and every parameter
   bit-equal, ``flash_attention`` and ``flash_attention_bwd`` 22 times a
   step, ms a step of both.  (b) ``dist_compress``: one step's gradients
   through ``make_dp_grad_fn(compress=True)`` twice (a non-zero residual):
   gradients ``(g + r).to(bf16).float()`` and residual ``(g + r) - that``
   bit for bit; ms of the plain, uncompressed and compressed gradient,
   peak memory.  (c) ``dist_topk``: ``distributed_topk`` at BERT4Rec's
   serve shape (512 × 10⁶ fp32 scores from the published model, k 100, 8
   blocks, plain-tensor form) and on the scores rounded to 16 values:
   values and ids those of a stable descending sort of each row;
   ``bert4rec_score`` under a ``model`` axis of 8 alike; ms against
   ``torch.topk``.  (d) ``dist_reshard``: TinyLlama's parameters
   ``reshard``-ed onto the mesh and back, a checkpoint saved from the mesh
   and restored with ``shardings=``: bit-equal.  The ``kernels`` record's
   rows 4 and 7 gain (a)'s launches (``launches_dist_train``).
15. Models on a mesh, after phase 14 (the models on DTensors,
   ``Trainer(mesh=)`` with a ``model`` axis, data-parallel MoE): two ranks
   on the one card, two threads of this process in torch's threaded
   process group (``mp_group``: NCCL refuses two ranks on one device, and
   gloo's functional collectives crashed its processes on CUDA tensors),
   each sub-phase against the same work on one device, run first.  (a) ``mp_train``:
   TinyLlama-1.1B at its published config, 8 × 512, AdamW, 3 steps on
   ("data", "model") = (1, 2), parameters placed by
   ``param_logical_axes``: step 0's loss at 2e-3 and gradient norm at 2e-2
   relative, steps 1-2's losses at 1e-2; ``flash_attention_wgmma`` and
   ``flash_attention_bwd_wgmma`` 22 times a step a rank on 16 q and 2 KV
   heads.  (b) ``mp_moe``: Granite-MoE-3B-A800M, 32 layers, fp32, experts
   over ``model`` (20 a rank): ``serve_prefill`` on 8 × 128, then 16
   prompt tokens decoded into a cache split by ``kv_heads`` and 16 greedy
   steps; logits at rtol 1e-3, atol 1e-4, greedy tokens equal, expert ids
   and kept sets equal but at (token, slot) pairs whose router top-k gap
   is < 1e-5 (counted); ``flash_attention`` once a layer and
   ``flash_decode`` once a layer a step, on 12 q and 4 KV heads a rank.
   (c) ``mp_moe_dp``: Granite at published width cut to 4 layers, bf16,
   3 AdamW steps on (2, 1) (each rank its block of 8 × 512, the aux
   loss's means all-reduced) against one device under
   ``use_mesh_rules({"data": 2, "model": 1})``: losses (aux included)
   at (a)'s tolerances, and the aux of step 0's batch in an fp32 forward
   at 1e-5 (bf16 rounds the router's inputs by GEMM shape).  (d)
   ``mp_bert4rec``:
   ``bert4rec_score`` of 512 users at 10⁶ items on (1, 2), the scores
   split by ``vocab``: ids tie-aware as in phase 8, recall of one device's
   top 10.  (e) ``mp_gnn``: GraphSAGE-Reddit, 512 seeds, ``binned_edges``
   on a stripe-laid batch, one gradient on (2, 1): loss and every gradient
   within ``SUM_RTOL`` of the largest.  Each line: seconds and launches
   per rank, the peak memory of both ranks, ``gathered_ops``; rows 4, 5
   and 7 of the ``kernels`` record gain ``launches_model_parallel``.
16. The dry-run, the roofline and the examples, after phase 15.  (a)
   ``repro_torch.launch.dryrun.run_cell`` in a subprocess (its fake process
   groups of 256 and 512 ranks never meet phases 14-15's): TinyLlama-1.1B
   × train_4k, Granite-MoE-3B-A800M × decode_32k, GAT-Cora ×
   full_graph_sm and BERT4Rec × serve_p99 on ``h100x32x8``, TinyLlama ×
   train_4k also on ``h100x2x32x8``; each ``ok``, a dense LM's
   ``useful_flop_frac`` ≤ 1.05; one ``dryrun`` line a cell.  (b) The
   counter held against the card: phase 13's TinyLlama training step
   (8 × 512) and one ``serve_prefill`` (8 × 2048) counted on the card and
   on meta tensors (no mesh): the meta count less the card's is exactly
   the FLOPs the meta run booked under the plain attention's scope (the
   card's kernels are ``ctypes`` launches no dispatch mode sees); the
   tracker's peak beside ``max_memory_allocated``.  (c) ``roofline_card``:
   the step's roofline bound from (b)'s meta count (the plain attention,
   as the dry-run counts it) and from the card's (the kernels left out,
   so a bound the step cannot beat), phase 13's median step,
   ``roofline_fraction``, ``mfu``, ``useful_flop_frac`` and the card-op
   bound's share of the step, none above 1.05; the meta tracker's peak
   beside phase 13's.  (d) The three examples through ``main(["--device",
   "cuda", ...])``: ``torch_train_lm`` 60 steps (loss falls), resumed to
   70, ``flash_attention_wgmma`` and ``flash_attention_bwd_wgmma`` 8
   launches a step (rows 4 and 7 gain ``launches_examples``);
   ``torch_serve_recsys`` (cross-entropy falls, top-10 ids in range, no
   kernel launched); ``torch_quickstart`` (slab engines, no kernel
   launched: each PageRank variant within ``PR_L1_TOL`` of ``base`` and 2
   iterations, BFS depths equal to the flat path's, the cache model's
   rates equal to a second host replay).
   Guards: the script refuses to run with ``REPRO_CHAOS`` armed, and
   phases 4, 6, 8, 9, 10(b), 11, 12(a), 12(b), 13, 14, 15 and 16 must end
   with no ``resilience.*`` counter moved (``resilience_quiet`` lines).

Output: one JSON record per line; the last two lines are the kernels'
record and ``{"ok": true, "device": {...}}``.  ``--log PATH`` appends the
detail (each case's error, the compiler's register report) to PATH.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import tempfile
import threading
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
            "launches": launches, "n": n, "m": m, "x": x, "y_base": y_base,
            "base_rank": base_rank, "base_iters": base_iters}


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
# phase 9: traversal on the main path's graph
# --------------------------------------------------------------------- #
#: BFS search keys drawn from SEED among vertices of out-degree ≥ 1:
#: Graph500 draws 64; 8 keep the phase inside the script's time budget
TRAVERSAL_SOURCES = 8


class LevelClock:
    """Wall time of each traversal level by Beamer direction, with no sync
    added: a level lies between two frontier reads of
    ``repro_torch.core.traversal``, each of which waits for the card."""

    def __init__(self):
        from repro_torch.core import traversal

        self._cls = traversal._Frontier
        self._orig = self._cls.direction
        self.stamps = []

    def __enter__(self):
        orig, stamps = self._orig, self.stamps

        def direction(state, algo):
            use_pull = orig(state, algo)
            stamps.append((time.perf_counter(), use_pull))
            return use_pull

        self._cls.direction = direction
        return self

    def __exit__(self, *exc):
        self._cls.direction = self._orig

    def take(self) -> dict:
        """ms of the push and the pull levels since the last take."""
        out = {"push_level_ms": [], "pull_level_ms": []}
        for (t0, use_pull), (t1, _) in zip(self.stamps, self.stamps[1:]):
            if use_pull is not None:
                key = "pull_level_ms" if use_pull else "push_level_ms"
                out[key].append(1e3 * (t1 - t0))
        self.stamps.clear()
        return out


def transpose_on_card(dg):
    """Gᵀ as a DeviceGraph built on the card from ``dg``'s arrays (stable
    sort by destination), unweighted: CC's backward pull."""
    import torch

    from repro_torch.core import DeviceGraph

    order = torch.sort(dg.dst, stable=True).indices
    rowptr = torch.zeros(dg.n + 1, dtype=torch.int32, device=dg.device)
    rowptr[1:] = torch.cumsum(dg.in_degree, 0)
    return DeviceGraph(n=dg.n, src=dg.dst[order], dst=dg.src[order],
                       rowptr=rowptr, out_degree=dg.in_degree,
                       in_degree=dg.out_degree)


def timed_run(fn):
    """(result, seconds) of ``fn()`` between two synchronisations."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_bfs_invariants(what: str, dg, depth, source: int):
    """Every reached vertex but the source has an in-neighbour one level
    up, and no edge skips a level (every edge carries: unweighted)."""
    import torch

    from repro_torch.core import INF_DEPTH

    du, dv = depth[dg.src.long()], depth[dg.dst.long()]
    if bool(((du < INF_DEPTH) & (dv > du + 1)).any()):
        raise AssertionError(f"{what}: an edge skips a level")
    parent = torch.zeros(dg.n, dtype=torch.bool, device=depth.device)
    parent[dg.dst.long()[(du < INF_DEPTH) & (dv == du + 1)]] = True
    parent[source] = True
    if not bool(parent[depth < INF_DEPTH].all()):
        raise AssertionError(f"{what}: a reached vertex has no parent")


def check_sssp_invariants(what: str, dg, dist, source: int):
    """dist[v] ≤ dist[u] + w on every edge (in fp32, as relaxed), with
    equality on some in-edge of each reached vertex but the source."""
    import torch

    cand = dist[dg.src.long()] + dg.vals
    dv = dist[dg.dst.long()]
    if not bool((dv <= cand).all()):
        raise AssertionError(f"{what}: an edge still relaxes")
    tight = torch.zeros(dg.n, dtype=torch.bool, device=dist.device)
    tight[dg.dst.long()[(cand == dv) & torch.isfinite(cand)]] = True
    tight[source] = True
    if not bool(tight[torch.isfinite(dist)].all()):
        raise AssertionError(f"{what}: a reached vertex has no tight edge")


def check_cc_invariants(what: str, dg, labels):
    lab = labels.long()
    if not bool((lab[dg.src.long()] == lab[dg.dst.long()]).all()):
        raise AssertionError(f"{what}: an edge joins two labels")
    if not bool((lab[lab] == lab).all()):
        raise AssertionError(f"{what}: a label is not its own root")


def check_exact(what: str, out, ref):
    import torch

    if out.shape != ref.shape or not torch.equal(out, ref):
        bad = int((out != ref).sum()) if out.shape == ref.shape else -1
        raise AssertionError(f"{what}: {bad} entries differ from the flat "
                             "path (must match exactly)")


def close_stats(out, ref) -> dict:
    """max |out - ref| and the worst entry's share of assert_close's fp32
    defaults (rtol 1.3e-6, atol 1e-5)."""
    import torch

    diff = (out - ref).abs()
    share = diff / (1e-5 + 1.3e-6 * ref.abs())
    return {"max_abs_err": float(diff.max()),
            "tolerance_used": float(share.max()),
            "nonfinite": int((~torch.isfinite(ref)).sum())}


def reached_edges(dg, reached) -> int:
    """Edges of the traversed component: out-edges of reached vertices."""
    import torch

    return int(torch.where(reached, dg.out_degree, 0).sum(dtype=torch.int64))


def phase_traversal(main: dict, seed: int, log) -> dict:
    """BFS, BC, SSSP and CC on the main path's scale-24 graph: fused,
    flat, and slab (BFS) or balanced (BC), each held against the flat path
    and invariants over all edges; returns the launch counts."""
    import torch

    from benchmarks.torch_paper_figs import search_keys
    from repro_torch.core import (INF_DEPTH, bc, bfs, connected_components,
                                  sssp)
    from repro_torch.kernels import cuda_build

    t_phase = time.perf_counter()
    dg, bp = main["dg"], main["pull"]
    n, m = main["n"], main["m"]
    # BFS and BC multiply the frontier by the edge value (reference
    # semantics): they run on the layout's unweighted view
    dgu = dataclasses.replace(dg, vals=None)
    bpu = dataclasses.replace(bp, edge_vals=None)
    zero_weight = int((dg.vals == 0).sum())
    sources = search_keys(dg.out_degree, TRAVERSAL_SOURCES, seed)
    launches = {}
    lines = []
    clock = LevelClock()

    def record(algo, engine, runs, edges, **extra):
        secs = [r["seconds"] for r in runs]
        gteps = [e / s / 1e9 for e, s in zip(edges, secs)]
        line = {"phase": "traversal", "algo": algo, "engine": engine,
                "ms": [1e3 * s for s in secs], "gteps": gteps,
                "gteps_hmean": len(gteps) / sum(1 / g for g in gteps),
                "traversed_edges": edges, "zero_weight_edges": zero_weight,
                **{k: [r[k] for r in runs] for k in runs[0]
                   if k != "seconds"},
                **extra}
        emit(line)
        lines.append(line)

    def launched(name, label, want):
        got = dict(cuda_build.launches)
        launches[label] = got
        if got.get(name, 0) < want:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{got.get(name, 0)} times, fewer than "
                                 f"the {want} its runs need")

    with clock:
        # ---- BFS: 8 search keys, fused and flat; one slab ---- #
        results = {}
        for engine, bg_, kw in (("fused", bpu, {"impl": "fused"}),
                                ("flat", None, {})):
            torch.cuda.synchronize()
            cuda_build.reset_launches()
            runs, edges, levels = [], [], {"push_level_ms": [],
                                           "pull_level_ms": []}
            for s in sources:
                (depth, lv, n_push, n_pull), secs = timed_run(
                    lambda: bfs(dgu, bg_, s, **kw))
                for k, v in clock.take().items():
                    levels[k] += v
                results[(engine, s)] = (depth, lv, n_push, n_pull)
                runs.append({"source": s, "seconds": secs, "levels": lv,
                             "n_push": n_push, "n_pull": n_pull})
                edges.append(reached_edges(dgu, depth < INF_DEPTH))
            if engine == "fused":
                launched("fused_pull", "bfs/fused",
                         sum(r["n_pull"] for r in runs))
            record("bfs", engine, runs, edges, **levels)
        s0 = sources[0]
        (depth, lv, n_push, n_pull), secs = timed_run(
            lambda: bfs(dgu, bpu, s0, impl="slab"))
        record("bfs", "slab", [{"source": s0, "seconds": secs, "levels": lv,
                                "n_push": n_push, "n_pull": n_pull}],
               [reached_edges(dgu, depth < INF_DEPTH)], **clock.take())
        results[("slab", s0)] = (depth, lv, n_push, n_pull)
        for (engine, s), (depth, lv, n_push, n_pull) in results.items():
            flat = results[("flat", s)]
            check_exact(f"bfs/{engine} from {s}: depth", depth, flat[0])
            if (lv, n_push, n_pull) != flat[1:]:
                raise AssertionError(f"bfs/{engine} from {s}: levels and "
                                     f"directions {(lv, n_push, n_pull)} "
                                     f"!= flat {flat[1:]}")
            if engine == "fused":
                check_bfs_invariants(f"bfs from {s}", dgu, depth, s)
        both = [s for s in sources if results[("fused", s)][2] >= 1
                and results[("fused", s)][3] >= 1]
        if not both:
            raise AssertionError("no BFS took both Beamer directions")
        del results

        # ---- BC from one key: fused, flat, balanced ---- #
        bc_out = {}
        for engine, bg_, kw in (("fused", bpu, {"impl": "fused"}),
                                ("flat", None, {}),
                                ("balanced", bpu, {"schedule": "balanced"})):
            torch.cuda.synchronize()
            cuda_build.reset_launches()
            (scores, depth, sigma), secs = timed_run(
                lambda: bc(dgu, bg_, s0, **kw))
            levels = clock.take()
            n_levels = len(levels["push_level_ms"]) + len(
                levels["pull_level_ms"])
            if engine == "fused":  # σ through fused_pull at every level
                launched("fused_pull", "bc/fused",
                         n_levels + len(levels["pull_level_ms"]))
            elif engine == "balanced":
                launched("tocab_spmm", "bc/balanced", 1)
            bc_out[engine] = (scores, depth, sigma)
            record("bc", engine, [{"source": s0, "seconds": secs,
                                   "levels": n_levels,
                                   "forward_ms": sum(
                                       levels["push_level_ms"]
                                       + levels["pull_level_ms"])}],
                   [reached_edges(dgu, depth < INF_DEPTH)], **levels)
        scores_f, depth_f, sigma_f = bc_out["flat"]
        for engine in ("fused", "balanced"):
            scores, depth, sigma = bc_out[engine]
            check_exact(f"bc/{engine}: depth", depth, depth_f)
            stats = {"sigma": close_stats(sigma, sigma_f),
                     "scores": close_stats(scores, scores_f)}
            emit({"phase": "traversal_bc_vs_flat", "engine": engine,
                  **stats})
            torch.testing.assert_close(
                sigma, sigma_f, msg=lambda t: f"bc/{engine} sigma: {t}")
            torch.testing.assert_close(
                scores, scores_f, msg=lambda t: f"bc/{engine} scores: {t}")
        del bc_out, scores_f, depth_f, sigma_f

    # ---- SSSP on the weighted layout: fused and flat ---- #
    sssp_out = {}
    for engine, bg_, kw in (("fused", bp, {"impl": "fused"}),
                            ("flat", None, {})):
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        (dist, iters), secs = timed_run(lambda: sssp(dg, bg_, s0, **kw))
        if engine == "fused":
            launched("fused_pull", "sssp/fused", iters)
        sssp_out[engine] = dist
        record("sssp", engine, [{"source": s0, "seconds": secs,
                                 "iterations": iters}],
               [reached_edges(dg, torch.isfinite(dist))],
               ms_per_iteration=1e3 * secs / iters)
    check_exact("sssp/fused: dist", sssp_out["fused"], sssp_out["flat"])
    check_sssp_invariants("sssp", dg, sssp_out["fused"], s0)
    del sssp_out

    # ---- CC: fused and flat, Gᵀ built on the card ---- #
    if n > 2 ** 24:
        raise AssertionError(f"CC's fp32 labels are exact only up to 2^24 "
                             f"vertices, this graph has {n}")
    (dg_t, t_secs) = timed_run(lambda: transpose_on_card(dg))
    emit({"phase": "traversal_transpose", "where": "card",
          "seconds": t_secs})
    cc_out = {}
    for engine, bg_, kw in (("fused", bp, {"impl": "fused"}),
                            ("flat", None, {})):
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        (labels, iters), secs = timed_run(
            lambda: connected_components(dg, dg_t, bg_, **kw))
        if engine == "fused":
            launched("fused_pull", "cc/fused", iters)
        cc_out[engine] = labels
        record("cc", engine, [{"seconds": secs, "iterations": iters}], [m],
               ms_per_iteration=1e3 * secs / iters,
               components=int(torch.unique(labels).numel()))
    check_exact("cc/fused: labels", cc_out["fused"], cc_out["flat"])
    check_cc_invariants("cc", dg, cc_out["fused"])
    del cc_out, dg_t
    emit({"phase": "traversal_launches", "launches": launches,
          "phase_seconds": time.perf_counter() - t_phase})
    log(f"traversal: sources={sources} zero_weight_edges={zero_weight}")
    return launches


# --------------------------------------------------------------------- #
# phase 11: the paper's §3.1 ablations on the main path's graph
# --------------------------------------------------------------------- #
#: propagation blocking's bins at scale 24: 1,048,576 vertices, 4 MB of
#: fp32 a bin (the reference figure's count)
ABLATION_BINS = 16
#: timed calls per engine after one warm-up (median taken)
ABLATION_REPS = 5


def device_breakdown(fn, top: int = 4) -> dict:
    """Device time of one ``fn()`` by kernel, from ``torch.profiler``'s
    CUDA activity: the sum over kernels and the ``top`` largest (name cut
    to 80 characters, ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key[:80], e.device_time_total / 1e3)
                   for e in prof.key_averages() if e.device_time_total > 0),
                  key=lambda r: -r[1])
    return {"device_ms": sum(ms for _, ms in rows),
            "top": [list(r) for r in rows[:top]]}


def phase_ablation(main: dict, log):
    """One SpMV-shaped pull of the main path's ``x`` through flat ``base``,
    TOCAB slab and fused, 2D blocking and propagation blocking, each
    semiring held against ``base``; the 2D layout is built on the card from
    ``dg``'s edge lists at phase 4's block and freed on return."""
    import torch

    from repro_torch.core import baseline_pull, tocab_pull
    from repro_torch.core.ablations import (build_blocked_2d,
                                            propagation_blocking_pull,
                                            tocab_pull_2d)
    from repro_torch.kernels import cuda_build

    dg, bp, x, m = main["dg"], main["pull"], main["x"], main["m"]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    b2, secs = timed_run(lambda: build_blocked_2d(dg, bp.block_size))
    tile_edges = b2.edge_mask.sum(1).tolist()
    slots_2d = b2.num_tiles * b2.edge_budget
    layout_bytes = sum(t.numel() * t.element_size() for t in (
        b2.src_rel, b2.dst_rel, b2.edge_mask, b2.edge_vals))
    emit({"phase": "ablation_build", "block_size": b2.block_size,
          "tiles_per_side": b2.tiles_per_side,
          "edge_budget": b2.edge_budget, "tile_edges": tile_edges,
          "slots": slots_2d, "slots_per_edge": slots_2d / m,
          "seconds": secs, "layout_gb": layout_bytes / 1e9,
          "build_peak_gb": (torch.cuda.max_memory_allocated() - held) / 1e9,
          "held_before_gb": held / 1e9})
    if sum(tile_edges) != m or b2.m != m:
        raise AssertionError(f"2D layout holds {sum(tile_edges)} edges of "
                             f"{m}")
    engines = {
        "base": (lambda r: baseline_pull(dg, x, r), 1, m),
        "tocab_1d/slab": (lambda r: tocab_pull(bp, x, r), bp.num_blocks,
                          bp.num_blocks * bp.edge_budget),
        "tocab_1d/fused": (lambda r: tocab_pull(bp, x, r, impl="fused"),
                           bp.num_blocks, bp.num_blocks * bp.edge_budget),
        "blocked_2d": (lambda r: tocab_pull_2d(b2, x, r), b2.num_tiles,
                       slots_2d),
        "prop_blocking": (lambda r: propagation_blocking_pull(
            dg, x, ABLATION_BINS, r), ABLATION_BINS, m),
    }
    # base is also held against its own first call: its sum adds with
    # atomics, so even that is exact only for min and max
    refs = {r: engines["base"][0](r) for r in ("sum", "min", "max")}
    for name, (fn, blocks, slots) in engines.items():
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        checks = {}
        for reduce, ref in refs.items():
            out = fn(reduce)
            if out.shape != ref.shape:
                raise AssertionError(f"ablation {name}/{reduce}: shape "
                                     f"{tuple(out.shape)}")
            err, atol, used = check_close(f"ablation {name}/{reduce} vs "
                                          "base", out, ref, reduce)
            checks[reduce] = {"max_abs_err": err, "atol": atol,
                              "tolerance_used": used}
            del out
        torch.cuda.synchronize()
        launches = dict(cuda_build.launches)
        want = 3 if name == "tocab_1d/fused" else 0
        if launches.get("fused_pull", 0) != want or \
                sum(launches.values()) != want:
            raise AssertionError(f"ablation {name}: launches {launches}, "
                                 f"want fused_pull {want} for 3 calls")
        timed_run(lambda: fn("sum"))  # warm-up
        times = [timed_run(lambda: fn("sum"))[1]
                 for _ in range(ABLATION_REPS)]
        ms = 1e3 * sorted(times)[len(times) // 2]
        line = {"phase": "ablation", "engine": name, "ms": ms,
                "ms_all": [1e3 * t for t in times], "gteps": m / ms / 1e6,
                "blocks": blocks, "slots": slots, "launches": launches,
                "sum_rtol": SUM_RTOL, "checks": checks,
                "device": device_breakdown(lambda: fn("sum"))}
        emit(line)
        log(json.dumps(line))
    del b2, refs
    torch.cuda.empty_cache()


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
    the main path's shapes, and in bf16 at the MoE archs' shapes."""
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
        return share

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

    # the MoE archs' shapes in bf16 (phase 12): Granite's prefill (24 query
    # / 8 KV heads of 64, a group of 3, causal, 8 × 2048) and Mixtral's
    # (48 / 8 heads of 128, a group of 6, window 4096, 1 × 8192: past the
    # window), both on the tensor cores; their decode caches (160 slots,
    # and Mixtral's full 4096-slot ring).  The plain version runs one KV
    # head at a time, which bounds its fp32 scores at 1.6 GB
    def attention_ref_by_kv_head(q, k, v, **kw):
        g = q.shape[1] // k.shape[1]
        return torch.cat([attention_ref(q[:, h * g:(h + 1) * g],
                                        k[:, h:h + 1], v[:, h:h + 1], **kw)
                          for h in range(k.shape[1])], dim=1)

    moe_shapes = {}
    for arch, (B, Hq, Hkv, S, D, window) in (
            ("granite", (8, 24, 8, 2048, 64, 0)),
            ("mixtral", (1, 48, 8, 8192, 128, 4096))):
        q = rand(B, Hq, S, D, dtype=bf16)
        k, v = (rand(B, Hkv, S, D, dtype=bf16) for _ in range(2))
        n_tc = cuda_build.launches["flash_attention_wgmma"]
        out = flash_attention_cuda(q, k, v, causal=True, window=window)
        ref = attention_ref_by_kv_head(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        if cuda_build.launches["flash_attention_wgmma"] != n_tc + 1:
            raise AssertionError(f"flash_attention: {arch}'s bf16 prefill "
                                 "did not take the tensor-core kernel")
        on_tc += 1
        what = (f"{bf16} q={tuple(q.shape)} kv={tuple(k.shape)} causal "
                f"window={window} wgmma ({arch})")
        moe_shapes[f"flash_attention {what}"] = record(
            "flash_attention", what, out, ref)
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    for arch, (B, Hq, Hkv, S, D) in (
            ("granite", (8, 24, 8, 160, 64)),
            ("mixtral", (8, 48, 8, 160, 128)),
            ("mixtral", (8, 48, 8, 4096, 128))):
        q = rand(B, Hq, 1, D, dtype=bf16)
        k, v = (rand(B, Hkv, S, D, dtype=bf16) for _ in range(2))
        for kv_len in sorted({S, S // 2 + 1}):
            out = flash_decode(q, k, v, kv_len=kv_len)
            ref = flash_decode_ref(q, k, v, kv_len=kv_len)
            torch.cuda.synchronize()
            what = (f"{bf16} q={tuple(q.shape)} kv={tuple(k.shape)} "
                    f"kv_len={kv_len} ({arch})")
            moe_shapes[f"flash_decode {what}"] = record("flash_decode", what,
                                                        out, ref)
        del q, k, v
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
          "moe_shapes_tolerance_used": moe_shapes,
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
    just before (b) and (c) and read just after; no forward of the phase
    stores a logsumexp (only the autograd path's does)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import kernel as attn_kernel
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models import transformer as tfm

    lse_before = sum(attn_kernel.lse_stores.values())
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
    if sum(attn_kernel.lse_stores.values()) != lse_before:
        raise AssertionError("a forward of the serving phase stored a "
                             "logsumexp")
    del master
    return {"params": params,  # phase 10(c) serves with them, then frees
            "launches": {"flash_decode": launches_b.get("flash_decode", 0),
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
    del cands, by_item, ref
    # phase 10(c) scores these users again, with a fault, then frees them
    return {"params": params, "users": users, "cfg": cfg, "result": res}


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


# --------------------------------------------------------------------- #
# phase 10: resilience and the tuner
# --------------------------------------------------------------------- #
def counter(name: str, **labels) -> float:
    from repro_torch.obs.metrics import registry

    return registry.counter(name).value(**labels)


def resilience_total() -> float:
    """Sum of every ``resilience.*`` counter of the port's registry
    (retries, fallbacks, injected faults, timeouts, exhausted retries)."""
    from repro_torch.obs.metrics import registry

    return sum(s["value"] for name, m in registry.snapshot().items()
               if name.startswith("resilience.") for s in m["series"])


def check_quiet(after: str, before: float) -> float:
    """Raise unless no ``resilience.*`` counter moved since ``before``:
    outside phase 10 nothing may retry or fall back.  Returns the total."""
    now = resilience_total()
    emit({"phase": "resilience_quiet", "after": after,
          "resilience_events": now - before})
    if now != before:
        raise AssertionError(f"{after} recorded {now - before} resilience "
                             "events (retries, fallbacks) where phase 10 "
                             "injected none")
    return now


def phase_ladder(main: dict, seed: int, log) -> dict:
    """Phase 10(a): the ladder on phase 4's scale-24 layouts.  On the card
    it stays off, ``allow_fallback=True`` or not: an injected fault at the
    fused dispatch or the dense bin's kernel raises, nothing falls back or
    is memoized, and the opted-in calls without a fault launch their
    kernels; ``impl="reference"``; ``"auto"`` with an empty tuning DB."""
    import os

    import torch

    from benchmarks.torch_paper_figs import search_keys
    from repro_torch.core import bfs, pagerank, spmv
    from repro_torch.kernels import cuda_build
    from repro_torch.resilience import ChaosError, chaos, degrade
    from repro_torch.tune import plan as tune_plan

    t_phase = time.perf_counter()
    dg, x, y_base = main["dg"], main["x"], main["y_base"]
    base_rank, base_iters = main["base_rank"], main["base_iters"]
    total0 = resilience_total()
    degrade.clear()
    lines = []

    def fallbacks():
        from repro_torch.obs.metrics import registry

        return sum(s["value"] for s in registry.snapshot().get(
            "resilience.fallbacks", {"series": []})["series"])

    def launched(fn):
        cuda_build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(cuda_build.launches)

    def raises(site, fn) -> bool:
        chaos.inject(site)
        try:
            fn()
        except ChaosError:
            return True
        return False

    def expect(ok: bool, what: str, rec: dict):
        if not ok:
            raise AssertionError(f"{what}: {rec}")

    for variant, bg, site, kernel in (
            ("gc-pull", main["pull"], "tocab_pull", "fused_pull"),
            ("gc-push", main["push"], "tocab_push", "fused_push")):
        f0 = fallbacks()
        rec = {"phase": "ladder", "engine": site, "variant": variant}
        # a fault raises, with the opt-in or without it
        for opt in (None, True):
            rec[f"allow_fallback={opt}_raised"] = raises(
                "kernel.tocab_fused", lambda: pagerank(
                    dg, bg, variant=variant, impl="fused", tol=1e-6,
                    allow_fallback=opt))
        rec.update(fallbacks=fallbacks() - f0,
                   verdict=degrade.apply_verdict(bg.fingerprint, site,
                                                 "fused"))
        expect(rec["allow_fallback=None_raised"]
               and rec["allow_fallback=True_raised"]
               and rec["fallbacks"] == 0 and rec["verdict"] == "fused",
               f"{variant}: a fault on the card must raise, opt-in or not",
               rec)
        # an opted-in run without a fault launches the kernel every
        # iteration
        t0 = time.perf_counter()
        (rank, iters), counts = launched(lambda: pagerank(
            dg, bg, variant=variant, impl="fused", allow_fallback=True,
            tol=1e-6))
        secs = time.perf_counter() - t0
        l1 = float((rank - base_rank).abs().sum())
        rec.update(iterations=iters, base_iterations=base_iters,
                   kernel_launches=counts.get(kernel, 0), l1_vs_base=l1,
                   pr_l1_tol=PR_L1_TOL, seconds=secs,
                   ms_per_iteration=1e3 * secs / iters)
        expect(rec["kernel_launches"] == iters
               and bool(rank.isfinite().all()) and l1 <= PR_L1_TOL
               and abs(iters - base_iters) <= 1,
               f"{variant}: an opted-in run must launch {kernel}", rec)
        emit(rec)
        lines.append(rec)

    # the balanced dense bin: the tocab_spmm kernel, no onehot rung
    bp = main["pull"]
    f0 = fallbacks()
    rec = {"phase": "ladder", "engine": "tocab_spmm (balanced dense bin)",
           "allow_fallback=True_raised": raises(
               "kernel.tocab_spmm", lambda: spmv(
                   dg, bp, x, variant="gc-pull", schedule="balanced",
                   allow_fallback=True, scale=2.5))}
    t0 = time.perf_counter()
    y, counts = launched(lambda: spmv(dg, bp, x, variant="gc-pull",
                                      schedule="balanced",
                                      allow_fallback=True, scale=2.5))
    rec.update(fallbacks=fallbacks() - f0,
               kernel_launches=counts.get("tocab_spmm", 0),
               seconds=time.perf_counter() - t0,
               max_abs_err_vs_base=check_close(
                   "opted-in balanced spmv", y, y_base, "sum")[0])
    emit(rec)
    expect(rec["allow_fallback=True_raised"] and rec["fallbacks"] == 0
           and rec["kernel_launches"] >= 1,
           "the dense bin must raise on a fault and launch without one",
           rec)

    # impl="reference": the last rung, run directly
    ref0 = counter("tocab.engine_traces", engine="tocab_pull_reference",
                   direction="pull")
    t0 = time.perf_counter()
    y, counts = launched(lambda: spmv(dg, bp, x, variant="gc-pull",
                                      impl="reference", scale=2.5))
    rec = {"phase": "ladder", "engine": "impl=reference",
           "reference_calls": counter(
               "tocab.engine_traces", engine="tocab_pull_reference",
               direction="pull") - ref0,
           "launches": counts, "seconds": time.perf_counter() - t0,
           "max_abs_err_vs_base": check_close("spmv impl=reference", y,
                                              y_base, "sum")[0]}
    emit(rec)
    expect(rec["reference_calls"] == 1 and not any(counts.values()),
           "impl='reference' runs the reference rung and no kernel", rec)

    # "auto" with an empty tuning DB: a plan miss, uniform slab, α 15
    old_dir = os.environ.get("REPRO_TUNE_DIR")
    with tempfile.TemporaryDirectory() as empty:
        os.environ["REPRO_TUNE_DIR"] = empty
        tune_plan.clear_cache()
        try:
            # the host cost of a first lookup on an empty DB, alone
            t0 = time.perf_counter()
            tune_plan.resolve_plan(bp, "spmv")
            lookup = time.perf_counter() - t0
            tune_plan.clear_cache()
            miss0 = counter("tune.plan_lookups", result="miss",
                            workload="spmv")
            slab0 = counter("tocab.engine_traces", engine="tocab_pull",
                            direction="pull")
            y, counts = launched(lambda: spmv(dg, bp, x, variant="gc-pull",
                                              schedule="auto", impl="auto",
                                              scale=2.5))
            rec = {"phase": "ladder", "engine": "auto, empty tuning DB",
                   "first_plan_lookup_seconds": lookup,
                   "spmv_plan_misses": counter(
                       "tune.plan_lookups", result="miss",
                       workload="spmv") - miss0,
                   "spmv_slab_calls": counter(
                       "tocab.engine_traces", engine="tocab_pull",
                       direction="pull") - slab0,
                   "spmv_launches": counts,
                   "spmv_max_abs_err_vs_base": check_close(
                       "spmv auto", y, y_base, "sum")[0]}
            dgu = dataclasses.replace(dg, vals=None)
            bpu = dataclasses.replace(bp, edge_vals=None)
            src = search_keys(dg.out_degree, 1, seed)[0]
            miss0 = counter("tune.plan_lookups", result="miss",
                            workload="bfs")
            t0 = time.perf_counter()
            auto, counts = launched(lambda: bfs(
                dgu, bpu, src, schedule="auto", impl="auto", alpha=None))
            secs = time.perf_counter() - t0
            flat = bfs(dgu, None, src, alpha=15.0)
            rec.update(bfs_source=src, bfs_plan_misses=counter(
                "tune.plan_lookups", result="miss", workload="bfs") - miss0,
                bfs_levels=auto[1:], flat_levels=flat[1:],
                bfs_launches=counts, bfs_seconds=secs)
            check_exact("bfs auto vs flat: depth", auto[0], flat[0])
        finally:
            if old_dir is None:
                os.environ.pop("REPRO_TUNE_DIR", None)
            else:
                os.environ["REPRO_TUNE_DIR"] = old_dir
            tune_plan.clear_cache()
    emit(rec)
    expect(rec["spmv_plan_misses"] >= 1 and rec["spmv_slab_calls"] == 1
           and not any(rec["spmv_launches"].values())
           and rec["bfs_plan_misses"] >= 1
           and rec["bfs_levels"] == rec["flat_levels"]
           and not any(rec["bfs_launches"].values()),
           "'auto' on an untuned graph runs uniform slab at α 15", rec)
    # every fault injected above was used, and nothing else moved: 5
    # injections (4 fused, 1 dense bin) and no fallback
    events = resilience_total() - total0
    emit({"phase": "ladder_resilience_events", "events": events,
          "expected": 5, "seconds": time.perf_counter() - t_phase})
    if events != 5 or chaos._queued:
        raise AssertionError(f"phase 10(a) recorded {events} resilience "
                             f"events (5 expected); queued: {chaos._queued}")
    degrade.clear()
    return {"lines": lines}


def phase_tuner(seed: int, log) -> dict:
    """Phase 10(b): ``repro_torch.tune.tune`` on the card over the
    reference's suite (rmat14–16, grid256), workloads pagerank, spmv and
    bfs, budget ``small``, in a temporary DB; a second sweep served from
    the DB; ``"auto"`` against the chosen candidate given explicitly."""
    import os

    import torch

    from repro_torch.configs.graphcage import DEFAULT as CFG
    from repro_torch.core import bfs, pagerank, spmv
    from repro_torch.core.partition import DEFAULT_BIN_THRESHOLDS
    from repro_torch.kernels import cuda_build
    from repro_torch.obs import trace as obs_trace
    from repro_torch.tune import (Candidate, SearchSpace, analytic,
                                  device_key, runner, tune)
    from repro_torch.tune import db as tune_db
    from repro_torch.tune import plan as tune_plan
    from repro_torch.tune.space import WORKLOADS
    from repro_torch.tune.suite import SUITE

    t_phase = time.perf_counter()
    # the small budget's space at the default bin thresholds (4, 32) gives
    # these graphs no dense block; the full budget's "auto" thresholds do,
    # so the balanced trials reach tocab_spmm
    space = dataclasses.replace(
        SearchSpace.for_budget("small", CFG),
        bin_thresholds=(DEFAULT_BIN_THRESHOLDS, "auto"))
    graphs = {name: build() for name, build in SUITE.items()}
    old_dir = os.environ.get("REPRO_TUNE_DIR")
    tmp = tempfile.TemporaryDirectory()
    os.environ["REPRO_TUNE_DIR"] = tmp.name
    for mod in (tune_plan, analytic, runner):
        mod.clear_cache()
    card = device_key()
    try:
        per_graph = {}
        entries = []
        torch.cuda.synchronize()
        cuda_build.reset_launches()
        t_sweep = time.perf_counter()
        for name, g in graphs.items():
            # the cache-model replays first, timed alone (the sweep's prune
            # then reads them from the memo)
            t0 = time.perf_counter()
            for wl in WORKLOADS:
                for c in space.candidates(wl):
                    analytic.predicted_cost(g, c)
            replay = time.perf_counter() - t0
            n_ev = len(obs_trace.events())
            t0 = time.perf_counter()
            summary = tune({name: g}, workloads=WORKLOADS, budget="small",
                           space=space, cfg=CFG, device="cuda")
            sweep = time.perf_counter() - t0
            trial_s = sum(e["dur_s"] for e in obs_trace.events()[n_ev:]
                          if e["name"] == "tune.trial")
            entries += summary["entries"]
            per_graph[name] = {
                "n": g.n, "m": g.m, "replay_seconds": replay,
                "sweep_seconds": sweep, "timed_trial_seconds": trial_s,
                "new_trials": summary["new_trials"],
                "entries": summary["entries"]}
        sweep_secs = time.perf_counter() - t_sweep
        launches = {k: cuda_build.launches.get(k, 0)
                    for k in ("fused_pull", "fused_push", "tocab_spmm")}
        emit({"phase": "tune_sweep", "budget": "small",
              "bin_thresholds": [list(DEFAULT_BIN_THRESHOLDS), "auto"],
              "device_kind": card, "entries": len(entries),
              "seconds": sweep_secs, "launches": launches})
        keys = sorted(tune_db.load(tune_db.db_path())["entries"])
        bad = [k for k in keys if k.split("/")[1] != card]
        bad += [e["graph"] for e in entries
                if e["device_kind"] != card or e.get("db_hit")]
        if len(keys) != len(entries):
            bad.append(f"{len(keys)} DB entries for {len(entries)} tunings")
        skipped = {e["key"]: e["skipped"] for e in entries if e["skipped"]}
        if bad or skipped or not all(launches.values()) \
                or card != torch.cuda.get_device_name(0).strip().replace(
                    " ", "-").lower():
            raise AssertionError(f"tuner sweep: entries {bad} not keyed by "
                                 f"the card ({card}), skipped {skipped}, "
                                 f"launches {launches}")
        again = tune(graphs, workloads=WORKLOADS, budget="small",
                     space=space, cfg=CFG, device="cuda")
        emit({"phase": "tune_second_sweep", "new_trials":
              again["new_trials"], "db_hits": again["db_hits"]})
        if again["new_trials"] != 0 or again["db_hits"] != len(entries):
            raise AssertionError(f"second sweep: {again['new_trials']} new "
                                 f"trials, {again['db_hits']} DB hits")

        def run(g, c, wl, auto):
            dg, bg = runner.build_for(g, c, "cuda")
            kw = (dict(schedule="auto", impl="auto") if auto
                  else dict(schedule=c.schedule, impl=c.impl))
            variant = runner._pr_variant(c)
            if wl == "pagerank":
                return pagerank(dg, bg, variant=variant, tol=1e-6, **kw)
            if wl == "spmv":
                gen = torch.Generator().manual_seed(seed)
                x = torch.rand(g.n, generator=gen).cuda()
                return spmv(dg, bg, x, variant=variant, **kw)
            return bfs(dg, bg, 0, alpha=None if auto else c.alpha, **kw)

        for name, info in per_graph.items():
            g = graphs[name]
            line = {"phase": "tune", "graph": name, "n": g.n, "m": g.m,
                    "chosen": {}, "best_us": {}, "trials": {}, "pruned": {},
                    "auto_vs_chosen": {}}
            for e in info["entries"]:
                wl, c = e["workload"], Candidate.from_json(e["chosen"])
                auto, want = run(g, c, wl, True), run(g, c, wl, False)
                if wl == "pagerank":
                    l1 = float((auto[0] - want[0]).abs().sum())
                    if l1 > PR_L1_TOL or abs(auto[1] - want[1]) > 1:
                        raise AssertionError(f"{name}/{wl}: auto vs "
                                             f"{c.key()}: L1 {l1}")
                    agree = {"l1": l1, "iterations": [auto[1], want[1]]}
                elif wl == "spmv":
                    agree = {"max_abs_err": check_close(
                        f"{name}/spmv auto vs {c.key()}", auto, want,
                        "sum")[0]}
                else:
                    check_exact(f"{name}/bfs auto vs {c.key()}", auto[0],
                                want[0])
                    if auto[1:] != want[1:]:
                        raise AssertionError(f"{name}/bfs levels {auto[1:]}"
                                             f" vs {want[1:]}")
                    agree = {"levels": list(auto[1:])}
                line["chosen"][wl] = c.key()
                line["best_us"][wl] = e["best_us"]
                line["trials"][wl] = len(e["trials"])
                line["pruned"][wl] = e["pruned_analytic"]
                line["auto_vs_chosen"][wl] = agree
            line.update(replay_seconds=info["replay_seconds"],
                        timed_trial_seconds=info["timed_trial_seconds"],
                        sweep_seconds=info["sweep_seconds"],
                        note="values fit in L2: launch-bound trials show "
                             "the tuner works, not cache blocking at scale")
            emit(line)
    finally:
        if old_dir is None:
            os.environ.pop("REPRO_TUNE_DIR", None)
        else:
            os.environ["REPRO_TUNE_DIR"] = old_dir
        for mod in (tune_plan, analytic, runner):
            mod.clear_cache()
        tmp.cleanup()
    emit({"phase": "tuner_seconds", "seconds": time.perf_counter() - t_phase})
    return {"launches": launches}


def phase_serve_retry(lm: dict, seed: int, log):
    """Phase 10(c), LM: a short decode run on TinyLlama-1.1B (bf16, the
    serving loop) with one ``serve.batch`` fault — injected before a step,
    and raised after a decode step has written its K/V into the cache in
    place — gives the greedy tokens of the same run without it, each with
    one retry."""
    import numpy as np
    import torch

    from repro_torch.launch.serve import serve_loop
    from repro_torch.models import transformer as tfm
    from repro_torch.resilience import ChaosError, chaos

    params, cfg = lm.pop("params"), lm["cfg"]
    rng = np.random.default_rng(seed + 10)
    P, new = 16, 8
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (2, P))).cuda()
    want = serve_loop(params, prompts, cfg, new)

    def retried(fault) -> dict:
        r0 = counter("resilience.retries", site="serve.batch",
                     error="ChaosError")
        with fault():
            res = serve_loop(params, prompts, cfg, new)
        return {"tokens_equal": bool(torch.equal(res.tokens, want.tokens)),
                "retries": counter("resilience.retries", site="serve.batch",
                                   error="ChaosError") - r0,
                "seconds": res.total_seconds}

    class injected:
        def __enter__(self):
            chaos.inject("serve.batch")

        def __exit__(self, *exc):
            return False

    class after_cache_write:
        """Raise once after the real step at position P + 2 has run."""

        def __enter__(self):
            real, state = tfm.serve_decode, {"armed": True}

            def step(params, tok, pos, cache, cfg):
                out = real(params, tok, pos, cache, cfg)
                if pos == P + 2 and state.pop("armed", False):
                    raise ChaosError("serve.batch")
                return out

            self.real, tfm.serve_decode = real, step

        def __exit__(self, *exc):
            tfm.serve_decode = self.real
            return False

    rec = {"phase": "serve_retry", "arch": lm.get("arch", LM_ARCH),
           "requests": 2,
           "prompt_len": P, "max_new": new,
           "seconds_without_fault": want.total_seconds,
           "fault_before_step": retried(injected),
           "fault_after_cache_write": retried(after_cache_write)}
    emit(rec)
    if not all(r["tokens_equal"] and r["retries"] == 1
               for r in (rec["fault_before_step"],
                         rec["fault_after_cache_write"])):
        raise AssertionError(f"retried serve step: {rec}")
    del params


def phase_score_retry(b4: dict):
    """Phase 10(c), BERT4Rec: ``score_loop`` at 512 users with one
    ``serve.batch`` fault gives phase 8's ids and scores."""
    import torch

    from repro_torch.launch.serve import score_loop
    from repro_torch.resilience import chaos

    r0 = counter("resilience.retries", site="serve.batch",
                 error="ChaosError")
    chaos.inject("serve.batch")
    t0 = time.perf_counter()
    res = score_loop(b4["params"], b4["users"], b4["cfg"], top_k=10, reps=1)
    secs = time.perf_counter() - t0
    want = b4["result"]
    rec = {"phase": "score_retry", "users": b4["users"].shape[0],
           "seconds": secs, "ms_per_batch_without_fault":
               1e3 * want.seconds_per_batch,
           "retries": counter("resilience.retries", site="serve.batch",
                              error="ChaosError") - r0,
           "ids_equal": bool(torch.equal(res.ids, want.ids)),
           "scores_equal": bool(torch.equal(res.scores, want.scores))}
    emit(rec)
    if not (rec["retries"] == 1 and rec["ids_equal"]
            and rec["scores_equal"]):
        raise AssertionError(f"retried score step: {rec}")


# --------------------------------------------------------------------- #
# phase 12: MoE serving at full width
# --------------------------------------------------------------------- #
#: Granite-MoE-3B-A800M at its published config (32 layers)
MOE_ARCH = "granite-moe-3b-a800m"
#: Mixtral-8x22B at its published width; 56 layers would be ~281 GB in
#: bf16, more than one card holds
MIXTRAL_ARCH = "mixtral-8x22b"
MIXTRAL_LAYERS = 2

#: kernel classes of the MoE serving breakdown, by substrings of the
#: kernel's name in the profiler's key (mangled or not); the first match
#: wins.  GEMM kernels are split into the experts' (``aten::bmm``'s own
#: device time) and the rest.
KERNEL_CLASSES = {
    "attention": ("attn_kernel", "attn_wgmma_kernel", "decode_kernel",
                  "decode_mma_kernel", "dq_kernel", "dkdv_kernel"),
    "sort": ("sort", "Sort", "radix", "Radix"),
    "scatter_gather": ("index", "gather", "scatter", "Index", "Gather",
                       "Scatter"),
    "gemm": ("gemm", "nvjet", "xmma", "cutlass", "Gemm"),
}


def op_breakdown(fn, top: int = 6) -> dict:
    """Device time of one ``fn()`` by kernel class, from ``torch.profiler``
    (CPU and CUDA activity; ms): ``attention`` (the port's kernels),
    ``sort``, ``scatter_gather``, ``expert_gemm`` (``aten::bmm``'s own
    device time), ``dense_gemm`` (the other GEMM kernels), ``other``, the
    total ``device_ms`` and the ``top`` largest kernels by name (cut to
    80 characters)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {c: 0.0 for c in KERNEL_CLASSES}
    expert = 0.0
    kernels = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            if e.key == "aten::bmm":
                expert += e.self_device_time_total / 1e3
        elif e.device_time_total > 0:
            ms = e.device_time_total / 1e3
            kernels.append((e.key[:80], ms))
            for c, names in KERNEL_CLASSES.items():
                if any(n in e.key for n in names):
                    out[c] += ms
                    break
    out["expert_gemm"] = expert
    out["dense_gemm"] = out.pop("gemm") - expert
    out["device_ms"] = sum(ms for _, ms in kernels)
    out["other"] = out["device_ms"] - sum(
        out[c] for c in ("attention", "sort", "scatter_gather",
                         "expert_gemm", "dense_gemm"))
    out["top"] = [list(k) for k in sorted(kernels, key=lambda k: -k[1])[:top]]
    return out


def moe_prompts(batch: int, seq_len: int, vocab: int, seed: int):
    """(batch, seq_len) prompts on the card from the port's LM stream."""
    from repro_torch.data.tokens import synthetic_lm_batches

    toks = next(synthetic_lm_batches(batch, seq_len, vocab, seed=seed))
    return toks["tokens"][:, :seq_len].long()


def moe_prefill_vs_decode(arch: str, master: dict, cfg, seed: int,
                          B: int = 2, S: int = 128) -> dict:
    """fp32 ``forward`` (flash_attention) against one ``serve_decode`` step
    (flash_decode) a position, at ``capacity_factor = E / top_k`` so that
    the forward drops no pair (the reference's
    ``test_lm_prefill_matches_decode`` does the same); logits at
    ``LM_RTOL`` / ``LM_ATOL``, greedy tokens equal."""
    import torch

    from repro_torch.models import transformer as tfm

    dev = torch.device("cuda")
    cfg32 = dataclasses.replace(
        cfg, compute_dtype="float32",
        capacity_factor=cfg.num_experts / cfg.top_k)
    tokens = moe_prompts(B, S, cfg.vocab, seed)
    t0 = time.perf_counter()
    full, aux = tfm.forward(master, tokens, cfg32)
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
    if not (bool(full.isfinite().all()) and bool(dec.isfinite().all())
            and bool(aux.isfinite())):
        raise AssertionError(f"{arch}: fp32 prefill/decode not finite")
    diff = (dec - full).abs()
    share = float((diff / (LM_ATOL + LM_RTOL * full.abs())).max())
    differ = full.argmax(-1) != dec.argmax(-1)
    top2 = full.topk(2, dim=-1).values
    rec = {"phase": "moe_prefill_vs_decode_fp32", "arch": arch,
           "layers": cfg.n_layers, "requests": B, "tokens": S,
           "capacity_factor": cfg32.capacity_factor,
           "max_abs_err": float(diff.max()), "rtol": LM_RTOL,
           "atol": LM_ATOL, "tolerance_used": share,
           "greedy_tokens_differ": int(differ.sum()),
           "min_top2_margin": float((top2[..., 0] - top2[..., 1]).min()),
           "aux": float(aux), "seconds": secs}
    emit(rec)
    if not share <= 1.0 or bool(differ.any()):
        raise AssertionError(f"{arch}: fp32 prefill and decode disagree: "
                             f"{rec}")
    return rec


def moe_layer_vs_oracle(master: dict, cfg, seed: int, B: int = 8,
                        S: int = 2048) -> dict:
    """Layer 0's MoE block at the published capacity factor on B × S
    tokens of layer-0 activations (the embedding through layer 0's
    attention and norm), in fp32, against a dense per-expert oracle: for
    each expert, the pairs routed to it in flat (token, slot) order, the
    first C kept.  Expert ids and the kept set equal exactly, outputs at
    ``LM_RTOL`` / ``LM_ATOL``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    p = master["layers"][0]
    tokens = moe_prompts(B, S, cfg.vocab, seed + 1)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = tfm._embed(master, tokens, cfg32)
    h = L.rms_norm(x, p["ln_attn"], plus_one=cfg.norm_plus_one)
    x = x + L.attention_block(p["attn"], h, positions, cfg32.attn_cfg(True))
    h = L.rms_norm(x, p["ln_mlp"], plus_one=cfg.norm_plus_one)
    mcfg = cfg32.moe_cfg()
    E, k, n, d = cfg.num_experts, cfg.top_k, B * S, cfg.d_model
    t0 = time.perf_counter()
    out, aux = moe.moe_block(p["moe"], h, mcfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    # the port's kept set, as an (n, k) mask over (token, slot) pairs
    xt = h.reshape(n, d)
    _, gates, ids = moe.route(p["moe"], xt, mcfg)
    C = moe._capacity(n, mcfg)
    *_, keep, order = moe._bin_and_dispatch(xt, gates, ids, E, C)
    kept = torch.zeros(n * k, dtype=torch.bool, device=xt.device)
    kept[order] = keep
    kept = kept.view(n, k)

    # the oracle: its own routing (torch.topk), capacity and expert loop
    w = p["moe"]
    probs = torch.softmax(xt @ w["router"], dim=-1)
    o_vals, o_ids = torch.topk(probs, k, dim=-1)
    o_gates = o_vals / o_vals.sum(-1, keepdim=True)
    o_cap = max(8, -(-int(n * k * mcfg.capacity_factor / E) // 8) * 8)
    o_kept = torch.zeros(n, k, dtype=torch.bool, device=xt.device)
    want = torch.zeros_like(xt)
    for e in range(E):
        t, j = (o_ids == e).nonzero(as_tuple=True)  # flat (token, slot)
        t, j = t[:o_cap], j[:o_cap]
        o_kept[t, j] = True
        xe = xt[t]
        y = (F.silu(xe @ w["w_gate"][e]) * (xe @ w["w_up"][e])
             ) @ w["w_down"][e]
        want.index_add_(0, t, o_gates[t, j, None] * y)
    got = out.reshape(n, d)
    diff = (got - want).abs()
    share = float((diff / (LM_ATOL + LM_RTOL * want.abs())).max())
    rec = {"phase": "moe_layer_vs_oracle", "arch": cfg.name, "layer": 0,
           "tokens": n, "experts": E, "top_k": k,
           "capacity_factor": mcfg.capacity_factor, "capacity": C,
           "oracle_capacity": o_cap,
           "ids_equal": bool(torch.equal(ids, o_ids)),
           "kept_equal": bool(torch.equal(kept, o_kept)),
           "pairs": n * k, "dropped_pairs": int((~kept).sum()),
           "max_bin": int(torch.bincount(ids.reshape(-1),
                                         minlength=E).max()),
           "max_abs_err": float(diff.max()), "rtol": LM_RTOL,
           "atol": LM_ATOL, "tolerance_used": share, "aux": float(aux),
           "moe_block_seconds": secs}
    emit(rec)
    if not (rec["ids_equal"] and rec["kept_equal"] and C == o_cap
            and share <= 1.0):
        raise AssertionError(f"moe_block vs the dense oracle: {rec}")
    return rec


def moe_serve(arch: str, params: dict, cfg, seed: int, Bs: int = 8,
              P: int = 128, new: int = 32) -> dict:
    """The serving loop, Bs requests × (P prompt + new) tokens, bf16:
    ``flash_decode`` launched exactly once a layer a decode step and
    ``flash_attention`` never (counts set to 0 just before the run)."""
    import torch

    from repro_torch.kernels import cuda_build
    from repro_torch.launch.serve import serve_loop

    prompts = moe_prompts(Bs, P, cfg.vocab, seed + 2)
    serve_loop(params, prompts[:, :8], cfg, 4)  # warm-up: allocator
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    res = serve_loop(params, prompts, cfg, new)
    launches = dict(cuda_build.launches)
    want = cfg.n_layers * res.decode_steps
    toks = res.tokens
    if toks.shape != (Bs, new) or not bool(((toks >= 0)
                                             & (toks < cfg.vocab)).all()):
        raise AssertionError(f"{arch} serve: bad tokens {toks.shape}")
    if launches.get("flash_decode", 0) != want \
            or launches.get("flash_attention", 0) != 0:
        raise AssertionError(f"{arch} serve launched {launches}; want "
                             f"flash_decode = {want}, flash_attention = 0")
    step_ms = sorted(1e3 * s for s in res.step_seconds)
    return {"requests": Bs, "prompt_len": P, "max_new": new,
            "decode_steps": res.decode_steps,
            "serve_prefill_seconds": res.prefill_seconds,
            "decode_ms_per_step": 1e3 * res.decode_seconds / new,
            "decode_step_ms_p50": step_ms[len(step_ms) // 2],
            "decode_step_ms_max": step_ms[-1],
            "tokens_per_s": res.tokens_per_s,
            "decode_tokens_per_s": res.decode_tokens_per_s,
            "serve_launches": launches,
            "flash_decode_per_step": launches.get("flash_decode", 0)
            // res.decode_steps, "prompts": prompts}


def moe_prefill(arch: str, params: dict, cfg, seed: int, Bp: int,
                Sp: int) -> dict:
    """``serve_prefill`` on Bp × Sp tokens, bf16: ``flash_attention``
    launched exactly once a layer, all on the tensor-core route; then the
    same call's device time by op."""
    import torch

    from repro_torch.kernels import cuda_build
    from repro_torch.models import transformer as tfm

    toks = moe_prompts(Bp, Sp, cfg.vocab, seed + 3)
    tfm.serve_prefill(params, toks[:1, :256], cfg)  # warm-up
    torch.cuda.synchronize()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    last = tfm.serve_prefill(params, toks, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(cuda_build.launches)
    if launches.get("flash_attention", 0) != cfg.n_layers \
            or launches.get("flash_attention_wgmma", 0) != cfg.n_layers \
            or launches.get("flash_decode", 0) != 0:
        raise AssertionError(f"{arch} serve_prefill launched {launches}; "
                             f"want flash_attention = {cfg.n_layers}, all "
                             "on the tensor cores, flash_decode = 0")
    if last.shape != (Bp, cfg.vocab) or not bool(last.isfinite().all()):
        raise AssertionError(f"{arch} serve_prefill: bad logits")
    breakdown = op_breakdown(lambda: tfm.serve_prefill(params, toks, cfg))
    return {"prefill_requests": Bp, "prefill_tokens": Sp,
            "prefill_seconds": secs, "prefill_tokens_per_s": Bp * Sp / secs,
            "prefill_launches": launches,
            "prefill_device_ms_by_op": breakdown}


def decode_step_bytes(params: dict, cfg, batch: int, kv_len: int,
                      reached=None) -> int:
    """Bytes one decode step must read: every weight but the experts
    (the fp32 (un)embedding table once), of each layer's experts those in
    ``reached`` (the count its routing reaches; all of them when None,
    which is what the (E, C) slab design reads), and the live K/V of
    every layer (bf16)."""
    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(nbytes(v) for v in tree)
        return tree.numel() * tree.element_size()

    total = nbytes(params)
    if reached is not None:
        for p, hit in zip(params["layers"], reached):
            experts = {n: w for n, w in p["moe"].items() if n != "router"}
            total -= nbytes(experts) * (cfg.num_experts - hit) \
                // cfg.num_experts
    kv = 2 * cfg.n_layers * batch * cfg.n_kv_heads * kv_len * cfg.head_dim * 2
    return total + kv


def moe_decode_profile(params: dict, cfg, prompts) -> dict:
    """Prefill a cache by decode steps over ``prompts``, then: one more
    step repeated on the same cache and position gives bit-equal logits
    (the fixed-order combine), the experts that step's routing reaches in
    each layer (read by wrapping ``moe.route`` for the first of the two
    calls), and that step's device time by op."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    B, P = prompts.shape
    cache = tfm.init_cache(cfg, B, P, device=prompts.device)
    for t in range(P - 1):
        _, cache = tfm.serve_decode(params, prompts[:, t:t + 1], t, cache,
                                    cfg)
    tok = prompts[:, -1:]
    route, ids = moe.route, []

    def recording_route(*args):
        out = route(*args)
        ids.append(out[2])
        return out

    moe.route = recording_route
    try:
        a, _ = tfm.serve_decode(params, tok, P - 1, cache, cfg)
    finally:
        moe.route = route
    b, _ = tfm.serve_decode(params, tok, P - 1, cache, cfg)
    if not torch.equal(a, b):
        raise AssertionError(
            f"{cfg.name}: a repeated decode step changed the logits by up to "
            f"{float((a - b).abs().max())}")
    if len(ids) != cfg.n_layers:
        raise AssertionError(f"{cfg.name}: {len(ids)} routings in a decode "
                             f"step of {cfg.n_layers} layers")
    breakdown = op_breakdown(
        lambda: tfm.serve_decode(params, tok, P - 1, cache, cfg))
    return {"repeat_step_bit_equal": True,
            "experts_reached": [int(i.unique().numel()) for i in ids],
            "decode_step_device_ms_by_op": breakdown}


def moe_serve_line(arch, cfg, params, serve, prefill, step, checks,
                   t_phase) -> dict:
    """The arch's ``moe_serve`` line, with the card and the decode step's
    byte bound: over the experts the profiled step's routing reaches
    (``decode_step_bound_ms``), and over all of them, as the (E, C) slabs
    read them (``slab_design_bound_ms``)."""
    kv_len = serve["prompt_len"] + serve["max_new"]
    nbytes = decode_step_bytes(params, cfg, serve["requests"], kv_len,
                               step["experts_reached"])
    slab = decode_step_bytes(params, cfg, serve["requests"], kv_len)
    line = {"phase": "moe_serve", "arch": arch, "card": card_line(),
            "layers": cfg.n_layers, **serve, **prefill, **step,
            "experts_reached_mean": sum(step["experts_reached"])
            / cfg.n_layers,
            "decode_step_bytes": nbytes,
            "decode_step_bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
            "slab_design_bytes": slab,
            "slab_design_bound_ms": 1e3 * slab / HBM_BYTES_PER_S,
            "checks": {n: c["tolerance_used"] for n, c in checks.items()},
            "phase_seconds": time.perf_counter() - t_phase}
    emit(line)
    return line


def moe_init(arch: str, cfg, seed: int, full=None) -> dict:
    """fp32 parameters of ``cfg`` from ``seed`` on the card, their count
    held against ``cfg.param_count()``; ``full`` is the published config
    when ``cfg`` cuts its depth."""
    import torch

    from repro_torch.models import transformer as tfm

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    master = tfm.init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    n_params = tfm.param_count(master)
    rec = {"phase": "moe_init", "arch": arch,
           "config": dataclasses.asdict(cfg), "params": n_params,
           "active_params": cfg.active_param_count(),
           "seconds": time.perf_counter() - t0}
    if full is not None:
        rec["reduced"] = {"n_layers": [full.n_layers, cfg.n_layers],
                          "published_params": full.param_count(),
                          "why": "56 layers are ~281 GB in bf16, more than "
                                 "one 80 GB card holds"}
    emit(rec)
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, the config says "
                             f"{cfg.param_count()}")
    return master


def phase_moe_granite(seed: int, log) -> dict:
    """Phase 12(a): Granite-MoE-3B-A800M at its published config, random
    weights from ``seed`` on the card: parameter count; fp32 forward vs
    decode; layer 0's MoE block vs the dense oracle; the bf16 serving loop
    and ``serve_prefill`` with exact launch counts; a repeated decode step
    bit-equal; the ``moe_serve`` line.  Returns the bf16 parameters for
    phase 12(c)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm

    t_phase = time.perf_counter()
    cfg = get_arch(MOE_ARCH).make_model_cfg()
    master = moe_init(MOE_ARCH, cfg, seed)
    checks = {"prefill_vs_decode": moe_prefill_vs_decode(MOE_ARCH, master,
                                                         cfg, seed),
              "layer_vs_oracle": moe_layer_vs_oracle(master, cfg, seed)}
    params = tfm.cast_params(master, cfg)
    del master
    torch.cuda.empty_cache()
    serve = moe_serve(MOE_ARCH, params, cfg, seed)
    prompts = serve.pop("prompts")
    prefill = moe_prefill(MOE_ARCH, params, cfg, seed, 8, 2048)
    step = moe_decode_profile(params, cfg, prompts[:, :16])
    line = moe_serve_line(MOE_ARCH, cfg, params, serve, prefill, step,
                          checks, t_phase)
    return {"params": params, "cfg": cfg, "arch": MOE_ARCH, "line": line}


def phase_moe_mixtral(seed: int, log) -> dict:
    """Phase 12(b): Mixtral-8x22B at its published width (d 6144, 48/8
    heads, D 128, 8 experts top-2, window 4096), depth cut to
    :data:`MIXTRAL_LAYERS`: fp32 forward vs decode; ``serve_prefill`` on
    1 × 8192 tokens (past the window: the windowed tensor-core route at
    D 128); the serving loop 8 × (128 + 32); the ``moe_serve`` line."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm

    t_phase = time.perf_counter()
    full = get_arch(MIXTRAL_ARCH).make_model_cfg()
    cfg = dataclasses.replace(full, n_layers=MIXTRAL_LAYERS)
    master = moe_init(MIXTRAL_ARCH, cfg, seed, full=full)
    checks = {"prefill_vs_decode": moe_prefill_vs_decode(
        MIXTRAL_ARCH, master, cfg, seed)}
    params = tfm.cast_params(master, cfg)
    del master
    torch.cuda.empty_cache()
    prefill = moe_prefill(MIXTRAL_ARCH, params, cfg, seed, 1, 8192)
    serve = moe_serve(MIXTRAL_ARCH, params, cfg, seed)
    prompts = serve.pop("prompts")
    step = moe_decode_profile(params, cfg, prompts[:, :16])
    line = moe_serve_line(MIXTRAL_ARCH, cfg, params, serve, prefill, step,
                          checks, t_phase)
    del params
    torch.cuda.empty_cache()
    return {"line": line}


def add_moe_launches(records: list, lines: list):
    """Rows 4-5 of the ``kernels`` record gain phase 12's launches a
    serving arch, and the kernel's device time (ms, ``torch.profiler``)
    over all its calls in one ``serve_prefill`` (flash_attention) or one
    decode step (flash_decode), and that over the calls (one a layer)."""
    where = {"flash_attention": ("prefill_device_ms_by_op",
                                 "device_ms_in_one_prefill"),
             "flash_decode": ("decode_step_device_ms_by_op",
                              "device_ms_in_one_step")}
    for row in records:
        if row["name"] not in where:
            continue
        by_op, key = where[row["name"]]
        row["moe"] = {
            ln["arch"]: {
                "layers": ln["layers"],
                "launches_serve_loop": ln["serve_launches"].get(row["name"],
                                                                0),
                "launches_serve_prefill":
                    ln["prefill_launches"].get(row["name"], 0),
                key: ln[by_op]["attention"],
                "device_ms_per_call": ln[by_op]["attention"] / ln["layers"]}
            for ln in lines}


# --------------------------------------------------------------------- #
# phase 3 (backward): flash_attention_bwd vs autograd of the plain version
# --------------------------------------------------------------------- #
#: the attention gradient vs torch autograd of attention_ref in fp32 on the
#: same values: max |error| of each of dq, dk, dv over its largest
#: magnitude.  bf16: one bf16 ulp at 1.0 (the kernel's inputs, its forward
#: output o, which delta = rowsum(dout ∘ o) reads, and its outputs are
#: bf16; everything inside is fp32); fp32: 1e-4 (fp32 sums in another
#: order, over up to 4608 keys)
BWD_REL_OF_MAX = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
#: the tensor-core forward's logsumexp vs attention_lse_ref (fp32 on the
#: same values): |error| ≤ LSE_RTOL · max(1, |lse|).  Both are fp32; the
#: kernel's scores come from the tensor cores in another order, through
#: ex2.approx (2⁻²²) and log2f: a few fp32 ulps of |lse|, some 80 below
#: this bound, which a wrong scale, cap or mask exceeds by far
LSE_RTOL = 1e-5
#: the backward kernels' sources (the row's is the tensor-core one, the
#: training path's; the FMA one serves fp32, D 8-32 and D 256), and what
#: they take the place of: XLA's autodiff of attention_ref (the JAX
#: package has no TPU backward kernel)
BWD_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
              "flash_attention_bwd_wgmma.cu")
BWD_FMA_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bwd.cu")
BWD_REPLACES = ("src/repro/kernels/flash_attention/ref.py:10 (XLA autodiff "
                "of attention_ref; no TPU kernel)")


def attention_ref_straight_cap(q, k, v, *, scale=None, causal=True,
                               window=0, softcap=0.0):
    """``attention_ref`` whose softcap passes the gradient straight through
    (the tanh derivative dropped): a wrong gradient the check must
    reject."""
    import torch

    B, Hq, Sq, D = q.shape
    group = Hq // k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if softcap > 0.0:
        s = s + (softcap * torch.tanh(s / softcap) - s).detach()
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones((Sq, k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= (qp - kp) < window
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def attention_grads_plain(q, k, v, dout, ref_fn, **kw):
    """fp32 (dq, dk, dv) of ``ref_fn`` by torch autograd on the values of
    q, k, v and dout, one KV head's query group at a time (which bounds
    the fp32 scores: GQA groups share nothing)."""
    import torch

    g = q.shape[1] // k.shape[1]
    grads = [torch.empty(t.shape, dtype=torch.float32, device=t.device)
             for t in (q, k, v)]
    for h in range(k.shape[1]):
        qs, ks, vs = (t.detach().float().requires_grad_() for t in (
            q[:, h * g:(h + 1) * g], k[:, h:h + 1], v[:, h:h + 1]))
        ref_fn(qs, ks, vs, **kw).backward(
            dout[:, h * g:(h + 1) * g].float())
        grads[0][:, h * g:(h + 1) * g] = qs.grad
        grads[1][:, h:h + 1] = ks.grad
        grads[2][:, h:h + 1] = vs.grad
    return grads


def rel_of_max(out, ref) -> tuple:
    """(max |out - ref|, that over max |ref|), in fp32."""
    err = float((out.float() - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def profiled_device_ms(fn, calls: int = 3) -> tuple:
    """``fn()`` under ``torch.profiler``, ``calls`` times: the median of
    each call's device time (the summed durations of its kernels and
    copies, which a host slower than the device does not stretch) and the
    names of the kernels that ran."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    per_call, names = [], set()
    for _ in range(calls):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_time_total > 0]
        per_call.append(sum(e.device_time_total for e in events) / 1e3)
        names.update(e.key for e in events)
    return statistics.median(per_call), sorted(names)


def sdpa_backend(names) -> str:
    """The SDPA backend named by the kernels that ran: ``cudnn``,
    ``flash``, ``efficient`` or ``math``."""
    low = " ".join(names).lower()
    for backend, marks in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                           ("efficient", ("fmha", "efficient", "mem_eff"))):
        if any(m in low for m in marks):
            return backend
    return "math"


def phase_attention_backward(seed: int, log) -> dict:
    """Attention's gradient through ``attention``'s autograd path, the
    backward ``attention_bwd_route`` picks, against torch autograd of
    ``attention_ref`` (fp32 oracle on the same values) at five shapes:
    TinyLlama's training attention (bf16, 8 × 32/4 heads × 512 × 64,
    causal), the same as transposed (B, S, H, D) views (the LM's
    projections), a Gemma-2-27B local layer (bf16, 1 × 32/16 heads × 4608
    × 128, window 4096, softcap 50, q scaled so the scores spread over the
    cap's range), a ragged bidirectional window (bf16, 2 × 8/2 × 1000 × 64,
    window 300) and a smoke shape (fp32, D 16, bidirectional: the FMA
    backward).  A gradient without the softcap's tanh derivative must fail
    the Gemma check; at every bf16 case the tensor-core forward's
    logsumexp is held against ``attention_lse_ref`` and its output with
    the lse bit-equal to its output without; the tensor-core backward is
    repeated bit-equal at TinyLlama's shape.  Then it is timed there
    beside its bound, the PR 23 FMA backward on the same operands, autograd
    of the plain version and SDPA's backward alone.  Returns the
    ``kernels`` row (launches filled in by phase 13)."""
    import statistics

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import attention
    from repro_torch.kernels.flash_attention.kernel import (
        attention_bwd_route, flash_attention_bwd_cuda,
        flash_attention_bwd_wgmma_cuda, flash_attention_wgmma_cuda)
    from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                         attention_ref)

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, dtype, mul=1.0, bshd=False):
        if bshd:  # a (B, S, H, D) buffer seen as (B, H, S, D)
            B, H, S, D = shape
            return rand(B, S, H, D, dtype=dtype, mul=mul).transpose(1, 2)
        return (torch.randn(shape, generator=gen, device=dev) * mul).to(dtype)

    def lse_plain(q, k, v, **kw):
        """attention_lse_ref's lse, one KV head's query group at a time."""
        g = q.shape[1] // k.shape[1]
        return torch.cat([attention_lse_ref(
            q[:, h * g:(h + 1) * g], k[:, h:h + 1], v[:, h:h + 1], **kw)[1]
            for h in range(k.shape[1])], dim=1)

    cases = {  # name: (B, Hq, Hkv, S, D, dtype, kw, q scale, (B, S, H, D))
        "tinyllama": (8, 32, 4, 512, 64, torch.bfloat16,
                      dict(causal=True), 1.0, False),
        "tinyllama_bshd_views": (8, 32, 4, 512, 64, torch.bfloat16,
                                 dict(causal=True), 1.0, True),
        "gemma2_27b_local": (1, 32, 16, 4608, 128, torch.bfloat16,
                             dict(causal=True, window=4096, softcap=50.0,
                                  scale=(4608 / 32) ** -0.5), 16.0, False),
        "ragged_window": (2, 8, 2, 1000, 64, torch.bfloat16,
                          dict(causal=False, window=300), 1.0, False),
        "smoke": (2, 4, 2, 100, 16, torch.float32,
                  dict(causal=False), 1.0, False),
    }
    out_rec, keep = {}, {}
    for name, (B, Hq, Hkv, S, D, dtype, kw, qmul, bshd) in cases.items():
        q = rand(B, Hq, S, D, dtype=dtype, mul=qmul, bshd=bshd)
        k, v = (rand(B, Hkv, S, D, dtype=dtype, bshd=bshd) for _ in range(2))
        dout = rand(B, Hq, S, D, dtype=dtype, bshd=bshd)
        route = attention_bwd_route(dtype, D)
        # leaves with the operands' strides (a transposed view stays one)
        leaves = [t.detach().clone().requires_grad_() if not bshd else
                  t.transpose(1, 2).detach().clone().transpose(1, 2)
                  .requires_grad_() for t in (q, k, v)]
        before = dict(cuda_build.launches)
        attention(*leaves, **kw).backward(dout)
        torch.cuda.synchronize()
        took = {n: cuda_build.launches[n] - before.get(n, 0)
                for n in ("flash_attention_bwd", "flash_attention_bwd_wgmma")}
        want = {"flash_attention_bwd": 1,
                "flash_attention_bwd_wgmma": int(route == "wgmma")}
        if took != want:
            raise AssertionError(f"attention backward at {name} ({route}): "
                                 f"launched {took}, want {want}")
        ref = attention_grads_plain(q, k, v, dout, attention_ref, **kw)
        limit = BWD_REL_OF_MAX[str(dtype)[6:]]
        rec = {"shape": {"q": list(q.shape), "kv": list(k.shape)},
               "dtype": str(dtype)[6:], "route": route,
               "bshd_views": bshd,
               "kw": {a: b for a, b in kw.items() if a != "scale"},
               "limit_rel_of_max": limit}
        for nm, got, r in zip(("dq", "dk", "dv"), leaves, ref):
            if got.grad.dtype != dtype or not bool(
                    got.grad.isfinite().all()):
                raise AssertionError(f"{name} {nm}: dtype {got.grad.dtype} "
                                     "or not finite")
            err, rel = rel_of_max(got.grad, r)
            rec[nm] = {"max_abs_err": err, "rel_of_max": rel}
            log(f"attention backward {name} ({route}) {nm}: "
                f"max_abs_err={err:.3g} rel_of_max={rel:.3g} "
                f"limit={limit:.3g}")
            if not rel <= limit:
                raise AssertionError(f"attention backward {name} ({route}) "
                                     f"{nm}: {rel:.3g} of max > {limit:.3g}")
        if kw.get("softcap"):
            # the same check against a gradient without the cap derivative
            wrong = attention_grads_plain(q, k, v, dout,
                                          attention_ref_straight_cap, **kw)
            worst = max(rel_of_max(got.grad, r)[1]
                        for got, r in zip(leaves, wrong))
            rec["without_softcap_derivative_rel_of_max"] = worst
            if not worst > limit:
                raise AssertionError(
                    f"{name}: a gradient without the softcap derivative "
                    f"passes the check ({worst:.3g} ≤ {limit:.3g})")
            del wrong
        if route == "wgmma":
            # the forward's logsumexp, and its output unchanged by storing it
            out, lse = flash_attention_wgmma_cuda(q, k, v, return_lse=True,
                                                  **kw)
            same = bool(torch.equal(out, flash_attention_wgmma_cuda(
                q, k, v, **kw)))
            ref_lse = lse_plain(q, k, v, **kw)
            lse_err = float((lse - ref_lse).abs().max())
            lse_share = float(((lse - ref_lse).abs()
                               / ref_lse.abs().clamp(min=1.0)).max()) \
                / LSE_RTOL
            rec["lse"] = {"max_abs_err": lse_err,
                          "share_of_limit": lse_share,
                          "out_bit_equal_without_lse": same}
            log(f"flash_attention lse {name}: max_abs_err={lse_err:.3g} "
                f"share_of_limit={lse_share:.3g}")
            if not (lse_share <= 1.0 and same):
                raise AssertionError(f"{name}: the forward's lse is "
                                     f"{lse_share:.3g}x its bound, or its "
                                     "output moved with it")
            if name == "tinyllama":
                keep = dict(q=q, k=k, v=v, dout=dout, out=out, lse=lse,
                            kw=kw, rec=rec)
            del out, lse, ref_lse
        out_rec[name] = rec
        del q, k, v, dout, leaves, ref
        torch.cuda.empty_cache()

    # the TinyLlama shape: repeats, then times
    q, k, v, dout, out, lse, kw = (keep[n] for n in ("q", "k", "v", "dout",
                                                     "out", "lse", "kw"))

    def run():
        return flash_attention_bwd_wgmma_cuda(q, k, v, out, dout, lse, **kw)

    first, again = run(), run()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        raise AssertionError("flash_attention_bwd_wgmma: repeats differ")
    del first, again
    ms = cuda_ms(run, reps=20, warmup=3)
    previous_ms = cuda_ms(lambda: flash_attention_bwd_cuda(
        q, k, v, out, dout, **kw), reps=5, warmup=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    plain_ms = cuda_ms(lambda: torch.autograd.grad(
        attention_ref(*leaves, **kw), leaves, dout), reps=2)
    # SDPA's backward alone: one retained forward, then the backward timed
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                              enable_gqa=True)

    def sdpa_bwd():
        return torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True)

    lib_loops = [cuda_ms(sdpa_bwd, reps=10, warmup=2) for _ in range(5)]
    lib_device_ms, kernels_seen = profiled_device_ms(sdpa_bwd)
    backend = sdpa_backend(kernels_seen)
    device_ms, _ = profiled_device_ms(run)
    B, Hq, S, D = q.shape
    fwd_flops = 4 * B * Hq * S * S * D / 2  # causal: half the scores
    ops = 2.5 * fwd_flops
    nbytes = 2 * (4 * q.numel() + 2 * k.numel() + 2 * v.numel())
    ops_ms, bytes_ms = 1e3 * ops / BF16_OPS_PER_S, 1e3 * nbytes / \
        HBM_BYTES_PER_S
    tl = keep["rec"]
    row = {"name": "flash_attention_bwd", "route": "cuda",
           "attention_bwd_route": "wgmma",
           "source": BWD_SOURCE, "replaces": BWD_REPLACES, "launches": 0,
           "max_abs_err": max(tl[n]["max_abs_err"] for n in ("dq", "dk",
                                                              "dv")),
           "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "library_ms": statistics.median(lib_loops),
           "library": f"scaled_dot_product_attention backward alone "
                      f"({backend})",
           "library_loops_ms": lib_loops,
           "library_device_ms": lib_device_ms,
           "library_kernels": [n[:100] for n in kernels_seen[:8]],
           "device_ms": device_ms,
           "previous_ms": previous_ms,
           "previous": BWD_FMA_SOURCE + " (PR 23, FP32 FMA)",
           "plain": "torch.autograd.grad of attention_ref (its forward "
                    "included)",
           "rel_of_max": {n: tl[n]["rel_of_max"] for n in ("dq", "dk", "dv")},
           "limit_rel_of_max": tl["limit_rel_of_max"],
           "shape": tl["shape"], "tflops": ops / (ms * 1e-3) / 1e12,
           "bound_share": max(ops_ms, bytes_ms) / ms}
    emit({"phase": "attention_backward_vs_plain", "cases": out_rec,
          "repeat": "bit-identical x2", "seconds": time.perf_counter() - t0})
    del q, k, v, dout, out, lse, leaves, keep, sdpa_out
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------- #
# phase 13: training
# --------------------------------------------------------------------- #
#: the training phase's LM: TinyLlama-1.1B's published config, trained at
#: batch 8 × 512 for 12 steps (AdamW, cosine schedule), as launch.train runs it
TRAIN_ARGV = ["--arch", LM_ARCH, "--full-config", "--batch", "8", "--seq",
              "512", "--steps", "12", "--log-every", "1"]
#: step 0 with the kernels vs with backend="torch" attention on the same
#: params and batch (bf16 compute either way; only the attention differs):
#: loss to 2e-3 relative, gradient global norm to 2e-2
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 2e-3, 2e-2


def device_idle_share(fn) -> dict:
    """One ``fn()`` under ``torch.profiler``: the window from the first
    event to the last (host and device), the device's busy time (the union
    of its kernel and copy intervals) and the idle share of the window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler saw no device activity")
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    return {"window_ms": (hi - lo) / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / max(hi - lo, 1e-9)}


def phase_train_lm(seed: int, log) -> dict:
    """(a) TinyLlama-1.1B at its published width through
    ``repro_torch.launch.train``: step 0's gradient (kernels) checked leaf
    by leaf and against ``backend="torch"`` attention, one step profiled
    (the device's idle share, then its device time by kernel class),
    then ``main`` for 12 steps with the launch counts set to 0 just before
    it and read just after."""
    import contextlib
    import io
    import math

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.launch import train as launch
    from repro_torch.models import layers
    from repro_torch.train.optim import adamw, cosine_schedule, global_norm
    from repro_torch.train.trainer import _value_and_grad, make_train_step
    from repro_torch.train.tree import tree_leaves, tree_paths

    t0 = time.perf_counter()
    argv = TRAIN_ARGV + ["--seed", str(seed)]
    args = launch.build_parser().parse_args(argv)
    cfg = get_arch(LM_ARCH).make_model_cfg()
    params, loss_fn, batches = launch._lm_setup(cfg, args)
    batch = next(batches)

    # step 0's gradient with the kernels: every leaf finite and non-zero
    cuda_build.reset_launches()
    loss0, _, grads = _value_and_grad(loss_fn, params, batch)
    checked = dict(cuda_build.launches)
    if checked.get("flash_attention_bwd", 0) != cfg.n_layers \
            or checked.get("flash_attention_bwd_wgmma", 0) != cfg.n_layers:
        raise AssertionError(f"step 0's gradient launched {checked}; want "
                             f"flash_attention_bwd = flash_attention_bwd_"
                             f"wgmma = {cfg.n_layers}")
    bad = [p for p, g in zip(tree_paths(grads), tree_leaves(grads))
           if not bool(g.isfinite().all()) or not bool((g != 0).any())]
    if bad or not bool(loss0.isfinite()):
        raise AssertionError(f"step 0: loss {float(loss0)}; leaves without "
                             f"a finite non-zero gradient: {bad[:8]}")
    gnorm0 = float(global_norm(grads))
    n_leaves = len(tree_leaves(grads))
    del grads
    # the oracle: the same step with the plain attention (backend="torch";
    # attention_block passes its own backend=None, which this overrides)
    def plain(*a, backend=None, **kw):
        return attn_ops.attention(*a, backend="torch", **kw)

    saved, layers.attn_op = layers.attn_op, plain
    cuda_build.reset_launches()
    try:
        loss_t, _, grads_t = _value_and_grad(loss_fn, params, batch)
        gnorm_t = float(global_norm(grads_t))
    finally:
        layers.attn_op = saved
    if sum(cuda_build.launches.values()):
        raise AssertionError(f"the plain-attention oracle launched "
                             f"{dict(cuda_build.launches)}")
    del grads_t
    torch.cuda.empty_cache()
    loss_rel = abs(float(loss0) - float(loss_t)) / abs(float(loss_t))
    gnorm_rel = abs(gnorm0 - gnorm_t) / gnorm_t
    if not (loss_rel <= TRAIN_LOSS_RTOL and gnorm_rel <= TRAIN_GNORM_RTOL):
        raise AssertionError(f"step 0 kernels vs plain attention: loss "
                             f"{float(loss0)} vs {float(loss_t)}, grad norm "
                             f"{gnorm0} vs {gnorm_t}")

    # one full step (forward, backward, AdamW) profiled after one warm-up
    opt = adamw(cosine_schedule(args.lr, 20, args.steps))
    step = make_train_step(loss_fn, opt)
    state = opt.init(params)
    p1, s1, _ = step(params, state, batch)
    del p1, s1
    torch.cuda.synchronize()
    profile = device_idle_share(lambda: step(params, state, batch))
    by_op = op_breakdown(lambda: step(params, state, batch), top=10)
    del params, state, batch, batches, step
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0

    # the main path: launch.train.main, 12 steps
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    cuda_build.reset_launches()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        hist = launch.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    launches = dict(cuda_build.launches)
    peak = torch.cuda.max_memory_allocated()
    log("--- launch.train ---\n" + buf.getvalue())
    losses = [h["loss"] for h in hist]
    steps = args.steps
    want = cfg.n_layers * steps
    if [h["step"] for h in hist] != list(range(steps)) or not all(
            math.isfinite(x) for x in losses):
        raise AssertionError(f"training losses: {losses}")
    if abs(losses[0] - float(loss0)) > 1e-5 * abs(float(loss0)):
        raise AssertionError(f"main's step 0 loss {losses[0]} is not the "
                             f"checked step's {float(loss0)}")
    if any(launches.get(n, 0) != want for n in (
            "flash_attention", "flash_attention_wgmma",
            "flash_attention_bwd", "flash_attention_bwd_wgmma")):
        raise AssertionError(f"training launched {launches}; want "
                             f"flash_attention = flash_attention_wgmma = "
                             f"flash_attention_bwd = flash_attention_bwd_"
                             f"wgmma = {want}")
    dts = sorted(h["dt"] for h in hist[2:])
    step_ms = 1e3 * dts[len(dts) // 2]
    tokens = args.batch * args.seq
    line = {"phase": "train_lm", "arch": LM_ARCH,
            "params": cfg.param_count(), "batch": args.batch,
            "seq": args.seq, "steps": steps,
            "losses": losses, "step0": {
                "loss": float(loss0), "loss_plain_attention": float(loss_t),
                "loss_rel": loss_rel, "grad_norm": gnorm0,
                "grad_norm_plain_attention": gnorm_t,
                "grad_norm_rel": gnorm_rel,
                "leaves_with_finite_nonzero_grad": n_leaves},
            "step_ms_median_2_11": step_ms,
            "step_ms_all": [1e3 * h["dt"] for h in hist],
            "tokens_per_s": tokens / (step_ms / 1e3),
            "peak_memory_gb": peak / 1e9,
            "one_step_profile": profile,
            "one_step_device_ms_by_op": by_op,
            "launches": launches, "setup_seconds": setup_s,
            "run_seconds": run_s}
    emit(line)
    return line


def phase_train_resume(seed: int, log) -> dict:
    """(b) Exact resume on the card, the smoke TinyLlama (bf16 compute):
    6 uninterrupted steps against 4, a restore from ``LATEST`` in a fresh
    ``Trainer`` and 2 more; losses and final params bit-equal.  Under
    ``torch.use_deterministic_algorithms`` (the embedding's and the loss
    gather's backward add with atomics otherwise); the ops it warns about
    are recorded."""
    import os

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import synthetic_lm_batches
    from repro_torch.models import transformer as tfm
    from repro_torch.train.optim import adamw, cosine_schedule
    from repro_torch.train.trainer import Trainer
    from repro_torch.train.tree import tree_leaves

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_arch(LM_ARCH).make_smoke_cfg()
    opt = adamw(cosine_schedule(3e-3, 2, 6))

    def loss_fn(p, b):
        return tfm.loss_fn(p, b, cfg)

    def stream(skip=0):
        it = synthetic_lm_batches(8, 64, cfg.vocab, seed=seed, device=dev)
        for _ in range(skip):
            next(it)
        return it

    def fresh():
        gen = torch.Generator(device=dev).manual_seed(seed)
        return tfm.init_params(cfg, gen, dev)

    quiet = dict(log_every=1, log_fn=lambda *_: None)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            whole = Trainer(loss_fn=loss_fn, optimizer=opt)
            p, s = whole.init_state(fresh())
            p6, _, h6 = whole.run(p, s, stream(), num_steps=6, **quiet)
            with tempfile.TemporaryDirectory() as d:
                first = Trainer(loss_fn=loss_fn, optimizer=opt, ckpt_dir=d)
                p, s = first.init_state(fresh())
                _, _, h4 = first.run(p, s, stream(), num_steps=4, **quiet)
                second = Trainer(loss_fn=loss_fn, optimizer=opt, ckpt_dir=d)
                p, s = second.init_state(fresh())
                p, s, start = second.maybe_restore(p, s)
                if start != 4:
                    raise AssertionError(f"restored step {start}, want 4")
                pr, _, h2 = second.run(p, s, stream(4), start_step=4,
                                       num_steps=6, **quiet)
    finally:
        torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(" does not have")[0][:120]
                     for w in caught if "deterministic" in str(w.message)})
    l6 = [h["loss"] for h in h6]
    lr = [h["loss"] for h in h4 + h2]
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(p6),
                                                 tree_leaves(pr)))
    rec = {"phase": "train_resume", "arch": LM_ARCH + " (smoke)",
           "losses_whole": l6, "losses_resumed": lr,
           "losses_bit_equal": l6 == lr, "params_bit_equal": same,
           "nondeterministic_ops_warned": nondet,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if l6 != lr or not same:
        raise AssertionError(f"resume is not bit-exact: {rec}")
    return rec


def phase_train_gnn(seed: int, log) -> dict:
    """(c) The four GNNs at their published widths, random weights from
    ``seed``, AdamW: GAT-Cora on ``cora_like()`` for 100 steps through the
    TOCAB slab engines (``build_blocked(g, block_size=512)``), then its
    flat and TOCAB forwards on the trained params; GraphSAGE-Reddit on
    ``NeighborSampler`` batches of 512 seeds (fanout 25-10) over
    ``reddit_like()``, 20 steps; GIN-TU on the same cora graph with the
    layout (``tocab_pull``'s gradient), 20 steps; DimeNet on
    ``molecule_batch()``, 5 steps.  No port kernel launches here (the slab
    engines are torch ops); a fused kernel asked for a gradient raises."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import build_blocked
    from repro_torch.data.graphs import cora_like, molecule_batch, reddit_like
    from repro_torch.data.sampler import NeighborSampler
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.tocab_fused import fused_pull
    from repro_torch.models.gnn import gnn_forward, gnn_loss_fn, init_gnn
    from repro_torch.train.optim import adamw, constant_schedule
    from repro_torch.train.trainer import make_train_step

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lines = []
    cuda_build.reset_launches()

    def train(arch, cfg, batches, steps, bg=None, lr=5e-3):
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_gnn(gen, cfg, dev)
        opt = adamw(constant_schedule(lr))
        step = make_train_step(
            lambda p, b: gnn_loss_fn(p, b, cfg, bg=bg), opt)
        state = opt.init(params)
        losses, metric, dts = [], [], []
        for _ in range(steps):
            batch = next(batches)
            t = time.perf_counter()
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t)
            losses.append(float(m["loss"]))
            metric.append(float(m.get("acc", m.get("mse"))))
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{arch}: losses {losses}")
        dts = sorted(dts[1:])
        line = {"phase": "train_gnn", "arch": arch,
                "config": dataclasses.asdict(cfg), "steps": steps,
                "loss_first": losses[0], "loss_last": losses[-1],
                "acc_or_mse_last": metric[-1],
                "step_ms_median": 1e3 * dts[len(dts) // 2]}
        lines.append(line)
        return params, line

    def repeat(batch):
        while True:
            yield batch

    # GAT-Cora through the TOCAB slab engines, as examples/gnn_cora.py
    cfg = get_arch("gat-cora").make_model_cfg()
    g, cora = cora_like(seed=seed, device=dev)
    bg = build_blocked(g, block_size=512, device=dev)
    params, line = train("gat-cora", cfg, repeat(cora), 100, bg=bg)
    with torch.no_grad():
        flat = gnn_forward(params, cora, cfg, bg=None)
        toc = gnn_forward(params, cora, cfg, bg=bg)
    err, rel = rel_of_max(toc, flat)
    acc = float((flat.argmax(-1) == cora.labels.long()).float().mean())
    line.update(nodes=g.n, edges=g.m, blocks=bg.num_blocks,
                flat_vs_tocab_max_abs_err=err, flat_vs_tocab_rel_of_max=rel,
                train_accuracy=acc)
    if not rel <= SUM_RTOL:
        raise AssertionError(f"gat-cora: flat vs TOCAB forward {rel:.3g} "
                             f"of max > {SUM_RTOL}")
    # a fused kernel refuses a gradient it could not give
    x = cora.node_feat[:, :8].clone().requires_grad_()
    try:
        fused_pull(bg, x)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        line["fused_pull_under_grad"] = "raises: " + str(e)[:100]
    else:
        raise AssertionError("fused_pull took an input that requires grad")
    # GIN-TU on the same graph, aggregating with tocab_pull
    train("gin-tu", get_arch("gin-tu").make_model_cfg(), repeat(cora), 20,
          bg=bg)
    del bg, cora, params, flat, toc, x
    # GraphSAGE-Reddit on sampled batches of 512 seeds
    cfg = get_arch("graphsage-reddit").make_model_cfg()
    g, host = reddit_like(seed=seed, device="cpu")
    sampler = NeighborSampler(g, host.node_feat.numpy(),
                              host.labels.numpy(), cfg.sample_sizes,
                              seed=seed, device=dev)

    def sampled():
        while True:
            yield sampler.sample(512)

    _, line = train("graphsage-reddit", cfg, sampled(), 20)
    line.update(graph_nodes=g.n, graph_edges=g.m, seeds_per_batch=512,
                local_nodes=NeighborSampler.batch_shapes(
                    512, cfg.sample_sizes, cfg.d_in)[0])
    # DimeNet on batched molecules
    cfg = get_arch("dimenet").make_model_cfg()
    t = time.perf_counter()
    mol = molecule_batch(seed=seed, device=dev)
    build_s = time.perf_counter() - t
    _, line = train("dimenet", cfg, repeat(mol), 5, lr=1e-3)
    line.update(graphs=int(mol.labels.shape[0]), nodes=mol.n,
                edges=int(mol.edge_src.shape[0]),
                triplets=int(mol.t_mask.sum()), batch_build_seconds=build_s)
    torch.cuda.synchronize()
    launches = dict(cuda_build.launches)
    if sum(launches.values()):
        raise AssertionError(f"GNN training launched {launches}; the slab "
                             "engines launch no kernel")
    for ln in lines:
        emit(ln)
    return {"lines": lines, "seconds": time.perf_counter() - t0}


def phase_train_bert4rec(seed: int, log) -> dict:
    """(d) BERT4Rec at its published 10⁶-item config: one loss and backward
    of the sampled-softmax branch on the card (a batch built as
    tests/test_models.py builds one: random items, masked positions,
    labels and shared negatives), against the same on the CPU; then
    ``binned_embedding_grad`` against the flat sum."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import bert4rec as b4
    from repro_torch.train.trainer import _value_and_grad

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_arch("bert4rec").make_model_cfg()
    if not cfg.sampled_softmax:
        raise AssertionError("bert4rec's published config should take the "
                             "sampled softmax")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = b4.init_bert4rec(cfg, gen, dev)
    rng = np.random.default_rng(seed)
    B, L, M, K = 4, cfg.max_len, cfg.max_masked, cfg.num_negatives
    host = {
        "items": rng.integers(0, cfg.vocab, (B, L)).astype(np.int32),
        "mask_pos": rng.integers(0, L, (B, M)).astype(np.int32),
        "pos_labels": rng.integers(0, cfg.vocab, (B, M)).astype(np.int32),
        "pos_weight": np.ones((B, M), np.float32),
        "negatives": rng.integers(0, cfg.vocab, (K,)).astype(np.int32),
    }

    def loss_fn(p, b):
        return b4.bert4rec_loss_fn(p, b, cfg)

    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    loss, _, grads = _value_and_grad(loss_fn, params, batch)
    torch.cuda.synchronize()
    cpu_loss, _, cpu_grads = _value_and_grad(
        loss_fn, {k: ([{n: t.cpu() for n, t in blk.items()} for blk in v]
                      if k == "blocks" else v.cpu())
                  for k, v in params.items()},
        {k: torch.from_numpy(v) for k, v in host.items()})
    emb = grads["item_emb"]
    if not (bool(loss.isfinite()) and bool(emb.isfinite().all())
            and bool((emb != 0).any())):
        raise AssertionError("bert4rec: loss or item_emb gradient not finite "
                             "or all zero")
    loss_rel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    emb_err, emb_rel = rel_of_max(emb.cpu(), cpu_grads["item_emb"])
    if not (loss_rel <= B4_RTOL and emb_rel <= B4_RTOL):
        raise AssertionError(f"bert4rec card vs CPU: loss {loss_rel:.3g}, "
                             f"item_emb grad {emb_rel:.3g} of max")
    # binned_embedding_grad of the encoder-shaped gradients of these items
    g = torch.randn((B, L, cfg.d_model), generator=gen, device=dev)
    ids = batch["items"]
    binned = b4.binned_embedding_grad(ids, g, cfg.table_size)
    flat = torch.zeros_like(binned).index_add_(
        0, ids.reshape(-1).long(), g.reshape(-1, cfg.d_model))
    mag = torch.zeros_like(binned).index_add_(
        0, ids.reshape(-1).long(), g.reshape(-1, cfg.d_model).abs())
    diff = (binned - flat).abs()
    share = float((diff / (SUM_RTOL * mag + 1e-30)).max())
    rec = {"phase": "train_bert4rec", "vocab": cfg.vocab,
           "batch": {"users": B, "max_len": L, "masked": M, "negatives": K},
           "loss": float(loss), "loss_rel_vs_cpu": loss_rel,
           "item_emb_grad_rel_of_max_vs_cpu": emb_rel,
           "item_emb_rows_touched": int((emb != 0).any(-1).sum()),
           "binned_vs_flat_max_abs_err": float(diff.max()),
           "binned_vs_flat_tolerance_used": share,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if not share <= 1.0:
        raise AssertionError(f"binned_embedding_grad vs flat: {share:.3g}× "
                             "SUM_RTOL of the rows' magnitudes")
    return rec


def phase_training(seed: int, log, bwd_row: dict) -> dict:
    """Phase 13: (a) TinyLlama-1.1B training at full width, (b) an exact
    resume, (c) the four GNNs, (d) BERT4Rec's sampled softmax.  Fills the
    ``flash_attention_bwd`` row's ``launches`` from (a)'s main path."""
    import torch

    t0 = time.perf_counter()
    lm = phase_train_lm(seed, log)
    torch.cuda.empty_cache()
    bwd_row["launches"] = lm["launches"].get("flash_attention_bwd", 0)
    bwd_row["launches_wgmma"] = lm["launches"].get(
        "flash_attention_bwd_wgmma", 0)
    bwd_row["train"] = {"step_ms": lm["step_ms_median_2_11"],
                        "tokens_per_s": lm["tokens_per_s"],
                        "peak_memory_gb": lm["peak_memory_gb"]}
    phase_train_resume(seed, log)
    torch.cuda.empty_cache()
    phase_train_gnn(seed, log)
    torch.cuda.empty_cache()
    phase_train_bert4rec(seed, log)
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    emit({"phase": "training_seconds", "seconds": secs})
    return {"lm": lm, "seconds": secs}


# --------------------------------------------------------------------- #
# phase 14: distribution on a one-rank NCCL mesh
# --------------------------------------------------------------------- #
#: 3 AdamW steps of TinyLlama-1.1B, 8 × 512, with and without a mesh
DIST_STEPS = 3
#: rounds of the three gradient functions timed in turns (the first warms)
DIST_GRAD_ROUNDS = 5
#: BERT4Rec's serve shape for the two-stage top-k: 512 users × 10⁶ items,
#: top 100, the items cut into 8 blocks (the plain-tensor form); the
#: tie-laden case rounds the scores to 16 values
DIST_TOPK_USERS, DIST_TOPK_K, DIST_TOPK_BLOCKS, DIST_TIE_LEVELS = \
    512, 100, 8, 16


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms`` for the block (the
    embedding's and the loss gather's backward add with atomics otherwise,
    so two runs of one step would differ in their last bits)."""
    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def dist_train(seed: int, mesh, log) -> dict:
    """(a) TinyLlama-1.1B at its published width, 8 × 512, AdamW with the
    launcher's cosine schedule, 3 steps through ``Trainer(mesh=mesh)``
    (the data-parallel step: the batch's block, the denominators and every
    gradient leaf through ``all_reduce`` over the mesh's ``data`` group,
    NCCL) against ``Trainer(mesh=None)`` from the same seed: losses and
    every parameter bit-equal (a sum over one rank is its one term, the
    mean divides by nothing); ``flash_attention`` and
    ``flash_attention_bwd`` 22 times a step on the mesh."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import synthetic_lm_batches
    from repro_torch.kernels import cuda_build
    from repro_torch.models import transformer as tfm
    from repro_torch.train.optim import adamw, cosine_schedule
    from repro_torch.train.trainer import Trainer
    from repro_torch.train.tree import tree_leaves

    dev = torch.device("cuda")
    cfg = get_arch(LM_ARCH).make_model_cfg()
    B, S = 8, 512

    def run(m):
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = tfm.init_params(cfg, gen, dev)
        batches = synthetic_lm_batches(B, S, cfg.vocab, seed=seed,
                                       device=dev, mesh=m)
        tr = Trainer(loss_fn=lambda p, b: tfm.loss_fn(p, b, cfg),
                     optimizer=adamw(cosine_schedule(3e-4, 20, DIST_STEPS)),
                     mesh=m, denominator=(lambda b: tfm.loss_denominator(
                         b, cfg)) if m is not None else None)
        p, st = tr.init_state(params)
        del params
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launches()
        with deterministic():
            p, st, hist = tr.run(p, st, batches, num_steps=DIST_STEPS,
                                 log_every=1, log_fn=lambda *_: None)
        torch.cuda.synchronize()
        launches = dict(cuda_build.launches)
        peak = torch.cuda.max_memory_allocated()
        del st
        return p, hist, launches, peak

    t0 = time.perf_counter()
    p_one, h_one, l_one, peak_one = run(None)
    # held on the host, so that the two runs' peaks are comparable
    p_one = [x.cpu() for x in tree_leaves(p_one)]
    torch.cuda.empty_cache()
    p_dp, h_dp, l_dp, peak_dp = run(mesh)
    same = [torch.equal(a, b.cpu()) for a, b in zip(p_one,
                                                    tree_leaves(p_dp))]
    del p_one, p_dp
    torch.cuda.empty_cache()
    want = cfg.n_layers * DIST_STEPS
    rec = {"phase": "dist_train", "arch": LM_ARCH, "batch": B, "seq": S,
           "steps": DIST_STEPS, "mesh": dict(zip(mesh.mesh_dim_names,
                                                 mesh.mesh.shape)),
           "backend": torch.distributed.get_backend(),
           "losses_one_device": [h["loss"] for h in h_one],
           "losses_mesh": [h["loss"] for h in h_dp],
           "losses_bit_equal": [h["loss"] for h in h_one] == [
               h["loss"] for h in h_dp],
           "params_bit_equal": all(same), "param_leaves": len(same),
           "step_ms_one_device": [1e3 * h["dt"] for h in h_one],
           "step_ms_mesh": [1e3 * h["dt"] for h in h_dp],
           "peak_memory_gb_one_device": peak_one / 1e9,
           "peak_memory_gb_mesh": peak_dp / 1e9,
           "launches_one_device": l_one, "launches_mesh": l_dp,
           "launches_per_step_mesh": {
               n: l_dp.get(n, 0) / DIST_STEPS
               for n in ("flash_attention", "flash_attention_bwd")},
           "deterministic_algorithms": True,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if not (rec["losses_bit_equal"] and rec["params_bit_equal"]):
        raise AssertionError(f"the one-rank mesh is not the one-device "
                             f"step bit for bit: {rec}")
    for launches in (l_one, l_dp):
        if any(launches.get(n, 0) != want for n in (
                "flash_attention", "flash_attention_bwd")):
            raise AssertionError(f"3 steps launched {launches}; want "
                                 f"flash_attention = flash_attention_bwd "
                                 f"= {want}")
    return rec


def dist_compress(seed: int, mesh, log) -> dict:
    """(b) One TinyLlama step's gradients through ``make_dp_grad_fn(...,
    compress=True)`` on the mesh, applied twice so that the residual is
    non-zero: the gradients equal ``(g + r).to(bf16).float()`` and the new
    residual ``(g + r) - that``, bit for bit, leaf by leaf (``g`` from
    the same step with no mesh).  Then host ms (synchronised; 5 rounds of
    one call each, in turns; the median of rounds 2-5) of the plain
    gradient, the uncompressed and the compressed function, and the
    compressed call's peak memory."""
    import statistics

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import synthetic_lm_batches
    from repro_torch.dist.collectives import (init_error_feedback,
                                              make_dp_grad_fn)
    from repro_torch.models import transformer as tfm
    from repro_torch.train.trainer import _value_and_grad
    from repro_torch.train.tree import tree_leaves

    dev = torch.device("cuda")
    cfg = get_arch(LM_ARCH).make_model_cfg()
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    batch = next(synthetic_lm_batches(8, 512, cfg.vocab, seed=seed,
                                      device=dev, mesh=mesh))

    def loss_fn(p, b):
        return tfm.loss_fn(p, b, cfg)

    fn_c = make_dp_grad_fn(loss_fn, mesh, "data", compress=True)
    fn_e = make_dp_grad_fn(loss_fn, mesh, "data", compress=False)
    bad = []
    with deterministic():
        _, _, g = _value_and_grad(loss_fn, params, batch)
        _, r1, _ = fn_c(params, batch, init_error_feedback(params, 1))
        torch.cuda.reset_peak_memory_stats()
        g2, r2, loss2 = fn_c(params, batch, r1)
        torch.cuda.synchronize()
        peak_c = torch.cuda.max_memory_allocated()
        nonzero = 0
        for i, (gi, ri, g2i, r2i) in enumerate(zip(
                tree_leaves(g), tree_leaves(r1), tree_leaves(g2),
                tree_leaves(r2))):
            corrected = gi.float() + ri
            wire = corrected.to(torch.bfloat16).float()
            if not (torch.equal(g2i, wire)
                    and torch.equal(r2i, corrected - wire)):
                bad.append(i)
            nonzero += int(bool(ri.abs().sum() > 0))
        n_leaves = len(tree_leaves(g))
        del g, r1, g2, r2, corrected, wire
        torch.cuda.empty_cache()

        res = init_error_feedback(params, 1)
        fns = {"plain": lambda: _value_and_grad(loss_fn, params, batch),
               "uncompressed": lambda: fn_e(params, batch, res),
               "compressed": lambda: fn_c(params, batch, res)}
        ms = {k: [] for k in fns}
        for _ in range(DIST_GRAD_ROUNDS):  # in turns, one of each a round
            for k, f in fns.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                f()
                torch.cuda.synchronize()
                ms[k].append(1e3 * (time.perf_counter() - t))
    del params, res
    torch.cuda.empty_cache()
    rec = {"phase": "dist_compress", "arch": LM_ARCH, "leaves": n_leaves,
           "leaves_not_bit_equal": bad, "leaves_with_nonzero_residual":
               nonzero, "loss": float(loss2),
           "ms_all": ms, "ms": {k: statistics.median(v[1:])
                                for k, v in ms.items()},
           "peak_memory_gb_compressed": peak_c / 1e9,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if bad or nonzero == 0:
        raise AssertionError(f"compressed gradients: {rec}")
    return rec


def dist_topk(seed: int, log) -> dict:
    """(c) ``distributed_topk`` at BERT4Rec's serve shape: the fp32 scores
    of 512 users against 10⁶ items from the published model (random
    weights from ``seed``), k = 100, in 8 blocks (the plain-tensor form),
    and the same scores rounded to 16 values (ties everywhere): values and
    ids exactly those of a stable descending sort of each whole row (what
    ``lax.top_k`` returns).  ``bert4rec_score`` under ``use_mesh_rules``
    with a ``model`` axis of 8 gives the same.  Device ms (CUDA events)
    of the two-stage top-k, ``torch.topk`` and the full stable sort."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.recsys import make_cloze_batch
    from repro_torch.dist.collectives import distributed_topk
    from repro_torch.dist.sharding import use_mesh_rules
    from repro_torch.models import bert4rec as b4

    import numpy as np

    dev = torch.device("cuda")
    cfg = get_arch("bert4rec").make_model_cfg()
    t0 = time.perf_counter()
    params = b4.init_bert4rec(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    users = make_cloze_batch(np.random.default_rng(seed), DIST_TOPK_USERS,
                             cfg.max_len, cfg.vocab, cfg.mask_id,
                             device=dev)["items"]
    p = b4.cast_params(params, torch.bfloat16)
    user = b4.bert4rec_encode(p, users, cfg, dtype=torch.bfloat16)[:, -1, :]
    scores = (user @ p["item_emb"][: cfg.vocab].T).float()
    del p, user
    mesh = {"data": 1, "model": DIST_TOPK_BLOCKS}
    k = DIST_TOPK_K
    lo, hi = scores.min(), scores.max()
    tied = torch.round((scores - lo) / (hi - lo) * (DIST_TIE_LEVELS - 1))
    rec = {"phase": "dist_topk", "users": DIST_TOPK_USERS,
           "items": cfg.vocab, "k": k, "blocks": DIST_TOPK_BLOCKS,
           "cases": {}}
    for name, x in [("scores", scores), ("tied_16_values", tied)]:
        v, i = distributed_topk(x, k, mesh)
        sv, si = torch.sort(x, dim=-1, descending=True, stable=True)
        case = {"values_equal": torch.equal(v, sv[:, :k]),
                "ids_equal": torch.equal(i, si[:, :k]),
                "distinct_values_in_top_k": int(torch.unique(v).numel()),
                "ms": cuda_ms(lambda: distributed_topk(x, k, mesh), 5),
                "torch_topk_ms": cuda_ms(lambda: torch.topk(x, k), 5),
                "stable_sort_ms": cuda_ms(lambda: torch.sort(
                    x, dim=-1, descending=True, stable=True), 3)}
        del sv, si
        rec["cases"][name] = case
    with use_mesh_rules(mesh):
        v, i = b4.bert4rec_score(params, users, cfg, top_k=k)
    sv, si = torch.sort(scores, dim=-1, descending=True, stable=True)
    rec["bert4rec_score_equal"] = bool(torch.equal(v, sv[:, :k])
                                       and torch.equal(i, si[:, :k]))
    del params, scores, tied, sv, si
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    emit(rec)
    if not rec["bert4rec_score_equal"] or not all(
            c["values_equal"] and c["ids_equal"]
            for c in rec["cases"].values()):
        raise AssertionError(f"two-stage top-k: {rec}")
    return rec


def dist_reshard(seed: int, mesh, log) -> dict:
    """(d) TinyLlama's parameters through ``reshard`` onto the mesh
    (replicated DTensors) and back (their full tensors), then a checkpoint
    saved from the mesh (``train.checkpoint.save`` of the DTensor tree,
    4.1 GB) and restored with ``shardings=`` (the mesh and its
    placements): every leaf bit-equal."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import get_arch
    from repro_torch.dist.elastic import reshard
    from repro_torch.models import transformer as tfm
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.tree import tree_leaves, tree_map

    dev = torch.device("cuda")
    cfg = get_arch(LM_ARCH).make_model_cfg()
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    on_mesh = reshard(params, mesh)
    kinds = {type(x).__name__ for x in tree_leaves(on_mesh)}
    back = tree_map(lambda x: x.full_tensor(), on_mesh)
    round_trip = all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                       tree_leaves(back)))
    del back
    with tempfile.TemporaryDirectory() as d:
        t1 = time.perf_counter()
        ckpt.save(d, 1, on_mesh)
        save_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        restored, step, _ = ckpt.restore(
            d, on_mesh, shardings=(mesh, [Replicate()] * mesh.ndim))
        restore_s = time.perf_counter() - t1
        size = sum(os.path.getsize(os.path.join(d, "step_00000001", f))
                   for f in os.listdir(os.path.join(d, "step_00000001")))
    restored_ok = step == 1 and all(
        isinstance(x, DTensor) and x.device_mesh == mesh
        and torch.equal(x.full_tensor(), p)
        for x, p in zip(tree_leaves(restored), tree_leaves(params)))
    n = len(tree_leaves(params))
    del params, on_mesh, restored
    torch.cuda.empty_cache()
    rec = {"phase": "dist_reshard", "arch": LM_ARCH, "leaves": n,
           "leaf_types_on_mesh": sorted(kinds),
           "reshard_round_trip_bit_equal": round_trip,
           "checkpoint_restored_bit_equal": restored_ok,
           "checkpoint_bytes": size, "save_seconds": save_s,
           "restore_seconds": restore_s,
           "seconds": time.perf_counter() - t0}
    emit(rec)
    if not (round_trip and restored_ok and kinds == {"DTensor"}):
        raise AssertionError(f"reshard / restore onto the mesh: {rec}")
    return rec


def phase_distribution(seed: int, log, records: list) -> dict:
    """Phase 14: a one-rank NCCL group on the card (a ``FileStore``, no
    network), ``make_mesh_for()`` → a (1, 1) ("data", "model") mesh on
    ``cuda``; then (a) ``dist_train``, (b) ``dist_compress``, (c)
    ``dist_topk``, (d) ``dist_reshard``; the group is destroyed at the
    end.  NCCL that cannot start fails the phase (no gloo fallback).  Rows
    4 and 7 of the ``kernels`` record gain (a)'s launches on the mesh."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.elastic import make_mesh_for

    t0 = time.perf_counter()
    store_dir = tempfile.TemporaryDirectory()
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(store_dir.name, "store"),
                                     1),
        rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, want nccl")
        mesh = make_mesh_for()
        if mesh.device_type != "cuda" or tuple(mesh.mesh.shape) != (1, 1) \
                or mesh.mesh_dim_names != ("data", "model"):
            raise AssertionError(f"mesh {mesh}")
        emit({"phase": "dist_mesh", "backend": dist.get_backend(),
              "mesh": str(mesh), "device_type": mesh.device_type,
              "init_seconds": time.perf_counter() - t0})
        train = dist_train(seed, mesh, log)
        torch.cuda.empty_cache()
        dist_compress(seed, mesh, log)
        torch.cuda.empty_cache()
        dist_topk(seed, log)
        torch.cuda.empty_cache()
        dist_reshard(seed, mesh, log)
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        store_dir.cleanup()
    for row in records:
        if row["name"] in ("flash_attention", "flash_attention_bwd"):
            row["launches_dist_train"] = train["launches_mesh"].get(
                row["name"], 0)
            row["dist_train_steps"] = DIST_STEPS
    secs = time.perf_counter() - t0
    emit({"phase": "distribution_seconds", "seconds": secs})
    return {"train": train, "seconds": secs}


# --------------------------------------------------------------------- #
# phase 15: models on a two-rank mesh on the one card
# --------------------------------------------------------------------- #
#: two ranks on cuda:0: two threads of this process in torch's threaded
#: process group, which carries every collective as torch ops on the
#: ranks' tensors (NCCL refuses two ranks on one device; gloo's functional
#: collectives on CUDA tensors crash its processes in torch 2.11)
MP_WORLD, MP_BACKEND, MP_GROUP_TIMEOUT_S = 2, "threaded", 900
#: (a) TinyLlama-1.1B, 8 × 512, AdamW, 3 steps on ("data", "model") =
#: (1, 2): step 0's loss and gradient norm at phase 13's tolerances, steps
#: 1-2's losses at 1e-2
MP_STEPS, MP_B, MP_S = 3, 8, 512
MP_LOSS_RTOL0, MP_GNORM_RTOL0, MP_LOSS_RTOL = 2e-3, 2e-2, 1e-2
#: (b) Granite-MoE-3B-A800M, 32 layers, fp32 on (1, 2): serve_prefill on
#: 8 × 128, then 32 decode steps (16 prompt tokens into the cache, 16
#: greedy); logits at phase 12's tolerances; expert ids and kept sets
#: equal except at (token, slot) pairs whose router top-k gap is < 1e-5
MP_MOE_B, MP_MOE_P, MP_MOE_FORCED, MP_MOE_NEW = 8, 128, 16, 16
MP_MOE_RTOL, MP_MOE_ATOL, MP_TIE_GAP = 1e-3, 1e-4, 1e-5
#: (c) Granite at published width cut to 4 layers, bf16, 3 AdamW steps on
#: (2, 1), 8 × 512: losses (the aux term in them) at (a)'s tolerances; the
#: aux loss of step 0's batch at 1e-5 in an fp32 forward (in bf16 the
#: ranks' 2048-row GEMMs round the router's inputs otherwise than one
#: device's 4096-row ones, and each token whose top-1 expert flips moves
#: the aux by ~3e-5 of itself)
MP_DP_LAYERS, MP_AUX_RTOL = 4, 1e-5
#: (d) BERT4Rec at 10⁶ items: 512 users, top 10, on (1, 2)
MP_B4_USERS, MP_B4_K = 512, 10
#: (e) GraphSAGE-Reddit, 512 seeds (25-10), binned_edges, on (2, 1)
MP_SAGE_SEEDS = 512
#: ops that run whole on every rank in each sub-phase (no DTensor rule
#: keeps them split, or the rules replicate them)
MP_GATHERED = {
    "mp_train": [],
    "mp_moe": ["embedding and unembedding table whole on both ranks "
               "(vocab 49,155 does not divide by 2)"],
    "mp_moe_dp": [],
    "mp_bert4rec": ["item-embedding gather and encoder replicated over "
                    "model (data = 1)"],
    "mp_gnn": ["node states gathered whole before each gather by "
               "edge_src / edge_dst (take_rows)",
               "in-degree segment sum: each rank's edges into every node, "
               "summed over data"],
}


def mp_mesh(shape):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cuda", torch.arange(MP_WORLD).reshape(shape),
                      mesh_dim_names=("data", "model"))


#: what the spies record for the calling thread: ``heads`` a set of
#: (kernel, q heads, KV heads), ``routes`` a list of MoE routings (None:
#: not recorded)
MP_SEEN = threading.local()


@contextlib.contextmanager
def mp_spies():
    """For the whole phase: the attention wrappers replaced by ones that
    note (kernel, q heads, KV heads) and call through, and the MoE's
    ``route`` / ``_bin_and_dispatch`` by ones that note the top (k + 1)
    router probabilities, the expert ids and the kept set in (token, slot)
    order, each into the calling thread's ``MP_SEEN`` (the ranks are
    threads)."""
    import torch

    from repro_torch.kernels.flash_attention import decode_kernel, ops
    from repro_torch.models import moe

    names = [(ops, n) for n in ("flash_attention_cuda",
                                "flash_attention_wgmma_cuda",
                                "flash_attention_bwd_cuda",
                                "flash_attention_bwd_wgmma_cuda")]
    names += [(decode_kernel, "flash_decode_cuda"), (moe, "route"),
              (moe, "_bin_and_dispatch")]
    real = {n: getattr(m, n) for m, n in names}

    def note(name):
        def call(q, k, *a, **kw):
            heads = getattr(MP_SEEN, "heads", None)
            if heads is not None:
                heads.add((name, int(q.shape[1]), int(k.shape[1])))
            return real[name](q, k, *a, **kw)
        return call

    def route(params, xt, cfg):
        probs, gate_vals, ids = real["route"](params, xt, cfg)
        if getattr(MP_SEEN, "routes", None) is not None:
            top = torch.sort(probs, dim=-1, descending=True,
                             stable=True).values[:, :cfg.top_k + 1]
            MP_SEEN.routes.append({"top": top.float().cpu(),
                                   "ids": ids.cpu()})
        return probs, gate_vals, ids

    def bin_(xt, gate_vals, ids, E, C):
        out = real["_bin_and_dispatch"](xt, gate_vals, ids, E, C)
        if getattr(MP_SEEN, "routes", None) is not None:
            keep_sorted, order = out[4], out[5]
            pair = torch.empty_like(keep_sorted).index_copy_(0, order,
                                                             keep_sorted)
            MP_SEEN.routes[-1]["keep"] = pair.view(ids.shape).cpu()
        return out

    for m, n in names[:5]:
        setattr(m, n, note(n))
    moe.route, moe._bin_and_dispatch = route, bin_
    try:
        yield
    finally:
        for m, n in names:
            setattr(m, n, real[n])


def mp_watch(routes: bool = False):
    """Start this thread's records (attention heads; MoE routings when
    ``routes``) and zero its launch counts."""
    from repro_torch.kernels import cuda_build

    MP_SEEN.heads = set()
    MP_SEEN.routes = [] if routes else None
    cuda_build.reset_launches()


def mp_peak(mesh, reset: bool):
    """Peak ``max_memory_allocated`` in GB for a one-device run (reset it
    when ``reset``); on a mesh the ranks share the process, so the phase
    reads the peak of both around each sub-phase instead (None here)."""
    import torch

    if mesh is not None:
        return None
    if reset:
        torch.cuda.reset_peak_memory_stats()
        return None
    return torch.cuda.max_memory_allocated() / 1e9


def mp_lm_train(seed: int, mesh, cfg, steps: int, dispatch_mesh=None,
                param_axes=None) -> dict:
    """``steps`` AdamW steps of ``cfg`` on 8 × 512 tokens from ``seed``
    through ``Trainer(mesh=mesh)`` (None: one device, its MoE dispatch
    under ``use_mesh_rules(dispatch_mesh)``): losses, aux, gradient norms,
    ms a step, the launches."""
    import torch

    from repro_torch.data.tokens import synthetic_lm_batches
    from repro_torch.dist.sharding import use_mesh_rules
    from repro_torch.kernels import cuda_build
    from repro_torch.models import transformer as tfm
    from repro_torch.train.optim import adamw, cosine_schedule
    from repro_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tfm.init_params(cfg, gen, dev)
    batches = synthetic_lm_batches(MP_B, MP_S, cfg.vocab, seed=seed,
                                   device=dev, mesh=mesh)

    def loss_fn(p, b):
        with use_mesh_rules(dispatch_mesh if mesh is None else mesh):
            return tfm.loss_fn(p, b, cfg)

    tr = Trainer(loss_fn=loss_fn,
                 optimizer=adamw(cosine_schedule(3e-4, 20, steps)),
                 mesh=mesh, param_axes=param_axes,
                 denominator=(lambda b: tfm.loss_denominator(b, cfg))
                 if mesh is not None else None)
    p, st = tr.init_state(params)
    del params
    torch.cuda.synchronize()
    mp_peak(mesh, reset=True)
    mp_watch()
    p, st, hist = tr.run(p, st, batches, num_steps=steps, log_every=1,
                         log_fn=lambda *_: None)
    torch.cuda.synchronize()
    return {"losses": [h["loss"] for h in hist],
            "aux": [h["moe_aux"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist],
            "step_ms": [1e3 * h["dt"] for h in hist],
            "launches": dict(cuda_build.thread_launches()),
            "heads": sorted(MP_SEEN.heads),
            "peak_memory_gb": mp_peak(mesh, reset=False)}


def mp_aux_fp32(seed: int, mesh, cfg, dispatch_mesh=None) -> float:
    """The aux loss of ``cfg`` (fp32 compute) on the first 8 × 512 batch
    from ``seed``, at the parameters ``seed`` draws: on ``mesh`` each
    rank's block, the aux's means all-reduced; else one device under
    ``use_mesh_rules(dispatch_mesh)``."""
    import torch

    from repro_torch.data.tokens import synthetic_lm_batches
    from repro_torch.dist.sharding import use_mesh_rules
    from repro_torch.models import transformer as tfm

    dev = torch.device("cuda")
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    batch = next(synthetic_lm_batches(MP_B, MP_S, cfg.vocab, seed=seed,
                                      device=dev, mesh=mesh))
    with torch.no_grad(), use_mesh_rules(dispatch_mesh if mesh is None
                                         else mesh):
        _, metrics = tfm.loss_fn(params, batch, cfg)
    return float(metrics["moe_aux"])


def mp_moe_serve(seed: int, mesh, records: bool) -> dict:
    """Granite-MoE-3B-A800M at 32 layers, fp32: ``serve_prefill`` on
    8 × 128 prompts, then 16 prompt tokens decoded into a cache and 16
    greedy steps; on ``mesh`` the parameters placed by
    ``param_logical_axes`` and the cache split by ``kv_heads``."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import place_tree, use_mesh_rules
    from repro_torch.kernels import cuda_build
    from repro_torch.models import transformer as tfm

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_arch(MOE_ARCH).make_model_cfg(),
                              compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tfm.init_params(cfg, gen, dev)
    if mesh is not None:
        params = place_tree(params, tfm.param_logical_axes(cfg), mesh,
                            src_data_rank=None)
        torch.cuda.empty_cache()
    prompts = moe_prompts(MP_MOE_B, MP_MOE_P, cfg.vocab, seed + 2).to(dev)

    def feed(t):
        if mesh is None:
            return t
        return distribute_tensor(t, mesh, [Replicate()] * mesh.ndim,
                                 src_data_rank=None)

    def host(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).cpu()

    torch.cuda.synchronize()
    mp_peak(mesh, reset=True)
    mp_watch(routes=records)
    t0 = time.perf_counter()
    with torch.no_grad(), use_mesh_rules(mesh):
        pre = host(tfm.serve_prefill(params, feed(prompts), cfg))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        l_prefill = dict(cuda_build.thread_launches())
        cache = tfm.init_cache(cfg, MP_MOE_B, MP_MOE_FORCED + MP_MOE_NEW,
                               dtype=torch.float32, device=dev, mesh=mesh)
        logits, toks = [], []
        t1 = time.perf_counter()
        for t in range(MP_MOE_FORCED):
            lg, cache = tfm.serve_decode(params, feed(prompts[:, t:t + 1]),
                                         t, cache, cfg)
            logits.append(host(lg))
        tok = logits[-1].argmax(-1, keepdim=True).to(dev)
        for i in range(MP_MOE_NEW):
            lg, cache = tfm.serve_decode(params, feed(tok),
                                         MP_MOE_FORCED + i, cache, cfg)
            logits.append(host(lg))
            tok = logits[-1].argmax(-1, keepdim=True).to(dev)
            toks.append(tok.cpu())
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t1
    launches = dict(cuda_build.thread_launches())
    return {"prefill": pre, "logits": torch.stack(logits),
            "tokens": torch.cat(toks, 1), "routes": MP_SEEN.routes,
            "prefill_launches": l_prefill, "launches": launches,
            "heads": sorted(MP_SEEN.heads), "prefill_ms": 1e3 * prefill_s,
            "decode_ms_per_step": 1e3 * decode_s / (MP_MOE_FORCED
                                                    + MP_MOE_NEW),
            "peak_memory_gb": mp_peak(mesh, reset=False),
            "n_layers": cfg.n_layers, "heads_per_rank": (
                cfg.n_heads // MP_WORLD, cfg.n_kv_heads // MP_WORLD)}


def mp_b4_users(cfg):
    import numpy as np

    from repro_torch.data.recsys import make_cloze_batch

    return make_cloze_batch(np.random.default_rng(SEED + 3), MP_B4_USERS,
                            cfg.max_len, cfg.vocab, cfg.mask_id,
                            device="cpu")["items"]


def mp_b4_score(seed: int, mesh) -> dict:
    """BERT4Rec at 10⁶ items: ``bert4rec_score`` of 512 users, top 10; on
    ``mesh`` replicated parameters and the scores split by ``vocab``."""
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import place_tree, use_mesh_rules
    from repro_torch.models import bert4rec as b4

    dev = torch.device("cuda")
    cfg = get_arch("bert4rec").make_model_cfg()
    params = b4.init_bert4rec(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    users = mp_b4_users(cfg).to(dev)
    if mesh is not None:
        params = place_tree(params, None, mesh, src_data_rank=None)
        users = distribute_tensor(users, mesh, [Replicate()] * mesh.ndim,
                                  src_data_rank=None)
    torch.cuda.synchronize()
    mp_peak(mesh, reset=True)
    times = []
    with torch.no_grad(), use_mesh_rules(mesh):
        for _ in range(3):
            t0 = time.perf_counter()
            v, i = b4.bert4rec_score(params, users, cfg, top_k=MP_B4_K)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    full = [(t.full_tensor() if hasattr(t, "full_tensor") else t).cpu()
            for t in (v, i)]
    return {"values": full[0], "ids": full[1], "ms": 1e3 * min(times[1:]),
            "peak_memory_gb": mp_peak(mesh, reset=False)}


def mp_sage_batch(seed: int):
    """A GraphSAGE-Reddit batch of 512 seeds (25-10) on the host, its
    edges laid out in two destination stripes (``binned_edges``)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.graphs import reddit_like
    from repro_torch.data.sampler import NeighborSampler
    from repro_torch.models.gnn import bin_edges_by_stripe

    cfg = get_arch("graphsage-reddit").make_model_cfg()
    g, host = reddit_like(seed=seed, device="cpu")
    sampler = NeighborSampler(g, host.node_feat.numpy(), host.labels.numpy(),
                              cfg.sample_sizes, seed=seed, device="cpu")
    return bin_edges_by_stripe(sampler.sample(MP_SAGE_SEEDS), MP_WORLD)


def mp_sage_grads(seed: int, mesh, batch) -> dict:
    """One gradient of GraphSAGE-Reddit (``binned_edges``) on ``batch``:
    on ``mesh`` the batch placed by ``nodes`` / ``edges`` and the
    parameters replicated."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import place_tree, use_mesh_rules
    from repro_torch.models import gnn
    from repro_torch.train.trainer import _value_and_grad
    from repro_torch.train.tree import tree_leaves

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_arch("graphsage-reddit").make_model_cfg(),
                              binned_edges=True)
    params = gnn.init_gnn(torch.Generator(device=dev).manual_seed(seed), cfg,
                          dev)
    batch = dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).to(dev)
        for f in dataclasses.fields(batch) if getattr(batch, f.name)
        is not None})
    if mesh is not None:
        params = place_tree(params, None, mesh, src_data_rank=None)
        batch = gnn.place_batch(batch, mesh)
    torch.cuda.synchronize()
    mp_peak(mesh, reset=True)
    t0 = time.perf_counter()
    with use_mesh_rules(mesh):
        loss, _, grads = _value_and_grad(
            lambda p, b: gnn.gnn_loss_fn(p, b, cfg), params, batch)
    full = [(g.full_tensor() if hasattr(g, "full_tensor") else g).cpu()
            for g in tree_leaves(grads)]
    torch.cuda.synchronize()
    loss = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
    return {"loss": float(loss), "grads": full,
            "ms": 1e3 * (time.perf_counter() - t0),
            "peak_memory_gb": mp_peak(mesh, reset=False)}


def mp_rank_jobs(rank: int, seed: int, inputs: dict) -> dict:
    """Phase 15 on one rank: every sub-phase's mesh side, in order."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm

    out = {}
    cfg = get_arch(LM_ARCH).make_model_cfg()
    dp_cfg = dataclasses.replace(get_arch(MOE_ARCH).make_model_cfg(),
                                 n_layers=MP_DP_LAYERS)
    jobs = [
        ("mp_train", lambda: mp_lm_train(
            seed, mp_mesh((1, 2)), cfg, MP_STEPS,
            param_axes=tfm.param_logical_axes(cfg))),
        ("mp_moe", lambda: mp_moe_serve(seed, mp_mesh((1, 2)), rank == 0)),
        ("mp_moe_dp", lambda: {**mp_lm_train(
            seed, mp_mesh((2, 1)), dp_cfg, MP_STEPS), "aux_fp32": mp_aux_fp32(
                seed, mp_mesh((2, 1)), dp_cfg)}),
        ("mp_bert4rec", lambda: mp_b4_score(seed, mp_mesh((1, 2)))),
        ("mp_gnn", lambda: mp_sage_grads(seed, mp_mesh((2, 1)),
                                         inputs["sage_batch"])),
    ]
    for name, job in jobs:
        torch.distributed.barrier()
        if rank == 0:
            torch.cuda.reset_peak_memory_stats()
        torch.distributed.barrier()
        t0 = time.perf_counter()
        out[name] = job()
        out[name]["seconds"] = time.perf_counter() - t0
        emit({"phase": "mp_rank_done", "rank": rank, "subphase": name,
              "seconds": out[name]["seconds"]})
        torch.distributed.barrier()
        if rank == 0:  # both ranks' tensors live in this process
            out[name]["peak_memory_gb_both_ranks"] = \
                torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
    return out


def mp_threads(seed: int, inputs: dict) -> list:
    """Both ranks' results, in rank order: two threads joined in torch's
    threaded process group (a ``HashStore``; each rank's collectives are
    torch ops on the ranks' CUDA tensors), each running
    :func:`mp_rank_jobs`.  A rank's failure wakes the other and raises
    with its traceback; a rank still running after the limit raises too
    (the threads are daemons, so none outlives the script)."""
    import traceback

    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed import multi_threaded_pg as tpg

    results, errors = {}, {}
    store = dist.HashStore()

    def rank_main(rank: int):
        try:
            torch.cuda.set_device(0)
            # the group lives in this thread's world, which
            # _uninstall_threaded_pg drops whole (torch 2.11's
            # destroy_process_group cannot take a thread's world)
            dist.init_process_group(MP_BACKEND, rank=rank,
                                    world_size=MP_WORLD, store=store)
            emit({"phase": "mp_rank_start", "rank": rank,
                  "backend": dist.get_backend()})
            results[rank] = mp_rank_jobs(rank, seed, inputs)
        except BaseException:
            errors[rank] = traceback.format_exc()
            tpg.ProcessLocalGroup.exception_handle(None)  # wake the peer

    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    tpg._install_threaded_pg()
    threads = [threading.Thread(target=rank_main, args=(r,), daemon=True,
                                name=f"mp_rank{r}") for r in range(MP_WORLD)]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + MP_GROUP_TIMEOUT_S
        for t in threads:
            t.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        tpg.ProcessLocalGroup.reset()
        tpg._uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    if errors:
        raise AssertionError(f"phase 15, rank {min(errors)}:\n"
                             f"{errors[min(errors)]}")
    if any(t.is_alive() for t in threads) or len(results) != MP_WORLD:
        raise AssertionError(f"phase 15: a rank did not finish in "
                             f"{MP_GROUP_TIMEOUT_S} s")
    return [results[r] for r in range(MP_WORLD)]


def mp_line(name: str, ranks: list, **extra) -> dict:
    """A sub-phase's line: ms, peak memory and attention launches per
    rank, the ops that stay whole, and ``extra``."""
    per = [r[name] for r in ranks]
    rec = {"phase": name, "backend": MP_BACKEND, "ranks": MP_WORLD,
           "device": "cuda:0", "seconds_per_rank": [p["seconds"] for p in per],
           "peak_memory_gb_both_ranks": per[0]["peak_memory_gb_both_ranks"],
           "launches_per_rank": [p.get("launches", {}) for p in per],
           "gathered_ops": MP_GATHERED[name]}
    rec.update(extra)
    return rec


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def mp_check_train(ranks, one) -> dict:
    """(a): the mesh's losses and gradient norm against one device; 22
    tensor-core launches of each attention kernel a step on 16 q heads
    and 2 KV heads."""
    from repro_torch.configs import get_arch

    cfg = get_arch(LM_ARCH).make_model_cfg()
    n = cfg.n_layers
    hq, hkv = cfg.n_heads // MP_WORLD, cfg.n_kv_heads // MP_WORLD
    mesh = ranks[0]["mp_train"]
    rec = mp_line("mp_train", ranks, arch=LM_ARCH, mesh=[1, 2],
                  batch=MP_B, seq=MP_S, steps=MP_STEPS,
                  params=cfg.param_count(),
                  losses_mesh=mesh["losses"], losses_one_device=one["losses"],
                  grad_norms_mesh=mesh["grad_norms"],
                  grad_norms_one_device=one["grad_norms"],
                  step_ms_mesh=mesh["step_ms"], step_ms_one_device=one[
                      "step_ms"], heads=[list(h) for h in mesh["heads"]],
                  loss0_rel=rel(mesh["losses"][0], one["losses"][0]),
                  grad_norm0_rel=rel(mesh["grad_norms"][0],
                                     one["grad_norms"][0]),
                  loss_rel_steps=[rel(a, b) for a, b in zip(
                      mesh["losses"], one["losses"])])
    emit(rec)
    if not (rec["loss0_rel"] <= MP_LOSS_RTOL0
            and rec["grad_norm0_rel"] <= MP_GNORM_RTOL0
            and all(r <= MP_LOSS_RTOL for r in rec["loss_rel_steps"])):
        raise AssertionError(f"mp_train: the mesh misses one device: {rec}")
    want = n * MP_STEPS
    for r in ranks:
        lc = r["mp_train"]["launches"]
        if any(lc.get(k, 0) != want for k in (
                "flash_attention", "flash_attention_wgmma",
                "flash_attention_bwd", "flash_attention_bwd_wgmma")):
            raise AssertionError(f"mp_train: a rank launched {lc}; want "
                                 f"{want} of each tensor-core kernel")
        if r["mp_train"]["heads"] != [
                ("flash_attention_bwd_wgmma_cuda", hq, hkv),
                ("flash_attention_wgmma_cuda", hq, hkv)]:
            raise AssertionError(f"mp_train: heads {r['mp_train']['heads']}"
                                 f"; want {hq} q and {hkv} KV heads a rank")
    return rec


def mp_route_compare(mesh_routes, one_routes) -> dict:
    """Expert ids and kept sets of the mesh's rank 0 against one device,
    call by call; differences allowed only at (token, slot) pairs whose
    router top-k gap (to the neighbouring probability) is < 1e-5 (a kept
    set may then move in that call)."""
    import torch

    if len(mesh_routes) != len(one_routes):
        raise AssertionError(f"{len(mesh_routes)} MoE routings on the "
                             f"mesh, {len(one_routes)} on one device")
    near = ids_off = keep_off = keep_off_calls = 0
    for m, o in zip(mesh_routes, one_routes):
        top = o["top"]
        k = o["ids"].shape[1]
        gaps = top[:, :-1] - top[:, 1:]  # gap j: between p_j and p_j+1
        lo = torch.cat([torch.full_like(gaps[:, :1], float("inf")),
                        gaps[:, :k - 1]], 1)
        pair_gap = torch.minimum(lo, gaps[:, :k])
        tie = pair_gap < MP_TIE_GAP
        near += int(tie.sum())
        bad_ids = m["ids"] != o["ids"]
        if bool((bad_ids & ~tie).any()):
            raise AssertionError("expert ids differ away from a router tie")
        ids_off += int(bad_ids.sum())
        bad_keep = m["keep"] != o["keep"]
        if bool(bad_keep.any()):
            if not bool(tie.any()):
                raise AssertionError("kept sets differ in a routing "
                                     "without a router tie")
            keep_off += int(bad_keep.sum())
            keep_off_calls += 1
    return {"routings": len(one_routes), "near_tie_pairs": near,
            "expert_ids_differing": ids_off, "kept_differing": keep_off,
            "routings_with_kept_differing": keep_off_calls}


def mp_check_moe(ranks, one) -> dict:
    """(b): logits against one device, greedy tokens equal, expert ids and
    kept sets by :func:`mp_route_compare`; one ``flash_attention`` a layer
    in the prefill and one ``flash_decode`` a layer a step, on 12 q and 4
    KV heads a rank."""
    import torch

    mesh = ranks[0]["mp_moe"]
    n = one["n_layers"]
    hq, hkv = one["heads_per_rank"]
    steps = MP_MOE_FORCED + MP_MOE_NEW

    def share(a, b):
        return float(((a - b).abs() / (MP_MOE_ATOL + MP_MOE_RTOL * b.abs()))
                     .max())

    routes = mp_route_compare(mesh["routes"], one["routes"])
    rec = mp_line("mp_moe", ranks, arch=MOE_ARCH, mesh=[1, 2],
                  n_layers=n, prompts=[MP_MOE_B, MP_MOE_P],
                  decode_steps=steps, dtype="float32",
                  prefill_tolerance_used=share(mesh["prefill"],
                                               one["prefill"]),
                  decode_tolerance_used=share(mesh["logits"], one["logits"]),
                  prefill_max_abs_err=float((mesh["prefill"]
                                             - one["prefill"]).abs().max()),
                  tokens_equal=bool(torch.equal(mesh["tokens"],
                                                one["tokens"])),
                  prefill_ms_mesh=mesh["prefill_ms"],
                  prefill_ms_one_device=one["prefill_ms"],
                  decode_ms_per_step_mesh=mesh["decode_ms_per_step"],
                  decode_ms_per_step_one_device=one["decode_ms_per_step"],
                  heads=[list(h) for h in mesh["heads"]], **routes)
    emit(rec)
    if not (rec["prefill_tolerance_used"] <= 1.0
            and rec["decode_tolerance_used"] <= 1.0 and rec["tokens_equal"]):
        raise AssertionError(f"mp_moe: the mesh misses one device: {rec}")
    for r in ranks:
        m = r["mp_moe"]
        if m["prefill_launches"].get("flash_attention", 0) != n \
                or m["launches"].get("flash_attention", 0) != n \
                or m["launches"].get("flash_decode", 0) != n * steps:
            raise AssertionError(f"mp_moe: a rank launched {m['launches']}"
                                 f"; want flash_attention = {n}, "
                                 f"flash_decode = {n * steps}")
        if m["heads"] != [("flash_attention_cuda", hq, hkv),
                          ("flash_decode_cuda", hq, hkv)]:
            raise AssertionError(f"mp_moe: heads {m['heads']}; want {hq} q "
                                 f"and {hkv} KV heads a rank")
    return rec


def mp_check_moe_dp(ranks, one) -> dict:
    """(c): losses (with the aux term) at (a)'s tolerances and the aux of
    step 0's batch in fp32 at 1e-5 against one device under the same
    two-shard dispatch; 4 + 4 tensor-core attention launches a step a
    rank."""
    mesh = ranks[0]["mp_moe_dp"]
    rec = mp_line("mp_moe_dp", ranks, arch=MOE_ARCH, mesh=[2, 1],
                  n_layers=MP_DP_LAYERS, batch=MP_B, seq=MP_S,
                  steps=MP_STEPS, dtype="bfloat16",
                  reduced={"n_layers": [32, MP_DP_LAYERS]},
                  losses_mesh=mesh["losses"], losses_one_device=one["losses"],
                  aux_mesh=mesh["aux"], aux_one_device=one["aux"],
                  aux0_rel=rel(mesh["aux"][0], one["aux"][0]),
                  aux_fp32_mesh=mesh["aux_fp32"],
                  aux_fp32_one_device=one["aux_fp32"],
                  aux_fp32_rel=rel(mesh["aux_fp32"], one["aux_fp32"]),
                  loss0_rel=rel(mesh["losses"][0], one["losses"][0]),
                  loss_rel_steps=[rel(a, b) for a, b in zip(
                      mesh["losses"], one["losses"])],
                  step_ms_mesh=mesh["step_ms"],
                  step_ms_one_device=one["step_ms"])
    emit(rec)
    if not (rec["loss0_rel"] <= MP_LOSS_RTOL0
            and rec["aux0_rel"] <= MP_LOSS_RTOL0
            and rec["aux_fp32_rel"] <= MP_AUX_RTOL
            and all(r <= MP_LOSS_RTOL for r in rec["loss_rel_steps"])):
        raise AssertionError(f"mp_moe_dp: the mesh misses one device: {rec}")
    for r in ranks:
        lc = r["mp_moe_dp"]["launches"]
        if r["mp_moe_dp"]["losses"] != mesh["losses"] or any(
                lc.get(k, 0) != MP_DP_LAYERS * MP_STEPS
                for k in ("flash_attention", "flash_attention_bwd")):
            raise AssertionError(f"mp_moe_dp: rank results {lc}")
    return rec


def mp_check_b4(ranks, seed: int) -> dict:
    """(d): the mesh's ids tie-aware against fp32 scores (phase 8's rule)
    and against one device; recall of one device's top 10."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import bert4rec as b4

    dev = torch.device("cuda")
    cfg = get_arch("bert4rec").make_model_cfg()
    one = mp_b4_score(seed, None)
    params = b4.init_bert4rec(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    users = mp_b4_users(cfg).to(dev)
    with torch.no_grad():
        user32 = b4.bert4rec_encode(params, users, cfg)[:, -1, :]
        s32 = user32 @ params["item_emb"][: cfg.vocab].T
    top32 = s32.topk(MP_B4_K, dim=-1)
    tol = SCORE_TOL_OF_MAX * s32.abs().amax(dim=-1, keepdim=True)
    ids = ranks[0]["mp_bert4rec"]["ids"].to(dev)
    margin = s32.gather(1, ids) - (top32.values[:, -1:] - tol)
    hits = (ids[:, :, None] == one["ids"].to(dev)[:, None, :]).any(-1)
    rec = mp_line("mp_bert4rec", ranks, items=cfg.vocab,
                  users=MP_B4_USERS, top_k=MP_B4_K, mesh=[1, 2],
                  ms_mesh=ranks[0]["mp_bert4rec"]["ms"], ms_one_device=one[
                      "ms"], recall_of_one_device_top10=float(
                          hits.float().mean()),
                  ids_equal_one_device=bool(torch.equal(
                      ids.cpu(), one["ids"])),
                  min_margin_over_tol=float(margin.min()),
                  score_tol_of_max=SCORE_TOL_OF_MAX)
    emit(rec)
    del params, s32, user32
    distinct = all(len(set(r)) == MP_B4_K for r in ids.tolist())
    if ids.shape != (MP_B4_USERS, MP_B4_K) or not distinct \
            or not bool((margin >= 0).all()) \
            or not torch.equal(ranks[1]["mp_bert4rec"]["ids"],
                               ranks[0]["mp_bert4rec"]["ids"]):
        raise AssertionError(f"mp_bert4rec: ids fail the tie-aware check: "
                             f"{rec}")
    return rec


def mp_check_gnn(ranks, one) -> dict:
    """(e): loss and every gradient of the mesh within ``SUM_RTOL`` of the
    largest magnitude of one device's."""
    mesh = ranks[0]["mp_gnn"]
    errs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(mesh["grads"], one["grads"])]
    rec = mp_line("mp_gnn", ranks, arch="graphsage-reddit", mesh=[2, 1],
                  seeds=MP_SAGE_SEEDS, binned_edges=True,
                  loss_mesh=mesh["loss"], loss_one_device=one["loss"],
                  loss_rel=rel(mesh["loss"], one["loss"]),
                  grad_rel_of_max=errs, ms_mesh=mesh["ms"],
                  ms_one_device=one["ms"])
    emit(rec)
    if not (rec["loss_rel"] <= SUM_RTOL and max(errs) <= SUM_RTOL
            and len(errs) == len(one["grads"])):
        raise AssertionError(f"mp_gnn: the mesh misses one device: {rec}")
    return rec


def phase_model_parallel(seed: int, log, records: list) -> dict:
    """Phase 15: the models on a ("data", "model") mesh of two ranks on
    the one card (two threads in torch's threaded process group), each
    sub-phase against the same work on one device run here first: (a)
    ``mp_train``, (b) ``mp_moe``, (c) ``mp_moe_dp``, (d) ``mp_bert4rec``,
    (e) ``mp_gnn``.  Rows 4, 5 and 7 of the ``kernels`` record gain the
    ranks' launches (``launches_model_parallel``)."""
    import torch

    from repro_torch.configs import get_arch

    t0 = time.perf_counter()

    def one_device(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.empty_cache()
        emit({"phase": "mp_one_device_done", "subphase": name,
              "seconds": time.perf_counter() - t})
        return out

    cfg = get_arch(LM_ARCH).make_model_cfg()
    with mp_spies():
        one_train = one_device("mp_train", lambda: mp_lm_train(
            seed, None, cfg, MP_STEPS))
        one_moe = one_device("mp_moe", lambda: mp_moe_serve(seed, None,
                                                             True))
        dp_cfg = dataclasses.replace(get_arch(MOE_ARCH).make_model_cfg(),
                                     n_layers=MP_DP_LAYERS)
        two_shards = {"data": MP_WORLD, "model": 1}
        one_dp = one_device("mp_moe_dp", lambda: {**mp_lm_train(
            seed, None, dp_cfg, MP_STEPS, dispatch_mesh=two_shards),
            "aux_fp32": mp_aux_fp32(seed, None, dp_cfg, two_shards)})
        sage = mp_sage_batch(seed)
        one_gnn = one_device("mp_gnn", lambda: mp_sage_grads(seed, None,
                                                             sage))
        one_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        ranks = mp_threads(seed, {"sage_batch": sage})
        mesh_s = time.perf_counter() - t1
    emit({"phase": "mp_group", "backend": MP_BACKEND, "ranks": MP_WORLD,
          "device": "cuda:0", "one_device_seconds": one_s,
          "mesh_seconds": mesh_s,
          "why": "two ranks on one card: NCCL refuses two ranks on one "
                 "device, and gloo's functional collectives (the "
                 "all_gather_tensor a DTensor redistribute issues) crashed "
                 "both of its processes on CUDA tensors; the threaded "
                 "group runs each collective as torch ops on the card"})
    mp_check_train(ranks, one_train)
    mp_check_moe(ranks, one_moe)
    mp_check_moe_dp(ranks, one_dp)
    mp_check_b4(ranks, seed)
    torch.cuda.empty_cache()
    mp_check_gnn(ranks, one_gnn)
    for row in records:
        if row["name"] not in ("flash_attention", "flash_decode",
                               "flash_attention_bwd"):
            continue
        total = {}
        for r in ranks:
            for name in ("mp_train", "mp_moe", "mp_moe_dp"):
                n = r[name]["launches"].get(row["name"], 0)
                if n:
                    total[name] = total.get(name, 0) + n
        row["launches_model_parallel"] = sum(total.values())
        row["launches_model_parallel_by_subphase"] = total
    secs = time.perf_counter() - t0
    emit({"phase": "model_parallel_seconds", "seconds": secs})
    return {"seconds": secs}


# --------------------------------------------------------------------- #
# phase 16: the dry-run, the roofline and the examples
# --------------------------------------------------------------------- #
#: (arch, shape, multi_pod) of the cells the dry-run traces here
DRYRUN_CELLS = [("tinyllama-1.1b", "train_4k", False),
                ("granite-moe-3b-a800m", "decode_32k", False),
                ("gat-cora", "full_graph_sm", False),
                ("bert4rec", "serve_p99", False),
                ("tinyllama-1.1b", "train_4k", True)]
#: a share (useful FLOP fraction, roofline fraction, MFU, the card-op
#: bound's share of a measured step) above this means the count lost work
SHARE_MAX = 1.05
#: torch_train_lm's run on the card, then its resumed run's last step
EXAMPLE_STEPS, EXAMPLE_RESUME_STEPS = 60, 70
#: the prefill phase 16(b) counts: phase 6's serve_prefill shape
PREFILL_SHAPE = (8, 2048)
#: the quickstart's PageRank stops at tol 1e-8, where its L1 step is
#: within 2x of fp32 rounding: a variant's iterations may differ from
#: base's by this many (the reference's own variants stop 2 apart)
QUICKSTART_ITERS = 2

_DRYRUN_SCRIPT = """
import json, sys
from repro_torch.launch.dryrun import run_cell
for arch, shape, multi in json.loads(sys.argv[1]):
    rec = run_cell(arch, shape, multi, out_dir=sys.argv[2])
    print("RECORD " + json.dumps(rec, default=str), flush=True)
"""


def phase_dryrun(log) -> list:
    """(a) ``run_cell`` on the production meshes, in a subprocess."""
    from repro_torch.configs import get_arch

    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        r = subprocess.run(
            [sys.executable, "-c", _DRYRUN_SCRIPT, json.dumps(DRYRUN_CELLS),
             out], env=env, cwd=str(ROOT), capture_output=True, text=True,
            timeout=600)
    log("--- dry-run ---\n" + r.stderr[-20000:])
    if r.returncode != 0:
        raise AssertionError(f"the dry-run exited {r.returncode}: "
                             f"{r.stderr[-3000:]}")
    recs = [json.loads(ln[len("RECORD "):]) for ln in r.stdout.splitlines()
            if ln.startswith("RECORD ")]
    if len(recs) != len(DRYRUN_CELLS):
        raise AssertionError(f"the dry-run gave {len(recs)} records for "
                             f"{len(DRYRUN_CELLS)} cells")
    for rec in recs:
        if not rec["ok"]:
            raise AssertionError(f"dry-run {rec['arch']} × {rec['shape']} "
                                 f"[{rec['mesh']}]: {rec.get('error')}\n"
                                 f"{rec.get('traceback')}")
        spec = get_arch(rec["arch"])
        dense_lm = spec.family == "lm" and not spec.make_model_cfg().is_moe
        emit({"phase": "dryrun", **{k: rec[k] for k in (
            "arch", "shape", "mesh", "num_devices", "dominant",
            "bound_seconds", "t_compute", "t_memory", "t_collective",
            "t_collective_by_axis", "flops_per_device", "bytes_per_device",
            "arg_bytes_per_device", "peak_bytes_per_device",
            "collective_counts", "model_flops", "useful_flop_frac",
            "roofline_fraction", "flops_by_scope", "trace_s")}})
        if dense_lm and rec["useful_flop_frac"] > SHARE_MAX:
            raise AssertionError(f"dry-run {rec['arch']} × {rec['shape']}: "
                                 f"useful_flop_frac {rec['useful_flop_frac']}"
                                 f" > {SHARE_MAX}: the count lost work")
    return recs


def check_meta_vs_card(what: str, meta, card):
    """Every op but the plain attention counts alike on the card and on
    meta: the meta count less the card's is exactly the FLOPs the meta run
    booked under the ``attention`` scope, and the card booked none."""
    attn = meta.flops_by_scope.get("attention", 0)
    if card.flops_by_scope or attn <= 0 or meta.flops - card.flops != attn:
        raise AssertionError(f"{what}: meta {meta.flops} − card "
                             f"{card.flops} = {meta.flops - card.flops}, "
                             f"want the attention scope's {attn} (card "
                             f"scopes {card.flops_by_scope})")
    return {"card_flops": card.flops, "meta_flops": meta.flops,
            "attention_plain_flops": attn, "card_bytes": card.bytes,
            "meta_bytes": meta.bytes}


def phase_counter_vs_card(seed: int, lm: dict, log) -> dict:
    """(b) phase 13's training step and phase 6's prefill shape, counted
    on the card and on meta tensors; (c) the step's roofline."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import cuda_build
    from repro_torch.launch import train as launch
    from repro_torch.launch.cells import META, shapes_only
    from repro_torch.launch.hlo_analysis import (PEAK_FLOPS, roofline_terms,
                                                 run_counted)
    from repro_torch.models import transformer as tfm
    from repro_torch.train.optim import adamw, cosine_schedule
    from repro_torch.train.trainer import make_train_step

    args = launch.build_parser().parse_args(TRAIN_ARGV + ["--seed",
                                                          str(seed)])
    cfg = get_arch(LM_ARCH).make_model_cfg()
    opt = adamw(cosine_schedule(args.lr, 20, args.steps))
    params, loss_fn, batches = launch._lm_setup(cfg, args)
    batch = next(batches)
    step = make_train_step(loss_fn, opt)
    state = opt.init(params)
    prompts = moe_prompts(*PREFILL_SHAPE, cfg.vocab, seed)

    def prefill(p, t):
        with torch.no_grad():
            return tfm.serve_prefill(p, t, cfg)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.reset_launches()
    card = run_counted(step, (params, state, batch))
    torch.cuda.synchronize()
    card_peak = torch.cuda.max_memory_allocated()
    launched = dict(cuda_build.launches)
    if any(launched.get(n, 0) != cfg.n_layers for n in (
            "flash_attention_wgmma", "flash_attention_bwd_wgmma")):
        raise AssertionError(f"the counted step launched {launched}")
    card_pf = run_counted(prefill, (params, prompts))
    torch.cuda.synchronize()
    tokens_shape = tuple(batch["tokens"].shape)
    tokens_dtype = batch["tokens"].dtype
    del params, state, batch, batches
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mparams = shapes_only(tfm.init_params, cfg, torch.Generator(),
                          device=META)
    mstate = opt.init(mparams)
    mbatch = {"tokens": torch.empty(tokens_shape, dtype=tokens_dtype,
                                    device=META)}
    meta = run_counted(step, (mparams, mstate, mbatch))
    meta_pf = run_counted(prefill, (mparams, torch.empty(
        PREFILL_SHAPE, dtype=prompts.dtype, device=META)))
    meta_s = time.perf_counter() - t0
    train_line = check_meta_vs_card("training step", meta, card)
    prefill_line = check_meta_vs_card("serve_prefill", meta_pf, card_pf)
    emit({"phase": "counter_vs_card", "arch": LM_ARCH,
          "train": {"batch": tokens_shape, **train_line,
                    "card_tracker_peak_gb": card.peak_bytes / 1e9,
                    "card_max_memory_allocated_gb": card_peak / 1e9,
                    "card_tracker_gap": card.peak_bytes / card_peak - 1},
          "prefill": {"shape": PREFILL_SHAPE, **prefill_line},
          "meta_seconds": meta_s})

    # (c) the roofline of the step: meta's count (the plain attention),
    # one card, against phase 13's measured median step
    B, S = tokens_shape[0], tokens_shape[1] - 1
    model_flops = 6.0 * cfg.active_param_count() * B * S
    rl = roofline_terms(meta.flops, meta.bytes, meta.collectives(), 1,
                        model_flops=model_flops)
    # the card's own count leaves the kernels' work out, so its bound is
    # one the measured step cannot beat
    rl_card = roofline_terms(card.flops, card.bytes, card.collectives(), 1)
    step_s = lm["step_ms_median_2_11"] / 1e3
    shares = {"roofline_fraction": rl["roofline_fraction"],
              "mfu": model_flops / (step_s * PEAK_FLOPS),
              "useful_flop_frac": rl["useful_flop_frac"],
              "card_ops_bound_share_of_step":
                  rl_card["bound_seconds"] / step_s}
    measured = lm["peak_memory_gb"]
    line = {"phase": "roofline_card", "arch": LM_ARCH, "batch": B,
            "seq": S, "model_flops": model_flops,
            "counted_flops": meta.flops, "counted_bytes": meta.bytes,
            "attention_plain_flops": meta.flops_by_scope["attention"],
            "dominant": rl["dominant"], "bound_seconds": rl["bound_seconds"],
            "t_compute": rl["t_compute"], "t_memory": rl["t_memory"],
            "bound_over_step": rl["bound_seconds"] / step_s,
            "card_ops_bound_seconds": rl_card["bound_seconds"],
            "card_ops_dominant": rl_card["dominant"],
            "step_seconds_phase13": step_s, **shares,
            "predicted_peak_gb": meta.peak_bytes / 1e9,
            "measured_peak_gb_phase13": measured,
            "peak_gap": meta.peak_bytes / 1e9 / measured - 1}
    emit(line)
    bad = {k: v for k, v in shares.items() if v > SHARE_MAX}
    if bad:
        raise AssertionError(f"roofline shares above {SHARE_MAX}: {bad}")
    return line


def load_example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_train_lm(log) -> dict:
    """``torch_train_lm`` for 60 steps on the card, then resumed to 70."""
    import io
    import math

    from repro_torch.kernels import cuda_build

    mod = load_example("torch_train_lm")
    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as ckpt:
        argv = ["--device", "cuda", "--ckpt-dir", ckpt]
        t0 = time.perf_counter()
        cuda_build.reset_launches()
        with contextlib.redirect_stdout(buf):
            first = mod.main(argv + ["--steps", str(EXAMPLE_STEPS)])
        first_launches = dict(cuda_build.launches)
        first_s = time.perf_counter() - t0
        cuda_build.reset_launches()
        with contextlib.redirect_stdout(buf):
            again = mod.main(argv + ["--steps", str(EXAMPLE_RESUME_STEPS)])
        again_launches = dict(cuda_build.launches)
    log("--- torch_train_lm ---\n" + buf.getvalue())
    hist = first["history"]
    losses = [h["loss"] for h in hist + again["history"]]
    if not all(math.isfinite(x) for x in losses) \
            or not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"torch_train_lm losses {losses}")
    if first["start"] != 0 or again["start"] != EXAMPLE_STEPS \
            or again["history"][-1]["step"] != EXAMPLE_RESUME_STEPS - 1:
        raise AssertionError(f"torch_train_lm started at {first['start']}, "
                             f"resumed at {again['start']}")
    per_step = {}
    for launched, steps in ((first_launches, EXAMPLE_STEPS),
                            (again_launches,
                             EXAMPLE_RESUME_STEPS - EXAMPLE_STEPS)):
        for n in ("flash_attention_wgmma", "flash_attention_bwd_wgmma"):
            if launched.get(n, 0) != first["layers"] * steps:
                raise AssertionError(f"torch_train_lm launched {launched} "
                                     f"in {steps} steps; want {n} = "
                                     f"{first['layers']} a step")
            per_step[n] = launched[n] / steps
    line = {"phase": "example_train_lm", "params": first["params"],
            "layers": first["layers"], "steps": EXAMPLE_STEPS,
            "resumed_from": again["start"],
            "losses": {h["step"]: h["loss"] for h in
                       hist + again["history"]},
            "ms_a_step_logged": [1e3 * h["dt"] for h in hist],
            "launches": first_launches, "launches_resumed": again_launches,
            "launches_a_step": per_step, "seconds": first_s}
    emit(line)
    return line


def example_serve_recsys(log) -> dict:
    """``torch_serve_recsys`` on the card: no kernel on its path."""
    import io

    import numpy as np

    from repro_torch.kernels import cuda_build

    mod = load_example("torch_serve_recsys")
    buf = io.StringIO()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main(["--device", "cuda"])
    secs = time.perf_counter() - t0
    log("--- torch_serve_recsys ---\n" + buf.getvalue())
    losses = out["losses"]
    ids = out["top_ids"]
    if not np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.3:
        raise AssertionError(f"torch_serve_recsys: CE {losses[:3]} … "
                             f"{losses[-3:]} did not fall")
    if not ids.is_cuda or int(ids.min()) < 0 \
            or int(ids.max()) >= out["vocab"] or ids.shape[1] != 10:
        raise AssertionError(f"torch_serve_recsys ids {ids}")
    if sum(cuda_build.launches.values()):
        raise AssertionError(f"torch_serve_recsys launched "
                             f"{dict(cuda_build.launches)}")
    line = {"phase": "example_serve_recsys", "ce_first": losses[0],
            "ce_last": losses[-1], "ms_per_batch": out["ms_per_batch"],
            "seconds": secs}
    emit(line)
    return line


def example_quickstart(log) -> dict:
    """``torch_quickstart`` on the card (slab engines: no kernel)."""
    import io

    import torch

    from repro_torch.core import DeviceGraph, bfs, rmat_graph
    from repro_torch.core.cache_model import (CacheConfig,
                                              simulate_pagerank_variant)
    from repro_torch.kernels import cuda_build

    mod = load_example("torch_quickstart")
    buf = io.StringIO()
    cuda_build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main(["--device", "cuda"])
    secs = time.perf_counter() - t0
    launched = dict(cuda_build.launches)
    log("--- torch_quickstart ---\n" + buf.getvalue())
    if sum(launched.values()):
        raise AssertionError(f"torch_quickstart launched {launched}")
    pr = out["pagerank"]
    base = pr["base"]
    l1 = {}
    for variant, got in pr.items():
        l1[variant] = float((got["rank"] - base["rank"]).abs().sum())
        if l1[variant] > PR_L1_TOL \
                or abs(got["iters"] - base["iters"]) > QUICKSTART_ITERS:
            raise AssertionError(f"quickstart PR {variant}: {got['iters']} "
                                 f"iterations (base {base['iters']}), L1 "
                                 f"{l1[variant]}")
    g = rmat_graph(scale=14, edge_factor=8, seed=7, weights=True)
    flat, *_ = bfs(DeviceGraph.from_host(g, device="cuda"), None, 0)
    if not torch.equal(flat, out["bfs"]["depth"]):
        raise AssertionError("quickstart BFS: depths differ from the flat "
                             "path's")
    cfg = CacheConfig(capacity_bytes=16 * 1024)
    for v, got in out["cache"].items():
        r = simulate_pagerank_variant(g, v, cfg, block_size=2048)
        if got != {k: r[k] for k in got}:
            raise AssertionError(f"quickstart cache model {v}: {got} vs "
                                 f"{r}")
    line = {"phase": "example_quickstart",
            "pagerank_iters": {v: r["iters"] for v, r in pr.items()},
            "pagerank_l1_vs_base": l1, "bfs": {
                k: out["bfs"][k] for k in ("levels", "push", "pull",
                                           "reached")},
            "cache": out["cache"], "seconds": secs}
    emit(line)
    return line


def phase_dryrun_and_examples(seed: int, log, records: list,
                              lm: dict) -> dict:
    """Phase 16: (a) the dry-run, (b) the counter against the card, (c)
    the roofline on the card, (d) the three examples.  Rows 4 and 7 of
    the ``kernels`` record gain (d)'s ``torch_train_lm`` launches."""
    import torch

    t0 = time.perf_counter()
    phase_dryrun(log)
    phase_counter_vs_card(seed, lm, log)
    torch.cuda.empty_cache()
    train = example_train_lm(log)
    torch.cuda.empty_cache()
    example_serve_recsys(log)
    example_quickstart(log)
    torch.cuda.empty_cache()
    for row in records:
        name = {"flash_attention": "flash_attention_wgmma",
                "flash_attention_bwd": "flash_attention_bwd_wgmma"}.get(
            row["name"])
        if name is not None:
            row["launches_examples"] = train["launches"].get(name, 0)
            row["examples_steps"] = EXAMPLE_STEPS
    secs = time.perf_counter() - t0
    emit({"phase": "dryrun_and_examples_seconds", "seconds": secs})
    return {"seconds": secs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log", type=Path, default=None,
                    help="append per-case detail to this file")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
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
    from repro_torch.resilience import chaos

    if chaos.enabled():
        print("chip_smoke: rate-based fault injection is armed "
              "(REPRO_CHAOS); the script injects its own faults only",
              file=sys.stderr)
        return 4

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

    quiet = resilience_total()
    phase_kernels(SEED, log)
    phase_spmm_kernel(SEED, log)
    phase_attention_kernels(SEED, log)
    bwd_row = phase_attention_backward(SEED, log)
    main_state = phase_main(SCALE, SEED, log)
    quiet = check_quiet("phase 4", quiet)
    records = phase_timing(main_state, log, floors, previous)
    phase_traversal(main_state, SEED, log)
    quiet = check_quiet("phase 9", quiet)
    phase_ablation(main_state, log)
    quiet = check_quiet("phase 11", quiet)
    phase_ladder(main_state, SEED, log)
    del main_state
    torch.cuda.empty_cache()
    quiet = resilience_total()
    phase_tuner(SEED, log)
    quiet = check_quiet("phase 10(b)", quiet)
    lm = phase_lm(SEED, log)
    quiet = check_quiet("phase 6", quiet)
    phase_serve_retry(lm, SEED, log)
    torch.cuda.empty_cache()
    quiet = resilience_total()
    records += attention_timing(lm, SEED, log)
    records += phase_embedding_bag(SEED, log, eb_probes, eb_previous)
    b4 = phase_bert4rec(SEED, log)
    quiet = check_quiet("phase 8", quiet)
    phase_score_retry(b4)
    del b4
    torch.cuda.empty_cache()
    t_moe = time.perf_counter()
    quiet = resilience_total()
    granite = phase_moe_granite(SEED, log)
    quiet = check_quiet("phase 12(a)", quiet)
    phase_serve_retry(granite, SEED, log)
    torch.cuda.empty_cache()
    quiet = resilience_total()
    mixtral = phase_moe_mixtral(SEED, log)
    check_quiet("phase 12(b)", quiet)
    add_moe_launches(records, [granite["line"], mixtral["line"]])
    emit({"phase": "moe_seconds", "seconds": time.perf_counter() - t_moe})
    del granite, mixtral
    torch.cuda.empty_cache()
    quiet = resilience_total()
    training = phase_training(SEED, log, bwd_row)
    check_quiet("phase 13", quiet)
    records.append(bwd_row)
    torch.cuda.empty_cache()
    quiet = resilience_total()
    phase_distribution(SEED, log, records)
    check_quiet("phase 14", quiet)
    torch.cuda.empty_cache()
    quiet = resilience_total()
    phase_model_parallel(SEED, log, records)
    check_quiet("phase 15", quiet)
    torch.cuda.empty_cache()
    quiet = resilience_total()
    phase_dryrun_and_examples(SEED, log, records, training["lm"])
    check_quiet("phase 16", quiet)
    emit({"phase": "elapsed", "seconds": time.perf_counter() - t_start})
    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
