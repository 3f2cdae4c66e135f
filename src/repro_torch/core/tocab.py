"""TOCAB execution engines (paper §3.1 phases 2+3) and baselines.

Three engines, plain PyTorch ops (the hand-written CUDA kernels of the fused
pipeline live in :mod:`repro_torch.kernels.tocab_fused`):

* :func:`baseline_pull` / :func:`baseline_push` — flat edge-centric
  segment-reduce over the *global* vertex arrays.  This is the paper's
  "Base" configuration: random reads of ``values[src]`` span all of memory.
* :func:`cb_pull` — conventional cache blocking (paper's "CB" bar):
  edges are processed block-by-block but partials are written at *global*
  width (no local-ID compaction).
* :func:`tocab_pull` / :func:`tocab_push` — the paper's contribution:
  blocked gather confined to a cache-sized window + dense compacted
  partials + a separate reduction phase (``impl="slab"``), or the fused
  kernels that fold each block straight into the output (``impl="fused"``).
  ``schedule="balanced"`` runs the slab phases per sparsity bin
  (:mod:`repro_torch.core.balance`).

All engines support ``sum`` / ``min`` / ``max`` semirings.  Padded index
entries (``id_map`` = n, ``edge_perm`` = m) read 0, as the reference's
``mode="fill"`` gathers do, and land in a scratch segment that is sliced
off, as its dropped segment ``n`` does.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.obs.metrics import registry as _obs
from repro_torch.obs.trace import synchronize
from repro_torch.resilience import chaos, degrade
from .graph import DeviceGraph
from .partition import REDUCE_IDENTITY, BlockedGraph

__all__ = [
    "segment_reduce",
    "resolve_schedule",
    "resolve_impl",
    "baseline_pull",
    "baseline_push",
    "cb_pull",
    "tocab_pull",
    "tocab_push",
    "tocab_pull_partials",
    "tocab_edge_reduce",
    "blocked_edge_values",
    "tocab_gather_src",
    "reduce_partials",
    "timed",
]

_SCATTER_REDUCE = {"min": "amin", "max": "amax"}


def _record_engine(engine: str, direction: str, blocks: int, edges: int):
    """Per-call telemetry of static facts (the reference records the same
    series once per trace)."""
    _obs.counter(
        "tocab.engine_traces", "engine (re)traces by name/direction"
    ).inc(engine=engine, direction=direction)
    _obs.gauge("tocab.blocks", "subgraphs per blocked engine trace").set(
        blocks, engine=engine)
    _obs.gauge("tocab.edges", "edges per engine trace").set(
        edges, engine=engine)


def timed(engine_fn, graph, *args, engine: str = None, **kw):
    """Synchronously run one engine call, recording wall time and edges/s.

    ``graph`` is the DeviceGraph / BlockedGraph first argument; edges come
    from its ``m``.  The engine may return a tensor or tuples / dicts of
    them (e.g. ``(rank, iters)``); the clock stops after the card has
    finished every one.  Returns the result."""
    name = engine or getattr(engine_fn, "__name__", "engine")
    t0 = time.perf_counter()
    out = synchronize(engine_fn(graph, *args, **kw))
    dt = time.perf_counter() - t0
    _obs.histogram("tocab.call_seconds", "engine wall time").observe(
        dt, engine=name)
    _obs.gauge("tocab.edges_per_s", "engine throughput").set(
        graph.m / max(dt, 1e-12), engine=name)
    return out


def _check_reduce(reduce: str):
    if reduce not in REDUCE_IDENTITY:
        raise ValueError(f"unknown reduce {reduce!r}")


def segment_reduce(vals: torch.Tensor, ids: torch.Tensor, num_segments: int,
                   reduce: str, sorted_ids: bool = False) -> torch.Tensor:
    """out[s] = ⊕ vals[ids == s] along dim 0; empty segments hold the
    semiring identity (0, +inf, -inf), as ``jax.ops.segment_*`` give.
    ``sorted_ids`` is accepted for parity; torch's scatters take no hint."""
    del sorted_ids
    _check_reduce(reduce)
    tail = vals.shape[1:]
    out = torch.full((num_segments,) + tail, REDUCE_IDENTITY[reduce],
                     dtype=vals.dtype, device=vals.device)
    ids = ids.long()
    if reduce == "sum":
        return out.index_add_(0, ids, vals)
    idx = ids.view((-1,) + (1,) * len(tail)).expand_as(vals)
    return out.scatter_reduce_(0, idx, vals, reduce=_SCATTER_REDUCE[reduce])


def _bcast(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.view(t.shape + (1,) * (ndim - t.ndim))


def _take_fill(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[idx]`` along dim 0 with out-of-range rows reading 0 (the
    reference's ``jnp.take(..., mode="fill", fill_value=0)``)."""
    n = values.shape[0]
    idx = idx.long()
    ok = (idx >= 0) & (idx < n)
    out = values[idx.clamp(0, max(n - 1, 0))]
    return torch.where(_bcast(ok, out.ndim), out, 0)


def _edge_messages(values, src_ids, edge_vals, mask, reduce, combine):
    """Gather per-edge messages and neutralize padding with the identity
    (``mask=None``: every slot is a real edge)."""
    msgs = _take_fill(values, src_ids)
    if edge_vals is not None:
        edge_vals = _bcast(edge_vals, msgs.ndim)
    if combine is not None:
        msgs = combine(msgs, edge_vals)
    elif edge_vals is not None:
        msgs = msgs * edge_vals
    if mask is None:
        return msgs
    return torch.where(_bcast(mask, msgs.ndim), msgs, REDUCE_IDENTITY[reduce])


def _require_direction(bg: BlockedGraph, direction: str):
    if bg.direction != direction:
        raise ValueError(
            f"needs a {direction!r} layout, got direction={bg.direction!r}")


# ====================================================================== #
# Baseline (flat, non-blocked) engines
# ====================================================================== #
def baseline_pull(
    dg: DeviceGraph,
    values: torch.Tensor,
    reduce: str = "sum",
    combine: Optional[Callable] = None,
):
    """out[dst] = ⊕_{(src,dst)∈E} values[src] (⊗ edge_val).

    Flat segment reduce by destination — the unblocked reference (random
    reads of ``values`` span the full array)."""
    _record_engine("baseline_pull", "pull", 1, dg.m)
    msgs = _edge_messages(values, dg.src, dg.vals, None, reduce, combine)
    return segment_reduce(msgs, dg.dst, dg.n, reduce)


def baseline_push(
    dg: DeviceGraph,
    values: torch.Tensor,
    reduce: str = "sum",
    combine: Optional[Callable] = None,
):
    """Push direction: scatter values[src] to every out-neighbour (the same
    flat reduction with the read side sequential: edges are src-sorted)."""
    _record_engine("baseline_push", "push", 1, dg.m)
    msgs = _edge_messages(values, dg.src, dg.vals, None, reduce, combine)
    return segment_reduce(msgs, dg.dst, dg.n, reduce)


# ====================================================================== #
# Conventional cache blocking (no compaction) — the paper's CB strawman
# ====================================================================== #
def cb_pull(
    bg: BlockedGraph,
    values: torch.Tensor,
    reduce: str = "sum",
    combine: Optional[Callable] = None,
):
    """Column blocking only: gathers are window-confined but every block
    writes partials at global width (one reduction keyed by the global
    destination of each edge)."""
    _require_direction(bg, "pull")
    _record_engine("cb_pull", "pull", bg.num_blocks, bg.m)
    src_global = bg.window_idx + bg.window_lo()[:, None]
    msgs = _edge_messages(values, src_global, bg.edge_vals, bg.edge_mask,
                          reduce, combine)
    return _reduce_to_compact_side(bg, msgs, reduce)


def _reduce_to_compact_side(bg: BlockedGraph, msgs: torch.Tensor,
                            reduce: str) -> torch.Tensor:
    """out[id_map[b, compact_idx[b, s]]] = ⊕ msgs[b, s] over real slots: one
    reduction keyed by each edge's global compact-side vertex (padding goes
    to the scratch segment n)."""
    dst_global = torch.gather(bg.id_map, 1, bg.compact_idx.long())
    dst_global = torch.where(bg.edge_mask, dst_global, bg.n)
    tail = msgs.shape[2:]
    return segment_reduce(msgs.reshape((-1,) + tail), dst_global.reshape(-1),
                          bg.n + 1, reduce)[:-1]


# ====================================================================== #
# TOCAB — blocked + compacted (the paper's contribution)
# ====================================================================== #
def tocab_pull_partials(
    bg: BlockedGraph,
    values: torch.Tensor,
    reduce: str = "sum",
    combine: Optional[Callable] = None,
):
    """Phase 2 (subgraph processing, Alg. 4): per-block dense partial slabs.

    Returns ``partials`` of shape (num_blocks, local_budget, *value_tail).
    Gathers hit only the block's contiguous source window; scatters hit only
    the dense local partial slab."""
    _require_direction(bg, "pull")
    src_global = bg.window_idx + bg.window_lo()[:, None]
    msgs = _edge_messages(values, src_global, bg.edge_vals, bg.edge_mask,
                          reduce, combine)
    flat_idx = bg.compact_idx + torch.arange(
        bg.num_blocks, dtype=torch.int32,
        device=bg.device)[:, None] * bg.local_budget
    tail = msgs.shape[2:]
    partials = segment_reduce(msgs.reshape((-1,) + tail),
                              flat_idx.reshape(-1), bg.flat_partial_size,
                              reduce)
    return partials.reshape((bg.num_blocks, bg.local_budget) + tail)


def reduce_partials(bg: BlockedGraph, partials: torch.Tensor,
                    reduce: str = "sum"):
    """Phase 3 (accumulation, paper Fig. 5): merge dense per-block partials
    into the global result — one flat segment reduce keyed by ``id_map``."""
    tail = partials.shape[2:]
    out = segment_reduce(
        partials.reshape((-1,) + tail),
        bg.id_map.reshape(-1),
        bg.n + 1,  # padded id_map entries point at segment n → dropped
        reduce,
    )
    return out[:-1]


def resolve_schedule(bg, schedule: str, workload: str = "spmv") -> str:
    """``"auto"`` → the tuned plan's schedule for this graph (the
    :mod:`repro_torch.tune` DB, keyed by the layout's build-time
    fingerprint and its device), anything else passes through."""
    if schedule != "auto":
        return schedule
    from repro_torch.tune.plan import resolve_schedule as _resolve

    return _resolve(bg, workload=workload)


def resolve_impl(bg, impl: str, workload: str = "spmv") -> str:
    """``"auto"`` → the tuned plan's implementation (``"slab"`` or
    ``"fused"``) for this graph, anything else passes through."""
    if impl != "auto":
        return impl
    from repro_torch.tune.plan import resolve_impl as _resolve

    return _resolve(bg, workload=workload)


def _reconcile_fused(schedule: str, impl: str,
                     schedule_arg: str, impl_arg: str):
    """``fused`` × ``balanced`` is not a valid pairing — the fused pipeline
    runs every block through one kernel (its bin awareness is a visit
    *order*, not per-bin strategies).  Whichever side the tuner picked
    (``"auto"``) yields; an explicit conflict is an error."""
    if impl == "fused" and schedule == "balanced":
        if impl_arg == "auto":
            return schedule, "slab"
        if schedule_arg == "auto":
            return "uniform", impl
        raise ValueError(
            "impl='fused' is incompatible with schedule='balanced' — use "
            "schedule='uniform' (or 'auto') with the fused pipeline")
    return schedule, impl


def _resolve(obj, schedule: str, impl: str, workload: str):
    """Concrete ``(schedule, impl)`` for one engine call: ``"auto"``
    resolved from the tuning DB, fused × balanced reconciled, both
    checked."""
    rs = resolve_schedule(obj, schedule, workload=workload)
    ri = resolve_impl(obj, impl, workload=workload)
    rs, ri = _reconcile_fused(rs, ri, schedule, impl)
    if rs not in ("uniform", "balanced"):
        raise ValueError(f"unknown schedule {rs!r}")
    if ri not in degrade.LADDER:
        raise ValueError(f"unknown impl {ri!r}; expected one of "
                         f"{degrade.LADDER}")
    return rs, ri


def _guarded(site: str, thunk):
    """``thunk`` behind the chaos site ``site``, checked before it runs."""

    def run():
        chaos.maybe_raise(site)
        return thunk()

    return run


def _ladder_dispatch(engine: str, bg, ri: str, allow: bool, fused_thunk,
                     slab_thunk, reference_thunk):
    """Degradation-ladder dispatch for one engine call (see
    :mod:`repro_torch.resilience.degrade`).  ``engine`` is the dispatch-site
    label (``tocab_pull``/``tocab_push``/``tocab_edge_reduce``);
    fingerprint-keyed verdicts make the fallback a once-per-(graph,
    engine) decision, not a per-iteration one.  Without ``allow`` the
    requested rung runs alone and its failure propagates.  The fused rung
    checks the chaos site ``kernel.tocab_fused``; the slab rung checks
    ``kernel.tocab_slab`` only when the ladder is armed."""
    if ri == "reference":
        return reference_thunk()
    rungs = [("slab", _guarded("kernel.tocab_slab", slab_thunk)
              if allow else slab_thunk), ("reference", reference_thunk)]
    if ri == "fused":
        rungs.insert(0, ("fused", _guarded("kernel.tocab_fused",
                                           fused_thunk)))
    if not allow:
        return rungs[0][1]()
    return degrade.dispatch(engine, bg.fingerprint, rungs,
                            allow_fallback=True)


def _prepare(site: str, bg, schedule: str, impl: str, allow_fallback,
             device):
    """(schedule, impl, allow) for one ``tocab_*`` call on ``device``:
    resolved, and started at a memoized verdict when the ladder is armed
    (:func:`repro_torch.resilience.degrade.fallback_allowed`: CPU only)."""
    rs, ri = _resolve(bg, schedule, impl, "spmv")
    allow = degrade.fallback_allowed(allow_fallback, device)
    if allow:
        ri = degrade.apply_verdict(bg.fingerprint, site, ri)
    return rs, ri, allow


def _slab_epilogue(out, reduce: str, epilogue):
    """Per-vertex apply step on the slab path: the affine expression the
    fused kernels apply after their last block."""
    if epilogue is None:
        return out
    if reduce != "sum":
        raise ValueError(
            f"epilogue fusion is affine (out*mul+add) — only the sum "
            f"semiring supports it, got reduce={reduce!r}")
    mul, add = epilogue
    return out * mul + add


def tocab_pull(
    bg: BlockedGraph,
    values: torch.Tensor,
    reduce: str = "sum",
    combine: Optional[Callable] = None,
    schedule: str = "uniform",
    dense_impl: Optional[str] = None,
    impl: str = "slab",
    epilogue=None,
    allow_fallback: Optional[bool] = None,
):
    """Blocked pull.  ``impl='slab'`` runs phase 2 (partial slab) and phase
    3 (its reduction) as torch ops; ``impl='fused'`` runs the fused
    pipeline (:func:`repro_torch.kernels.tocab_fused.fused_pull`: the
    hand-written CUDA kernel for a tensor on the card), which never
    materializes the slab.  ``schedule='balanced'`` (slab only) runs each
    sparsity bin of the build-time schedule on its own strategy
    (:func:`repro_torch.core.balance.balanced_pull`); ``dense_impl`` picks
    the dense bin's (``'cuda'``: the ``tocab_spmm`` kernel, the default for
    tensors on the card; ``'onehot'``: torch ops, the default on the CPU).
    ``epilogue=(mul, add)`` applies ``out*mul + add`` (sum semiring
    only).  ``schedule='auto'`` / ``impl='auto'`` resolve from the
    :mod:`repro_torch.tune` DB (uniform slab for a graph never tuned).
    ``impl='reference'`` runs the uniform slab dataflow, the ladder's last
    rung.

    ``allow_fallback=True`` arms the fused → slab → reference ladder
    (:mod:`repro_torch.resilience.degrade`) and the dense bin's cuda →
    onehot rung for values on the CPU; on the card, and with anything but
    ``True`` (``None``, the default, included), it stays off and a failure
    raises."""
    rs, ri, allow = _prepare("tocab_pull", bg, schedule, impl,
                             allow_fallback, values.device)

    def _fused():
        from repro_torch.kernels.tocab_fused import fused_pull

        _record_engine("tocab_pull_fused", "pull", bg.num_blocks, bg.m)
        return fused_pull(bg, values, reduce, combine, epilogue)

    def _uniform(engine: str):
        _record_engine(engine, "pull", bg.num_blocks, bg.m)
        partials = tocab_pull_partials(bg, values, reduce, combine)
        return _slab_epilogue(reduce_partials(bg, partials, reduce),
                              reduce, epilogue)

    def _slab():
        if rs != "balanced":
            return _uniform("tocab_pull")
        from .balance import balanced_pull

        return _slab_epilogue(
            balanced_pull(bg, values, reduce, combine, dense_impl=dense_impl,
                          allow_fallback=allow), reduce, epilogue)

    return _ladder_dispatch("tocab_pull", bg, ri, allow, _fused, _slab,
                            lambda: _uniform("tocab_pull_reference"))


def _push_messages(values, id_map, compact_idx, edge_vals, edge_mask,
                   reduce, combine):
    """Per-edge push messages of a set of blocks: gather each block's
    distinct sources once (``block_contrib``), fan out per edge by
    ``compact_idx``, weight, and neutralize padding with the identity."""
    block_contrib = _take_fill(values, id_map)  # (k, lb, *tail)
    tail = values.shape[1:]
    idx = _bcast(compact_idx.long(), 2 + len(tail)).expand(
        compact_idx.shape + tail)
    msgs = torch.gather(block_contrib, 1, idx)
    ev = edge_vals
    if ev is not None:
        ev = _bcast(ev, msgs.ndim)
    if combine is not None:
        msgs = combine(msgs, ev)
    elif ev is not None:
        msgs = msgs * ev
    return torch.where(_bcast(edge_mask, msgs.ndim), msgs,
                       REDUCE_IDENTITY[reduce])


def _push_windows(
    bg: BlockedGraph,
    values: torch.Tensor,
    reduce: str = "sum",
    combine: Optional[Callable] = None,
):
    """Uniform push body: every block's messages scattered into its
    disjoint destination window."""
    _require_direction(bg, "push")
    msgs = _push_messages(values, bg.id_map, bg.compact_idx, bg.edge_vals,
                          bg.edge_mask, reduce, combine)
    dst_global = bg.window_idx + bg.window_lo()[:, None]
    dst_global = torch.where(bg.edge_mask, dst_global, bg.n)
    out = segment_reduce(msgs.reshape((-1,) + values.shape[1:]),
                         dst_global.reshape(-1), bg.n + 1, reduce)
    return out[:-1]


def tocab_push(
    bg: BlockedGraph,
    values: torch.Tensor,
    reduce: str = "sum",
    combine: Optional[Callable] = None,
    schedule: str = "uniform",
    impl: str = "slab",
    epilogue=None,
    allow_fallback: Optional[bool] = None,
):
    """Push (Alg. 5): block by destination range; contributions of the few
    distinct sources of a block are fetched *once* through ``id_map``, then
    fanned out per edge; accumulation is confined to the block's
    destination window.  ``schedule``, ``impl``, ``epilogue`` and
    ``allow_fallback`` as in :func:`tocab_pull`."""
    rs, ri, allow = _prepare("tocab_push", bg, schedule, impl,
                             allow_fallback, values.device)

    def _fused():
        from repro_torch.kernels.tocab_fused import fused_push

        _record_engine("tocab_push_fused", "push", bg.num_blocks, bg.m)
        return fused_push(bg, values, reduce, combine, epilogue)

    def _uniform(engine: str):
        _record_engine(engine, "push", bg.num_blocks, bg.m)
        return _slab_epilogue(_push_windows(bg, values, reduce, combine),
                              reduce, epilogue)

    def _slab():
        if rs != "balanced":
            return _uniform("tocab_push")
        from .balance import balanced_push

        return _slab_epilogue(balanced_push(bg, values, reduce, combine),
                              reduce, epilogue)

    return _ladder_dispatch("tocab_push", bg, ri, allow, _fused, _slab,
                            lambda: _uniform("tocab_push_reference"))


# ====================================================================== #
# Dynamic per-edge values (GNN support): flat edge arrays → blocked slabs
# ====================================================================== #
def blocked_edge_values(bg: BlockedGraph,
                        flat_vals: torch.Tensor) -> torch.Tensor:
    """Scatter flat per-edge values (original edge order) into the TOCAB
    blocked slab layout via ``edge_perm``.  Padded slots read 0."""
    return _take_fill(flat_vals, bg.edge_perm)


def _edge_reduce_uniform(bg: BlockedGraph, flat_edge_vals, reduce: str):
    vals = blocked_edge_values(bg, flat_edge_vals)
    vals = torch.where(_bcast(bg.edge_mask, vals.ndim), vals,
                       REDUCE_IDENTITY[reduce])
    flat_idx = bg.compact_idx + torch.arange(
        bg.num_blocks, dtype=torch.int32,
        device=bg.device)[:, None] * bg.local_budget
    tail = vals.shape[2:]
    partials = segment_reduce(vals.reshape((-1,) + tail),
                              flat_idx.reshape(-1), bg.flat_partial_size,
                              reduce)
    partials = partials.reshape((bg.num_blocks, bg.local_budget) + tail)
    return reduce_partials(bg, partials, reduce)


def tocab_edge_reduce(
    bg: BlockedGraph,
    flat_edge_vals: torch.Tensor,  # (m, ...) in original edge order
    reduce: str = "sum",
    schedule: str = "uniform",
    impl: str = "slab",
    epilogue=None,
    allow_fallback: Optional[bool] = None,
):
    """Reduce *edge* values to the compacted side (dst for pull layout)
    through the partial-slab + reduction machinery — the GNN primitive
    (edge messages → node aggregate) in TOCAB form.  ``schedule``,
    ``impl``, ``epilogue`` and ``allow_fallback`` as in
    :func:`tocab_pull`."""
    rs, ri, allow = _prepare("tocab_edge_reduce", bg, schedule, impl,
                             allow_fallback, flat_edge_vals.device)

    def _fused():
        from repro_torch.kernels.tocab_fused import fused_edge_reduce

        _record_engine("tocab_edge_reduce_fused", bg.direction,
                       bg.num_blocks, bg.m)
        return fused_edge_reduce(bg, flat_edge_vals, reduce, epilogue)

    def _slab():
        if rs == "balanced":
            from .balance import balanced_edge_reduce

            out = balanced_edge_reduce(bg, flat_edge_vals, reduce)
        else:
            out = _edge_reduce_uniform(bg, flat_edge_vals, reduce)
        return _slab_epilogue(out, reduce, epilogue)

    def _reference():
        _record_engine("tocab_edge_reduce_reference", bg.direction,
                       bg.num_blocks, bg.m)
        return _slab_epilogue(_edge_reduce_uniform(bg, flat_edge_vals,
                                                   reduce), reduce, epilogue)

    return _ladder_dispatch("tocab_edge_reduce", bg, ri, allow, _fused,
                            _slab, _reference)


def tocab_gather_src(bg: BlockedGraph, values: torch.Tensor) -> torch.Tensor:
    """Per-edge gather of source-side values in *original edge order* —
    window-confined reads, then permuted back via ``edge_perm``."""
    _require_direction(bg, "pull")
    src_global = bg.window_idx + bg.window_lo()[:, None]
    gathered = values[src_global[bg.edge_mask].long()]
    out = torch.zeros((bg.m,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    out[bg.edge_perm[bg.edge_mask].long()] = gathered
    return out
