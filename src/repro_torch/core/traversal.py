"""Traversal-based algorithms: BFS, Betweenness Centrality, SSSP and
connected components (paper §3.3).

Partial-active algorithms keep a changing frontier, held as a **status
array** (topology-driven), as the paper argues for GPUs: the next frontier
rides the same engines as PageRank's sums.

Direction optimization (Beamer): iterations with a sparse frontier run in
**push**, GAP's top-down step: only the frontier's ``m_f`` out-edges are
expanded and their heads marked (``_frontier_push``), never all m;
dense-frontier iterations run in **pull**, and only those go through TOCAB
(``tocab_pull``: the fused kernel under ``impl="fused"``, the sparsity bins
under ``schedule="balanced"``).  The switch is the classic α test on the
frontier's out-edge count, ``m_f > m / alpha``, so a push level's work
(m_f + n) is always below a scan's (m + n).

The reference's ``lax.while_loop`` is a host loop here, with one
device→host read per iteration: BFS and BC read the frontier's size and
its out-edge count together, SSSP and CC their ``changed`` flag.  The loop
records its telemetry (``traversal.frontier_size``,
``traversal.frontier_edges``, ``traversal.iterations``) from those values,
so recording adds no synchronisation.  ``m_f`` is counted exactly, in
int64 (the reference sums it in fp32, which rounds past 2²⁴ edges), and
``traversal.frontier_edges_total`` sums it by direction.  A push level
reads exactly its m_f arcs, so for BFS ``tocab.edges_scanned`` of
``frontier_push`` equals the push direction's ``frontier_edges_total``.
The level's counts also size the push level's arrays, so the read is the
level's only synchronisation.

Traced (:mod:`repro_torch.obs.trace`), a traversal is a
``traversal.<algo>`` span and each level a ``traversal.level`` span with
device markers: ``level``, and ``direction`` (``push``, ``pull``, or None
for the last read, which found the frontier empty), ``frontier_size`` and
``frontier_edges`` set after the read, which is a
``traversal.frontier_read`` span of its own.

Each entry point runs on the device of the graph it is given.  Semantics
kept from the reference: BFS and BC pass ``combine=None``, so on a layout
with edge values a frontier message is multiplied by the edge's weight (an
edge of weight 0 does not carry the frontier, and BC's σ is a weighted
sum); CC's labels are fp32, exact up to 2²⁴ vertices.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.obs.metrics import registry as _obs
from repro_torch.obs.trace import span
from . import tocab
from .balance import ADD_EDGE, UNWEIGHTED
from .graph import DeviceGraph
from .partition import BlockedGraph

__all__ = ["bfs", "bc", "sssp", "connected_components", "INF_DEPTH",
           "DEFAULT_ALPHA"]

INF_DEPTH = torch.iinfo(torch.int32).max // 2

#: the paper's Beamer direction-switch threshold (m_frontier > m/α → pull)
DEFAULT_ALPHA = 15.0


def _resolve_traversal(obj, schedule: str, alpha: Optional[float],
                       impl: str):
    """Concrete ``(schedule, alpha, impl)`` for one traversal, resolved
    once before the loop: ``"auto"`` from the tuning DB (workload ``bfs``;
    uniform slab for a graph never tuned), fused × balanced reconciled as
    in ``tocab_pull``.  ``alpha=None`` is the tuned α under
    ``schedule="auto"`` and the paper's 15 otherwise."""
    want_auto = schedule == "auto"
    schedule, impl = tocab._resolve(obj, schedule, impl, "bfs")
    if alpha is None:
        if want_auto:
            from repro_torch.tune.plan import resolve_alpha

            alpha = resolve_alpha(obj, workload="bfs")
        else:
            alpha = DEFAULT_ALPHA
    return schedule, float(alpha), impl


def _source_index(source, n: int) -> int:
    src = int(source)
    if not 0 <= src < n:
        raise ValueError(f"source {src} is not a vertex of a graph of {n}")
    return src


def _record_frontier(algo: str, size: int, edges: int, use_pull: bool):
    direction = "pull" if use_pull else "push"
    _obs.counter(
        "traversal.frontier_edges_total", "frontier out-edges by direction"
    ).inc(edges, algo=algo, direction=direction)
    _obs.histogram(
        "traversal.frontier_size", "active vertices per iteration"
    ).observe(float(size), algo=algo)
    _obs.histogram(
        "traversal.frontier_edges", "frontier out-edge volume (Beamer m_f)"
    ).observe(float(edges), algo=algo)
    _obs.counter(
        "traversal.iterations", "iterations by Beamer direction decision"
    ).inc(algo=algo, direction=direction)


def _record_iteration(algo: str):
    _obs.counter("traversal.iterations", "").inc(algo=algo, direction="pull")


#: a vertex weighs ``_COUNT`` plus its out-degree in the frontier read, so
#: one int64 sum holds the frontier's size above bit 32 and its out-edges
#: below, exactly: m < 2³¹, since ``rowptr`` is int32
_COUNT = 1 << 32


def _frontier_stats(weights: torch.Tensor, frontier: torch.Tensor):
    """(vertices on the frontier, their out-edges), exact, in one read of
    the sum of the frontier's ``weights``."""
    total = torch.where(frontier, weights, 0).sum().item()
    return total // _COUNT, total % _COUNT


def _frontier_push(dg: DeviceGraph, frontier: torch.Tensor, size: int,
                   edges: int) -> torch.Tensor:
    """reached[v] = True where an out-edge of a frontier vertex carries to
    v, reading only those ``edges`` arcs of the frontier's ``size``
    vertices (GAP's top-down step).  Both counts come from the level's
    frontier read, so every array has a size the host knows and nothing
    here waits for the device.

    The frontier's arcs are numbered 0 .. edges - 1, vertex after vertex;
    a binary search in the running sum of their degrees finds each arc's
    vertex, whose run of the src-sorted arc list (``rowptr``) gives the
    arc's position: one thread an arc, whatever the degrees.  Indices are
    clamped, so a frontier that disagrees with its counts gives a wrong
    answer, never a read out of range.  On a layout with edge values an
    arc carries where its value is > 0 (a frontier message times the
    edge's value, as the pull engines form it); the others mark a scratch
    slot n."""
    tocab._record_engine("frontier_push", "push", 1, edges)
    n = dg.n
    reached = torch.zeros(n + 1, dtype=torch.bool, device=frontier.device)
    if edges == 0:  # frontier vertices without out-edges
        return reached[:n]
    ids = torch.nonzero_static(frontier, size=size, fill_value=0).view(-1)
    deg = dg.out_degree.take(ids)
    end = deg.cumsum(0)  # where each vertex's arcs end in the numbering
    arc = torch.arange(edges, device=frontier.device)
    owner = torch.searchsorted(end, arc, right=True).clamp_max_(size - 1)
    # arc a of frontier vertex i sits at rowptr[i] + a - (end[i] - deg[i])
    start = (deg - end).add_(dg.rowptr.take(ids))
    pos = start.take(owner).add_(arc).clamp_max_(dg.m - 1)
    heads = dg.dst.take(pos)
    if dg.vals is not None:
        heads = torch.where(dg.vals.take(pos) > 0, heads, n)
    return reached.index_fill_(0, heads.long(), True)[:n]


def _frontier_reach(dg: DeviceGraph, bg_pull: Optional[BlockedGraph],
                    frontier: torch.Tensor, use_pull: bool, schedule: str,
                    impl: str, size: int, edges: int) -> torch.Tensor:
    """Where the frontier reaches (bools), from its status array and the
    level's counts: TOCAB pull of the frontier as 0/1 floats in the dense
    phase (reached where the max over in-edges is > 0), the top-down
    expansion in the sparse one."""
    if not use_pull:
        return _frontier_push(dg, frontier, size, edges)
    frontier = frontier.float()
    if bg_pull is None:
        reached = tocab.baseline_pull(dg, frontier, reduce="max")
    else:
        reached = tocab.tocab_pull(bg_pull, frontier, reduce="max",
                                   schedule=schedule, impl=impl)
    return reached > 0


class _Frontier:
    """BFS state shared by :func:`bfs` and BC's forward phase: depths, the
    frontier as a status array with its last read's counts (``size``,
    ``edges``), and the direction counts."""

    def __init__(self, dg: DeviceGraph, src: int, threshold: float):
        self.dg, self.threshold = dg, threshold
        self.depth = torch.full((dg.n,), INF_DEPTH, dtype=torch.int32,
                                device=dg.device)
        self.depth[src] = 0
        self.frontier = torch.zeros(dg.n, dtype=torch.bool, device=dg.device)
        self.frontier[src] = True
        self.weights = dg.out_degree.long().add_(_COUNT)
        self.size = self.edges = 0
        self.level = self.n_push = self.n_pull = 0

    def level_span(self):
        """The span of the next level."""
        return span("traversal.level", device=self.dg.device,
                    level=self.level)

    def direction(self, algo: str, level) -> Optional[bool]:
        """Whether the next level pulls; None when the frontier is empty.
        ``level`` is the level's span."""
        with span("traversal.frontier_read") as rd:
            size, edges = rd.wait(_frontier_stats, self.weights,
                                  self.frontier)
        self.size, self.edges = size, edges
        if size == 0:
            level.set(direction=None)
            return None
        use_pull = edges > self.threshold
        level.set(direction="pull" if use_pull else "push",
                  frontier_size=size, frontier_edges=edges)
        _record_frontier(algo, size, edges, use_pull)
        if use_pull:
            self.n_pull += 1
        else:
            self.n_push += 1
        return use_pull

    def reach(self, bg_pull: Optional[BlockedGraph], use_pull: bool,
              schedule: str, impl: str) -> torch.Tensor:
        """Where the current frontier reaches (:func:`_frontier_reach`)."""
        return _frontier_reach(self.dg, bg_pull, self.frontier, use_pull,
                               schedule, impl, self.size, self.edges)

    def advance(self, reached: torch.Tensor) -> torch.Tensor:
        """Make the newly reached vertices the frontier; returns it."""
        self.frontier = reached & (self.depth >= INF_DEPTH)
        self.level += 1
        self.depth.masked_fill_(self.frontier, self.level)
        return self.frontier


def bfs(
    dg: DeviceGraph,
    bg_pull: Optional[BlockedGraph],
    source,
    max_iters: int = 0,
    alpha: Optional[float] = None,
    schedule: str = "uniform",
    impl: str = "slab",
):
    """Direction-optimizing BFS.  ``dg``/``bg_pull`` are over edges
    oriented (src→dst) = (in-neighbour → vertex), i.e. the pull layout;
    ``bg_pull=None`` runs the pull levels flat too.  ``source`` is an int
    or a 0-d tensor.  ``schedule`` / ``impl`` pick the pull levels'
    engine as in ``tocab_pull``; ``"auto"`` consults the tuning DB, and
    ``alpha=None`` takes the tuned Beamer α under ``schedule="auto"`` (the
    paper's 15 otherwise).

    Returns (depth int32[n], levels, push_iters, pull_iters), the counts as
    Python ints."""
    schedule, alpha, impl = _resolve_traversal(
        bg_pull if bg_pull is not None else dg, schedule, alpha, impl)
    src = _source_index(source, dg.n)
    state = _Frontier(dg, src, dg.m / alpha)
    max_iters = max_iters or dg.n
    with span("traversal.bfs", root=src):
        while state.level < max_iters:
            with state.level_span() as lv:
                use_pull = state.direction("bfs", lv)
                if use_pull is None:
                    break
                state.advance(state.reach(bg_pull, use_pull, schedule, impl))
    return state.depth, state.level, state.n_push, state.n_pull


def bc(
    dg: DeviceGraph,
    bg_pull: Optional[BlockedGraph],
    source,
    max_levels: int = 64,
    alpha: Optional[float] = None,
    schedule: str = "uniform",
    impl: str = "slab",
):
    """Brandes betweenness centrality from one source (paper Alg. 3 + the
    standard dependency back-propagation).  Forward phase = BFS computing
    depth δ and shortest-path counts σ; backward phase accumulates
    dependencies level by level.  Arguments as in :func:`bfs`.

    Returns (bc_scores f32[n], depth, sigma)."""
    schedule, alpha, impl = _resolve_traversal(
        bg_pull if bg_pull is not None else dg, schedule, alpha, impl)
    src = _source_index(source, dg.n)
    n = dg.n
    state = _Frontier(dg, src, dg.m / alpha)
    sigma = torch.zeros(n, dtype=torch.float32, device=dg.device)
    sigma[src] = 1.0

    # ---------------- forward: depth + sigma ---------------- #
    with span("traversal.bc", root=src):  # the forward levels
        while state.level < max_levels:
            with state.level_span() as lv:
                use_pull = state.direction("bc", lv)
                if use_pull is None:
                    break
                frontier = state.frontier
                new = state.advance(
                    state.reach(bg_pull, use_pull, schedule, impl))
                # σ[dst] += Σ σ[src] over tree edges (src on the frontier)
                path_msgs = torch.where(frontier, sigma, 0.0)
                sig_in = (
                    tocab.tocab_pull(bg_pull, path_msgs, reduce="sum",
                                     schedule=schedule, impl=impl)
                    if bg_pull is not None
                    else tocab.baseline_pull(dg, path_msgs, reduce="sum")
                )
                sigma = torch.where(new, sig_in, sigma)
    depth, levels = state.depth, state.level

    # ---------------- backward: dependency accumulation ---------------- #
    # δ(v) = Σ_{w: (v,w) tree edge} σ(v)/σ(w) · (1 + δ(w)); levels from
    # deepest-1 down to 0.  v gathers from its out-neighbours w: a flat sum
    # over each vertex's out-edges, which are the runs of the src-sorted
    # edge list (``rowptr``): one fixed order, so equal σ and depths give
    # bit-equal scores (backward frontiers are level-sparse: no blocking).
    safe_sigma = sigma.clamp(min=1e-30)
    reached = depth < INF_DEPTH
    depth_dst = depth.index_select(0, dg.dst)
    delta = torch.zeros(n, dtype=torch.float32, device=dg.device)
    for i in range(levels):
        level = levels - 1 - i
        coef = torch.where(reached, (1.0 + delta) / safe_sigma, 0.0)
        msgs = coef.index_select(0, dg.dst) * (depth_dst == level + 1)
        acc = torch.segment_reduce(msgs, "sum", offsets=dg.rowptr)
        delta = torch.where(depth == level, delta + sigma * acc, delta)
    bc_scores = torch.where(reached, delta, 0.0)
    bc_scores[src] = 0.0
    return bc_scores, depth, sigma


def sssp(
    dg: DeviceGraph,
    bg_pull: Optional[BlockedGraph],
    source,
    max_iters: int = 0,
    schedule: str = "uniform",
    impl: str = "slab",
):
    """Bellman-Ford SSSP (min-plus semiring), TOCAB pull per iteration.
    The relaxation ``d + w`` is the ``ADD_EDGE`` combine (``d + 1`` on a
    layout without edge values), which the fused kernels form on the card.

    Returns (dist f32[n], iters)."""
    schedule, _, impl = _resolve_traversal(
        bg_pull if bg_pull is not None else dg, schedule, DEFAULT_ALPHA,
        impl)
    src = _source_index(source, dg.n)
    dist = torch.full((dg.n,), float("inf"), dtype=torch.float32,
                      device=dg.device)
    dist[src] = 0.0
    max_iters = max_iters or dg.n
    changed, iters = True, 0
    with span("traversal.sssp", root=src):
        while changed and iters < max_iters:
            _record_iteration("sssp")
            with span("traversal.level", device=dg.device, level=iters,
                      direction="pull") as lv:
                relaxed = (
                    tocab.tocab_pull(bg_pull, dist, reduce="min",
                                     combine=ADD_EDGE, schedule=schedule,
                                     impl=impl)
                    if bg_pull is not None
                    else tocab.baseline_pull(dg, dist, reduce="min",
                                             combine=ADD_EDGE)
                )
                new_dist = torch.minimum(dist, relaxed)
                changed = lv.wait(bool, (new_dist < dist).any())
            dist, iters = new_dist, iters + 1
    return dist, iters


def connected_components(
    dg: DeviceGraph,
    dg_t: DeviceGraph,
    bg_pull: Optional[BlockedGraph] = None,
    max_iters: int = 0,
    schedule: str = "uniform",
    impl: str = "slab",
):
    """Weakly-connected components via min-label propagation (all-active,
    min semiring — the same blocked pull engine as SSSP), edge values
    ignored (``UNWEIGHTED``).

    ``dg_t`` is the transpose edge set (labels must flow both directions
    for *weak* connectivity); its pull is flat.  Labels are fp32 while they
    propagate, as in the reference: exact for up to 2²⁴ vertices.  Returns
    (labels int32[n], iters)."""
    schedule, _, impl = _resolve_traversal(
        bg_pull if bg_pull is not None else dg, schedule, DEFAULT_ALPHA,
        impl)
    labels = torch.arange(dg.n, dtype=torch.float32, device=dg.device)
    max_iters = max_iters or dg.n
    changed, iters = True, 0
    with span("traversal.cc"):
        while changed and iters < max_iters:
            _record_iteration("cc")
            with span("traversal.level", device=dg.device, level=iters,
                      direction="pull") as lv:
                fwd = (
                    tocab.tocab_pull(bg_pull, labels, reduce="min",
                                     combine=UNWEIGHTED, schedule=schedule,
                                     impl=impl)
                    if bg_pull is not None
                    else tocab.baseline_pull(dg, labels, reduce="min",
                                             combine=UNWEIGHTED)
                )
                bwd = tocab.baseline_pull(dg_t, labels, reduce="min",
                                          combine=UNWEIGHTED)
                new = torch.minimum(labels, torch.minimum(fwd, bwd))
                changed = lv.wait(bool, (new < labels).any())
            labels, iters = new, iters + 1
    return labels.to(torch.int32), iters
