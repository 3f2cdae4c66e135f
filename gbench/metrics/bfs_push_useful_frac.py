"""bfs_push_useful_frac: the frontier's out-edges over the edges the push
levels scan, over the run's BFS traversals: the program's counters
``traversal.frontier_edges_total{algo=bfs,direction=push}`` (Beamer's m_f
of each push level) over ``tocab.edges_scanned{engine=baseline_push}``
(all m edges a push level).

Read from the program's registry (``repro_torch.obs``) in a traced run:
None where the span buffer holds no push level of a traced slice (no
card, no trace) or the counters are missing."""


def read(rec: dict):
    if rec.get("algo") != "bfs":
        return None
    from repro_torch.obs import trace
    from repro_torch.obs.metrics import registry

    if not any(e["name"] == "traversal.level"
               and e["attrs"].get("direction") == "push"
               for e in trace.events()):
        return None
    useful = registry.counter("traversal.frontier_edges_total").value(
        algo="bfs", direction="push")
    scanned = registry.counter("tocab.edges_scanned").value(
        engine="baseline_push", direction="push")
    return useful / scanned if useful and scanned else None
