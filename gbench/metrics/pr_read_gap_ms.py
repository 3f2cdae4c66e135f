"""pr_read_gap_ms: the mean device-clock ms from a ``pagerank.stop_test``
span's entry marker to the entry marker of the next ``pagerank.iteration``
of the same solve, over the traced slice's solves.

The stop test's entry marker falls on the card when the iteration's work
(its engine and the L1 change) is done; the next iteration's entry marker
when the host, having read the change, queues the next iteration.  In
between the card has nothing queued.  Read from the program's span buffer
(``repro_torch.obs.trace``), which records only while the slice's
profiler runs; None where it holds no such spans (no card, no trace)."""


def read(rec: dict):
    if rec.get("algo") != "pagerank":
        return None
    from repro_torch.obs import trace

    events = trace.events()
    iters = {e.get("id"): e for e in events
             if e["name"] == "pagerank.iteration" and "dev_t0_ms" in e}
    by_solve = {(e["parent"], e["attrs"]["it"]): e for e in iters.values()}
    gaps = []
    for e in events:
        it = iters.get(e.get("parent"))
        if e["name"] != "pagerank.stop_test" or it is None \
                or "dev_t0_ms" not in e:
            continue
        nxt = by_solve.get((it["parent"], it["attrs"]["it"] + 1))
        if nxt is not None:
            gaps.append(nxt["dev_t0_ms"] - e["dev_t0_ms"])
    return sum(gaps) / len(gaps) if gaps else None
