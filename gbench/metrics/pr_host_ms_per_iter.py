"""pr_host_ms_per_iter: the mean host ms of a ``pagerank.iteration`` span
less the time of its ``pagerank.stop_test`` (the read of the L1 change),
over the traced slice's iterations: the host loop's own work an iteration,
queueing the engine and the elementwise passes.

Read from the program's span buffer (``repro_torch.obs.trace``), which
records only while the slice's profiler runs; None where it holds no such
spans (no card, no trace)."""


def read(rec: dict):
    if rec.get("algo") != "pagerank":
        return None
    from repro_torch.obs import trace

    events = trace.events()
    iters = {e.get("id"): e["dur_s"] for e in events
             if e["name"] == "pagerank.iteration"}
    own = dict(iters)
    for e in events:
        if e["name"] == "pagerank.stop_test" and e.get("parent") in own:
            own[e["parent"]] -= e["dur_s"]
    return 1e3 * sum(own.values()) / len(own) if own else None
