"""bfs_push_level_device_ms: the mean device-clock ms between the entry
and exit markers of the traced slice's ``traversal.level`` spans whose
direction is ``push``: a push level's frontier read, its flat push and
its advance, on the card's clock.

Read from the program's span buffer (``repro_torch.obs.trace``), which
records only while the slice's profiler runs; None where it holds no such
spans (no card, no trace)."""


def read(rec: dict):
    if rec.get("algo") != "bfs":
        return None
    from repro_torch.obs import trace

    ms = [e["device_ms"] for e in trace.events()
          if e["name"] == "traversal.level" and "device_ms" in e
          and e["attrs"].get("direction") == "push"]
    return sum(ms) / len(ms) if ms else None
