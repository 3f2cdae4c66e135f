"""bfs_push_level_ms: the device-busy milliseconds of the traced BFS
traversals, less the time of their fused pull launches, over their push
levels (the registry counter ``traversal.iterations{algo=bfs,
direction=push}``)."""

#: device kernels of the pull levels (profiler names)
PULL_KERNELS = ("fused_pull_stream",)


def read(rec: dict):
    prof = rec.get("profile")
    if rec.get("algo") != "bfs" or not prof:
        return None
    push = prof["counters"].get("push_levels", 0)
    if not push or not prof["busy_s"]:
        return None
    pull_s = sum(v["seconds"] for name, v in prof["kernels"].items()
                 if any(k in name for k in PULL_KERNELS))
    return 1e3 * (prof["busy_s"] - pull_s) / push
