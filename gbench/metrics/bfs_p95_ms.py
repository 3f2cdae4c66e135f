"""bfs_p95_ms: the 95th percentile of the wall time of every BFS in the
window (linear between order statistics)."""
import statistics


def read(rec: dict):
    if rec.get("algo") != "bfs" or len(rec["requests"]) < 2:
        return None
    ms = [r["ms"] for r in rec["requests"]]
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
