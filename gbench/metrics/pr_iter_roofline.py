"""pr_iter_roofline: the least time of one PageRank pull iteration over its
mean wall time in the window, in %.

The least time is the bytes an iteration needs, counted from the graph's
n and m alone, over the device's memory bandwidth: each edge's 4-byte
source id, and the offsets, out-degree, contribution and old rank of each
vertex read once (4 bytes each), its new rank written once.  The count is
the same whatever engine runs the iteration."""


def read(rec: dict):
    peak, reqs = rec.get("peak"), rec["requests"]
    if rec.get("algo") != "pagerank" or not peak or not reqs:
        return None
    n, m = rec["graph"]["n"], rec["graph"]["m"]
    least_s = (4 * m + 20 * n + 4) / peak["hbm_bytes_per_s"]
    iter_s = sum(r["ms"] for r in reqs) / 1e3 / sum(r["iters"] for r in reqs)
    return 100.0 * least_s / iter_s
