"""bfs_gteps: traversed edges of every BFS in the window (the out-edges of
the vertices each reached) over the window's seconds, in 10^9 a second."""


def read(rec: dict):
    if rec.get("algo") != "bfs" or not rec["requests"]:
        return None
    return sum(r["edges"] for r in rec["requests"]) / rec["window_s"] / 1e9
