"""bfs_traversal_roofline: the least time of the window's BFS traversals
over their wall time, in %.

The least time is the bytes a traversal needs over the device's memory
bandwidth: each traversed edge's 4-byte id once, and each reached
vertex's offset and depth once (4 bytes each)."""


def read(rec: dict):
    peak, reqs = rec.get("peak"), rec["requests"]
    if rec.get("algo") != "bfs" or not peak or not reqs:
        return None
    nbytes = sum(4 * r["edges"] + 8 * r["reached"] for r in reqs)
    wall_s = sum(r["ms"] for r in reqs) / 1e3
    return 100.0 * nbytes / peak["hbm_bytes_per_s"] / wall_s
