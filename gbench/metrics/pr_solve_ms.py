"""pr_solve_ms: the window's milliseconds over the PageRank solves it
completed."""


def read(rec: dict):
    if rec.get("algo") != "pagerank" or not rec["requests"]:
        return None
    return 1e3 * rec["window_s"] / len(rec["requests"])
