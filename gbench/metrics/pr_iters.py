"""pr_iters: the mean number of iterations of the window's PageRank
solves, as ``pagerank`` returns them."""


def read(rec: dict):
    if rec.get("algo") != "pagerank" or not rec["requests"]:
        return None
    return sum(r["iters"] for r in rec["requests"]) / len(rec["requests"])
