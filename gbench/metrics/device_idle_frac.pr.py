"""device_idle_frac.pr: the share of the traced slice's wall time (a few
PageRank solves under torch.profiler) in which no kernel or copy ran on
the device."""


def read(rec: dict):
    prof = rec.get("profile")
    if rec.get("algo") != "pagerank" or not prof or not prof["busy_s"]:
        return None
    return 1.0 - prof["busy_s"] / prof["window_s"]
