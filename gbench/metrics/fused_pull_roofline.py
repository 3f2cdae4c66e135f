"""fused_pull_roofline: the fused pull kernel's byte bound over its mean
device time a launch in the traced slice, in %.

The bound: 9 bytes a real edge of the pull layout (its window index,
compact index and mask), the values read once and the output written
once, 4 bytes a vertex each, over the device's memory bandwidth.  The
layout's id map (a few % more) is left out, so the share is not
overstated."""

#: device kernels whose launches are the fused pull (profiler names)
KERNELS = ("fused_pull_stream",)


def read(rec: dict):
    prof, peak = rec.get("profile"), rec.get("peak")
    if not prof or not peak:
        return None
    hits = [v for name, v in prof["kernels"].items()
            if any(k in name for k in KERNELS)]
    count = sum(v["count"] for v in hits)
    if not count:
        return None
    n, m = rec["graph"]["n"], rec["graph"]["m"]
    bound_s = (9 * m + 8 * n) / peak["hbm_bytes_per_s"]
    return 100.0 * bound_s / (sum(v["seconds"] for v in hits) / count)
