#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one run of
one cell of ``BENCHMARK.json``.

    python3 gbench/run.py --workload kron24.pr --seed 7 --seconds 30 --trace 0

A cell names a configuration (``configs/<config>.json``: a graph and the
generator in ``gen/`` that makes it on the card from ``--seed``) and a
traffic mix (``traffic/<mix>.json``, whose ``driver`` is
``drivers/<driver>.py``).  The driver sets the program up and calls its
entry point; this file times the calls in a closed loop for ``--seconds``,
samples their answers from the seed, and then has the driver judge them
against its plain reference (``reference/``) by the limits the mix states.
Each metric is read from the run's record by ``metrics/<metric>.py``:
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics, after a short slice under ``torch.profiler``.

The last line of standard output is the result, as JSON; the numbers
compared, each beside its limit, are the last lines of standard error and
the last key of the result.  With no card, or fewer cards than the cell
asks for, the run prints no result and exits with 2; it exits with 3 if
JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()  # set-up is timed from the start of the process

import argparse  # noqa: E402
import bisect  # noqa: E402
import importlib.util  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: characters of a kernel's name kept in the breakdown
NAME_CHARS = 160


def _prepare_env(root: Path):
    """The program's source on the path; kernel caches inside the
    checkout, at fixed paths."""
    src = root / "src"
    if src.is_dir() and str(src) not in sys.path:
        sys.path.insert(0, str(src))
    cache = root / HERE.name / "_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))


def load_module(path: Path):
    """Import the Python file ``path`` as a module of its own."""
    name = "gbench_" + "_".join(path.with_suffix("").parts[-2:]).replace(
        ".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


class Context:
    """What a driver gets: the cell's configuration and mix, the seed, the
    device, and where to record its set-up."""

    def __init__(self, root: Path, cell: dict, bench: dict, seed: int,
                 device: str):
        config = next(c for c in bench["configs"]
                      if c["name"] == cell["config"])
        self.root = root / HERE.name
        self.cfg = json.loads((root / config["file"]).read_text())
        self.mix = json.loads(
            (self.root / "traffic" / f"{cell['traffic']}.json").read_text())
        self.seed, self.device = seed, device
        self.setup: dict = {}
        self.graph: dict = {}

    def load(self, rel: str):
        return load_module(self.root / rel)


class Sample:
    """A uniform sample of ``k`` answers from the seed (reservoir), and the
    last answer."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.kept, self.last = k, rng, [], None

    def offer(self, i: int, answer):
        if len(self.kept) < self.k:
            self.kept.append((i, answer))
        else:
            j = self.rng.randrange(i + 1)
            if j < self.k:
                self.kept[j] = (i, answer)
        self.last = (i, answer)

    def items(self) -> list:
        out = sorted(self.kept, key=lambda t: t[0])
        if self.last is not None and self.last[0] != out[-1][0]:
            out.append(self.last)
        return out


def window(driver, seconds: float, sample: Sample) -> tuple:
    """Call the driver in a closed loop until ``seconds`` have passed;
    the window ends when the last call returns.  A call's time ends when
    it returns; the driver's ``settle`` then counts what the benchmark
    needs of its answer, inside the window but outside that time."""
    infos = []
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        answer, info = driver.call(i)
        t1 = time.perf_counter()
        info["ms"] = 1e3 * (t1 - t0)
        driver.settle(answer, info)
        infos.append(info)
        sample.offer(i, answer)
        i += 1
        if t1 - start >= seconds:
            return infos, t1 - start


def _numbers(info: dict) -> dict:
    return {k: (v.item() if hasattr(v, "item") else v)
            for k, v in info.items()}


def _union(spans: list) -> list:
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(events: list, top: int = 10) -> dict:
    """Device busy time, kernel time by name, and idle gaps by what the
    host was doing, from ``torch.profiler`` events (microseconds).

    An idle gap is named after the outermost ``aten::`` operation that
    covers its middle on the host (``python`` where none does)."""
    from torch.autograd import DeviceType

    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name.startswith("aten::")]
    kernels: dict = {}
    for e in dev:
        k = kernels.setdefault(e.name, {"count": 0, "seconds": 0.0})
        k["count"] += 1
        k["seconds"] += (e.time_range.end - e.time_range.start) / 1e6
    busy = _union([(e.time_range.start, e.time_range.end) for e in dev])
    if not busy:
        return {"busy_s": 0.0, "kernels": kernels, "device_ops": [],
                "idle_gaps": []}
    lo = min(e.time_range.start for e in events)
    hi = max(e.time_range.end for e in events)
    edges = [lo] + [x for span in busy for x in span] + [hi]
    # host ops by start (ties in list order), with the running maximum of
    # their ends: the first op among those starting by ``mid`` whose
    # running end reaches ``mid`` is the earliest-starting op covering it
    host.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    reach = list(itertools.accumulate((e.time_range.end for e in host), max))
    gaps: dict = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        n = bisect.bisect_right(starts, mid)
        i = bisect.bisect_left(reach, mid, 0, n)
        name = host[i].name if i < n else "python"
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    by_time = sorted(kernels.items(), key=lambda kv: -kv[1]["seconds"])
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernels": kernels,
        "device_ops": [[n[:NAME_CHARS], v["seconds"]]
                       for n, v in by_time[:top]],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                            key=lambda t: -t[1])[:top],
    }


def profile(driver, start: int, count: int) -> dict:
    """``count`` further calls under ``torch.profiler``: the traced slice.
    Its calls do not count in the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile

    before = driver.counters()
    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        calls = [driver.call(start + j) for j in range(count)]
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    after = driver.counters()
    for answer, info in calls:
        driver.settle(answer, info)
    infos = [_numbers(info) for _, info in calls]
    del calls
    out = reduce_trace(list(prof.events()))
    out.update(window_s=window_s, requests=infos,
               counters={k: after[k] - before.get(k, 0) for k in after})
    return out


def device_info(device: str, count: int) -> dict:
    import torch

    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", control: bool = False,
             log=None) -> dict:
    """One run of cell ``workload`` of ``root/BENCHMARK.json``; returns the
    result (``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, with ``trace`` also ``breakdown``, and ``checks`` last).

    ``control=True`` puts the driver's control (its reference, made worse
    on purpose) in the program's place."""
    import torch

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = _cell(bench, workload)
    ctx = Context(root, cell, bench, seed, device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    driver = ctx.load(f"drivers/{ctx.mix['driver']}.py").Driver(ctx)
    if control:
        driver.control()
    t = time.perf_counter()
    driver.warm()
    ctx.setup["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - T0
    log(f"setup {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ctx.setup.items()) + f"; {ctx.graph}")

    sample = Sample(int(ctx.mix["sample"]), random.Random(seed))
    infos, window_s = window(driver, seconds, sample)
    infos = [_numbers(i) for i in infos]
    prof = (profile(driver, len(infos), int(ctx.mix["profile_requests"]))
            if trace and device == "cuda" else None)
    dev = device_info(device, int(cell["chips"]))
    if prof is not None:
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])

    samples = sample.items()
    driver.release()
    if device == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = driver.check(samples, infos)
    log(f"check {time.perf_counter() - t:.3f} s over {len(samples)} "
        f"sampled of {len(infos)} calls")

    rec = {"algo": driver.algo, "setup_s": setup_s, "setup": ctx.setup,
           "graph": ctx.graph, "requests": infos, "window_s": window_s,
           "profile": prof, "peak": _peak(dev["kind"])}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = ctx.load(f"metrics/{m['name']}.py").read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = ctx.mix["limits"]
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in numbers.items()}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    out = {"correct": correct, "attempted": len(infos), "failed": 0,
           "metrics": metrics, "device": dev}
    if prof is not None:
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    out["checks"] = checks
    return out


def _peak(kind: str):
    """The published peaks of device ``kind`` (``peaks.json``), or None."""
    return json.loads((HERE / "peaks.json").read_text()).get(kind)


def _cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = HERE.parent
    cell = _cell(json.loads((root / "BENCHMARK.json").read_text()),
                 args.workload)
    _prepare_env(root)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(root, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    bad = forbidden_modules()  # the window has closed
    if bad:
        print("refusing to report: loaded in this process: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
