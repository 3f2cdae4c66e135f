"""Render and diff BENCH_*.json artifacts (the port's copy of
``repro.obs.report``, for a machine without JAX).

    python -m repro_torch.obs.report BENCH_fig6_pagerank.json
    python -m repro_torch.obs.report BENCH_new.json --baseline BENCH_old.json

The first form prints the run fingerprint and a table of benchmark records;
the second additionally prints per-metric deltas against the baseline run
(positive runtime delta = regression).  Exit code is 0 unless --fail-above
is given and some runtime regressed more than that percentage."""
from __future__ import annotations

import argparse
import sys
from typing import Optional

from .export import read_json

__all__ = ["render", "diff", "render_diff", "main"]

_SKIP_FIELDS = ("name",)


def _numeric_fields(records: list) -> list:
    fields: list = []
    for r in records:
        for k, v in r.items():
            if k not in _SKIP_FIELDS and isinstance(v, (int, float)) \
                    and k not in fields:
                fields.append(k)
    return fields


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return "" if v is None else str(v)


def _table(headers: list, rows: list) -> str:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    def line(cells):
        return "  ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip()
    out = [line(headers), line(["-" * w for w in widths])]
    out.extend(line(r) for r in rows)
    return "\n".join(out)


def _fingerprint_line(fp: dict) -> str:
    """The port's torch/CUDA/card fields; a reference artifact's jax field
    where the payload came from the JAX package."""
    if "jax_version" in fp:
        env = f"jax={fp.get('jax_version')}"
    else:
        env = (f"torch={fp.get('torch_version')} "
               f"cuda={fp.get('cuda_version')} "
               f"device={fp.get('device_kind')!r} "
               f"power_limit_w={fp.get('power_limit_w')}")
    return (f"# {env} backend={fp.get('backend')} "
            f"devices={fp.get('device_count')} git={fp.get('git_sha')}")


def render(payload: dict) -> str:
    """Human-readable table for one BENCH payload."""
    fp = payload.get("fingerprint", {})
    head = (
        f"# {payload.get('name', '?')}  [{payload.get('schema', '?')}]\n"
        + _fingerprint_line(fp)
    )
    records = payload.get("records", [])
    if not records:
        return head + "\n(no records)"
    fields = _numeric_fields(records)
    rows = [[r.get("name", "?")] + [_fmt(r.get(f)) for f in fields]
            for r in records]
    return head + "\n" + _table(["name"] + fields, rows)


def diff(new: dict, old: dict) -> list:
    """Per-record, per-metric deltas between two BENCH payloads.

    Returns rows ``{name, metric, old, new, delta, pct}`` for every numeric
    field present in both versions of a same-named record."""
    old_by_name = {r.get("name"): r for r in old.get("records", [])}
    out = []
    for r in new.get("records", []):
        base = old_by_name.get(r.get("name"))
        if base is None:
            continue
        for k, v in r.items():
            if k in _SKIP_FIELDS or not isinstance(v, (int, float)):
                continue
            b = base.get(k)
            if not isinstance(b, (int, float)):
                continue
            delta = v - b
            pct = (delta / b * 100.0) if b else None
            out.append({"name": r["name"], "metric": k, "old": b,
                        "new": v, "delta": delta, "pct": pct})
    return out


def render_diff(rows: list, only_metric: Optional[str] = None) -> str:
    if only_metric:
        rows = [r for r in rows if r["metric"] == only_metric]
    if not rows:
        return "(no overlapping records to diff)"
    table_rows = [
        [r["name"], r["metric"], _fmt(r["old"]), _fmt(r["new"]),
         _fmt(r["delta"]),
         ("" if r["pct"] is None else f"{r['pct']:+.1f}%")]
        for r in rows
    ]
    return _table(["name", "metric", "old", "new", "delta", "pct"],
                  table_rows)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a BENCH_*.json artifact, optionally diffed "
                    "against a baseline run.")
    ap.add_argument("bench", help="BENCH_*.json to render")
    ap.add_argument("--baseline", default=None,
                    help="prior BENCH_*.json to diff against")
    ap.add_argument("--metric", default=None,
                    help="restrict the diff table to one metric "
                         "(e.g. us_per_call)")
    ap.add_argument("--fail-above", type=float, default=None, metavar="PCT",
                    help="exit 1 if any us_per_call regressed more than PCT%%")
    args = ap.parse_args(argv)

    payload = read_json(args.bench)
    print(render(payload))
    if args.baseline is None:
        return 0
    rows = diff(payload, read_json(args.baseline))
    print(f"\n## delta vs {args.baseline}\n")
    print(render_diff(rows, only_metric=args.metric))
    if args.fail_above is not None:
        bad = [r for r in rows
               if r["metric"] == "us_per_call" and r["pct"] is not None
               and r["pct"] > args.fail_above]
        if bad:
            print(f"\nREGRESSION: {len(bad)} record(s) slower than "
                  f"+{args.fail_above}%", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
