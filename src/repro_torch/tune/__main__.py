"""CLI: ``python -m repro_torch.tune {tune,show,apply} [...]``.

* ``tune``  — search the graph suite (:mod:`repro_torch.tune.suite`) on the
  card (``--device cpu`` for the host), persist winners to the DB.
* ``show``  — render the DB (one row per entry, chosen config + provenance).
* ``apply`` — print the tuned configuration per graph as ready-to-paste
  ``build_blocked(...)`` / engine kwargs (or ``--json`` for machines).

Examples::

    PYTHONPATH=src python -m repro_torch.tune tune --arch graphcage \\
        --trials-budget small
    PYTHONPATH=src python -m repro_torch.tune show
    PYTHONPATH=src python -m repro_torch.tune apply --graph rmat14
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional

from repro_torch.core.graph import Graph

from . import db as tune_db
from . import tuner
from .space import BUDGETS, WORKLOADS
from .suite import SMOKE_GRAPH, SUITE


def _load_graphs(names, budget: str) -> Dict[str, Graph]:
    builders = SUITE
    if names:
        unknown = sorted(set(names) - set(builders))
        if unknown:
            raise SystemExit(
                f"unknown graph(s) {unknown}; suite has {sorted(builders)}")
        picked = names
    else:
        picked = (SMOKE_GRAPH,) if budget == "smoke" else tuple(builders)
    return {n: builders[n]() for n in picked}


def _arch_cfg(arch: str):
    if arch != "graphcage":
        raise SystemExit(f"unknown --arch {arch!r} (only 'graphcage' has "
                         "tunable graph engines)")
    from repro_torch.configs.graphcage import DEFAULT

    return DEFAULT


def _fmt_age(created) -> str:
    try:
        return time.strftime("%Y-%m-%d %H:%M", time.localtime(float(created)))
    except (TypeError, ValueError):
        return "?"


def cmd_tune(args) -> int:
    cfg = _arch_cfg(args.arch)
    budget = args.trials_budget
    graphs = _load_graphs(args.graphs, budget)
    workloads = tuple(args.workloads) if args.workloads else (
        ("pagerank",) if budget == "smoke" else ("pagerank", "spmv"))
    space = None
    if args.impls:
        import dataclasses

        from .space import SearchSpace

        space = dataclasses.replace(
            SearchSpace.for_budget(budget, cfg), impls=tuple(args.impls))
    print(f"# tuning {sorted(graphs)} x {list(workloads)} "
          f"(budget={budget}, dtype={args.dtype}, "
          f"device={tune_db.device_key(args.device)}, "
          f"db={tune_db.db_path(args.db_dir)})",
          file=sys.stderr)
    summary = tuner.tune(
        graphs, workloads=workloads, budget=budget, space=space,
        db_dir=args.db_dir, cfg=cfg, force=args.force, verbose=args.verbose,
        dtype=args.dtype, trial_timeout=args.trial_timeout,
        device=args.device)
    for e in summary["entries"]:
        src = "db-hit" if e.get("db_hit") else (
            f"{len(e['trials'])} trials, {e['pruned_analytic']} pruned")
        star = " *non-default*" if e.get("non_default") else ""
        print(f"{e['graph']}/{e['workload']}: {_chosen_key(e)}"
              f"  ({e['best_us']:.0f}us; {src}){star}")
    print(f"# {len(summary['entries'])} entries, "
          f"{summary['new_trials']} new trials, "
          f"{summary['pruned']} pruned analytically, "
          f"{summary['db_hits']} db hits -> {summary['db_path']}")
    return 0


def _chosen_key(entry: dict) -> str:
    from .space import Candidate

    return Candidate.from_json(entry["chosen"]).key()


def cmd_show(args) -> int:
    d = tune_db.load(tune_db.db_path(args.db_dir))
    entries = d.get("entries", {})
    if not entries:
        print(f"(empty tuning db at {tune_db.db_path(args.db_dir)})")
        return 0
    fp = d.get("fingerprint", {})
    print(f"# {d.get('schema')}  backend={fp.get('backend')} "
          f"device={fp.get('device_kind')} git={fp.get('git_sha')}")
    header = f"{'graph':10} {'workload':9} {'chosen':40} {'us':>9} " \
             f"{'trials':>6} {'pruned':>6} {'created':16}"
    print(header)
    print("-" * len(header))
    for key in sorted(entries):
        e = entries[key]
        print(f"{e.get('graph', '?'):10} {e.get('workload', '?'):9} "
              f"{_chosen_key(e):40} {e.get('best_us', 0):9.0f} "
              f"{len(e.get('trials', [])):6d} "
              f"{e.get('pruned_analytic', 0):6d} "
              f"{_fmt_age(e.get('created')):16}")
    return 0


def cmd_apply(args) -> int:
    d = tune_db.load(tune_db.db_path(args.db_dir))
    entries = [e for e in d.get("entries", {}).values()
               if not args.graph or e.get("graph") == args.graph]
    if not entries:
        print(f"(nothing to apply for "
              f"{args.graph or 'any graph'} in {tune_db.db_path(args.db_dir)})")
        return 1
    if args.json:
        print(json.dumps(
            {f"{e['graph']}/{e['workload']}": e["chosen"] for e in entries},
            indent=1, sort_keys=True))
        return 0
    for e in sorted(entries, key=lambda e: (e["graph"], e["workload"])):
        c = e["chosen"]
        print(f"# {e['graph']} / {e['workload']}  "
              f"({e['best_us']:.0f}us, chosen {_chosen_key(e)})")
        if c["engine"] in ("cb", "tocab"):
            th = c["bin_thresholds"]
            th = tuple(th) if isinstance(th, list) else th
            print(f"bg = build_blocked(g, block_size={c['block_size']}, "
                  f"direction={c['direction']!r}, bin_thresholds={th!r})")
            print(f"out = {'tocab' if c['engine'] == 'tocab' else 'cb'}_"
                  f"{c['direction']}(bg, x"
                  + (f", schedule={c['schedule']!r}"
                     if c["engine"] == "tocab" else "")
                  + (f", impl={c['impl']!r}"
                     if c.get("impl", "slab") != "slab" else "") + ")")
        else:
            print(f"out = baseline_{c['direction']}(dg, x)")
        if e["workload"] == "bfs":
            print(f"depth, *_ = bfs(dg, bg, src, alpha={c['alpha']})")
        print()
    return 0


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="Cache-model-guided autotuner over the benchmark "
                    "graph suite (persistent DB under experiments/tune/).")
    sub = ap.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--db-dir", default=None,
                        help="tuning-db directory (default: $REPRO_TUNE_DIR "
                             "or experiments/tune)")

    t = sub.add_parser("tune", parents=[common],
                       help="search the graph suite, persist winners")
    t.add_argument("--arch", default="graphcage")
    t.add_argument("--trials-budget", default="small",
                   choices=sorted(BUDGETS))
    t.add_argument("--graphs", default=None,
                   type=lambda s: [x for x in s.split(",") if x],
                   help="comma-separated suite graph names "
                        "(default: whole suite; smoke: rmat14)")
    t.add_argument("--workloads", default=None,
                   type=lambda s: [x for x in s.split(",") if x],
                   choices=None, metavar=f"{{{','.join(WORKLOADS)}}}")
    t.add_argument("--impls", default=None,
                   type=lambda s: [x for x in s.split(",") if x],
                   metavar="{slab,fused}",
                   help="restrict the engine-impl axis (default: the "
                        "arch config's tune_impls)")
    t.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="value dtype the trials time and the DB entry is "
                        "keyed on")
    t.add_argument("--force", action="store_true",
                   help="re-tune even on a DB hit")
    t.add_argument("--trial-timeout", default=None, type=float,
                   help="per-candidate wall-clock bound in seconds, CPU "
                        "trials only (--device cpu); a candidate that "
                        "exceeds it is marked poisoned in the DB and "
                        "skipped by later sweeps")
    t.add_argument("--device", default="cuda",
                   help="where the trials run and which device's entries "
                        "they write (default: the card)")
    t.add_argument("--verbose", action="store_true")
    t.set_defaults(fn=cmd_tune)

    s = sub.add_parser("show", parents=[common], help="render the DB")
    s.set_defaults(fn=cmd_show)

    a = sub.add_parser("apply", parents=[common],
                       help="print tuned config per graph")
    a.add_argument("--graph", default=None)
    a.add_argument("--json", action="store_true")
    a.set_defaults(fn=cmd_apply)

    args = ap.parse_args(argv)
    if args.cmd == "tune" and args.workloads:
        bad = sorted(set(args.workloads) - set(WORKLOADS))
        if bad:
            ap.error(f"unknown workload(s) {bad}; expected {WORKLOADS}")
    if args.cmd == "tune" and args.impls:
        bad = sorted(set(args.impls) - {"slab", "fused"})
        if bad:
            ap.error(f"unknown impl(s) {bad}; expected slab/fused")
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
