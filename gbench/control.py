#!/usr/bin/env python3
"""Readings that the limits of a cell's check are set from, on the card.

    python3 gbench/control.py --workload kron24.pr --seconds 3 \\
        --seeds 101 102 ... --control-seeds 101 102 103

For each seed of ``--seeds`` a short run of the program, and for each of
``--control-seeds`` one of the control (the driver's plain reference put
in the program's place and made worse on purpose: bfloat16 for PageRank,
an early exit for BFS), all in one process; one JSON line a run with the
numbers compared.  The benchmark's own runs never run the control.
"""
import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    sys.path.insert(0, str(HERE))
    import run

    root = HERE.parent
    run._prepare_env(root)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    runs = [(s, False) for s in args.seeds] + \
        [(s, True) for s in args.control_seeds]
    for seed, control in runs:
        out = run.run_cell(root, args.workload, seed, args.seconds, False,
                           control=control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": control, "attempted": out["attempted"],
                          "checks": {k: c["value"]
                                     for k, c in out["checks"].items()},
                          "metrics": {k: m["value"]
                                      for k, m in out["metrics"].items()}}),
              flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
