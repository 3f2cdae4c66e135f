"""A configuration, a traffic mix and a metric are each added as new files
plus new entries in BENCHMARK.json, and run, with no existing file of the
harness edited."""
import hashlib
import json

from gbench_testlib import run_cell, tiny_layout


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "gbench").rglob("*")) if p.is_file()}


def test_add_config_mix_and_metric(tmp_path):
    root = tiny_layout(tmp_path)
    before = digests(root)

    g = root / "gbench"
    (g / "configs" / "kron10flat.json").write_text(json.dumps(
        {"generator": "kronecker", "scale": 10, "edge_factor": 8,
         "a": 0.45, "b": 0.15, "c": 0.15, "symmetrize": False,
         "graph_seed": 3}))
    mix = json.loads((g / "traffic" / "pr_gap.json").read_text())
    mix.update(tol=1e-6, max_iters=30, sample=2)
    (g / "traffic" / "pr_tight.json").write_text(json.dumps(mix))
    (g / "metrics" / "pr_first_ms.py").write_text(
        "def read(rec):\n"
        "    reqs = rec['requests']\n"
        "    return reqs[0]['ms'] if rec.get('algo') == 'pagerank' "
        "and reqs else None\n")

    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "kron10flat", "source": "a test", "reduced": [],
        "file": "gbench/configs/kron10flat.json", "why": "a test"})
    bench["workloads"].append({
        "name": "kron10flat.pr_tight", "config": "kron10flat",
        "traffic": "pr_tight", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({
        "name": "pr_first_ms", "unit": "ms", "better": "lower",
        "bound": 0.1, "source": "host_clock",
        "workloads": ["kron10flat.pr_tight"]})
    for m in bench["end_to_end"]:
        if m["name"] in ("pr_solve_ms", "pr_solve_p95_ms"):
            m["workloads"].append("kron10flat.pr_tight")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    out = run_cell(root, "kron10flat.pr_tight", seed=9)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"setup_s", "pr_solve_ms",
                                   "pr_solve_p95_ms", "pr_first_ms"}
    after = digests(root)
    assert {k: after[k] for k in before} == before
