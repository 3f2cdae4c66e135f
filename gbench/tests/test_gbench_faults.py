"""The check at a small scale: the control (the plain reference put in the
program's place, made worse on purpose) and each fault planted under the
timed path must come out as not correct; the program as it is, correct.

The faults a one-card cell can have: a step that returns its state
unchanged; half of the work left out, the rest counted double; an answer
altered where it is produced.  (No cell exchanges data between cards.)"""
import importlib

import pytest
import torch

from gbench_testlib import run_cell, tiny_layout

# the modules themselves: ``repro_torch.core`` re-exports functions of the
# same names
pr_mod = importlib.import_module("repro_torch.core.pagerank")
tocab_mod = importlib.import_module("repro_torch.core.tocab")
trav_mod = importlib.import_module("repro_torch.core.traversal")

PR_CELLS = ["kron24.pr", "urand24.pr"]
BFS_CELLS = ["kron24.bfs", "urand24.bfs"]


@pytest.fixture
def root(tmp_path):
    return tiny_layout(tmp_path, scale=11)


@pytest.mark.parametrize("cell", PR_CELLS + BFS_CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(tmp_path, cell, seed):
    # BFS's control cuts a traversal's tail, which a symmetric graph of
    # 2**11 vertices lacks from most roots: at 2**14, 63 of the 64 have one
    # on kron24; on urand24 the level past the largest holds ~16 % of it,
    # under urand24's cut of a half
    root = tiny_layout(tmp_path, scale=14 if cell.endswith(".bfs") else 11)
    assert run_cell(root, cell, seed=seed)["correct"] is True
    out = run_cell(root, cell, seed=seed, control=True)
    assert out["correct"] is False, (out["attempted"], out["checks"])


def _halve(values):
    keep = torch.arange(values.shape[0], device=values.device) % 2 == 0
    return torch.where(keep.view((-1,) + (1,) * (values.ndim - 1)),
                       values * 2, 0)


def pr_unchanged(mp):
    mp.setattr(pr_mod, "pagerank_iteration",
               lambda variant, dg, bg, rank, *a, **k: rank.clone())


def pr_half(mp):
    pull = tocab_mod.tocab_pull
    mp.setattr(tocab_mod, "tocab_pull",
               lambda bg, values, *a, **k: pull(bg, _halve(values), *a, **k))


def pr_altered(mp):
    pull = tocab_mod.tocab_pull

    def altered(*a, **k):
        out = pull(*a, **k)
        out[0] += 1e-3
        return out

    mp.setattr(tocab_mod, "tocab_pull", altered)


def bfs_unchanged(mp):
    mp.setattr(trav_mod, "_frontier_reach",
               lambda dg, bg, frontier, *a: torch.zeros_like(frontier))


def bfs_half(mp):
    reach = trav_mod._frontier_reach
    mp.setattr(trav_mod, "_frontier_reach",
               lambda dg, bg, frontier, *a: reach(dg, bg, _halve(frontier),
                                                  *a))


def bfs_altered(mp):
    bfs = trav_mod.bfs

    def altered(*a, **k):
        depth, levels, push, pull = bfs(*a, **k)
        depth = depth.clone()
        depth[int(torch.argmin(depth))] += 1  # the root's depth
        return depth, levels, push, pull

    mp.setattr(trav_mod, "bfs", altered)


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in PR_CELLS for f in (pr_unchanged, pr_half, pr_altered)
] + [(c, f) for c in BFS_CELLS
     for f in (bfs_unchanged, bfs_half, bfs_altered)],
    ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = run_cell(root, cell, seed=4)
    assert out["correct"] is False, out["checks"]
