"""The graph generators at a small scale: one seed, one graph; Kronecker
skew against uniform degrees; a clean CSR."""
import json

import pytest
import torch

from gbench_testlib import GBENCH, load

GRAPH = load("drivers/_graph.py")


def make(name: str, seed: int, scale: int = 12):
    cfg = json.loads((GBENCH / "configs" / f"{name}.json").read_text())
    cfg["scale"] = scale
    gen = torch.Generator().manual_seed(seed)
    make_edges = load(f"gen/{cfg['generator']}.py").edges
    return GRAPH.csr(*make_edges(cfg, gen, "cpu"),
                     symmetrize=cfg["symmetrize"])


@pytest.mark.parametrize("name", ["kron24", "urand24"])
def test_same_seed_same_graph(name):
    a, b, c = make(name, 7), make(name, 7), make(name, 8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[1], c[1])


@pytest.mark.parametrize("name", ["kron24", "urand24"])
def test_csr_is_clean(name):
    rowptr, colidx = make(name, 3)
    n = rowptr.numel() - 1
    assert rowptr[0] == 0 and rowptr[-1] == colidx.numel()
    row = torch.repeat_interleave(torch.arange(n), rowptr[1:] - rowptr[:-1])
    key = row * n + colidx.long()
    assert bool((key[1:] > key[:-1]).all())  # sorted, no duplicates
    assert not bool((row == colidx.long()).any())  # no self-loops
    assert 0 <= int(colidx.min()) and int(colidx.max()) < n


def test_symmetrize_stores_each_edge_both_ways():
    n = 6
    src, dst = torch.tensor([0, 1, 1, 4, 5]), torch.tensor([1, 2, 2, 4, 3])
    for sym, want in ((False, {(0, 1), (1, 2), (5, 3)}),
                      (True, {(0, 1), (1, 0), (1, 2), (2, 1), (5, 3),
                              (3, 5)})):
        rowptr, colidx = GRAPH.csr(n, src, dst, symmetrize=sym)
        row = torch.repeat_interleave(torch.arange(n),
                                      rowptr[1:] - rowptr[:-1])
        assert set(zip(row.tolist(), colidx.tolist())) == want


@pytest.mark.parametrize("name", ["kron24", "urand24"])
def test_configured_graphs_are_symmetric(name):
    rowptr, colidx = make(name, 4, scale=10)
    n = rowptr.numel() - 1
    row = torch.repeat_interleave(torch.arange(n), rowptr[1:] - rowptr[:-1])
    fwd = row * n + colidx.long()
    rev = torch.sort(colidx.long() * n + row).values
    assert torch.equal(fwd, rev)


def test_large_seed():
    rowptr, colidx = make("kron24", 2**31 + 12345, scale=8)
    assert colidx.numel() > 0


def test_kronecker_is_skewed_uniform_is_not():
    def skew(rowptr):
        deg = (rowptr[1:] - rowptr[:-1]).double()
        return float(deg.max() / deg.mean()), float((deg == 0).double().mean())

    kron, urand = skew(make("kron24", 5)[0]), skew(make("urand24", 5)[0])
    assert kron[0] > 20 * urand[0]  # hubs
    assert kron[1] > 0.1 and urand[1] < 0.01  # many vertices without edges
    n_edges = [make(k, 5)[1].numel() for k in ("kron24", "urand24")]
    assert 0.7 < n_edges[0] / n_edges[1] < 1.0  # about the same edges
