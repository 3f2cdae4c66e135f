"""Set-up shared by the graph drivers.

The graph is made on the device (``gen/<generator>.py``) from the
configuration's ``graph_seed``, in every run: the configuration fixes the
graph, as GAP benchmarks one generated file, and ``--seed`` draws only the
traffic (``traffic``, a generator seeded from it).  Where the
configuration says ``symmetrize``, each edge is joined by its reverse, as
GAP's builder does; self-loops are dropped, duplicates removed by one
device sort, then the edges are turned into CSR.  The benchmark keeps its
own copy of that CSR on the host, for the reference after the window, and
its own out-degree array on the device.  The program gets the same CSR as
its host ``Graph`` and builds from it what its entry points take: the flat
``DeviceGraph`` and the pull layout (``build_blocked``); the fused pull
kernel is built first.
"""
from __future__ import annotations

import time

import torch


def csr(n: int, src: torch.Tensor, dst: torch.Tensor,
        symmetrize: bool = False) -> tuple:
    """``(rowptr int64[n + 1], colidx int32[m])`` on the edges' device:
    with ``symmetrize`` every edge and its reverse, self-loops dropped,
    duplicates removed, rows sorted by destination."""
    if symmetrize:
        src, dst = torch.cat((src, dst)), torch.cat((dst, src))
    keep = src != dst
    key = src[keep].long() * n + dst[keep].long()
    del src, dst, keep
    key = torch.sort(key).values
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    key = key[first]
    del first
    row = torch.div(key, n, rounding_mode="floor")
    colidx = (key - row * n).to(torch.int32)
    del key
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=colidx.device)
    rowptr[1:] = torch.cumsum(torch.bincount(row, minlength=n), 0)
    return rowptr, colidx


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class GraphSetup:
    """The graph of one run, in the benchmark's hands and the program's.

    Set-up seconds go into ``ctx.setup``: ``gen_s`` (made on the device),
    ``host_copy_s``, ``kernel_build_s``, ``device_graph_s`` and
    ``layout_s`` (``build_blocked``, ending in a synchronise)."""

    def __init__(self, ctx):
        from repro_torch.core.graph import DeviceGraph, Graph
        from repro_torch.core.partition import build_blocked

        dev, cfg = ctx.device, ctx.cfg
        t = time.perf_counter()
        #: the traffic's random stream, from ``--seed``
        self.traffic = torch.Generator(device=dev).manual_seed(ctx.seed)
        #: the configuration's random stream: it draws the graph, then
        #: whatever else the configuration fixes (BFS's roots)
        self.fixed = torch.Generator(device=dev).manual_seed(
            int(cfg["graph_seed"]))
        make = ctx.load(f"gen/{cfg['generator']}.py").edges
        rowptr, colidx = csr(*make(cfg, self.fixed, dev),
                             symmetrize=bool(cfg["symmetrize"]))
        self.n, self.m = rowptr.numel() - 1, colidx.numel()
        #: the benchmark's own out-degrees (int64, on the device)
        self.out_degree = rowptr[1:] - rowptr[:-1]
        _sync(dev)
        ctx.setup["gen_s"] = time.perf_counter() - t

        t = time.perf_counter()
        #: the benchmark's own CSR, on the host
        self.rowptr = rowptr.cpu().numpy()
        self.colidx = colidx.cpu().numpy()
        del rowptr, colidx
        ctx.setup["host_copy_s"] = time.perf_counter() - t

        t = time.perf_counter()
        if torch.device(dev).type == "cuda":
            from repro_torch.kernels import cuda_build

            cuda_build.build(["fused_pull"])
        ctx.setup["kernel_build_s"] = time.perf_counter() - t

        g = Graph(n=self.n, rowptr=self.rowptr, colidx=self.colidx)
        t = time.perf_counter()
        self.dg = DeviceGraph.from_host(g, device=dev)
        _sync(dev)
        ctx.setup["device_graph_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.bg = build_blocked(g, direction="pull", device=dev)
        _sync(dev)
        ctx.setup["layout_s"] = time.perf_counter() - t
        ctx.graph = {"n": self.n, "m": self.m}

    def release(self):
        """Drop the program's graph and layout."""
        self.dg = self.bg = None

    def on_device(self, device) -> tuple:
        """The benchmark's CSR on ``device``: ``(rowptr, colidx)``, both
        int64."""
        return (torch.from_numpy(self.rowptr).to(device),
                torch.from_numpy(self.colidx).to(device).long())
