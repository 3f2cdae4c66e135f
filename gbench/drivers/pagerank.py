"""PageRank solves, one after another (traffic ``pr_*``).

Every solve is the program's ``repro_torch.core.pagerank.pagerank`` from
uniform ``1 / n``, with the engine, the schedule and the stop test the mix
names.  The check runs the plain reference (``reference/pagerank.py``, in
float64) once over the benchmark's own CSR and compares:

* ``rank_l1``: the L1 distance between a solve's ranks and the
  reference's after as many iterations, the largest over the sampled
  solves;
* ``stop_miss``: how far the reference's own L1 changes put the stop of a
  solve from where the program put it, in units of ``tol`` (0 where they
  agree), the largest over every solve of the window.
"""
from __future__ import annotations

import torch


class Driver:
    algo = "pagerank"

    def __init__(self, ctx):
        from repro_torch.core.pagerank import pagerank

        self.ctx, mix = ctx, ctx.mix
        self.graph = ctx.load("drivers/_graph.py").GraphSetup(ctx)
        self.stop = dict(damping=mix["damping"], tol=mix["tol"],
                         max_iters=mix["max_iters"])
        dg, bg = self.graph.dg, self.graph.bg
        kw = dict(variant=mix["variant"], schedule=mix["schedule"],
                  impl=mix["impl"], **self.stop)
        #: what the window drives: ``entry() -> (rank, iterations)``
        self.entry = lambda: pagerank(dg, bg, **kw)

    def warm(self):
        self.call(0)

    def call(self, i: int):
        rank, iters = self.entry()
        if rank.is_cuda:
            torch.cuda.synchronize()
        return (rank, int(iters)), {"iters": int(iters)}

    def settle(self, answer, info: dict):
        """Nothing of the benchmark's own to count after a solve."""

    def counters(self) -> dict:
        return {}

    def control(self):
        """The reference in the program's place, in bfloat16."""
        ref = self.ctx.load("reference/pagerank.py")
        rowptr, colidx = self.graph.on_device(self.ctx.device)

        def entry():
            out = ref.pagerank(rowptr, colidx, dtype=torch.bfloat16,
                               **self.stop)
            return out["rank"], out["iters"]

        self.entry = entry

    def release(self):
        self.entry = None
        self.graph.release()

    def check(self, samples: list, infos: list) -> dict:
        ref = self.ctx.load("reference/pagerank.py")
        rowptr, colidx = self.graph.on_device(self.ctx.device)
        iters = sorted({info["iters"] for info in infos}
                       | {k for _, (_, k) in samples})
        out = ref.pagerank(rowptr, colidx, min_iters=iters[-1],
                           keep=set(iters), **self.stop)
        del rowptr, colidx
        l1 = max(float((rank.double() - out["kept"][k]).abs().sum())
                 for _, (rank, k) in samples)
        return {"rank_l1": l1,
                "stop_miss": max(self._miss(out["deltas"], k)
                                 for k in iters)}

    def _miss(self, deltas: list, k: int) -> float:
        """How far, in units of ``tol``, the reference's L1 changes lie on
        the wrong side of the stop test for a solve that stopped after
        ``k`` iterations: its change at ``k`` must be at most ``tol``
        (unless ``k`` is the cap), the one before above it."""
        tol = self.stop["tol"]
        miss = 0.0
        if k < self.stop["max_iters"]:
            miss = max(miss, deltas[k - 1] / tol - 1.0)
        if k > 1:
            miss = max(miss, 1.0 - deltas[k - 2] / tol)
        return miss
