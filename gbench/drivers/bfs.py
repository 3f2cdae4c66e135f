"""Graph500 BFS traversals, one after another (traffic ``bfs_*``).

The configuration fixes the roots, as Graph500 fixes its search keys for
a graph: ``roots`` distinct vertices with out-edges, drawn from the
configuration's stream after its graph.  ``--seed`` orders them: the
window takes pass after pass over all of them, each pass in an order of
its own.  Each traversal is the program's
``repro_torch.core.traversal.bfs`` with the engine, the schedule and the
Beamer ``alpha`` the mix names.  Traversed edges are the out-edges of the
reached vertices, counted from the benchmark's own degree array after the
traversal's timed span (``settle``).  The check runs the plain reference
(``reference/bfs.py``) from each sampled root and compares, exactly:

* ``depth_mismatch``: vertices whose depth (or reachability) differs,
  summed over the sampled traversals;
* ``level_mismatch``: the differences in levels, push levels and pull
  levels, summed over the sampled traversals.
"""
from __future__ import annotations

import torch


class Driver:
    algo = "bfs"

    def __init__(self, ctx):
        from repro_torch.core.traversal import INF_DEPTH, bfs

        self.ctx, mix = ctx, ctx.mix
        self.graph = ctx.load("drivers/_graph.py").GraphSetup(ctx)
        deg = self.graph.out_degree
        cand = torch.nonzero(deg > 0).squeeze(1)
        pick = torch.randperm(cand.numel(), generator=self.graph.fixed,
                              device=deg.device)[:int(mix["roots"])]
        roots = cand[pick]
        order = torch.cat([
            torch.randperm(roots.numel(), generator=self.graph.traffic,
                           device=deg.device)
            for _ in range(int(mix["passes"]))])
        #: the window's roots, call by call
        self.roots = roots[order].tolist()
        #: the warm-up root: the largest hub, whose traversal pushes and
        #: pulls
        self.warm_root = int(torch.argmax(deg))
        self.unreached = INF_DEPTH
        self.alpha = float(mix["alpha"])
        dg, bg = self.graph.dg, self.graph.bg
        kw = dict(alpha=self.alpha, schedule=mix["schedule"],
                  impl=mix["impl"])
        #: what the window drives: ``entry(root) -> (depth, levels,
        #: push_levels, pull_levels)``
        self.entry = lambda root: bfs(dg, bg, root, **kw)

    def warm(self):
        self._run(self.warm_root)

    def call(self, i: int):
        return self._run(self.roots[i % len(self.roots)])

    def _run(self, root: int):
        depth, levels, push, pull = self.entry(root)
        if depth.is_cuda:
            torch.cuda.synchronize()
        info = {"root": root, "levels": levels, "push_levels": push,
                "pull_levels": pull}
        return (root, depth, levels, push, pull), info

    def settle(self, answer, info: dict):
        """The benchmark's own count of what a traversal reached, made
        after its timed span."""
        reached = answer[1] != self.unreached
        info["edges"] = int((self.graph.out_degree * reached).sum())
        info["reached"] = int(reached.sum())

    def counters(self) -> dict:
        from repro_torch.obs.metrics import registry

        c = registry.counter("traversal.iterations")
        return {f"{d}_levels": c.value(algo="bfs", direction=d)
                for d in ("push", "pull")}

    def control(self):
        """The reference in the program's place, with an early exit that
        drops the traversal's tail levels."""
        ref = self.ctx.load("reference/bfs.py")
        rowptr, colidx = self.graph.on_device(self.ctx.device)
        cut = float(self.ctx.mix["control_tail_cut"])
        self.entry = lambda root: ref.bfs(
            rowptr, colidx, root, alpha=self.alpha,
            unreached=self.unreached, tail_cut=cut)

    def release(self):
        self.entry = None
        self.graph.release()

    def check(self, samples: list, infos: list) -> dict:
        ref = self.ctx.load("reference/bfs.py")
        rowptr, colidx = self.graph.on_device(self.ctx.device)
        deg = rowptr[1:] - rowptr[:-1]
        src = torch.repeat_interleave(
            torch.arange(deg.numel(), device=deg.device), deg,
            output_size=colidx.numel())
        depth_miss = level_miss = 0
        for _, (root, depth, levels, push, pull) in samples:
            d, lv, p, q = ref.bfs(rowptr, colidx, root, alpha=self.alpha,
                                  unreached=self.unreached, src=src)
            depth_miss += int((depth.to(d.device) != d).sum())
            level_miss += abs(levels - lv) + abs(push - p) + abs(pull - q)
        return {"depth_mismatch": depth_miss, "level_mismatch": level_miss}
