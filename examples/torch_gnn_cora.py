"""Train GAT on a cora-like graph with the TOCAB aggregation backend, then
A/B the aggregation backends (flat segment-sum vs cache-blocked TOCAB), on
the PyTorch port (``repro_torch``).

    PYTHONPATH=src python examples/torch_gnn_cora.py [--device cpu]

On the card by default.  The TOCAB path is the slab engine (torch ops), so
autograd gives its gradient.
"""
import argparse
import time

import torch

from repro_torch.core import build_blocked
from repro_torch.data.graphs import cora_like
from repro_torch.models.gnn import (GNNConfig, gnn_forward, gnn_loss_fn,
                                    init_gnn)
from repro_torch.train.optim import adamw, constant_schedule
from repro_torch.train.trainer import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    g, batch = cora_like(n=2708, m=10556, d_feat=256, n_classes=7, seed=0,
                         device=dev)
    print(f"graph: |V|={g.n} |E|={g.m}")
    # TOCAB-blocked layout for the aggregation backend
    bg = build_blocked(g, block_size=512, device=dev)
    print(f"TOCAB: {bg.num_blocks} subgraphs")

    cfg = GNNConfig(arch="gat", n_layers=2, d_in=256, d_hidden=8,
                    n_classes=7, n_heads=8)
    params = init_gnn(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    opt = adamw(constant_schedule(5e-3))
    state = opt.init(params)
    step = make_train_step(lambda p, b: gnn_loss_fn(p, b, cfg, bg=bg), opt)

    t0 = time.perf_counter()
    for i in range(101):
        params, state, m = step(params, state, batch)
        if i % 20 == 0:
            print(f"step {i:3d} loss={float(m['loss']):.4f} "
                  f"acc={float(m['acc']):.3f}")
    print(f"101 steps in {time.perf_counter() - t0:.2f}s on {dev}")

    # backend A/B: same params, both aggregation paths
    with torch.no_grad():
        out_flat = gnn_forward(params, batch, cfg, bg=None)
        out_toc = gnn_forward(params, batch, cfg, bg=bg)
    print(f"agg backends max |Δ| = "
          f"{float((out_flat - out_toc).abs().max()):.2e} (TOCAB ≡ flat)")


if __name__ == "__main__":
    main()
