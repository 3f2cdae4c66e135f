"""Serve a BERT4Rec model with batched requests on the PyTorch port
(``repro_torch``): train briefly, then run online scoring (top-k over the
catalogue) and candidate retrieval.

    PYTHONPATH=src python examples/torch_serve_recsys.py [--device cpu]

On the card by default.  No hand-written kernel is on this path (the
encoder, the score matmul and the top-k are torch ops).  ``main`` returns
the losses, the served ids and the retrieval.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.data.recsys import synthetic_recsys_batches
from repro_torch.models.bert4rec import (bert4rec_loss_fn, bert4rec_retrieve,
                                         bert4rec_score, init_bert4rec)
from repro_torch.train.optim import adamw, constant_schedule
from repro_torch.train.trainer import make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = dataclasses.replace(get_arch("bert4rec").make_smoke_cfg(),
                              vocab=5000, max_len=50)
    params = init_bert4rec(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    opt = adamw(constant_schedule(1e-3))
    state = opt.init(params)
    gen = synthetic_recsys_batches(32, cfg.max_len, cfg.vocab, cfg.mask_id,
                                   device=dev)
    step = make_train_step(lambda p, b: bert4rec_loss_fn(p, b, cfg), opt)

    print("training…")
    losses = []
    for i in range(120):
        params, state, m = step(params, state, next(gen))
        losses.append(float(m["loss"]))
        if i % 30 == 0:
            print(f"  step {i:3d} ce={losses[-1]:.4f}")

    # --- batched online serving (serve_p99-style) ---
    def serve(p, items):
        with torch.no_grad():
            return bert4rec_score(p, items, cfg, top_k=10)

    batch = next(gen)["items"]
    vals, idx = serve(params, batch)  # warmup
    t0 = time.perf_counter()
    reps = 20
    for _ in range(reps):
        vals, idx = serve(params, batch)
        if vals.is_cuda:
            torch.cuda.synchronize(vals.device)
    dt = (time.perf_counter() - t0) / reps
    print(f"\nonline scoring: batch={batch.shape[0]} → top-10 of "
          f"{cfg.vocab} items in {dt*1e3:.1f} ms/batch")
    print(f"  sample recs for user 0: {idx[0].cpu().numpy()}")

    # --- retrieval against a candidate set (retrieval_cand-style) ---
    cands = torch.from_numpy(np.random.default_rng(0).choice(
        cfg.vocab, 2000, replace=False).astype(np.int32)).to(dev)
    with torch.no_grad():
        rv, ri = bert4rec_retrieve(params, batch[:1], cands, cfg, top_k=5)
    print(f"retrieval: top-5 of {len(cands)} candidates → ids "
          f"{ri.cpu().numpy()} (scores {np.round(rv.cpu().numpy(), 2)})")
    return {"losses": losses, "vocab": cfg.vocab, "top_vals": vals,
            "top_ids": idx, "ms_per_batch": dt * 1e3,
            "retrieval": (rv, ri), "candidates": cands}


if __name__ == "__main__":
    main()
