"""End-to-end driver on the PyTorch port (``repro_torch``): train a
~100M-param LM for a few hundred steps.

Scaled-down tinyllama family (the production configs' code path: AdamW,
checkpointing, straggler watchdog).  Its attention is bf16 at head dim
64, so on the card every layer's forward runs the tensor-core
``flash_attention`` kernel and its backward ``flash_attention_bwd_wgmma``.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--dim 512] \\
        [--device cpu]

On the card by default.  Run it again with the same ``--ckpt-dir`` and
more ``--steps`` and it resumes from its last checkpoint.  ``main``
returns the logged history and the step it started from.
"""
import argparse
import tempfile

import torch

from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.models.transformer import (TransformerCfg, init_params,
                                            loss_fn, param_count)
from repro_torch.train.optim import adamw, cosine_schedule
from repro_torch.train.trainer import Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = TransformerCfg(
        name="lm-100m", n_layers=args.layers, d_model=args.dim,
        n_heads=args.dim // 64, n_kv_heads=max(1, args.dim // 128),
        head_dim=64, d_ff=args.dim * 11 // 4, vocab=8192,
        mlp_kind="swiglu", remat=False)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    n_params = param_count(params)
    print(f"model: {n_params/1e6:.1f}M params")

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="lm_ckpt_")
    trainer = Trainer(
        loss_fn=lambda p, b: loss_fn(p, b, cfg),
        optimizer=adamw(cosine_schedule(3e-4, 20, args.steps)),
        ckpt_dir=ckpt_dir, ckpt_every=100)
    p, s = trainer.init_state(params)
    p, s, start = trainer.maybe_restore(p, s)
    if start:
        print(f"resumed from step {start}")
    batches = synthetic_lm_batches(args.batch, args.seq, cfg.vocab, seed=1,
                                   device=dev)
    p, s, hist = trainer.run(p, s, batches, start_step=start,
                             num_steps=args.steps, log_every=25)
    if hist:
        print(f"\nloss {hist[0]['loss']:.3f} → {hist[-1]['loss']:.3f}; "
              f"checkpoints in {ckpt_dir}")
    if trainer.watchdog.flagged:
        print(f"straggler steps flagged: {trainer.watchdog.flagged[:5]}")
    return {"history": hist, "start": start, "steps": args.steps,
            "layers": cfg.n_layers, "params": n_params,
            "ckpt_dir": ckpt_dir}


if __name__ == "__main__":
    main()
