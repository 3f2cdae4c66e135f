"""Training launcher of the port: ``--arch`` selects any architecture and
runs real training through the port's path — the step factory,
checkpointing, restart and the watchdog (the reference's
``launch/train.py``, with its flags, plus ``--device`` and
``--log-every``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 100 [--full-config] [--ckpt-dir DIR] [--grad-accum 2] \\
        [--device cpu]

Smoke configs by default; ``--full-config`` takes the published one (on
the card: TinyLlama-1.1B trains there at batch 8 × 512).  It runs on the
card unless ``--device`` names another device, on one device (no mesh:
distribution is ROADMAP A12).  :func:`main` returns the loss history.

Two setups the reference's launcher cannot feed either are refused with a
``ValueError``: ``--arch dimenet`` (its GNN setup builds ``cora_like``
without ``positions`` or triplets, ``t_kj``), and ``--arch bert4rec
--full-config`` (past 50,000 items the loss takes the sampled softmax,
whose ``mask_pos`` / ``negatives`` the cloze batches do not carry).
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_arch
from repro_torch.train.optim import adamw, cosine_schedule
from repro_torch.train.trainer import Trainer
from repro_torch.train.tree import tree_leaves

__all__ = ["main", "build_parser"]


def _generator(args) -> torch.Generator:
    return torch.Generator(device=args.device).manual_seed(args.seed)


def _lm_setup(cfg, args):
    from repro_torch.data.tokens import synthetic_lm_batches
    from repro_torch.models.transformer import init_params, loss_fn
    params = init_params(cfg, _generator(args), device=args.device)
    batches = synthetic_lm_batches(
        args.batch, args.seq, cfg.vocab, seed=args.seed,
        grad_accum=args.grad_accum if args.grad_accum > 1 else 0,
        device=args.device)
    return params, (lambda p, b: loss_fn(p, b, cfg)), batches


def _gnn_setup(cfg, args):
    from repro_torch.data.graphs import cora_like
    from repro_torch.models.gnn import gnn_loss_fn, init_gnn
    if cfg.arch == "dimenet":
        raise ValueError(
            "--arch dimenet: the GNN setup builds cora_like without "
            "positions or triplets (t_kj, t_ji), which dimenet needs; the "
            "reference's launcher fails there too. Train DimeNet on "
            "data.graphs.molecule_batch() through train.trainer instead")
    cfg = dataclasses.replace(cfg, d_in=32)
    g, batch = cora_like(n=2048, m=8192, d_feat=32, n_classes=cfg.n_classes,
                         seed=args.seed, device=args.device)
    params = init_gnn(_generator(args), cfg, device=args.device)

    def batches():
        while True:
            yield batch

    return params, (lambda p, b: gnn_loss_fn(p, b, cfg)), batches()


def _recsys_setup(cfg, args):
    from repro_torch.data.recsys import synthetic_recsys_batches
    from repro_torch.models.bert4rec import bert4rec_loss_fn, init_bert4rec
    if cfg.sampled_softmax:
        raise ValueError(
            f"--arch bert4rec at {cfg.vocab} items trains on the sampled "
            "softmax, whose batches carry mask_pos, pos_labels, pos_weight "
            "and negatives; the cloze batches of data.recsys carry none "
            "(the reference's launcher fails there too). Use the smoke "
            "config, or build such batches and call train.trainer")
    params = init_bert4rec(cfg, _generator(args), device=args.device)
    batches = synthetic_recsys_batches(args.batch, cfg.max_len, cfg.vocab,
                                       cfg.mask_id, seed=args.seed,
                                       device=args.device)
    return params, (lambda p, b: bert4rec_loss_fn(p, b, cfg)), batches


SETUPS = {"lm": _lm_setup, "gnn": _gnn_setup, "recsys": _recsys_setup}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full literature config")
    ap.add_argument("--device", default="cuda",
                    help="where params and batches live (default: the card)")
    ap.add_argument("--log-every", type=int, default=10,
                    help="history and log line every N steps (and the last)")
    return ap


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    spec = get_arch(args.arch)
    cfg = spec.make_model_cfg() if args.full_config else spec.make_smoke_cfg()
    print(f"arch={args.arch} family={spec.family} cfg={cfg}")
    params, loss_fn, batches = SETUPS[spec.family](cfg, args)
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"params: {n/1e6:.2f}M")

    trainer = Trainer(
        loss_fn=loss_fn,
        optimizer=adamw(cosine_schedule(args.lr, 20, args.steps)),
        ckpt_dir=args.ckpt_dir, ckpt_every=max(args.steps // 4, 10),
        grad_accum=args.grad_accum)
    p, s = trainer.init_state(params)
    del params
    start = 0
    if args.ckpt_dir:
        p, s, start = trainer.maybe_restore(p, s)
        if start:
            print(f"resumed from step {start}")
    p, s, hist = trainer.run(p, s, batches, start_step=start,
                             num_steps=args.steps, log_every=args.log_every)
    if hist:
        print(f"done: loss {hist[0]['loss']:.4f} → {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
