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
card unless ``--device`` names another device.  :func:`main` returns the
loss history.

Under ``torchrun`` (or with a process group already initialised) and more
than one rank, it trains data-parallel, as the reference's launcher does
on more than one device: ``make_mesh_for()`` builds a ("data", "model")
mesh of every rank, the token stream gives each rank its block of the
global batch (``--batch`` is the global batch), the Trainer averages the
gradients over the ranks, and rank 0 prints and writes the checkpoints::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 8 \
        -m repro_torch.launch.train --arch tinyllama-1.1b --full-config \
        --batch 64 --seq 512

The group is NCCL on the card (the device is ``cuda:LOCAL_RANK``) and
gloo with ``--device cpu``; NCCL that cannot start fails the run.  One
process without torchrun's environment runs alone, with no mesh.

Two setups the reference's launcher cannot feed either are refused with a
``ValueError``: ``--arch dimenet`` (its GNN setup builds ``cora_like``
without ``positions`` or triplets, ``t_kj``), and ``--arch bert4rec
--full-config`` (past 50,000 items the loss takes the sampled softmax,
whose ``mask_pos`` / ``negatives`` the cloze batches do not carry).
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.dist.elastic import make_mesh_for
from repro_torch.train.optim import adamw, cosine_schedule
from repro_torch.train.trainer import Trainer
from repro_torch.train.tree import tree_leaves

__all__ = ["main", "build_parser"]


def _generator(args) -> torch.Generator:
    return torch.Generator(device=args.device).manual_seed(args.seed)


def _lm_setup(cfg, args, mesh=None):
    from repro_torch.data.tokens import synthetic_lm_batches
    from repro_torch.models.transformer import init_params, loss_fn
    params = init_params(cfg, _generator(args), device=args.device)
    batches = synthetic_lm_batches(
        args.batch, args.seq, cfg.vocab, seed=args.seed,
        grad_accum=args.grad_accum if args.grad_accum > 1 else 0,
        device=args.device, mesh=mesh)
    return params, (lambda p, b: loss_fn(p, b, cfg)), batches


def _gnn_setup(cfg, args, mesh=None):
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


def _recsys_setup(cfg, args, mesh=None):
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


def _denominator(family: str, cfg):
    """batch → the count the family's loss divides by (a data-parallel
    step weighs the ranks' losses by it)."""
    if family == "lm":
        from repro_torch.models.transformer import loss_denominator
    elif family == "gnn":
        from repro_torch.models.gnn import loss_denominator
    else:
        from repro_torch.models.bert4rec import loss_denominator
    return lambda b: loss_denominator(b, cfg)


def _init_distributed(args) -> bool:
    """Join torchrun's process group when its environment names more than
    one rank (NCCL on the card, ``cuda:LOCAL_RANK``; gloo on the CPU);
    whether this call created the group (and so destroys it)."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return False
    if torch.device(args.device).type == "cuda":
        args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
        torch.cuda.set_device(args.device)
        dist.init_process_group("nccl", device_id=torch.device(args.device))
    else:
        dist.init_process_group("gloo")
    return True


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
    owned = _init_distributed(args)
    try:
        return _train(args)
    finally:
        if owned:
            dist.destroy_process_group()


def _train(args) -> list:
    mesh = None
    if dist.is_initialized() and dist.get_world_size() > 1:
        mesh = make_mesh_for()
    log = print if not dist.is_initialized() or dist.get_rank() == 0 \
        else (lambda *a, **k: None)
    spec = get_arch(args.arch)
    cfg = spec.make_model_cfg() if args.full_config else spec.make_smoke_cfg()
    log(f"arch={args.arch} family={spec.family} cfg={cfg}")
    params, loss_fn, batches = SETUPS[spec.family](cfg, args, mesh)
    n = sum(x.numel() for x in tree_leaves(params))
    log(f"params: {n/1e6:.2f}M" + (f" mesh={mesh}" if mesh else ""))

    trainer = Trainer(
        loss_fn=loss_fn,
        optimizer=adamw(cosine_schedule(args.lr, 20, args.steps)),
        ckpt_dir=args.ckpt_dir, ckpt_every=max(args.steps // 4, 10),
        grad_accum=args.grad_accum, mesh=mesh,
        denominator=_denominator(spec.family, cfg) if mesh else None)
    p, s = trainer.init_state(params)
    del params
    start = 0
    if args.ckpt_dir:
        p, s, start = trainer.maybe_restore(p, s)
        if start:
            log(f"resumed from step {start}")
    p, s, hist = trainer.run(p, s, batches, start_step=start,
                             num_steps=args.steps, log_every=args.log_every,
                             log_fn=log)
    if hist:
        log(f"done: loss {hist[0]['loss']:.4f} → {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
