"""Serving launcher of the port: a batched-request LM loop (prefill, then
greedy decode with a KV cache) and the recsys scoring loop, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        [--full] [--requests 8] [--prompt-len 16] [--max-new 16] \
        [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch bert4rec \
        [--full] [--requests 8] [--device cuda]

The default is the arch's smoke config, as in the reference's launcher
(for bert4rec with ``vocab=5000``, as there); ``--full`` runs the published
config (random weights from a seed: the repo holds no checkpoint).

* :func:`serve_loop` is the LM loop itself, the same as the reference's:
  the prompt is prefilled by decode steps over its tokens, then each
  request decodes greedily; it returns the tokens and the timings and
  records the reference's ``serve.*`` metrics and ``serve.prefill`` /
  ``serve.decode`` spans.  Every step's attention runs on the
  ``flash_decode`` kernel on the card.
* :func:`score_loop` is the recsys loop: ``bert4rec_score`` (top-10 over
  the whole item table) on one batch of users, timed over ``reps`` calls,
  recording the reference's ``serve.score`` span,
  ``serve.score_seconds`` histogram and ``serve.users_per_s`` gauge.  No
  kernel of the port runs on it: scores, top-k and gathers are torch ops.

Not ported: the reference's retry / chaos wrapper around each batch step
(resilience, ROADMAP A6).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import registry as _obs

__all__ = ["ServeResult", "serve_loop", "serve_lm", "ScoreResult",
           "score_loop", "serve_recsys", "main"]


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor  # (B, max_new) greedy continuations
    prefill_seconds: float
    decode_seconds: float
    step_seconds: List[float]  # per greedy decode step
    total_seconds: float
    prompt_len: int

    @property
    def decode_steps(self) -> int:
        """serve_decode calls, the prefill's included."""
        return self.prompt_len - 1 + self.tokens.shape[1]

    @property
    def tokens_per_s(self) -> float:
        return self.tokens.shape[0] * (self.prompt_len + self.tokens.shape[1]
                                       ) / max(self.total_seconds, 1e-9)

    @property
    def decode_tokens_per_s(self) -> float:
        return self.tokens.numel() / max(self.decode_seconds, 1e-9)


def serve_loop(params: dict, prompts: torch.Tensor, cfg, max_new: int,
               cache_dtype=torch.bfloat16) -> ServeResult:
    """Serve ``prompts`` (B, P) int on their device: prefill the cache with
    decode steps over the first P-1 prompt tokens, then ``max_new`` greedy
    steps from the last one.  ``params`` as :func:`~repro_torch.models.
    transformer.serve_decode` takes them (a :func:`cast_params` copy on the
    serving path)."""
    from repro_torch.models import transformer as tfm

    B, P = prompts.shape
    if P < 1 or max_new < 1:
        raise ValueError("need a prompt token and one new token at least")
    horizon = P + max_new
    cache = tfm.init_cache(cfg, B, horizon, dtype=cache_dtype,
                           device=prompts.device)
    t0 = time.perf_counter()
    with obs_trace.span("serve.prefill", requests=B, prompt_len=P) as sp:
        for t in range(P - 1):
            _, cache = tfm.serve_decode(params, prompts[:, t:t + 1], t,
                                        cache, cfg)
        sp.block(cache.k)
    t_prefill = time.perf_counter() - t0
    _obs.histogram("serve.prefill_seconds",
                   "prompt prefill walltime per batch").observe(t_prefill)
    step_hist = _obs.histogram("serve.decode_seconds",
                               "per-token decode step walltime")
    generated, steps = [], []
    tok = prompts[:, -1:]
    t1 = time.perf_counter()
    with obs_trace.span("serve.decode", requests=B, max_new=max_new) as sp:
        for t in range(P - 1, P - 1 + max_new):
            td = time.perf_counter()
            logits, cache = tfm.serve_decode(params, tok, t, cache, cfg)
            tok = torch.argmax(logits, dim=-1)[:, None]
            obs_trace.synchronize(tok)
            steps.append(time.perf_counter() - td)
            step_hist.observe(steps[-1])
            generated.append(tok)
        sp.block(tok)
    t_decode = time.perf_counter() - t1
    result = ServeResult(
        tokens=torch.cat(generated, dim=1), prefill_seconds=t_prefill,
        decode_seconds=t_decode, step_seconds=steps,
        total_seconds=time.perf_counter() - t0, prompt_len=P)
    _obs.gauge("serve.tokens_per_s", "end-to-end serving throughput").set(
        result.tokens_per_s)
    _obs.gauge("serve.decode_tokens_per_s", "decode-phase throughput").set(
        result.decode_tokens_per_s)
    return result


def serve_lm(spec, args) -> ServeResult:
    """The reference's ``serve_lm`` on the port: random weights from seed
    0 on ``args.device``, prompts from numpy's ``default_rng(0)``."""
    from repro_torch.models import transformer as tfm

    cfg = spec.make_model_cfg() if args.full else spec.make_smoke_cfg()
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = tfm.cast_params(tfm.init_params(cfg, gen, device), cfg)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.requests, args.prompt_len))
    ).to(device)
    res = serve_loop(params, prompts, cfg, args.max_new)
    B = args.requests
    print(f"{cfg.name} on {device}: {B} requests × ({args.prompt_len} prompt "
          f"+ {args.max_new} new) in {res.total_seconds:.2f}s → "
          f"{res.tokens_per_s:.0f} tok/s (greedy); prefill "
          f"{res.prefill_seconds:.2f}s, decode "
          f"{1e3 * res.decode_seconds / args.max_new:.2f} ms/step")
    print("sample continuation (request 0):",
          res.tokens[0, :16].cpu().numpy())
    return res


@dataclasses.dataclass
class ScoreResult:
    scores: torch.Tensor  # (B, top_k) fp32, of the last rep
    ids: torch.Tensor  # (B, top_k) item ids, of the last rep
    rep_seconds: List[float]  # per scored batch

    @property
    def seconds_per_batch(self) -> float:
        return sum(self.rep_seconds) / len(self.rep_seconds)

    @property
    def users_per_s(self) -> float:
        return self.scores.shape[0] / max(self.seconds_per_batch, 1e-9)


def score_loop(params: dict, items: torch.Tensor, cfg, top_k: int = 10,
               reps: int = 20) -> ScoreResult:
    """Score the users ``items`` (B, L) int on their device against every
    item, ``reps`` times after one untimed call, each rep waited for: the
    reference's ``serve_recsys`` loop."""
    from repro_torch.models.bert4rec import bert4rec_score

    if reps < 1:
        raise ValueError("need one rep at least")
    vals, ids = bert4rec_score(params, items, cfg, top_k=top_k)
    obs_trace.synchronize(vals)
    hist = _obs.histogram("serve.score_seconds",
                          "recsys catalogue-scoring walltime per batch")
    reps_s = []
    with obs_trace.span("serve.score", requests=items.shape[0],
                        reps=reps) as sp:
        for _ in range(reps):
            tr = time.perf_counter()
            vals, ids = bert4rec_score(params, items, cfg, top_k=top_k)
            obs_trace.synchronize(vals)
            reps_s.append(time.perf_counter() - tr)
            hist.observe(reps_s[-1])
        sp.block(vals)
    result = ScoreResult(scores=vals, ids=ids, rep_seconds=reps_s)
    _obs.gauge("serve.users_per_s", "recsys scoring throughput").set(
        result.users_per_s)
    return result


def serve_recsys(spec, args) -> ScoreResult:
    """The reference's ``serve_recsys`` on the port: random weights from
    seed 0 on ``args.device``, ``args.requests`` users of random items from
    numpy's ``default_rng(0)``, top-10 over the table, 20 reps."""
    from repro_torch.models.bert4rec import init_bert4rec

    cfg = (spec.make_model_cfg() if args.full
           else dataclasses.replace(spec.make_smoke_cfg(), vocab=5000))
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_bert4rec(cfg, gen, device)
    rng = np.random.default_rng(0)
    items = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.requests, cfg.max_len)).astype(np.int32)
    ).to(device)
    res = score_loop(params, items, cfg, top_k=10, reps=20)
    print(f"{cfg.name} on {device}: scored {args.requests} users × "
          f"{cfg.vocab} items → top-10 in "
          f"{1e3 * res.seconds_per_batch:.1f} ms/batch "
          f"({res.users_per_s:.0f} users/s)")
    return res


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="where to serve (default: the card)")
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the smoke one")
    args = ap.parse_args(argv)
    spec = get_arch(args.arch)
    if spec.family == "lm":
        return serve_lm(spec, args)
    if spec.family == "recsys":
        return serve_recsys(spec, args)
    raise SystemExit(f"{args.arch} ({spec.family}) has no serving mode")


if __name__ == "__main__":
    main()
