#!/usr/bin/env python3
"""Variants of the port's tensor-core flash-attention kernels, built and
timed side by side on one card: what the design choices of
``src/repro_torch/kernels/flash_attention/csrc/flash_attention_wgmma.cu``
are worth at the LM's prefill shape (8 × 32 × 2048 × 64, causal, GQA 8,
bf16), beside ``scaled_dot_product_attention``; and the backward's designs
at TinyLlama's training shape (8 × 32/4 × 512 × 64, causal) and a
Gemma-2-27B local layer (1 × 32/16 × 4608 × 128, window 4096, softcap 50).

    python3 benchmarks/torch_attention_variants.py    # on the card, ~1 min
    python3 benchmarks/torch_attention_variants.py --part bwd
    python3 benchmarks/torch_attention_variants.py --part fwd \
        --previous-forward prev.cu   # an earlier flash_attention_wgmma.cu

Each variant is the source with one edit, made in a temporary directory
(the repository's file is not touched), built with the loader's ``nvcc``
flags and called through the same C entry point:

* ``as_is`` — the source;
* ``p_rounded`` — P rounded to bf16 once, one P V product (no P_lo);
* ``p_cvt_split`` — the P_hi / P_lo split with float-to-bf16 conversions
  instead of truncation and byte permutes;
* ``one_cta_per_sm`` — head dim 64 built for one CTA an SM (up to 255
  registers) instead of two;
* ``softmax_pinned`` — with a shared-memory store of the row sums just
  before the P V wait, which keeps ptxas from scheduling the softmax after
  that wait;
* ``warpgroup_turns`` — with the two warpgroups taking turns to issue
  their products (named barriers 3 and 4, warpgroup 0 first);
* ``phases`` — ``as_is`` with ``clock64`` counters around the main loop's
  phases (the counters cost a few per cent);
* ``previous_forward`` (with ``--previous-forward PATH``) — an earlier
  version of the source whose C entry has no ``lse`` argument (as in
  ``git show f7b7446:src/repro_torch/kernels/flash_attention/csrc/
  flash_attention_wgmma.cu``), built beside the others; its line says
  whether its output has the same bits as ``as_is``'s.

One JSON line per variant: ms per call (CUDA events, mean of 20 after 3
warm-ups), TFLOP/s of the causal work, the largest share of the bf16
tolerance ``chip_smoke.py`` holds the kernel to (rtol 2⁻⁷, atol 2⁻⁶ of the
mean |entry|, against the fp32 plain version), and for ``phases`` each
phase's share of the summed warpgroup time.

The backward (``--part bwd``), one JSON line per design and shape:

* ``bwd_fma`` — the PR 23 kernel, ``flash_attention_bwd.cu`` (FP32 FMA,
  contiguous operands), through the package's launcher;
* ``bwd_wgmma`` — ``flash_attention_bwd_wgmma.cu`` as it is (P and dS
  rounded to bf16 once), with the device ms of each of its two kernels
  from ``torch.profiler``;
* ``bwd_wgmma_split`` — the same with ``kSplit = true`` (P and dS fed to
  the tensor cores as bf16 hi + lo);
* ``bwd_dq_2cta`` / ``bwd_dkdv_3cta`` — the same with ``dq_kernel`` built
  for two CTAs an SM (at most 128 registers a thread) / ``dkdv_kernel``
  for three (at most 168);
* ``bwd_sdpa`` — SDPA's backward alone (``torch.autograd.grad`` of a
  retained forward), at TinyLlama's shape only: SDPA has no softcap.

Each with ms per call, TFLOP/s of 2.5× the forward's causal flops, and the
largest of dq's, dk's and dv's max |error| over their largest magnitude
against torch autograd of the fp32 plain version (``chip_smoke.py``'s
bound is 2⁻⁷).  The card's name and power limit come first.  Fails if
there is no card, or if a source no longer has the text an edit targets.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: the loop's phases, in the order of the counters the ``phases`` edit adds
PHASES = ("wait_k", "issue_products", "wait_s", "softmax", "wait_pv",
          "rescale_split_refill", "last_pv", "cta_start")

_SPLIT_TRUNC = """\
      const uint32_t ab = __float_as_uint(a), cb = __float_as_uint(c);
      p_hi[kk][r] = __byte_perm(ab, cb, 0x7632);  // upper halves: c | a
      const float la = a - __uint_as_float(ab & 0xffff0000u);
      const float lc = c - __uint_as_float(cb & 0xffff0000u);
      p_lo[kk][r] =
          __byte_perm(__float_as_uint(la), __float_as_uint(lc), 0x7632);
"""
_SPLIT_CVT = """\
      const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
      const float2 hf = __bfloat1622float2(hi);
      p_hi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
      p_lo[kk][r] = pack_bf16(a - hf.x, c - hf.y);
"""

_PIN_EDITS = (
    ("      bar_empty[kStages];\n",
     "      bar_empty[kStages];\n  __shared__ volatile float pin[kThreads];\n"),
    ("    wgmma_wait<0>();  // P V of tile it - 1\n",
     "    pin[tid] = st.l0 + st.l1;\n"
     "    wgmma_wait<0>();  // P V of tile it - 1\n"),
)

_TURN_EDITS = (
    ("  for (int it = 1; it < n_tiles; ++it) {\n",
     "  if (cw == 1) asm volatile(\"bar.arrive 3, 256;\\n\" ::: \"memory\");\n"
     "  for (int it = 1; it < n_tiles; ++it) {\n"),
    ("    mbar_wait(&bar_k[it % kStages], phase(it));\n",
     "    mbar_wait(&bar_k[it % kStages], phase(it));\n"
     "    asm volatile(\"bar.sync %0, 256;\\n\" ::\"r\"(3 + cw) : \"memory\");\n"),
    ("tile_v(it - 1));\n",
     "tile_v(it - 1));\n"
     "    asm volatile(\"bar.arrive %0, 256;\\n\" ::\"r\"(4 - cw) : \"memory\");\n"),
    ("  if (n_tiles > 0) {\n    const int it = n_tiles - 1;\n",
     "  if (cw == 0) asm volatile(\"bar.sync 3, 256;\\n\" ::: \"memory\");\n"
     "  if (n_tiles > 0) {\n    const int it = n_tiles - 1;\n"),
)

_PHASE_EDITS = (
    ("namespace {\n",
     "__device__ unsigned long long g_phase[8];\n"
     "extern \"C\" int phases_read(unsigned long long* h) {\n"
     "  return cudaMemcpyFromSymbol(h, g_phase, 64);\n}\n"
     "namespace {\n"),
    ("  const int tid = threadIdx.x;\n  const int qt =",
     "  const long long c_start = clock64();\n"
     "  const int tid = threadIdx.x;\n  const int qt ="),
    ("  for (int it = 1; it < n_tiles; ++it) {\n",
     "  unsigned long long pt[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  long long c_a = clock64(), c_b;\n  pt[7] += c_a - c_start;\n"
     "  for (int it = 1; it < n_tiles; ++it) {\n    c_a = clock64();\n"),
    ("    mbar_wait(&bar_k[it % kStages], phase(it));\n",
     "    mbar_wait(&bar_k[it % kStages], phase(it));\n"
     "    c_b = clock64(); pt[0] += c_b - c_a; c_a = c_b;\n"),
    ("    wgmma_wait<1>();  // S of tile it\n    fence_regs(s);\n",
     "    c_b = clock64(); pt[1] += c_b - c_a; c_a = c_b;\n"
     "    wgmma_wait<1>();  // S of tile it\n    fence_regs(s);\n"
     "    c_b = clock64(); pt[2] += c_b - c_a; c_a = c_b;\n"),
    ("    wgmma_wait<0>();  // P V of tile it - 1\n"
     "    fence_regs(st.acc);\n",
     "    c_b = clock64(); pt[3] += c_b - c_a; c_a = c_b;\n"
     "    wgmma_wait<0>();  // P V of tile it - 1\n"
     "    fence_regs(st.acc);\n"
     "    c_b = clock64(); pt[4] += c_b - c_a; c_a = c_b;\n"),
    ("    if (tid == 0) refill(false);\n    __syncwarp();\n  }\n",
     "    if (tid == 0) refill(false);\n    __syncwarp();\n"
     "    c_b = clock64(); pt[5] += c_b - c_a; c_a = c_b;\n  }\n"
     "  c_a = clock64();\n"),
    ("  // epilogue: l over the row's 4 lanes",
     "  pt[6] += clock64() - c_a;\n"
     "  if (t == 0)\n"
     "    for (int i = 0; i < 8; ++i) atomicAdd(&g_phase[i], pt[i]);\n"
     "  // epilogue: l over the row's 4 lanes"),
)


def _edit(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"the source no longer has {old[:60]!r}")
        src = src.replace(old, new, 1)
    return src


#: the backward's shapes: (B, Hq, Hkv, S, D, kw, q scale)
BWD_SHAPES = {
    "tinyllama": (8, 32, 4, 512, 64, dict(causal=True), 1.0),
    "gemma2_27b_local": (1, 32, 16, 4608, 128,
                         dict(causal=True, window=4096, softcap=50.0,
                              scale=(4608 / 32) ** -0.5), 16.0),
}


_DQ_BOUNDS = "__global__ void __launch_bounds__(256, 1)\ndq_kernel"
_KV_BOUNDS = "__global__ void __launch_bounds__(128, 1)\ndkdv_kernel"


def bwd_variants(src: str) -> dict:
    """The tensor-core backward's source as it is, with P and dS split
    into bf16 halves, and with each kernel built for more CTAs an SM."""
    return {
        "bwd_wgmma": src,
        "bwd_wgmma_split": _edit(src, (
            ("constexpr bool kSplit = false;",
             "constexpr bool kSplit = true;"),
        )),
        "bwd_dq_2cta": _edit(src, (
            (_DQ_BOUNDS, _DQ_BOUNDS.replace("(256, 1)", "(256, 2)")),)),
        "bwd_dkdv_3cta": _edit(src, (
            (_KV_BOUNDS, _KV_BOUNDS.replace("(128, 1)", "(128, 3)")),)),
    }


def _build(texts: dict, work: Path, nvcc_cmd) -> dict:
    """Every ``{name: source}`` built at once into ``work``; ``{name:
    library path}``."""
    procs = {}
    for name, text in texts.items():
        (work / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [*nvcc_cmd, "-o", str(work / f"lib{name}.so"),
             str(work / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
    return {name: work / f"lib{name}.so" for name in texts}


def variants(src: str) -> dict:
    return {
        "as_is": src,
        "p_rounded": _edit(src, (
            ("    wgmma_rs<D>(acc, p_lo[kk], dv);\n", ""),)),
        "p_cvt_split": _edit(src, ((_SPLIT_TRUNC, _SPLIT_CVT),)),
        "one_cta_per_sm": _edit(src, (
            ("kMinBlocks = D == 64 ? 2 : 1;", "kMinBlocks = 1;"),)),
        "softmax_pinned": _edit(src, _PIN_EDITS),
        "warpgroup_turns": _edit(src, _TURN_EDITS),
        "phases": _edit(src, _PHASE_EDITS),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("fwd", "bwd", "all"), default="all")
    ap.add_argument("--previous-forward", type=Path, default=None,
                    help="an earlier flash_attention_wgmma.cu (no lse "
                         "argument) to hold the forward's bits against")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("torch_attention_variants: no CUDA device", file=sys.stderr)
        return 3
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import kernel as K

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    fwd_src = cuda_build._source("flash_attention_wgmma")
    bwd_src = cuda_build._source("flash_attention_bwd_wgmma")
    texts = {}
    if args.part in ("fwd", "all"):
        texts.update(variants(fwd_src.read_text()))
        if args.previous_forward is not None:
            texts["previous_forward"] = args.previous_forward.read_text()
    if args.part in ("bwd", "all"):
        texts.update(bwd_variants(bwd_src.read_text()))
    work = Path(tempfile.mkdtemp(prefix="attn_variants_"))
    # the copies include the headers beside the package's sources
    paths = _build(texts, work, [cuda_build._nvcc(), *cuda_build._NVCC_FLAGS,
                                 "-I", str(fwd_src.parent)])
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        sigs = K._BWD_WGMMA_SIGNATURES if name.startswith("bwd") \
            else K._WGMMA_SIGNATURES
        if name == "previous_forward":  # the entry without the lse pointer
            argtypes, restype = sigs["flash_attention_wgmma"]
            sigs = dict(sigs, flash_attention_wgmma=(argtypes[:4]
                                                     + argtypes[5:], restype))
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    if args.part in ("fwd", "all"):
        forward(torch, K, {n: lib for n, lib in libs.items()
                           if not n.startswith("bwd")})
    if args.part in ("bwd", "all"):
        backward(torch, K, {n: lib for n, lib in libs.items()
                            if n.startswith("bwd")})
    return 0


def _ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def forward(torch, K, libs):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    B, H, Hk, S, D = 8, 32, 4, 2048, 64
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for shape in ((B, H, S, D), (B, Hk, S, D),
                                      (B, Hk, S, D)))
    ref = attention_ref(q, k, v, causal=True).float()
    atol = 2.0 ** -6 * float(ref.abs().mean())
    flops = 4 * B * H * S * S * D / 2

    def call(lib, lse=True):
        out = torch.empty_like(q)
        rc = lib.flash_attention_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *([None] if lse else []), *K._strides(q), *K._strides(k),
            *K._strides(v), *K._strides(out), B, H, Hk, S, S, D, D ** -0.5,
            1, 0, 0.0,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out

    def ms(fn):
        return _ms(torch, fn)

    sdpa = ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    print(json.dumps({"variant": "sdpa", "ms": sdpa,
                      "tflops": flops / sdpa / 1e9}), flush=True)
    for name, lib in libs.items():
        has_lse = name != "previous_forward"
        raw = call(lib, has_lse)
        out = raw.float()
        torch.cuda.synchronize()
        share = float(((out - ref).abs()
                       / (atol + 2.0 ** -7 * ref.abs())).max())
        t = ms(lambda: call(lib, has_lse))
        rec = {"variant": name, "ms": t, "tflops": flops / t / 1e9,
               "tolerance_share": share}
        if not has_lse:
            rec["bit_equal_to_as_is"] = bool(torch.equal(
                raw, call(libs["as_is"])))
        if name == "phases":
            lib.phases_read.argtypes = [ctypes.c_void_p]
            call(lib)  # the counters only add: one more call, then read
            torch.cuda.synchronize()
            counts = (ctypes.c_ulonglong * 8)()
            lib.phases_read(ctypes.addressof(counts))
            before = list(counts)
            call(lib)
            torch.cuda.synchronize()
            lib.phases_read(ctypes.addressof(counts))
            delta = [a - b for a, b in zip(counts, before)]
            rec["phase_share"] = {p: d / sum(delta)
                                  for p, d in zip(PHASES, delta)}
        print(json.dumps(rec), flush=True)


def backward(torch, K, libs):
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention.ref import attention_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for shape, (B, Hq, Hkv, S, D, kw, qmul) in BWD_SHAPES.items():
        def rand(*dims, mul=1.0):
            return (torch.randn(dims, generator=gen, device=dev) * mul).to(
                torch.bfloat16)

        q = rand(B, Hq, S, D, mul=qmul)
        k, v, dout = rand(B, Hkv, S, D), rand(B, Hkv, S, D), rand(B, Hq, S, D)
        out, lse = K.flash_attention_wgmma_cuda(q, k, v, return_lse=True,
                                                **kw)
        # the fp32 oracle, one KV head's query group at a time
        g = Hq // Hkv
        oracle = [torch.empty(t.shape, device=dev) for t in (q, k, v)]
        for h in range(Hkv):
            leaves = [t.detach().float().requires_grad_() for t in (
                q[:, h * g:(h + 1) * g], k[:, h:h + 1], v[:, h:h + 1])]
            attention_ref(*leaves, **kw).backward(
                dout[:, h * g:(h + 1) * g].float())
            oracle[0][:, h * g:(h + 1) * g] = leaves[0].grad
            oracle[1][:, h:h + 1] = leaves[1].grad
            oracle[2][:, h:h + 1] = leaves[2].grad
            del leaves
        flops = 2.5 * 4 * B * Hq * S * S * D / 2

        def worst(grads):
            return max(float((a.float() - r).abs().max())
                       / float(r.abs().max()) for a, r in zip(grads, oracle))

        def wgmma_call(lib):
            dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=dev)
                          for t in (q, k, v))
            rows = lib.flash_attention_bwd_wgmma_rows(S)
            scratch = torch.empty(B * Hq * rows * 2, device=dev)
            rc = lib.flash_attention_bwd_wgmma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), scratch.data_ptr(),
                *K._strides(q), *K._strides(k), *K._strides(v),
                *K._strides(out), *K._strides(dout), B, Hq, Hkv, S, S, D,
                float(kw.get("scale", D ** -0.5)), int(kw["causal"]),
                int(kw.get("window", 0)), float(kw.get("softcap", 0.0)),
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            return dq, dk, dv

        calls = {"bwd_fma": lambda: K.flash_attention_bwd_cuda(
            q, k, v, out, dout, **kw)}
        for name, lib in libs.items():
            calls[name] = (lambda lib=lib: wgmma_call(lib))
        for name, fn in calls.items():
            err = worst(fn())
            t = _ms(torch, fn, reps=5 if name == "bwd_fma" else 20,
                    warmup=1 if name == "bwd_fma" else 3)
            rec = {"variant": name, "shape": shape, "ms": t,
                   "tflops": flops / t / 1e9, "rel_of_max": err}
            if name == "bwd_wgmma":
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                rec["device_ms_by_kernel"] = {
                    e.key[:60]: e.device_time_total / 1e3
                    for e in prof.key_averages() if e.device_time_total > 0}
            print(json.dumps(rec), flush=True)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        sdpa_kw = dict(is_causal=True, enable_gqa=True)
        if kw.get("window") or kw.get("softcap"):
            sdpa_kw = None  # SDPA has neither a window nor a cap
        if sdpa_kw is not None:
            o = F.scaled_dot_product_attention(*leaves, **sdpa_kw)
            t = _ms(torch, lambda: torch.autograd.grad(
                o, leaves, dout, retain_graph=True))
            print(json.dumps({"variant": "bwd_sdpa", "shape": shape,
                              "ms": t, "tflops": flops / t / 1e9}),
                  flush=True)
        del q, k, v, dout, out, lse, oracle, leaves
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
