#!/usr/bin/env python3
"""Variants of the port's tensor-core flash-attention kernel, built and
timed side by side on one card: what the design choices of
``src/repro_torch/kernels/flash_attention/csrc/flash_attention_wgmma.cu``
are worth at the LM's prefill shape (8 × 32 × 2048 × 64, causal, GQA 8,
bf16), beside ``scaled_dot_product_attention``.

    python3 benchmarks/torch_attention_variants.py    # on the card, ~1 min

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
  phases (the counters cost a few per cent).

One JSON line per variant: ms per call (CUDA events, mean of 20 after 3
warm-ups), TFLOP/s of the causal work, the largest share of the bf16
tolerance ``chip_smoke.py`` holds the kernel to (rtol 2⁻⁷, atol 2⁻⁶ of the
mean |entry|, against the fp32 plain version), and for ``phases`` each
phase's share of the summed warpgroup time.  The card's name and power
limit come first.  Fails if there is no card, or if the source no longer
has the text an edit targets.
"""
from __future__ import annotations

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


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_attention_variants: no CUDA device", file=sys.stderr)
        return 3
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import attention_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    src = cuda_build._source("flash_attention_wgmma").read_text()
    work = Path(tempfile.mkdtemp(prefix="attn_variants_"))
    procs = {}
    for name, text in variants(src).items():
        (work / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build._NVCC_FLAGS, "-o",
             str(work / f"lib{name}.so"), str(work / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(work / f"lib{name}.so"))
        for fn, (argtypes, restype) in K._WGMMA_SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    B, H, Hk, S, D = 8, 32, 4, 2048, 64
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for shape in ((B, H, S, D), (B, Hk, S, D),
                                      (B, Hk, S, D)))
    ref = attention_ref(q, k, v, causal=True).float()
    atol = 2.0 ** -6 * float(ref.abs().mean())
    flops = 4 * B * H * S * S * D / 2

    def call(lib):
        out = torch.empty_like(q)
        rc = lib.flash_attention_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *K._strides(q), *K._strides(k), *K._strides(v),
            *K._strides(out), B, H, Hk, S, S, D, D ** -0.5, 1, 0, 0.0,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out

    def ms(fn, reps=20, warmup=3):
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

    sdpa = ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    print(json.dumps({"variant": "sdpa", "ms": sdpa,
                      "tflops": flops / sdpa / 1e9}), flush=True)
    for name, lib in libs.items():
        out = call(lib).float()
        torch.cuda.synchronize()
        share = float(((out - ref).abs()
                       / (atol + 2.0 ** -7 * ref.abs())).max())
        t = ms(lambda: call(lib))
        rec = {"variant": name, "ms": t, "tflops": flops / t / 1e9,
               "tolerance_share": share}
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
