"""The five LM-family transformer configs (exact literature specs), as the
reference's ``configs/lm_archs.py`` gives them.

Per-arch ``long_500k`` policy: pure global-attention archs skip it; Mixtral
(SWA) and Gemma-2 (local/global alternating) run it.  The MoE configs
(Granite, Mixtral) run through ``models/moe.py``.
"""
from __future__ import annotations

from repro_torch.models.transformer import TransformerCfg

from .base import LM_SHAPES, ArchSpec

__all__ = ["LM_ARCHS"]


def _granite():
    # [hf:ibm-granite/granite-3.0-*-base] 40 experts, top-8
    return TransformerCfg(
        name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
        n_kv_heads=8, head_dim=64, d_ff=512, vocab=49155,
        mlp_kind="swiglu", num_experts=40, top_k=8, layer_pattern="global",
    )


def _granite_smoke():
    return TransformerCfg(
        name="granite-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=32, vocab=512, mlp_kind="swiglu",
        num_experts=8, top_k=2, remat=False,
    )


def _mixtral():
    # [arXiv:2401.04088] 8 experts top-2; SWA (window 4096)
    return TransformerCfg(
        name="mixtral-8x22b", n_layers=56, d_model=6144, n_heads=48,
        n_kv_heads=8, head_dim=128, d_ff=16384, vocab=32768,
        mlp_kind="swiglu", num_experts=8, top_k=2,
        layer_pattern="window", window=4096, rope_theta=1e6,
    )


def _mixtral_smoke():
    return TransformerCfg(
        name="mixtral-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=4,
        head_dim=8, d_ff=128, vocab=512, mlp_kind="swiglu",
        num_experts=4, top_k=2, layer_pattern="window", window=16, remat=False,
    )


def _tinyllama():
    # [arXiv:2401.02385] llama2-arch small
    return TransformerCfg(
        name="tinyllama-1.1b", n_layers=22, d_model=2048, n_heads=32,
        n_kv_heads=4, head_dim=64, d_ff=5632, vocab=32000,
        mlp_kind="swiglu", layer_pattern="global",
    )


def _tinyllama_smoke():
    return TransformerCfg(
        name="tinyllama-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=176, vocab=512,
        mlp_kind="swiglu", remat=False,
    )


def _gemma7b():
    # [arXiv:2403.08295] GeGLU, head_dim=256, 16 q heads / 16 kv heads
    return TransformerCfg(
        name="gemma-7b", n_layers=28, d_model=3072, n_heads=16,
        n_kv_heads=16, head_dim=256, d_ff=24576, vocab=256000,
        mlp_kind="geglu", norm_plus_one=True, embed_scale=True,
        layer_pattern="global",
    )


def _gemma7b_smoke():
    return TransformerCfg(
        name="gemma-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=256, vocab=512, mlp_kind="geglu",
        norm_plus_one=True, embed_scale=True, remat=False,
    )


def _gemma2_27b():
    # [arXiv:2408.00118] local(4096)+global alternating, logit softcaps,
    # query scale = (d_model/n_heads)^-0.5 = 144^-0.5
    return TransformerCfg(
        name="gemma2-27b", n_layers=46, d_model=4608, n_heads=32,
        n_kv_heads=16, head_dim=128, d_ff=36864, vocab=256000,
        mlp_kind="geglu", norm_plus_one=True, embed_scale=True,
        layer_pattern="alternating", window=4096,
        attn_softcap=50.0, final_softcap=30.0,
        attn_scale=(4608 / 32) ** -0.5,
    )


def _gemma2_smoke():
    return TransformerCfg(
        name="gemma2-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=256, vocab=512, mlp_kind="geglu",
        norm_plus_one=True, embed_scale=True, layer_pattern="alternating",
        window=16, attn_softcap=50.0, final_softcap=30.0, remat=False,
    )


LM_ARCHS = {
    "granite-moe-3b-a800m": ArchSpec(
        "granite-moe-3b-a800m", "lm", _granite, _granite_smoke, LM_SHAPES,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
        skip_shapes=("long_500k",),
        notes="pure global attention → long_500k skipped per assignment"),
    "mixtral-8x22b": ArchSpec(
        "mixtral-8x22b", "lm", _mixtral, _mixtral_smoke, LM_SHAPES,
        source="arXiv:2401.04088",
        notes="SWA(4096) bounds decode KV → long_500k runs with ring cache"),
    "tinyllama-1.1b": ArchSpec(
        "tinyllama-1.1b", "lm", _tinyllama, _tinyllama_smoke, LM_SHAPES,
        source="arXiv:2401.02385", skip_shapes=("long_500k",),
        notes="pure global attention → long_500k skipped per assignment"),
    "gemma-7b": ArchSpec(
        "gemma-7b", "lm", _gemma7b, _gemma7b_smoke, LM_SHAPES,
        source="arXiv:2403.08295", skip_shapes=("long_500k",),
        notes="pure global attention → long_500k skipped per assignment"),
    "gemma2-27b": ArchSpec(
        "gemma2-27b", "lm", _gemma2_27b, _gemma2_smoke, LM_SHAPES,
        source="arXiv:2408.00118",
        notes="alternating local/global: local ring cache + global full KV"),
}
