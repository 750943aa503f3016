"""Kimi K2 — trillion-parameter MoE (paper-table spec).

[arXiv:2501.kimi2] — 61L, d_model=7168, 64 heads (GQA kv=8), per-expert
FFN d_ff=2048, vocab=163840, 384 experts top-8.
"""

from repro_torch.configs.base import ArchConfig, LayerSpec, MoESpec, register

KIMI_K2 = register(
    ArchConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        d_ff=2048,
        vocab=163840,
        pattern=(LayerSpec(kind="attn", moe=True),),
        moe=MoESpec(n_experts=384, top_k=8, d_expert=2048),
        head_dim=112,  # 7168 / 64
        source="arXiv:2501.kimi2",
    )
)
