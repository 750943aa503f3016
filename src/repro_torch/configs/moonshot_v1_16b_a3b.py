"""Moonlight-16B-A3B (Moonshot) fine-grained MoE.

[hf:moonshotai/Moonlight-16B-A3B] — 48L, d_model=2048, 16 heads (kv=16),
per-expert FFN d_ff=1408, vocab=163840, 64 routed experts top-6.
The assignment tags it "dense" but the parameterisation is MoE; we follow
the parameters (64e top-6).
"""

from repro_torch.configs.base import ArchConfig, LayerSpec, MoESpec, register

MOONSHOT_16B = register(
    ArchConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab=163840,
        pattern=(LayerSpec(kind="attn", moe=True),),
        moe=MoESpec(n_experts=64, top_k=6, d_expert=1408),
        source="hf:moonshotai/Moonlight-16B-A3B",
    )
)
