"""Grok-1 314B MoE.

[hf:xai-org/grok-1] — 64L, d_model=6144, 48 heads (GQA kv=8), expert FFN
d_ff=32768, vocab=131072, 8 experts top-2. Every layer is MoE.
"""

from repro_torch.configs.base import ArchConfig, LayerSpec, MoESpec, register

GROK_1 = register(
    ArchConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=32768,
        vocab=131072,
        pattern=(LayerSpec(kind="attn", moe=True),),
        moe=MoESpec(n_experts=8, top_k=2, d_expert=32768),
        attn_softcap=30.0,  # grok uses attention logit capping
        source="hf:xai-org/grok-1",
    )
)
