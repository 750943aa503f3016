"""Mixtral 8x7B sparse MoE (bonus pool arch, beyond the assigned ten).

[arXiv:2401.04088] — 32L, d_model=4096, 32 heads (GQA kv=8), expert FFN
d_ff=14336, vocab=32000, 8 experts top-2, sliding-window 4096 attention.
The window+MoE combination at llama-class dims.
"""

from repro_torch.configs.base import ArchConfig, LayerSpec, MoESpec, register

MIXTRAL = register(
    ArchConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab=32000,
        pattern=(LayerSpec(kind="attn", moe=True, window=4096),),
        moe=MoESpec(n_experts=8, top_k=2, d_expert=14336),
        source="arXiv:2401.04088",
    )
)
