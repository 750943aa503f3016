"""Jamba-1.5-Large 398B — Mamba+attention 1:7 interleave with MoE.

[arXiv:2403.19887] — 72L, d_model=8192, 64 heads (GQA kv=8), expert FFN
d_ff=24576 (MoE 16e top-2 on every other layer), vocab=65536. Each 8-layer
period = 7 Mamba layers + 1 attention layer; MoE at odd positions.
"""

from repro_torch.configs.base import ArchConfig, LayerSpec, MoESpec, register

_PERIOD = tuple(
    LayerSpec(kind=("attn" if i == 3 else "mamba"), moe=(i % 2 == 1))
    for i in range(8)
)

JAMBA_1_5_LARGE = register(
    ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab=65536,
        pattern=_PERIOD,
        moe=MoESpec(n_experts=16, top_k=2, d_expert=24576),
        ssm_d_state=16,
        ssm_d_conv=4,
        ssm_expand=2,
        source="arXiv:2403.19887",
    )
)
