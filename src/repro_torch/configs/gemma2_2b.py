"""Gemma-2 2B — alternating local/global attention, logit softcapping.

[arXiv:2408.00118] — 26L, d_model=2304, 8 heads (GQA kv=4), d_ff=9216,
vocab=256000. Sliding window 4096 on every other layer; attention softcap
50.0, final-logit softcap 30.0; tied embeddings.
"""

from repro_torch.configs.base import ArchConfig, LayerSpec, register

GEMMA2_2B = register(
    ArchConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        d_ff=9216,
        vocab=256000,
        pattern=(
            LayerSpec(kind="attn", window=4096),
            LayerSpec(kind="attn"),
        ),
        head_dim=256,
        logit_softcap=30.0,
        attn_softcap=50.0,
        tie_embeddings=True,
        source="arXiv:2408.00118",
    )
)
