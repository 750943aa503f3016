"""Granite-20B (code) — llama-arch with MQA.

[arXiv:2405.04324] — 52L, d_model=6144, 48 heads (MQA kv=1), d_ff=24576,
vocab=49152.
"""

from repro_torch.configs.base import ArchConfig, LayerSpec, register

GRANITE_20B = register(
    ArchConfig(
        name="granite-20b",
        family="dense",
        n_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab=49152,
        pattern=(LayerSpec(kind="attn"),),
        source="arXiv:2405.04324",
    )
)
