"""InternLM2-1.8B — llama-style GQA decoder.

[arXiv:2403.17297] — 24L, d_model=2048, 16 heads (GQA kv=8), d_ff=8192,
vocab=92544.
"""

from repro_torch.configs.base import ArchConfig, LayerSpec, register

INTERNLM2_1_8B = register(
    ArchConfig(
        name="internlm2-1.8b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab=92544,
        pattern=(LayerSpec(kind="attn"),),
        rope_theta=1_000_000.0,
        source="arXiv:2403.17297",
    )
)
