"""The paper's own evaluation models (Table III), as decoder-only analogues.

PAC+ evaluates T5-Base (0.25B), BART-Large (0.41B), T5-Large (0.74B) —
encoder-decoder models. The PAC+ technique is agnostic to the
encoder/decoder split (adapters consume per-layer activations), so we
carry decoder-only configs with the same layer/width/head budget, which is
what the assigned architecture pool exercises. Layer counts are doubled
to account for the encoder+decoder stacks (12+12 → 24 etc.).
"""

from repro_torch.configs.base import ArchConfig, LayerSpec, register

T5_BASE = register(
    ArchConfig(
        name="t5-base-pac",
        family="dense",
        n_layers=24,  # 12 enc + 12 dec
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab=32128,
        pattern=(LayerSpec(kind="attn"),),
        source="arXiv:1910.10683 (T5), PAC+ Table III",
    )
)

BART_LARGE = register(
    ArchConfig(
        name="bart-large-pac",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab=50265,
        pattern=(LayerSpec(kind="attn"),),
        source="ACL 2020 (BART), PAC+ Table III",
    )
)

T5_LARGE = register(
    ArchConfig(
        name="t5-large-pac",
        family="dense",
        n_layers=48,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab=32128,
        pattern=(LayerSpec(kind="attn"),),
        source="arXiv:1910.10683 (T5), PAC+ Table III",
    )
)
