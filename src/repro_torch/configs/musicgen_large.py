"""MusicGen-Large decoder backbone over EnCodec tokens.

[arXiv:2306.05284] — 48L, d_model=2048, 32 heads (kv=32, i.e. MHA),
d_ff=8192, vocab=2048 (one EnCodec codebook; the conv codec frontend is a
stub per the assignment — `input_specs()` supplies frame embeddings).
"""

from repro_torch.configs.base import ArchConfig, LayerSpec, register

MUSICGEN_LARGE = register(
    ArchConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=2048,
        pattern=(LayerSpec(kind="attn"),),
        rope="none",  # musicgen uses learned sinusoidal offsets; positionless here
        frontend="audio",
        source="arXiv:2306.05284",
    )
)
