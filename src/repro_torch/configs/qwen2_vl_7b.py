"""Qwen2-VL-7B language backbone with M-RoPE.

[arXiv:2409.12191] — 28L, d_model=3584, 28 heads (GQA kv=4), d_ff=18944,
vocab=152064. M-RoPE: 3-D (temporal/height/width) rotary position ids
provided by the stub vision frontend; dynamic-resolution patching is the
frontend's job and is stubbed, as in the reference.
"""

from repro_torch.configs.base import ArchConfig, LayerSpec, register

QWEN2_VL_7B = register(
    ArchConfig(
        name="qwen2-vl-7b",
        family="vlm",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab=152064,
        pattern=(LayerSpec(kind="attn"),),
        rope="mrope",
        rope_theta=1_000_000.0,
        frontend="vision",
        source="arXiv:2409.12191",
    )
)
