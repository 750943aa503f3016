"""xLSTM-125M — sLSTM + mLSTM blocks.

[arXiv:2405.04517] — 12L, d_model=768, 4 heads, d_ff=0 (xLSTM blocks carry
their own up/down projections), vocab=50304. The paper's 7:1-style mixing
at small scale: sLSTM at one position per 4-layer period.
"""

from repro_torch.configs.base import ArchConfig, LayerSpec, register

XLSTM_125M = register(
    ArchConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        pattern=(
            LayerSpec(kind="mlstm", ffn=False),
            LayerSpec(kind="mlstm", ffn=False),
            LayerSpec(kind="mlstm", ffn=False),
            LayerSpec(kind="slstm", ffn=False),
        ),
        rope="none",
        source="arXiv:2405.04517",
    )
)
