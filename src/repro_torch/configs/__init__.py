"""Architecture config registry: the dense, MoE, SSM, hybrid and
vision-language configs the port runs.

Each architecture lives in its own module and registers an
:class:`~repro_torch.configs.base.ArchConfig` with its published
hyper-parameters.
"""

import importlib

from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    ArchConfig,
    InputShape,
    LayerSpec,
    MoESpec,
    get_arch,
    list_archs,
    register,
)

_MODULES = ["internlm2_1_8b", "paper_models", "gemma2_2b", "granite_20b", "musicgen_large",
            "mixtral_8x7b", "moonshot_v1_16b_a3b", "grok_1_314b", "kimi_k2_1t_a32b",
            "xlstm_125m", "jamba_1_5_large_398b", "qwen2_vl_7b"]

_loaded = False


def load_all() -> None:
    global _loaded
    if _loaded:
        return
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True
