"""Optimizers on parameter trees (counterpart of ``repro.optim``)."""

from repro_torch.optim.optimizers import (  # noqa: F401
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    linear_warmup,
    sgdm_init,
    sgdm_update,
)
