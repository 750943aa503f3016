"""Optimizers on parameter trees (counterpart of ``repro.optim``)."""

from repro_torch.optim.optimizers import adamw_init, adamw_update, clip_by_global_norm  # noqa: F401
