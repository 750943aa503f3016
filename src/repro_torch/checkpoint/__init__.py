"""Checkpoints in the reference's msgpack framing (no ``msgpack`` package)."""

from repro_torch.checkpoint.io import (  # noqa: F401
    CheckpointError,
    load_checkpoint,
    save_checkpoint,
    tree_fingerprint,
)
