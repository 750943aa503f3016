"""Data pipeline (counterpart of ``repro.data``)."""

from repro_torch.data.pipeline import (  # noqa: F401
    DataPipeline,
    SyntheticPersonalCorpus,
    glue_like_task,
)
