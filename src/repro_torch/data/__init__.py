"""Data pipeline (counterpart of ``repro.data``)."""

from repro_torch.data.pipeline import DataPipeline, SyntheticPersonalCorpus  # noqa: F401
