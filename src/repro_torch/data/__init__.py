"""The port's training data pipeline."""

from repro_torch.data.pipeline import (
    DataState,
    GraphPatternFilter,
    SyntheticLMDataset,
    make_pipeline,
)

__all__ = [
    "DataState",
    "GraphPatternFilter",
    "SyntheticLMDataset",
    "make_pipeline",
]
