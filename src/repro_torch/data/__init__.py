"""Synthetic corpora of the port."""
from .synthetic import DATASETS, DatasetSpec, make_dataset  # noqa: F401
