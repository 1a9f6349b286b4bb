"""Training inputs: the deterministic token source and its prefetching
pipeline."""
from .pipeline import DataPipeline, TokenSource

__all__ = ["DataPipeline", "TokenSource"]
