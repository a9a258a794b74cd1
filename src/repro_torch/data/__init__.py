"""Data sources of the port: the deterministic synthetic token stream."""
from .pipeline import DataConfig, SyntheticTokens, prefetch

__all__ = ["DataConfig", "SyntheticTokens", "prefetch"]
