from .pipeline import MemmapTokens, ShardedLoader, SyntheticTokens

__all__ = ["SyntheticTokens", "MemmapTokens", "ShardedLoader"]
