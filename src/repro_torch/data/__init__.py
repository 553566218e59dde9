"""Data pipeline: sharded token store with replica placement + JoSS
policy-B locality-aware batch construction."""
from repro_torch.data.pipeline import (JossDataPipeline, LocalityReport,
                                       Shard, TokenStore)

__all__ = ["JossDataPipeline", "LocalityReport", "Shard", "TokenStore"]
