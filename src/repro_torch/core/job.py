"""Job / map-task model, trimmed to what the data pipeline's placement
reads (a copy of part of ``repro/core/job.py``): a job over input split
into m shards B_1..B_m has one map task per shard (paper §2, §4).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List

_job_counter = itertools.count()


@dataclasses.dataclass
class MapTask:
    """M_i processes shard B_i (paper §4)."""

    job_id: int
    index: int
    shard_id: object
    input_bytes: int


@dataclasses.dataclass
class Job:
    """A MapReduce-style job over sharded input. ``code_key`` and
    ``input_type`` identify it for FP memoization (paper Fig. 4 line 1);
    ``true_fp`` is its filtering percentage, map output over map input."""

    name: str
    code_key: str
    input_type: str
    shard_ids: List[object]
    shard_bytes: List[int]
    n_reducers: int = 1
    true_fp: float = 1.0
    job_id: int = dataclasses.field(default_factory=lambda: next(_job_counter))

    def __post_init__(self):
        if len(self.shard_ids) != len(self.shard_bytes):
            raise ValueError("shard_ids and shard_bytes must align")
        if self.n_reducers < 1:
            raise ValueError("r >= 1 (paper §4)")
        self.map_tasks = [
            MapTask(self.job_id, i, s, b)
            for i, (s, b) in enumerate(zip(self.shard_ids, self.shard_bytes))
        ]

    @property
    def m(self) -> int:
        """Number of map tasks."""
        return len(self.map_tasks)
