"""Job / task model (paper §2, §4).

A job J over input data D split into m shards (blocks) B_1..B_m has m map
tasks and r reduce tasks. ``FP`` is the filtering percentage: map-output size
over map-input size (paper Eq. 1-2, refs [25][26]).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import List, Optional, Sequence

_job_counter = itertools.count()


class JobKind(enum.Enum):
    """JoSS job classes (paper §4.1)."""

    SMALL_MH = "small_map_heavy"
    SMALL_RH = "small_reduce_heavy"
    LARGE = "large"
    UNKNOWN = "unknown"  # FP not yet profiled -> FIFO queues (Fig. 4 line 4-6)


class TaskState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"


@dataclasses.dataclass
class MapTask:
    """M_i processes shard B_i (paper §4)."""

    job_id: int
    index: int
    shard_id: object
    input_bytes: int
    state: TaskState = TaskState.PENDING
    # filled by the assigner / executor
    host: Optional[object] = None
    locality: Optional[object] = None
    # speculative-execution bookkeeping (straggler mitigation)
    attempt: int = 0

    @property
    def tid(self):
        return ("m", self.job_id, self.index, self.attempt)


@dataclasses.dataclass
class ReduceTask:
    """R_j consumes the shuffled map output of its job (paper §2)."""

    job_id: int
    index: int
    state: TaskState = TaskState.PENDING
    host: Optional[object] = None
    attempt: int = 0

    @property
    def tid(self):
        return ("r", self.job_id, self.index, self.attempt)


@dataclasses.dataclass
class Job:
    """A MapReduce-style job: map fn + reduce fn over sharded input.

    ``code_key`` identifies the executable (for FP memoization);``input_type``
    is the input-data classifier's verdict (web vs non-web, paper §4.3).
    """

    name: str
    code_key: str
    input_type: str
    shard_ids: List[object]
    shard_bytes: List[int]
    n_reducers: int = 1
    # true filtering percentage of the underlying computation; the scheduler
    # must NOT read this directly - it learns it via profiling (paper Fig. 4).
    true_fp: float = 1.0
    submit_time: float = 0.0
    job_id: int = dataclasses.field(default_factory=lambda: next(_job_counter))
    # per-map-task compute cost multiplier (sim); 1.0 = nominal
    cost_scale: float = 1.0

    def __post_init__(self):
        if len(self.shard_ids) != len(self.shard_bytes):
            raise ValueError("shard_ids and shard_bytes must align")
        if self.n_reducers < 1:
            raise ValueError("r >= 1 (paper §4)")
        self.map_tasks = [
            MapTask(self.job_id, i, s, b)
            for i, (s, b) in enumerate(zip(self.shard_ids, self.shard_bytes))
        ]
        self.reduce_tasks = [ReduceTask(self.job_id, j)
                             for j in range(self.n_reducers)]

    # -- sizes (paper Eq. 1-2) -----------------------------------------------
    @property
    def m(self) -> int:
        """Number of map tasks."""
        return len(self.map_tasks)

    @property
    def s_map(self) -> int:
        """S_map = sum_i |B_i|."""
        return sum(self.shard_bytes)

    def s_reduce(self, fp: float) -> float:
        """S_reduce = S_map * FP_J under the averaged-FP reduction (Eq. 2)."""
        return self.s_map * fp

    @property
    def profile_key(self) -> str:
        """Hash key for FP memoization: (code, input type) (Fig. 4 line 1)."""
        return f"{self.code_key}::{self.input_type}"

    def done(self) -> bool:
        return (all(t.state == TaskState.DONE for t in self.map_tasks)
                and all(t.state == TaskState.DONE for t in self.reduce_tasks))
