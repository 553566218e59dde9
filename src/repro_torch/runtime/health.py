"""Heartbeat-based health tracking + MapReduce-style speculative execution.

The paper's Hadoop substrate re-runs straggling tasks on other nodes
(speculative execution); at multi-pod training scale the same mechanism
becomes: (a) heartbeat registry marking hosts dead after ``timeout``
missed beats, (b) task-duration tracking that flags tasks exceeding
``slack`` x the running median, (c) a backup-launch decision that the
JoSS queues execute by re-enqueueing the task on another pod (the
simulator wires this to SimConfig.speculative; a real deployment wires it
to the data-pipeline shard re-dispatch and to elastic re-meshing below).
"""
from __future__ import annotations

import dataclasses
import enum
import statistics
from typing import Dict, List, Optional, Tuple


class HostState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclasses.dataclass
class _HostInfo:
    last_beat: float
    state: HostState = HostState.HEALTHY


class HealthTracker:
    """Failure detector: φ-less two-threshold heartbeat tracker."""

    def __init__(self, *, suspect_after: float = 10.0,
                 dead_after: float = 30.0):
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        self._hosts: Dict[object, _HostInfo] = {}

    def beat(self, host, now: float) -> None:
        info = self._hosts.get(host)
        if info is None:
            self._hosts[host] = _HostInfo(now)
        else:
            info.last_beat = now
            info.state = HostState.HEALTHY

    def sweep(self, now: float) -> List[object]:
        """Update states; return hosts newly declared dead."""
        newly_dead = []
        for host, info in self._hosts.items():
            age = now - info.last_beat
            if age >= self.dead_after:
                if info.state is not HostState.DEAD:
                    newly_dead.append(host)
                info.state = HostState.DEAD
            elif age >= self.suspect_after:
                if info.state is HostState.HEALTHY:
                    info.state = HostState.SUSPECT
        return newly_dead

    def state(self, host) -> HostState:
        info = self._hosts.get(host)
        return HostState.DEAD if info is None else info.state

    def alive(self) -> List[object]:
        return [h for h, i in self._hosts.items()
                if i.state is not HostState.DEAD]


class SpeculativeLauncher:
    """Flags straggling tasks for backup execution (Hadoop speculative
    execution, adapted: the decision is pluggable into the JoSS queues)."""

    def __init__(self, *, slack: float = 1.8, min_samples: int = 5,
                 max_backups: int = 1):
        self.slack = slack
        self.min_samples = min_samples
        self.max_backups = max_backups
        self._durations: List[float] = []
        self._running: Dict[object, float] = {}   # task id -> start time
        self._backups: Dict[object, int] = {}

    def task_started(self, tid, now: float) -> None:
        self._running[tid] = now

    def task_finished(self, tid, now: float) -> None:
        t0 = self._running.pop(tid, None)
        if t0 is not None:
            self._durations.append(now - t0)
        self._backups.pop(tid, None)

    def median(self) -> Optional[float]:
        if len(self._durations) < self.min_samples:
            return None
        return statistics.median(self._durations)

    def stragglers(self, now: float) -> List[object]:
        """Tasks that should get a backup launch right now."""
        med = self.median()
        if med is None:
            return []
        out = []
        for tid, t0 in self._running.items():
            if (now - t0 > self.slack * med
                    and self._backups.get(tid, 0) < self.max_backups):
                out.append(tid)
        return out

    def backup_launched(self, tid) -> None:
        self._backups[tid] = self._backups.get(tid, 0) + 1
