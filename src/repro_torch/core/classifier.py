"""Job classification (paper §4.1, §5) + input-data classifier (§4.3).

Implements:
  * Eq. (3): RH iff FP_J > td, with td = k/(k-1) (Eq. 8, proved in §5).
  * Eq. (4): small iff m <= N_avg_VPS.
  * The FP registry: first execution of a (code, input-type) pair goes through
    the FIFO queues; the measured average FP is memoized under a hash
    (Fig. 4 lines 1-6, ~20 bytes/record per §6.3).
  * The input-data classifier: web vs non-web document sniffing.
"""
from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import Dict, Optional

from repro_torch.core.job import Job, JobKind
from repro_torch.core.topology import VirtualCluster


def best_threshold(k: int) -> float:
    """td = k/(k-1) (paper Eq. 8).

    Derivation (§5): policy-A worst case moves all map input across pods,
    TR1 = S_map; policy-B worst case moves (k-1)/k of the reduce input,
    TR2 = (k-1)/k * S_map * FP_J. Classify RH only when TR2 > TR1.
    """
    if k < 2:
        raise ValueError("threshold defined for k >= 2 pods (paper assumes k>1)")
    return k / (k - 1)


def worst_case_traffic_rh(s_map: float) -> float:
    """TR1 (Eq. 5): all mappers fetch off-pod; reducers local."""
    return s_map


def worst_case_traffic_mh(s_map: float, fp: float, k: int) -> float:
    """TR2 (Eq. 6): mappers local; reducers fetch (k-1)/k of input off-pod."""
    return (k - 1) / k * s_map * fp


@dataclasses.dataclass
class FpRecord:
    """Memoized per-(code,input-type) profile (~20 bytes in the paper §6.3)."""

    fp: float
    n_samples: int


class FpRegistry:
    """H: the set of (hashed) profiled jobs + their average FP values."""

    def __init__(self):
        self._records: Dict[str, FpRecord] = {}

    @staticmethod
    def hash_key(profile_key: str) -> str:
        return hashlib.sha1(profile_key.encode()).hexdigest()[:16]

    def knows(self, job: Job) -> bool:
        return self.hash_key(job.profile_key) in self._records

    def fp_of(self, job: Job) -> Optional[float]:
        rec = self._records.get(self.hash_key(job.profile_key))
        return None if rec is None else rec.fp

    def record(self, job: Job, measured_fp: float) -> None:
        """Record a completed job's measured average FP (Fig. 4 epilogue).

        Running averages across repeat executions keep the estimate stable the
        way the paper's single memoized value does, while tolerating noise.
        """
        key = self.hash_key(job.profile_key)
        rec = self._records.get(key)
        if rec is None:
            self._records[key] = FpRecord(measured_fp, 1)
        else:
            n = rec.n_samples + 1
            rec.fp += (measured_fp - rec.fp) / n
            rec.n_samples = n

    @property
    def storage_bytes(self) -> int:
        """Extra master-side storage (paper §6.3: ~20 bytes/record)."""
        return 20 * len(self._records)


class JobClassifier:
    """Combines Eq. (3) and Eq. (4) into the JoSS job class."""

    def __init__(self, cluster: VirtualCluster, registry: FpRegistry,
                 td: Optional[float] = None):
        self.cluster = cluster
        self.registry = registry
        self.td = best_threshold(cluster.k) if td is None else td

    def classify(self, job: Job) -> JobKind:
        # Eq. (4): small iff all map tasks fit one pod simultaneously.
        small = job.m <= self.cluster.n_avg_hosts
        if not small:
            return JobKind.LARGE  # policy C regardless of FP
        fp = self.registry.fp_of(job)
        if fp is None:
            return JobKind.UNKNOWN  # first sighting -> FIFO queues
        return JobKind.SMALL_RH if fp > self.td else JobKind.SMALL_MH


_TAG_RE = re.compile(r"<[^>\s][^>]*>")


def classify_input_type(sample_text: str, *, sniff_chars: int = 4096,
                        tag_threshold: float = 0.01) -> str:
    """Input-data classifier (paper §4.3): web vs non-web document.

    'A web document refers to a file consisting of a lot of tags enclosed in
    angle brackets. By simply inspecting the first several sentences ... the
    input-data classifier can easily know if it is a web document or not.'
    """
    head = sample_text[:sniff_chars]
    if not head:
        return "non-web"
    tags = _TAG_RE.findall(head)
    tag_chars = sum(len(t) for t in tags)
    # plenty of markup in the head of the file -> web document
    return "web" if len(tags) >= 3 and tag_chars / len(head) > tag_threshold \
        else "non-web"
