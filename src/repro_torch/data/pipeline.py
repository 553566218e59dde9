"""JoSS-placed training data pipeline (a copy of
``repro/data/pipeline.py``: for the same seeds it gives the same shard
assignment, the same batches and the same locality report).

The training corpus is stored as fixed-size token shards with replicas on
specific hosts (HDFS-block semantics, paper §2). Each epoch of training is
a map-heavy job (the "map" is the forward/backward over a shard's
sequences; FP ~= activation bytes / input bytes >> td never holds, so
Eq. 3 classifies it MH), and JoSS policy B computes the shard -> pod
assignment via the greedy unique-shard cover: every pod trains on the
shards it already stores, and only the residue crosses between pods.

The pipeline then serves per-step global batches whose batch dimension is
laid out pod-major, so each pod's rows come from the shards it holds.
Locality is accounted with the paper's Eqs. 9-11. Batches are numpy
int32 arrays; the trainer moves them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np

from repro_torch.core.job import Job
from repro_torch.core.policies import policy_b
from repro_torch.core.topology import Locality, VirtualCluster


@dataclasses.dataclass
class Shard:
    sid: str
    tokens: np.ndarray       # (n_seqs, seq_len) int32
    nbytes: int


@dataclasses.dataclass
class LocalityReport:
    """Paper Eqs. 9-11 applied to data-pipeline reads."""

    host_rate: float      # VPS-locality
    pod_rate: float       # Cen-locality
    off_pod_rate: float   # off-Cen
    bytes_local: int
    bytes_pod: int
    bytes_off_pod: int

    @property
    def int_bytes(self) -> int:
        return self.bytes_off_pod


class TokenStore:
    """Sharded synthetic corpus with replica placement on a cluster."""

    def __init__(self, cluster: VirtualCluster, *, n_shards: int,
                 seqs_per_shard: int, seq_len: int, vocab: int,
                 replication: int = 1, seed: int = 0):
        self.cluster = cluster
        self.seq_len = seq_len
        rng = np.random.RandomState(seed)
        hosts = [h.hid for h in cluster.hosts()]
        self.shards: Dict[str, Shard] = {}
        for i in range(n_shards):
            sid = f"shard{i}"
            toks = rng.randint(0, vocab, size=(seqs_per_shard, seq_len)
                               ).astype(np.int32)
            self.shards[sid] = Shard(sid, toks, toks.nbytes)
            picks = rng.choice(len(hosts),
                               size=min(replication, len(hosts)),
                               replace=False)
            cluster.place_shard(sid, [hosts[int(p)] for p in picks])

    def as_job(self, *, name: str = "train-epoch") -> Job:
        sids = sorted(self.shards)
        return Job(name=name, code_key=name, input_type="tokens",
                   shard_ids=sids,
                   shard_bytes=[self.shards[s].nbytes for s in sids],
                   n_reducers=1, true_fp=0.0)


class JossDataPipeline:
    """Policy-B shard->pod assignment + pod-major batch construction."""

    def __init__(self, store: TokenStore, *, global_batch: int,
                 seed: int = 0, joss: bool = True):
        self.store = store
        self.cluster = store.cluster
        self.global_batch = global_batch
        self.rng = np.random.RandomState(seed)
        k = self.cluster.k
        if global_batch % k:
            raise ValueError(f"global_batch {global_batch} % k={k} != 0")
        job = store.as_job()
        if joss:
            plan = policy_b(job, self.cluster)
            self.assignment = {s: p for s, p in zip(job.shard_ids,
                                                    plan.map_assignment)}
        else:  # baseline: round-robin, placement-blind (FIFO-like)
            self.assignment = {s: i % k for i, s in
                               enumerate(sorted(store.shards))}
        # per-pod shard lists
        self.pod_shards: Dict[int, List[str]] = {c: [] for c in range(k)}
        for s, p in self.assignment.items():
            self.pod_shards[p].append(s)
        # pods with no shards borrow from the globally largest pool
        for c in range(k):
            if not self.pod_shards[c]:
                donor = max(self.pod_shards, key=lambda d:
                            len(self.pod_shards[d]))
                self.pod_shards[c] = list(self.pod_shards[donor])
        self._locality_counts = {"host": 0, "pod": 0, "off": 0}
        self._bytes = {"host": 0, "pod": 0, "off": 0}

    # ------------------------------------------------------------- serving --
    def _account(self, sid: str, pod: int) -> None:
        """Account the read of shard ``sid`` by pod ``pod`` (paper metric:
        nearest replica as seen from an arbitrary host of the pod)."""
        hid = self.cluster.pods[pod].hosts[0].hid
        _, loc = self.cluster.nearest_replica(sid, hid)
        nb = self.store.shards[sid].nbytes
        key = {Locality.HOST: "host", Locality.POD: "pod",
               Locality.OFF_POD: "off"}[loc]
        self._locality_counts[key] += 1
        self._bytes[key] += nb

    def batches(self, n_steps: int) -> Iterator[np.ndarray]:
        """Yield (global_batch, seq_len) arrays, batch dim pod-major."""
        k = self.cluster.k
        per_pod = self.global_batch // k
        for _ in range(n_steps):
            parts = []
            for c in range(k):
                rows = []
                while len(rows) < per_pod:
                    sid = self.pod_shards[c][
                        self.rng.randint(len(self.pod_shards[c]))]
                    self._account(sid, c)
                    sh = self.store.shards[sid]
                    take = min(per_pod - len(rows), sh.tokens.shape[0])
                    idx = self.rng.choice(sh.tokens.shape[0], size=take,
                                          replace=False)
                    rows.append(sh.tokens[idx])
                parts.append(np.concatenate(rows, axis=0)[:per_pod])
            yield np.concatenate(parts, axis=0)

    def locality_report(self) -> LocalityReport:
        c = self._locality_counts
        total = max(1, sum(c.values()))
        b = self._bytes
        return LocalityReport(
            host_rate=c["host"] / total, pod_rate=c["pod"] / total,
            off_pod_rate=c["off"] / total,
            bytes_local=b["host"], bytes_pod=b["pod"],
            bytes_off_pod=b["off"])
