"""JoSS request routing for multi-pod serving.

Serving maps onto the paper's job taxonomy directly:

  * prefill  = map-heavy (moves the prompt once, compute-dominated)
                -> policy B: route to the pod already holding the
                   request's context/KV (its "input blocks").
  * decode   = the job's reduce phase pinned by its data: a decode step
                MUST run where the KV cache lives (VPS-locality is
                mandatory, not preferential).
  * new sessions (no cached state) = unknown-FP jobs -> policy A:
                least-loaded pod.

The router keeps per-pod token-load accounting and a session->pod map; a
dead pod (HealthTracker) invalidates its sessions, which re-enter as new
(policy A) sessions — the serving analogue of re-enqueueing a failed
task.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.topology import VirtualCluster


@dataclasses.dataclass
class Request:
    rid: str
    session: Optional[str]      # KV-cache identity (None = fresh)
    prompt_tokens: int
    decode_tokens: int = 1


@dataclasses.dataclass
class RouteDecision:
    rid: str
    pod: int
    policy: str                 # 'A' (least-loaded) or 'B' (cache affinity)
    cache_hit: bool


class JossServeRouter:
    def __init__(self, cluster: VirtualCluster):
        self.cluster = cluster
        self.load = {c: 0 for c in range(cluster.k)}      # in-flight tokens
        self.sessions: Dict[str, int] = {}                # session -> pod
        self.decisions: List[RouteDecision] = []

    def route(self, req: Request) -> RouteDecision:
        if req.session is not None and req.session in self.sessions:
            pod = self.sessions[req.session]
            dec = RouteDecision(req.rid, pod, "B", cache_hit=True)
        else:
            pod = min(self.load, key=lambda c: (self.load[c], c))
            dec = RouteDecision(req.rid, pod, "A", cache_hit=False)
            if req.session is not None:
                self.sessions[req.session] = pod
        self.load[pod] += req.prompt_tokens + req.decode_tokens
        self.decisions.append(dec)
        return dec

    def complete(self, req: Request, pod: int) -> None:
        self.load[pod] -= req.prompt_tokens + req.decode_tokens

    def pod_failed(self, pod: int) -> List[str]:
        """Invalidate sessions homed on a dead pod; they re-route fresh."""
        lost = [s for s, p in self.sessions.items() if p == pod]
        for s in lost:
            del self.sessions[s]
        self.load[pod] = 0
        return lost

    # ----------------------------------------------------------- metrics --
    def cache_hit_rate(self) -> float:
        hits = sum(1 for d in self.decisions if d.cache_hit)
        return hits / max(1, len(self.decisions))

    def load_imbalance(self) -> float:
        vals = list(self.load.values())
        mean = sum(vals) / len(vals)
        if mean == 0:
            return 0.0
        return max(vals) / mean - 1.0
