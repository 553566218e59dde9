"""VPS lease and rental-cost accounting for elastic virtual clusters.

The paper's tenant rents VPSs from a provider to form the virtual cluster
(paper §1); related virtualized-MapReduce work (arXiv:1208.1942,
arXiv:1402.2810) treats machine rental cost as a first-class input. This
module models the tenant-visible billing surface: every live host carries a
``Lease`` (kind, hourly rate, open/close times), and a ``LeaseBook``
accrues VPS-hours and dollar cost across the whole fleet history.

Billing is continuous (seconds / 3600 x hourly rate) rather than
ceil-to-the-hour, so cost comparisons between autoscaler policies are not
dominated by rounding at the small fleet sizes the benchmarks sweep.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.topology import HostId

#: lease kinds — spot VPSs are cheaper but can be preempted by the provider
ON_DEMAND = "ondemand"
SPOT = "spot"


@dataclasses.dataclass(frozen=True)
class PriceSheet:
    """Hourly rates per lease kind ($/VPS-hour), roughly a 3:1 on-demand
    to spot discount (typical public-cloud ratio), plus the pod object
    store's per-GB-written rate for shuffle checkpointing —
    one-shot sim runs have no monthly retention, so a flat write charge
    models the bill."""

    ondemand_per_hour: float = 0.50
    spot_per_hour: float = 0.15
    storage_per_gb: float = 0.02

    def rate(self, kind: str) -> float:
        if kind == SPOT:
            return self.spot_per_hour
        return self.ondemand_per_hour


@dataclasses.dataclass
class Lease:
    """One VPS rental: open at ``start``, closed at ``end`` (None = live)."""

    hid: HostId
    kind: str
    rate: float          # $/hour
    start: float         # sim seconds
    end: Optional[float] = None
    close_reason: Optional[str] = None

    def hours(self, now: Optional[float] = None) -> float:
        stop = self.end if self.end is not None else now
        if stop is None:
            return 0.0
        return max(0.0, stop - self.start) / 3600.0

    def cost(self, now: Optional[float] = None) -> float:
        return self.hours(now) * self.rate


class LeaseBook:
    """Ledger of every lease the tenant ever held in one simulation."""

    def __init__(self, prices: Optional[PriceSheet] = None):
        self.prices = prices or PriceSheet()
        self.open_leases: Dict[HostId, Lease] = {}
        self.closed_leases: List[Lease] = []
        # accrued totals of closed leases plus running sums over the open
        # set, so vps_hours()/cost() are O(1) — they are read on every
        # churn/autoscale observation, and a churny run can hold a long
        # lease history and a large live fleet
        self._closed_hours = 0.0
        self._closed_cost = 0.0
        self._open_count = 0
        self._open_start_sum = 0.0       # sum of open starts (s)
        self._open_rate_sum = 0.0        # sum of open $/hour rates
        self._open_rate_start = 0.0      # sum of rate * start

    def open(self, hid: HostId, kind: str, now: float) -> Lease:
        if hid in self.open_leases:
            raise ValueError(f"lease for {hid} already open")
        lease = Lease(hid, kind, self.prices.rate(kind), now)
        self.open_leases[hid] = lease
        self._open_count += 1
        self._open_start_sum += lease.start
        self._open_rate_sum += lease.rate
        self._open_rate_start += lease.rate * lease.start
        return lease

    def close(self, hid: HostId, now: float, reason: str) -> Lease:
        lease = self.open_leases.pop(hid)
        lease.end = now
        lease.close_reason = reason
        self.closed_leases.append(lease)
        self._closed_hours += lease.hours()
        self._closed_cost += lease.cost()
        self._open_count -= 1
        self._open_start_sum -= lease.start
        self._open_rate_sum -= lease.rate
        self._open_rate_start -= lease.rate * lease.start
        return lease

    def close_all(self, now: float, reason: str = "sim_end") -> None:
        for hid in list(self.open_leases):
            self.close(hid, now, reason)

    def kind_of(self, hid: HostId) -> Optional[str]:
        lease = self.open_leases.get(hid)
        return None if lease is None else lease.kind

    # -- accounting (O(1): running sums; sim time never runs backwards) ------
    def vps_hours(self, now: Optional[float] = None) -> float:
        if now is None:
            return self._closed_hours
        open_s = now * self._open_count - self._open_start_sum
        return self._closed_hours + max(0.0, open_s) / 3600.0

    def cost(self, now: Optional[float] = None) -> float:
        if now is None:
            return self._closed_cost
        open_cost = now * self._open_rate_sum - self._open_rate_start
        return self._closed_cost + max(0.0, open_cost) / 3600.0

    def n_leases(self) -> int:
        return len(self.closed_leases) + len(self.open_leases)
