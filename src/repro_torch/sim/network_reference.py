"""Naive per-flow reference for the class-aggregated fabric.

This is the original per-flow allocator structure, retained so the fast path in
``repro_torch.sim.network`` can be proven behaviour-identical (the
``core/reference.py`` pattern): it keeps **no incremental state** — on
every flow start/cancel/completion it rebuilds the signature membership
counts from scratch by scanning all flows (O(F x L)), updates every
flow's rate attribute, full-min-scans every flow for the next
completion, and purges progress counters by another full scan. The fast
allocator replaces each of those with O(classes) machinery (incremental
membership, per-class sorted fronts with lazy tombstones, an O(classes)
front minimum); the equivalence suite
(``tests/test_torch_network_reference.py`` and ``chip_smoke.py``'s
``scheduler`` phase) holds the two to bit-identical completion logs and
simulation trajectories.

One deliberate difference from the original per-flow code: progress is tracked
against per-signature virtual counters (``vdone[sig]`` += rate x dt; a
flow completes when the counter passes ``target = vdone_at_join + mb``)
rather than per-flow ``rem -= rate x dt`` decrements, and filling debits
each link once by ``count x share`` rather than once per flow. Max-min
assigns every flow of a signature the same rate, so the two formulations
are mathematically identical — but their floating-point rounding paths
are not, and *bit* equality between a per-flow and a per-class
implementation is only provable when both sides execute the same
arithmetic. The shared spec lives at class granularity; this module
keeps the naive per-flow *structure* around it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.core.topology import VirtualCluster
from repro_torch.sim.network import (EPS_MB, FCAP, FabricConfig, LinkKey, Sig,
                                     _FabricBase)


class _RefFlow:
    """One transfer, with its own copies of everything the allocator
    recomputes per event (rate) — the naive representation."""

    __slots__ = ("fid", "mb", "sig", "path", "cap", "kind", "t0", "done",
                 "target", "rate")

    def __init__(self, fid: int, mb: float, sig: Sig, kind: str,
                 t0: float, done: Callable[[float], None], target: float):
        self.fid = fid
        self.mb = mb
        self.sig = sig
        self.path, self.cap = sig
        self.kind = kind
        self.t0 = t0
        self.done = done
        self.target = target
        self.rate = 0.0


class ReferenceNetworkFabric(_FabricBase):
    """Per-flow max-min allocator: O(flows) everywhere, zero incremental
    state. Selected via ``FabricConfig(allocator="reference")``."""

    def __init__(self, cluster: VirtualCluster,
                 cfg: Optional[FabricConfig] = None):
        super().__init__(cluster, cfg)
        self._flows: Dict[int, _RefFlow] = {}
        self._vdone: Dict[Sig, float] = {}   # MB drained per member
        self._rates: Dict[Sig, float] = {}   # from the last recompute

    # -- flow API ----------------------------------------------------------------
    def start_flow(self, now: float, mb: float, src_pod: Optional[int],
                   dst_pod: int, cap: float, kind: str,
                   done: Callable[[float], None]) -> int:
        if mb <= EPS_MB:   # nothing to move: complete "immediately"
            self.kernel.call_at(now, done)
            return -1
        self._settle(now)
        fid = next(self._fids)
        sig = (self.path(src_pod, dst_pod), cap)
        if sig not in self._vdone:
            self._vdone[sig] = 0.0
            self._rates[sig] = 0.0
        target = self._vdone[sig] + mb
        self._flows[fid] = _RefFlow(fid, mb, sig, kind, now, done, target)
        self._reschedule(now)
        return fid

    def cancel(self, fid: int, now: float) -> None:
        if fid not in self._flows:
            return
        self._settle(now)
        del self._flows[fid]
        self._purge()
        self.summary.n_cancelled += 1
        self._reschedule(now)

    # -- mechanics ----------------------------------------------------------------
    def _purge(self) -> None:
        """Drop progress counters whose last flow is gone (full scan)."""
        live = {f.sig for f in self._flows.values()}
        for sig in [s for s in self._vdone if s not in live]:
            del self._vdone[sig]
            del self._rates[sig]

    def _settle(self, now: float) -> None:
        dt = now - self._last
        if dt > 0.0:
            vdone = self._vdone
            for sig, r in self._rates.items():
                if r:
                    vdone[sig] += r * dt
            self._accrue(dt)
            self._last = now

    def _recompute(self) -> None:
        """Progressive filling, rebuilt from scratch: membership counts
        re-derived by scanning every flow, then the same class-grained
        arithmetic as the fast path (explicit ``(share, link_key)``
        minimum, one ``count x share`` debit per link), then every
        flow's rate attribute rewritten."""
        counts: Dict[Sig, int] = {}
        for f in self._flows.values():
            counts[f.sig] = counts.get(f.sig, 0) + 1
        order = sorted(counts)
        rem_cap = dict(self._caps)
        users: Dict[LinkKey, List[Sig]] = {k: [] for k in rem_cap}
        for sig in order:
            for link in sig[0]:
                users[link].append(sig)
        unfixed = dict.fromkeys(order)
        rates: Dict[Sig, float] = {}
        while unfixed:
            best_key = None
            best_members: List[Sig] = []
            for link, members in users.items():
                n = 0
                for sig in members:
                    if sig in unfixed:
                        n += counts[sig]
                if n == 0:
                    continue
                key = (rem_cap[link] / n, link)
                if best_key is None or key < best_key:
                    best_key, best_members = key, members
            for sig in unfixed:
                key = (sig[1], (FCAP, sig))
                if key < best_key:
                    best_key, best_members = key, [sig]
            rate = best_key[0]
            dec: Dict[LinkKey, int] = {}
            for sig in best_members:
                if sig not in unfixed:
                    continue
                rates[sig] = rate
                del unfixed[sig]
                for link in sig[0]:
                    dec[link] = dec.get(link, 0) + counts[sig]
            for link, k in dec.items():
                rem_cap[link] = max(0.0, rem_cap[link] - k * rate)
        self._rates = rates
        for f in self._flows.values():
            f.rate = rates[f.sig]
        for k in self._load:
            self._load[k] = 0.0
        for sig in order:
            r = rates[sig] * counts[sig]
            for link in sig[0]:
                self._load[link] += r

    def _reschedule(self, now: float) -> None:
        """Full min-scan over every live flow for the next completion.
        Starved flows (rate 0.0, e.g. a zero-capacity elastic link) arm
        no completion event — same contract as the fast path."""
        self._epoch += 1
        if not self._flows:
            # the last flow just drained: stop the carried-MB integrals
            # from accruing at stale rates across the idle gap
            for k in self._load:
                self._load[k] = 0.0
            return
        self._recompute()
        vdone = self._vdone
        t_next = None
        for f in self._flows.values():
            r = f.rate
            if r <= 0.0:
                continue
            t = now + (f.target - vdone[f.sig]) / r
            if t_next is None or t < t_next:
                t_next = t
        if t_next is not None:
            self.kernel.push(t_next, "flow", self._epoch)

    def _on_flow(self, now: float, epoch: int) -> None:
        if epoch != self._epoch:
            return   # superseded by a later flow-set change
        self._settle(now)
        vdone = self._vdone
        finished = [f for f in self._flows.values()
                    if f.target - vdone[f.sig] <= EPS_MB]
        for f in finished:
            del self._flows[f.fid]
        self._purge()
        for f in finished:   # dict order == flow-creation order
            self._complete_one(f, now)
        self._reschedule(now)
        for f in finished:
            f.done(now)
