"""Contention-aware network fabric: class-aggregated max-min allocator.

The per-stream timing model charges every transfer a fixed
rate (``SimConfig.pod_bw``/``dcn_bw``), so saving inter-pod bytes never
actually makes jobs faster — the paper's central feedback loop (lower
INT => less WAN queueing => lower JTT/WTT) was missing. The fabric closes the
loop with max-min fair-share *flows* over shared links, and this module
makes that allocator scale: the original recomputed an O(flows^2 x links)
progressive filling and settled/min-scanned every live flow on *every*
flow start/cancel/completion, capping contended runs at toy fleets while
the dispatch path already handles 8192 hosts. This module is the
fast path; the per-flow structure is retained in
``repro_torch.sim.network_reference`` and proven bit-identical.

Topology (capacities from ``core.topology.LinkCapacities``, or derived
from the live fleet via ``core.topology.ElasticLinks``):

  * one **uplink** and one **downlink** per pod — everything the pod's
    hosts (and its object store) send into / receive from the fabric;
  * one shared **WAN** link crossed by every inter-pod byte.

A flow from pod *a* to pod *b* traverses ``up(a) [+ wan if a != b] +
down(b)``; a flow with no source pod (external durable store) traverses
``wan + down(b)``. Host-local disk reads never touch the fabric. Every
flow additionally carries a per-flow rate cap — the per-stream rate the
old model charged (``pod_bw``/``dcn_bw``/checkpoint/repair bandwidth) —
so an *uncontended* fabric reproduces per-stream timing and contention
only ever slows transfers down, never speeds them up.

Flow kinds drained through the fabric: ``map_read`` (off-host map input),
``shuffle`` (reduce fetches), ``ckpt_write``/``ckpt_read`` (pod object
store), ``rerep`` (durability repair copies) and ``migrate`` (live task
state shipped during notice-window drains).

The fast path — flow equivalence classes
----------------------------------------
Max-min fairness cannot tell two flows apart that share the same
``(path, per-flow cap)`` signature: they cross exactly the same
constraint set, so progressive filling provably assigns them identical
rates at all times. With P pods there are only O(P^2) signatures — a few
dozen — no matter how many thousand flows are live, and the whole
allocator runs at class granularity:

  * **filling** is over classes: each round picks the most-constrained
    link by an explicit ``(share, link_key)`` lexicographic minimum
    (class caps enter as ``("~cap", sig)`` virtual links, which sort
    after every real link), fixes every class crossing it, and debits
    each affected link once by ``member_count x share`` — O(C^2 x L)
    instead of O(F^2 x L);
  * **progress** is virtual: each class keeps ``vdone``, the MB drained
    *per member* since the class was born. A flow stores a single
    ``target = vdone_at_join + mb`` and is done when the counter passes
    it, so settling elapsed time is one multiply-add per class, not per
    flow;
  * **next completion** comes from a per-class sorted front (a heap of
    ``(target, fid)`` with lazy tombstones for cancelled flows): one
    O(C) minimum over class fronts per reschedule instead of a
    min-scan over every live flow. A class whose rate is
    0.0 (a link legitimately at zero capacity, e.g. an elastic pod with
    no hosts left) is *starved*: it arms no completion event and simply
    waits for the next flow-set or capacity change.

Everything is deterministic: classes are visited in sorted-signature
order, link keys have a total order, and same-instant completions are
logged in flow-creation order. ``repro_torch.sim.network_reference`` keeps the
naive per-flow structure (from-scratch class rebuilds, full min-scans)
over the *same arithmetic spec*, and the equivalence suite
(``tests/test_fabric_fastpath.py``) plus the ``bench_fabric`` claim
checks hold the two to **bit-identical completion logs** — order, times
and kinds — across static/churn/durability/speculative scenarios.

Accounting: per-link utilization integrals (MB actually carried vs
capacity x horizon) and per-flow *stall* — time lost versus the flow's
uncontended time ``mb / cap`` — aggregated per kind into
:class:`FabricSummary` and surfaced as ``SimResult.fabric``,
``fabric_stall_s``, ``fabric_mb`` and ``wan_util``.

The fill backend seam
----------------------------
Every flow-set or capacity change solves one *fill problem* (the
progressive-filling recompute). The fast allocator exposes that point
as a pluggable hook: installing a :class:`FillBackend` on
``NetworkFabric.fill_backend`` switches ``_reschedule`` from solving
inline to *deferring* — the fabric marks the fill pending, notifies the
backend, and arms nothing. The solution must arrive (``apply_fill`` with
externally computed per-class rates, or ``solve_fill_inline`` for the
scalar path) before simulated time next advances; ``_settle`` enforces
that with a hard error. Same-instant reschedules while a fill is pending
simply coalesce: zero-dt settles never read rates, so only the *last*
flow-set state of an instant needs solving — exactly the problem the
inline path's final recompute of that instant would have solved. The
lockstep executor (``repro_torch.sweep.lockstep``) uses this seam to batch
pending problems across many paused simulators into single
launches of the batched fill kernel (``repro_torch.sweep.vmap_fill``).
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.topology import ElasticLinks, LinkCapacities, VirtualCluster
from repro_torch.sim.engine import EventKernel, Subsystem

#: a flow whose remaining volume drops below this (1 byte) is complete
EPS_MB = 1e-6
_INF = float("inf")

# link-key type tags. Tuples compare lexicographically, giving the
# explicit total order progressive filling breaks ties with; "~cap"
# deliberately sorts after "down"/"up"/"wan" so a per-flow cap only wins
# a tie against a real link when it is strictly tighter.
UP, DOWN, WAN, FCAP = "up", "down", "wan", "~cap"

LinkKey = Tuple[str, int]
Path = Tuple[LinkKey, ...]
Sig = Tuple[Path, float]


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Enables the fabric for a run (``SimConfig.fabric``).

    ``links`` overrides the cluster's ``LinkCapacities`` (handy for
    oversubscription sweeps without rebuilding the cluster/workload).
    ``elastic`` derives pod capacities from the *live* host count
    instead (each VPS brings NIC bandwidth — scale-in/out reshapes the
    fabric); the fixed ``links`` default keeps golden trajectories
    untouched. ``completion_log`` records one entry per finished flow
    for the determinism claim checks; ``log_limit`` bounds how many
    entries are retained (claim checks use small runs — the 1024-host
    scale sweeps must not hold millions of tuples; dropped entries are
    counted in ``FabricSummary.log_dropped``). ``allocator`` selects the
    class-aggregated fast path (default) or the retained per-flow
    reference (``"reference"``) for equivalence tests and benchmarks.
    """

    links: Optional[LinkCapacities] = None
    completion_log: bool = True
    log_limit: Optional[int] = None
    elastic: Optional[ElasticLinks] = None
    allocator: str = "fast"
    #: record up to N fill problems (capacities + class states at a
    #: reschedule, plus the computed rates / next completion) into
    #: ``NetworkFabric.fill_snapshots`` — the ground truth the batched
    #: ``repro_torch.sweep.vmap_fill`` kernel is equivalence-tested against.
    #: 0 (default) captures nothing, costing one int compare/reschedule.
    capture_fills: int = 0


@dataclasses.dataclass
class FabricSummary:
    """Fabric-side accounting for one run (surfaced on ``SimResult``)."""

    n_flows: int = 0                 # completed flows
    n_cancelled: int = 0             # flows killed mid-transfer (churn)
    mb_total: float = 0.0            # MB fully drained through the fabric
    stall_s: float = 0.0             # sum over flows of (actual - mb/cap)
    #: kind -> [n_flows, mb, stall_s]
    by_kind: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    #: "up0"/"down1"/"wan" -> mean utilization over the run horizon
    link_util: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: (time, kind, mb) per completion, in completion order — the
    #: determinism and fast-vs-reference equivalence claims compare this
    #: log bit-for-bit (``FabricConfig.completion_log=False`` leaves it
    #: empty; ``log_limit`` keeps only the first N entries).
    #: Under speculation + checkpointing, ``by_kind["ckpt_write"]`` may
    #: exceed ``SimResult.ckpt_mb_written``: a losing speculative twin's
    #: store write physically drains through the fabric, but the store
    #: bills the winning attempt only (bit-locked semantics).
    completion_log: List[Tuple[float, str, float]] = dataclasses.field(
        default_factory=list)
    log_dropped: int = 0             # completions not logged (log_limit)
    #: fill problems solved but not snapshotted because the
    #: ``capture_fills`` budget was already spent — the capture seam's
    #: counterpart of ``log_dropped``, so a truncated corpus is visible
    #: instead of silently looking complete
    fills_dropped: int = 0


class FillBackend:
    """Pluggable solver hook for the fast allocator's fill problems.

    Install on ``NetworkFabric.fill_backend`` (any time after
    construction). From then on every ``_reschedule`` *defers* instead of
    solving: the fabric marks the fill pending and calls :meth:`defer`.
    The backend — synchronously inside ``defer`` or later, but strictly
    before the simulation's next time advance — must deliver the
    solution via ``fabric.apply_fill(rates)`` (externally computed
    per-class rates, e.g. from the batched ``repro_torch.sweep.vmap_fill``
    kernel) or ``fabric.solve_fill_inline()`` (the fabric's own scalar
    recompute). Deferring is free to coalesce: repeated ``defer`` calls
    at one instant supersede each other, and only the final flow-set
    state needs solving.
    """

    def defer(self, fabric: "NetworkFabric", now: float) -> None:
        raise NotImplementedError


class InlineFillBackend(FillBackend):
    """Degenerate backend: solves every deferred fill immediately with
    the fabric's own scalar recompute — trajectory-identical to running
    with no backend at all (the equivalence anchor of the deferred
    protocol, asserted in ``tests/test_lockstep.py``). ``timed=True``
    additionally accrues wall-clock spent solving into ``fill_s`` /
    ``n_fills`` — the scalar fill-path cost the lockstep benchmarks
    compare the batched path against."""

    def __init__(self, timed: bool = False):
        self.timed = timed
        self.fill_s = 0.0
        self.n_fills = 0

    def defer(self, fabric: "NetworkFabric", now: float) -> None:
        if not self.timed:
            fabric.solve_fill_inline()
            return
        import time
        t0 = time.perf_counter()
        fabric.solve_fill_inline()
        self.fill_s += time.perf_counter() - t0
        self.n_fills += 1


class _FabricBase(Subsystem):
    """State and accounting shared by the fast and reference allocators.

    Subclasses own the allocation core (``_settle``/``_recompute``/
    ``_reschedule``/``_on_flow``/``start_flow``/``cancel``); the base
    owns link capacities (fixed or elastic), carried-MB integrals, the
    completion summary and the subsystem wiring. The two allocators must
    stay *bit-identical* — any arithmetic either one performs on rates,
    progress counters or capacities is part of the shared spec.
    """

    def __init__(self, cluster: VirtualCluster,
                 cfg: Optional[FabricConfig] = None):
        self.cluster = cluster
        self.cfg = cfg or FabricConfig()
        self.links: LinkCapacities = self.cfg.links or cluster.links
        self._fids = itertools.count()
        self._epoch = 0
        self._last = 0.0
        self._caps: Dict[LinkKey, float] = {}
        self._carried: Dict[LinkKey, float] = {}  # MB integral
        self._load: Dict[LinkKey, float] = {}     # current sum rate
        # chaos derating: link -> surviving capacity fraction;
        # empty (the default) leaves every capacity untouched
        self._derate: Dict[LinkKey, float] = {}
        self.summary = FabricSummary()
        self._tel = None   # TelemetrySubsystem, cached at attach

    # -- subsystem protocol ----------------------------------------------------
    def attach(self, sim, kernel: EventKernel) -> None:
        super().attach(sim, kernel)
        # self-stepping: a flow transition frees no slots and queues no
        # work (task-visible transitions arrive as map_done/reduce_done/
        # rerep events, which do run the post-step), so dispatching here
        # would only drift the offer-shuffle RNG vs per-stream mode
        kernel.register("flow", self._on_flow, post_step=False)
        # telemetry is created before any subsystem attaches, so
        # one getattr here keeps the per-completion hot path branch-cheap
        self._tel = getattr(sim, "telemetry", None)
        el = self.cfg.elastic
        for p in self.cluster.pods:
            if el is not None:
                self._caps[(UP, p.index)] = el.host_up * p.n_hosts
                self._caps[(DOWN, p.index)] = el.host_down * p.n_hosts
            else:
                self._caps[(UP, p.index)] = self.links.pod_up
                self._caps[(DOWN, p.index)] = self.links.pod_down
        self._caps[(WAN, 0)] = (el.wan_per_host * self.cluster.n_hosts
                                if el is not None and el.wan_per_host > 0.0
                                else self.links.wan)
        for k in self._caps:
            self._carried[k] = 0.0
            self._load[k] = 0.0

    # -- elastic link capacities --------------------------------
    def on_host_added(self, hid, now: float) -> None:
        if self.cfg.elastic is not None:
            self._refresh_caps(hid.pod, now)

    def on_host_lost(self, host, now: float) -> None:
        if self.cfg.elastic is not None:
            self._refresh_caps(host.hid.pod, now)

    def _refresh_caps(self, pod: int, now: float) -> None:
        """A VPS joined/left ``pod``: re-derive its aggregate link
        capacities from the live host count (and the WAN from the fleet
        size, when per-host WAN scaling is on). Settles elapsed progress
        at the old rates first, so the capacity change takes effect at
        exactly ``now``."""
        self._settle(now)
        el = self.cfg.elastic
        n = self.cluster.pods[pod].n_hosts
        self._caps[(UP, pod)] = el.host_up * n
        self._caps[(DOWN, pod)] = el.host_down * n
        if el.wan_per_host > 0.0:
            self._caps[(WAN, 0)] = el.wan_per_host * self.cluster.n_hosts
        if self._derate:
            # chaos derates survive elastic recapacitation
            for k, f in self._derate.items():
                self._caps[k] = self._base_cap(k) * f
        self._caps_changed()
        self._reschedule(now)

    def _caps_changed(self) -> None:
        """Capacity-refresh hook; the fast allocator re-packs its caps
        vector here, the reference allocator needs nothing."""

    # -- chaos link faults -------------------------------------------
    def _base_cap(self, key: LinkKey) -> float:
        """Re-derive one link's nominal (underate) capacity from the
        live cluster state — the same arithmetic as ``attach`` /
        ``_refresh_caps``, factored out so derating composes with
        elastic recapacitation instead of compounding on itself."""
        tag, idx = key
        el = self.cfg.elastic
        if tag == WAN:
            return (el.wan_per_host * self.cluster.n_hosts
                    if el is not None and el.wan_per_host > 0.0
                    else self.links.wan)
        n = self.cluster.pods[idx].n_hosts
        if tag == UP:
            return el.host_up * n if el is not None else self.links.pod_up
        return el.host_down * n if el is not None else self.links.pod_down

    def set_derate(self, key: LinkKey, factor: float, now: float) -> None:
        """Derate one link to ``factor`` of its nominal capacity (0.0 =
        full partition: flows park on the starved link until restore;
        1.0 = restore). Settle-then-recapacitate, the same discipline as
        the elastic refreshes: progress accrued at the old rates is
        banked before the new capacity takes effect at exactly ``now``."""
        if key not in self._caps:
            raise KeyError(f"unknown link {key!r}")
        self._settle(now)
        if factor == 1.0:
            self._derate.pop(key, None)
        else:
            self._derate[key] = factor
        self._caps[key] = self._base_cap(key) * self._derate.get(key, 1.0)
        self._caps_changed()
        self._reschedule(now)

    # -- shared helpers ----------------------------------------------------------
    def path(self, src_pod: Optional[int], dst_pod: int) -> Path:
        """Link path of a transfer into ``dst_pod``. ``src_pod=None``
        means the bytes enter from outside the cluster (external durable
        store): they cross the WAN but no pod uplink."""
        if src_pod is None:
            return ((WAN, 0), (DOWN, dst_pod))
        if src_pod == dst_pod:
            return ((UP, src_pod), (DOWN, dst_pod))
        return ((UP, src_pod), (WAN, 0), (DOWN, dst_pod))

    def _accrue(self, dt: float) -> None:
        """Advance the link-carried integrals by ``dt`` at the rates
        fixed by the last recompute (called from ``_settle``)."""
        for k, load in self._load.items():
            if load:
                self._carried[k] += load * dt

    def _complete_one(self, f, now: float) -> None:
        s = self.summary
        s.n_flows += 1
        s.mb_total += f.mb
        stall = max(0.0, (now - f.t0) - f.mb / f.cap)
        s.stall_s += stall
        agg = s.by_kind.setdefault(f.kind, [0, 0.0, 0.0])
        agg[0] += 1
        agg[1] += f.mb
        agg[2] += stall
        if self.cfg.completion_log:
            limit = self.cfg.log_limit
            if limit is None or len(s.completion_log) < limit:
                s.completion_log.append((now, f.kind, f.mb))
            else:
                s.log_dropped += 1
        if self._tel is not None:
            self._tel.note_flow(f, now, stall)

    # -- accounting ----------------------------------------------------------------
    def finalize(self, horizon: float) -> FabricSummary:
        self._settle(max(horizon, self._last))
        for (tag, idx), mb in sorted(self._carried.items()):
            name = WAN if tag == WAN else f"{tag}{idx}"
            cap = self._caps[(tag, idx)]
            # elastic capacities move during the run; utilization is
            # reported against the final values (exact for fixed links)
            self.summary.link_util[name] = (
                mb / (cap * horizon) if cap > 0.0 and horizon > 0 else 0.0)
        return self.summary


class _Class:
    """One flow equivalence class: every live flow sharing ``sig =
    (path, cap)``. Max-min assigns all members the same rate, so the
    class carries the rate, the virtual-progress counter, and a sorted
    front of member targets; members hold only their target."""

    __slots__ = ("sig", "path", "cap", "n", "rate", "vdone", "front",
                 "dead", "fill_key")

    def __init__(self, sig: Sig):
        self.sig = sig
        self.path, self.cap = sig
        self.n = 0            # live members
        self.rate = 0.0       # per-member rate from the last recompute
        self.vdone = 0.0      # MB drained per member since class birth
        self.front: List[Tuple[float, int]] = []   # (target, fid) heap
        self.dead: Set[int] = set()   # cancelled fids still in `front`
        # the class-cap candidate key of progressive filling, built once
        self.fill_key = (self.cap, (FCAP, sig))


class _Flow:
    """One transfer. Progress lives on the class: the flow is done when
    ``cls.vdone`` reaches ``target`` (= the counter at join + volume)."""

    __slots__ = ("fid", "mb", "kind", "t0", "done", "cls", "target")

    def __init__(self, fid: int, mb: float, kind: str, t0: float,
                 done: Callable[[float], None], cls: _Class,
                 target: float):
        self.fid = fid
        self.mb = mb
        self.kind = kind
        self.t0 = t0
        self.done = done
        self.cls = cls
        self.target = target

    @property
    def cap(self) -> float:
        return self.cls.cap

    @property
    def rate(self) -> float:
        return self.cls.rate


class NetworkFabric(_FabricBase):
    """Class-aggregated max-min fair-share flow accounting (fast path)."""

    def __init__(self, cluster: VirtualCluster,
                 cfg: Optional[FabricConfig] = None):
        super().__init__(cluster, cfg)
        self._flows: Dict[int, _Flow] = {}
        self._classes: Dict[Sig, _Class] = {}
        # persistent recompute indexes, maintained at class birth/death
        # and flow admit/evict so each recompute starts from O(C) state:
        self._order: List[_Class] = []      # classes in sorted-sig order
        self._order_sigs: List[Sig] = []    # parallel bisect keys
        self._cap_order: List[_Class] = []  # classes by fill_key
        self._cap_keys: List[tuple] = []    # parallel bisect keys
        self._users: Dict[LinkKey, List[_Class]] = {}  # link -> classes
        self._nuse: Dict[LinkKey, int] = {}  # link -> live member count
        #: fill problems recorded when ``cfg.capture_fills`` > 0 (the
        #: repro_torch.sweep.vmap_fill equivalence corpus)
        self.fill_snapshots: List[dict] = []
        #: pluggable fill solver; None = solve inline (default)
        self.fill_backend: Optional[FillBackend] = None
        self._fill_pending = False
        self._pending_now = 0.0
        # class-structure arrays for fill_problem(): (members, fcap,
        # cap_rank) depend only on the class *set*. Built on the first
        # fill_problem() call and maintained incrementally at class
        # birth/death from then on (np.insert/np.delete — the class set
        # churns on most fills, so a rebuild-on-dirty cache thrashes).
        # None until a fill backend actually asks for dense problems, so
        # the inline allocator never pays for the maintenance.
        self._struct_arrays: Optional[tuple] = None
        self._link_order: List[LinkKey] = []
        self._link_idx: Dict[LinkKey, int] = {}
        self._caps_arr: Optional[np.ndarray] = None
        self._pending_n: Optional[np.ndarray] = None

    def attach(self, sim, kernel: EventKernel) -> None:
        super().attach(sim, kernel)
        self._users = {k: [] for k in self._caps}
        self._nuse = dict.fromkeys(self._caps, 0)
        # fixed for the fabric's lifetime: links are never added or
        # removed, only (elastically) re-capacitated. Sorted-key order
        # is the tie-break order, and therefore the packing order every
        # fill problem must use.
        self._link_order = sorted(self._caps)
        self._link_idx = {k: i for i, k in enumerate(self._link_order)}
        self._caps_changed()

    def _caps_changed(self) -> None:
        """Link capacities moved (attach, elastic resize): refresh the
        packed caps vector ``fill_problem`` snapshots from."""
        if self._link_order:
            self._caps_arr = np.fromiter(
                (self._caps[k] for k in self._link_order), float,
                len(self._link_order))

    # -- deferred fills --------------------------------------------------
    @property
    def fill_pending(self) -> bool:
        """True while a deferred fill awaits ``apply_fill`` /
        ``solve_fill_inline`` (the lockstep executor's pause signal)."""
        return self._fill_pending

    def fill_problem(self) -> dict:
        """The pending fill problem as dense arrays — the exact shape
        ``repro_torch.sweep.vmap_fill`` kernels consume, built from live state:

            caps      (L,)    link capacities, sorted-link-key order
            members   (C, L)  class-crosses-link incidence (0/1)
            n         (C,)    live members per class
            fcap      (C,)    per-flow rate cap per class
            cap_rank  (C,)    position in the fill_key (cap, sig) order
            remaining (C,)    earliest front target minus vdone — the
                              ETA numerator (inf when no live front)

        Classes appear in sorted-signature order (``self._order``) —
        the order ``apply_fill`` expects rates back in. The
        members/fcap/cap_rank block is maintained incrementally at
        class birth/death (first call builds it); n/remaining are
        snapshotted per problem, and caps whenever capacities move.
        remaining lets the batched kernel return ``dt_next`` alongside
        rates, collapsing ``apply_fill``'s rearm to a push (the front
        peeks happen here instead of in ``_arm`` — same heaps, same
        tombstone pops, just earlier in the barrier)."""
        if self._struct_arrays is None:
            self._build_struct()
        members, fcap, cap_rank = self._struct_arrays
        order = self._order
        C = len(order)
        n = np.fromiter((c.n for c in order), float, C)
        # remaining[k] = front target - vdone, the numerator of the
        # scalar ``_arm`` scan's ETA (same subtraction, just performed
        # here) — inf when the class has no live front. _front_target
        # is inlined: the overwhelmingly common case is a clean front
        # head (no tombstone), and a per-class method call is
        # measurable at this call rate.
        remaining = np.empty(C)
        inf = _INF
        for k, c in enumerate(order):
            front = c.front
            if front and front[0][1] in c.dead:
                dead = c.dead
                while front and front[0][1] in dead:
                    dead.discard(front[0][1])
                    heapq.heappop(front)
            remaining[k] = front[0][0] - c.vdone if front else inf
        # apply_fill reuses n for the link-load matvec (no sim progress
        # happens between the barrier's collect and its delivery)
        self._pending_n = n
        return {"caps": self._caps_arr, "members": members, "n": n,
                "fcap": fcap, "cap_rank": cap_rank,
                "remaining": remaining}

    def _build_struct(self) -> None:
        """Full (members, fcap, cap_rank) build — runs once, on the
        first ``fill_problem``; class birth/death maintains the arrays
        incrementally from then on (``_add_class``/``_drop_class``)."""
        order = self._order
        C = len(order)
        L = len(self._link_order)
        members = np.zeros((C, L))
        fcap = np.empty(C)
        idx = self._link_idx
        for j, cls in enumerate(order):
            fcap[j] = cls.cap
            row = members[j]
            for link in cls.path:
                row[idx[link]] = 1.0
        cap_rank = np.empty(C)
        pos = {cls.sig: j for j, cls in enumerate(order)}
        for rank, cls in enumerate(self._cap_order):
            cap_rank[pos[cls.sig]] = rank
        self._struct_arrays = (members, fcap, cap_rank)

    def apply_fill(self, rates, dt_next: Optional[float] = None) -> None:
        """Deliver a deferred fill's solution: ``rates[j]`` is the
        per-member rate of class ``j`` in ``self._order`` (the order
        ``fill_problem`` listed them) — a float sequence or 1-D array.
        Class rates are set from plain Python floats (``.tolist()``) so
        numpy scalars never leak into the progress arithmetic. Rearms
        the completion event exactly as the inline path would: via the
        shared ``_arm`` scan, or — when the solver already computed
        ``dt_next`` from the remaining array ``fill_problem``
        shipped (bit-identical arithmetic, ``inf`` = nothing to arm) —
        by pushing ``now + dt_next`` directly."""
        if not self._fill_pending:
            raise RuntimeError("apply_fill with no fill pending")
        order = self._order
        arr = np.asarray(rates, dtype=float)
        for cls, r in zip(order, arr.tolist()):
            cls.rate = r
        load = self._load
        arrs = self._struct_arrays
        if arrs is not None and len(arr) == len(order):
            # link loads via one matvec over the maintained incidence
            # matrix. Summation order differs from the scalar loop by
            # at most an ulp, which only the link-utilization telemetry
            # can see — loads feed the carried-MB integrals, never the
            # progress arithmetic the equivalence claims compare.
            n_arr = self._pending_n
            if n_arr is None or len(n_arr) != len(order):
                n_arr = np.fromiter((c.n for c in order), float,
                                    len(order))
            loads = (n_arr * arr) @ arrs[0]
            for k, v in zip(self._link_order, loads.tolist()):
                load[k] = v
        else:
            for k in load:
                load[k] = 0.0
            for c in order:
                r = c.rate * c.n
                for link in c.path:
                    load[link] += r
        self._fill_pending = False
        self._pending_n = None
        now = self._pending_now
        if dt_next is None:
            self._arm(now)
        else:
            dt = float(dt_next)
            self._finish_arm(now, now + dt if dt != _INF else None)

    def solve_fill_inline(self) -> None:
        """Deliver a deferred fill with the fabric's own scalar
        recompute — the backend-installed path degrades to exactly the
        inline allocator (used by :class:`InlineFillBackend` and the
        lockstep executor's scalar path, ``use_batched=False``)."""
        if not self._fill_pending:
            raise RuntimeError("solve_fill_inline with no fill pending")
        self._recompute()
        self._fill_pending = False
        self._arm(self._pending_now)

    # -- class bookkeeping -------------------------------------------------------
    def _add_class(self, sig: Sig) -> _Class:
        cls = _Class(sig)
        self._classes[sig] = cls
        i = bisect.bisect_left(self._order_sigs, sig)
        self._order_sigs.insert(i, sig)
        self._order.insert(i, cls)
        j = bisect.bisect_left(self._cap_keys, cls.fill_key)
        self._cap_keys.insert(j, cls.fill_key)
        self._cap_order.insert(j, cls)
        for link in cls.path:
            self._users[link].append(cls)
        arrs = self._struct_arrays
        if arrs is not None:
            # incremental maintenance of the fill_problem arrays: the
            # new class lands at order position i / cap rank j, pushing
            # existing ranks >= j up by one. Hand-rolled slice copies —
            # np.insert's python wrapper costs ~10x the memcpy.
            members, fcap, cap_rank = arrs
            C, L = members.shape
            m2 = np.zeros((C + 1, L))
            m2[:i] = members[:i]
            m2[i + 1:] = members[i:]
            idx = self._link_idx
            row = m2[i]
            for link in cls.path:
                row[idx[link]] = 1.0
            f2 = np.empty(C + 1)
            f2[:i] = fcap[:i]
            f2[i] = cls.cap
            f2[i + 1:] = fcap[i:]
            r2 = np.empty(C + 1)
            r2[:i] = cap_rank[:i]
            r2[i] = j
            r2[i + 1:] = cap_rank[i:]
            r2[r2 >= j] += 1.0
            r2[i] = j
            self._struct_arrays = (m2, f2, r2)
            self._pending_n = None
        return cls

    def _drop_class(self, cls: _Class) -> None:
        del self._classes[cls.sig]
        i = bisect.bisect_left(self._order_sigs, cls.sig)
        del self._order_sigs[i]
        del self._order[i]
        j = bisect.bisect_left(self._cap_keys, cls.fill_key)
        del self._cap_keys[j]
        del self._cap_order[j]
        for link in cls.path:
            self._users[link].remove(cls)
        arrs = self._struct_arrays
        if arrs is not None:
            members, fcap, cap_rank = arrs
            C, L = members.shape
            m2 = np.empty((C - 1, L))
            m2[:i] = members[:i]
            m2[i:] = members[i + 1:]
            f2 = np.empty(C - 1)
            f2[:i] = fcap[:i]
            f2[i:] = fcap[i + 1:]
            r2 = np.empty(C - 1)
            r2[:i] = cap_rank[:i]
            r2[i:] = cap_rank[i + 1:]
            r2[r2 > j] -= 1.0
            self._struct_arrays = (m2, f2, r2)
            self._pending_n = None

    # -- flow API ----------------------------------------------------------------
    def start_flow(self, now: float, mb: float, src_pod: Optional[int],
                   dst_pod: int, cap: float, kind: str,
                   done: Callable[[float], None]) -> int:
        """Begin draining ``mb`` from ``src_pod`` to ``dst_pod``; ``done``
        fires (via the kernel, deterministic order) on completion.
        Returns the flow id (pass to :meth:`cancel` to kill it)."""
        if mb <= EPS_MB:   # nothing to move: complete "immediately"
            self.kernel.call_at(now, done)
            return -1
        self._settle(now)
        fid = next(self._fids)
        sig = (self.path(src_pod, dst_pod), cap)
        cls = self._classes.get(sig)
        if cls is None:
            cls = self._add_class(sig)
        target = cls.vdone + mb
        self._flows[fid] = _Flow(fid, mb, kind, now, done, cls, target)
        cls.n += 1
        nuse = self._nuse
        for link in cls.path:
            nuse[link] += 1
        heapq.heappush(cls.front, (target, fid))
        self._reschedule(now)
        return fid

    def cancel(self, fid: int, now: float) -> None:
        """Kill an in-flight flow (its task died with a host). Bytes
        already moved stay carried; the callback never fires."""
        if fid not in self._flows:
            return
        self._settle(now)
        f = self._flows.pop(fid)
        cls = f.cls
        cls.n -= 1
        nuse = self._nuse
        for link in cls.path:
            nuse[link] -= 1
        if cls.n == 0:
            # last member gone: the class (and its progress counter)
            # dies with it — a later same-signature flow starts fresh
            self._drop_class(cls)
        else:
            cls.dead.add(fid)   # lazily dropped from the front heap
        self.summary.n_cancelled += 1
        self._reschedule(now)

    # -- mechanics ----------------------------------------------------------------
    def _settle(self, now: float) -> None:
        """Advance every *class* counter by the elapsed interval at the
        rates fixed by the last recompute — O(classes), not O(flows) —
        and accrue the link-carried integrals."""
        dt = now - self._last
        if dt > 0.0:
            if self._fill_pending:
                raise RuntimeError(
                    "simulated time advanced across a deferred fill: "
                    "the fill backend must deliver rates (apply_fill / "
                    "solve_fill_inline) before the next event instant")
            for cls in self._classes.values():
                if cls.rate:
                    cls.vdone += cls.rate * dt
            self._accrue(dt)
            self._last = now

    def _recompute(self) -> None:
        """Max-min fair allocation by progressive filling over classes.

        Each round takes the lexicographic minimum ``(share, link_key)``
        over real links (``share = remaining capacity / unfixed member
        count``) and class caps (share = the cap, key ``("~cap", sig)``
        so real links win exact ties), fixes every unfixed class on the
        winner, and debits each touched link once by ``members x share``.
        Classes are visited in sorted-signature order; the reference
        allocator performs the identical arithmetic from per-flow state,
        which is what makes the two bit-comparable.
        """
        rem_cap = dict(self._caps)
        # working copy of the persistent per-link live member counts;
        # integers — exact, so the shares match the reference's
        # from-scratch rescan bit for bit
        nuse = dict(self._nuse)
        users = self._users
        cap_order = self._cap_order
        unfixed: Set[Sig] = {c.sig for c in self._order}
        ci = 0
        n_caps = len(cap_order)
        while unfixed:
            best_key = None
            best_link = None
            for link, n in nuse.items():
                if n == 0:
                    continue
                key = (rem_cap[link] / n, link)
                if best_key is None or key < best_key:
                    best_key, best_link = key, link
            # the tightest unfixed class cap is the next live entry of
            # the fill_key-sorted class list (pointer advances lazily
            # past classes fixed through real links)
            while ci < n_caps and cap_order[ci].sig not in unfixed:
                ci += 1
            best_cls = None
            if ci < n_caps:
                c = cap_order[ci]
                if best_key is None or c.fill_key < best_key:
                    best_key, best_link, best_cls = c.fill_key, None, c
            rate = best_key[0]
            fixed = ([best_cls] if best_cls is not None else
                     [c for c in users[best_link] if c.sig in unfixed])
            dec: Dict[LinkKey, int] = {}
            for c in fixed:
                c.rate = rate
                unfixed.discard(c.sig)
                for link in c.path:
                    dec[link] = dec.get(link, 0) + c.n
            for link, k in dec.items():
                nuse[link] -= k
                rem_cap[link] = max(0.0, rem_cap[link] - k * rate)
        for k in self._load:
            self._load[k] = 0.0
        for c in self._order:
            r = c.rate * c.n
            for link in c.path:
                self._load[link] += r

    def _front_target(self, cls: _Class) -> Optional[float]:
        """Earliest live target of ``cls`` (drops cancelled tombstones)."""
        front = cls.front
        while front and front[0][1] in cls.dead:
            cls.dead.discard(front[0][1])
            heapq.heappop(front)
        return front[0][0] if front else None

    def _reschedule(self, now: float) -> None:
        """Recompute rates and (re)arm the next completion event.

        Candidates come from each class's sorted front — one O(classes)
        minimum instead of a min-scan over every live flow. Starved
        classes (rate 0.0 — a zero-capacity elastic link) arm nothing:
        their flows simply wait for the next flow-set or capacity
        change. The epoch counter invalidates any previously armed
        event.

        With a :class:`FillBackend` installed the solve is *deferred*:
        the fill is marked pending and nothing is armed until the
        backend delivers rates (``apply_fill``/``solve_fill_inline``,
        which run the identical arming arithmetic via ``_arm``).
        Same-instant reschedules coalesce — zero-dt settles never read
        rates, so solving only the instant's final flow-set state is
        exactly equivalent to the inline path's last recompute. The
        armed completion event lands at ``t_next`` strictly after
        ``now``, so arming from the barrier instead of mid-handler
        cannot reorder same-time events."""
        self._epoch += 1
        if not self._flows:
            # the last flow just drained: rates are all zero now, and
            # the carried-MB integrals must stop accruing across the
            # idle gap until the next flow starts. A pending fill is
            # withdrawn — there is nothing left to solve.
            for k in self._load:
                self._load[k] = 0.0
            self._fill_pending = False
            return
        backend = self.fill_backend
        if backend is not None:
            self._fill_pending = True
            self._pending_now = now
            backend.defer(self, now)
            return
        self._recompute()
        self._arm(now)

    def _arm(self, now: float) -> None:
        """Post-solve half of a reschedule: arm the next completion
        event from the class fronts and service the capture seam.
        Shared verbatim by the inline path and ``apply_fill``, so a
        deferred solve rearms bit-identically."""
        t_next = None
        for cls in self._classes.values():
            if cls.rate <= 0.0:
                continue
            target = self._front_target(cls)
            if target is not None:
                t = now + (target - cls.vdone) / cls.rate
                if t_next is None or t < t_next:
                    t_next = t
        self._finish_arm(now, t_next)

    def _finish_arm(self, now: float, t_next: Optional[float]) -> None:
        """Tail of a rearm — event push and the capture seam — shared
        by the ``_arm`` scan and ``apply_fill``'s solver-computed
        ``dt_next`` shortcut."""
        if t_next is not None:
            self.kernel.push(t_next, "flow", self._epoch)
        limit = self.cfg.capture_fills
        if limit:
            if len(self.fill_snapshots) < limit:
                self._capture_fill(now, t_next)
            else:
                self.summary.fills_dropped += 1

    def _capture_fill(self, now: float, t_next: Optional[float]) -> None:
        """Snapshot the fill problem this reschedule just solved — the
        inputs (link capacities, class membership/caps/progress/fronts)
        and the outputs (per-class rates, next completion) — for the
        batched-kernel equivalence suite. Pure observation: reads the
        post-recompute state and mutates nothing (``_front_target`` only
        drops already-cancelled tombstones, which is idempotent)."""
        classes = []
        for cls in self._order:
            classes.append({
                "path": [list(link) for link in cls.path],
                "cap": cls.cap, "n": cls.n, "vdone": cls.vdone,
                "target": self._front_target(cls), "rate": cls.rate})
        self.fill_snapshots.append({
            "now": now,
            "links": [[tag, idx, cap] for (tag, idx), cap
                      in sorted(self._caps.items())],
            "classes": classes,
            "dt_next": None if t_next is None else t_next - now})

    def _on_flow(self, now: float, epoch: int) -> None:
        if epoch != self._epoch:
            return   # superseded by a later flow-set change
        self._settle(now)
        finished: List[_Flow] = []
        empty: List[_Class] = []
        nuse = self._nuse
        for cls in self._classes.values():
            front, dead, vdone = cls.front, cls.dead, cls.vdone
            while front:
                target, fid = front[0]
                if fid in dead:
                    dead.discard(fid)
                    heapq.heappop(front)
                    continue
                if target - vdone <= EPS_MB:
                    heapq.heappop(front)
                    finished.append(self._flows.pop(fid))
                    cls.n -= 1
                    for link in cls.path:
                        nuse[link] -= 1
                    continue
                break
            if cls.n == 0:
                empty.append(cls)
        for cls in empty:
            self._drop_class(cls)
        # summary/log in flow-creation order (the reference completes in
        # dict order, which is fid order — the logs must compare equal)
        finished.sort(key=lambda f: f.fid)
        for f in finished:
            self._complete_one(f, now)
        self._reschedule(now)
        # callbacks fire after the surviving flow set is re-armed; they
        # may start new flows (each re-settles at dt=0 and re-arms)
        for f in finished:
            f.done(now)


def make_fabric(cluster: VirtualCluster,
                cfg: Optional[FabricConfig] = None) -> _FabricBase:
    """Build the fabric ``cfg`` asks for: the class-aggregated fast path
    (default) or the retained per-flow reference allocator."""
    cfg = cfg or FabricConfig()
    if cfg.allocator == "reference":
        from repro_torch.sim.network_reference import ReferenceNetworkFabric
        return ReferenceNetworkFabric(cluster, cfg)
    if cfg.allocator != "fast":
        raise ValueError(f"unknown fabric allocator {cfg.allocator!r}")
    return NetworkFabric(cluster, cfg)
