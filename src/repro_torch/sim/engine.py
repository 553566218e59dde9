"""Reusable discrete-event kernel + subsystem protocol.

``sim/cluster_sim.py`` grew one inline ``elif kind == ...`` arm per feature
(dispatch, churn/autoscale, re-replication).
This module is the extension seam that replaces that pattern: a minimal
event kernel owning the heap and the deterministic sequencing, a *typed*
event registry (one handler per kind, registered up front — dispatching
an unknown kind is an error, not a silent fall-through), and a subsystem
protocol through which optional machinery (elastic churn/autoscaling,
durability, the network fabric) plugs into the simulator without the
simulator knowing its internals.

Determinism contract
--------------------
Events are ordered by ``(time, seq)`` where ``seq`` is a monotone counter
assigned at push. Ties in time therefore resolve in *push order*, exactly
the inline loop's semantics — the golden-trajectory suite
(``tests/test_engine_kernel.py``) holds the refactored simulator to
bit-identical trajectories, so the kernel must never reorder pushes,
consume RNG, or add/remove heap entries relative to the old inline loop.

Per-event flow in ``run()``::

    pop (time, seq, kind, payload)
    handler[kind](now, payload)          # the registered handler
    post_step(now)                       # scheduler dispatch, unless the
                                         # kind was registered with
                                         # post_step=False (it runs its own)
    stop()?                              # e.g. all work drained -> break

``post_step=False`` exists for the heartbeat: its handler must dispatch
*before* re-arming the heartbeat so same-instant completions keep their
historical sequence numbers (dispatch may push events; a second dispatch
call would also double-consume the shuffle RNG). A handler may also
return ``True`` to suppress the post-step for *that one event* — the
typed replacement for the old loop's ``continue`` on stale events
(a completion killed by churn, a late speculative twin): those must not
trigger a dispatch pass, or the offer-shuffle RNG stream diverges.

Subsystem protocol
------------------
A :class:`Subsystem` participates through two seams:

* **event kinds** — ``attach(sim, kernel)`` registers the kinds the
  subsystem owns (``churn``/``scale`` for elastic, ``rerep`` for
  durability, ``flow``/``call`` for the fabric); ``start(now)`` pushes
  its initial events after the workload's submits are enqueued.
* **hooks** — the simulator notifies every attached subsystem of the
  cluster-visible transitions: ``on_host_added`` / ``on_host_lost``
  (fleet mutation, after the simulator's own bookkeeping),
  ``on_host_notice`` / ``on_host_survived`` (announced departures and
  their cancellations — the migration seam), ``on_task_start``
  / ``on_task_finish`` (successful attempt transitions only — killed
  attempts are not reported), and ``on_tick`` (every heartbeat). All
  hooks default to no-ops, so a subsystem overrides only what it needs
  and the no-subsystem run pays nothing.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Dict, List, Optional, Tuple


class EventKernel:
    """Event heap + typed registry. One instance per simulation run."""

    def __init__(self):
        self._heap: List[Tuple[float, int, str, object]] = []
        self._seq = itertools.count()
        self._handlers: Dict[str, Callable[[float, object], None]] = {}
        self._self_stepping: set = set()   # kinds that run their own post_step
        self.now = 0.0

    # -- registry -------------------------------------------------------------
    def register(self, kind: str, handler: Callable[[float, object], None],
                 *, post_step: bool = True) -> None:
        """Bind ``kind`` to ``handler(now, payload)``.

        ``post_step=False`` marks the kind as self-stepping: the kernel
        will not run the per-event ``post_step`` after it (the handler is
        responsible for its own dispatch/ordering — see the heartbeat).
        """
        if kind in self._handlers:
            raise ValueError(f"event kind {kind!r} already registered")
        self._handlers[kind] = handler
        if not post_step:
            self._self_stepping.add(kind)

    # -- scheduling -------------------------------------------------------------
    def push(self, time: float, kind: str, payload: object = None) -> None:
        """Schedule ``kind`` at ``time``; same-time events fire in push
        order (the monotone ``seq`` breaks ties deterministically)."""
        if kind not in self._handlers:
            raise KeyError(f"cannot push unregistered event kind {kind!r}")
        heapq.heappush(self._heap, (time, next(self._seq), kind, payload))

    def call_at(self, time: float, fn: Callable[[float], None]) -> None:
        """Schedule a bare continuation (used by the fabric's task stage
        chains). The ``call`` kind is registered on first use; the
        payload IS the handler, so no per-callsite kind is needed. It is
        self-stepping: a continuation never frees slots or grows the
        backlog, so running the scheduler's post-step after it would only
        drift the offer-shuffle RNG stream away from per-stream mode."""
        if "call" not in self._handlers:
            self.register("call", _run_call, post_step=False)
        self.push(time, "call", fn)

    def __len__(self) -> int:
        return len(self._heap)

    # -- loop -------------------------------------------------------------------
    def run(self, *, post_step: Optional[Callable[[float], None]] = None,
            stop: Optional[Callable[[], bool]] = None,
            pause: Optional[Callable[[], bool]] = None) -> float:
        """Drain events until the heap empties or ``stop()`` is true after
        an event. Returns the time of the last processed event.

        ``pause`` is the lockstep seam: checked after ``stop`` at
        every event boundary, a true return suspends the loop *without*
        consuming state — the caller may service whatever the pause
        signals (e.g. a deferred fabric fill) and call ``run`` again to
        resume exactly where it left off. Heap, registry and ``now``
        survive across calls, so resumption is indistinguishable from
        never having paused."""
        heap = self._heap
        handlers = self._handlers
        self_stepping = self._self_stepping
        now = self.now
        while heap:
            now, _, kind, payload = heapq.heappop(heap)
            self.now = now
            skip_step = handlers[kind](now, payload)
            if (post_step is not None and not skip_step
                    and kind not in self_stepping):
                post_step(now)
            if stop is not None and stop():
                break
            if pause is not None and pause():
                break
        return now


def _run_call(now: float, payload) -> None:
    payload(now)


class Subsystem:
    """Base class for simulator plug-ins (elastic, durability, fabric).

    Lifecycle: ``attach`` (register event kinds, grab references) is
    called once before any event is pushed; ``start`` is called after
    the workload's submit events are enqueued, in attach order. The
    ``on_*`` hooks fire as documented in the module docstring.
    """

    def attach(self, sim, kernel: EventKernel) -> None:   # pragma: no cover
        self.sim = sim
        self.kernel = kernel

    def start(self, now: float) -> None:
        """Push initial events (churn trace, autoscale tick, ...)."""

    # -- hooks (all optional) ---------------------------------------------------
    def on_host_added(self, hid, now: float) -> None:
        """A host joined and is already in every offer/index structure."""

    def on_host_lost(self, host, now: float) -> None:
        """``host`` (the removed ``topology.Host``) just departed; the
        simulator has finished kill/requeue/gate bookkeeping."""

    def on_host_notice(self, hid, deadline, reason: str,
                       now: float) -> None:
        """Advance warning that ``hid`` will depart. ``deadline``
        is the announced kill instant (None for proactive compaction
        drains), ``reason`` the announced churn kind (``"preempt"`` /
        ``"expire"``) or ``"compact"``. The host is still alive and its
        tasks still running — the migration subsystem uses this window
        to drain and move work."""

    def on_host_survived(self, hid, now: float) -> None:
        """A previously-noticed departure did not happen (lease renewed,
        loss vetoed): ``hid`` stays in the fleet and should be undrained;
        in-flight migrations off it may be abandoned."""

    def on_task_start(self, log, now: float) -> None:
        """A task attempt started (``log`` is its ``TaskLog``)."""

    def on_task_finish(self, log, now: float) -> None:
        """A task attempt completed successfully (killed attempts and
        late speculative twins are not reported)."""

    def on_job_submit(self, job, now: float) -> None:
        """A job entered the system (its maps just joined the backlog)."""

    def on_job_finish(self, job, now: float) -> None:
        """The last task of ``job`` completed (observability seam)."""

    def on_tick(self, now: float) -> None:
        """One heartbeat elapsed (fires before the dispatch pass)."""


class ProfilingKernel(EventKernel):
    """``EventKernel`` with per-kind wall-clock accounting.

    The hot ``run()`` loop is duplicated rather than branch-instrumented
    so the production kernel pays nothing; benchmarks swap this in via
    ``Simulator._make_kernel`` (``benchmarks/bench_engine.py``). Timing
    uses the wall clock and is **for measurement only** — never attach
    this to a run whose trajectory feeds a determinism gate's *timing*
    claims (event ordering is unchanged; only wall time is observed).

    ``kind_s``/``kind_n`` accumulate handler seconds and event counts
    per kind; ``post_step_s`` the dispatch passes that follow them.
    """

    def __init__(self):
        super().__init__()
        self.kind_s: Dict[str, float] = {}
        self.kind_n: Dict[str, int] = {}
        self.post_step_s = 0.0

    def run(self, *, post_step: Optional[Callable[[float], None]] = None,
            stop: Optional[Callable[[], bool]] = None,
            pause: Optional[Callable[[], bool]] = None) -> float:
        import time
        perf = time.perf_counter
        heap = self._heap
        handlers = self._handlers
        self_stepping = self._self_stepping
        kind_s, kind_n = self.kind_s, self.kind_n
        now = self.now
        while heap:
            now, _, kind, payload = heapq.heappop(heap)
            self.now = now
            t0 = perf()
            skip_step = handlers[kind](now, payload)
            kind_s[kind] = kind_s.get(kind, 0.0) + (perf() - t0)
            kind_n[kind] = kind_n.get(kind, 0) + 1
            if (post_step is not None and not skip_step
                    and kind not in self_stepping):
                t0 = perf()
                post_step(now)
                self.post_step_s += perf() - t0
            if stop is not None and stop():
                break
            if pause is not None and pause():
                break
        return now
