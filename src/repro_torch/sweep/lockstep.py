"""Lockstep batched execution: many live simulators, one fill kernel.

The seeds/cells of one sweep group run as resumable coroutines
(``Simulator.begin/step/finish``) advancing in synchronized epochs, and
every fabric fill the epoch produces is solved in one launch of the
hand-written CUDA fill kernel (``kernels/csrc/fill.cu``) instead of one
scalar recompute per fabric. A copy of ``repro/sweep/lockstep.py`` with
the JAX solver replaced by the kernel.

The mechanism, end to end:

1. Each lane's fabric gets a :class:`FillBackend` whose ``defer`` does
   nothing but leave ``fill_pending`` set — the flag doubles as the
   event kernel's ``pause`` predicate, so the simulator suspends at the
   exact event boundary where the inline allocator would have solved.
2. The executor steps every lane until it pauses (a fill is pending) or
   drains, then gathers the pending problems — dense arrays straight
   from ``NetworkFabric.fill_problem()`` — and hands the whole epoch to
   ``vmap_fill.BatchedFillSolver``: one copy in, one kernel launch and
   one copy out per epoch (padding is inert in every kernel reduction,
   so each problem's result is independent of batch composition).
3. Rates go back through ``apply_fill``, which rearms the completion
   event with the *same* ``_arm`` arithmetic the inline path uses; the
   lane resumes next epoch exactly where it paused.

Lanes are **not** time-synchronized — each advances at its own pace
between barriers, one fill problem per lane per epoch. A dynamic gang
(default 64 lanes) refills from the cell queue as lanes retire, keeping
batches full for the whole matrix.

Correctness contract (``tests/test_torch_lockstep.py``, ``chip_smoke.py``):
per-cell metrics equal to scalar ``run_cell`` runs and a byte-identical
aggregate claim JSON. The kernel fills as the scalar allocator does, so
the batched path is bit-identical to the inline one. ``use_batched=False``
delivers every fill with ``solve_fill_inline`` per lane (same deferred
protocol, scalar solve); the executor never takes that path on its own.

Run the lockstep gate matrix on the card, beside the scalar inline
baseline (``--device cpu`` for the plain version on the CPU)::

    PYTHONPATH=src python -m repro_torch.sweep.lockstep [--seeds 32]
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Sequence

from repro_torch.sim.network import FillBackend
from repro_torch.sweep.cells import LOCKSTEP_BUILDERS, CellSpec, run_cell
from repro_torch.device import DeviceLike, resolve_device

MetricRow = Dict[str, float]

#: problems with at most this many classes are solved inline at the
#: barrier, as the JAX executor routes them (its measured crossover of
#: the scalar recompute against the batched path's fixed per-problem
#: cost: ~8-12 classes on 1 CPU core). Kept, so the epoch and problem
#: counts match the JAX package's
INLINE_C = 8


class DeferredFillBackend(FillBackend):
    """The lockstep fabric hook: ``defer`` is a no-op because the
    ``fill_pending`` flag it leaves behind *is* the whole signal — the
    kernel's pause predicate reads it, and the executor delivers rates
    at the epoch barrier."""

    def defer(self, fabric, now: float) -> None:
        pass


@dataclasses.dataclass
class LockstepStats:
    """Execution accounting for one :meth:`LockstepExecutor.run`."""

    n_cells: int = 0      # cells completed (batched + fallback)
    n_fallback: int = 0   # cells run scalar (family not batchable)
    epochs: int = 0       # barrier rounds
    problems: int = 0     # fill problems delivered at barriers
    inline_small: int = 0  # problems routed to the scalar solve (<= INLINE_C)
    batches: int = 0      # kernel launches (one per epoch with a batch)
    fill_s: float = 0.0   # wall seconds in the batched fill path
    wall_s: float = 0.0
    used_batched: bool = False
    device: str = ""
    #: the solver's split of its calls: pack_s, h2d_ms, kernel_ms,
    #: d2h_ms (CUDA events, with ``profile=True``), wait_s, solve_s,
    #: hold_short (``vmap_fill.BatchedFillSolver``)
    solver: Dict[str, float] = dataclasses.field(default_factory=dict)


class _Lane:
    """One live cell: its simulator, its result adapter, and the last
    event time ``step`` returned (the makespan once drained)."""

    __slots__ = ("key", "sim", "fabric", "finish", "end", "pause")

    def __init__(self, key: str, sim, finish):
        self.key = key
        self.sim = sim
        self.fabric = sim.fabric
        self.finish = finish
        self.end = 0.0
        # Pause only once the pending fill's rates could actually be
        # read: rates are consumed exclusively by dt>0 settles, so the
        # lane keeps stepping while the heap head cannot cause one.
        # Two coalescing opportunities fall out, both with bit-identical
        # trajectories (the inline allocator must solve every
        # reschedule — it cannot know one is about to be superseded):
        #
        #  * same-instant events (head time == now): zero-dt settles
        #    never read rates, so every reschedule in the burst
        #    supersedes the last and only the instant's *final*
        #    flow-set state needs solving;
        #  * armed "flow" events: while a fill is pending, every flow
        #    event in the heap is stale — arming only ever happens at
        #    delivery, so any armed event predates (and was superseded
        #    by) the epoch bump that marked the fill pending. Its
        #    handler is an epoch-mismatch no-op that settles nothing.
        #
        # Only a *foreign* strictly-later head (heartbeat, call, task
        # event — anything that may settle) or heap exhaustion forces
        # delivery.
        kern = sim.kernel
        heap = kern._heap
        fabric = sim.fabric

        def pause(f=fabric, h=heap, k=kern):
            if not f._fill_pending:
                return False
            if not h:
                return True
            head = h[0]
            return head[0] > k.now and head[2] != "flow"

        self.pause = pause


class LockstepExecutor:
    """Drives a cell list through the lockstep protocol. ``gang_size``
    bounds concurrent lanes (memory: each lane is a full simulator).
    ``use_batched=True`` solves each epoch with the fill kernel on
    ``device`` (the card unless ``device="cpu"``, which takes the plain
    version; without CUDA the default raises). ``use_batched=False``
    takes the scalar deferred path (the equivalence anchor)."""

    def __init__(self, *, gang_size: int = 64, use_batched: bool = True,
                 device: DeviceLike = None, profile: bool = False):
        self.gang_size = max(1, int(gang_size))
        self.use_batched = bool(use_batched)
        self.device = resolve_device(device) if self.use_batched else None
        self.profile = profile
        self.stats = LockstepStats()

    def run(self, specs: Sequence[CellSpec]) -> Dict[str, MetricRow]:
        """Execute every cell; returns ``{cell key: metrics}`` sorted
        by canonical key, exactly the shape ``SweepEngine.run`` results
        take. Families without a lockstep builder fall back to the
        scalar ``run_cell`` path inline."""
        t0 = time.perf_counter()
        st = self.stats
        results: Dict[str, MetricRow] = {}
        batchable: List[CellSpec] = []
        for spec in specs:
            if spec.family in LOCKSTEP_BUILDERS:
                batchable.append(spec)
            else:
                results[spec.key()] = run_cell(spec)
                st.n_fallback += 1
                st.n_cells += 1
        solver = None
        if self.use_batched and batchable:
            from repro_torch.sweep.vmap_fill import BatchedFillSolver
            solver = BatchedFillSolver(device=self.device,
                                       pad_batch=self.gang_size,
                                       profile=self.profile)
            st.used_batched = True
            st.device = str(self.device)
        # Dozens of live simulators mean a large stable object graph;
        # at the default gen0 threshold (~700 allocations) the
        # collector re-scans it constantly — ~20% of the executor's
        # wall time, measured. Collect once, then raise the threshold
        # for the drive; restored (with a final sweep) on exit.
        thresh = gc.get_threshold()
        gc.collect()
        gc.set_threshold(max(thresh[0], 100_000), *thresh[1:])
        try:
            self._drive(batchable, results, solver)
        finally:
            gc.set_threshold(*thresh)
            gc.collect()
            if solver is not None:
                st.batches = solver.n_batches
                st.solver = dict(solver.timing)
                solver.close()
        st.wall_s = time.perf_counter() - t0
        return {k: results[k] for k in sorted(results)}

    def _drive(self, specs: Sequence[CellSpec],
               results: Dict[str, MetricRow], solver) -> None:
        st = self.stats
        queue = list(specs)
        queue.reverse()          # pop() keeps submission order
        backend = DeferredFillBackend()
        gang: List[_Lane] = []
        while queue or gang:
            # refill: keep the gang (and therefore the batches) full
            while queue and len(gang) < self.gang_size:
                spec = queue.pop()
                builder = LOCKSTEP_BUILDERS[spec.family]
                sim, finish = builder(spec)
                sim.begin()
                if sim.fabric is None:
                    raise RuntimeError(
                        f"lockstep builder for {spec.family!r} built a "
                        "simulator without a fabric")
                sim.fabric.fill_backend = backend
                gang.append(_Lane(spec.key(), sim, finish))
            # epoch: advance every lane to its next fill (or further)
            pending: List[_Lane] = []
            for lane in gang:
                fabric = lane.fabric
                assert not fabric.fill_pending, \
                    "lane resumed with an undelivered fill"
                lane.end = lane.sim.step(pause=lane.pause)
                if fabric.fill_pending:
                    pending.append(lane)
            st.epochs += 1
            # barrier: one batched solve for the whole epoch
            if pending:
                t1 = time.perf_counter()
                if solver is not None:
                    # tiny problems go scalar, as the JAX executor
                    # routes them (INLINE_C)
                    batched = []
                    for lane in pending:
                        if len(lane.fabric._order) <= INLINE_C:
                            lane.fabric.solve_fill_inline()
                            st.inline_small += 1
                        else:
                            batched.append(lane)
                    if batched:
                        sols = solver.solve(
                            [l.fabric.fill_problem() for l in batched])
                        for lane, (row, dt) in zip(batched, sols):
                            # apply_fill converts to plain floats
                            # itself; numpy scalars never touch
                            # progress arithmetic
                            lane.fabric.apply_fill(row, dt_next=dt)
                else:
                    for lane in pending:
                        lane.fabric.solve_fill_inline()
                st.fill_s += time.perf_counter() - t1
                st.problems += len(pending)
            # retire drained lanes (their last fill, if any, was just
            # delivered above, so finalize's settle sees solved rates)
            still: List[_Lane] = []
            for lane in gang:
                if lane.sim._drained():
                    results[lane.key] = lane.finish(
                        lane.sim.finish(lane.end))
                    st.n_cells += 1
                elif (len(lane.sim.kernel) == 0
                      and not lane.fabric.fill_pending):
                    raise RuntimeError(
                        f"lockstep deadlock: cell {lane.key} has an "
                        "empty event heap but unfinished work")
                else:
                    still.append(lane)
            gang = still


# ------------------------------------------------------ the gate matrix --
#: the lockstep gate point of ``benchmarks/bench_sweep.py``: the
#: contention family at 8 pods x 8 hosts and 24 jobs (17 fabric links,
#: fills of up to ~47 classes), every algorithm and scenario, 32 seeds
GATE_ALGOS = ("joss-t", "joss-j", "fifo", "fair", "capacity")
GATE_SCENARIOS = ("uncontended", "oversub8", "oversub24")
GATE_HOSTS_PER_POD = (8,) * 8
GATE_N_JOBS = 24
GATE_SEEDS = 32
GATE_GANG = 64
#: the metrics of the aggregate claim rows whose sha the gate compares
CLAIM_METRICS = ("wtt", "int_mb")
#: seeds of the profiled run that splits a solve's time (``run_gate``)
PROFILE_SEEDS = 4


def gate_matrix(n_seeds: int = GATE_SEEDS) -> List[CellSpec]:
    from repro_torch.sweep.cells import matrix
    return matrix("fabric_contention", GATE_ALGOS, GATE_SCENARIOS, n_seeds,
                  hosts_per_pod=GATE_HOSTS_PER_POD, n_jobs=GATE_N_JOBS)


def scalar_baseline(specs: Sequence[CellSpec]):
    """Every cell in turn through its lockstep builder with a timed
    inline backend: the scalar allocator doing exactly the solves the
    inline path does. Returns (results, wall_s, fill_s, n_fills)."""
    from repro_torch.sim.network import InlineFillBackend
    results: Dict[str, MetricRow] = {}
    fill_s = 0.0
    n_fills = 0
    t0 = time.perf_counter()
    for spec in specs:
        sim, finish = LOCKSTEP_BUILDERS[spec.family](spec)
        sim.begin()
        backend = InlineFillBackend(timed=True)
        sim.fabric.fill_backend = backend
        end = sim.step()
        results[spec.key()] = finish(sim.finish(end))
        fill_s += backend.fill_s
        n_fills += backend.n_fills
    wall_s = time.perf_counter() - t0
    return ({k: results[k] for k in sorted(results)}, wall_s, fill_s,
            n_fills)


def run_gate(n_seeds: int = GATE_SEEDS, device: DeviceLike = None,
             profile: bool = False) -> dict:
    """The gate matrix through the batched lockstep executor on
    ``device``, beside the scalar inline baseline and the scalar
    deferred path (seed-0 cells); with ``profile``, a profiled batched
    run over the first ``PROFILE_SEEDS`` seeds splits a solve's time.
    Returns the counts, times and checks (``cells_equal``,
    ``aggregate_equal``, ``deferred_equal``)."""
    import hashlib

    from repro_torch.sweep.engine import aggregate_json
    specs = gate_matrix(n_seeds)
    scalar, s_wall, s_fill, s_fills = scalar_baseline(specs)
    ex = LockstepExecutor(gang_size=GATE_GANG, device=device)
    batched = ex.run(specs)
    seed0 = [s for s in specs if s.seed == 0]
    deferred_ex = LockstepExecutor(gang_size=GATE_GANG, use_batched=False)
    deferred = deferred_ex.run(seed0)
    split = None
    if profile:
        # the split of a solve, from a second batched run over the first
        # seeds (a profiled solve holds its stream, so its run's fill_s
        # is not the headline one)
        few = [s for s in specs if s.seed < PROFILE_SEEDS]
        pex = LockstepExecutor(gang_size=GATE_GANG, device=device,
                               profile=True)
        same = pex.run(few) == {s.key(): scalar[s.key()] for s in few}
        split = {"cells": len(few), "equal": same,
                 "batches": pex.stats.batches,
                 "hold_short": pex.stats.solver["hold_short"],
                 "per_batch": {k: v / max(1, pex.stats.batches)
                               for k, v in pex.stats.solver.items()
                               if k != "hold_short"}}
    agg_b = aggregate_json(batched, metrics=CLAIM_METRICS)
    agg_s = aggregate_json(scalar, metrics=CLAIM_METRICS)
    n_diff = sum(batched.get(k) != v for k, v in scalar.items())
    st = ex.stats
    return {
        "cells": len(specs), "n_seeds": n_seeds, "device": st.device,
        "cells_equal": set(batched) == set(scalar) and n_diff == 0,
        "cells_differing": n_diff,
        "deferred_equal": all(deferred[s.key()] == scalar[s.key()]
                              for s in seed0),
        "aggregate_equal": agg_b == agg_s,
        "aggregate_sha256": hashlib.sha256(agg_b.encode()).hexdigest(),
        "scalar_aggregate_sha256": hashlib.sha256(
            agg_s.encode()).hexdigest(),
        "batched": {"epochs": st.epochs, "problems": st.problems,
                    "inline_small": st.inline_small, "batches": st.batches,
                    "fill_s": st.fill_s, "wall_s": st.wall_s,
                    "solver": st.solver},
        "scalar": {"fill_s": s_fill, "fill_solves": s_fills,
                   "wall_s": s_wall},
        "profile": split,
        "deferred": {"cells": len(seed0),
                     "epochs": deferred_ex.stats.epochs,
                     "problems": deferred_ex.stats.problems,
                     "wall_s": deferred_ex.stats.wall_s},
    }


def _table(r: dict) -> str:
    b, s = r["batched"], r["scalar"]
    rows = [("path", "cells", "fill s", "fill solves", "wall s"),
            ("scalar inline", str(r["cells"]), f"{s['fill_s']:.2f}",
             str(s["fill_solves"]), f"{s['wall_s']:.2f}"),
            (f"lockstep (batched, {r['device']})", str(r["cells"]),
             f"{b['fill_s']:.2f}", str(b["problems"]), f"{b['wall_s']:.2f}")]
    widths = [max(len(row[i]) for row in rows) for i in range(5)]
    lines = [" | ".join(c.ljust(w) for c, w in zip(row, widths))
             for row in rows]
    lines.insert(1, "-+-".join("-" * w for w in widths))
    lines.append(f"[lockstep: {b['epochs']} epochs, {b['batches']} kernel "
                 f"batches, {b['inline_small']} small problems inlined]")
    lines.append(f"[aggregate sha256 over {CLAIM_METRICS}: "
                 f"{r['aggregate_sha256']}; per-cell equal: "
                 f"{r['cells_equal']}; aggregate equal: "
                 f"{r['aggregate_equal']}; scalar deferred path equal on "
                 f"{r['deferred']['cells']} cells: {r['deferred_equal']}]")
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="the lockstep gate matrix through the fill kernel, "
                    "beside the scalar inline baseline")
    ap.add_argument("--seeds", type=int, default=GATE_SEEDS)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain version)")
    args = ap.parse_args(argv)
    r = run_gate(args.seeds, device=args.device)
    print(_table(r))
    ok = r["cells_equal"] and r["aggregate_equal"] and r["deferred_equal"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
