"""Batched max-min progressive fill: the fabric allocator's fill problems,
many at once, in one launch of a hand-written CUDA kernel.

Counterpart of ``repro/sweep/vmap_fill.py``, whose batched path is a
``jax.vmap(lax.while_loop)`` in float64. Here the batched path is
``kernels/csrc/fill.cu`` (``kernels.fill``), float64 on the card, with its
plain PyTorch version ``fill_rates_dt_ref`` for CPU tensors. Both fill
exactly as the scalar allocator ``NetworkFabric._recompute`` does, round
for round, so the batched solve is bit-identical to the inline one, not
merely within ``RTOL``.

This module holds, copied from the JAX package as they are:

  * :func:`fill_reference` — scalar progressive filling + front math on
    one snapshot, mirroring ``NetworkFabric._recompute``/``_arm``
    arithmetic operation-for-operation;
  * :class:`PackedProblems`, :func:`batched_fill_reference` and
    :func:`orderings_match`;

and the port's own :class:`BatchedFillSolver`, the lockstep executor's
engine, and :func:`batched_fill` over snapshots.

Problems come as the snapshot dicts ``NetworkFabric`` records:

    {"links":   [[tag, idx, cap], ...],          # sorted by link key
     "classes": [{"path": [[tag, idx], ...], "cap": c, "n": k,
                  "vdone": v, "target": t-or-None, "rate": r}, ...],
     "dt_next": seconds-or-None}                 # scalar outputs

or as the dense ``fill_problem()`` dicts the live fabric emits.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import fill as fk
from repro_torch.kernels.fill import fill_rates_dt_ref  # noqa: F401

#: relative tolerance the JAX package holds its batched kernel to; the
#: port's kernel is held to bit-equality, and ``orderings_match`` keeps
#: the JAX contract's ordering check available
RTOL = 1e-9

_INF = float("inf")

#: device clock cycles a profiled solve holds its stream for (~1 ms on an
#: H100), longer than the host takes to issue the copies and the launch;
#: ``timing["hold_short"]`` counts the calls where it did not
PROFILE_HOLD_CYCLES = 2_000_000


# --------------------------------------------------------- reference --
def fill_reference(snapshot: dict) -> dict:
    """Scalar progressive filling + completion-front math on one
    snapshot — the pure-Python path, arithmetic-identical to
    ``NetworkFabric._recompute`` (same shares, same tie-breaks, same
    ``max(0, rem - k * rate)`` debits, same division order)."""
    links = [((tag, idx), float(cap))
             for tag, idx, cap in snapshot["links"]]
    classes = snapshot["classes"]
    caps = dict(links)
    rem = dict(caps)
    nuse = {k: 0 for k in caps}
    paths = []
    for c in classes:
        path = tuple((tag, idx) for tag, idx in c["path"])
        paths.append(path)
        for link in path:
            nuse[link] += c["n"]
    unfixed = set(range(len(classes)))
    # fill_key = (cap, ("~cap", sig)) with sig = (path, cap): "~cap"
    # is a constant prefix, so the order reduces to (cap, sig)
    cap_order = sorted(unfixed,
                       key=lambda i: (classes[i]["cap"],
                                      (paths[i], classes[i]["cap"])))
    users = {k: [i for i in range(len(classes)) if k in paths[i]]
             for k in caps}
    rates = [0.0] * len(classes)
    ci = 0
    while unfixed:
        best_key = None
        best_link = None
        for link, n in nuse.items():
            if n == 0:
                continue
            key = (rem[link] / n, link)
            if best_key is None or key < best_key:
                best_key, best_link = key, link
        while ci < len(cap_order) and cap_order[ci] not in unfixed:
            ci += 1
        best_cls = None
        if ci < len(cap_order):
            i = cap_order[ci]
            fill_key = (classes[i]["cap"],
                        ("~cap", (paths[i], classes[i]["cap"])))
            if best_key is None or fill_key < best_key:
                best_key, best_link, best_cls = fill_key, None, i
        rate = best_key[0]
        fixed = ([best_cls] if best_cls is not None else
                 [i for i in users[best_link] if i in unfixed])
        dec: Dict[tuple, int] = {}
        for i in fixed:
            rates[i] = rate
            unfixed.discard(i)
            for link in paths[i]:
                dec[link] = dec.get(link, 0) + classes[i]["n"]
        for link, k in dec.items():
            nuse[link] -= k
            rem[link] = max(0.0, rem[link] - k * rate)
    etas = [( (c["target"] - c["vdone"]) / r
              if r > 0.0 and c["target"] is not None else None)
            for c, r in zip(classes, rates)]
    finite = [e for e in etas if e is not None]
    return {"rates": rates, "etas": etas,
            "dt_next": min(finite) if finite else None}


# ----------------------------------------------------------- packing --
class PackedProblems:
    """A batch of snapshots padded to uniform (C, L): the array form
    both kernels consume. Padded links carry zero members and +inf
    capacity; padded classes have n=0 and start pre-fixed."""

    __slots__ = ("caps", "members", "n", "fcap", "cap_rank", "vdone",
                 "target", "n_classes", "n_links")

    def __init__(self, snapshots: Sequence[dict]):
        S = len(snapshots)
        # floors of 1: a zero-class/zero-link snapshot (or an empty
        # batch) still packs to valid arrays — its lanes are all
        # padding, which the kernel resolves to rate 0 / eta inf
        self.n_links = L = max(
            1, max((len(s["links"]) for s in snapshots), default=0))
        self.n_classes = C = max(
            1, max((len(s["classes"]) for s in snapshots), default=0))
        self.caps = np.full((S, L), _INF)
        self.members = np.zeros((S, C, L))
        self.n = np.zeros((S, C))
        self.fcap = np.full((S, C), _INF)
        self.cap_rank = np.full((S, C), C, dtype=float)
        self.vdone = np.zeros((S, C))
        self.target = np.full((S, C), _INF)
        for si, snap in enumerate(snapshots):
            link_idx = {}
            for li, (tag, idx, cap) in enumerate(snap["links"]):
                link_idx[(tag, idx)] = li
                self.caps[si, li] = cap
            paths = []
            for cj, c in enumerate(snap["classes"]):
                path = tuple((tag, idx) for tag, idx in c["path"])
                paths.append(path)
                for link in path:
                    self.members[si, cj, link_idx[link]] = 1.0
                self.n[si, cj] = c["n"]
                self.fcap[si, cj] = c["cap"]
                self.vdone[si, cj] = c["vdone"]
                if c["target"] is not None:
                    self.target[si, cj] = c["target"]
            order = sorted(range(len(paths)),
                           key=lambda i: (snap["classes"][i]["cap"],
                                          (paths[i],
                                           snap["classes"][i]["cap"])))
            for rank, i in enumerate(order):
                self.cap_rank[si, i] = rank


def batched_fill(snapshots: Sequence[dict], device: DeviceLike = None
                 ) -> dict:
    """Evaluate a batch of snapshots in one call of ``kernels.fill``
    (the kernel on the card, its plain version on the CPU). Returns
    ``{"rates": (S, C), "etas": (S, C), "dt_next": (S,)}`` numpy float64
    arrays; padded lanes hold rate 0 / eta inf."""
    dev = resolve_device(device)
    p = PackedProblems(snapshots)
    S, C = p.n.shape
    if S == 0:
        return {"rates": np.zeros((0, C)), "etas": np.zeros((0, C)),
                "dt_next": np.zeros((0,))}
    remaining = p.target - p.vdone
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (p.caps, p.members.astype(np.uint8), p.n, p.fcap,
                      p.cap_rank, remaining)]
    rates, dt = fk.fill_rates_dt(*args)
    rates = rates.cpu().numpy()
    live = (rates > 0.0) & np.isfinite(p.target)
    with np.errstate(divide="ignore", invalid="ignore"):
        etas = np.where(live, (p.target - p.vdone) / np.where(
            live, rates, 1.0), _INF)
    return {"rates": rates, "etas": etas, "dt_next": dt.cpu().numpy()}


# ------------------------------------------------------ live solver ---
class BatchedFillSolver:
    """Persistent batched solver for *live* fill problems, the lockstep
    executor's engine; a drop-in for the JAX package's solver of the same
    name, with the same ``solve``.

    Each epoch's problems are packed, at the batch's largest (C, L), into
    one pinned host buffer (float64 vectors, then the members as bytes),
    copied to the card in one copy, solved in one kernel launch (one warp
    a problem) and copied back in one copy; ``solve`` waits for that copy
    and returns numpy rows, so ``apply_fill`` stays in Python floats. The
    arrays of ``fill_problem()`` are copied into the buffer, never held:
    the fabric reuses them. ``device="cpu"`` solves with the plain version.

    ``pad_batch``/``pad_classes``/``pad_links`` are accepted for parity
    with the JAX solver and not used: XLA needed a few fixed shapes to
    avoid recompiles, the kernel takes any shape. ``profile=True`` times
    the split of each call into :attr:`timing`: the host's pack and wait
    by its clock, and the copy in, the kernel and the copy out by CUDA
    events on the device. So that those intervals hold no time the card
    spends waiting for the host to issue the next operation, a profiled
    call first holds the stream in a ``PROFILE_HOLD_CYCLES`` spin while
    the host issues all three (``hold_short`` counts the calls whose
    issue outlasted it); that hold adds to the call's wall time, so a
    profiled run is not the one to read ``fill_s`` from."""

    def __init__(self, *, device: DeviceLike = None, pad_batch: int = 64,
                 pad_classes: int = 48, pad_links: int = 24,
                 profile: bool = False):
        self.device = resolve_device(device)
        self.pad_batch, self.pad_classes, self.pad_links = (
            pad_batch, pad_classes, pad_links)
        self.profile = profile and self.device.type == "cuda"
        self.n_batches = 0
        self.n_problems = 0
        self.timing = {"pack_s": 0.0, "h2d_ms": 0.0, "kernel_ms": 0.0,
                       "d2h_ms": 0.0, "wait_s": 0.0, "solve_s": 0.0,
                       "hold_short": 0}
        self._host_in = self._dev_in = None
        self._host_out = self._dev_out = None

    def close(self) -> None:
        self._host_in = self._dev_in = None
        self._host_out = self._dev_out = None

    def __enter__(self) -> "BatchedFillSolver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _buffers(self, n_in: int, n_out: int):
        """(host in, device in, host out, device out), grown to fit."""
        cuda = self.device.type == "cuda"
        if self._host_in is None or self._host_in.numel() < n_in:
            size = max(n_in, 2 * (0 if self._host_in is None
                                  else self._host_in.numel()))
            self._host_in = torch.empty(size, dtype=torch.uint8,
                                        pin_memory=cuda)
            self._dev_in = (torch.empty(size, dtype=torch.uint8,
                                        device=self.device)
                            if cuda else self._host_in)
        if self._host_out is None or self._host_out.numel() < n_out:
            size = max(n_out, 2 * (0 if self._host_out is None
                                   else self._host_out.numel()))
            self._host_out = torch.empty(size, dtype=torch.float64,
                                         pin_memory=cuda)
            self._dev_out = (torch.empty(size, dtype=torch.float64,
                                         device=self.device)
                             if cuda else self._host_out)
        return self._host_in, self._dev_in, self._host_out, self._dev_out

    def solve(self, problems: Sequence[dict]
              ) -> List[Tuple[np.ndarray, float]]:
        """Solve a batch of ``fill_problem()`` dicts; returns, per
        problem, ``(rates, dt_next)`` — the per-member rate of each
        class in the problem's own class order (shape ``(C_i,)``,
        float64) and the seconds to the earliest completion under
        those rates (``inf`` when no class arms one)."""
        if not problems:
            return []
        t0 = time.perf_counter()
        S = len(problems)
        C = max(p["n"].shape[0] for p in problems)
        L = max(p["caps"].shape[0] for p in problems)
        n_f = S * (L + 4 * C)
        n_in = 8 * n_f + S * C * L
        n_out = S * C + 2 * S
        h_in, d_in, h_out, d_out = self._buffers(n_in, n_out)
        # pack: float64 caps (S, L), n, fcap, cap_rank, remaining (S, C),
        # then members (S, C, L) as bytes; every pad value is rewritten
        raw = h_in.numpy()
        f = raw[:8 * n_f].view(np.float64)
        caps = f[:S * L].reshape(S, L)
        vec = f[S * L:].reshape(4, S, C)
        n, fcap, rank, rem = vec
        members = raw[8 * n_f:n_in].reshape(S, C, L)
        caps.fill(_INF)
        n.fill(0.0)
        fcap.fill(_INF)
        rank.fill(float(C))
        rem.fill(_INF)
        members.fill(0)
        for si, p in enumerate(problems):
            ci = p["n"].shape[0]
            li = p["caps"].shape[0]
            caps[si, :li] = p["caps"]
            members[si, :ci, :li] = p["members"]
            n[si, :ci] = p["n"]
            fcap[si, :ci] = p["fcap"]
            rank[si, :ci] = p["cap_rank"]
            rem[si, :ci] = p["remaining"]
        t1 = time.perf_counter()
        if self.device.type == "cpu":
            rates, dts = fk.fill_rates_dt(*self._views(h_in, S, C, L))
            rates, dts = rates.numpy(), dts.numpy()
            t_wait = 0.0
        else:
            rates, dts, t_wait = self._solve_cuda(d_in, h_out, d_out, n_in,
                                                  S, C, L)
        out = [(rates[si, :p["n"].shape[0]].copy(), float(dts[si]))
               for si, p in enumerate(problems)]
        self.n_batches += 1
        self.n_problems += S
        tm = self.timing
        tm["pack_s"] += t1 - t0
        tm["wait_s"] += t_wait
        tm["solve_s"] += time.perf_counter() - t0
        return out

    @staticmethod
    def _views(buf: torch.Tensor, S: int, C: int, L: int):
        """(caps, members, n, fcap, cap_rank, remaining) over a packed
        buffer, host or device."""
        n_f = S * (L + 4 * C)
        f = buf[:8 * n_f].view(torch.float64)
        vec = f[S * L:].view(4, S, C)
        members = buf[8 * n_f:8 * n_f + S * C * L].view(S, C, L)
        return (f[:S * L].view(S, L), members, vec[0], vec[1], vec[2],
                vec[3])

    def _solve_cuda(self, d_in, h_out, d_out, n_in, S, C, L):
        prof = self.profile
        if prof:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            t_issue = time.perf_counter()
            ev[4].record()
            torch.cuda._sleep(PROFILE_HOLD_CYCLES)
            ev[0].record()
        d_in[:n_in].copy_(self._host_in[:n_in], non_blocking=True)
        if prof:
            ev[1].record()
        n_out = S * C + 2 * S
        fk.launch(*self._views(d_in, S, C, L), d_out[:n_out])
        if prof:
            ev[2].record()
        h_out[:n_out].copy_(d_out[:n_out], non_blocking=True)
        if prof:
            ev[3].record()
            t_issue = time.perf_counter() - t_issue
        t0 = time.perf_counter()
        torch.cuda.current_stream(self.device).synchronize()
        t_wait = time.perf_counter() - t0
        if prof:
            tm = self.timing
            tm["h2d_ms"] += ev[0].elapsed_time(ev[1])
            tm["kernel_ms"] += ev[1].elapsed_time(ev[2])
            tm["d2h_ms"] += ev[2].elapsed_time(ev[3])
            # the split holds no host time only if the host issued every
            # operation before the hold ran out
            tm["hold_short"] += t_issue * 1e3 > ev[4].elapsed_time(ev[0])
        res = h_out[:n_out].numpy()
        fk.raise_on_status(res[S * C + S:])
        return res[:S * C].reshape(S, C), res[S * C:S * C + S], t_wait


def batched_fill_reference(snapshots: Sequence[dict]) -> dict:
    """The pure-Python loop in the batched API shape — the serial
    baseline the batched kernel is held against."""
    S = len(snapshots)
    C = max(1, max((len(s["classes"]) for s in snapshots), default=0))
    rates = np.zeros((S, C))
    etas = np.full((S, C), _INF)
    dt = np.full((S,), _INF)
    for i, snap in enumerate(snapshots):
        ref = fill_reference(snap)
        for j, (r, e) in enumerate(zip(ref["rates"], ref["etas"])):
            rates[i, j] = r
            if e is not None:
                etas[i, j] = e
        if ref["dt_next"] is not None:
            dt[i] = ref["dt_next"]
    return {"rates": rates, "etas": etas, "dt_next": dt}


def contention_snapshots(algo: str = "joss-t",
                         scenario: str = "oversub8", *,
                         n_jobs: int = 12, seed_index: int = 0,
                         hosts_per_pod: Tuple[int, ...] = (8, 8),
                         limit: int = 256) -> List[dict]:
    """Real fill problems captured from one ``fabric_contention`` cell
    of the port's simulator (``FabricConfig.capture_fills``), seed
    re-derived from the cell key, as the JAX package's function of the
    same name captures them from its simulator."""
    from repro_torch.core.joss import make_algorithm
    from repro_torch.sim.cluster_sim import SimConfig, Simulator
    from repro_torch.sim.network import FabricConfig
    from repro_torch.sim.workloads import (fabric_links, make_cluster,
                                           profiling_prelude,
                                           small_workload)
    from repro_torch.sweep.cells import WAN_OVERSUB, CellSpec, make_params
    spec = CellSpec("fabric_contention", algo, scenario, seed_index,
                    make_params(hosts_per_pod=hosts_per_pod,
                                n_jobs=n_jobs))
    seed = spec.sim_seed()
    links = fabric_links(hosts_per_pod,
                         wan_oversub=WAN_OVERSUB[scenario])
    cluster = make_cluster(hosts_per_pod, links=links)
    jobs = small_workload(cluster, seed=seed, n_jobs=n_jobs)
    for j in jobs:
        j.submit_time = 0.0
    algorithm = make_algorithm(algo, cluster)
    if hasattr(algorithm, "registry"):
        for j in profiling_prelude(cluster):
            algorithm.registry.record(j, j.true_fp)
    cfg = SimConfig(fabric=FabricConfig(completion_log=False,
                                        capture_fills=limit))
    sim = Simulator(cluster, algorithm, jobs, config=cfg, seed=seed)
    sim.run()
    return sim.fabric.fill_snapshots


def orderings_match(etas_a: np.ndarray, etas_b: np.ndarray,
                    rtol: float = RTOL) -> bool:
    """True when two per-class completion-ETA vectors imply the same
    completion ordering: finite entries sort identically, with entries
    closer than ``rtol`` treated as ties (the batched kernel may move a
    value a few ulp, which must never count as a reordering)."""
    a = np.asarray(etas_a, dtype=float)
    b = np.asarray(etas_b, dtype=float)
    if a.shape != b.shape or not np.array_equal(np.isfinite(a),
                                                np.isfinite(b)):
        return False
    idx = np.where(np.isfinite(a))[0]
    order_a = sorted(idx, key=lambda i: (a[i], i))
    order_b = sorted(idx, key=lambda i: (b[i], i))
    for ia, ib in zip(order_a, order_b):
        if ia == ib:
            continue
        # a swap is only legal between near-equal ETAs (a tie)
        if not np.isclose(a[ia], a[ib], rtol=rtol, atol=0.0):
            return False
    return True
