"""Structured trace export: Chrome trace-event JSON + JSONL log.

The exporter buffers normalized event records — task attempts, fabric
flows, churn notices/kills, autoscale actions — and renders them two
ways:

* :meth:`TraceExporter.chrome_trace` — the Chrome trace-event format
  (``{"traceEvents": [...]}``) that Perfetto / ``chrome://tracing``
  load directly. Tracks are (pid, tid) pairs: one *process* per track
  group (a pod of hosts, the fabric), one *thread* per host or link, so
  task attempts render as slices on their host's track and flows as
  slices on the links they crossed.
* :meth:`TraceExporter.jsonl` — one JSON object per line, the
  machine-readable event log. Keys are sorted and timestamps are
  integer microseconds of *simulation* time, so the log for a given
  seed is byte-stable — :meth:`sha256` is the determinism gate's
  anchor (``BENCH_obs.json``'s probe, checked by
  ``tests/test_torch_obs.py`` and ``chip_smoke.py``).

Memory is bounded à la ``FabricConfig.log_limit``: ``limit=N`` keeps
the first N events and counts the rest in :attr:`dropped` (``None`` =
unbounded, ``0`` = keep nothing), so silent truncation is observable.

Determinism rules: no wall clock (timestamps are sim time), no RNG, and
insertion-ordered track ids — two runs of the same seed byte-compare
equal.
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional, Tuple


def _us(t: float) -> int:
    """Simulation seconds -> integer trace microseconds."""
    return int(round(t * 1e6))


def link_name(key) -> str:
    """Fabric LinkKey -> display name, matching
    ``FabricSummary.link_util`` ("up0"/"down1"/"wan")."""
    tag, idx = key
    return tag if tag == "wan" else f"{tag}{idx}"


class TraceExporter:
    def __init__(self, limit: Optional[int] = None):
        self.limit = limit
        self.dropped = 0
        # compact buffered tuples; rendering to trace-event dicts is
        # deferred to export time so the per-event cost during the
        # simulation is one tuple append. Shapes:
        #   ("X", (pid, tid), name, t0, t1, args|None)   duration slice
        #   ("i", (pid, tid), name, t,  None, args|None) instant
        #   ("F", links, kind, t0, t1, args, kept)       flow batch —
        #     ONE buffer entry for a whole flow, holding the allocator's
        #     shared path tuple; expands to `kept` per-link "X" slices
        #     at render time (keeps the hot path allocation-free per
        #     link, which keeps the gc quiet at the 4096-host point)
        self._events: List[tuple] = []
        self._n = 0  # rendered event count (flow batches expand)
        # (process name, thread name) -> (pid, tid); first-touch order
        self._tracks: Dict[Tuple[str, str], Tuple[int, int]] = {}
        self._pids: Dict[str, int] = {}
        self._tid_next: Dict[int, int] = {}

    def __len__(self) -> int:
        return self._n

    # -- tracks --------------------------------------------------------------
    def _track(self, process: str, thread: str) -> Tuple[int, int]:
        key = (process, thread)
        tr = self._tracks.get(key)
        if tr is None:
            pid = self._pids.get(process)
            if pid is None:
                pid = self._pids[process] = len(self._pids) + 1
                self._tid_next[pid] = 1
            tid = self._tid_next[pid]
            self._tid_next[pid] = tid + 1
            tr = self._tracks[key] = (pid, tid)
        return tr

    # -- emitters ------------------------------------------------------------
    # (hot path: these run once per task attempt / flow, so the limit
    # check and track lookup are inlined and the trace-event dict is
    # NOT built here — just one compact tuple append)
    def complete(self, process: str, thread: str, name: str,
                 t0: float, t1: float,
                 args: Optional[dict] = None) -> None:
        """A duration slice (``ph="X"``): a task attempt on its host's
        track."""
        if self.limit is not None and self._n >= self.limit:
            self.dropped += 1
            return
        tr = self._tracks.get((process, thread))
        if tr is None:
            tr = self._track(process, thread)
        self._events.append(("X", tr, name, t0, t1, args))
        self._n += 1

    def instant(self, process: str, thread: str, name: str, t: float,
                args: Optional[dict] = None) -> None:
        """A point event (``ph="i"``): churn notice/kill/join, an
        autoscale action."""
        if self.limit is not None and self._n >= self.limit:
            self.dropped += 1
            return
        tr = self._tracks.get((process, thread))
        if tr is None:
            tr = self._track(process, thread)
        self._events.append(("i", tr, name, t, None, args))
        self._n += 1

    def flow(self, links: tuple, kind: str, t0: float, t1: float,
             args: Optional[dict] = None) -> None:
        """A flow crossing ``links``: renders as one "X" slice per link
        on the ``fabric`` process. Buffered as a single entry holding
        the (shared) path tuple so the run-time cost is one append
        regardless of hop count; the cap counts the expanded per-link
        events, dropping from the tail."""
        k = len(links)
        if self.limit is not None:
            kept = min(k, self.limit - self._n)
            if kept <= 0:
                self.dropped += k
                return
            self.dropped += k - kept
        else:
            kept = k
        self._events.append(("F", links, kind, t0, t1, args, kept))
        self._n += kept

    # -- renderers -----------------------------------------------------------
    def _render(self) -> List[dict]:
        """Buffered tuples -> Chrome trace-event dicts (export time)."""
        out: List[dict] = []
        track = self._track
        tracks = self._tracks
        for ev in self._events:
            ph = ev[0]
            if ph == "F":
                _, links, kind, t0, t1, args, kept = ev
                ts, dur = _us(t0), _us(t1 - t0)
                for link in links[:kept]:
                    key = ("fabric", link_name(link))
                    tr = tracks.get(key)
                    if tr is None:
                        tr = track(*key)
                    d = {"ph": "X", "pid": tr[0], "tid": tr[1],
                         "name": kind, "ts": ts, "dur": dur}
                    if args:
                        d["args"] = args
                    out.append(d)
                continue
            _, (pid, tid), name, t0, t1, args = ev
            if ph == "X":
                d = {"ph": "X", "pid": pid, "tid": tid, "name": name,
                     "ts": _us(t0), "dur": _us(t1 - t0)}
            else:
                d = {"ph": "i", "s": "t", "pid": pid, "tid": tid,
                     "name": name, "ts": _us(t0)}
            if args:
                d["args"] = args
            out.append(d)
        return out

    def chrome_trace(self) -> dict:
        """The Perfetto-loadable document: metadata events naming every
        process/thread, then the buffered events. (Events render first —
        flow batches mint their link tracks lazily at render time.)"""
        events = self._render()
        meta: List[dict] = []
        for pname, pid in self._pids.items():
            meta.append({"ph": "M", "pid": pid, "name": "process_name",
                         "args": {"name": pname}})
        for (pname, tname), (pid, tid) in self._tracks.items():
            meta.append({"ph": "M", "pid": pid, "tid": tid,
                         "name": "thread_name", "args": {"name": tname}})
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms"}

    def jsonl(self) -> str:
        """One sorted-key JSON object per line; byte-stable per seed."""
        return "".join(json.dumps(e, sort_keys=True,
                                  separators=(",", ":")) + "\n"
                       for e in self._render())

    def sha256(self) -> str:
        return hashlib.sha256(self.jsonl().encode()).hexdigest()
