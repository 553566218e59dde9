"""Prefill window, an open loop of request batches: batch i of ``batch``
requests is due ``i / rate`` seconds into the window, whatever the server
is doing, for ``seconds`` seconds; the server takes them in order. Each is
routed by the program's JoSS router (``serve.lm.route_requests``),
prefilled by its ``make_prefill_step`` and decoded by its
``make_serve_step`` for ``gen_len`` tokens in all.

Batch i's prompt length is entry i of a replay of ``replay_batches``
lengths, each drawn independently from ``prompt_lens`` with the weights
``length_weights`` by a generator seeded with ``replay_seed``: long
prompts follow each other as often as the distribution makes them, and
every run sends the same lengths at the same times, so the tail is that of
one fixed replay whatever ``--seed``, which draws the prompts. A batch
holds one length: the program's prefill step takes a (B, P) batch, with no
length of its own for each row.

A request's time to first token runs from its batch's due time to its
first token on the host, after a synchronise: a wait in the queue counts.
Every batch due inside the window is served, late or not.

Compared after the window (``harness.logit_gaps``): a sample of
``check_requests`` finished requests drawn from the seed, the longest
prompt among them; the reference runs each prompt with its served tokens.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench import harness
from bench.harness import Context, free, program_model, sync


@dataclasses.dataclass
class State:
    ctx: Context
    model: object = None
    prefill: Dict[int, object] = None
    decode: object = None
    replay: List[int] = None            # batch i's prompt length
    n: int = 0                          # batches served in the window
    t0: Optional[float] = None          # the window's start
    closed: float = 0.0                 # when the window's time was up
    ttft: List[float] = dataclasses.field(default_factory=list)
    waits: List[float] = dataclasses.field(default_factory=list)
    prefills: List[list] = dataclasses.field(default_factory=list)
    served: list = dataclasses.field(default_factory=list)


def setup(ctx: Context) -> State:
    from repro_torch.train import make_prefill_step, make_serve_step
    t = ctx.traffic
    st = State(ctx)
    st.replay = replay(t)
    st.model = program_model(ctx)
    G = t["gen_len"]
    used = sorted(set(st.replay))
    st.prefill = {P: make_prefill_step(st.model, cache_len=P + G)
                  for P in used}
    st.decode = make_serve_step(st.model)
    for P in used:                        # every shape of the traffic
        _batch(st, P, ("warm", P), time.perf_counter(), record=False)
    st.ttft.clear()
    st.waits.clear()
    st.prefills.clear()
    sync(ctx.device)
    return st


def replay(t: dict) -> List[int]:
    """The traffic's prompt lengths, batch by batch."""
    w = np.asarray(t["length_weights"], dtype=np.float64)
    rng = np.random.default_rng(t["replay_seed"])
    pick = rng.choice(len(t["prompt_lens"]), size=t["replay_batches"],
                      p=w / w.sum())
    return [int(t["prompt_lens"][k]) for k in pick]


def length(st: State, i: int) -> int:
    return st.replay[i % len(st.replay)]


def _batch(st: State, P: int, stream: tuple, due: float,
           record: bool = True) -> None:
    from repro_torch.serve.lm import route_requests
    t, dev = st.ctx.traffic, st.ctx.device
    B, G = t["batch"], t["gen_len"]
    t0 = time.perf_counter()
    route_requests(B, P, G)
    nxt, cache = st.prefill[P]({"tokens": st.ctx.tokens((B, P), *stream)})
    sync(dev)
    t1 = time.perf_counter()
    out = [nxt]
    for j in range(G - 1):
        nxt, _, cache = st.decode(cache, nxt, P + j)
        out.append(nxt)
    toks = torch.cat(out, dim=1).cpu()
    del cache
    if record:
        st.ttft += [t1 - due] * B
        st.waits.append(t0 - due)
        st.prefills.append([B, P, t1 - t0])
        st.served += harness.finished(toks, [G] * B, stream, P)


def _serve(st: State, i: int, due: float) -> None:
    wait = due - time.perf_counter()
    if wait > 0:
        time.sleep(wait)
    _batch(st, length(st, i), ("prompt", i), due)


def unit(st: State) -> None:
    if st.t0 is None:
        st.t0 = time.perf_counter()
    _serve(st, st.n, st.t0 + st.n / st.ctx.traffic["rate"])
    st.n += 1


def close(st: State) -> None:
    """Serve every batch due before the window's end that is still
    waiting; the window ends when the last is done."""
    st.closed = time.perf_counter() - st.t0
    rate = st.ctx.traffic["rate"]
    while st.n / rate < st.closed:
        _serve(st, st.n, st.t0 + st.n / rate)
        st.n += 1
    sync(st.ctx.device)


def end_to_end(st: State, elapsed: float) -> Dict[str, float]:
    return {"ttft_p95_ms": 1e3 * float(np.percentile(st.ttft, 95)),
            "ttft_p50_ms": 1e3 * float(np.percentile(st.ttft, 50))}


def window_record(st: State, elapsed: float) -> dict:
    return {"batches": st.n, "elapsed_s": elapsed,
            "prefills": list(st.prefills),
            "wait_max_s": max(st.waits, default=0.0),
            "wait_last_s": st.waits[-1] if st.waits else 0.0}


def attempted(st: State) -> int:
    return st.n * st.ctx.traffic["batch"]


def traced(st: State) -> dict:
    """``traced_batches`` more batches, back to back."""
    before = len(st.prefills)
    for _ in range(st.ctx.traffic["traced_batches"]):
        _serve(st, st.n, time.perf_counter())
        st.n += 1
    return {"prefills": st.prefills[before:]}


def release(st: State) -> list:
    got = st.served
    st.model = st.prefill = st.decode = None
    free(st.ctx.device)
    return got


def check(ctx: Context, served: list) -> Dict[str, float]:
    t0 = time.perf_counter()
    out = harness.logit_gaps(
        ctx, harness.sample(served, ctx.seed, ctx.traffic["check_requests"]))
    out["reference_s"] = time.perf_counter() - t0
    return out
