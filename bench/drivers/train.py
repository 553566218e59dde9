"""Training window: the program's ``make_train_step`` over its model (remat
on, AdamW as the traffic states), on B x S token rows drawn from the seed,
every step's rows different.

Set-up builds the one step object, with the model and optimizer state,
and drives it through its first ``CHECKED`` steps: the warm-up, and the
steps the reference follows. The window goes on with the same object.
Read after the window, against the float32 reference over the same
weights and rows (``limits/<cell>.json`` names those held to a limit; the
rest are printed under ``info``):

- ``loss_gap``: each of the three steps' loss, the largest relative gap;
  ``first_loss_gap``: the first step's alone;
- ``grad_gap``: each leaf's first gradient as the optimizer takes it
  (clipped; the program's read back from its first moment after one
  step), the gap of the norms over the larger of the reference's norm of
  that leaf and of the median leaf, the worst leaf;
- ``change_gap``: the same of each leaf's change over the three steps
  (what the fourth step starts from), leaving out the leaves whose
  reference gradient is under a thousandth of the median leaf's.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List

import torch

from bench import reference
from bench.harness import Context, free, program_model, sync
from bench.reference.adamw import AdamW

CHECKED = 3
#: a control or a fault stands in for the whole program: no window
STANDS_IN = True


@dataclasses.dataclass
class Readings:
    """What the comparison reads of one side."""
    losses: List[float]
    grad_norm: float                 # first step, before clipping
    grad_norms: Dict[str, float]     # first step, as the optimizer took it
    change_norms: Dict[str, float]   # |p after CHECKED steps - p at start|


@dataclasses.dataclass
class State:
    ctx: Context
    step: object = None
    opt_state: object = None
    model: object = None
    n: int = 0                        # steps taken so far
    window_steps: int = 0
    readings: Readings = None


def rows(ctx: Context, i: int) -> torch.Tensor:
    t = ctx.traffic
    return ctx.tokens((t["batch"], t["seq_len"]), "train", i)


def setup(ctx: Context) -> State:
    st = State(ctx)
    if ctx.control or ctx.fault:
        return st                     # the stand-in is read in the check
    from repro_torch.train import (OptConfig, TrainConfig, adamw_init,
                                   make_train_step)
    st.model = program_model(ctx)
    tcfg = TrainConfig(opt=OptConfig(**ctx.traffic["optimizer"]), remat=True)
    params = dict(st.model.named_parameters())
    st.opt_state = adamw_init(params)
    st.step = make_train_step(st.model, tcfg)
    losses, b1 = [], tcfg.opt.b1
    for i in range(CHECKED):
        _, met = _take(st)
        losses.append(met["loss"])
        if i == 0:
            grads = {n: torch.linalg.vector_norm(m.float()) / (1 - b1)
                     for n, m in st.opt_state["m"].items()}
            gnorm = met["grad_norm"]
    p0 = ctx.weights()
    change = {n: torch.linalg.vector_norm(p.detach().float() - p0[n].float())
              for n, p in params.items()}
    del p0
    st.readings = Readings([x.item() for x in losses], gnorm.item(),
                           _host(grads), _host(change))
    free(ctx.device)
    return st


def _host(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    vals = torch.stack(list(d.values())).tolist()
    return dict(zip(d, vals))


def _take(st: State):
    st.opt_state, met = st.step(st.opt_state, {"tokens": rows(st.ctx, st.n)})
    st.n += 1
    return st.opt_state, met


def unit(st: State) -> None:
    _take(st)
    st.window_steps += 1


def close(st: State) -> None:
    sync(st.ctx.device)


def end_to_end(st: State, elapsed: float) -> Dict[str, float]:
    t = st.ctx.traffic
    return {"train_tokens_per_s":
            st.window_steps * t["batch"] * t["seq_len"] / elapsed}


def window_record(st: State, elapsed: float) -> dict:
    t = st.ctx.traffic
    return {"steps": st.window_steps, "elapsed_s": elapsed,
            "batch": t["batch"], "seq_len": t["seq_len"]}


def attempted(st: State) -> int:
    return st.window_steps


def traced(st: State) -> dict:
    n = st.ctx.traffic["traced_steps"]
    for _ in range(n):
        _take(st)
    return {"steps": n}


def release(st: State) -> Readings:
    got = st.readings
    st.model = st.step = st.opt_state = None
    free(st.ctx.device)
    return got


# --------------------------------------------------------------- check --
def reference_readings(ctx: Context, precision: str = "f32",
                       fault: str = None) -> Readings:
    """The reference over the same weights and rows, CHECKED steps;
    ``fault`` "half_batch" takes the loss over the first half of each
    batch's rows."""
    ref, c = ctx.ref(), ctx.config
    reference.exact_float32()
    P = reference.params(ctx.weights(), grad=True)
    free(ctx.device)
    adam = AdamW(ctx.traffic["optimizer"], P)
    losses, grads = [], None
    for i in range(CHECKED):
        toks = rows(ctx, i)
        if fault == "half_batch":
            toks = toks[:toks.shape[0] // 2]
        loss = ref.loss(c, P, toks, precision)
        g = torch.autograd.grad(loss, list(P.values()))
        taken = adam.step(P, dict(zip(P, g)))
        losses.append(loss.detach())
        if i == 0:
            grads = taken
            gnorm = torch.sqrt(sum(x.square().sum() for x in g))
        del g
    del adam
    free(ctx.device)
    p0 = ctx.weights()
    change = {n: torch.linalg.vector_norm(p.detach() - p0[n].float())
              for n, p in P.items()}
    del P, p0
    free(ctx.device)
    return Readings([x.item() for x in losses], gnorm.item(), _host(grads),
                    _host(change))


def compare(got: Readings, ref: Readings) -> Dict[str, float]:
    """The three numbers of the module's docstring."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got.losses,
                                                        ref.losses))
    g_med = statistics.median(ref.grad_norms.values())

    def worst(a: Dict[str, float], b: Dict[str, float], keep) -> float:
        med = statistics.median(b[n] for n in keep)
        return max(abs(a[n] - b[n]) / max(b[n], med) for n in keep)

    moved = [n for n, g in ref.grad_norms.items() if g >= 1e-3 * g_med]
    return {"loss_gap": loss_gap,
            "first_loss_gap": abs(got.losses[0] - ref.losses[0])
            / abs(ref.losses[0]),
            "grad_gap": worst(got.grad_norms, ref.grad_norms,
                              list(ref.grad_norms)),
            "change_gap": worst(got.change_norms, ref.change_norms, moved)}


def explain(got: Readings, ref: Readings) -> Dict[str, object]:
    """Where the numbers come from: both sides' losses and first gradient
    norms before clipping, and the three leaves farthest apart in each
    norm (program, reference)."""
    def far(a, b):
        med = statistics.median(b.values())
        top = sorted(b, key=lambda n: -abs(a[n] - b[n]) / max(b[n], med))
        return [[n, a[n], b[n]] for n in top[:3]]
    return {"losses": [got.losses, ref.losses],
            "grad_norm": [got.grad_norm, ref.grad_norm],
            "grad_leaves": far(got.grad_norms, ref.grad_norms),
            "change_leaves": far(got.change_norms, ref.change_norms)}


def check(ctx: Context, got: Readings) -> Dict[str, float]:
    t0 = time.perf_counter()
    if ctx.control or ctx.fault:
        got = reference_readings(ctx, ctx.control or "f32", ctx.fault)
    ref = reference_readings(ctx)
    out = compare(got, ref)
    out.update(explain(got, ref), reference_s=time.perf_counter() - t0)
    return out
