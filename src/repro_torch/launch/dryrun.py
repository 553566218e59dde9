"""Multi-pod dry run: every (architecture x input shape) cell sized for one
rank of the production mesh, with the roofline terms. Counterpart of
``repro/launch/dryrun.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--json out.json]

Exit code != 0 iff a requested cell fails.

JAX lowers and compiles each cell on 512 placeholder devices and reads the
HLO. No process group of 256 or 512 ranks can be started here, so a cell
is sized for one rank (index 0 on every axis) by running the port's own
step on ``meta`` tensors, with a ``MeshShape`` in place of a
``DeviceMesh``: the collectives then move nothing and log what they would
move (``sharding.collectives.LOG``). Per cell:

- the parameters are built on ``meta`` (``build_model(cfg,
  device="meta")``) and placed by ``sharding.params.place`` (the shardings
  of ``tree_shardings`` on ``make_production_mesh(...)`` and
  ``arch_rules``), the optimizer state split by ZeRO-1
  (``opt_state_axes``'s leaf rule, ``train.sharded``);
- memory is one rank's bytes, exact from the plan: ``argument_bytes`` the
  stored parameters, the optimizer state, the rank's rows of the batch and
  its cache; ``output_bytes`` what the step returns; ``alias_bytes`` what
  it updates in place (JAX donates it); ``temp_bytes`` is an estimate,
  named in the row's ``temp_bytes_by``;
- flops are counted by ``torch.utils.flop_counter.FlopCounterMode``, the
  bytes the ops read and write (their tensor inputs and outputs, as the
  HLO analysis counts top-level ops, elementwise ops fused) by
  ``Traffic``, and the collective bytes by the log, for one rank's share
  of the step: its rows of the batch, the gathered weights, the
  expert-parallel exchanges. The model runs at depth 1 and 2 (and encdec's
  encoder too), and the per-layer difference is multiplied by the depth,
  as the HLO analysis multiplies a scan body by its trip count; the
  training step's second half (the gradient reduction and ZeRO-1) runs at
  full depth. The model takes the card's path: flash attention and the
  GLA scan forward through the kernels' stand-ins (``kernels.meta``: one
  op of the kernel's own inputs and outputs, with the kernel's flops),
  backward through the plain versions' autograd, as on the card.

Training cells run the sharded step of ``train.sharded``; serving cells
(prefill, decode) the sharded serving step of ``serve.sharded``. Every
family runs tensor-parallel over 'model' in both (``sharding.tp``): a
rank holds and computes with its pieces of the attention, MLP, vocab and
its family's head blocks, the partial products all-reduced, and at
decode its S_max/M slots of the KV cache (and its heads of a recurrent
state), the ranks' attention partials exchanged and merged. The MoE
experts are held E/M a rank in both, expert-parallel where the sequence
splits over 'model' and each rank's experts' rows of the dense dispatch
at a decode step. A serving rank stores every weight as its pieces, as
a training rank does. The batch is split over the batch axes where it
divides; the step's tokens and logits (the rank's vocab columns, under
tensor parallelism) are all-gathered over the batch axes, as JAX's
replicated outputs are.

The roofline uses the H100 SXM's datasheet peaks
(``launch.hlo_analysis``: 989e12 bf16 FLOP/s, 3.35e12 B/s HBM, 450e9 B/s
NVLink 4 per direction).
"""
import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import ArchConfig, ShapeCell
# the kernels' stand-ins on meta; imported before any FlopCounterMode is
# made, which copies the flop formulas registered by then
from repro_torch.kernels import meta  # noqa: F401
from repro_torch.launch.hlo_analysis import CostTotals, Roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.hlo_analysis import HBM_BW, ICI_BW, PEAK_FLOPS
from repro_torch.models import build_model
from repro_torch.models.common import count_params, tree_map
from repro_torch.serve.sharded import ShardedServing
from repro_torch.sharding import DEFAULT_RULES, Rules
from repro_torch.sharding import collectives as col
from repro_torch.sharding.params import batch_axes
from repro_torch.sharding.partition import mesh_axes
from repro_torch.train import OptConfig, TrainConfig
from repro_torch.train.sharded import ShardedTraining

META = torch.device("meta")


def arch_rules(cfg: ArchConfig, *,
               overrides: Optional[Dict[str, Any]] = None) -> Rules:
    rules = DEFAULT_RULES
    if cfg.fsdp:
        # ZeRO-3-style weight sharding over 'data'; the expert weights are
        # gathered over 'data' before the expert-parallel exchange
        rules = rules.updated(embed="data", expert_in="data")
    if overrides:
        rules = rules.updated(**overrides)
    return rules


def opt_shapes(param_shapes, state_dtype: str = "float32"
               ) -> Dict[str, Any]:
    """JAX's optimizer-state shapes for a tree of param shapes (tensors on
    ``meta``): m and v in ``state_dtype``, an int32 step."""
    dt = getattr(torch, state_dtype)
    mv = tree_map(lambda s: torch.empty(s.shape, dtype=dt, device=META),
                  param_shapes)
    return {"m": mv, "v": tree_map(lambda s: s, mv),
            "step": torch.empty((), dtype=torch.int32, device=META)}


# ----------------------------------------------------------- counting --
class Traffic(TorchDispatchMode):
    """Bytes the aten ops read and write: each op's tensor inputs and
    outputs, as the HLO analysis counts a top-level op's operands and
    result. Elementwise (pointwise) ops are taken as fused into their
    neighbours, as XLA fuses them, and views move nothing."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if torch.Tag.pointwise not in func.tags and not any(
                r.alias_info is not None and not r.alias_info.is_write
                for r in func._schema.returns):
            self.nbytes += sum(t.numel() * t.element_size()
                               for t in tree_leaves((args, kwargs, out))
                               if isinstance(t, torch.Tensor))
        return out


@dataclasses.dataclass
class Counts:
    """One run's flops, op bytes and collective log (integers by (kind,
    group size))."""

    flops: float = 0.0
    mem_bytes: float = 0.0
    calls: Dict[Tuple[str, int], int] = dataclasses.field(
        default_factory=dict)
    nbytes: Dict[Tuple[str, int], int] = dataclasses.field(
        default_factory=dict)

    def plus(self, other: "Counts", mult: int = 1) -> "Counts":
        def add(a, b):
            return {k: a.get(k, 0) + mult * b.get(k, 0)
                    for k in set(a) | set(b) if a.get(k, 0) + mult
                    * b.get(k, 0)}
        return Counts(self.flops + mult * other.flops,
                      self.mem_bytes + mult * other.mem_bytes,
                      add(self.calls, other.calls),
                      add(self.nbytes, other.nbytes))

    def log(self) -> col.CollectiveLog:
        lg = col.CollectiveLog()
        lg.calls.update(self.calls)
        lg.nbytes.update(self.nbytes)
        return lg


def counted(fn) -> Counts:
    """Run fn() with the flop counter, the traffic counter and a fresh
    collective log."""
    col.LOG.reset()
    traffic = Traffic()
    with FlopCounterMode(display=False) as fc, traffic:
        fn()
    return Counts(float(fc.get_total_flops()), float(traffic.nbytes),
                  dict(col.LOG.calls), dict(col.LOG.nbytes))


def _depths(cfg: ArchConfig) -> Dict[str, int]:
    out = {"n_layers": cfg.n_layers}
    if cfg.encoder_layers:
        out["encoder_layers"] = cfg.encoder_layers
    return out


def by_depth(cfg: ArchConfig, run) -> Counts:
    """run(cfg') at depth 1 (every stack), then each stack at depth 2;
    the total at cfg's depths: base + sum over stacks (L - 1) x the
    difference."""
    depths = _depths(cfg)
    ones = {k: 1 for k in depths}
    base = run(dataclasses.replace(cfg, **ones))
    total = base
    for k, L in depths.items():
        if L > 1:
            two = run(dataclasses.replace(cfg, **dict(ones, **{k: 2})))
            total = total.plus(two.plus(base, -1), L - 1)
    return total


def _lengths(cfg: ArchConfig, cell: ShapeCell) -> Optional[Tuple[int, int]]:
    """Two sequence lengths to count a cell at, where every cost of the
    family is affine in the length beyond them and the two together are
    shorter than the cell's, else None: rwkv6 (the chunked scan) and
    hymba (the scan and banded attention, at multiples of the window from
    twice the window on)."""
    if cell.kind == "decode":
        return None
    if cfg.family == "ssm":
        lengths = (128, 256)
    elif cfg.family == "hybrid" and cfg.sliding_window:
        lengths = (2 * cfg.sliding_window, 3 * cfg.sliding_window)
    else:
        return None
    S1, S2 = lengths
    if cell.seq_len <= S1 + S2 or (cell.seq_len - S1) % (S2 - S1):
        return None
    return lengths


def by_shape(cfg: ArchConfig, cell: ShapeCell, run) -> Counts:
    """``by_depth`` of run(cfg', cell), the sequence too counted at two
    lengths and extrapolated where ``_lengths`` gives them."""
    lengths = _lengths(cfg, cell)
    if lengths is None:
        return by_depth(cfg, lambda c: run(c, cell))
    S1, S2 = lengths
    a, b = (by_depth(cfg, lambda c: run(c, dataclasses.replace(
        cell, seq_len=S))) for S in (S1, S2))
    return a.plus(b.plus(a, -1), (cell.seq_len - S1) // (S2 - S1))


def _meta_model(cfg: ArchConfig):
    return build_model(cfg, device=META)


def _nbytes(t) -> int:
    """The bytes of the tensors in t: through dicts, lists and tuples and
    the caches' dataclass records."""
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, dict):
        return sum(_nbytes(x) for x in t.values())
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    if dataclasses.is_dataclass(t) and not isinstance(t, type):
        return sum(_nbytes(getattr(t, f.name))
                   for f in dataclasses.fields(t))
    return 0


def _rows(x: torch.Tensor, axes, b_axes, mesh) -> torch.Tensor:
    """x's rows for this rank where its 'batch' dim splits over the batch
    axes, else x whole."""
    if "batch" not in axes or not b_axes:
        return x
    dim = axes.index("batch")
    n = col.axis_size(mesh, b_axes)
    if x.shape[dim] % n:
        return x
    return col.chunk_dim(x, mesh, b_axes, dim)


def rank_inputs(model, cell: ShapeCell, mesh, rules: Rules):
    """The cell's inputs (``input_specs``), each cut to this rank's rows
    along its 'batch' axis (``input_axes``)."""
    b_axes = batch_axes(mesh, rules)
    specs, axes = model.input_specs(cell), model.input_axes(cell)
    return tree_map(lambda s, ax: _rows(s, ax, b_axes, mesh), specs, axes)


# -------------------------------------------------------------- cells --
def count_train(cfg: ArchConfig, cell: ShapeCell, mesh, rules: Rules,
                tcfg: TrainConfig) -> Tuple[Counts, Dict[str, int], str]:
    """One rank's sharded train step: (counts, memory, temp estimate).
    The microbatches repeat one computation: one is counted, times
    ``n_micro``."""
    n = tcfg.n_micro
    one = dataclasses.replace(tcfg, n_micro=1)

    def first_half(c, cl):
        st = ShardedTraining(_meta_model(c), mesh, rules)
        mb = dataclasses.replace(cl, global_batch=cl.global_batch // n)
        batch = _meta_model(dataclasses.replace(c, n_layers=1)
                            ).input_specs(mb)
        return counted(lambda: st.grads(one, batch))

    if cell.global_batch % n:
        raise ValueError(f"{cell.global_batch} rows in {n} microbatches")
    counts = Counts().plus(by_shape(cfg, cell, first_half), n)
    batch = _meta_model(dataclasses.replace(cfg, n_layers=1)
                        ).input_specs(cell)
    full = ShardedTraining(_meta_model(cfg), mesh, rules)
    # this rank's ZeRO-1 slices, as JAX lowers its state from opt_shapes
    state = opt_shapes({n: torch.empty(full.state_shape(n), device=META)
                        for n in full.params if full.mine(n)},
                       tcfg.opt.state_dtype)
    grads = {n: torch.empty(p.shape, dtype=torch.float32, device=META)
             for n, p in full.params.items()}
    loss = torch.empty((), device=META)
    # the metrics accumulate_grads returns: "tokens" too for one micro
    metrics = {"loss": loss} if n > 1 else {"loss": loss, "tokens": loss}
    counts = counts.plus(counted(lambda: full.apply(
        tcfg, state, loss, metrics, grads)))
    params = sum(_nbytes(p) for p in full.params.values())
    opt = _nbytes(state)
    rows = _nbytes(full.rows(batch))
    # temp: the remat's saved layer inputs (one microbatch), the f32
    # logits with their gradient, the f32 gradient accumulators, and the
    # flat reduction buffer and its result
    B = full.rows(batch)["tokens"].shape[0] // tcfg.n_micro
    S = batch["tokens"].shape[1]
    acts = sum(_depths(cfg).values()) * B * S * cfg.d_model * \
        cfg.tdtype.itemsize
    logits = 2 * B * S * _vocab_cols(full.model) * 4
    n_local = sum(p.numel() for p in full.params.values())
    temp = acts + logits + 3 * 4 * n_local
    mem = {"argument_bytes": params + opt + rows,
           "output_bytes": params + opt + 3 * 4,
           "alias_bytes": params + opt, "temp_bytes": temp}
    return counts, mem, ("estimate: saved layer inputs + f32 logits and "
                         "their gradient + f32 gradients, accumulators "
                         "and reduction buffer")


def _vocab_cols(model) -> int:
    """The logit columns a rank computes: its vocab rows under tensor
    parallelism, else the padded vocab."""
    V = model.cfg.padded_vocab
    return V // model.tp.M if model.vocab_tp() else V


def _serving_param_bytes(model) -> int:
    """The weights a serving rank holds (``model`` placed by
    ``ShardedServing``): every stored piece, the experts' E/M among
    them."""
    return sum(p.numel() * p.element_size() for p in model.parameters())


def count_serve(cfg: ArchConfig, cell: ShapeCell, mesh, rules: Rules
                ) -> Tuple[Counts, Dict[str, int], str]:
    b_axes = batch_axes(mesh, rules)

    def serving_inputs(c, cl):
        serving = ShardedServing(_meta_model(c), mesh, rules)
        inputs = rank_inputs(serving.model, cl, mesh, rules)
        if cl.kind == "decode":
            inputs["cache"] = serving.cache_specs(
                inputs["tokens"].shape[0], serving.model.cache_len(cl))
        return serving, inputs

    def run(c, cl):
        serving, inputs = serving_inputs(c, cl)

        def go():
            if cell.kind == "prefill":
                toks, cache = serving.prefill(inputs)
                logits = None
            else:
                toks, logits, cache = serving.decode(
                    inputs["cache"], inputs["tokens"], cl.seq_len - 1)
                if isinstance(logits, list):
                    logits = logits[0]
            if b_axes and toks.shape[0] < cl.global_batch:
                col.gather_dim(toks, mesh, b_axes, 0)
                if logits is not None:
                    col.gather_dim(logits, mesh, b_axes, 0)
        return counted(go)

    counts = by_shape(cfg, cell, run)
    serving, inputs = serving_inputs(cfg, cell)
    model = serving.model
    params = _serving_param_bytes(model)
    B = inputs["tokens"].shape[0]
    V = _vocab_cols(model)
    logits = B * V * 4
    if cell.kind == "prefill":
        cache = _nbytes(serving.cache_specs(B, cell.seq_len))
        mem = {"argument_bytes": params + _nbytes(inputs),
               "output_bytes": B * 4 + cache, "alias_bytes": 0,
               "temp_bytes": B * inputs["tokens"].shape[1] * (
                   V * 4 + 4 * cfg.d_model * cfg.tdtype.itemsize)}
        by = ("estimate: the prompt's f32 logits and four activations of "
              "d_model")
    else:
        cache = _nbytes(inputs["cache"])
        mem = {"argument_bytes": params + _nbytes(inputs),
               "output_bytes": B * 4 + logits + cache,
               "alias_bytes": cache, "temp_bytes": logits}
        by = "estimate: the step's f32 logits"
    return counts, mem, by


def lower_cell(arch: str, shape: str, *, multi_pod: bool = False,
               rule_overrides: Optional[Dict[str, Any]] = None,
               n_micro: Optional[int] = None,
               opt_dtype: str = "float32") -> Dict[str, Any]:
    """Size one (arch, shape) cell for one rank. Returns its row."""
    cfg = get_config(arch)
    cell = SHAPES[shape]
    if not cfg.supports(shape):
        return {"arch": arch, "shape": shape, "status": "SKIP",
                "reason": cfg.skip_reason}
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = arch_rules(cfg, overrides=rule_overrides)
    if cell.kind == "train":
        micro = n_micro if n_micro is not None else (
            4 if cell.name == "train_4k" else 1)
        tcfg = TrainConfig(n_micro=micro,
                           opt=OptConfig(state_dtype=opt_dtype))
    else:
        tcfg = None
    return reckon(cfg, cell, mesh, rules, tcfg, arch=arch)


def spec_fields(cfg: ArchConfig, cell: ShapeCell) -> Dict[str, Any]:
    """A row's fields from the spec surface alone (JAX's spec methods)."""
    model = _meta_model(cfg)
    return {"n_params": count_params(model.param_specs()),
            "n_active_params": model.n_active_params(),
            "model_flops_global": model.model_flops(cell)}


def reckon(cfg: ArchConfig, cell: ShapeCell, mesh, rules: Rules,
           tcfg: Optional[TrainConfig] = None, *,
           arch: Optional[str] = None) -> Dict[str, Any]:
    """The row of any config and cell on a ``MeshShape`` (the production
    meshes through ``lower_cell``; a tiny one in the tests, whose
    collective log the gloo ranks' run must equal: ``row["log"]``)."""
    t0 = time.time()
    if cell.kind == "train":
        counts, mem, temp_by = count_train(cfg, cell, mesh, rules, tcfg)
    else:
        counts, mem, temp_by = count_serve(cfg, cell, mesh, rules)
    count_s = time.time() - t0
    n_dev = math.prod(mesh_axes(mesh).values())
    spec = spec_fields(cfg, cell)
    model_flops = spec["model_flops_global"]
    log = counts.log()
    wire = log.wire_bytes()
    totals = CostTotals(flops=counts.flops, mem_bytes=counts.mem_bytes,
                        collective_bytes=sum(wire.values()),
                        per_collective=wire, n_collectives=log.n_calls())
    rl = Roofline(compute_s=totals.flops / PEAK_FLOPS,
                  memory_s=totals.mem_bytes / HBM_BW,
                  collective_s=totals.collective_bytes / ICI_BW,
                  totals=totals,
                  model_flops_per_dev=model_flops / max(n_dev, 1))
    mem["per_device_total"] = (mem["argument_bytes"] + mem["output_bytes"]
                               - mem["alias_bytes"] + mem["temp_bytes"])
    return {
        "arch": arch or cfg.name, "shape": cell.name, "status": "OK",
        "mesh": "x".join(str(s) for s in mesh_axes(mesh).values()),
        "n_devices": n_dev,
        "count_s": round(count_s, 2),
        **spec,
        "flops_per_dev": totals.flops,
        "mem_bytes_per_dev": totals.mem_bytes,
        "collective_bytes_per_dev": totals.collective_bytes,
        "per_collective": {k: round(v) for k, v in wire.items()},
        "n_collectives": totals.n_collectives,
        "log": [[k, n, counts.calls[(k, n)], counts.nbytes[(k, n)]]
                for (k, n) in sorted(counts.calls)],
        "compute_s": rl.compute_s,
        "memory_s": rl.memory_s,
        "collective_s": rl.collective_s,
        "dominant": rl.dominant,
        "useful_flop_fraction": rl.useful_flop_fraction,
        "roofline_fraction": rl.roofline_fraction,
        "memory": mem,
        "temp_bytes_by": temp_by,
    }


def fmt_row(r: Dict[str, Any]) -> str:
    if r["status"] != "OK":
        return (f"{r['arch']:16s} {r['shape']:12s} {r['status']}: "
                f"{r.get('reason', r.get('error', ''))[:80]}")
    return (f"{r['arch']:16s} {r['shape']:12s} mesh={r['mesh']:9s} "
            f"compute={r['compute_s']*1e3:8.2f}ms "
            f"memory={r['memory_s']*1e3:8.2f}ms "
            f"coll={r['collective_s']*1e3:8.2f}ms "
            f"dom={r['dominant']:10s} "
            f"useful={r['useful_flop_fraction']:.2f} "
            f"roofline={r['roofline_fraction']:.2f} "
            f"mem/dev={r['memory']['per_device_total']/2**30:.2f}GiB "
            f"[{r['count_s']:.1f}s]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--opt-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--json", default=None, help="append results to file")
    ap.add_argument("--rules", default=None,
                    help="JSON dict of logical-rule overrides")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        archs = [args.arch] if args.arch else sorted(ARCHS)
        shapes = [args.shape] if args.shape else sorted(SHAPES)
        cells = [(a, s) for a in archs for s in shapes]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    overrides = json.loads(args.rules) if args.rules else None

    t0 = time.time()
    results = []
    failed = 0
    for arch, shape in cells:
        for mp in meshes:
            try:
                r = lower_cell(arch, shape, multi_pod=mp,
                               rule_overrides=overrides,
                               n_micro=args.n_micro,
                               opt_dtype=args.opt_dtype)
            except Exception as e:  # noqa: BLE001 - report and continue
                failed += 1
                r = {"arch": arch, "shape": shape, "status": "FAIL",
                     "mesh": "2x16x16" if mp else "16x16",
                     "error": f"{type(e).__name__}: {e}",
                     "traceback": traceback.format_exc()[-2000:]}
            results.append(r)
            print(fmt_row(r), flush=True)

    n_skip = sum(r["status"] == "SKIP" for r in results)
    print(f"dryrun: {len(results)} rows, {n_skip} SKIP, {failed} FAIL, "
          f"{time.time() - t0:.1f} s", flush=True)
    if args.json:
        existing = []
        if os.path.exists(args.json):
            with open(args.json) as f:
                existing = json.load(f)
        with open(args.json, "w") as f:
            json.dump(existing + results, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
