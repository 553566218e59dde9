"""AdamW, as ``repro/train/optimizer.py`` computes it, and the logical
axes of its ZeRO-1 state (``zero1_leaf_axes``, ``opt_state_axes``, on
JAX's stacked spec tree; ``train/sharded.py`` places the state by them).

The port's params are the model's named parameters, one leaf per layer,
where JAX stacks each layer leaf into (L, ...). The state mirrors them:
``{"m": {name: tensor}, "v": {name: tensor}, "step": int32 scalar}``, m
and v in ``state_dtype``; the math runs in f32. ``adamw_update`` writes
the params and the state in place (the model holds its parameters).

Weight decay follows JAX's decision leaf by leaf. JAX decays a leaf iff
``p.ndim >= 2``, meant as "no decay on norms and biases", but its layer
leaves carry the stacked L dim, so every layer leaf decays (norm scales,
biases, ``ln_x``, ``u`` and ``a_log`` included), as does every leaf of
encdec's stacked encoder, and of the other leaves only the matrices do.
``decays`` reproduces that by name.

A leaf of more than ``CHUNK`` elements is updated, and its squares summed,
in flat pieces of ``CHUNK``: the f32 temporaries of one update (up to
four at once) would otherwise be the leaf's size each, 8.5 GB for one
2.1 B-param expert leaf of dbrx-132b. The update is elementwise, so its
pieces give the same bits; the norm adds the pieces' sums.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import torch

from repro_torch.models.common import ParamSpec, ParamTree, tree_map
from repro_torch.sharding.partition import (Rules, logical_to_spec,
                                            mesh_axis_size)

#: the largest piece of a leaf the update and the norm take at once, in
#: elements (256 MB of f32)
CHUNK = 1 << 26


def _pieces(*ts: torch.Tensor):
    """``ts`` (same numel) as one tuple when small, else tuples of equal
    flat slices of CHUNK elements, views that write through."""
    n = ts[0].numel()
    if n <= CHUNK or not all(t.is_contiguous() for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for i in range(0, n, CHUNK):
        yield tuple(f[i:i + CHUNK] for f in flat)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # moment storage dtype: float32, or bfloat16 to halve optimizer-state
    # memory (math still runs in f32)
    state_dtype: str = "float32"


def lr_schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in f32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = t.clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Mapping[str, torch.Tensor],
               state_dtype: str = "float32") -> Dict[str, object]:
    """Zero moments shaped as ``params`` (a name -> tensor mapping, e.g.
    ``dict(model.named_parameters())``) and step 0, on their devices."""
    dt = getattr(torch, state_dtype)
    dev = next(iter(params.values())).device
    return {"m": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for n, p in params.items()},
            "v": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(s for x in tree.values() for s in piece_sums(x)))


def decays(name: str, p: torch.Tensor) -> bool:
    """JAX's ``p.ndim >= 2`` on the JAX leaf: a layer leaf always has the
    stacked L dim there, so every ``layers.*`` leaf decays, and so does
    every leaf of encdec's stacked ``encoder``. Of the unstacked ones, the
    matrices decay (``frontend.proj``, ``projector.w1``) and the vectors
    do not (``final_norm``, ``enc_norm``, ``projector.ln``)."""
    return name.startswith(("layers.", "encoder.")) or p.dim() >= 2


def adamw_scalars(cfg: OptConfig, step: torch.Tensor, gnorm: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """One step's scalars: the new step, the clip scale of the gradient
    norm ``gnorm``, the learning rate and the bias corrections."""
    step = step + 1
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.grad_clip > 0
             else torch.ones((), device=gnorm.device))
    stepf = step.to(torch.float32)
    return {"step": step, "scale": scale, "lr": lr_schedule(cfg, step),
            "bc1": 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device),
                                 stepf),
            "bc2": 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device),
                                 stepf)}


@torch.no_grad()
def adamw_leaf(cfg: OptConfig, wd: bool, p: torch.Tensor, grad: torch.Tensor,
               m: torch.Tensor, v: torch.Tensor,
               sc: Dict[str, torch.Tensor]) -> None:
    """AdamW on one leaf (or one slice of it: the update is elementwise),
    in place, in pieces of CHUNK; ``wd``: whether it decays."""
    for pp, gp, mp, vp in _pieces(p, grad, m, v):
        g = gp.float() * sc["scale"]
        m32, v32 = mp.float(), vp.float()  # the state itself when f32
        m32.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v32.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        del g
        delta = (m32 / sc["bc1"]).div_(torch.sqrt(v32 / sc["bc2"])
                                       .add_(cfg.eps))
        if wd:
            delta.add_(cfg.weight_decay * pp.float())
        pp.copy_(pp.float() - sc["lr"] * delta)
        if m32 is not mp:
            mp.copy_(m32)
            vp.copy_(v32)


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads: Mapping[str, torch.Tensor],
                 state: Dict[str, object],
                 params: Mapping[str, torch.Tensor]
                 ) -> Tuple[Dict[str, object], Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping and bias correction.
    Updates ``params`` and the state's m/v in place, one leaf at a time;
    returns (state, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    sc = adamw_scalars(cfg, state["step"], gnorm)
    for name, p in params.items():
        adamw_leaf(cfg, cfg.weight_decay > 0 and decays(name, p), p,
                   grads[name], state["m"][name], state["v"][name], sc)
    state["step"] = sc["step"]
    return state, {"grad_norm": gnorm, "lr": sc["lr"]}


def piece_sums(x: torch.Tensor) -> list:
    """The sums of squares ``global_norm`` adds for one leaf, in order."""
    return [torch.sum(torch.square(piece.float())) for (piece,) in _pieces(x)]


# --------------------------------------------------------------- sharding --
def zero1_leaf_axes(spec: ParamSpec, mesh, rules: Rules) -> Tuple:
    """Axes for one param's m/v: param axes + 'fsdp' on the largest free
    dim (ZeRO-1). Falls back to the param axes when nothing shards."""
    fs = mesh_axis_size(mesh, rules.get("fsdp"))
    if fs <= 1:
        return spec.axes
    base = logical_to_spec(mesh, rules, spec.axes, spec.shape)
    # mesh axes already consumed by the param's own sharding
    used = set()
    for entry in base:
        if entry is None:
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            used.add(a)
    fsdp_axis = rules.get("fsdp")
    flat_fsdp = ((fsdp_axis,) if isinstance(fsdp_axis, str)
                 else tuple(fsdp_axis or ()))
    if any(a in used for a in flat_fsdp):
        return spec.axes
    # largest dim whose logical axis maps to nothing and divides fs
    cand = None
    base_full = list(base) + [None] * (len(spec.shape) - len(base))
    for i, dim in enumerate(spec.shape):
        if base_full[i] is None and dim % fs == 0:
            if cand is None or dim > spec.shape[cand]:
                cand = i
    if cand is None:
        return spec.axes
    axes = list(spec.axes)
    axes[cand] = "fsdp"
    return tuple(axes)


def opt_state_axes(param_specs: ParamTree, mesh, rules: Rules, *,
                   zero1: bool = True) -> Dict[str, object]:
    """Logical-axes tree for the optimizer state, from JAX's stacked spec
    tree (``model.param_specs()``)."""
    def leaf(spec: ParamSpec):
        return zero1_leaf_axes(spec, mesh, rules) if zero1 else spec.axes

    mv = tree_map(leaf, param_specs)
    return {"m": mv, "v": tree_map(lambda x: x, mv), "step": ()}
