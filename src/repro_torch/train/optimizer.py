"""AdamW, as ``repro/train/optimizer.py`` computes it (the single-device
half; ZeRO-1 state sharding waits for the multi-device slice).

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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import torch


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
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def decays(name: str, p: torch.Tensor) -> bool:
    """JAX's ``p.ndim >= 2`` on the JAX leaf: a layer leaf always has the
    stacked L dim there, so every ``layers.*`` leaf decays, and so does
    every leaf of encdec's stacked ``encoder``. Of the unstacked ones, the
    matrices decay (``frontend.proj``, ``projector.w1``) and the vectors
    do not (``final_norm``, ``enc_norm``, ``projector.ln``)."""
    return name.startswith(("layers.", "encoder.")) or p.dim() >= 2


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads: Mapping[str, torch.Tensor],
                 state: Dict[str, object],
                 params: Mapping[str, torch.Tensor]
                 ) -> Tuple[Dict[str, object], Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping and bias correction.
    Updates ``params`` and the state's m/v in place, one leaf at a time;
    returns (state, {"grad_norm", "lr"})."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.grad_clip > 0
             else torch.ones((), device=gnorm.device))
    lr = lr_schedule(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = state["m"][name], state["v"][name]
        m32, v32 = m.float(), v.float()  # the state itself when f32
        m32.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v32.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        del g
        delta = (m32 / bc1).div_(torch.sqrt(v32 / bc2).add_(cfg.eps))
        if cfg.weight_decay > 0 and decays(name, p):
            delta.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - lr * delta)
        if m32 is not m:
            m.copy_(m32)
            v.copy_(v32)
    state["step"] = step
    return state, {"grad_norm": gnorm, "lr": lr}
