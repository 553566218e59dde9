"""AdamW as the training traffic states it, in float32: the gradient
clipped to a global norm, bias-corrected moments, a cosine rate after a
linear warm-up, decoupled weight decay on the leaves that ``decays`` names
(every layer leaf, and the matrices outside the layers: the rule of the
configuration's optimizer)."""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch


def decays(name: str, p: torch.Tensor) -> bool:
    return name.startswith("layers.") or p.dim() >= 2


def rate(opt: Mapping, step: int) -> float:
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / max(opt["warmup_steps"], 1)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    lo = opt["min_lr_ratio"]
    return opt["lr"] * (lo + (1 - lo) * 0.5 * (1 + math.cos(math.pi * t)))


class AdamW:
    def __init__(self, opt: Mapping, params: Mapping[str, torch.Tensor]):
        self.opt, self.step_count = opt, 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Update ``params`` in place; returns the norm of each leaf's
        gradient as the update takes it (after clipping)."""
        o = self.opt
        self.step_count += 1
        t = self.step_count
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.clamp(o["grad_clip"] / gnorm.clamp_min(1e-9), max=1.0)
        lr = rate(o, t)
        bc1, bc2 = 1 - o["b1"] ** t, 1 - o["b2"] ** t
        taken = {}
        for n, p in params.items():
            g = grads[n] * scale
            taken[n] = torch.linalg.vector_norm(g)
            self.m[n].mul_(o["b1"]).add_((1 - o["b1"]) * g)
            self.v[n].mul_(o["b2"]).add_((1 - o["b2"]) * g.square())
            delta = (self.m[n] / bc1) / (torch.sqrt(self.v[n] / bc2)
                                         + o["eps"])
            if o["weight_decay"] > 0 and decays(n, p):
                delta = delta + o["weight_decay"] * p
            p.sub_(lr * delta)
        return taken
