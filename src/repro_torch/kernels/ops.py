"""Public wrappers for the port's kernels (counterpart of
``repro/kernels/ops.py``).

The kernels take the model layout, so no transpose or GQA broadcast
happens here: kv head h // (H/G) is read by index inside the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as _fa


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    qpos: Optional[torch.Tensor] = None,
                    kpos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash attention. q (B,S,H,D), k/v (B,S,G,D) model layout, positions
    of any integer type; returns (B,S,H,D)."""
    if qpos is not None:
        qpos = qpos.to(device=q.device, dtype=torch.int32).contiguous()
    if kpos is not None:
        kpos = kpos.to(device=q.device, dtype=torch.int32).contiguous()
    return _fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window,
                               qpos=qpos, kpos=kpos)
