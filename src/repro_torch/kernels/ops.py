"""Public wrappers for the port's kernels (counterpart of
``repro/kernels/ops.py``).

The kernels take the model layout, so no transpose or GQA broadcast
happens here: kv head h // (H/G) is read by index inside the attention
kernel, and the GLA scan reads (B, T, H, K/V) as it is. When grad mode is
on and an input requires grad, the call goes through the autograd
Function of ``kernels.autograd``: the kernel forward, and the attention
kernel's backward or the plain version's (``kernels.autograd``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gla_scan as _gla
from repro_torch.kernels.autograd import (FlashAttentionFn, GlaScanFn,
                                          wants_grad)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    qpos: Optional[torch.Tensor] = None,
                    kpos: Optional[torch.Tensor] = None,
                    self_attention: bool = False,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """Flash attention. q (B,S,H,D), k/v (B,S,G,D) model layout, positions
    of any integer type; returns (B,S,H,D). The backward runs the backward
    kernels on CUDA bf16 (``flash_attention.backward_on_kernel``), else it
    is the caller's plain function (``models.common.attention_plain``):
    ``self_attention`` (qpos and kpos are the same positions) lets it take
    the banded plain version, as JAX trains through it; a ``block_k`` names
    a caller that calls ``attention_chunked`` at that ``block_k``
    directly."""
    if qpos is not None:
        qpos = qpos.to(device=q.device, dtype=torch.int32).contiguous()
    if kpos is not None:
        kpos = kpos.to(device=q.device, dtype=torch.int32).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if wants_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, qpos, kpos,
                                      self_attention, block_k)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               qpos=qpos, kpos=kpos)


def gla(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        logw: torch.Tensor, u: Optional[torch.Tensor] = None, *,
        initial_state: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked GLA recurrence (RWKV6 / SSM heads), any T >= 1. logw, u and
    the state are taken in f32; returns (y in v's dtype, f32 state)."""
    f32 = torch.float32
    if u is not None:
        u = u.to(f32).contiguous()
    if initial_state is not None:
        initial_state = initial_state.to(f32).contiguous()
    args = (r.contiguous(), k.contiguous(), v.contiguous(),
            logw.to(f32).contiguous(), u, initial_state)
    if wants_grad(*args):
        return GlaScanFn.apply(*args)
    return _gla.gla_scan(*args[:5], initial_state=initial_state)
