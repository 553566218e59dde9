"""Chunked gated-linear-attention (GLA) recurrence, as plain torch.

Counterpart of ``repro/models/recurrence.py``: the shared compute core of
the RWKV6 (Finch) time-mix and the hymba SSM heads. Per head with K key
channels and V value channels, state S in R^{K x V}:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (diag(u) k_t^T v_t + S_{t-1})        # u = None: y_t = r_t S_t

The arithmetic is the JAX package's: f32 throughout, the pairwise decays
of a chunk as exp(min(cw_prev_t - cw_j, 0)) (never overflows, however
strong the decay), and y in v's dtype.

Shapes: r, k, logw (B, T, H, K); v (B, T, H, V); u (H, K) or None; state
(B, H, K, V) f32. ``gla_chunked`` is what ``gla_impl="chunked"`` runs and
the reference the tests hold the kernel's wrapper to; ``make_gla`` picks
between it and the hand-written kernel.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.models.common import acc_dtype

GLA_IMPLS = ("kernel", "chunked")


def gla_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: Optional[torch.Tensor] = None, *,
                chunk: int = 32, initial_state: Optional[torch.Tensor] = None,
                shifted_prev: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked recurrence. ``shifted_prev=False`` keeps the JAX
    arithmetic, cw_prev = cw - logw. ``True`` takes cw_prev_t as cw_{t-1}
    itself (the same number, rounded once), as the CUDA kernel does: the
    adjacent pair's exponent cw_prev_t - cw_{t-1} is then exactly 0, where
    the difference form leaves it the rounding error of |cw|, ~1e-3 once a
    chunk's decay sums to ~-1e4 (logw = -exp(6)), and y off by as much."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    c = min(chunk, T)
    if T % c:
        raise ValueError(f"T={T} must be divisible by chunk={c}")
    n = T // c
    f32 = acc_dtype(v)  # f64 stays f64

    def split(x, d):  # (B, T, H, d) -> (n, B, H, c, d)
        return x.to(f32).reshape(B, n, c, H, d).permute(1, 0, 3, 2, 4)

    rc, kc, wc = split(r, K), split(k, K), split(logw, K)
    vc = split(v, V)
    S = (torch.zeros((B, H, K, V), dtype=f32, device=r.device)
         if initial_state is None else initial_state.to(f32))
    tri = torch.tril(torch.ones((c, c), dtype=f32, device=r.device),
                     diagonal=-1)                   # strictly lower: j <= t-1
    uf = None if u is None else u.to(f32)
    ys = []
    for rb, kb, vb, wb in zip(rc, kc, vc, wc):      # (B, H, c, K/V)
        cw = torch.cumsum(wb, dim=2)                # cum logw inclusive
        if shifted_prev:                            # cum logw over i < t
            cw_prev = torch.cat([torch.zeros_like(cw[:, :, :1]),
                                 cw[:, :, :-1]], dim=2)
        else:
            cw_prev = cw - wb
        # inter-chunk: y_t += (r_t * prod_{i<t} w_i) @ S
        y_inter = torch.einsum("bhck,bhkv->bhcv", rb * torch.exp(cw_prev), S)
        # intra-chunk: pairwise decays, exponent <= 0 for j <= t-1
        diff = cw_prev[:, :, :, None, :] - cw[:, :, None, :, :]
        A = torch.einsum("bhck,bhcjk,bhjk->bhcj", rb,
                         torch.exp(diff.clamp(max=0.0)), kb)
        y_intra = torch.einsum("bhcj,bhjv->bhcv", A * tri, vb)
        # diagonal (current-token) term
        if uf is not None:
            du = torch.einsum("bhck,hk,bhck->bhc", rb, uf, kb)
        else:
            du = torch.einsum("bhck,bhck->bhc", rb, kb)
        ys.append(y_inter + y_intra + du[..., None] * vb)
        # S' = diag(prod w) S + sum_j (k_j * prod_{i>j} w_i) v_j
        w_all = cw[:, :, -1:, :]                    # total chunk decay
        k_scaled = kb * torch.exp(w_all - cw)       # exponent <= 0
        S = S * torch.exp(w_all[:, :, 0, :, None]) + torch.einsum(
            "bhck,bhcv->bhkv", k_scaled, vb)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, T, H, V)
    return y.to(v.dtype), S


def gla_step(state: torch.Tensor, r: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, logw: torch.Tensor,
             u: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. state: (B, H, K, V); r/k/logw: (B, H, K); v: (B, H,
    V). Returns (y (B, H, V) in v's dtype, new state); ``state`` itself is
    not written."""
    f32 = torch.float32
    r32, k32, v32 = r.to(f32), k.to(f32), v.to(f32)
    kv = k32[..., :, None] * v32[..., None, :]              # (B,H,K,V)
    if u is not None:
        att = state + u.to(f32)[None, :, :, None] * kv
    else:
        att = state + kv
    y = torch.einsum("bhk,bhkv->bhv", r32, att)
    new_state = state * torch.exp(logw.to(f32))[..., None] + kv
    return y.to(v.dtype), new_state


def gla_ref(r, k, v, logw, u=None, *, initial_state=None):
    """Sequential oracle for tests: step-by-step scan over T."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    S = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if initial_state is None else initial_state.to(torch.float32))
    ys = []
    for t in range(T):
        y, S = gla_step(S, r[:, t], k[:, t], v[:, t], logw[:, t], u)
        ys.append(y)
    return torch.stack(ys, dim=1).to(v.dtype), S


def make_gla(impl: str) -> Callable:
    """gla(r, k, v, logw, u=None, *, initial_state=None) -> (y, state) for
    T >= 1. ``"kernel"`` is the hand-written CUDA scan (its plain version on
    the CPU); ``"chunked"`` is ``gla_chunked`` with the JAX models' chunk
    choice (32 when it divides T, else T)."""
    if impl == "kernel":
        from repro_torch.kernels import ops as kops
        return kops.gla
    if impl != "chunked":
        raise ValueError(f"gla_impl {impl!r} not in {GLA_IMPLS}")

    def chunked(r, k, v, logw, u=None, *, initial_state=None):
        T = r.shape[1]
        return gla_chunked(r, k, v, logw, u, chunk=32 if T % 32 == 0 else T,
                           initial_state=initial_state)

    return chunked
