"""Mixture-of-Experts FFN with top-k routing and capacity-bounded
sort-based dispatch (dropping on overflow), and an optional parallel
dense-residual FFN (arctic). Counterpart of ``repro/models/moe.py`` and of
the single-device branch of ``repro/models/moe_ep.py::moe_ffn_ep``.

Dispatch is sort-based, as in JAX: the (token, expert-choice) pairs are
stably sorted by expert, each pair's rank inside its expert decides
whether it fits the capacity C, and the kept pairs are copied into an
(E*C, d) expert buffer; the pairs that do not fit go to a spill slot E*C
and are dropped. Every attention call goes through ``attn_impl`` as in
``TransformerLM``; the FFN of each layer is ``ffn``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch import flags
from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import (MLP, Attention, Norm,
                                            TransformerLM, _Params, mlp)


class Experts(_Params):
    """router (d, E) in f32, expert weights wi (E, d, fin), wo (E, f, d)."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        E, d, f, dt = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.tdtype
        fin = 2 * f if cfg.act == "swiglu" else f
        self.add("router", (d, E), torch.float32, "scaled", device)
        self.add("wi", (E, d, fin), dt, "scaled", device)
        self.add("wo", (E, f, d), dt, "scaled", device)


def _dense_cfg(cfg: ArchConfig) -> ArchConfig:
    """arctic's parallel dense FFN: hidden = d_model."""
    return dataclasses.replace(cfg, d_ff=cfg.d_model)


class MoEBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.ln1 = Norm(cfg, device)
        self.attn = Attention(cfg, device)
        self.ln2 = Norm(cfg, device)
        self.moe = Experts(cfg, device)
        if cfg.moe_dense_residual:
            self.dense_mlp = MLP(_dense_cfg(cfg), device)


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Per-expert capacity, rounded up to a multiple of 128 (at least 128),
    as JAX rounds it: which tokens are dropped depends on it."""
    c = cfg.capacity_factor * n_tokens * cfg.moe_topk / cfg.n_experts
    return max(128, int(-(-c // 128) * 128))


def route(cfg: ArchConfig, router: torch.Tensor, xt: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token->expert choices. xt: (T, d) -> (gates (T,k) in xt's dtype,
    experts (T,k) by falling probability, Switch-style aux loss).
    ``torch.topk`` and ``jax.lax.top_k`` may order tied probabilities
    differently; continuous inputs give no ties."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    topv, topi = torch.topk(probs, cfg.moe_topk, dim=-1)
    gates = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    E = cfg.n_experts
    density = torch.zeros(E, dtype=torch.float32, device=xt.device)
    density.index_add_(0, topi.reshape(-1),
                       torch.ones(topi.numel(), device=xt.device))
    aux = E * torch.sum(density / topi.numel() * probs.mean(dim=0))
    return gates.to(xt.dtype), topi, aux


def dispatch(cfg: ArchConfig, topi: torch.Tensor, C: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (token, choice) pairs in expert order: (order, dest, keep), all
    (T*k,). ``order`` is the stable sort of the flattened choices by
    expert (pair ``order[i]`` = token ``order[i] // k``, choice ``order[i]
    % k``); ``dest`` its slot ``e*C + rank`` in the expert buffer, or the
    spill slot ``E*C`` where the rank reaches C (``keep`` False)."""
    E = cfg.n_experts
    es, order = torch.sort(topi.reshape(-1), stable=True)
    starts = torch.searchsorted(es, torch.arange(E, device=es.device))
    rank = torch.arange(es.numel(), device=es.device) - starts[es]
    keep = rank < C
    dest = torch.where(keep, es * C + rank, E * C)
    return order, dest, keep


def moe_ffn(cfg: ArchConfig, p: Experts, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss). Sort-based dispatch."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.moe_topk
    C = capacity(cfg, T)
    xt = x.reshape(T, d)
    gates, topi, aux = route(cfg, p.router, xt)
    order, dest, keep = dispatch(cfg, topi, C)
    ts = order // k

    # scatter tokens into the (E*C, d) expert buffer ("the shuffle"); the
    # spill row E*C takes every dropped pair and is cut off
    buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=x.device)
    buf[dest] = xt[ts]
    h = torch.bmm(buf[:-1].reshape(E, C, d), p.wi)
    if cfg.act == "swiglu":
        gate, up = h.chunk(2, dim=-1)
        h = F.silu(gate.float()).to(up.dtype) * up
    else:
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    y = torch.bmm(h, p.wo).reshape(E * C, d)

    # combine ("the reduce"): each pair's expert output times its gate
    # (zero where dropped). JAX scatter-adds them into token order
    # (``.at[ts].add``); here each token's k values are added in a fixed
    # order, by rising expert id (the order of the sorted pairs), in x's
    # dtype, each add rounded as JAX's bf16 scatter-add rounds it. No
    # atomics, so a run on the card gives the same bits every time, where
    # index_add_ on a CUDA tensor would add in whatever order its atomics
    # land (k = 4 for dbrx)
    yf = torch.cat([y, torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    g = gates.reshape(-1)[order] * keep.to(gates.dtype)
    vals = (yf[dest] * g[:, None]).to(x.dtype)
    # pair order[i] sits at i: place the values back at (token, choice),
    # then walk each token's choices by rising expert id
    by_pair = torch.empty_like(vals)
    by_pair[order] = vals
    by_pair = by_pair.reshape(T, k, d)
    rising = torch.argsort(topi, dim=-1)
    out = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + by_pair.gather(
            1, rising[:, j, None, None].expand(T, 1, d))[:, 0]
    return out.reshape(B, S, d), aux


def moe_ffn_ep(cfg: ArchConfig, p: Experts, x: torch.Tensor,
               mesh: Optional[object] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel MoE FFN of JAX ``moe_ep.moe_ffn_ep``. On one
    device (no mesh), or with ``REPRO_MOE_DENSE=1``, it is the dense
    sort-based ``moe_ffn``, as JAX falls back; the all_to_all body comes
    with the port's multi-device slice."""
    if mesh is None or flags.moe_dense():
        return moe_ffn(cfg, p, x)
    raise NotImplementedError(
        "expert-parallel MoE dispatch over a mesh is not ported yet")


class MoETransformerLM(TransformerLM):
    """Transformer with MoE FFN (dbrx) + optional dense residual (arctic).
    Forward, loss, prefill and decode are ``TransformerLM``'s; each layer's
    FFN is ``ffn``."""

    def make_block(self, device: torch.device) -> nn.Module:
        return MoEBlock(self.cfg, device)

    def ffn(self, p: MoEBlock, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        out, _ = moe_ffn_ep(cfg, p.moe, h)
        if cfg.moe_dense_residual:
            out = out + mlp(_dense_cfg(cfg), p.dense_mlp, h)
        return out
