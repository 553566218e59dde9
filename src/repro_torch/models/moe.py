"""Mixture-of-Experts FFN with top-k routing and capacity-bounded
sort-based dispatch (dropping on overflow), and an optional parallel
dense-residual FFN (arctic). Counterpart of ``repro/models/moe.py``; each
layer's FFN is ``models.moe_ep.moe_ffn_ep``, expert-parallel under active
sharding rules and this dense dispatch otherwise.

Dispatch is sort-based, as in JAX: the (token, expert-choice) pairs are
stably sorted by expert, each pair's rank inside its expert decides
whether it fits the capacity C, and the kept pairs are copied into an
(E*C, d) expert buffer; the pairs that do not fit go to a spill slot E*C
and are dropped. Every attention call goes through ``attn_impl`` as in
``TransformerLM``; the FFN of each layer is ``ffn``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.autograd import PlainSpanFn
from repro_torch.models.common import ParamSpec, tree_leaves
from repro_torch.models.transformer import (META, MLP, Attention, Norm,
                                            TransformerLM, _Params,
                                            attention_roles, mlp_roles,
                                            stack_specs, tp_mlp)
from repro_torch.sharding.tp import group_of


class Experts(_Params):
    """router (d, E) in f32, expert weights wi (E, d, fin), wo (E, f, d)."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        E, d, f, dt = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.tdtype
        fin = 2 * f if cfg.act == "swiglu" else f
        self.add("router", (d, E), torch.float32, "scaled", device,
                 axes=("embed", "experts"))
        # 'expert_in' (not 'embed'): expert weights are EP-sharded over
        # 'model' and stay whole per rank for the expert-parallel dispatch;
        # ZeRO-1 shards their optimizer state over 'data' instead
        self.add("wi", (E, d, fin), dt, "scaled", device,
                 axes=("experts", "expert_in", "expert_mlp"))
        self.add("wo", (E, f, d), dt, "scaled", device,
                 axes=("experts", "expert_mlp", "expert_in"))


def moe_specs(cfg: ArchConfig, L: int) -> Dict[str, ParamSpec]:
    return stack_specs(Experts(cfg, META), L)


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
    probs, gates, topi = route_probs(cfg, router, xt)
    return gates, topi, switch_aux(cfg, probs, topi)


def route_probs(cfg: ArchConfig, router: torch.Tensor, xt: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``route`` without the aux loss: (probs (T, E) f32, gates, experts)."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    topv, topi = torch.topk(probs, cfg.moe_topk, dim=-1)
    gates = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gates.to(xt.dtype), topi


def switch_aux(cfg: ArchConfig, probs: torch.Tensor, topi: torch.Tensor
               ) -> torch.Tensor:
    """E * sum_e f_e * p_e over the tokens of ``probs`` (T, E)."""
    E = cfg.n_experts
    density = torch.zeros(E, dtype=torch.float32, device=probs.device)
    density.index_add_(0, topi.reshape(-1),
                       torch.ones(topi.numel(), device=probs.device))
    return E * torch.sum(density / topi.numel() * probs.mean(dim=0))


def dispatch(cfg: ArchConfig, topi: torch.Tensor, C: int,
             offsets: Optional[torch.Tensor] = None,
             rows: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (token, choice) pairs in expert order: (order, dest, keep), all
    (T*k,). ``order`` is the stable sort of the flattened choices by
    expert (pair ``order[i]`` = token ``order[i] // k``, choice ``order[i]
    % k``). A pair is kept where its rank among the pairs to its expert,
    after the ``offsets[e]`` (E,) pairs that earlier data ranks send to
    that expert (none by default), is below C: JAX's rank in the global
    batch. ``dest`` is its slot ``e*R + rank`` in an expert buffer of R =
    ``rows`` (default C) rows an expert, or the spill slot ``E*R`` where
    it is dropped (``keep`` False)."""
    E = cfg.n_experts
    R = C if rows is None else rows
    es, order = torch.sort(topi.reshape(-1), stable=True)
    starts = torch.searchsorted(es, torch.arange(E, device=es.device))
    rank = torch.arange(es.numel(), device=es.device) - starts[es]
    keep = rank < C if offsets is None else rank + offsets[es] < C
    dest = torch.where(keep, es * R + rank, E * R)
    return order, dest, keep


def kept_pairs(order: torch.Tensor, keep: torch.Tensor, k: int
               ) -> torch.Tensor:
    """``dispatch``'s keep mask at (token, choice): (T, k) bool."""
    out = torch.empty_like(keep)
    out[order] = keep
    return out.reshape(-1, k)


def _to_experts(xt: torch.Tensor, ts: torch.Tensor, dest: torch.Tensor,
                rows: int) -> torch.Tensor:
    """The (rows, d) expert buffer: token ``ts[i]`` at row ``dest[i]``."""
    buf = torch.zeros((rows, xt.shape[1]), dtype=xt.dtype, device=xt.device)
    buf[dest] = xt[ts]
    return buf


def _combine(y: torch.Tensor, gates: torch.Tensor, order: torch.Tensor,
             dest: torch.Tensor, keep: torch.Tensor, topi: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """("the reduce") each pair's expert output times its gate (zero where
    dropped), summed per token: (T, d) in ``dtype``. JAX scatter-adds them
    into token order (``.at[ts].add``); here each token's k values are
    added in a fixed order, by rising expert id (the order of the sorted
    pairs), in ``dtype``, each add rounded as JAX's bf16 scatter-add
    rounds it. No atomics, so a forward on the card gives the same bits
    every time, where index_add_ on a CUDA tensor would add in whatever
    order its atomics land (k = 4 for dbrx)."""
    return sum_rising(pair_values(y, gates, order, dest, keep, topi, dtype),
                      topi)


def pair_values(y: torch.Tensor, gates: torch.Tensor, order: torch.Tensor,
                dest: torch.Tensor, keep: torch.Tensor, topi: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """Each (token, choice) pair's expert output row of y (rows, d) times
    its gate, zero where dropped: (T, k, d) in ``dtype``. A dest of
    ``rows`` reads a zero row."""
    T, k = topi.shape
    d = y.shape[1]
    yf = torch.cat([y, torch.zeros((1, d), dtype=y.dtype, device=y.device)])
    g = gates.reshape(-1)[order] * keep.to(gates.dtype)
    vals = (yf[dest] * g[:, None]).to(dtype)
    # pair order[i] sits at i: place the values back at (token, choice)
    by_pair = torch.empty_like(vals)
    by_pair[order] = vals
    return by_pair.reshape(T, k, d)


def sum_rising(by_pair: torch.Tensor, topi: torch.Tensor) -> torch.Tensor:
    """Each token's k values (T, k, d) added by rising expert id, in
    their type: (T, d)."""
    T, k, d = by_pair.shape
    dtype = by_pair.dtype
    rising = torch.argsort(topi, dim=-1)
    out = torch.zeros((T, d), dtype=dtype, device=by_pair.device)
    for j in range(k):
        out = out + by_pair.gather(
            1, rising[:, j, None, None].expand(T, 1, d))[:, 0]
    return out


def expert_compute(cfg: ArchConfig, wi: torch.Tensor, wo: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """x: (E', n, d) tokens for E' experts -> their outputs (E', n, d)."""
    h = torch.bmm(x, wi)
    if cfg.act == "swiglu":
        gate, up = h.chunk(2, dim=-1)
        h = F.silu(gate.float()).to(up.dtype) * up
    else:
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    return torch.bmm(h, wo)


def dense_experts(cfg: ArchConfig, wi: torch.Tensor, wo: torch.Tensor,
                  xt: torch.Tensor, gates: torch.Tensor, topi: torch.Tensor,
                  order: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor,
                  R: int) -> torch.Tensor:
    """The dense dispatch of the tokens xt (T, d) over every expert, the
    pairs placed by ``dispatch`` into a buffer of R rows an expert: (T, d)
    in xt's dtype. The scatter and the combine go through ``PlainSpanFn``,
    whose backward recomputes them with the same slots."""
    E, k = cfg.n_experts, cfg.moe_topk
    d = xt.shape[1]
    # scatter tokens into the (E*R, d) expert buffer ("the shuffle"); the
    # spill row E*R takes every dropped pair and is cut off
    buf = PlainSpanFn.apply("moe_dispatch",
                            functools.partial(_to_experts, rows=E * R + 1),
                            xt, order // k, dest)
    y = expert_compute(cfg, wi, wo, buf[:-1].reshape(E, R, d))
    return PlainSpanFn.apply("moe_dispatch",
                             functools.partial(_combine, dtype=xt.dtype),
                             y.reshape(E * R, d), gates, order, dest, keep,
                             topi)


def moe_ffn(cfg: ArchConfig, p: Experts, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss). Sort-based dispatch."""
    B, S, d = x.shape
    T = B * S
    C = capacity(cfg, T)
    xt = x.reshape(T, d)
    gates, topi, aux = route(cfg, p.router, xt)
    order, dest, keep = dispatch(cfg, topi, C)
    out = dense_experts(cfg, p.wi, p.wo, xt, gates, topi, order, dest, keep,
                        C)
    return out.reshape(B, S, d), aux


class MoETransformerLM(TransformerLM):
    """Transformer with MoE FFN (dbrx) + optional dense residual (arctic).
    Forward, loss, prefill and decode are ``TransformerLM``'s; each layer's
    FFN is ``ffn``. Under tensor parallelism the attention, the vocab and
    arctic's dense residual MLP run on the ranks' pieces; the experts run
    expert-parallel (``models.moe_ep``)."""

    def make_block(self, device: torch.device) -> nn.Module:
        return MoEBlock(self.cfg, device)

    def block_roles(self, name: str, blk: nn.Module):
        out = attention_roles(f"{name}.attn", blk.attn)
        if self.cfg.moe_dense_residual:
            out.update(mlp_roles(self.cfg, f"{name}.dense_mlp"))
        return out

    def moe_weight_axes_note(self) -> str:
        return ("expert weights: ('layers','experts','expert_in',"
                "'expert_mlp') — EP over 'model', replicated over "
                "(pod,data); ZeRO-1 shards m/v over 'data'.")

    def n_active_params(self) -> int:
        """6·N_active·D roofline accounting: a stacked expert leaf counts
        at k/E of its size."""
        total = 0
        for s in tree_leaves(self.param_specs()):
            n = math.prod(s.shape)
            if "experts" in s.axes and len(s.shape) >= 3:
                n = n * self.cfg.moe_topk // self.cfg.n_experts
            total += n
        return total

    def ffn(self, p: MoEBlock, h: torch.Tensor) -> torch.Tensor:
        """The MoE FFN of the residual stream every 'model' rank holds:
        ``moe_ffn_ep`` under the rules. Virtual ranks (``tp.VirtualTP``,
        no rules) run the dense dispatch, each rank on its E/M experts'
        rows where the sequence does not split over them (a decode step,
        as JAX's fallback), else on every expert."""
        # models.moe_ep builds on this module, so it is imported here
        from repro_torch.models.moe_ep import moe_ffn_ep, moe_ffn_held
        from repro_torch.sharding.partition import current_rules
        cfg, tp = self.cfg, self.tp
        if (tp is not None and current_rules() is None
                and h.shape[1] % tp.M and not cfg.n_experts % tp.M):
            out = moe_ffn_held(cfg, p.moe, h, tp.M, tp.reduce)[0]
        else:
            out, _ = moe_ffn_ep(cfg, p.moe, h)
        if cfg.moe_dense_residual:
            dc = _dense_cfg(cfg)
            out = out + tp_mlp(dc, group_of(self, p.dense_mlp),
                               p.dense_mlp, h)
        return out
