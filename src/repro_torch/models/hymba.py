"""Hymba (arXiv:2411.13676): each layer runs attention heads and SSM heads
in PARALLEL on the same input, averages their (normalized) outputs, then a
dense FFN. Sliding-window attention + O(1) SSM state.

Counterpart of ``repro/models/hymba.py``: the paper's Mamba heads are
multi-head GLA with ssm_state key channels, no u-bonus and data-dependent
decay w = exp(-softplus(dt)·a). Attention goes through ``attn_impl`` with
the sliding window and a ring cache of ``window`` slots; for T > 1 the SSM
heads run the GLA scan picked by ``gla_impl``, and a single decode token
runs ``gla_step`` (plain torch, as the JAX package does). The decode step
updates its cache in place.

Under tensor parallelism (``sharding.tp``) the attention, its output norm
``attn_norm``, the MLP and the vocab run on the ranks' pieces, and the
SSM heads on the rank's heads: ``wx``/``wB``/``wC`` column-parallel
(``qkv``/``heads``), ``wdt``/``a_log``/``dt_bias`` by ``heads`` where
the heads divide by M, ``norm`` by ``qkv``, ``wo`` row-parallel. Where
the heads do not divide (hymba-1.5b's 25 at M 16) they split into
gcd(H, M) groups repeated on their ranks (``transformer.head_group``),
the columns gathered before the heads, as JAX's 'heads' -> 'model' falls
back. The cache (``SplitCache`` of ``HymbaCache``s) splits the KV ring
over the ranks' slots and holds each rank's heads of the SSM state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.device import DeviceLike
from repro_torch.models import common as cm
from repro_torch.models.common import ParamSpec
from repro_torch.models.recurrence import gla_step, make_gla
from repro_torch.models.transformer import (META, MLP, Attention, Norm,
                                            SplitCache, TransformerLM,
                                            _Params, apply_norm,
                                            attention_roles,
                                            causal_attention, head_group,
                                            layout_cache, mlp_roles,
                                            rank_cols, ring_slots,
                                            stack_specs, tp_attention,
                                            tp_cols, tp_out, tp_vec)
from repro_torch.sharding.tp import group_of


class SSM(_Params):
    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        d, dt, f32 = cfg.d_model, cfg.tdtype, torch.float32
        H, hd, N = cfg.n_heads, cfg.hdim, cfg.ssm_state
        self.add("wx", (d, H * hd), dt, "scaled", device,
                 axes=("embed", "qkv"))
        for name, width in (("wB", H * N), ("wC", H * N), ("wdt", H)):
            self.add(name, (d, width), dt, "scaled", device,
                     axes=("embed", "heads"))
        self.add("a_log", (H, N), f32, "zeros", device, axes=("heads", None))
        self.add("dt_bias", (H,), f32, "zeros", device, axes=("heads",))
        self.add("wo", (H * hd, d), dt, "scaled", device,
                 axes=("qkv", "embed"))
        self.add("norm", (H * hd,), f32, "ones", device, axes=("qkv",))


class HymbaBlock(_Params):
    """ln1, attention, its output norm ``attn_norm`` (a bare parameter of
    the block, as in the JAX tree), SSM heads, ln2, FFN."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.ln1 = Norm(cfg, device)
        self.attn = Attention(cfg, device)
        self.add("attn_norm", (cfg.n_heads * cfg.hdim,), torch.float32,
                 "ones", device, axes=("qkv",))
        self.ssm = SSM(cfg, device)
        self.ln2 = Norm(cfg, device)
        self.mlp = MLP(cfg, device)


@dataclasses.dataclass
class HymbaCache:
    """Sliding-window KV ring buffer + SSM state + shift state."""

    k: torch.Tensor          # (L, B, W, G, hd)
    v: torch.Tensor
    kpos: torch.Tensor       # (W,) int32 stored positions, -1 = empty
    ssm: torch.Tensor        # (L, B, H, N, hd) float32 GLA state
    shift: torch.Tensor      # (L, B, d) previous token; kept to match the
    #                          JAX cache, read by nothing


class HymbaLM(TransformerLM):
    """Parallel attention + SSM heads; sliding-window attention."""

    def __init__(self, cfg: ArchConfig, *, device: DeviceLike = None,
                 attn_impl: str = "flash", gla_impl: str = "kernel"):
        super().__init__(cfg, device=device, attn_impl=attn_impl)
        self.gla_impl = gla_impl
        self.gla = make_gla(gla_impl)

    def make_block(self, device: torch.device) -> nn.Module:
        return HymbaBlock(self.cfg, device)

    def ssm_specs(self, L: int) -> Dict[str, ParamSpec]:
        return stack_specs(SSM(self.cfg, META), L)

    def block_roles(self, name: str, blk: nn.Module):
        """The attention with its output norm (one group), the SSM's
        projections, ``norm`` and ``wo`` (one group), its per-head
        ``wdt``/``a_log``/``dt_bias`` (a group of their own: they split
        where the heads divide), and the MLP."""
        a, m = f"{name}.attn", f"{name}.ssm"
        out = attention_roles(a, blk.attn)
        out[f"{name}.attn_norm"] = (0, False, a)
        out.update({f"{m}.{w}": (1, False, m) for w in ("wx", "wB", "wC")})
        out.update({f"{m}.norm": (0, False, m), f"{m}.wo": (0, False, m),
                    f"{m}.wdt": (1, False, f"{m}.heads"),
                    f"{m}.a_log": (0, False, f"{m}.heads"),
                    f"{m}.dt_bias": (0, False, f"{m}.heads")})
        out.update(mlp_roles(self.cfg, f"{name}.mlp"))
        return out

    # ------------------------------------------------------------ SSM mix --
    def _ssm_mix(self, p: SSM, x: torch.Tensor,
                 state: Optional[List[torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The SSM heads of the normed x (B, T, d); ``state``: each of the
        group's ranks' (B, H/T, N, hd) state, or None. Returns (out, each
        rank's final state)."""
        cfg = self.cfg
        tp = group_of(self, p)
        B, T, _ = x.shape
        H, hd, N = cfg.n_heads, cfg.hdim, cfg.ssm_state
        per, Hl = head_group(tp, H)
        xv = tp_cols(tp, p, "wx", x, hd)
        Bm = tp_cols(tp, p, "wB", x, N)
        Cm = tp_cols(tp, p, "wC", x, N)
        if "wdt" in p.tp_dims and tp.M > 1:
            dl = tp_cols(tp, p, "wdt", x, 1)
        else:  # every head's column, the group's taken
            dl = [(xr @ p.wdt)[..., r // per * Hl:(r // per + 1) * Hl]
                  for r, xr in zip(tp.ranks, tp.copy(x))]
        a_log, dt_bias, norm = (tp_vec(tp, p, n, H)
                                for n in ("a_log", "dt_bias", "norm"))
        state = state or [None] * len(tp.ranks)
        ys, finals = [], []
        for j in range(len(tp.ranks)):
            dt = F.softplus(dl[j].float() + dt_bias[j])         # (B,T,Hl)
            a = -torch.exp(a_log[j].float())                    # (Hl,N) < 0
            logw = dt[..., None] * a                            # <= 0
            k = (Bm[j].reshape(B, T, Hl, N).float()
                 * dt[..., None]).to(x.dtype)                   # dt·B
            Cj = Cm[j].reshape(B, T, Hl, N)
            xj = xv[j].reshape(B, T, Hl, hd)
            if T == 1 and state[j] is not None:
                y, S = gla_step(state[j], Cj[:, 0], k[:, 0], xj[:, 0],
                                logw[:, 0])
                y = y[:, None]
            else:
                y, S = self.gla(Cj, k, xj, logw, initial_state=state[j])
            y = cm.rms_norm(y.reshape(B, T, Hl, hd),
                            norm[j].reshape(Hl, hd)).reshape(B, T, Hl * hd)
            ys.append(y.to(x.dtype))
            finals.append(S)
        return tp_out(tp, p, rank_cols(tp, ys, H)), finals

    # ------------------------------------------------------- layer bodies --
    def _fused_mix(self, p: HymbaBlock, h: torch.Tensor,
                   positions: torch.Tensor):
        """Parallel attention + SSM on the same normed input, averaged.
        Returns (mix, (k, v) as ``tp_attention`` gives them, the SSM
        states); prefill keeps the k, v and states."""
        cfg = self.cfg
        H, hd = cfg.n_heads, cfg.hdim
        tp = group_of(self, p.attn)
        norms = tp_vec(tp, p, "attn_norm", H)
        Hl = head_group(tp, H)[1]
        attn_y, kv = tp_attention(
            cfg, tp, p.attn, h, positions,
            lambda q, k, v: causal_attention(cfg, q, k, v, positions,
                                             self.attn_impl),
            post=lambda j, o: cm.rms_norm(o, norms[j].reshape(Hl, hd)
                                          ).to(h.dtype))
        ssm_y, S = self._ssm_mix(p.ssm, h)
        return 0.5 * (attn_y + ssm_y), kv, S

    def layer_body(self, p: HymbaBlock, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = x + self._fused_mix(p, apply_norm(cfg, p.ln1, x), positions)[0]
        return x + self.ffn(p, apply_norm(cfg, p.ln2, x))

    # ------------------------------------------------------------- decode --
    def state_module(self) -> nn.Module:
        return self.layers[0].ssm

    def cache_len(self, cell: ShapeCell) -> int:
        return min(cell.seq_len, self.cfg.sliding_window)

    def cache_specs(self, B: int, W: int) -> HymbaCache:
        cfg = self.cfg
        L, d = cfg.n_layers, cfg.d_model
        H, G, hd, N = cfg.n_heads, cfg.n_kv_heads, cfg.hdim, cfg.ssm_state
        kv = (L, B, W, G, hd)
        return HymbaCache(
            k=cm.shape_struct(kv, cfg.tdtype),
            v=cm.shape_struct(kv, cfg.tdtype),
            kpos=cm.shape_struct((W,), torch.int32),
            ssm=cm.shape_struct((L, B, H, N, hd), torch.float32),
            shift=cm.shape_struct((L, B, d), cfg.tdtype))

    def cache_axes(self) -> HymbaCache:
        kv = ("layers", "batch", "cache_seq", "kv_heads", None)
        return HymbaCache(k=kv, v=kv, kpos=(None,),
                          ssm=("layers", "batch", "heads", None, None),
                          shift=("layers", "batch", "embed"))

    def init_cache(self, B: int, W: int) -> HymbaCache:
        """An empty ring of ``W`` slots (kpos -1) and zero SSM and shift
        states, as JAX ``HymbaLM.init_cache``."""
        cfg = self.cfg
        L, d = cfg.n_layers, cfg.d_model
        H, G, hd, N = cfg.n_heads, cfg.n_kv_heads, cfg.hdim, cfg.ssm_state
        dev = self.embed.device
        kv = (L, B, W, G, hd)
        return HymbaCache(
            k=torch.zeros(kv, dtype=cfg.tdtype, device=dev),
            v=torch.zeros(kv, dtype=cfg.tdtype, device=dev),
            kpos=torch.full((W,), -1, dtype=torch.int32, device=dev),
            ssm=torch.zeros((L, B, H, N, hd), dtype=torch.float32,
                            device=dev),
            shift=torch.zeros((L, B, d), dtype=cfg.tdtype, device=dev))

    @torch.no_grad()
    def prefill_parts(self, batch: Dict[str, torch.Tensor],
                      cache_len: Optional[int] = None
                      ) -> Tuple[List[torch.Tensor], object]:
        """Run the prompt: (the logits' parts, the filled cache). The KV
        ring holds min(cache_len, window) slots once the prompt reaches
        the window (``ring_layout``). Under tensor parallelism a
        ``SplitCache``: the ring over the ranks' slots where it divides
        by M, each rank's heads of the SSM state."""
        cfg, tp = self.cfg, self.tp
        tokens = batch["tokens"]
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        x = self.embed_tokens(tokens)
        kvs, ssm, shift = [], [], []
        for p in self.layers:
            h = apply_norm(cfg, p.ln1, x)
            mix, kv, Sst = self._fused_mix(p, h, positions)
            x = x + mix
            x = x + self.ffn(p, apply_norm(cfg, p.ln2, x))
            kvs.append(kv)
            ssm.append(Sst)
            shift.append(h[:, -1])
        parts = self.final_parts(x)
        C = ring_slots(cache_len, S, cfg.sliding_window)
        split = tp is not None and not C % tp.M
        ks, vs, kpos = layout_cache(tp, kvs, S, cache_len,
                                    cfg.sliding_window, split)
        shift = torch.stack(shift).to(cfg.tdtype)
        n = len(tp.ranks) if tp is not None else 1
        kps = tp.slice(kpos, 0) if split else [kpos]
        caches = [HymbaCache(
            k=ks[j if split else 0], v=vs[j if split else 0],
            kpos=kps[j if split else 0].contiguous(),
            ssm=torch.stack([s[j if len(s) > 1 else 0] for s in ssm]),
            shift=shift) for j in range(n)]
        if tp is None:
            return parts, caches[0]
        return parts, SplitCache(caches, C if split else 0)

    @torch.no_grad()
    def decode_split(self, cache, tokens: torch.Tensor, pos: int
                     ) -> Tuple[List[torch.Tensor], object]:
        """One decode step: tokens (B,1) at position ``pos``. Updates
        ``cache`` in place and returns it with the logits' parts."""
        cfg, tp = self.cfg, self.tp
        H, hd = cfg.n_heads, cfg.hdim
        x = self.embed_tokens(tokens)
        qpos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        parts = cache.parts if isinstance(cache, SplitCache) else [cache]
        slot = self.mark_slot(cache, pos)
        for i, p in enumerate(self.layers):
            h = apply_norm(cfg, p.ln1, x)
            g = group_of(self, p.attn)
            norm = g.gather(g.pieces(p, "attn_norm"), 0, True)
            attn_y = self.decode_attention(
                p.attn, h, cache, i, slot, qpos,
                post=lambda o: cm.rms_norm(o, norm.reshape(H, hd)
                                           ).to(h.dtype))
            n = len(group_of(self, p.ssm).ranks)
            ssm_y, Sst = self._ssm_mix(p.ssm, h, state=[
                c.ssm[i] for c in parts[:n]])
            for j, c in enumerate(parts):
                c.ssm[i].copy_(Sst[j if n > 1 else 0])
                c.shift[i].copy_(h[:, -1])
            x = x + 0.5 * (attn_y + ssm_y)
            x = x + self.ffn(p, apply_norm(cfg, p.ln2, x))
        return self.final_parts(x), cache
