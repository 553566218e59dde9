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
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models import common as cm
from repro_torch.models.recurrence import gla_step, make_gla
from repro_torch.models.transformer import (MLP, Attention, Norm,
                                            TransformerLM, _Params,
                                            apply_norm, attn_out,
                                            causal_attention,
                                            decode_attention_raw, mlp,
                                            project_qkv, ring_layout)


class SSM(_Params):
    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        d, dt, f32 = cfg.d_model, cfg.tdtype, torch.float32
        H, hd, N = cfg.n_heads, cfg.hdim, cfg.ssm_state
        self.add("wx", (d, H * hd), dt, "scaled", device)
        self.add("wB", (d, H * N), dt, "scaled", device)
        self.add("wC", (d, H * N), dt, "scaled", device)
        self.add("wdt", (d, H), dt, "scaled", device)
        self.add("a_log", (H, N), f32, "zeros", device)
        self.add("dt_bias", (H,), f32, "zeros", device)
        self.add("wo", (H * hd, d), dt, "scaled", device)
        self.add("norm", (H * hd,), f32, "ones", device)


class HymbaBlock(_Params):
    """ln1, attention, its output norm ``attn_norm`` (a bare parameter of
    the block, as in the JAX tree), SSM heads, ln2, FFN."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.ln1 = Norm(cfg, device)
        self.attn = Attention(cfg, device)
        self.add("attn_norm", (cfg.n_heads * cfg.hdim,), torch.float32,
                 "ones", device)
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

    # ------------------------------------------------------------ SSM mix --
    def _ssm_inputs(self, p: SSM, x: torch.Tensor):
        cfg = self.cfg
        B, T, _ = x.shape
        H, hd, N = cfg.n_heads, cfg.hdim, cfg.ssm_state
        xv = (x @ p.wx).reshape(B, T, H, hd)
        Bm = (x @ p.wB).reshape(B, T, H, N)
        Cm = (x @ p.wC).reshape(B, T, H, N)
        dt = F.softplus((x @ p.wdt).float() + p.dt_bias)        # (B,T,H)
        a = -torch.exp(p.a_log.float())                         # (H,N) < 0
        logw = dt[..., None] * a                                # <= 0
        k = Bm.float() * dt[..., None]                          # dt·B
        return Cm, k.to(x.dtype), xv, logw

    def _ssm_mix(self, p: SSM, x: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        B, T, _ = x.shape
        H, hd = cfg.n_heads, cfg.hdim
        Cm, k, xv, logw = self._ssm_inputs(p, x)
        if T == 1 and state is not None:
            y, S = gla_step(state, Cm[:, 0], k[:, 0], xv[:, 0], logw[:, 0])
            y = y[:, None]
        else:
            y, S = self.gla(Cm, k, xv, logw, initial_state=state)
        y = cm.rms_norm(y.reshape(B, T, H, hd),
                        p.norm.reshape(H, hd)).reshape(B, T, H * hd)
        return y.to(x.dtype) @ p.wo, S

    # ------------------------------------------------------- layer bodies --
    def _fused_mix(self, p: HymbaBlock, h: torch.Tensor,
                   positions: torch.Tensor):
        """Parallel attention + SSM on the same normed input, averaged.
        Returns (mix, k, v, SSM state); prefill keeps k, v and the state."""
        cfg = self.cfg
        q, k, v = project_qkv(cfg, p.attn, h, positions)
        o = causal_attention(cfg, q, k, v, positions, self.attn_impl)
        o = cm.rms_norm(o, p.attn_norm.reshape(cfg.n_heads, cfg.hdim))
        attn_y = attn_out(p.attn, o.to(h.dtype))
        ssm_y, S = self._ssm_mix(p.ssm, h)
        return 0.5 * (attn_y + ssm_y), k, v, S

    def layer_body(self, p: HymbaBlock, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = x + self._fused_mix(p, apply_norm(cfg, p.ln1, x), positions)[0]
        return x + mlp(cfg, p.mlp, apply_norm(cfg, p.ln2, x))

    # ------------------------------------------------------------- decode --
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
    def prefill(self, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, HymbaCache]:
        """Run the prompt, return (full logits, filled cache). The KV ring
        holds min(cache_len, window) slots once the prompt reaches the
        window (``ring_layout``)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        x = self.embed_tokens(tokens)
        ks: List[torch.Tensor] = []
        vs: List[torch.Tensor] = []
        ssm: List[torch.Tensor] = []
        shift: List[torch.Tensor] = []
        for p in self.layers:
            h = apply_norm(cfg, p.ln1, x)
            mix, k, v, Sst = self._fused_mix(p, h, positions)
            x = x + mix
            x = x + mlp(cfg, p.mlp, apply_norm(cfg, p.ln2, x))
            ks.append(k)
            vs.append(v)
            ssm.append(Sst)
            shift.append(h[:, -1])
        logits = self.unembed(x)
        k_all, v_all, kpos = ring_layout(torch.stack(ks), torch.stack(vs), S,
                                         cache_len, window=cfg.sliding_window)
        return logits, HymbaCache(k=k_all.contiguous(), v=v_all.contiguous(),
                                  kpos=kpos, ssm=torch.stack(ssm),
                                  shift=torch.stack(shift).to(cfg.tdtype))

    @torch.no_grad()
    def decode_step(self, cache: HymbaCache, tokens: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, HymbaCache]:
        """One decode step: tokens (B,1) at position ``pos``. Updates
        ``cache`` in place and returns it with the (B,1,V) logits."""
        cfg = self.cfg
        x = self.embed_tokens(tokens)
        cache.kpos[pos % cache.k.shape[2]] = pos
        for i, p in enumerate(self.layers):
            h = apply_norm(cfg, p.ln1, x)
            o = decode_attention_raw(cfg, p.attn, h, cache.k[i], cache.v[i],
                                     pos, cache.kpos,
                                     attn_impl=self.attn_impl)
            o = cm.rms_norm(o, p.attn_norm.reshape(cfg.n_heads, cfg.hdim))
            attn_y = attn_out(p.attn, o.to(h.dtype))
            ssm_y, Sst = self._ssm_mix(p.ssm, h, state=cache.ssm[i])
            cache.ssm[i].copy_(Sst)
            cache.shift[i].copy_(h[:, -1])
            x = x + 0.5 * (attn_y + ssm_y)
            x = x + mlp(cfg, p.mlp, apply_norm(cfg, p.ln2, x))
        return self.unembed(x), cache
