"""RWKV6 "Finch" (arXiv:2404.05892): attention-free LM with data-dependent
per-channel decay, as multi-head GLA with the u-bonus; decode keeps an
O(1) state.

Counterpart of ``repro/models/rwkv6.py`` (see its faithfulness notes:
static token-shift mixes, the low-rank dynamic decay, per-head groupnorm
and an output gate). For T > 1 the time-mix runs the GLA scan picked by
``gla_impl`` (``"kernel"``: the hand-written CUDA scan; ``"chunked"``: the
plain ``gla_chunked``); a single decode token runs ``gla_step``, plain
torch, as the JAX package does. The decode step updates its cache in
place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models import common as cm
from repro_torch.models.recurrence import gla_step, make_gla
from repro_torch.models.transformer import (Norm, TransformerLM, _Params,
                                            apply_norm)

LORA_W = 64  # low-rank dim of the dynamic decay (paper: 64 for 7B)


class TimeMix(_Params):
    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        d, dt, f32 = cfg.d_model, cfg.tdtype, torch.float32
        HK = cfg.n_heads * cfg.hdim
        hk = (cfg.n_heads, cfg.hdim)
        # static token-shift mixing coefficients per projection (r k v w g)
        self.add("mu", (5, d), f32, "zeros", device)
        for name in ("wr", "wk", "wv", "wg"):
            self.add(name, (d, HK), dt, "scaled", device)
        self.add("wo", (HK, d), dt, "scaled", device)
        # dynamic decay: w = -exp(w0 + (x @ A) @ B)  (low-rank, Finch)
        self.add("w0", hk, f32, "zeros", device)
        self.add("wA", (d, LORA_W), dt, "scaled", device)
        self.add("wB", (LORA_W, HK), dt, "scaled", device)
        self.add("u", hk, f32, "zeros", device)
        self.add("ln_x", (HK,), f32, "ones", device)


class ChannelMix(_Params):
    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.tdtype
        self.add("mu", (2, d), torch.float32, "zeros", device)
        self.add("wk", (d, f), dt, "scaled", device)
        self.add("wv", (f, d), dt, "scaled", device)
        self.add("wr", (d, d), dt, "scaled", device)


class RwkvBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.ln1 = Norm(cfg, device)
        self.att = TimeMix(cfg, device)
        self.ln2 = Norm(cfg, device)
        self.ffn = ChannelMix(cfg, device)


@dataclasses.dataclass
class RwkvCache:
    """O(1) decode state: GLA matrix state + token-shift states."""

    state: torch.Tensor       # (L, B, H, K, V) float32
    shift_att: torch.Tensor   # (L, B, d) previous token (time-mix shift)
    shift_ffn: torch.Tensor   # (L, B, d) previous token (channel-mix shift)


def _mix(mu: torch.Tensor, x: torch.Tensor,
         x_prev: torch.Tensor) -> torch.Tensor:
    """lerp(x, prev_token(x), mu) — RWKV token shift."""
    return x + (x_prev - x) * mu.to(x.dtype)


class Rwkv6LM(TransformerLM):
    """RWKV6: time-mix (GLA) + channel-mix blocks."""

    def __init__(self, cfg: ArchConfig, *, device: DeviceLike = None,
                 attn_impl: str = "flash", gla_impl: str = "kernel"):
        super().__init__(cfg, device=device, attn_impl=attn_impl)
        self.gla_impl = gla_impl
        self.gla = make_gla(gla_impl)

    def make_block(self, device: torch.device) -> nn.Module:
        return RwkvBlock(self.cfg, device)

    # ------------------------------------------------------------ blocks --
    def _time_mix(self, p: TimeMix, x: torch.Tensor, x_prev: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (B,T,d); x_prev: (B,T,d) shifted input. Returns (out, S_fin)."""
        cfg = self.cfg
        B, T, _ = x.shape
        H, K = cfg.n_heads, cfg.hdim
        xr, xk, xv, xw, xg = (_mix(p.mu[i], x, x_prev) for i in range(5))
        r = (xr @ p.wr).reshape(B, T, H, K)
        k = (xk @ p.wk).reshape(B, T, H, K)
        v = (xv @ p.wv).reshape(B, T, H, K)
        g = F.silu((xg @ p.wg).float())
        lora = (xw @ p.wA) @ p.wB
        logw = -torch.exp(torch.clamp(
            p.w0.reshape(1, 1, H, K).float()
            + lora.reshape(B, T, H, K).float(), -8.0, 6.0))
        if T == 1 and state is not None:
            y, S = gla_step(state, r[:, 0], k[:, 0], v[:, 0], logw[:, 0],
                            p.u)
            y = y[:, None]
        else:
            y, S = self.gla(r, k, v, logw, p.u, initial_state=state)
        # per-head groupnorm then output gate
        y = cm.rms_norm(y.reshape(B, T, H, K),
                        p.ln_x.reshape(H, K)).reshape(B, T, H * K)
        return (y.float() * g).to(x.dtype) @ p.wo, S

    def _channel_mix(self, p: ChannelMix, x: torch.Tensor,
                     x_prev: torch.Tensor) -> torch.Tensor:
        xk = _mix(p.mu[0], x, x_prev)
        xr = _mix(p.mu[1], x, x_prev)
        k = torch.square(torch.relu((xk @ p.wk).float())).to(x.dtype)
        r = torch.sigmoid((xr @ p.wr).float())
        return (r * (k @ p.wv).float()).to(x.dtype)

    @staticmethod
    def _shift(x: torch.Tensor,
               first: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Previous-token x; position 0 sees ``first`` (zeros by default)."""
        pad = torch.zeros_like(x[:, :1]) if first is None else first[:, None]
        return torch.cat([pad, x[:, :-1]], dim=1)

    def layer_body(self, p: RwkvBlock, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = apply_norm(cfg, p.ln1, x)
        out, _ = self._time_mix(p.att, h, self._shift(h))
        x = x + out
        h = apply_norm(cfg, p.ln2, x)
        return x + self._channel_mix(p.ffn, h, self._shift(h))

    # ------------------------------------------------------------- decode --
    def init_cache(self, B: int, S_max: int = 1) -> RwkvCache:
        """A zero state (S_max is irrelevant: the state is O(1))."""
        cfg = self.cfg
        L, d = cfg.n_layers, cfg.d_model
        H, K = cfg.n_heads, cfg.hdim
        dev = self.embed.device
        return RwkvCache(
            state=torch.zeros((L, B, H, K, K), dtype=torch.float32,
                              device=dev),
            shift_att=torch.zeros((L, B, d), dtype=cfg.tdtype, device=dev),
            shift_ffn=torch.zeros((L, B, d), dtype=cfg.tdtype, device=dev))

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, RwkvCache]:
        """Run the prompt, return (full logits, state). ``cache_len`` is
        accepted for the serving steps' sake and ignored: the state is
        O(1)."""
        cfg = self.cfg
        x = self.embed_tokens(batch["tokens"])
        states, sa, sf = [], [], []
        for p in self.layers:
            h = apply_norm(cfg, p.ln1, x)
            out, S = self._time_mix(p.att, h, self._shift(h))
            sa.append(h[:, -1])
            x = x + out
            h = apply_norm(cfg, p.ln2, x)
            sf.append(h[:, -1])
            x = x + self._channel_mix(p.ffn, h, self._shift(h))
            states.append(S)
        logits = self.unembed(x)
        return logits, RwkvCache(state=torch.stack(states),
                                 shift_att=torch.stack(sa).to(cfg.tdtype),
                                 shift_ffn=torch.stack(sf).to(cfg.tdtype))

    @torch.no_grad()
    def decode_step(self, cache: RwkvCache, tokens: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, RwkvCache]:
        """One decode step: tokens (B,1). Updates ``cache`` in place and
        returns it with the (B,1,V) logits; ``pos`` is not needed."""
        cfg = self.cfg
        x = self.embed_tokens(tokens)
        for i, p in enumerate(self.layers):
            h = apply_norm(cfg, p.ln1, x)
            out, S = self._time_mix(p.att, h, cache.shift_att[i][:, None]
                                    .to(h.dtype), state=cache.state[i])
            cache.state[i].copy_(S)
            cache.shift_att[i].copy_(h[:, -1])
            x = x + out
            h = apply_norm(cfg, p.ln2, x)
            out = self._channel_mix(p.ffn, h,
                                    cache.shift_ffn[i][:, None].to(h.dtype))
            cache.shift_ffn[i].copy_(h[:, -1])
            x = x + out
        return self.unembed(x), cache
