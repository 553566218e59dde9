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

Under tensor parallelism (``sharding.tp``) the time-mix runs on the
rank's heads: ``wr``/``wk``/``wv``/``wg`` and the decay's ``wB``
column-parallel (``qkv``), ``w0``/``u`` by ``heads``, ``ln_x`` by
``qkv``, ``wo`` row-parallel; the GLA scan runs on the rank's H/M heads
with its own state. The channel-mix's ``wk`` is column-parallel and
``wv`` row-parallel (``mlp``); ``wr`` (``embed``, ``embed``) and the
token-shift mixes stay whole. Where the heads do not divide by M the
heads split into gcd(H, M) groups, each repeated on its ranks
(``transformer.head_group``), as JAX's 'heads' -> 'model' falls back.
The cache (``SplitCache`` of ``RwkvCache``s) holds each rank's heads of
the state; the token-shift carries stay whole.
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
from repro_torch.models.recurrence import gla_step, make_gla
from repro_torch.models.transformer import (Norm, SplitCache, TransformerLM,
                                            _Params, apply_norm, head_group,
                                            rank_cols, tp_cols, tp_out,
                                            tp_vec)
from repro_torch.sharding.tp import group_of

LORA_W = 64  # low-rank dim of the dynamic decay (paper: 64 for 7B)


class TimeMix(_Params):
    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        d, dt, f32 = cfg.d_model, cfg.tdtype, torch.float32
        HK = cfg.n_heads * cfg.hdim
        hk = (cfg.n_heads, cfg.hdim)
        # static token-shift mixing coefficients per projection (r k v w g)
        self.add("mu", (5, d), f32, "zeros", device, axes=(None, "embed"))
        for name in ("wr", "wk", "wv", "wg"):
            self.add(name, (d, HK), dt, "scaled", device,
                     axes=("embed", "qkv"))
        self.add("wo", (HK, d), dt, "scaled", device, axes=("qkv", "embed"))
        # dynamic decay: w = -exp(w0 + (x @ A) @ B)  (low-rank, Finch)
        self.add("w0", hk, f32, "zeros", device, axes=("heads", None))
        self.add("wA", (d, LORA_W), dt, "scaled", device,
                 axes=("embed", None))
        self.add("wB", (LORA_W, HK), dt, "scaled", device,
                 axes=(None, "qkv"))
        self.add("u", hk, f32, "zeros", device, axes=("heads", None))
        self.add("ln_x", (HK,), f32, "ones", device, axes=("qkv",))


class ChannelMix(_Params):
    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.tdtype
        self.add("mu", (2, d), torch.float32, "zeros", device,
                 axes=(None, "embed"))
        self.add("wk", (d, f), dt, "scaled", device, axes=("embed", "mlp"))
        self.add("wv", (f, d), dt, "scaled", device, axes=("mlp", "embed"))
        self.add("wr", (d, d), dt, "scaled", device, axes=("embed", "embed"))


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

    def block_roles(self, name: str, blk: nn.Module):
        """The time-mix's projections, ``ln_x`` and ``wo`` (one group),
        its per-head ``w0``/``u`` (a group of their own: they split
        where the heads divide), and the channel-mix's MLP."""
        a, f = f"{name}.att", f"{name}.ffn"
        out = {f"{a}.{w}": (1, False, a)
               for w in ("wr", "wk", "wv", "wg", "wB")}
        out.update({f"{a}.ln_x": (0, False, a), f"{a}.wo": (0, False, a),
                    f"{a}.w0": (0, False, f"{a}.heads"),
                    f"{a}.u": (0, False, f"{a}.heads"),
                    f"{f}.wk": (1, False, f), f"{f}.wv": (0, False, f)})
        return out

    # ------------------------------------------------------------ blocks --
    def _time_mix(self, p: TimeMix, x: torch.Tensor, x_prev: torch.Tensor,
                  state: Optional[List[torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x: (B,T,d); x_prev: (B,T,d) shifted input; ``state``: each of
        the group's ranks' (B, H/T, K, K) state, or None. Returns (out,
        each rank's final state)."""
        cfg = self.cfg
        tp = group_of(self, p)
        B, T, _ = x.shape
        H, K = cfg.n_heads, cfg.hdim
        Hl = head_group(tp, H)[1]
        xr, xk, xv, xw, xg = (_mix(p.mu[i], x, x_prev) for i in range(5))
        r, k, v = (tp_cols(tp, p, w, t, K)
                   for w, t in (("wr", xr), ("wk", xk), ("wv", xv)))
        g = [F.silu(t.float()) for t in tp_cols(tp, p, "wg", xg, K)]
        lora = tp_cols(tp, p, "wB", xw @ p.wA, K)
        w0, u, ln = (tp_vec(tp, p, n, H) for n in ("w0", "u", "ln_x"))
        state = state or [None] * len(tp.ranks)
        ys, finals = [], []
        for j in range(len(tp.ranks)):
            logw = -torch.exp(torch.clamp(
                w0[j].reshape(1, 1, Hl, K).float()
                + lora[j].reshape(B, T, Hl, K).float(), -8.0, 6.0))
            rj, kj, vj = (t[j].reshape(B, T, Hl, K) for t in (r, k, v))
            if T == 1 and state[j] is not None:
                y, S = gla_step(state[j], rj[:, 0], kj[:, 0], vj[:, 0],
                                logw[:, 0], u[j])
                y = y[:, None]
            else:
                y, S = self.gla(rj, kj, vj, logw, u[j],
                                initial_state=state[j])
            # per-head groupnorm then output gate
            y = cm.rms_norm(y.reshape(B, T, Hl, K),
                            ln[j].reshape(Hl, K)).reshape(B, T, Hl * K)
            ys.append((y.float() * g[j]).to(x.dtype))
            finals.append(S)
        return tp_out(tp, p, rank_cols(tp, ys, H)), finals

    def _channel_mix(self, p: ChannelMix, x: torch.Tensor,
                     x_prev: torch.Tensor) -> torch.Tensor:
        tp = group_of(self, p)
        xk = _mix(p.mu[0], x, x_prev)
        xr = _mix(p.mu[1], x, x_prev)
        kv = tp.reduce([
            torch.square(torch.relu((a @ wk).float())).to(x.dtype) @ wv
            for a, wk, wv in zip(tp.copy(xk), tp.pieces(p, "wk"),
                                 tp.pieces(p, "wv"))])
        r = torch.sigmoid((xr @ p.wr).float())
        return (r * kv.float()).to(x.dtype)

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
    def state_module(self) -> nn.Module:
        return self.layers[0].att

    def cache_len(self, cell: ShapeCell) -> int:
        return 1  # O(1) state; S_max is irrelevant

    def cache_specs(self, B: int, S_max: int) -> RwkvCache:
        cfg = self.cfg
        L, d = cfg.n_layers, cfg.d_model
        H, K = cfg.n_heads, cfg.hdim
        return RwkvCache(
            state=cm.shape_struct((L, B, H, K, K), torch.float32),
            shift_att=cm.shape_struct((L, B, d), cfg.tdtype),
            shift_ffn=cm.shape_struct((L, B, d), cfg.tdtype))

    def cache_axes(self) -> RwkvCache:
        return RwkvCache(state=("layers", "batch", "heads", None, None),
                         shift_att=("layers", "batch", "embed"),
                         shift_ffn=("layers", "batch", "embed"))

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
    def prefill_parts(self, batch: Dict[str, torch.Tensor],
                      cache_len: Optional[int] = None
                      ) -> Tuple[List[torch.Tensor], object]:
        """Run the prompt: (the logits' parts, the state). ``cache_len``
        is accepted for the serving steps' sake and ignored: the state is
        O(1). Under tensor parallelism a ``SplitCache`` of each rank's
        heads of the state."""
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
        sa = torch.stack(sa).to(cfg.tdtype)
        sf = torch.stack(sf).to(cfg.tdtype)
        parts = [RwkvCache(state=torch.stack([S[j] for S in states]),
                           shift_att=sa, shift_ffn=sf)
                 for j in range(len(states[0]))]
        if self.tp is None:
            return self.final_parts(x), parts[0]
        return self.final_parts(x), SplitCache(parts, 0)

    @torch.no_grad()
    def decode_split(self, cache, tokens: torch.Tensor, pos: int
                     ) -> Tuple[List[torch.Tensor], object]:
        """One decode step: tokens (B,1). Updates ``cache`` in place and
        returns it with the logits' parts; ``pos`` is not needed."""
        cfg = self.cfg
        parts = cache.parts if isinstance(cache, SplitCache) else [cache]
        x = self.embed_tokens(tokens)
        for i, p in enumerate(self.layers):
            h = apply_norm(cfg, p.ln1, x)
            out, S = self._time_mix(
                p.att, h, parts[0].shift_att[i][:, None].to(h.dtype),
                state=[c.state[i] for c in parts])
            for c, s in zip(parts, S):
                c.state[i].copy_(s)
                c.shift_att[i].copy_(h[:, -1])
            x = x + out
            h = apply_norm(cfg, p.ln2, x)
            out = self._channel_mix(p.ffn, h,
                                    parts[0].shift_ffn[i][:, None]
                                    .to(h.dtype))
            for c in parts:
                c.shift_ffn[i].copy_(h[:, -1])
            x = x + out
        return self.final_parts(x), cache
