"""Whisper-style encoder-decoder (arXiv:2212.04356), counterpart of
``repro/models/encdec.py``. The conv/audio frontend is a stub, as there:
the inputs carry precomputed log-mel frame embeddings (B, S,
frontend_dim); a linear projection and a pair-average stride-2 downsample
stand in for the two convs. Sinusoid positions, no RoPE. The encoder is
bidirectional; the decoder is causal with cross-attention.

Every attention call is JAX's direct ``attention_chunked`` call at its
default ``block_k`` of 512 (``cm.chunked_call``): the flash kernel under
``attn_impl="flash"``, non-causal in the encoder and the cross-attention
(qpos = kpos = 0 there), with the same ``attention_chunked`` as its
backward. The decode step updates its cache in place.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.device import DeviceLike
from repro_torch.models import common as cm
from repro_torch.models.transformer import (MLP, Attention, Block, Norm,
                                            TransformerLM, _Params,
                                            apply_norm, attn_out,
                                            decode_attention_raw, mlp,
                                            project_qkv, ring_layout,
                                            run_layers)


@dataclasses.dataclass
class EncDecCache:
    """Decoder self-attn ring cache + precomputed cross-attn K/V."""

    k: torch.Tensor          # (L, B, S_max, G, hd) decoder self-attn
    v: torch.Tensor
    kpos: torch.Tensor       # (S_max,) int32 stored positions, -1 = empty
    xk: torch.Tensor         # (L, B, S_enc, G, hd) cross-attn keys (static)
    xv: torch.Tensor


def _sinusoid(S: int, d: int) -> np.ndarray:
    pos = np.arange(S)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / np.power(10_000.0, dim / d)
    out = np.zeros((S, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


def _sinusoid_on(S: int, like: torch.Tensor) -> torch.Tensor:
    """The (S, d) table in like's dtype on its device (JAX casts the f32
    table to x's dtype before the add)."""
    return _sinusoid_table(S, like.shape[-1], like.device, like.dtype)


@functools.lru_cache(maxsize=None)
def _sinusoid_table(S: int, d: int, device: torch.device,
                    dtype: torch.dtype) -> torch.Tensor:
    # one host->device copy per shape: a copy from pageable memory
    # synchronises the stream, so never make it per decode step
    return torch.from_numpy(_sinusoid(S, d)).to(device=device, dtype=dtype)


class Frontend(_Params):
    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.add("proj", (cfg.frontend_dim, cfg.d_model), cfg.tdtype,
                 "scaled", device, axes=("frontend", "embed"))


class EncDecBlock(nn.Module):
    """A decoder layer: self-attention, cross-attention (no bias, no
    qk-norm), FFN."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.ln1 = Norm(cfg, device)
        self.attn = Attention(cfg, device)
        self.ln_x = Norm(cfg, device)
        self.xattn = Attention(cfg, device, cross=True)
        self.ln2 = Norm(cfg, device)
        self.mlp = MLP(cfg, device)


class EncDecLM(TransformerLM):
    """Whisper-medium shaped enc-dec; n_layers = decoder depth. Parameters
    beside the decoder's: ``frontend.proj``, the ``encoder`` layers
    (``encoder_layers`` of them) and ``enc_norm``."""

    def __init__(self, cfg: ArchConfig, *, device: DeviceLike = None,
                 attn_impl: str = "flash"):
        super().__init__(cfg, device=device, attn_impl=attn_impl)
        dev = self.embed.device
        self.frontend = Frontend(cfg, dev)
        self.encoder = nn.ModuleList(Block(cfg, dev)
                                     for _ in range(cfg.encoder_layers))
        self.enc_norm = Norm(cfg, dev)

    def make_block(self, device: torch.device) -> nn.Module:
        return EncDecBlock(self.cfg, device)

    # -------------------------------------------------------------- specs --
    def encoder_layer_specs(self) -> cm.ParamTree:
        return self.param_specs()["encoder"]

    def cache_specs(self, B: int, S_max: int) -> EncDecCache:
        """The cross K/V hold S_max // 2 positions, as JAX's."""
        cfg = self.cfg
        G, hd = cfg.n_kv_heads, cfg.hdim
        kv = (cfg.n_layers, B, S_max, G, hd)
        xkv = (cfg.n_layers, B, S_max // 2, G, hd)
        return EncDecCache(k=cm.shape_struct(kv, cfg.tdtype),
                           v=cm.shape_struct(kv, cfg.tdtype),
                           kpos=cm.shape_struct((S_max,), torch.int32),
                           xk=cm.shape_struct(xkv, cfg.tdtype),
                           xv=cm.shape_struct(xkv, cfg.tdtype))

    def cache_axes(self) -> EncDecCache:
        kv = ("layers", "batch", "cache_seq", "kv_heads", None)
        return EncDecCache(k=kv, v=kv, kpos=(None,), xk=kv, xv=kv)

    def input_specs(self, cell: ShapeCell) -> Dict[str, object]:
        """As JAX's: a decode cell's cache spans the whole seq_len."""
        cfg = self.cfg
        B, S = cell.global_batch, cell.seq_len
        if cell.kind in ("train", "prefill"):
            return {"tokens": cm.shape_struct((B, S), torch.int32),
                    "frames": cm.shape_struct((B, S, cfg.frontend_dim),
                                              cfg.tdtype)}
        return {"tokens": cm.shape_struct((B, 1), torch.int32),
                "pos": cm.shape_struct((), torch.int32),
                "cache": self.cache_specs(B, S)}

    def input_axes(self, cell: ShapeCell) -> Dict[str, object]:
        if cell.kind in ("train", "prefill"):
            return {"tokens": ("batch", "seq"),
                    "frames": ("batch", "seq", "frontend")}
        return {"tokens": ("batch", None), "pos": (),
                "cache": self.cache_axes()}

    # ------------------------------------------------------------ encoder --
    def _encoder_body(self, p: Block, h: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        q, k, v = project_qkv(cfg, p.attn, apply_norm(cfg, p.ln1, h),
                              positions, rope=False)
        o = cm.chunked_call(self.attn_impl, q, k, v, causal=False,
                            qpos=positions, kpos=positions)
        h = h + attn_out(p.attn, o)
        return h + mlp(cfg, p.mlp, apply_norm(cfg, p.ln2, h))

    def encode(self, frames: torch.Tensor, *,
               remat: bool = True) -> torch.Tensor:
        """frames: (B, S, frontend_dim) -> (B, S//2, d) encoder states."""
        x = frames @ self.frontend.proj
        # stride-2 "conv" stub: average adjacent frames
        x = 0.5 * (x[:, 0::2] + x[:, 1::2])
        Se = x.shape[1]
        x = x + _sinusoid_on(Se, x)
        positions = torch.arange(Se, dtype=torch.int32, device=x.device)
        x = run_layers(self._encoder_body, self.encoder, x, positions,
                       remat=remat)
        return apply_norm(self.cfg, self.enc_norm, x)

    # ------------------------------------------------------------ decoder --
    def _cross_kv(self, p: Attention, enc: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        B, Se, _ = enc.shape
        G, hd = cfg.n_kv_heads, cfg.hdim
        return ((enc @ p.wk).reshape(B, Se, G, hd),
                (enc @ p.wv).reshape(B, Se, G, hd))

    def _cross_attend(self, p: Attention, x: torch.Tensor, xk: torch.Tensor,
                      xv: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        q = (x @ p.wq).reshape(B, S, cfg.n_heads, cfg.hdim)
        dev = x.device
        o = cm.chunked_call(
            self.attn_impl, q, xk, xv, causal=False,
            qpos=torch.zeros(S, dtype=torch.int32, device=dev),
            kpos=torch.zeros(xk.shape[1], dtype=torch.int32, device=dev))
        return attn_out(p, o)

    def _decoder_body(self, p: EncDecBlock, h: torch.Tensor,
                      positions: torch.Tensor, enc: torch.Tensor,
                      kv: Optional[List] = None) -> torch.Tensor:
        """One decoder layer over the whole sequence; ``kv`` collects its
        (k, v, xk, xv) for the cache."""
        cfg = self.cfg
        q, k, v = project_qkv(cfg, p.attn, apply_norm(cfg, p.ln1, h),
                              positions, rope=False)
        o = cm.chunked_call(self.attn_impl, q, k, v, causal=True,
                            qpos=positions, kpos=positions)
        h = h + attn_out(p.attn, o)
        xk, xv = self._cross_kv(p.xattn, enc)
        h = h + self._cross_attend(p.xattn, apply_norm(cfg, p.ln_x, h), xk,
                                   xv)
        if kv is not None:
            kv.append((k, v, xk, xv))
        return h + mlp(cfg, p.mlp, apply_norm(cfg, p.ln2, h))

    def decoder_forward(self, tokens: torch.Tensor, enc: torch.Tensor, *,
                        remat: bool = True) -> torch.Tensor:
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        x = self.embed_tokens(tokens)
        x = x + _sinusoid_on(S, x)
        x = run_layers(self._decoder_body, self.layers, x, positions, enc,
                       remat=remat)
        return self.unembed(x)

    def logits(self, batch: Dict[str, torch.Tensor], *,
               remat: bool = True) -> torch.Tensor:
        """Encode the batch's frames, then the decoder over its tokens;
        ``forward`` and ``loss`` are ``TransformerLM``'s."""
        enc = self.encode(batch["frames"], remat=remat)
        return self.decoder_forward(batch["tokens"], enc, remat=remat)

    # ------------------------------------------------------------- decode --
    def init_cache(self, B: int, S_max: int) -> EncDecCache:
        """Zero caches, kpos -1; the cross K/V hold S_max // 2 positions,
        as JAX ``EncDecLM.init_cache``."""
        cfg = self.cfg
        G, hd = cfg.n_kv_heads, cfg.hdim
        dev = self.embed.device
        kv = (cfg.n_layers, B, S_max, G, hd)
        xkv = (cfg.n_layers, B, S_max // 2, G, hd)
        return EncDecCache(
            k=torch.zeros(kv, dtype=cfg.tdtype, device=dev),
            v=torch.zeros(kv, dtype=cfg.tdtype, device=dev),
            kpos=torch.full((S_max,), -1, dtype=torch.int32, device=dev),
            xk=torch.zeros(xkv, dtype=cfg.tdtype, device=dev),
            xv=torch.zeros(xkv, dtype=cfg.tdtype, device=dev))

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, EncDecCache]:
        """Encode the frames, run the prompt, return (full logits, cache):
        the decoder's K/V as a ring of ``cache_len`` slots, and each
        layer's cross K/V of the encoder states."""
        tokens = batch["tokens"]
        S = tokens.shape[1]
        enc = self.encode(batch["frames"], remat=False)
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        x = self.embed_tokens(tokens)
        x = x + _sinusoid_on(S, x)
        kv: List = []
        for p in self.layers:
            x = self._decoder_body(p, x, positions, enc, kv)
        logits = self.unembed(x)
        ks, vs, xks, xvs = (torch.stack(t) for t in zip(*kv))
        ks, vs, kpos = ring_layout(ks, vs, S, cache_len)
        return logits, EncDecCache(k=ks.contiguous(), v=vs.contiguous(),
                                   kpos=kpos, xk=xks.contiguous(),
                                   xv=xvs.contiguous())

    @torch.no_grad()
    def decode_step(self, cache: EncDecCache, tokens: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, EncDecCache]:
        """One decode step: tokens (B,1) at position ``pos``, its sinusoid
        row at ``pos % S_max`` as in JAX. Updates ``cache`` in place and
        returns it with the (B,1,V) logits."""
        cfg = self.cfg
        x = self.embed_tokens(tokens)
        S_max = cache.k.shape[2]
        x = x + _sinusoid_on(S_max, x)[pos % S_max]
        cache.kpos[pos % S_max] = pos
        for i, p in enumerate(self.layers):
            o = decode_attention_raw(
                cfg, p.attn, apply_norm(cfg, p.ln1, x), cache.k[i],
                cache.v[i], pos, cache.kpos, attn_impl=self.attn_impl,
                rope=False)
            x = x + attn_out(p.attn, o)
            x = x + self._cross_attend(p.xattn, apply_norm(cfg, p.ln_x, x),
                                       cache.xk[i], cache.xv[i])
            x = x + mlp(cfg, p.mlp, apply_norm(cfg, p.ln2, x))
        return self.unembed(x), cache
