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

Under tensor parallelism (``sharding.tp``) every attention runs on the
rank's heads: the encoder's non-causal self-attention, the decoder's
causal self-attention and its cross-attention (q and the encoder's K/V
column-parallel by the rank's heads, ``wo`` row-parallel), and every MLP
on its d_ff columns. The cache (``SplitCache`` of ``EncDecCache``s)
splits the self-attention ring and the cross K/V over the ranks' slots,
as JAX's ``cache_seq`` -> 'model' splits ``k``/``v`` and ``xk``/``xv``;
at decode each rank's partials over its slots, non-causal for the cross
K/V, are merged across the ranks (``tp_decode_attention``).
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
                                            SplitCache, TransformerLM,
                                            _Params, _heads, apply_norm,
                                            attention_roles, layout_cache,
                                            mlp_roles, ring_slots,
                                            run_layers, tp_attention,
                                            tp_decode_attention,
                                            tp_out_whole)
from repro_torch.sharding.tp import group_of


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

    def tp_roles(self):
        """The decoder's and the vocab's (``block_roles``), and each
        encoder layer's attention and MLP."""
        out = super().tp_roles()
        for i in range(len(self.encoder)):
            out.update(attention_roles(f"encoder.{i}.attn",
                                       self.encoder[i].attn))
            out.update(mlp_roles(self.cfg, f"encoder.{i}.mlp"))
        return out

    def block_roles(self, name: str, blk: nn.Module):
        return {**attention_roles(f"{name}.attn", blk.attn),
                **attention_roles(f"{name}.xattn", blk.xattn),
                **mlp_roles(self.cfg, f"{name}.mlp")}

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
        a, _ = self.attention(
            p.attn, apply_norm(cfg, p.ln1, h), positions,
            lambda q, k, v: cm.chunked_call(self.attn_impl, q, k, v,
                                            causal=False, qpos=positions,
                                            kpos=positions), rope=False)
        h = h + a
        return h + self.ffn(p, apply_norm(cfg, p.ln2, h))

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
    def _cross(self, p: Attention, x: torch.Tensor, enc: torch.Tensor
               ) -> Tuple[torch.Tensor, object]:
        """The cross-attention of the normed x to the encoder states:
        (output, (xk, xv) as the cache takes them)."""
        dev = x.device
        S, Se = x.shape[1], enc.shape[1]
        return tp_attention(
            self.cfg, group_of(self, p), p, x,
            torch.zeros(S, dtype=torch.int32, device=dev),
            lambda q, k, v: cm.chunked_call(
                self.attn_impl, q, k, v, causal=False,
                qpos=torch.zeros(S, dtype=torch.int32, device=dev),
                kpos=torch.zeros(Se, dtype=torch.int32, device=dev)),
            rope=False, kv_in=enc)

    def _decoder_body(self, p: EncDecBlock, h: torch.Tensor,
                      positions: torch.Tensor, enc: torch.Tensor,
                      kv: Optional[List] = None) -> torch.Tensor:
        """One decoder layer over the whole sequence; ``kv`` collects its
        ((k, v), (xk, xv)) for the cache."""
        cfg = self.cfg
        a, skv = self.attention(
            p.attn, apply_norm(cfg, p.ln1, h), positions,
            lambda q, k, v: cm.chunked_call(self.attn_impl, q, k, v,
                                            causal=True, qpos=positions,
                                            kpos=positions), rope=False)
        h = h + a
        a, xkv = self._cross(p.xattn, apply_norm(cfg, p.ln_x, h), enc)
        h = h + a
        if kv is not None:
            kv.append((skv, xkv))
        return h + self.ffn(p, apply_norm(cfg, p.ln2, h))

    def decoder_hidden(self, tokens: torch.Tensor, enc: torch.Tensor, *,
                       remat: bool = True,
                       kv: Optional[List] = None) -> torch.Tensor:
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        x = self.embed_tokens(tokens)
        x = x + _sinusoid_on(S, x)
        if kv is not None:
            for p in self.layers:
                x = self._decoder_body(p, x, positions, enc, kv)
            return x
        return run_layers(self._decoder_body, self.layers, x, positions,
                          enc, remat=remat)

    def hidden(self, batch: Dict[str, torch.Tensor], *,
               remat: bool = True) -> torch.Tensor:
        """Encode the batch's frames, then the decoder over its tokens;
        ``forward``, ``logits`` and ``loss`` are ``TransformerLM``'s."""
        enc = self.encode(batch["frames"], remat=remat)
        return self.decoder_hidden(batch["tokens"], enc, remat=remat)

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
    def prefill_parts(self, batch: Dict[str, torch.Tensor],
                      cache_len: Optional[int] = None
                      ) -> Tuple[List[torch.Tensor], object]:
        """Encode the frames, run the prompt: (the logits' parts, the
        cache): the decoder's K/V as a ring of ``cache_len`` slots, and
        each layer's cross K/V of the encoder states. Under tensor
        parallelism both split over the ranks' slots where the ring and
        the encoder's length divide by M (a ``SplitCache``), else each
        is whole."""
        tokens = batch["tokens"]
        S = tokens.shape[1]
        tp = self.tp
        enc = self.encode(batch["frames"], remat=False)
        kv: List = []
        x = self.decoder_hidden(tokens, enc, kv=kv)
        parts = self.final_parts(x)
        C, Se = ring_slots(cache_len, S, 0), enc.shape[1]
        split = tp is not None and not C % tp.M and not Se % tp.M
        ks, vs, kpos = layout_cache(tp, [a for a, _ in kv], S, cache_len,
                                    0, split)
        xks, xvs, _ = layout_cache(tp, [b for _, b in kv], Se, None, 0,
                                   split)
        if tp is None or not split:
            one = EncDecCache(k=ks[0], v=vs[0], kpos=kpos, xk=xks[0],
                              xv=xvs[0])
            if tp is None:
                return parts, one
            return parts, SplitCache([one], 0)
        return parts, SplitCache(
            [EncDecCache(k=k, v=v, kpos=kp.contiguous(), xk=xk, xv=xv)
             for k, v, kp, xk, xv in zip(ks, vs, tp.slice(kpos, 0), xks,
                                         xvs)], C)

    def _decode_cross(self, p: Attention, h: torch.Tensor, cache, i: int
                      ) -> torch.Tensor:
        """Layer i's cross-attention of one decode step's normed h to the
        cached encoder K/V: q with every head, the ranks' partials over
        their slots merged where the cache is split."""
        cfg, tp, g = self.cfg, self.tp, group_of(self, p)
        zero = torch.zeros((1,), dtype=torch.int32, device=h.device)
        q = g.gather([x @ w for x, w in zip(g.copy(h), g.pieces(p, "wq"))],
                     -1, True)
        q = _heads(cfg, p, q, cfg.n_heads, None, zero, False)
        if isinstance(cache, SplitCache) and cache.slots:
            o = tp_decode_attention(
                tp, q, [c.xk[i] for c in cache.parts],
                [c.xv[i] for c in cache.parts],
                [torch.zeros((c.xk.shape[2],), dtype=torch.int32,
                             device=h.device) for c in cache.parts],
                zero, 0, self.attn_impl, causal=False)
        else:
            c = cache.parts[0] if isinstance(cache, SplitCache) else cache
            o = cm.chunked_call(
                self.attn_impl, q, c.xk[i], c.xv[i], causal=False,
                qpos=zero, kpos=torch.zeros((c.xk.shape[2],),
                                            dtype=torch.int32,
                                            device=h.device))
        return tp_out_whole(cfg, g, p, o)

    @torch.no_grad()
    def decode_split(self, cache, tokens: torch.Tensor, pos: int
                     ) -> Tuple[List[torch.Tensor], object]:
        """One decode step: tokens (B,1) at position ``pos``, its sinusoid
        row at ``pos % S_max`` as in JAX. Updates ``cache`` in place and
        returns it with the logits' parts (``prefill_split``'s)."""
        cfg = self.cfg
        x = self.embed_tokens(tokens)
        if isinstance(cache, SplitCache):
            S_max = cache.slots or cache.parts[0].k.shape[2]
        else:
            S_max = cache.k.shape[2]
        x = x + _sinusoid_on(S_max, x)[pos % S_max]
        qpos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        slot = self.mark_slot(cache, pos)
        for i, p in enumerate(self.layers):
            x = x + self.decode_attention(p.attn, apply_norm(cfg, p.ln1, x),
                                          cache, i, slot, qpos, rope=False)
            x = x + self._decode_cross(p.xattn, apply_norm(cfg, p.ln_x, x),
                                       cache, i)
            x = x + self.ffn(p, apply_norm(cfg, p.ln2, x))
        return self.final_parts(x), cache
