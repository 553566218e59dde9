"""Decoder-only transformer LM: GQA attention (optional qk-norm, qkv bias,
sliding window), swiglu/gelu FFN, KV-cache prefill/decode. Covers the dense
archs qwen2.5-14b, granite-3-2b, qwen3-4b and stablelm-12b, and is the base
of ``rwkv6.Rwkv6LM`` and ``hymba.HymbaLM``, which override ``make_block``,
``layer_body``, ``prefill`` and ``decode_step``; of ``moe.MoETransformerLM``
(``ffn``); of ``encdec.EncDecLM`` (``logits``, ``prefill``,
``decode_step``); and of ``vlm.VlmLM`` (``logits``, ``prefill``).

Counterpart of ``repro/models/transformer.py``. Layers are an
``nn.ModuleList`` instead of the stacked (L, ...) scan carrier; weight
matrices keep the JAX layout (in, out), so ``x @ w`` is the JAX einsum and
the converter only splits and renames. Each parameter is declared with its
init style and logical axes (``_Params.add``); ``param_specs`` gives JAX's
stacked spec tree and ``named_param_specs`` one spec a ``state_dict`` name.
The models call no sharding ``hint``: the sharded step
(``train/sharded.py``) stores each parameter as its shard and gathers it
where the layer reads it, so activations are plain tensors.

``attn_impl`` picks the attention at every call site (forward, the
training path, prefill, decode): ``"flash"`` (default) is the hand-written
CUDA kernel through ``kernels.ops.flash_attention``; ``"ref"`` and
``"chunked"`` are the plain torch versions of ``models.common``, with the
full-sequence paths keeping the JAX package's banded dispatch for sliding
windows (``"chunked"`` there is exactly JAX ``causal_attention``).

Training: ``loss`` runs ``logits`` (embed -> ``backbone``, each layer
under ``torch.utils.checkpoint`` with ``remat``, as JAX's scan runs it
under ``jax.checkpoint`` -> ``unembed``) -> ``softmax_xent`` with
gradients on;
the kernels carry them through ``kernels.autograd``. ``forward``,
``prefill`` and ``decode_step`` serve under ``torch.no_grad``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.convert import restack
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import common as cm

ATTN_IMPLS = ("flash", "ref", "chunked")


# ----------------------------------------------------------------- params --
class _Params(nn.Module):
    """A flat set of named parameters, each tagged with its init style
    ('normal', 'zeros', 'ones', 'embed', 'scaled') and its logical axes,
    as ParamSpec does."""

    def __init__(self):
        super().__init__()
        self.inits: Dict[str, str] = {}
        self.axes: Dict[str, Tuple[Optional[str], ...]] = {}

    def add(self, name: str, shape: Tuple[int, ...], dtype: torch.dtype,
            init: str, device: torch.device, *,
            axes: Tuple[Optional[str], ...]) -> None:
        if len(axes) != len(shape):
            raise ValueError(f"{name}: shape {shape}, axes {axes}")
        self.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device)))
        self.inits[name] = init
        self.axes[name] = tuple(axes)

    def specs(self) -> Dict[str, cm.ParamSpec]:
        """This module's own parameters (not its children's) as specs."""
        return {name: cm.ParamSpec(tuple(getattr(self, name).shape),
                                   getattr(self, name).dtype, init,
                                   self.axes[name])
                for name, init in self.inits.items()}


class Norm(_Params):
    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.add("scale", (cfg.d_model,), torch.float32, "ones", device,
                 axes=("embed",))
        if cfg.norm == "layernorm":
            self.add("bias", (cfg.d_model,), torch.float32, "zeros", device,
                     axes=("embed",))


class Attention(_Params):
    """q/k/v/o projections; the qkv bias and qk-norm of the config, except
    for cross-attention (``cross``), which takes neither (JAX
    ``attention_specs(cross=True)``)."""

    def __init__(self, cfg: ArchConfig, device: torch.device, *,
                 cross: bool = False):
        super().__init__()
        d, hd, H, G, dt = (cfg.d_model, cfg.hdim, cfg.n_heads,
                           cfg.n_kv_heads, cfg.tdtype)
        into, out_of = ("embed", "qkv"), ("qkv", "embed")
        self.add("wq", (d, H * hd), dt, "scaled", device, axes=into)
        self.add("wk", (d, G * hd), dt, "scaled", device, axes=into)
        self.add("wv", (d, G * hd), dt, "scaled", device, axes=into)
        self.add("wo", (H * hd, d), dt, "scaled", device, axes=out_of)
        if cfg.qkv_bias and not cross:
            self.add("bq", (H * hd,), dt, "zeros", device, axes=("qkv",))
            self.add("bk", (G * hd,), dt, "zeros", device, axes=("qkv",))
            self.add("bv", (G * hd,), dt, "zeros", device, axes=("qkv",))
        if cfg.qk_norm and not cross:
            self.add("q_norm", (hd,), torch.float32, "ones", device,
                     axes=(None,))
            self.add("k_norm", (hd,), torch.float32, "ones", device,
                     axes=(None,))


class MLP(_Params):
    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.tdtype
        width = 2 * f if cfg.act == "swiglu" else f
        self.add("wi", (d, width), dt, "scaled", device,
                 axes=("embed", "mlp"))
        self.add("wo", (f, d), dt, "scaled", device, axes=("mlp", "embed"))


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        self.ln1 = Norm(cfg, device)
        self.attn = Attention(cfg, device)
        self.ln2 = Norm(cfg, device)
        self.mlp = MLP(cfg, device)


# ------------------------------------------------------------------ specs --
META = torch.device("meta")


def stack_specs(mod: _Params, L: int) -> Dict[str, cm.ParamSpec]:
    """``mod``'s own specs, L of each stacked on a leading ``layers``
    dim, as JAX declares a layer's leaves."""
    return {name: s.stacked(L) for name, s in mod.specs().items()}


def _norm_spec(cfg: ArchConfig, L: int) -> Dict[str, cm.ParamSpec]:
    return stack_specs(Norm(cfg, META), L)


def _final_norm_spec(cfg: ArchConfig) -> Dict[str, cm.ParamSpec]:
    return Norm(cfg, META).specs()


def attention_specs(cfg: ArchConfig, L: int, *, cross: bool = False
                    ) -> Dict[str, cm.ParamSpec]:
    return stack_specs(Attention(cfg, META, cross=cross), L)


def mlp_specs(cfg: ArchConfig, L: int) -> Dict[str, cm.ParamSpec]:
    return stack_specs(MLP(cfg, META), L)


def _stack(specs: List[cm.ParamSpec]) -> cm.ParamSpec:
    """One leaf's per-layer specs -> its stacked spec."""
    if any(s != specs[0] for s in specs):
        raise ValueError(f"layers declare one leaf differently: {specs}")
    return specs[0].stacked(len(specs))


# ---------------------------------------------------------------- compute --
def apply_norm(cfg: ArchConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return cm.layer_norm(x, p.scale, p.bias)
    return cm.rms_norm(x, p.scale)


def project_qkv(cfg: ArchConfig, p: Attention, x: torch.Tensor,
                positions: torch.Tensor, *, rope: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> q (B,S,H,hd), k/v (B,S,G,hd), with bias/qk-norm/RoPE
    (``rope=False``: no rotation, as encdec's sinusoid-embedded
    attention)."""
    B, S, _ = x.shape
    H, G, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, G, hd)
    v = v.reshape(B, S, G, hd)
    if cfg.qk_norm:
        q = cm.rms_norm(q, p.q_norm)
        k = cm.rms_norm(k, p.k_norm)
    if rope:
        q = cm.apply_rope(q, positions, cfg.rope_theta)
        k = cm.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(p: Attention, o: torch.Tensor) -> torch.Tensor:
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ p.wo


def causal_attention(cfg: ArchConfig, q, k, v, positions: torch.Tensor,
                     attn_impl: str = "flash") -> torch.Tensor:
    """Causal self-attention. The kernel takes the window itself; the plain
    implementations go through ``cm.attention_plain``, the JAX dispatch
    (banded O(S*w) for sliding windows, else ``attn_impl``)."""
    w = cfg.sliding_window
    if attn_impl == "flash":
        return cm.make_attention("flash")(q, k, v, causal=True, window=w,
                                          qpos=positions, kpos=positions,
                                          self_attention=True)
    return cm.attention_plain(q, k, v, window=w, qpos=positions,
                              kpos=positions, impl=attn_impl)


def decode_attention_raw(cfg: ArchConfig, p: Attention, x: torch.Tensor,
                         k_cache: torch.Tensor, v_cache: torch.Tensor,
                         pos: int, kpos: torch.Tensor, *,
                         attn_impl: str = "flash",
                         rope: bool = True) -> torch.Tensor:
    """One-token decode against a (B, S_max, G, hd) cache slice.

    Returns the pre-projection heads (B,1,H,hd). Unlike the JAX version,
    which returns updated copies of a donated cache, this writes the new
    k/v into ``k_cache``/``v_cache`` in place at slot ``pos % S_max``.
    ``kpos`` is the (S_max,) stored-position array (-1 = empty slot),
    maintained by the caller.
    """
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = project_qkv(cfg, p, x, positions, rope=rope)
    write = pos % k_cache.shape[1]
    k_cache[:, write] = k[:, 0].to(k_cache.dtype)
    v_cache[:, write] = v[:, 0].to(v_cache.dtype)
    return cm.make_attention(attn_impl)(q, k_cache, v_cache, causal=True,
                                        window=cfg.sliding_window,
                                        qpos=positions, kpos=kpos)


def mlp(cfg: ArchConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    h = x @ p.wi
    if cfg.act == "swiglu":
        gate, up = h.chunk(2, dim=-1)
        h = F.silu(gate.float()).to(up.dtype) * up
    else:  # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
    return h @ p.wo


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean cross entropy in f32, as JAX ``softmax_xent``: the max
    is detached (``stop_gradient``), lse = log sum exp(logits - max) + max,
    the true logit by index (the iota compare of JAX picks the same one).
    Returns (loss, denominator = max(sum mask, 1))."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    true = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = (lse - true) * mask
    denom = mask.sum().clamp_min(1.0)
    return nll.sum() / denom, denom


def ring_layout(ks: torch.Tensor, vs: torch.Tensor, S: int,
                cache_len: Optional[int], *, window: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lay out prefill K/V (L,B,S,G,hd) as a ring cache of ``cache_len``
    slots where slot = position % cache_len (the decode-write invariant).

    Returns (k, v, kpos) with kpos[slot] = stored position or -1.
    """
    C = cache_len or (min(S, window) if window else S)
    if window:
        C = min(C, window) if S >= window else C
    dev = ks.device
    if S >= C:
        # keep the last C positions, rotated so slot = pos % C
        shift = (S - C) % C
        ks = torch.roll(ks[:, :, S - C:], shift, dims=2)
        vs = torch.roll(vs[:, :, S - C:], shift, dims=2)
        kpos = torch.roll(torch.arange(S - C, S, dtype=torch.int32,
                                       device=dev), shift)
    else:
        pad = C - S
        ks = F.pad(ks, (0, 0, 0, 0, 0, pad))
        vs = F.pad(vs, (0, 0, 0, 0, 0, pad))
        kpos = torch.cat([torch.arange(S, dtype=torch.int32, device=dev),
                          torch.full((pad,), -1, dtype=torch.int32,
                                     device=dev)])
    return ks, vs, kpos


def run_layers(body, layers, x: torch.Tensor, *args,
               remat: bool) -> torch.Tensor:
    """``x = body(p, x, *args)`` for every layer p in turn. With ``remat``
    (and grad mode on) each body runs under ``torch.utils.checkpoint``:
    only its input is kept and the body runs again in the backward, as
    JAX's ``jax.checkpoint(nothing_saveable)`` does over its scans."""
    remat = remat and torch.is_grad_enabled()
    for p in layers:
        x = (checkpoint(body, p, x, *args, use_reentrant=False) if remat
             else body(p, x, *args))
    return x


@dataclasses.dataclass
class DecodeCache:
    """KV cache of the dense transformer."""

    k: torch.Tensor          # (L, B, S_max, G, hd)
    v: torch.Tensor
    kpos: torch.Tensor       # (S_max,) int32 stored positions, -1 = empty


class TransformerLM(nn.Module):
    """Dense decoder-only LM. Parameters are created uninitialised on
    ``device``; fill them with ``init_params`` or ``load_state_dict``."""

    def __init__(self, cfg: ArchConfig, *, device: DeviceLike = None,
                 attn_impl: str = "flash"):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        dev = resolve_device(device)
        self.cfg = cfg
        self.attn_impl = attn_impl
        V = cfg.padded_vocab
        self.embed = nn.Parameter(torch.empty((V, cfg.d_model),
                                              dtype=cfg.tdtype, device=dev))
        self.layers = nn.ModuleList(self.make_block(dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg, dev)
        if cfg.tie_embeddings:
            self.lm_head = None
        else:
            self.lm_head = nn.Parameter(
                torch.empty((cfg.d_model, V), dtype=cfg.tdtype, device=dev))

    #: the model's bare parameters: (init style, logical axes)
    TOP_PARAMS = {"embed": ("embed", ("vocab", "embed")),
                  "lm_head": ("scaled", ("embed", "vocab"))}

    def make_block(self, device: torch.device) -> nn.Module:
        """One layer's parameter modules; subclasses return their own.
        ``init_params`` fills every ``_Params`` module found under it."""
        return Block(self.cfg, device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Fill every parameter with the JAX package's init distributions,
        drawn from ``generator`` on the parameters' device. The numbers are
        not JAX's; parity tests carry JAX's params over with
        ``repro_torch.convert.params_from_jax`` instead."""
        for name, (init, _) in self.TOP_PARAMS.items():
            if getattr(self, name) is not None:
                cm.init_param(getattr(self, name), init, generator)
        for mod in self.modules():
            if isinstance(mod, _Params):
                for name, init in mod.inits.items():
                    cm.init_param(getattr(mod, name), init, generator)

    # -------------------------------------------------------------- specs --
    # Build the model on device="meta" to read its specs without
    # allocating it: build_model(cfg, device="meta").param_specs()
    def named_param_specs(self) -> Dict[str, cm.ParamSpec]:
        """One spec per ``state_dict`` name, a layer's leaves without the
        ``layers`` dim: the view that places the port's per-layer
        parameters."""
        out = {}
        for name, p in self.named_parameters():
            owner, _, leaf = name.rpartition(".")
            mod = self.get_submodule(owner)
            init, axes = ((mod.inits[leaf], mod.axes[leaf])
                          if isinstance(mod, _Params)
                          else self.TOP_PARAMS[leaf])
            out[name] = cm.ParamSpec(tuple(p.shape), p.dtype, init, axes)
        return out

    def param_specs(self) -> cm.ParamTree:
        """JAX's spec tree, its names and layout: the layer leaves (and
        encdec's encoder leaves) stacked (L, ...) with a leading
        ``layers`` axis, by the mapping of ``convert.params_to_numpy``."""
        return restack(self.cfg, self.named_param_specs(), _stack)

    def layer_specs(self) -> cm.ParamTree:
        return self.param_specs()["layers"]

    def n_params(self) -> int:
        return cm.count_params(self.param_specs())

    def n_active_params(self) -> int:
        return self.n_params()

    def cache_len(self, cell: ShapeCell) -> int:
        w = self.cfg.sliding_window
        return min(cell.seq_len, w) if w else cell.seq_len

    def cache_specs(self, B: int, S_max: int) -> "DecodeCache":
        cfg = self.cfg
        shp = (cfg.n_layers, B, S_max, cfg.n_kv_heads, cfg.hdim)
        return DecodeCache(k=cm.shape_struct(shp, cfg.tdtype),
                           v=cm.shape_struct(shp, cfg.tdtype),
                           kpos=cm.shape_struct((S_max,), torch.int32))

    def cache_axes(self) -> "DecodeCache":
        ax = ("layers", "batch", "cache_seq", "kv_heads", None)
        return DecodeCache(k=ax, v=ax, kpos=(None,))

    def input_specs(self, cell: ShapeCell) -> Dict[str, object]:
        B, S = cell.global_batch, cell.seq_len
        if cell.kind in ("train", "prefill"):
            return {"tokens": cm.shape_struct((B, S), torch.int32)}
        return {"tokens": cm.shape_struct((B, 1), torch.int32),
                "pos": cm.shape_struct((), torch.int32),
                "cache": self.cache_specs(B, self.cache_len(cell))}

    def input_axes(self, cell: ShapeCell) -> Dict[str, object]:
        if cell.kind in ("train", "prefill"):
            return {"tokens": ("batch", "seq")}
        return {"tokens": ("batch", None), "pos": (),
                "cache": self.cache_axes()}

    def model_flops(self, cell: ShapeCell) -> float:
        """MODEL_FLOPS = 6·N·D (train), 2·N·D (prefill), 2·N a decoded
        token, N the active params."""
        N = self.n_active_params()
        if cell.kind == "train":
            return 6.0 * N * cell.global_batch * cell.seq_len
        if cell.kind == "prefill":
            return 2.0 * N * cell.global_batch * cell.seq_len
        return 2.0 * N * cell.global_batch

    # ------------------------------------------------------------ forward --
    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.embed)

    def layer_body(self, p: Block, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        q, k, v = project_qkv(cfg, p.attn, apply_norm(cfg, p.ln1, x),
                              positions)
        o = causal_attention(cfg, q, k, v, positions, self.attn_impl)
        x = x + attn_out(p.attn, o)
        return x + self.ffn(p, apply_norm(cfg, p.ln2, x))

    def ffn(self, p: nn.Module, h: torch.Tensor) -> torch.Tensor:
        """The layer's feed-forward block on its normed input; the moe
        family overrides it."""
        return mlp(self.cfg, p.mlp, h)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = apply_norm(cfg, self.final_norm, x)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = x @ head
        if cfg.padded_vocab != cfg.vocab:  # mask the padding tail
            if logits.requires_grad:       # training: out of place
                pad = torch.arange(logits.shape[-1],
                                   device=logits.device) >= cfg.vocab
                logits = logits.masked_fill(pad, -1e9)
            else:
                logits[..., cfg.vocab:] = -1e9
        return logits

    def backbone(self, x: torch.Tensor, positions: torch.Tensor, *,
                 remat: bool = True) -> torch.Tensor:
        return run_layers(self.layer_body, self.layers, x, positions,
                          remat=remat)

    def logits(self, batch: Dict[str, torch.Tensor], *,
               remat: bool = True) -> torch.Tensor:
        """The batch's (B, S) tokens -> (B, S, padded vocab) logits, with
        gradients when grad mode is on; the encdec and vlm families
        override it to read their frames or patches."""
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        x = self.backbone(self.embed_tokens(tokens), positions, remat=remat)
        return self.unembed(x)

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.logits(batch, remat=False)

    def loss(self, batch: Dict[str, torch.Tensor], *, remat: bool = True
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross entropy, as JAX ``TransformerLM.loss``: targets
        are the tokens rolled by -1, the last position masked. The loss
        reads the logits of the tokens, the last S positions (vlm's patch
        prefix ahead of them takes none, as in JAX ``VlmLM.loss``).
        Returns (loss, {"loss", "tokens"})."""
        tokens = batch["tokens"]
        logits = self.logits(batch, remat=remat)
        logits = logits[:, logits.shape[1] - tokens.shape[1]:]
        targets = torch.roll(tokens, -1, dims=1)
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
        mask[:, -1] = 0.0
        loss, denom = softmax_xent(logits, targets, mask)
        return loss, {"loss": loss, "tokens": denom}

    # ------------------------------------------------------------- decode --
    def init_cache(self, B: int, S_max: int) -> DecodeCache:
        """An empty ring of ``S_max`` slots (kpos -1), as JAX
        ``init_cache``."""
        cfg = self.cfg
        shp = (cfg.n_layers, B, S_max, cfg.n_kv_heads, cfg.hdim)
        dev = self.embed.device
        return DecodeCache(
            k=torch.zeros(shp, dtype=cfg.tdtype, device=dev),
            v=torch.zeros(shp, dtype=cfg.tdtype, device=dev),
            kpos=torch.full((S_max,), -1, dtype=torch.int32, device=dev))

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, DecodeCache]:
        """Run the prompt, return (full logits, filled cache).

        ``cache_len`` reserves headroom for subsequent decode steps; the
        cache layout is a ring keyed by slot = position % cache_len.
        """
        return self.prefill_embedded(self.embed_tokens(batch["tokens"]),
                                     cache_len)

    def prefill_embedded(self, x: torch.Tensor, cache_len: Optional[int]
                         ) -> Tuple[torch.Tensor, DecodeCache]:
        """``prefill`` from the embedded inputs x (B, S, d) at positions
        0..S-1 (the vlm family prepends its patches). Attention is JAX's
        direct ``attention_chunked`` call (``cm.chunked_call``)."""
        cfg = self.cfg
        S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        ks: List[torch.Tensor] = []
        vs: List[torch.Tensor] = []
        for p in self.layers:
            q, k, v = project_qkv(cfg, p.attn, apply_norm(cfg, p.ln1, x),
                                  positions)
            o = cm.chunked_call(self.attn_impl, q, k, v, causal=True,
                                window=cfg.sliding_window, qpos=positions,
                                kpos=positions)
            x = x + attn_out(p.attn, o)
            x = x + self.ffn(p, apply_norm(cfg, p.ln2, x))
            ks.append(k)
            vs.append(v)
        logits = self.unembed(x)
        k_all, v_all, kpos = ring_layout(torch.stack(ks), torch.stack(vs), S,
                                         cache_len, window=cfg.sliding_window)
        return logits, DecodeCache(k=k_all.contiguous(),
                                   v=v_all.contiguous(), kpos=kpos)

    @torch.no_grad()
    def decode_step(self, cache: DecodeCache, tokens: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, DecodeCache]:
        """One decode step: tokens (B,1) at position ``pos``. Updates
        ``cache`` in place and returns it with the (B,1,V) logits."""
        cfg = self.cfg
        x = self.embed_tokens(tokens)
        cache.kpos[pos % cache.k.shape[2]] = pos
        for i, p in enumerate(self.layers):
            o = decode_attention_raw(
                cfg, p.attn, apply_norm(cfg, p.ln1, x), cache.k[i],
                cache.v[i], pos, cache.kpos, attn_impl=self.attn_impl)
            x = x + attn_out(p.attn, o)
            x = x + self.ffn(p, apply_norm(cfg, p.ln2, x))
        return self.unembed(x), cache
