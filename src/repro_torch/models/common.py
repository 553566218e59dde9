"""Shared model machinery: param specs with logical axes, norms, RoPE, and
attention implementations (reference, chunked online-softmax, banded
sliding-window), as plain torch.

Counterpart of ``repro/models/common.py``. Layouts are the JAX package's:
q (B, Sq, H, D), k/v (B, Sk, G, D) with H % G == 0, positions (S,).

Logical axes (mapped to mesh axes by ``repro_torch.sharding``) are JAX's:
batch, seq, embed, qkv, heads, kv_heads, mlp, vocab, experts, expert_in,
expert_mlp, state, frontend, vis, and ``layers`` for the leading dim of a
stacked layer leaf. A spec tree is a nested dict of ``ParamSpec``; where
JAX has a ``ShapeDtypeStruct``, the port has a tensor on the ``meta``
device, which holds a shape and a dtype and no storage.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import flags
from repro_torch.device import DeviceLike, resolve_device


# ------------------------------------------------------------------ specs --
@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declares one parameter: shape, dtype, init style, logical axes."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str              # 'normal', 'zeros', 'ones', 'embed', 'scaled'
    axes: Tuple[Optional[str], ...]
    init_scale: float = 1.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")

    def stacked(self, L: int) -> "ParamSpec":
        """The spec of L of these stacked on a leading ``layers`` dim."""
        return dataclasses.replace(self, shape=(L,) + tuple(self.shape),
                                   axes=("layers",) + tuple(self.axes))


ParamTree = Dict[str, Any]   # nested dict of ParamSpec / tensors


def _is_node(x: Any) -> bool:
    """A dict or a dataclass record (a cache) is a tree node; a ParamSpec,
    a tensor or an axes tuple is a leaf."""
    return isinstance(x, dict) or (dataclasses.is_dataclass(x)
                                   and not isinstance(x, (type, ParamSpec)))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping dicts and dataclass records."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_node(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def shape_struct(shape: Tuple[int, ...], dtype: torch.dtype
                 ) -> torch.Tensor:
    """JAX's ShapeDtypeStruct: a tensor on ``meta`` (no allocation)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def shape_tree(specs: ParamTree) -> ParamTree:
    """Meta tensors of each spec's shape and dtype (dry-run: no
    allocation)."""
    return tree_map(lambda s: shape_struct(s.shape, s.dtype), specs)


def axes_tree(specs: ParamTree) -> ParamTree:
    return tree_map(lambda s: s.axes, specs)


def count_params(specs: ParamTree) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_leaves(specs))


# a leaf above this many elements draws its f32 noise one slice along dim
# 0 at a time: arctic-480b's expert leaf wi (128, 7168, 9728) would need a
# 35.7 GB temporary beside 55.6 GB of weights. Every leaf of the dense and
# recurrent families is below it, so their draws are unchanged
NOISE_SLICE_ELEMS = 1 << 30


@torch.no_grad()
def init_param(p: torch.Tensor, init: str, generator: torch.Generator,
               scale: float = 1.0) -> None:
    """Fill ``p`` with the distribution of JAX ``init_param`` (f32 normal,
    scaled, then cast), drawn from ``generator`` on p's device."""
    if init == "zeros":
        p.zero_()
        return
    if init == "ones":
        p.fill_(1.0)
        return
    if init == "embed":       # 1/sqrt(d) keeps tied-embedding logits O(1)
        std = scale / math.sqrt(p.shape[-1])
    elif init == "scaled":    # fan-in scaled
        std = scale / math.sqrt(p.shape[-2] if p.dim() >= 2
                                else p.shape[-1])
    else:                     # 'normal'
        std = 0.02 * scale
    if p.numel() <= NOISE_SLICE_ELEMS:
        noise = torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32)
        p.copy_(noise.mul_(std))
        return
    for part in p:
        part.copy_(torch.randn(part.shape, generator=generator,
                               device=p.device,
                               dtype=torch.float32).mul_(std))


def init_tree(specs: ParamTree, generator: torch.Generator, *,
              device: DeviceLike = None) -> ParamTree:
    """Materialize every spec on ``device`` (the card unless named), one
    leaf after another from ``generator``."""
    dev = resolve_device(device)

    def one(s: ParamSpec) -> torch.Tensor:
        t = torch.empty(s.shape, dtype=s.dtype, device=dev)
        init_param(t, s.init, generator, s.init_scale)
        return t
    return tree_map(one, specs)


# ------------------------------------------------------------------- norms --
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


# -------------------------------------------------------------------- RoPE --
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """float64 numpy, as the JAX package computes it; callers cast to f32."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    # one host->device copy per (head_dim, theta, device): a copy from
    # pageable memory synchronises the stream, so never make it per call
    return torch.from_numpy(rope_freqs(head_dim, theta).astype(np.float32)
                            ).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S). Split halves,
    not interleaved."""
    freqs = _rope_freqs_on(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs            # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- attention --
def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' accumulation type: f32, or f64 for f64 inputs
    (so that ``gradcheck`` can run them in f64)."""
    return torch.promote_types(x.dtype, torch.float32)


def _mask_bias(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """Additive mask bias (0 or -inf), f32 (Sq, Sk). kpos < 0 marks invalid
    (unwritten cache) slots."""
    ok = (kpos[None, :] >= 0).expand(qpos.shape[0], kpos.shape[0])
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        ok = ok & (kpos[None, :] > qpos[:, None] - window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, zero - math.inf)


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  qpos: Optional[torch.Tensor] = None,
                  kpos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference attention. q: (B,Sq,H,D); k,v: (B,Sk,G,D) with H % G == 0.

    qpos/kpos are absolute token positions (default arange); kpos == -1
    marks invalid cache slots (masked out).
    """
    B, Sq, H, D = q.shape
    G = k.shape[2]
    qpos = _arange(Sq, q) if qpos is None else qpos.long()
    kpos = _arange(k.shape[1], q) if kpos is None else kpos.long()
    qg = q.reshape(B, Sq, G, H // G, D)
    acc = acc_dtype(q)
    scores = torch.einsum("bsgqd,btgd->bgqst", qg.to(acc), k.to(acc))
    scores = scores * (1.0 / math.sqrt(D))
    scores = scores + _mask_bias(qpos, kpos, causal, window)
    # rows with no valid key (fully masked) must not produce nan
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.where(torch.isfinite(scores),
                    torch.exp(scores - torch.where(torch.isfinite(m), m, 0.0)),
                    0.0)
    probs = e / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bgqst,btgd->bsgqd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, D)


def attention_chunked(q, k, v, *, causal: bool = True, window: int = 0,
                      qpos: Optional[torch.Tensor] = None,
                      kpos: Optional[torch.Tensor] = None,
                      block_k: int = 512) -> torch.Tensor:
    """Online-softmax attention, scanning KV in blocks of ``block_k``.
    Accumulates in v's dtype, as the JAX version does."""
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    qpos = _arange(Sq, q) if qpos is None else qpos.long()
    kpos = _arange(Sk, q) if kpos is None else kpos.long()
    if Sk % block_k:
        pad = block_k - Sk % block_k
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = F.pad(kpos, (0, pad), value=-1)
    n_blocks = k.shape[1] // block_k
    f = acc_dtype(q)
    qg = q.reshape(B, Sq, G, H // G, D).to(f)
    scale = 1.0 / math.sqrt(D)

    m = torch.full((B, G, H // G, Sq), -math.inf, dtype=f, device=q.device)
    l = torch.zeros((B, G, H // G, Sq), dtype=f, device=q.device)
    acc = torch.zeros((B, G, H // G, Sq, D), dtype=v.dtype, device=q.device)
    for i in range(n_blocks):
        blk = slice(i * block_k, (i + 1) * block_k)
        kblk, vblk, kp = k[:, blk], v[:, blk], kpos[blk]
        s = torch.einsum("bsgqd,btgd->bgqst", qg, kblk.to(f)) * scale
        s = s + _mask_bias(qpos, kp, causal, window)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # renormalize previous accumulator (guard -inf - -inf = nan)
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_new))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bgqst,btgd->bgqsd", p.to(v.dtype), vblk)
        acc = acc * alpha[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None].to(acc.dtype)
    # (B,G,Hg,Sq,D) -> (B,Sq,H,D)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return out.to(q.dtype)


def attention_banded(q, k, v, *, window: int,
                     qpos: Optional[torch.Tensor] = None,
                     kpos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sliding-window attention in banded-block form: each q block of
    ``window`` rows attends its own block plus the previous one. q:
    (B,S,H,D); k,v: (B,S,G,D); requires S % window == 0 (self-attention).
    """
    B, S, H, D = q.shape
    G = k.shape[2]
    w = window
    if S % w:
        raise ValueError(f"S={S} must divide by window={w}")
    nb = S // w
    qpos = _arange(S, q) if qpos is None else qpos.long()
    kpos = _arange(S, q) if kpos is None else kpos.long()
    kb = k.reshape(B, nb, w, G, D)
    vb = v.reshape(B, nb, w, G, D)
    kp = kpos.reshape(nb, w)
    outs = []
    for i in range(nb):
        if i == 0:  # the block before the first is empty (kpos -1)
            kcat = torch.cat([torch.zeros_like(kb[:, 0]), kb[:, 0]], dim=1)
            vcat = torch.cat([torch.zeros_like(vb[:, 0]), vb[:, 0]], dim=1)
            kpc = torch.cat([torch.full_like(kp[0], -1), kp[0]])
        else:
            kcat = torch.cat([kb[:, i - 1], kb[:, i]], dim=1)
            vcat = torch.cat([vb[:, i - 1], vb[:, i]], dim=1)
            kpc = torch.cat([kp[i - 1], kp[i]])
        outs.append(attention_ref(q[:, i * w:(i + 1) * w], kcat, vcat,
                                  causal=True, window=w,
                                  qpos=qpos[i * w:(i + 1) * w], kpos=kpc))
    return torch.cat(outs, dim=1)


def attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                    qpos: Optional[torch.Tensor] = None,
                    kpos: Optional[torch.Tensor] = None,
                    self_attention: bool = True,
                    impl: str = "chunked",
                    block_k: Optional[int] = None) -> torch.Tensor:
    """The plain attention the JAX package trains through.

    With ``block_k`` None, the dispatch of JAX
    ``transformer.causal_attention``: banded O(S*w) when a sliding window
    tiles a causal self-attention at least twice and ``REPRO_NO_BANDED``
    is not set, else ``impl``: ``"chunked"`` online softmax with
    ``block_k = min(1024, max(S, 128))`` (JAX's), or ``"ref"``. An int
    ``block_k`` stands for the JAX call sites that call
    ``attention_chunked`` directly (encdec; the moe and vlm prefills):
    no banded path, and ``"chunked"`` at that ``block_k``.
    ``self_attention`` says that qpos and kpos are the same positions."""
    S = k.shape[1]
    w = window
    if (block_k is None and causal and self_attention and w
            and q.shape[1] == S and S % w == 0 and S >= 2 * w
            and not flags.no_banded_attention()):
        return attention_banded(q, k, v, window=w, qpos=qpos, kpos=kpos)
    if impl == "ref":
        return attention_ref(q, k, v, causal=causal, window=w, qpos=qpos,
                             kpos=kpos)
    return attention_chunked(q, k, v, causal=causal, window=w, qpos=qpos,
                             kpos=kpos,
                             block_k=block_k or min(1024, max(S, 128)))


ATTN_IMPLS: Dict[str, Callable] = {
    "ref": attention_ref,
    "chunked": attention_chunked,
}


def chunked_call(impl: str, q, k, v, *, block_k: int = 512,
                 **kw) -> torch.Tensor:
    """A JAX call site that calls ``attention_chunked`` directly, at its
    default ``block_k`` unless it names one: the kernel (``"flash"``),
    whose backward is then ``attention_chunked`` at the same ``block_k``,
    ``attention_chunked`` itself, or ``attention_ref`` (``"ref"``)."""
    if impl == "ref":
        return attention_ref(q, k, v, **kw)
    return make_attention(impl)(q, k, v, block_k=block_k, **kw)


def make_attention(impl: str, **defaults) -> Callable:
    """``"flash"`` routes to the CUDA kernel (its plain version on the CPU);
    ``"ref"`` and ``"chunked"`` are the plain torch implementations."""
    if impl == "flash":
        from repro_torch.kernels import ops as kops
        return partial(kops.flash_attention, **defaults)
    fn = ATTN_IMPLS[impl]
    return partial(fn, **defaults) if defaults else fn
