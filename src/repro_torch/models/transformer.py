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
where the layer reads it, so activations are plain tensors. Every family
runs tensor-parallel over 'model' where ``sharding.tp`` places it
(``self.tp``, the leaves named by ``tp_roles``): attention on the rank's
heads (``tp_attention``), the MLP on its d_ff columns (``tp_mlp``), the
embedding, logits and loss on its vocab rows (``embed_tokens``,
``logit_parts``, ``tp_softmax_xent``), and at decode the KV cache split
over the ranks' slots (``SplitCache``, ``decode_split``). The families'
own blocks (rwkv6's time- and channel-mix, hymba's SSM heads, encdec's
cross-attention) run on the same helpers; the MoE experts run
expert-parallel (``models.moe_ep``). A block the rules keep whole, and
every block on one device, runs the same helpers on ``sharding.tp.WHOLE``,
a group of one rank (``group_of``): each block has one code path.

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
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.convert import restack
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import common as cm
from repro_torch.sharding.tp import group_of

ATTN_IMPLS = ("flash", "ref", "chunked")


# ----------------------------------------------------------------- params --
class _Params(nn.Module):
    """A flat set of named parameters, each tagged with its init style
    ('normal', 'zeros', 'ones', 'embed', 'scaled') and its logical axes,
    as ParamSpec does. ``tp_dims``: its tensor-parallel leaves
    (``sharding.tp.mark``)."""

    tp_dims: Dict[str, Tuple[int, bool]] = {}

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


def _heads(cfg: ArchConfig, p: Attention, t: torch.Tensor, n: int,
           norm: str, positions: torch.Tensor, rope: bool) -> torch.Tensor:
    """A projection (B, S, n * hd) -> (B, S, n, hd) heads, with the qk-norm
    ``norm`` ("q_norm"/"k_norm", where p has it; None: v) and RoPE."""
    B, S, _ = t.shape
    t = t.reshape(B, S, n, cfg.hdim)
    if norm is not None and norm in p.inits:
        t = cm.rms_norm(t, getattr(p, norm))
    if norm is not None and rope:
        t = cm.apply_rope(t, positions, cfg.rope_theta)
    return t


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


def _act(cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        gate, up = h.chunk(2, dim=-1)
        return F.silu(gate.float()).to(up.dtype) * up
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(h.float(), approximate="tanh").to(h.dtype)


# ------------------------------------------------------ tensor-parallel --
def tp_on(p: nn.Module) -> bool:
    """Whether module p's leaves run tensor-parallel."""
    return bool(p.tp_dims)


def tp_mlp(cfg: ArchConfig, tp, p: MLP, h: torch.Tensor) -> torch.Tensor:
    """Column-parallel ``wi`` (each rank's gate and up columns paired),
    row-parallel ``wo``, the ranks' products summed."""
    return tp.reduce([_act(cfg, x @ wi) @ wo for x, wi, wo in zip(
        tp.copy(h), tp.pieces(p, "wi"), tp.pieces(p, "wo"))])


def _tp_qkv(cfg: ArchConfig, tp, p: Attention, h: torch.Tensor,
            kv_in: Optional[torch.Tensor] = None
            ) -> Tuple[List[torch.Tensor], ...]:
    """Each rank's columns of the q, k and v projections (and biases);
    k and v of ``kv_in`` where given (cross-attention), else of h."""
    hs = tp.copy(h)
    ks = hs if kv_in is None else tp.copy(kv_in)
    outs = []
    for w, xs in (("wq", hs), ("wk", ks), ("wv", ks)):
        t = [x @ wr for x, wr in zip(xs, tp.pieces(p, w))]
        if "b" + w[1] in p.inits:
            t = [o + b for o, b in zip(t, tp.pieces(p, "b" + w[1]))]
        outs.append(t)
    return tuple(outs)


def kv_index(cfg: ArchConfig, T: int, g: int) -> torch.Tensor:
    """The kv heads that head group g of T reads, one a local kv head: the
    single head of the group's GQA group where its heads lie in one, the
    run of whole GQA groups its heads span where they span whole ones
    (hymba's 25 heads in one group: its 5 kv heads), else one for each
    of its q heads (q head h reads kv head h // (H/G))."""
    H, G = cfg.n_heads, cfg.n_kv_heads
    Hl, group = H // T, H // G
    if group % Hl == 0:
        return torch.tensor([g * Hl // group])
    if Hl % group == 0:
        return torch.arange(g * Hl // group, (g + 1) * Hl // group)
    return torch.arange(g * Hl, (g + 1) * Hl) // group


def tp_out(tp, p: Attention, os: List[torch.Tensor]) -> torch.Tensor:
    """Row-parallel ``wo``: each rank's (B, S, H*hd/M) columns of o times
    its rows, the ranks' products summed."""
    return tp.reduce([o @ wo for o, wo in zip(os, tp.pieces(p, "wo"))])


def tp_attention(cfg: ArchConfig, tp, p: Attention, h: torch.Tensor,
                 positions: torch.Tensor, attend, *, rope: bool = True,
                 kv_in: Optional[torch.Tensor] = None, post=None
                 ) -> Tuple[torch.Tensor, object]:
    """Self-attention of the normed input h (B, S, d), every rank holding
    it, on the ranks' pieces of a tensor-parallel ``Attention``;
    ``attend(q, k, v)`` is the kernel's call. Returns (the output, summed
    over the ranks; (k, v) with every kv head, for the prefill's cache:
    one tensor each that every rank holds, or a list of each rank's kv
    heads where those are its own columns of M > 1 ranks). ``rope=False``: no rotation
    (encdec); ``kv_in``: the keys' and values' input (encdec's
    cross-attention of the encoder states); ``post(j, o)``: applied to
    the head group's output o (B, S, H/T, hd) of the j-th rank run here,
    before the ranks take their columns (hymba's output norm).

    The heads split into T = gcd(H, M) groups of H/T, group g on ranks
    g M/T ..; where T < M (the heads do not divide, as JAX's 'heads' ->
    'model' falls back), each group's M/T ranks repeat its attention and
    q is gathered. A rank's kv heads are its own columns where G % M == 0
    and T == M (rank r's q heads read exactly kv heads r G/M ..); else k
    and v are gathered and the rank takes the heads its q heads read
    (``kv_index``), so the kernel pairs heads by index as on one device.
    Each rank then multiplies its H hd/M columns of the group's o by its
    rows of ``wo``."""
    H, G, hd, M = cfg.n_heads, cfg.n_kv_heads, cfg.hdim, tp.M
    T = math.gcd(H, M)
    per, Hl, n = M // T, H // T, H * hd // M
    q, k, v = _tp_qkv(cfg, tp, p, h, kv_in)
    if per == 1:
        qs = [_heads(cfg, p, x, Hl, "q_norm", positions, rope) for x in q]
    else:
        qf = tp.gather(q, -1, False)
        qs = [_heads(cfg, p, qf[..., r // per * Hl * hd:
                                (r // per + 1) * Hl * hd],
                     Hl, "q_norm", positions, rope) for r in tp.ranks]
    if per == 1 and G % M == 0:
        ks = [_heads(cfg, p, x, G // M, "k_norm", positions, rope)
              for x in k]
        vs = [_heads(cfg, p, x, G // M, None, positions, rope) for x in v]
        # one rank (``WHOLE``) holds every kv head, as each rank would
        kv = (ks, vs) if M > 1 else (ks[0], vs[0])
    else:
        kf = _heads(cfg, p, tp.gather(k, -1, False), G, "k_norm",
                    positions, rope)
        vf = _heads(cfg, p, tp.gather(v, -1, False), G, None, positions,
                    rope)
        idx = [kv_index(cfg, T, r // per).to(h.device) for r in tp.ranks]
        ks = [kf.index_select(2, i) for i in idx]
        vs = [vf.index_select(2, i) for i in idx]
        kv = (kf, vf)
    os = []
    for j, (r, a, b, c) in enumerate(zip(tp.ranks, qs, ks, vs)):
        o = attend(a, b, c)
        if post is not None:
            o = post(j, o)
        os.append(o.flatten(2)[..., r % per * n:(r % per + 1) * n])
    return tp_out(tp, p, os), kv


def tp_out_whole(cfg: ArchConfig, tp, p: Attention,
                 o: torch.Tensor) -> torch.Tensor:
    """Row-parallel ``wo`` of o (B, S, H, hd) with every head, which every
    rank holds (a decode step's merged attention): each rank's H hd/M
    columns times its rows, summed."""
    B, S = o.shape[:2]
    n = cfg.n_heads * cfg.hdim // tp.M
    o = o.reshape(B, S, -1)
    return tp_out(tp, p, [o[..., r * n:(r + 1) * n] for r in tp.ranks])


def head_group(tp, H: int) -> Tuple[int, int]:
    """(ranks a head group, heads a group): T = gcd(H, M) groups of H/T
    heads, group g on ranks g M/T .. (``tp_attention``'s split)."""
    T = math.gcd(H, tp.M)
    return tp.M // T, H // T


def tp_cols(tp, p: nn.Module, leaf: str, x: torch.Tensor,
            width: int) -> List[torch.Tensor]:
    """Each rank's head group's columns of x @ p.leaf, a column-parallel
    leaf of heads ``width`` columns each: the rank's own columns where a
    group is one rank, else every rank's columns gathered and the
    group's taken (as ``tp_attention`` gathers q)."""
    cols = [xr @ w for xr, w in zip(tp.copy(x), tp.pieces(p, leaf))]
    per, Hl = head_group(tp, cols[0].shape[-1] * tp.M // width)
    if per == 1:
        return cols
    full = tp.gather(cols, -1, False)
    n = Hl * width
    return [full[..., r // per * n:(r // per + 1) * n] for r in tp.ranks]


def tp_vec(tp, p: nn.Module, leaf: str, H: int) -> List[torch.Tensor]:
    """Each rank's head group's piece of a per-head leaf (its first dim
    H heads, or H heads' columns): its piece where the leaf is
    tensor-parallel and a group is one rank, else the whole leaf (its
    pieces gathered) sliced to the group."""
    per, Hl = head_group(tp, H)
    if leaf in getattr(p, "tp_dims", {}) and tp.M > 1:
        pieces = tp.pieces(p, leaf)
        if per == 1:
            return pieces
        full = tp.gather(pieces, 0, False)
    else:
        full = getattr(p, leaf)
    n = full.shape[0] // H * Hl
    return [full[r // per * n:(r // per + 1) * n] for r in tp.ranks]


def rank_cols(tp, ys: List[torch.Tensor], H: int) -> List[torch.Tensor]:
    """From each rank's head group's (..., H/T * w) output, the rank's
    own (..., H w / M) columns (the row-parallel product's input)."""
    per, _ = head_group(tp, H)
    if per == 1:
        return ys
    n = ys[0].shape[-1] // per
    return [y[..., r % per * n:(r % per + 1) * n]
            for r, y in zip(tp.ranks, ys)]


def tp_qkv_whole(cfg: ArchConfig, tp, p: Attention, h: torch.Tensor,
                 positions: torch.Tensor, *, rope: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v with every head, each rank's columns gathered (a decode
    step's few rows)."""
    q, k, v = (tp.gather(t, -1, True) for t in _tp_qkv(cfg, tp, p, h))
    return (_heads(cfg, p, q, cfg.n_heads, "q_norm", positions, rope),
            _heads(cfg, p, k, cfg.n_kv_heads, "k_norm", positions, rope),
            _heads(cfg, p, v, cfg.n_kv_heads, None, positions, rope))


def attention_roles(name: str, p: Attention
                    ) -> Dict[str, Tuple[int, bool, str]]:
    """An attention's roles, one group: the projections (and biases)
    column-parallel, ``wo`` row-parallel."""
    out = {f"{name}.{leaf}": (1 if leaf[0] == "w" else 0, False, name)
           for leaf in p.inits if leaf[0] in "wb" and leaf != "wo"}
    out[f"{name}.wo"] = (0, False, name)
    return out


def mlp_roles(cfg: ArchConfig, name: str
              ) -> Dict[str, Tuple[int, bool, str]]:
    """An MLP's roles, one group: ``wi`` column-parallel (SwiGLU's gate
    and up halves paired), ``wo`` row-parallel."""
    return {f"{name}.wi": (1, cfg.act == "swiglu", name),
            f"{name}.wo": (0, False, name)}


def tp_softmax_xent(tp, parts: List[torch.Tensor], targets: torch.Tensor,
                    mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``softmax_xent`` over logits split by vocab columns, each rank
    holding its columns (``parts``): the detached max over the ranks, the
    sum of the ranks' exp-sums, the true logit from the rank that holds
    its column."""
    Vl = parts[0].shape[-1]
    lf = [x.float() for x in parts]
    m = tp.max([x.amax(dim=-1, keepdim=True).detach() for x in lf])
    lse = torch.log(tp.reduce([torch.exp(x - m).sum(dim=-1) for x in lf])
                    ) + m[..., 0]
    t = targets.long()
    trues = []
    for r, x in zip(tp.ranks, lf):
        local = t - r * Vl
        mine = (local >= 0) & (local < Vl)
        got = x.gather(-1, local.clamp(0, Vl - 1)[..., None])[..., 0]
        trues.append(torch.where(mine, got, torch.zeros((), dtype=x.dtype,
                                                        device=x.device)))
    nll = (lse - tp.reduce(trues)) * mask
    denom = mask.sum().clamp_min(1.0)
    return nll.sum() / denom, denom


def tp_argmax(tp, parts: List[torch.Tensor]) -> torch.Tensor:
    """The greedy token of logits split by vocab columns: each rank's
    best, then the best over the ranks, a tie to the lowest index (as
    ``torch.argmax`` over the whole row)."""
    Vl = parts[0].shape[-1]
    vals, idxs = [], []
    for r, x in zip(tp.ranks, parts):
        val, idx = x.float().max(dim=-1, keepdim=True)
        vals.append(val)
        idxs.append(idx + r * Vl)
    val = tp.gather(vals, -1, True)
    idx = tp.gather(idxs, -1, True)
    return idx.gather(-1, val.argmax(dim=-1, keepdim=True))[..., 0]


def tp_decode_attention(tp, q: torch.Tensor, ks: List[torch.Tensor],
                        vs: List[torch.Tensor], kpos: List[torch.Tensor],
                        qpos: torch.Tensor, window: int,
                        attn_impl: str = "flash", *,
                        causal: bool = True) -> torch.Tensor:
    """One decode step of q (B, 1, H, hd), every head, against a cache
    split over the ranks' slots: each rank's packed partials over its
    slots, exchanged ((2 + hd) f32 a head), merged in rank order. The
    kernel's two steps for ``attn_impl`` "flash", else their plain
    versions. ``causal=False``: encdec's cross-attention."""
    from repro_torch.kernels import flash_attention as fa
    partials, merge = ((fa.flash_decode_partials, fa.flash_decode_merge)
                       if attn_impl == "flash" else
                       (fa.flash_decode_partials_ref,
                        fa.flash_decode_merge_ref))
    B, _, H, hd = q.shape
    parts = [partials(q, k, v, causal=causal, window=window, qpos=qpos,
                      kpos=kp)[None] for k, v, kp in zip(ks, vs, kpos)]
    part = tp.gather(parts, 0, True).contiguous()
    return merge(part, q.dtype).reshape(B, 1, H, hd)


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
    C = ring_slots(cache_len, S, window)
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


def layout_cache(tp, kvs: List[Tuple[object, object]], S: int,
                 cache_len: Optional[int], window: int, split: bool
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                            torch.Tensor]:
    """Each layer's (k, v) of a prompt (tensors every rank holds, or
    lists of each rank's kv heads, as ``tp_attention`` gives them), laid
    out as the ring of ``ring_layout``: (ks, vs, kpos of the whole ring).
    ``split``: one (L, B, C/M, G, hd) k and v a rank, its slots (from a
    list of the ranks' kv heads, an exchange of heads for slots); else
    one whole k and v with every kv head."""
    lists = isinstance(kvs[0][0], list)
    ks, vs, kpos = [], [], None
    for j in range(len(kvs[0][0]) if lists else 1):
        kj = torch.stack([kv[0][j] if lists else kv[0] for kv in kvs])
        vj = torch.stack([kv[1][j] if lists else kv[1] for kv in kvs])
        kj, vj, kpos = ring_layout(kj, vj, S, cache_len, window=window)
        ks.append(kj)
        vs.append(vj)
    if not split:
        k = ks[0] if len(ks) == 1 else tp.gather(ks, 3, True)
        v = vs[0] if len(vs) == 1 else tp.gather(vs, 3, True)
        return [k.contiguous()], [v.contiguous()], kpos
    if lists:
        ks, vs = tp.to_slots(ks, 3, 2), tp.to_slots(vs, 3, 2)
    else:
        ks, vs = tp.slice(ks[0], 2), tp.slice(vs[0], 2)
    return ([k.contiguous() for k in ks], [v.contiguous() for v in vs],
            kpos)


def ring_slots(cache_len: Optional[int], S: int, window: int) -> int:
    """The slots of ``ring_layout``'s ring for a prompt of S."""
    C = cache_len or (min(S, window) if window else S)
    if window and S >= window:
        C = min(C, window)
    return C


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


@dataclasses.dataclass
class SplitCache:
    """A family's cache as the 'model' ranks hold it under tensor
    parallelism: ``parts``, one cache of the family's type a rank this
    process runs. The KV ring splits over the ranks' slots (JAX's
    ``cache_seq`` -> 'model'): rank r holds slots r C .. (r + 1) C - 1 of
    the S_max-slot ring, C = S_max / M, every kv head (``slots`` =
    S_max); ``slots`` 0: each part holds the whole ring (it does not
    divide, or the family has none). A recurrent state holds the rank's
    heads."""

    parts: List[object]
    slots: int               # S_max, or 0: not split


class TransformerLM(nn.Module):
    """Dense decoder-only LM. Parameters are created uninitialised on
    ``device``; fill them with ``init_params`` or ``load_state_dict``."""

    #: the tensor-parallel group (``sharding.tp``), None: not placed so
    tp = None
    #: the model's own tensor-parallel leaves (embed, lm_head)
    tp_dims: Dict[str, Tuple[int, bool]] = {}

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

    def tp_roles(self) -> Dict[str, Tuple[int, bool, str]]:
        """The leaves that may run tensor-parallel over 'model'
        (``sharding.tp``): name -> (dim split, paired, group). The
        vocab's and each layer's (``block_roles``)."""
        out = {"embed": (0, False, "vocab")}
        if not self.cfg.tie_embeddings:
            out["lm_head"] = (1, False, "vocab")
        for i, blk in enumerate(self.layers):
            out.update(self.block_roles(f"layers.{i}", blk))
        return out

    def block_roles(self, name: str, blk: nn.Module
                    ) -> Dict[str, Tuple[int, bool, str]]:
        """One layer's roles: the attention and the MLP; the families
        with other blocks override it."""
        return {**attention_roles(f"{name}.attn", blk.attn),
                **mlp_roles(self.cfg, f"{name}.mlp")}

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

    def state_module(self) -> Optional[nn.Module]:
        """The module whose tensor parallelism splits the cache's
        ``heads`` dim (a recurrent state's), None where it has none."""
        return None

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
        tp = self.tp
        if tp is None or "embed" not in self.tp_dims:
            return F.embedding(tokens, self.embed)
        # vocab-parallel: each rank looks up the tokens in its rows, zero
        # elsewhere, and the ranks' lookups are summed
        outs = []
        for r, e in zip(tp.ranks, tp.pieces(self, "embed")):
            Vl = e.shape[0]
            local = tokens.long() - r * Vl
            mine = ((local >= 0) & (local < Vl))[..., None]
            y = F.embedding(local.clamp(0, Vl - 1), e)
            outs.append(torch.where(mine, y, torch.zeros(
                (), dtype=y.dtype, device=y.device)))
        return tp.reduce(outs)

    def attention(self, p: Attention, h: torch.Tensor,
                  positions: torch.Tensor, attend, *, rope: bool = True
                  ) -> Tuple[torch.Tensor, object]:
        """The attention block of the normed input h: (output, k/v as
        the cache takes them). ``attend(q, k, v)`` is the attention
        call."""
        return tp_attention(self.cfg, group_of(self, p), p, h, positions,
                            attend, rope=rope)

    def layer_body(self, p: Block, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        a, _ = self.attention(
            p.attn, apply_norm(cfg, p.ln1, x), positions,
            lambda q, k, v: causal_attention(cfg, q, k, v, positions,
                                             self.attn_impl))
        x = x + a
        return x + self.ffn(p, apply_norm(cfg, p.ln2, x))

    def ffn(self, p: nn.Module, h: torch.Tensor) -> torch.Tensor:
        """The layer's feed-forward block on its normed input; the moe
        family overrides it."""
        return tp_mlp(self.cfg, group_of(self, p.mlp), p.mlp, h)

    def vocab_tp(self) -> bool:
        return self.tp is not None and "embed" in self.tp_dims

    def logit_parts(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Vocab-parallel logits: each rank's columns, the padding tail
        masked by global column index."""
        cfg, tp = self.cfg, self.tp
        x = apply_norm(cfg, self.final_norm, x)
        heads = ([e.T for e in tp.pieces(self, "embed")]
                 if cfg.tie_embeddings else tp.pieces(self, "lm_head"))
        parts = []
        for r, xr, head in zip(tp.ranks, tp.copy(x), heads):
            logits = xr @ head
            Vl = logits.shape[-1]
            if cfg.padded_vocab != cfg.vocab:
                pad = torch.arange(r * Vl, (r + 1) * Vl,
                                   device=logits.device) >= cfg.vocab
                logits = logits.masked_fill(pad, -1e9)
            parts.append(logits)
        return parts

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if self.vocab_tp():
            return self.tp.gather(self.logit_parts(x), -1, True)
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

    def hidden(self, batch: Dict[str, torch.Tensor], *,
               remat: bool = True) -> torch.Tensor:
        """The last layer's output (B, S', d) ahead of the final norm;
        the encdec and vlm families override it to read their frames or
        patches."""
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        return self.backbone(self.embed_tokens(tokens), positions,
                             remat=remat)

    def logits(self, batch: Dict[str, torch.Tensor], *,
               remat: bool = True) -> torch.Tensor:
        """The batch's (B, S) tokens -> (B, S', padded vocab) logits, with
        gradients when grad mode is on."""
        return self.unembed(self.hidden(batch, remat=remat))

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
        targets = torch.roll(tokens, -1, dims=1)
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
        mask[:, -1] = 0.0
        if self.vocab_tp():
            x = self.hidden(batch, remat=remat)
            x = x[:, x.shape[1] - tokens.shape[1]:]
            loss, denom = tp_softmax_xent(self.tp, self.logit_parts(x),
                                          targets, mask)
            return loss, {"loss": loss, "tokens": denom}
        logits = self.logits(batch, remat=remat)
        logits = logits[:, logits.shape[1] - tokens.shape[1]:]
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

    def join(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """Whole logits from a step's parts: the ranks' vocab columns
        gathered, or the one whole tensor."""
        return (self.tp.gather(parts, -1, True) if self.vocab_tp()
                else parts[0])

    @torch.no_grad()
    def prefill(self, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, object]:
        """Run the prompt, return (full logits, filled cache).

        ``cache_len`` reserves headroom for subsequent decode steps; the
        cache layout is a ring keyed by slot = position % cache_len.
        """
        parts, cache = self.prefill_parts(batch, cache_len)
        return self.join(parts), cache

    @torch.no_grad()
    def prefill_parts(self, batch: Dict[str, torch.Tensor],
                      cache_len: Optional[int] = None
                      ) -> Tuple[List[torch.Tensor], object]:
        """``prefill`` with the logits as their parts (``prefill_split``);
        each family reads its own inputs."""
        return self.prefill_split(self.embed_tokens(batch["tokens"]),
                                  cache_len)

    @torch.no_grad()
    def prefill_split(self, x: torch.Tensor, cache_len: Optional[int]
                      ) -> Tuple[List[torch.Tensor], object]:
        """Every layer over the embedded prompt x (B, S, d): (the logits'
        parts, ``logit_parts`` under vocab parallelism, else [the whole
        logits]; the cache). Attention is JAX's direct
        ``attention_chunked`` call (``cm.chunked_call``). On one device
        the cache is a ``DecodeCache``; under tensor parallelism a
        ``SplitCache``, split over the ranks' slots where the ring
        divides by M, else one whole ring (``layout_cache``)."""
        cfg, tp = self.cfg, self.tp
        S = x.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        kvs = []
        for p in self.layers:
            a, kv = self.attention(
                p.attn, apply_norm(cfg, p.ln1, x), positions,
                lambda q, k, v: cm.chunked_call(
                    self.attn_impl, q, k, v, causal=True,
                    window=cfg.sliding_window, qpos=positions,
                    kpos=positions))
            x = x + a
            x = x + self.ffn(p, apply_norm(cfg, p.ln2, x))
            kvs.append(kv)
        parts = self.final_parts(x)
        C = ring_slots(cache_len, S, cfg.sliding_window)
        split = tp is not None and not C % tp.M
        ks, vs, kpos = layout_cache(tp, kvs, S, cache_len,
                                    cfg.sliding_window, split)
        if tp is None:
            return parts, DecodeCache(k=ks[0], v=vs[0], kpos=kpos)
        if not split:
            return parts, SplitCache([DecodeCache(k=ks[0], v=vs[0],
                                                  kpos=kpos)], 0)
        return parts, SplitCache(
            [DecodeCache(k=k, v=v, kpos=kp.contiguous())
             for k, v, kp in zip(ks, vs, tp.slice(kpos, 0))], C)

    def final_parts(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The logits of the last layer's output x: ``logit_parts``
        under vocab parallelism, else [the whole logits]."""
        return (self.logit_parts(x) if self.vocab_tp()
                else [self.unembed(x)])

    @torch.no_grad()
    def decode_split(self, cache, tokens: torch.Tensor, pos: int
                     ) -> Tuple[List[torch.Tensor], object]:
        """Every layer of one decode step: (the logits' parts, as
        ``prefill_split``'s; the cache, updated in place). Under tensor
        parallelism q, k, v come with every head (the ranks' columns
        gathered), the new k/v are written by the rank that holds slot
        pos % S_max, attention over each rank's slots is merged across
        the ranks (``tp_decode_attention``), and the output, MLP and
        logits are the ranks' pieces."""
        cfg = self.cfg
        x = self.embed_tokens(tokens)
        qpos = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        slot = self.mark_slot(cache, pos)
        for i, p in enumerate(self.layers):
            x = x + self.decode_attention(p.attn, apply_norm(cfg, p.ln1, x),
                                          cache, i, slot, qpos)
            x = x + self.ffn(p, apply_norm(cfg, p.ln2, x))
        return self.final_parts(x), cache

    def mark_slot(self, cache, pos: int) -> Tuple[int, List[int]]:
        """Record position ``pos`` in the ring's slot pos % S_max: (the
        slot, within the rank's run where the ring is split; the indices
        of the parts that hold it, [] for a whole ring)."""
        if isinstance(cache, SplitCache) and cache.slots:
            C = cache.slots // self.tp.M
            w = pos % cache.slots
            mine = [j for j, r in enumerate(self.tp.ranks) if r == w // C]
            for j in mine:
                cache.parts[j].kpos[w % C] = pos
            return w % C, mine
        whole = cache.parts[0] if isinstance(cache, SplitCache) else cache
        w = pos % whole.k.shape[2]
        whole.kpos[w] = pos
        if isinstance(cache, SplitCache):
            for c in cache.parts[1:]:
                c.kpos[w] = pos
            return w, list(range(len(cache.parts)))
        return w, []

    def decode_attention(self, p: Attention, h: torch.Tensor, cache,
                         i: int, slot: Tuple[int, List[int]],
                         qpos: torch.Tensor, *, rope: bool = True,
                         post=None) -> torch.Tensor:
        """Layer i's self-attention of one decode step's normed input h,
        through ``wo``, its k/v written into the ring at ``slot``
        (``mark_slot``'s); ``post(o)`` is applied to the heads' output
        (B, 1, H, hd), every head, before ``wo`` (hymba's norm)."""
        cfg, tp, g = self.cfg, self.tp, group_of(self, p)
        q, k, v = tp_qkv_whole(cfg, g, p, h, qpos, rope=rope)
        w, mine = slot
        if isinstance(cache, SplitCache):
            for j in mine:
                c = cache.parts[j]
                c.k[i][:, w] = k[:, 0].to(c.k.dtype)
                c.v[i][:, w] = v[:, 0].to(c.v.dtype)
        else:
            cache.k[i][:, w] = k[:, 0].to(cache.k.dtype)
            cache.v[i][:, w] = v[:, 0].to(cache.v.dtype)
        if isinstance(cache, SplitCache) and cache.slots:
            o = tp_decode_attention(
                tp, q, [c.k[i] for c in cache.parts],
                [c.v[i] for c in cache.parts],
                [c.kpos for c in cache.parts], qpos, cfg.sliding_window,
                self.attn_impl)
        else:
            c = cache.parts[0] if isinstance(cache, SplitCache) else cache
            o = cm.make_attention(self.attn_impl)(
                q, c.k[i], c.v[i], causal=True, window=cfg.sliding_window,
                qpos=qpos, kpos=c.kpos)
        if post is not None:
            o = post(o)
        return tp_out_whole(cfg, g, p, o)

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, object]:
        """One decode step: tokens (B,1) at position ``pos``. Updates
        ``cache`` in place and returns it with the (B,1,V) logits
        (``decode_split`` runs the layers)."""
        parts, cache = self.decode_split(cache, tokens, pos)
        return self.join(parts), cache
