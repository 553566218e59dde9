"""Flash-attention forward: the hand-written CUDA kernels and their plain
PyTorch versions.

Counterpart of ``repro/kernels/flash_attention.py::flash_attention`` (the
Pallas TPU kernel). The port takes the model layout directly, q (B, Sq, H,
D) and k/v (B, Sk, G, D) with G dividing H; the kernels read kv head
h // (H/G) by index instead of the Pallas wrapper's ``repeat``. Positions:
``qpos`` (Sq,) and ``kpos`` (Sk,) int32, ``kpos == -1`` marks an empty slot.

Three kernels (``csrc/flash_attention.cu``) compute the same function; the
wrapper picks one by dtype and Sq (``choose_variant``):

- ``"tc"``: bf16 with Sq > 1 (prefill), on the tensor cores;
- ``"split"``: Sq == 1 (decode), keys split over ``decode_splits`` blocks
  and merged, f32 arithmetic; ``flash_decode_ref`` is its plain version;
- ``"simt"``: f32 with Sq > 1, f32 on CUDA cores (tensor cores would run
  f32 as TF32).

Training (``kernels.autograd.FlashAttentionFn``, on CUDA bf16 with Sq > 1,
where the forward runs ``"tc"``: ``backward_on_kernel``) runs the tc
kernel's instantiation that also writes each row's log-sum-exp
(``flash_attention_fwd_lse``) and the backward kernels ``attn_bwd_dq`` and
``attn_bwd_dkv`` (``flash_attention_backward``); ``flash_attention_bwd_ref``
is their plain version.

A decode over a cache split among ranks runs the split kernel in two
steps with an exchange between them: ``flash_decode_partials`` (the split
kernel and a merge into one packed partial a row: m, l and the
unnormalised acc, 2 + D f32) and ``flash_decode_merge`` (the merge of the
ranks' partials into o); ``flash_decode_partials_ref`` and
``flash_decode_merge_ref`` are their plain versions.

On a CPU tensor each wrapper runs its plain version. On a CUDA tensor
it launches its kernel or raises. Its output has no ``grad_fn``, so
it refuses inputs that require grad under grad mode, on any device;
``kernels.autograd.FlashAttentionFn`` carries the gradient.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import spans
from repro_torch.kernels import build
from repro_torch.kernels.autograd import refuse_grad
from repro_torch.models.common import acc_dtype

NEG_INF = -1e30
#: the head dims the kernels are instantiated at (every config's, full
#: width and a tensor-parallel rank's: 64, 128 and stablelm-12b's 160)
HEAD_DIMS = (16, 32, 64, 128, 160)
TILE_KEYS = 64               # keys a tile of the tc and split kernels
# split-kernel blocks an SM holds at once (4 warps, one 64-key stage: ~39
# KB of shared memory at D = 128 in bf16): decode_splits fits one wave
DECODE_BLOCKS_PER_SM = 5
VARIANTS = ("simt", "tc", "split")
_VARIANT_CODE = {name: i for i, name in enumerate(VARIANTS)}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# repro_flash_attention_fwd(q, k, v, qpos, kpos, o, lse, B, Sq, Sk, H, G, D,
#     causal, window, scale, dtype, variant, n_split, scratch, device, stream)
# repro_flash_attention_bwd(q, k, v, o, do, lse, qpos, kpos, dq, dk, dv,
#     delta, B, Sq, Sk, H, G, D, causal, window, scale, device, stream)
# repro_flash_decode_partials(q, k, v, qpos, kpos, part, B, Sk, H, G, D,
#     causal, window, scale, dtype, n_split, scratch, device, stream)
# repro_flash_decode_merge(part, o, rows, P, D, dtype, device, stream)
_SIGNATURES = {
    "repro_flash_attention_fwd": (
        ctypes.c_int, [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]),
    "repro_flash_attention_bwd": (
        ctypes.c_int, [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "repro_flash_decode_partials": (
        ctypes.c_int, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
           ctypes.c_int, ctypes.c_void_p]),
    "repro_flash_decode_merge": (
        ctypes.c_int, [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
        + [ctypes.c_void_p])}
#: the launch counts of the two-step decode, beside the variants
STEPS = ("partials", "merge")
_sm_count: Dict[int, int] = {}
_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def _positions(pos: Optional[torch.Tensor], n: int,
               device: torch.device) -> torch.Tensor:
    if pos is None:
        return torch.arange(n, dtype=torch.int32, device=device)
    return pos


def _mask(qp: torch.Tensor, kp: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    ok = (kp[None, :] >= 0).expand(qp.shape[0], kp.shape[0])
    if causal:
        ok = ok & (kp[None, :] <= qp[:, None])
    if window > 0:
        ok = ok & (kp[None, :] > qp[:, None] - window)
    return ok


def _scores(q: torch.Tensor, k: torch.Tensor, ok: torch.Tensor
            ) -> torch.Tensor:
    """(B, G, H/G, Sq, Sk) scores in f32 (f64 for f64 inputs), NEG_INF
    where masked."""
    B, Sq, H, D = q.shape
    G = k.shape[2]
    acc = acc_dtype(q)
    qg = q.to(acc).reshape(B, Sq, G, H // G, D)
    s = torch.einsum("bsgqd,btgd->bgqst", qg, k.to(acc)) * (1.0 / math.sqrt(D))
    return torch.where(ok, s, torch.tensor(NEG_INF, dtype=s.dtype,
                                           device=s.device))


def _finish(acc: torch.Tensor, l: torch.Tensor, q: torch.Tensor
            ) -> torch.Tensor:
    """acc (B, Sq, G, H/G, D) / max(l, 1e-30), l (B, G, H/G, Sq, 1)."""
    B, Sq, H, D = q.shape
    o = acc / l.clamp_min(1e-30).permute(0, 3, 1, 2, 4)
    return o.reshape(B, Sq, H, D).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        qpos: Optional[torch.Tensor] = None,
                        kpos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the kernels: same masks, finite NEG_INF, f32
    accumulation, zero for a row with no valid key, output in q's dtype."""
    Sq, Sk = q.shape[1], k.shape[1]
    ok = _mask(_positions(qpos, Sq, q.device).long(),
               _positions(kpos, Sk, q.device).long(), causal, window)
    s = _scores(q, k, ok)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(ok, p, torch.zeros((), dtype=p.dtype, device=p.device))
    acc = torch.einsum("bgqst,btgd->bsgqd", p, v.to(p.dtype))
    return _finish(acc, p.sum(dim=-1, keepdim=True), q)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, *, causal: bool = True,
                            window: int = 0,
                            qpos: Optional[torch.Tensor] = None,
                            kpos: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of the backward kernels: (dq, dk, dv) of attention at
    its output ``o`` for the upstream gradient ``do``, computed as the
    kernels do it. Each row's log-sum-exp of its valid scores and
    D = rowsum(do * o) in f32 (f64 for f64 inputs); then key tiles of 64:
    P = exp(s - lse) (0 where masked), dV = P^T do, dP = do V^T,
    dS = P (dP - D), dK = scale dS^T q, dq += scale dS K, with P and dS
    rounded to the inputs' dtype before their products, as the kernels'
    bf16 operands are, and every product accumulated in f32 (f64). A row
    with no valid key gets zero gradient. Outputs in the inputs' dtypes."""
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    hpg, acc, wd = H // G, acc_dtype(q), q.dtype
    ok = _mask(_positions(qpos, Sq, q.device).long(),
               _positions(kpos, Sk, q.device).long(), causal, window)
    s = _scores(q, k, ok)                              # (B, G, H/G, Sq, Sk)
    zero = torch.zeros((), dtype=acc, device=q.device)
    m = s.amax(dim=-1, keepdim=True)
    l = torch.where(ok, torch.exp(s - m), zero).sum(dim=-1, keepdim=True)
    lse = torch.where(l > 0, m + torch.log(l), zero + math.inf)

    def group(x):                                      # (B, G, H/G, Sq, D)
        return x.to(acc).reshape(B, Sq, G, hpg, D).permute(0, 2, 3, 1, 4)

    qg, dog = group(q), group(do)
    delta = (dog * group(o)).sum(dim=-1, keepdim=True)
    scale = 1.0 / math.sqrt(D)
    dq = torch.zeros_like(qg)
    dk = torch.zeros((B, Sk, G, D), dtype=acc, device=q.device)
    dv = torch.zeros_like(dk)
    for t0 in range(0, Sk, TILE_KEYS):
        t = slice(t0, t0 + TILE_KEYS)
        kt, vt = k[:, t].to(acc), v[:, t].to(acc)
        p = torch.where(ok[:, t], torch.exp(s[..., t] - lse), zero)
        dv[:, t] = torch.einsum("bgqst,bgqsd->btgd", p.to(wd).to(acc), dog)
        dp = torch.einsum("bgqsd,btgd->bgqst", dog, vt)
        ds = (p * (dp - delta)).to(wd).to(acc)
        dk[:, t] = scale * torch.einsum("bgqst,bgqsd->btgd", ds, qg)
        dq += scale * torch.einsum("bgqst,btgd->bgqsd", ds, kt)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return dq.to(wd), dk.to(k.dtype), dv.to(v.dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     n_split: int, causal: bool = True, window: int = 0,
                     qpos: Optional[torch.Tensor] = None,
                     kpos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the split kernel and its merge, written as they do
    it: the key tiles cut into ``n_split`` contiguous ranges of
    ceil(tiles / n_split) tiles of 64 keys, a partial (m, l, acc) in f32 per
    range (m = NEG_INF, l = 0, acc = 0 where no key is valid), then
    o = sum acc_s e^(m_s - M) / max(sum l_s e^(m_s - M), 1e-30) with
    M = max m_s."""
    if n_split < 1:
        raise ValueError(f"n_split must be >= 1, got {n_split}")
    Sq, Sk = q.shape[1], k.shape[1]
    ok = _mask(_positions(qpos, Sq, q.device).long(),
               _positions(kpos, Sk, q.device).long(), causal, window)
    s = _scores(q, k, ok)
    tiles = -(-Sk // TILE_KEYS)
    per = -(-tiles // n_split) * TILE_KEYS
    ms, ls, accs = [], [], []
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    for i in range(n_split):
        lo, hi = min(Sk, i * per), min(Sk, (i + 1) * per)
        si, oki = s[..., lo:hi], ok[:, lo:hi]
        m = (si.amax(dim=-1, keepdim=True) if hi > lo else
             torch.full(s.shape[:-1] + (1,), NEG_INF, dtype=s.dtype,
                        device=s.device))
        p = torch.where(oki, torch.exp(si - m), zero)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bgqst,btgd->bsgqd", p,
                                 v[:, lo:hi].to(p.dtype)))
    M = torch.stack(ms).amax(dim=0)
    w = [torch.exp(m - M) for m in ms]                 # (B, G, H/G, Sq, 1)
    l = sum(wi * li for wi, li in zip(w, ls))
    acc = sum(wi.permute(0, 3, 1, 2, 4) * ai for wi, ai in zip(w, accs))
    return _finish(acc, l, q)


def flash_decode_partials_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: int = 0,
                              qpos: Optional[torch.Tensor] = None,
                              kpos: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain version of ``flash_decode_partials``: q (B, 1, H, D) against
    k/v (B, Sk, G, D), one packed partial a row b * H + h, (B * H, 2 + D)
    f32: m = the max score over the valid keys (NEG_INF where none),
    l = sum e^(s - m) and acc = sum e^(s - m) v over them."""
    B, Sq, H, D = q.shape
    if Sq != 1:
        raise ValueError(f"decode partials take Sq == 1, got {Sq}")
    ok = _mask(_positions(qpos, Sq, q.device).long(),
               _positions(kpos, k.shape[1], q.device).long(), causal, window)
    s = _scores(q, k, ok)                               # (B, G, H/G, 1, Sk)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros((), dtype=s.dtype,
                                                      device=s.device))
    acc = torch.einsum("bgqst,btgd->bsgqd", p, v.to(p.dtype))
    rows = B * H
    return torch.cat([m.reshape(rows, 1), p.sum(dim=-1).reshape(rows, 1),
                      acc.reshape(rows, D)], dim=1).float()


def flash_decode_merge_ref(part: torch.Tensor,
                           dtype: torch.dtype) -> torch.Tensor:
    """Plain version of ``flash_decode_merge``: part (P, rows, 2 + D) f32,
    P packed partials a row -> o (rows, D) in ``dtype``:
    sum acc_p e^(m_p - M) / max(sum l_p e^(m_p - M), 1e-30), M = max m_p."""
    m, l, acc = part[..., :1], part[..., 1:2], part[..., 2:]
    w = torch.exp(m - m.amax(dim=0, keepdim=True))
    den = (l * w).sum(dim=0).clamp_min(1e-30)
    return ((acc * w).sum(dim=0) / den).to(dtype)


def choose_variant(dtype: torch.dtype, Sq: int) -> str:
    """The kernel a call goes to: ``"split"`` for one query position
    (decode), else ``"tc"`` for bf16 and ``"simt"`` for f32 (f32 on the
    tensor cores would be TF32, outside the f32 tolerance)."""
    if Sq == 1:
        return "split"
    return "tc" if dtype == torch.bfloat16 else "simt"


@functools.lru_cache(maxsize=None)
def decode_splits(B: int, G: int, Sk: int, n_sm: int) -> int:
    """How many key ranges the split kernel cuts Sk into: as many as one
    wave of ``DECODE_BLOCKS_PER_SM`` blocks (B * G * n_split) an SM holds,
    at least one 64-key tile a range, and no empty range. On the card a
    block's latency grows by about one tile's load for each tile it takes
    (PERF.md), so one tile a block is best while the blocks fit. Reads no
    data, so it never synchronises the stream."""
    tiles = -(-Sk // TILE_KEYS)
    want = max(1, min(tiles, DECODE_BLOCKS_PER_SM * n_sm // (B * G)))
    per = -(-tiles // want)
    return -(-tiles // per)


def check_head_dim(D: int) -> None:
    """Raises for a head dim the kernels have no instantiation of; the dry
    run's stand-ins (``kernels.meta``) apply the same rule."""
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")


def _check(q, k, v, qpos, kpos) -> None:
    # get_device(): the decode step calls this on every layer, and building
    # torch.device objects would cost the host more than the kernel's time
    if not (k.get_device() == v.get_device() == q.get_device()
            == qpos.get_device() == kpos.get_device()):
        raise ValueError("q, k, v, qpos and kpos must share one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must all be float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,Sq,H,D), k/v (B,Sk,G,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Sk, G, Dk = k.shape
    if Bk != B or Dk != D or G < 1 or H % G:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    check_head_dim(D)
    if min(B, Sq, Sk) < 1 or B > 65535 or G > 65535:
        raise ValueError(f"unsupported sizes B={B} Sq={Sq} Sk={Sk} G={G}")
    if qpos.shape != (Sq,) or kpos.shape != (Sk,) or \
            qpos.dtype != torch.int32 or kpos.dtype != torch.int32:
        raise ValueError("qpos (Sq,) and kpos (Sk,) must be int32")
    for name, t in (("q", q), ("k", k), ("v", v), ("qpos", qpos),
                    ("kpos", kpos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):  # read as 16-byte vectors
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def backward_on_kernel(q: torch.Tensor) -> bool:
    """Whether training runs the backward kernels: where the forward runs
    the tc kernel (CUDA, bf16, Sq > 1). Elsewhere (the CPU, f32, f64, the
    dry run's meta tensors) ``FlashAttentionFn`` differentiates the
    caller's plain function."""
    return q.device.type == "cuda" and choose_variant(q.dtype,
                                                      q.shape[1]) == "tc"


def _check_variant(variant: str, dtype: torch.dtype, Sq: int) -> None:
    if variant not in _VARIANT_CODE:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if variant == "tc" and dtype != torch.bfloat16:
        raise TypeError(f"the tc kernel takes bfloat16, got {dtype}")
    if variant == "split" and Sq != 1:
        raise ValueError(f"the split kernel takes Sq == 1, got Sq={Sq}")


def _split_scratch(numel: int, device: int, stream: int) -> torch.Tensor:
    """f32 scratch for the split kernel's partials. One buffer is kept per
    (device, stream) and grown as needed: calls on one stream run in order,
    so the merge of one call has read it before the next call's split
    kernel writes it. A CUDA graph being captured gets a buffer of its own,
    from the graph's pool."""
    if torch.cuda.is_current_stream_capturing():
        return torch.empty(numel, dtype=torch.float32, device=device)
    key = (device, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < numel:
        buf = _scratch[key] = torch.empty(numel, dtype=torch.float32,
                                          device=device)
    return buf


def _n_sm(device: int) -> int:
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_count[device]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    qpos: Optional[torch.Tensor] = None,
                    kpos: Optional[torch.Tensor] = None,
                    variant: Optional[str] = None,
                    n_split: Optional[int] = None) -> torch.Tensor:
    """q (B,Sq,H,D), k/v (B,Sk,G,D) -> (B,Sq,H,D) in q's dtype.

    ``variant`` (default ``choose_variant``) and ``n_split`` (default
    ``decode_splits``; split only) pin the kernel for measurements and
    checks; the model path passes neither. Raises on inputs that require
    grad under grad mode (``kernels.ops`` carries gradients). On ``meta``
    tensors (the dry run) it is the kernel's stand-in, ``kernels.meta``."""
    refuse_grad("flash_attention", q, k, v)
    if variant is None:
        variant = choose_variant(q.dtype, q.shape[1])
    else:
        _check_variant(variant, q.dtype, q.shape[1])
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   qpos=qpos, kpos=kpos)
    if dev.type == "meta":
        from repro_torch.kernels import meta
        return meta.flash_attention(q, k, v, qpos, kpos, causal, window)
    if dev.type != "cuda":
        raise ValueError(f"no flash_attention for device {dev}")
    return _launch_fwd(q, k, v, causal, window, qpos, kpos, variant,
                       n_split, False)[0]


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0,
                            qpos: Optional[torch.Tensor] = None,
                            kpos: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tc kernel's forward for training: (o, lse), o as
    ``flash_attention`` gives it, lse (B, G, Sq * H/G) f32, the log-sum-exp
    of each packed row f = position * H/G + head in group in the log2
    domain of the scaled scores (+inf for a row with no valid key), which
    ``flash_attention_backward`` reads. CUDA bf16 with Sq > 1 only
    (``backward_on_kernel``); raises on inputs that require grad under grad
    mode, as ``flash_attention`` does. The launch counts as a ``"tc"``
    one."""
    refuse_grad("flash_attention_fwd_lse", q, k, v)
    if not backward_on_kernel(q):
        raise ValueError(f"flash_attention_fwd_lse runs the tc kernel on "
                         f"CUDA bf16 with Sq > 1, got {q.dtype} "
                         f"{tuple(q.shape)} on {q.device}")
    return _launch_fwd(q, k, v, causal, window, qpos, kpos, "tc", None,
                       True)


def _launch_fwd(q, k, v, causal, window, qpos, kpos, variant, n_split,
                with_lse: bool) -> Tuple[torch.Tensor,
                                         Optional[torch.Tensor]]:
    dev = q.device
    qpos = _positions(qpos, q.shape[1], dev)
    kpos = _positions(kpos, k.shape[1], dev)
    _check(q, k, v, qpos, kpos)
    lib = build.load("flash_attention", _SIGNATURES)
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    device = dev.index or 0
    # the raw handle of the current stream, without building a Stream
    stream = torch._C._cuda_getCurrentRawStream(device)
    out = torch.empty_like(q)
    lse = (torch.empty((B, G, Sq * (H // G)), dtype=torch.float32,
                       device=dev) if with_lse else None)
    scratch = None
    if variant == "split":
        n_split = n_split or decode_splits(B, G, Sk, _n_sm(device))
        scratch = _split_scratch((2 + D) * B * H * n_split, device, stream)
    err = lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
        kpos.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Sq, Sk, H, G, D,
        int(causal), int(window), 1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype],
        _VARIANT_CODE[variant], n_split or 0,
        None if scratch is None else scratch.data_ptr(), device, stream)
    build.raise_on_error(lib, err, f"flash_attention ({variant})")
    _count(variant, (B, Sq, Sk, H, G, D))
    return out, lse


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0,
                             qpos: Optional[torch.Tensor] = None,
                             kpos: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) of attention at its output o for the upstream gradient
    do (contiguous, q's shape and dtype), from the forward's lse
    (``flash_attention_fwd_lse``): the kernels attn_bwd_dq (D and dq) and
    attn_bwd_dkv (dk and dv), ``flash_attention_bwd_ref``'s arithmetic.
    CUDA bf16 tensors, as the tc kernel takes; raises on others, and on
    inputs that require grad under grad mode. A call counts once in
    ``flash_attention_backward.launches``."""
    refuse_grad("flash_attention_backward", q, k, v, o, do)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the backward kernels take CUDA tensors, got "
                         f"{dev}; the plain version is "
                         f"flash_attention_bwd_ref")
    _check_variant("tc", q.dtype, q.shape[1])
    qpos = _positions(qpos, q.shape[1], dev)
    kpos = _positions(kpos, k.shape[1], dev)
    _check(q, k, v, qpos, kpos)
    B, Sq, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if (t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous()
                or t.data_ptr() % 16 or t.get_device() != q.get_device()):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{q.dtype} {tuple(q.shape)} on q's device")
    if (lse.shape != (B, G, Sq * (H // G)) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.get_device() != q.get_device()):
        raise ValueError(f"lse must be contiguous f32 {(B, G, Sq * H // G)} "
                         f"on q's device, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    lib = build.load("flash_attention", _SIGNATURES)
    device = dev.index or 0
    stream = torch._C._cuda_getCurrentRawStream(device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    # the operation's name holds no kernel's name, so that a reader of the
    # kernels by name (attn_bwd) cannot count it as one
    with spans.launch("launch::flash_attention_backward"):
        err = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), qpos.data_ptr(), kpos.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), B,
            Sq, Sk, H, G, D, int(causal), int(window), 1.0 / math.sqrt(D),
            device, stream)
    build.raise_on_error(lib, err, "flash_attention_backward")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0
#: backward calls of ``FlashAttentionFn`` that differentiated the caller's
#: plain function (not ``backward_on_kernel``)
flash_attention_backward.plain_calls = 0


flash_attention.launches = 0
flash_attention.launches_by_variant = {name: 0 for name in VARIANTS}
#: the two-step decode's launches (``flash_decode_partials``,
#: ``flash_decode_merge``), which ``launches`` counts too
flash_attention.launches_by_step = {name: 0 for name in STEPS}
#: (variant or step, its sizes: B, Sq, Sk, H, G, D; a merge's P, rows, D)
flash_attention.launches_by_shape = collections.Counter()


def _count(kind: str, shape: Tuple[int, ...]) -> None:
    flash_attention.launches += 1
    if kind in STEPS:
        flash_attention.launches_by_step[kind] += 1
    else:
        flash_attention.launches_by_variant[kind] += 1
    flash_attention.launches_by_shape[(kind,) + shape] += 1


def flash_decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          qpos: Optional[torch.Tensor] = None,
                          kpos: Optional[torch.Tensor] = None,
                          n_split: Optional[int] = None) -> torch.Tensor:
    """q (B, 1, H, D), k/v (B, Sk, G, D) -> the packed partials (B * H,
    2 + D) f32 of these keys (``flash_decode_partials_ref``): the split
    kernel over ``n_split`` key ranges (default ``decode_splits``), merged
    into one partial a row. A launch counts in ``flash_attention``'s
    launches, and in its ``launches_by_step`` as ``"partials"``."""
    refuse_grad("flash_decode_partials", q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return flash_decode_partials_ref(q, k, v, causal=causal,
                                         window=window, qpos=qpos, kpos=kpos)
    if dev.type == "meta":
        from repro_torch.kernels import meta
        return meta.flash_decode_partials(q, k, v, qpos, kpos, causal,
                                          window)
    if dev.type != "cuda":
        raise ValueError(f"no flash_decode_partials for device {dev}")
    _check_variant("split", q.dtype, q.shape[1])
    qpos = _positions(qpos, 1, dev)
    kpos = _positions(kpos, k.shape[1], dev)
    _check(q, k, v, qpos, kpos)
    lib = build.load("flash_attention", _SIGNATURES)
    B, _, H, D = q.shape
    Sk, G = k.shape[1], k.shape[2]
    device = dev.index or 0
    stream = torch._C._cuda_getCurrentRawStream(device)
    n_split = n_split or decode_splits(B, G, Sk, _n_sm(device))
    scratch = _split_scratch((2 + D) * B * H * n_split, device, stream)
    out = torch.empty((B * H, 2 + D), dtype=torch.float32, device=dev)
    err = lib.repro_flash_decode_partials(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qpos.data_ptr(),
        kpos.data_ptr(), out.data_ptr(), B, Sk, H, G, D, int(causal),
        int(window), 1.0 / math.sqrt(D), _DTYPE_CODE[q.dtype], n_split,
        scratch.data_ptr(), device, stream)
    build.raise_on_error(lib, err, "flash_decode_partials")
    _count("partials", (B, 1, Sk, H, G, D))
    return out


def flash_decode_merge(part: torch.Tensor, dtype: torch.dtype
                       ) -> torch.Tensor:
    """part (P, rows, 2 + D) f32, P packed partials a row in rank order ->
    o (rows, D) in ``dtype`` (``flash_decode_merge_ref``). A launch counts
    in ``flash_attention``'s launches, and in its ``launches_by_step`` as
    ``"merge"``."""
    dev = part.device
    if dev.type == "cpu":
        return flash_decode_merge_ref(part, dtype)
    if dev.type == "meta":
        from repro_torch.kernels import meta
        return meta.flash_decode_merge(part, dtype)
    if dev.type != "cuda":
        raise ValueError(f"no flash_decode_merge for device {dev}")
    P, rows, width = part.shape
    D = width - 2
    check_head_dim(D)
    if (part.dtype != torch.float32 or not part.is_contiguous()
            or dtype not in _DTYPE_CODE):
        raise ValueError(f"need contiguous f32 partials (P, rows, 2 + D), "
                         f"got {tuple(part.shape)} {part.dtype} -> {dtype}")
    lib = build.load("flash_attention", _SIGNATURES)
    device = dev.index or 0
    stream = torch._C._cuda_getCurrentRawStream(device)
    out = torch.empty((rows, D), dtype=dtype, device=dev)
    err = lib.repro_flash_decode_merge(part.data_ptr(), out.data_ptr(), rows,
                                       P, D, _DTYPE_CODE[dtype], device,
                                       stream)
    build.raise_on_error(lib, err, "flash_decode_merge")
    _count("merge", (P, rows, D))
    return out
