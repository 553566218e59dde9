"""Batched progressive fill: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``repro/sweep/vmap_fill.py::_fill_one`` with the
``_jitted_rates_dt`` epilogue (XLA, not a Pallas kernel): S fill problems
of the fabric allocator, padded to a common (C classes, L links), give each
class's per-member rate and the seconds to the earliest completion. Inputs,
float64 unless noted: caps (S, L), members (S, C, L) 0/1 (uint8 for the
kernel), n, fcap, cap_rank and remaining (S, C). Padded links carry caps =
inf and no members; padded classes n = 0, fcap = inf, remaining = inf.

Both versions fill as ``repro_torch/sim/network.py::_recompute`` does, round
by round: a link win fixes every unfixed class on the link, a cap win fixes
the one unfixed class of least ``cap_rank``, and each debit is
``max(0, rem - k * share)`` with the product and the difference rounded on
their own. So both are bit-equal to the scalar allocator, not merely close
(the JAX kernel fixes all classes at an equal cap in one round, which
rounds a shared link's debit differently).

On a CPU tensor the wrapper runs ``fill_rates_dt_ref``; on a CUDA tensor it
launches one of the two kernels of ``csrc/fill.cu`` or raises: ``"reg"``,
its state in registers, for up to ``REG_MAX_C`` classes and ``REG_MAX_L``
links, and ``"smem"``, the first design, for any shape
(``choose_variant``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

_F64 = torch.float64
VARIANTS = ("reg", "smem")
_VARIANT_CODE = {"smem": 0, "reg": 1}
#: the largest shape the register kernel's templates hold: 4 words of 64
#: classes, 4 links a lane
REG_MAX_C, REG_MAX_L = 256, 128
# repro_fill_rates_dt(caps, members, n, fcap, cap_rank, remaining, rates, dt,
#                     status, S, C, L, variant, device, stream)
_SIGNATURES = {"repro_fill_rates_dt": (
    ctypes.c_int, [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
    + [ctypes.c_void_p])}


def fill_rates_dt_ref(caps: torch.Tensor, members: torch.Tensor,
                      n: torch.Tensor, fcap: torch.Tensor,
                      cap_rank: torch.Tensor, remaining: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel, batched over S: (rates (S, C), dt (S,)).

    One round fixes, in every problem not yet done, the classes of the
    least-share link, or the one class of least ``cap_rank`` when its cap is
    strictly below that share (or no link has members left). The debit is
    written as two operations, never fused."""
    rates, dt, _ = _fill(caps, members, n, fcap, cap_rank, remaining)
    return rates, dt


def fill_rounds(caps, members, n, fcap, cap_rank) -> torch.Tensor:
    """The rounds each problem's fill takes (S,), the work the kernel does
    on these inputs."""
    return _fill(caps, members, n, fcap, cap_rank,
                 torch.full_like(n, float("inf")))[2]


def _fill(caps, members, n, fcap, cap_rank, remaining):
    S, C, L = members.shape
    m = members.to(_F64)
    inf = torch.tensor(float("inf"), dtype=_F64, device=caps.device)
    zero = torch.zeros((), dtype=_F64, device=caps.device)
    fixed = ~(n > 0.0)
    rem = caps.clone()
    rates = torch.zeros((S, C), dtype=_F64, device=caps.device)
    nuse = torch.bmm(n.unsqueeze(1), m).squeeze(1)   # exact integer sums
    rows = torch.arange(S, device=caps.device)
    rounds = torch.zeros(S, dtype=torch.int64, device=caps.device)
    for _ in range(C + 1):
        live = ~fixed
        active = live.any(dim=1)
        if not bool(active.any()):
            break
        has_link = nuse > 0.0
        share_l = torch.where(has_link, rem / nuse, inf)
        li = torch.argmin(share_l, dim=1)       # first least: key order
        link_share = share_l[rows, li]
        bc = torch.argmin(torch.where(live, cap_rank, inf), dim=1)
        cap_min = fcap[rows, bc]
        cap_wins = (cap_min < link_share) | ~has_link.any(dim=1)
        share = torch.where(cap_wins, cap_min, link_share)
        on_link = live & (m[rows, :, li] > 0.0)
        the_cap = torch.zeros_like(live)
        the_cap[rows, bc] = True
        newly = torch.where(cap_wins.unsqueeze(1), the_cap, on_link)
        newly &= active.unsqueeze(1)
        if not bool((newly.any(dim=1) | ~active).all()):
            raise RuntimeError("fill: a round fixed no class (inconsistent "
                               "problem)")
        rates = torch.where(newly, share.unsqueeze(1), rates)
        fixed = fixed | newly
        k_l = torch.bmm(torch.where(newly, n, zero).unsqueeze(1),
                        m).squeeze(1)
        debit = k_l * share.unsqueeze(1)
        left = rem - debit
        rem = torch.where(k_l > 0.0, torch.where(left > 0.0, left, zero),
                          rem)
        nuse = nuse - k_l
        rounds += active
    if bool((~fixed).any()):
        raise RuntimeError("fill: more rounds than classes")
    alive = (rates > 0.0) & torch.isfinite(remaining)
    etas = torch.where(alive, remaining / torch.where(alive, rates, inf),
                       inf)
    return rates, etas.min(dim=1).values, rounds


def choose_variant(C: int, L: int) -> str:
    """The kernel a call goes to: ``"reg"`` where its templates hold the
    shape (C classes, L links), else ``"smem"``."""
    return "reg" if C <= REG_MAX_C and L <= REG_MAX_L else "smem"


def _check_variant(variant: str, C: int, L: int) -> None:
    if variant not in _VARIANT_CODE:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if variant == "reg" and choose_variant(C, L) != "reg":
        raise ValueError(f"the reg kernel holds at most {REG_MAX_C} classes "
                         f"and {REG_MAX_L} links, got C={C} L={L}")


def _check(ts) -> None:
    caps, members, n, fcap, cap_rank, remaining = ts
    if len({t.device for t in ts}) != 1:
        raise ValueError("every input of fill_rates_dt must share one device")
    if members.dim() != 3:
        raise ValueError(f"members must be (S, C, L), got "
                         f"{tuple(members.shape)}")
    S, C, L = members.shape
    if members.dtype != torch.uint8:
        raise TypeError(f"the kernel takes uint8 members, got "
                        f"{members.dtype}")
    for name, t, shape in (("caps", caps, (S, L)), ("n", n, (S, C)),
                           ("fcap", fcap, (S, C)),
                           ("cap_rank", cap_rank, (S, C)),
                           ("remaining", remaining, (S, C))):
        if t.dtype != _F64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    for name, t in zip(("caps", "members", "n", "fcap", "cap_rank",
                        "remaining"), ts):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if min(S, C, L) < 1:
        raise ValueError(f"unsupported sizes S={S} C={C} L={L}")


def launch(caps: torch.Tensor, members: torch.Tensor, n: torch.Tensor,
           fcap: torch.Tensor, cap_rank: torch.Tensor,
           remaining: torch.Tensor, out: torch.Tensor,
           variant: Optional[str] = None) -> None:
    """Launch the kernel on the current stream without waiting for it:
    ``out`` (S * C + 2 S float64, on the card) receives rates (S, C), then
    dt (S,), then a status (S,) that is 1 for a problem the kernel could not
    solve. The caller reads the status after its copy back
    (``raise_on_status``). ``variant`` (default ``choose_variant``) pins
    the kernel, for measurements and checks."""
    S, C, L = members.shape
    if variant is not None:
        _check_variant(variant, C, L)
    variant = variant or choose_variant(C, L)
    if caps.device.type != "cuda":
        raise ValueError(f"no fill kernel for device {caps.device}")
    ts = (caps, members, n, fcap, cap_rank, remaining)
    _check(ts)
    if out.dtype != _F64 or out.numel() != S * C + 2 * S or \
            out.device != caps.device or not out.is_contiguous():
        raise ValueError("out must be a contiguous float64 tensor of "
                         f"{S * C + 2 * S} values beside the inputs")
    lib = build.load("fill", _SIGNATURES)
    stream = torch.cuda.current_stream(caps.device).cuda_stream
    base = out.data_ptr()
    err = lib.repro_fill_rates_dt(
        caps.data_ptr(), members.data_ptr(), n.data_ptr(), fcap.data_ptr(),
        cap_rank.data_ptr(), remaining.data_ptr(), base,
        base + 8 * S * C, base + 8 * (S * C + S), S, C, L,
        _VARIANT_CODE[variant], caps.device.index or 0, stream)
    build.raise_on_error(lib, err, f"fill ({variant})")
    fill_rates_dt.launches += 1
    fill_rates_dt.launches_by_variant[variant] += 1


def raise_on_status(status) -> None:
    """Raise if the kernel flagged a problem it could not solve."""
    bad = [i for i, v in enumerate(status.tolist()) if v != 0.0]
    if bad:
        raise RuntimeError(f"fill kernel: problems {bad[:8]} made no "
                           "progress in a round (inconsistent input)")


def fill_rates_dt(caps: torch.Tensor, members: torch.Tensor,
                  n: torch.Tensor, fcap: torch.Tensor,
                  cap_rank: torch.Tensor, remaining: torch.Tensor,
                  variant: Optional[str] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rates (S, C), dt (S,)) for S padded fill problems. On the card it
    waits for the kernel, to read its status."""
    S, C, L = members.shape
    if variant is not None:
        _check_variant(variant, C, L)
    if caps.device.type == "cpu":
        return fill_rates_dt_ref(caps, members, n, fcap, cap_rank, remaining)
    out = torch.empty(S * C + 2 * S, dtype=_F64, device=caps.device)
    launch(caps, members, n, fcap, cap_rank, remaining, out, variant)
    raise_on_status(out[S * C + S:].cpu())
    return out[:S * C].view(S, C), out[S * C:S * C + S]


fill_rates_dt.launches = 0
fill_rates_dt.launches_by_variant = {name: 0 for name in VARIANTS}
