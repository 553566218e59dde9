"""Weights and token streams made from ``--seed``, on the device.

The weights of a family's ``leaves`` (``bench.reference.<family>``) are
drawn in one ``randn`` call per dtype on a generator seeded from the seed,
in the dtype they are served in, and handed out as views of those buffers,
named as the program's ``state_dict``. The same seed gives the same
weights, to the program and to the reference alike.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Tuple

import torch


def derive(seed: int, *what) -> int:
    """A 63-bit seed for one stream (``what``) of a run's seed."""
    h = hashlib.sha256(repr((int(seed),) + what).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(device: torch.device, seed: int, *what) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *what))
    return g


def make(leaves: Iterable[Tuple[str, tuple, str, tuple]], seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """name -> tensor for every leaf: ("normal", std) and ("affine", mean,
    std) leaves are slices of one standard-normal draw per dtype, scaled
    (and shifted) in place; ("const", value) leaves are filled."""
    leaves = list(leaves)
    out: Dict[str, torch.Tensor] = {}
    for dtype in sorted({dt for _, _, dt, _ in leaves}):
        mine = [lf for lf in leaves if lf[2] == dtype]
        drawn = [lf for lf in mine if lf[3][0] != "const"]
        n = sum(_numel(shape) for _, shape, _, _ in drawn)
        flat = torch.randn(n, generator=generator(device, seed, "weights",
                                                  dtype),
                           dtype=getattr(torch, dtype), device=device)
        off = 0
        for name, shape, _, init in drawn:
            k = _numel(shape)
            t = flat[off:off + k].view(shape)
            off += k
            if init[0] == "normal":
                t.mul_(init[1])
            elif init[0] == "affine":
                t.mul_(init[2]).add_(init[1])
            else:
                raise ValueError(f"{name}: unknown init {init}")
            out[name] = t
        for name, shape, _, init in mine:
            if init[0] == "const":
                out[name] = torch.full(shape, init[1],
                                       dtype=getattr(torch, dtype),
                                       device=device)
    return {name: out[name] for name, _, _, _ in leaves}


def _numel(shape: tuple) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
