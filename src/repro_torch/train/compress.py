"""Int8 gradient compression with error feedback, as
``repro/train/compress.py`` computes it.

Each gradient leaf is quantized to symmetric per-tensor int8 from its f32
value plus the residual of the previous step, and dequantized again; the
new residual (what the int8 round trip lost) is carried to the next step,
so the quantization noise does not bias training. On one device only the
arithmetic runs (the transport saving belongs to a cross-host reduce).
``torch.round`` rounds half to even, as ``jnp.round`` does.

The scale is per JAX leaf: JAX stacks a layer leaf into (L, ...), so the
port's ``layers.{i}.<path>`` (and ``encoder.{i}.<path>``) leaves of one
path share the scale of their stack, the largest |value| over all L layers
(``stack_key``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax / 127.0, min=1e-12)


def quantize_int8(x: torch.Tensor, scale: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q, scale). ``scale`` defaults to
    x's own, max |x| / 127."""
    if scale is None:
        scale = int8_scale(x.abs().max())
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_decompress(grads: Mapping[str, torch.Tensor],
                        error_feedback: Optional[Mapping[str, torch.Tensor]]
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """Quantize+dequantize each gradient leaf with error feedback, at the
    scale of its JAX leaf.

    Returns (decompressed f32 grads, new error-feedback state)."""
    corrected = {}
    amax: Dict[str, torch.Tensor] = {}
    for name, g in grads.items():
        c = g.float()
        if error_feedback is not None:
            c = c + error_feedback[name]
        corrected[name] = c
        key = stack_key(name)
        m = c.abs().max()
        amax[key] = m if key not in amax else torch.maximum(amax[key], m)
    out, new_ef = {}, {}
    for name, c in corrected.items():
        q, s = quantize_int8(c, int8_scale(amax[stack_key(name)]))
        out[name] = dequantize_int8(q, s)
        new_ef[name] = c - out[name]
    return out, new_ef


def stack_key(name: str) -> str:
    """The JAX leaf a port leaf belongs to: ``layers.3.attn.wq`` ->
    ``layers.*.attn.wq``, ``encoder.3.mlp.wi`` -> ``encoder.*.mlp.wi``
    (encdec's stacked encoder); other names stand for themselves."""
    parts = name.split(".")
    if parts[0] in ("layers", "encoder") and len(parts) > 2:
        return ".".join([parts[0], "*"] + parts[2:])
    return name
