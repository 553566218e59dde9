"""build_model: ArchConfig -> model instance, by family."""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike


def build_model(cfg: Union[ArchConfig, str], *, device: DeviceLike = None,
                attn_impl: str = "flash", gla_impl: str = "kernel"):
    """``attn_impl`` picks the attention ("flash", "ref", "chunked") and
    ``gla_impl`` the GLA scan of the recurrent families ("kernel",
    "chunked"); the other families have no GLA scan and ignore it."""
    if isinstance(cfg, str):
        cfg = get_config(cfg)
    fam = cfg.family
    if fam == "dense":
        from repro_torch.models.transformer import TransformerLM
        return TransformerLM(cfg, device=device, attn_impl=attn_impl)
    if fam == "ssm":
        from repro_torch.models.rwkv6 import Rwkv6LM
        return Rwkv6LM(cfg, device=device, attn_impl=attn_impl,
                       gla_impl=gla_impl)
    if fam == "hybrid":
        from repro_torch.models.hymba import HymbaLM
        return HymbaLM(cfg, device=device, attn_impl=attn_impl,
                       gla_impl=gla_impl)
    if fam == "moe":
        from repro_torch.models.moe import MoETransformerLM
        return MoETransformerLM(cfg, device=device, attn_impl=attn_impl)
    if fam == "encdec":
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM(cfg, device=device, attn_impl=attn_impl)
    if fam == "vlm":
        from repro_torch.models.vlm import VlmLM
        return VlmLM(cfg, device=device, attn_impl=attn_impl)
    raise ValueError(f"unknown family {fam!r}")


def prefix_len(cfg: ArchConfig) -> int:
    """Positions ahead of the text tokens: vlm's patch prefix
    (``vis_tokens``), 0 for the other families. A vlm decode step after a
    prompt of P tokens is at position prefix_len + P + i."""
    return cfg.vis_tokens if cfg.family == "vlm" else 0


def side_inputs(cfg: ArchConfig, B: int, *, seed: int,
                n_frames: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The inputs beside the tokens that a family's prefill and loss take,
    shaped as JAX's ``input_specs`` and drawn as N(0, 1) float32 from
    ``RandomState(seed)``: encdec's log-mel frame embeddings (B,
    n_frames, frontend_dim), vlm's patch embeddings (B, vis_tokens,
    vis_dim); none for the other families. Cast them to the model's dtype
    on the way in."""
    rng = np.random.RandomState(seed)
    if cfg.family == "encdec":
        if not n_frames or n_frames % 2:
            raise ValueError(f"encdec needs an even n_frames, got "
                             f"{n_frames}")
        shape = (B, n_frames, cfg.frontend_dim)
        return {"frames": rng.standard_normal(shape).astype(np.float32)}
    if cfg.family == "vlm":
        shape = (B, cfg.vis_tokens, cfg.vis_dim)
        return {"patches": rng.standard_normal(shape).astype(np.float32)}
    return {}
