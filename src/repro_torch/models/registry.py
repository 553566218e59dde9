"""build_model: ArchConfig -> model instance, by family."""
from __future__ import annotations

from typing import Union

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike

# families whose port is a later slice of the work (see ROADMAP.md)
_LATER = {
    "moe": "the remaining-families slice (models/moe.py)",
    "encdec": "the remaining-families slice (models/encdec.py)",
    "vlm": "the remaining-families slice (models/vlm.py)",
}


def build_model(cfg: Union[ArchConfig, str], *, device: DeviceLike = None,
                attn_impl: str = "flash", gla_impl: str = "kernel"):
    """``attn_impl`` picks the attention ("flash", "ref", "chunked") and
    ``gla_impl`` the GLA scan of the recurrent families ("kernel",
    "chunked"); the dense family has no GLA scan and ignores it."""
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
    if fam in _LATER:
        raise NotImplementedError(
            f"family {fam!r} is not ported yet; it comes with {_LATER[fam]}")
    raise ValueError(f"unknown family {fam!r}")
