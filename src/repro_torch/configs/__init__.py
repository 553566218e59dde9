"""Architecture registry: ``--arch <id>`` resolves here. Every arch of
``repro.configs``, each a copy of its JAX config."""
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell

from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen25
from repro_torch.configs.granite_3_2b import CONFIG as _granite
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3
from repro_torch.configs.stablelm_12b import CONFIG as _stablelm
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv6
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.whisper_medium import CONFIG as _whisper
from repro_torch.configs.internvl2_26b import CONFIG as _internvl
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba

ARCHS = {c.name: c for c in (
    _qwen25, _granite, _qwen3, _stablelm, _rwkv6,
    _arctic, _dbrx, _whisper, _internvl, _hymba)}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeCell", "get_config"]
