"""Architecture registry: ``--arch <id>`` resolves here.

This slice carries the four dense archs and the recurrent pair (rwkv6,
hymba); the other families of ``repro.configs`` arrive with their model
ports.
"""
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeCell

from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen25
from repro_torch.configs.granite_3_2b import CONFIG as _granite
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv6
from repro_torch.configs.stablelm_12b import CONFIG as _stablelm

ARCHS = {c.name: c for c in (_qwen25, _granite, _qwen3, _stablelm, _rwkv6,
                             _hymba)}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeCell", "get_config"]
