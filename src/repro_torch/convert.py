"""Carry parameters from the JAX package's models into the port.

The JAX side hands over its param tree as nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``); this module never imports
JAX. The port keeps JAX's (in, out) weight layout, so the conversion splits
the stacked (L, ...) layer leaves and renames; nothing is transposed.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def to_tensor(a: Any) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16, which ``torch.from_numpy``
    refuses) -> a CPU tensor of the same dtype and values."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _leaves(tree: Any, prefix: str) -> Iterator[Tuple[str, Any]]:
    """(dotted path, array) for every array of a nested dict; a bare array
    is a leaf of its own path."""
    if isinstance(tree, Mapping):
        for name, sub in tree.items():
            yield from _leaves(sub, f"{prefix}.{name}")
    else:
        yield prefix, tree


def params_from_jax(cfg: ArchConfig,
                    tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``TransformerLM`` (or subclass: rwkv6, hymba) params -> the
    port's ``state_dict``.

    Every leaf under ``layers`` is stacked (L, ...), whatever its depth in
    the tree (hymba's bare ``attn_norm``, rwkv6's ``att.mu`` (L, 5, d));
    layer i's slice becomes ``layers.{i}.<path>``. Load the result with
    ``model.load_state_dict(sd)``; tensors come back on the CPU and are
    copied onto the model's device by the load.
    """
    sd: Dict[str, torch.Tensor] = {"embed": to_tensor(tree["embed"])}
    if not cfg.tie_embeddings:
        sd["lm_head"] = to_tensor(tree["lm_head"])
    for path, leaf in _leaves(tree["final_norm"], "final_norm"):
        sd[path] = to_tensor(leaf)
    for path, stacked in _leaves(tree["layers"], ""):
        stacked = np.asarray(stacked)
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(f"layers{path}: leading dim {stacked.shape[0]} "
                             f"!= {cfg.n_layers}")
        for i in range(cfg.n_layers):
            sd[f"layers.{i}{path}"] = to_tensor(stacked[i])
    return sd
