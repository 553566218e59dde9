"""Carry parameters (and AdamW moments) between the JAX package's models
and the port.

The JAX side hands over its param tree as nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``), or a checkpoint of it
read back by ``repro_torch.train.checkpoint.restore`` as tensors; this
module never imports JAX. The port keeps JAX's (in, out) weight layout, so
the conversion splits the stacked (L, ...) layer leaves (the decoder's and
encdec's encoder's) and renames; nothing is transposed.
``params_to_numpy`` goes the other way.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def to_tensor(a: Any) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16, which ``torch.from_numpy``
    refuses) or a tensor -> a CPU tensor of the same dtype and values."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().clone()
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


def stacked_depths(cfg: ArchConfig) -> Dict[str, int]:
    """The JAX tree's subtrees whose leaves are stacked (L, ...), and their
    depths: the decoder ``layers`` and encdec's ``encoder``."""
    return {"layers": cfg.n_layers, "encoder": cfg.encoder_layers}


def params_from_jax(cfg: ArchConfig,
                    tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``TransformerLM`` (or subclass) params -> the port's
    ``state_dict``.

    Every leaf under ``layers`` (and encdec's ``encoder``) is stacked (L,
    ...), whatever its depth in the tree (hymba's bare ``attn_norm``,
    rwkv6's ``att.mu`` (L, 5, d)); layer i's slice becomes
    ``layers.{i}.<path>``. Every other leaf (``embed``, ``lm_head``,
    ``final_norm``, encdec's ``frontend`` and ``enc_norm``, vlm's
    ``projector``) keeps its dotted path. Load the result with
    ``model.load_state_dict(sd)``; tensors come back on the CPU and are
    copied onto the model's device by the load.
    """
    depths = stacked_depths(cfg)
    sd: Dict[str, torch.Tensor] = {}
    for top, sub in tree.items():
        for path, leaf in _leaves(sub, top):
            leaf = to_tensor(leaf)
            if top not in depths:
                sd[path] = leaf
                continue
            L = depths[top]
            if leaf.shape[0] != L:
                raise ValueError(f"{path}: leading dim {leaf.shape[0]} != "
                                 f"{L}")
            rest = path[len(top):]
            for i in range(L):
                sd[f"{top}.{i}{rest}"] = leaf[i].clone()
    return sd


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 comes back as f32 (numpy has no bf16 of
    its own), exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(cfg: ArchConfig,
                    state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``params_from_jax``: the port's per-layer leaves
    (``layers.{i}.<path>``, ``encoder.{i}.<path>``) restacked to (L, ...)
    under the JAX tree's nested dicts, every leaf a numpy array (bf16 as
    f32)."""
    depths = stacked_depths(cfg)
    tree: Dict[str, Any] = {}
    per_layer: Dict[Tuple[str, str], list] = {}
    for name, t in state_dict.items():
        parts = name.split(".")
        if parts[0] in depths:
            per_layer.setdefault((parts[0], ".".join(parts[2:])), []).append(
                (int(parts[1]), t))
        else:
            _put(tree, parts, _to_numpy(t))
    for (top, path), items in per_layer.items():
        items.sort(key=lambda it: it[0])
        L = depths[top]
        if [i for i, _ in items] != list(range(L)):
            raise ValueError(f"{top}.*.{path}: layers {[i for i, _ in items]}"
                             f", expected 0..{L - 1}")
        _put(tree, [top] + path.split("."),
             np.stack([_to_numpy(t) for _, t in items]))
    return tree


def _put(tree: Dict[str, Any], path, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def opt_state_from_jax(cfg: ArchConfig,
                       state: Mapping[str, Any]) -> Dict[str, Any]:
    """JAX AdamW state ``{"m", "v", "step"}`` (trees shaped as the params)
    -> the port's ``{"m": {name: tensor}, "v": ..., "step"}`` on the CPU."""
    return {"m": params_from_jax(cfg, state["m"]),
            "v": params_from_jax(cfg, state["v"]),
            "step": to_tensor(state["step"]).to(torch.int32).reshape(())}
