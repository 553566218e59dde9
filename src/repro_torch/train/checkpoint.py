"""Fault-tolerant checkpointing: atomic, sharded, manifest-committed. The
on-disk format of ``repro/train/checkpoint.py``, so each package reads the
other's checkpoints.

Layout (one directory per step):

    <root>/step_000123/
        shard_00000.npz     # flattened leaf arrays
        ...
        MANIFEST.json       # written LAST; a checkpoint without a
                            # manifest is incomplete and ignored

A tree is nested dicts whose leaves are tensors (or numpy arrays); a
leaf's key is its path joined by "/", in sorted order, as JAX flattens a
dict. Leaves whose dtype numpy lacks (bf16, fp8) are stored as raw bytes,
shape + (itemsize,) uint8, with the dtype's name in the manifest. Writes go
to ``step_xxx.tmp`` and are renamed only after the manifest is fsync'd, so
a crash mid-write never corrupts the latest checkpoint. ``restore`` gives
back CPU tensors (on the device of ``tree_like``'s leaves where it is
given); a checkpoint of the JAX package's params reads back as a tree
for ``repro_torch.convert.params_from_jax``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

_NATIVE_KINDS = "biufc"


def _encode(a: Any) -> Tuple[np.ndarray, str]:
    """npz-safe encoding: non-native dtypes (bf16, fp8) as raw bytes."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype.is_floating_point and t.dtype not in (
                torch.float16, torch.float32, torch.float64):
            raw = t.reshape(-1).view(torch.uint8).reshape(
                tuple(t.shape) + (t.element_size(),))
            return raw.numpy(), str(t.dtype).split(".")[-1]
        a = t.numpy()
    a = np.asarray(a)
    if a.dtype.kind in _NATIVE_KINDS:
        return a, a.dtype.name
    raw = np.ascontiguousarray(a).view(np.uint8).reshape(
        a.shape + (a.dtype.itemsize,))
    return raw, a.dtype.name


def _decode(raw: np.ndarray, dtype_name: str) -> torch.Tensor:
    """``raw`` is a fresh array read from the npz; the tensor takes its
    memory."""
    t = torch.from_numpy(raw)
    if raw.dtype.kind in _NATIVE_KINDS and raw.dtype.name == dtype_name:
        return t
    return t.view(getattr(torch, dtype_name)).reshape(raw.shape[:-1])


def _leaf_paths(tree: Any, prefix: Tuple[str, ...] = ()
                ) -> List[Tuple[str, Any]]:
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree):
            out += _leaf_paths(tree[k], prefix + (str(k),))
        return out
    return [("/".join(prefix), tree)]


def save(root: str, step: int, tree, *, shard_leaves: int = 64,
         extra_meta: Optional[Dict[str, Any]] = None) -> str:
    """Blocking atomic save. Returns the committed directory."""
    final = os.path.join(root, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves = _leaf_paths(tree)
    manifest: Dict[str, Any] = {
        "step": step, "n_leaves": len(leaves), "shards": [],
        "time": time.time(), "meta": extra_meta or {},
    }
    for si in range(0, len(leaves), shard_leaves):
        chunk = leaves[si:si + shard_leaves]
        fname = f"shard_{si // shard_leaves:05d}.npz"
        arrays = {}
        dtypes = {}
        for k, v in chunk:
            arrays[k], dtypes[k] = _encode(v)
        with open(os.path.join(tmp, fname), "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        manifest["shards"].append(
            {"file": fname, "keys": [k for k, _ in chunk],
             "dtypes": dtypes})
    mpath = os.path.join(tmp, "MANIFEST.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_step(root: str) -> Optional[int]:
    """Highest step with a complete (manifest-committed) checkpoint."""
    if not os.path.isdir(root):
        return None
    best = None
    for name in os.listdir(root):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        if not os.path.exists(os.path.join(root, name, "MANIFEST.json")):
            continue
        try:
            step = int(name.split("_")[1])
        except ValueError:
            continue
        best = step if best is None else max(best, step)
    return best


def restore(root: str, tree_like=None, step: Optional[int] = None):
    """Restore a checkpoint; returns (tree, step).

    With ``tree_like`` the tree takes its structure, every leaf it names
    must be there with its shape, and a leaf lands on the device of the
    tensor it stands for; without, the tree is rebuilt from the keys
    (nested dicts of CPU tensors). Raises FileNotFoundError if no complete
    checkpoint exists.
    """
    step = latest_step(root) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {root}")
    d = os.path.join(root, f"step_{step:09d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    data: Dict[str, torch.Tensor] = {}
    for sh in manifest["shards"]:
        with np.load(os.path.join(d, sh["file"])) as z:
            for k in sh["keys"]:
                raw = z[k]  # each access reads the member again
                data[k] = _decode(raw, sh.get("dtypes", {}).get(
                    k, raw.dtype.name))
    if tree_like is None:
        tree: Dict[str, Any] = {}
        for key, leaf in data.items():
            *path, last = key.split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[last] = leaf
        return tree, step

    def fill(like, prefix: Tuple[str, ...]):
        if isinstance(like, Mapping):
            return {k: fill(v, prefix + (str(k),)) for k, v in like.items()}
        key = "/".join(prefix)
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[key]
        want = getattr(like, "shape", None)
        if want is not None and tuple(arr.shape) != tuple(want):
            raise ValueError(f"leaf {key!r} shape {tuple(arr.shape)} != "
                             f"{tuple(want)}")
        if isinstance(like, torch.Tensor):
            arr = arr.to(like.device)
        return arr

    return fill(tree_like, ()), step


def gc_old(root: str, keep: int = 3) -> List[str]:
    """Delete all but the newest ``keep`` complete checkpoints."""
    if not os.path.isdir(root):
        return []
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(root)
        if n.startswith("step_") and not n.endswith(".tmp")
        and os.path.exists(os.path.join(root, n, "MANIFEST.json")))
    removed = []
    for s in steps[:-keep] if keep else steps:
        p = os.path.join(root, f"step_{s:09d}")
        shutil.rmtree(p)
        removed.append(p)
    return removed


def _to_host(tree):
    """A copy of every leaf on the host: training goes on updating the
    device tensors (and a CPU tensor in place) while the copy is written."""
    if isinstance(tree, Mapping):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree)


class AsyncCheckpointer:
    """Overlap checkpoint I/O with training: ``submit`` copies the tree to
    the host synchronously (cheap) and writes on a worker thread. At most
    one write in flight; a newer submit waits for the previous."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_committed: Optional[int] = None
        self._err: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, step: int, tree,
               extra_meta: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        host_tree = _to_host(tree)

        def work():
            try:
                save(self.root, step, host_tree, extra_meta=extra_meta)
                gc_old(self.root, self.keep)
                self.last_committed = step
            except BaseException as e:  # noqa: BLE001 - surfaced in wait()
                self._err = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
