"""Content-addressed result store for sweep cells (a copy of
``repro/sweep/cache.py``).

A cell's cache key is ``sha256(code_fingerprint + cell key)``: the cell
key pins the *configuration* (family, algorithm, scenario, seed index,
params — see ``repro_torch.sweep.cells.CellSpec.key``) and the code
fingerprint pins the *simulator* (a digest over every ``.py`` file under
``src/repro_torch``). Unchanged cells are therefore free on re-run, and
any source edit — however small — invalidates the whole store at once
rather than risking stale trajectories.

The fingerprint digests this package only, never the JAX package ``repro``
beside it: the two packages' entries sit under different fingerprints,
so a shared store directory never serves one package's result to the
other.

Entries are one small JSON file each, written atomically (tmp + rename)
so a killed worker can never leave a half-written entry behind; unread-
able entries are treated as misses and overwritten.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Dict, Iterable, Optional

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(os.path.dirname(_PACKAGE_ROOT))

#: default on-disk store (gitignored), shared with the JAX package's: the
#: fingerprint keeps the two apart
DEFAULT_STORE_DIR = os.path.join(_REPO_ROOT, ".sweep_cache")

_fingerprint_cache: Dict[str, str] = {}


def _iter_source_files(root: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def code_fingerprint(root: Optional[str] = None) -> str:
    """Digest of every ``.py`` file under ``root`` (default:
    ``src/repro_torch``), as relative-path + contents in sorted order.
    Memoized per root — the tree does not change under a running
    process."""
    root = os.path.abspath(root or _PACKAGE_ROOT)
    fp = _fingerprint_cache.get(root)
    if fp is None:
        h = hashlib.sha256()
        for path in _iter_source_files(root):
            h.update(os.path.relpath(path, root).encode("utf-8"))
            h.update(b"\0")
            with open(path, "rb") as f:
                h.update(f.read())
            h.update(b"\0")
        fp = h.hexdigest()
        _fingerprint_cache[root] = fp
    return fp


class ResultStore:
    """Content-addressed cell-result cache.

    ``get``/``put`` address entries by ``sha256(fingerprint + cell
    key)``; entries live under ``<dir>/<fingerprint[:16]>/`` so stale
    fingerprints are trivially prunable and a store restored for the
    wrong code version can never serve a hit.
    """

    def __init__(self, directory: str = DEFAULT_STORE_DIR, *,
                 fingerprint: Optional[str] = None):
        self.directory = directory
        self.fingerprint = fingerprint or code_fingerprint()
        self._subdir = os.path.join(directory, self.fingerprint[:16])

    def _path(self, cell_key: str) -> str:
        h = hashlib.sha256(
            (self.fingerprint + "\0" + cell_key).encode("utf-8"))
        return os.path.join(self._subdir, h.hexdigest()[:40] + ".json")

    def get(self, cell_key: str) -> Optional[dict]:
        try:
            with open(self._path(cell_key)) as f:
                entry = json.load(f)
        except (OSError, ValueError):
            return None
        # the key is stored alongside the metrics, so a (vanishingly
        # unlikely) hash collision or a hand-edited entry reads as a miss
        if entry.get("key") != cell_key:
            return None
        return entry["metrics"]

    def put(self, cell_key: str, metrics: dict) -> None:
        os.makedirs(self._subdir, exist_ok=True)
        payload = json.dumps({"key": cell_key, "metrics": metrics},
                             sort_keys=True)
        fd, tmp = tempfile.mkstemp(dir=self._subdir, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            os.replace(tmp, self._path(cell_key))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
