"""Build the package's CUDA sources with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` becomes ``build/torch_kernels/lib<name>-<hash>.so``
under the repository root, a shared library with a plain C interface that
the wrappers load with ``ctypes``. The hash covers the source and the
compiler flags, so an edited source is rebuilt; an unchanged one is
loaded from disk. A build that fails raises: no wrapper falls back to its
plain version on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of the kernels under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple:
    """Start nvcc for one source; returns (target, temp output, process)."""
    target = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    log = open(target.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    return target, tmp, proc


def _finish(name: str, target: Path, tmp: str,
            proc: subprocess.Popen) -> None:
    rc = proc.wait()
    if rc != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed for {name} (exit {rc}):\n"
            + target.with_suffix(".log").read_text())
    os.replace(tmp, target)  # atomic: a concurrent reader sees all or none


def build_all() -> List[Path]:
    """Compile every stale source, one ``nvcc`` per source, all at once."""
    todo = [n for n in sources() if not library_path(n).exists()]
    started = [(n, *_start(n)) for n in todo]
    errors = []
    for n, target, tmp, proc in started:  # wait for every nvcc, then raise
        try:
            _finish(n, target, tmp, proc)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(n) for n in sources()]


def load(name: str,
         signatures: Optional[Dict[str, Tuple[object, Sequence]]] = None
         ) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if stale.

    ``signatures`` maps a function's name to (restype, argtypes); each is
    set on the first call that names it (a library loaded earlier without
    it gets it then: ctypes would pass an unset pointer argument as a
    32-bit int), and every library's ``repro_cuda_error_string`` is set
    at first load."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(path))
        fn = lib.repro_cuda_error_string
        fn.restype, fn.argtypes = ctypes.c_char_p, [ctypes.c_int]
        _loaded[name] = lib
    for fn_name, (restype, argtypes) in (signatures or {}).items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.restype = restype
            fn.argtypes = list(argtypes)
    return lib


def raise_on_error(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    """Raise if a launch function returned a non-zero ``cudaError_t``; each
    library exports ``repro_cuda_error_string`` for the message."""
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()}")
