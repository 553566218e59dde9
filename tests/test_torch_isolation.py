"""The port imports neither JAX nor anything of the JAX package ``repro``."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b|from\s+repro[\s.])",
    re.MULTILINE)


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_import_pulls_in_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__,\n"
        "                                'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "n = sum(m.startswith('repro_torch') for m in sys.modules)\n"
        "print(n, bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    # 51 modules: the serving slices' 27, the training slice's 13, and
    # flags, mapreduce (3), the moe/encdec/vlm models and their 4 configs
    assert int(r.stdout.split()[0]) >= 51, r.stdout


def test_sources_name_no_jax_and_no_repro_import():
    files = _port_files()
    assert len(files) >= 52
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, (f, hits)
    assert FORBIDDEN.search("from repro.models import x")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert not FORBIDDEN.search("from repro_torch.models import x")


def test_port_calls_no_library_attention():
    """Attention on the port's path is its own kernel: no file of the
    package calls SDPA (chip_smoke.py times it only as a yardstick)."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
        (ROOT / "src" / "repro_torch").rglob("*.cu"))
    assert len(files) >= 15
    for f in files:
        assert "scaled_dot_product_attention" not in f.read_text(), f
