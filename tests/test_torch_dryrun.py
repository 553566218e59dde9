"""The port's dry run (python -m repro_torch.launch.dryrun) against the JAX
package's: the two cells of tests/test_launch.py through the CLI, every
cell's spec fields against JAX's spec methods, the SKIP cells, the
ZeRO-1 state that goes on the stacked layers dim, and the kernels'
stand-ins the dry run counts in their place."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.models import build_model as jax_build
from repro.models.common import count_params
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.kernels import meta
from repro_torch.kernels import ops as kops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.sharding import DEFAULT_RULES
from repro_torch.sharding.params import placements
from repro_torch.train.sharded import zero1_split

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_torch_sharding import FSDP_ON_LAYERS  # noqa: E402

#: seconds a CLI cell may take on the CPU (each takes a few)
CELL_TIMEOUT_S = 60


def _cli(tmp_path, name, *args):
    out_json = tmp_path / f"{name}.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--json", str(out_json)],
        env=env, capture_output=True, text=True, timeout=CELL_TIMEOUT_S,
        cwd=REPO)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    return json.loads(out_json.read_text())


def _spec_fields_equal_jax(row):
    jm = jax_build(JARCHS[row["arch"]])
    assert row["n_params"] == count_params(jm.param_specs())
    assert row["n_active_params"] == jm.n_active_params()
    assert row["model_flops_global"] == jm.model_flops(JSHAPES[row["shape"]])


def test_dryrun_cell(tmp_path):
    """test_launch.py::test_dryrun_cell_compiles's cell and checks."""
    rows = _cli(tmp_path, "cell", "--arch", "granite-3-2b",
                "--shape", "decode_32k")
    r = rows[0]
    assert r["status"] == "OK"
    assert r["n_devices"] == 256
    assert r["dominant"] == "memory"   # decode = cache-read bound
    assert r["collective_bytes_per_dev"] > 0
    assert r["memory"]["per_device_total"] > 0
    _spec_fields_equal_jax(r)


def test_dryrun_multipod_cell(tmp_path):
    """test_launch.py::test_dryrun_multipod_cell's cell and checks."""
    rows = _cli(tmp_path, "cell_mp", "--arch", "rwkv6-7b",
                "--shape", "long_500k", "--multi-pod")
    r = rows[0]
    assert r["status"] == "OK"
    assert r["n_devices"] == 512
    assert r["mesh"] == "2x16x16"
    _spec_fields_equal_jax(r)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_fields_equal_jax_for_every_cell(arch):
    jm = jax_build(JARCHS[arch])
    for shape, cell in SHAPES.items():
        got = dryrun.spec_fields(get_config(arch), cell)
        assert got == {"n_params": count_params(jm.param_specs()),
                       "n_active_params": jm.n_active_params(),
                       "model_flops_global": jm.model_flops(
                           JSHAPES[shape])}, shape


def test_skip_cells_are_recorded():
    """test_launch.py::test_skip_cells_are_recorded on the port, through
    lower_cell's SKIP rows."""
    skips = [(a, s) for a, c in ARCHS.items() for s in c.skip_shapes]
    assert len(skips) == 8  # 8 full-attention archs skip long_500k
    assert all(s == "long_500k" for _, s in skips)
    assert skips == [(a, s) for a, c in JARCHS.items()
                     for s in c.skip_shapes]
    for arch, shape in skips:
        for mp in (False, True):
            r = dryrun.lower_cell(arch, shape, multi_pod=mp)
            assert r["status"] == "SKIP"
            assert r["reason"] == ARCHS[arch].skip_reason != ""


@pytest.mark.parametrize("multi_pod", (False, True))
def test_zero1_on_the_layers_dim_goes_to_data_ranks_in_turn(multi_pod):
    """The per-layer leaves whose stacked leaf takes ZeRO-1's 'fsdp' on the
    layers dim are exactly test_torch_sharding's 8; layer l's state goes
    whole to data rank l mod 16."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    on_layers = set()
    for arch in sorted(ARCHS):
        cfg = get_config(arch)
        model = build_model(cfg, device="meta")
        for name, pl in placements(model.named_param_specs(), mesh,
                                   DEFAULT_RULES).items():
            z = zero1_split(cfg, name, pl, mesh, DEFAULT_RULES)
            if z is not None and z[0] == "layers":
                top, i, rest = name.split(".", 2)
                assert z[1] == int(i) % 16
                on_layers.add((arch, f"{top}.{rest}"))
    assert on_layers == FSDP_ON_LAYERS


@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("window", (0, 1, 5, 64))
def test_visible_pairs_count_the_mask(causal, window):
    """The stand-in's pair count equals the mask's, the queries at the
    last Sq of the Sk key positions."""
    for Sq, Sk in ((1, 40), (3, 17), (17, 17), (8, 40)):
        qp = torch.arange(Sk - Sq, Sk)[:, None]
        kp = torch.arange(Sk)[None, :]
        ok = torch.ones(Sq, Sk, dtype=torch.bool)
        if causal:
            ok &= kp <= qp
        if window:
            ok &= kp > qp - window
        assert meta.visible_pairs(Sq, Sk, causal, window) == int(ok.sum())


@pytest.mark.parametrize("kernel", ("flash_attention", "gla_scan"))
def test_kernel_stand_ins_count_the_kernels_io(kernel):
    """On meta, the kernels' wrappers are one op each: the dry run's
    traffic is the kernel's inputs and outputs, its flops the kernel's;
    the plain path's intermediates are not counted."""
    M = torch.device("meta")
    if kernel == "flash_attention":
        B, S, H, G, D = 2, 256, 8, 2, 64
        q = torch.empty(B, S, H, D, dtype=torch.bfloat16, device=M)
        k, v = (torch.empty(B, S, G, D, dtype=torch.bfloat16, device=M)
                for _ in range(2))
        pos = torch.arange(S, dtype=torch.int32, device=M)
        io = 2 * (2 * q.numel() + 2 * k.numel()) + 2 * 4 * S
        flops = 4 * D * B * H * S * (S + 1) // 2
        call = lambda: kops.flash_attention(q, k, v, qpos=pos, kpos=pos)
    else:
        B, T, H, K = 2, 96, 4, 32
        r, k, v = (torch.empty(B, T, H, K, dtype=torch.bfloat16, device=M)
                   for _ in range(3))
        logw = torch.empty(B, T, H, K, device=M)
        io = 2 * 4 * r.numel() + 4 * logw.numel() + 4 * B * H * K * K
        n = 32
        flops = 3 * B * H * (4 * n * K * K + n * (n - 1) * 2 * K
                             + 2 * n * 2 * K)
        call = lambda: kops.gla(r, k, v, logw)
    got = dryrun.counted(call)
    assert got.mem_bytes == io
    assert got.flops == flops
