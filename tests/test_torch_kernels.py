"""The port's flash_attention (its plain version, on CPU tensors) against the
JAX package's Pallas kernel in interpret mode, on the shapes and with the
tolerances of tests/test_kernels.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as jax_flash)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import gla_scan as gs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ATTN_SHAPES = [
    # (B, H, Sq, Sk, D, block_q, block_k), as tests/test_kernels.py
    (1, 1, 128, 128, 32, 64, 64),
    (2, 4, 256, 256, 64, 128, 128),
    (1, 2, 128, 384, 64, 64, 128),   # cross: Sk > Sq
    (2, 3, 64, 64, 16, 64, 64),
]
# tests/test_kernels.py: f32 atol 2e-5, bf16 atol 2e-2, rtol 1e-2 for both
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
RTOL = 1e-2


def _inputs(rng, shape_q, shape_kv, dtype):
    """Same numbers on both sides: numpy f32, rounded once to ``dtype`` by
    JAX, then handed to torch bit for bit."""
    arrs = [jnp.asarray(rng.randn(*s), getattr(jnp, dtype))
            for s in (shape_q, shape_kv, shape_kv)]
    tens = [torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, dtype)) for a in arrs]
    return arrs, tens


def _bhsd_to_bshd(t):
    return t.transpose(1, 2).contiguous()


def _close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=RTOL)


@pytest.mark.parametrize("B,H,Sq,Sk,D,bq,bk", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas(B, H, Sq, Sk, D, bq, bk, dtype,
                                        causal):
    rng = np.random.RandomState(0)
    (q, k, v), (tq, tk, tv) = _inputs(rng, (B, H, Sq, D), (B, H, Sk, D),
                                      dtype)
    ref = jax_flash(q, k, v, causal=causal, interpret=True,
                    block_q=bq, block_k=bk)
    out = fa.flash_attention(_bhsd_to_bshd(tq), _bhsd_to_bshd(tk),
                             _bhsd_to_bshd(tv), causal=causal)
    _close(out.transpose(1, 2), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sliding_window(dtype):
    rng = np.random.RandomState(1)
    B, H, S, D, W = 1, 2, 256, 32, 64
    (q, k, v), (tq, tk, tv) = _inputs(rng, (B, H, S, D), (B, H, S, D), dtype)
    ref = jax_flash(q, k, v, causal=True, window=W, interpret=True,
                    block_q=64, block_k=64)
    out = fa.flash_attention(_bhsd_to_bshd(tq), _bhsd_to_bshd(tk),
                             _bhsd_to_bshd(tv), causal=True, window=W)
    _close(out.transpose(1, 2), ref, dtype)


def test_flash_attention_masked_kpos():
    """kpos == -1 slots (unwritten cache) are ignored."""
    rng = np.random.RandomState(2)
    B, H, Sq, Sk, D = 1, 1, 64, 128, 32
    (q, k, v), (tq, tk, tv) = _inputs(rng, (B, H, Sq, D), (B, H, Sk, D),
                                      "float32")
    kpos = np.where(np.arange(Sk) < 100, np.arange(Sk), -1).astype(np.int32)
    qpos = (np.arange(Sq) + 36).astype(np.int32)
    ref = jax_flash(q, k, v, causal=True, qpos=jnp.asarray(qpos),
                    kpos=jnp.asarray(kpos), interpret=True,
                    block_q=64, block_k=64)
    out = fa.flash_attention(_bhsd_to_bshd(tq), _bhsd_to_bshd(tk),
                             _bhsd_to_bshd(tv), causal=True,
                             qpos=torch.from_numpy(qpos),
                             kpos=torch.from_numpy(kpos))
    _close(out.transpose(1, 2), ref, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_decode_step(dtype):
    """Sq = 1 against a ring cache with empty (-1) slots, as decode runs it:
    the Pallas kernel needs Sk to tile, so Sk = 128 here."""
    rng = np.random.RandomState(3)
    B, H, Sk, D, pos = 2, 4, 128, 32, 90
    (q, k, v), (tq, tk, tv) = _inputs(rng, (B, H, 1, D), (B, H, Sk, D),
                                      dtype)
    kpos = np.where(np.arange(Sk) <= pos, np.arange(Sk), -1).astype(np.int32)
    qpos = np.array([pos], np.int32)
    ref = jax_flash(q, k, v, causal=True, qpos=jnp.asarray(qpos),
                    kpos=jnp.asarray(kpos), interpret=True, block_q=1,
                    block_k=64)
    out = fa.flash_attention(_bhsd_to_bshd(tq), _bhsd_to_bshd(tk),
                             _bhsd_to_bshd(tv), causal=True,
                             qpos=torch.from_numpy(qpos),
                             kpos=torch.from_numpy(kpos))
    _close(out.transpose(1, 2), ref, dtype)


def test_flash_attention_fully_masked_row_is_zero():
    """A query with no valid key gives exactly 0, as acc / max(l, 1e-30)."""
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               for s in ((1, 8, 2, 16), (1, 16, 1, 16), (1, 16, 1, 16)))
    qpos = torch.arange(8, dtype=torch.int32) - 4
    out = fa.flash_attention(q, k, v, causal=True, qpos=qpos)
    assert bool((out[:, :4] == 0).all())
    assert bool((out[:, 4:] != 0).any())


@pytest.mark.parametrize("H,G", [(8, 2), (8, 1), (4, 4)])
def test_ops_gqa_by_index_matches_jax_ops(H, G):
    """ops.flash_attention takes model-layout GQA (G <= H) and reads kv head
    h // (H/G) by index; JAX ops broadcasts by repeat."""
    rng = np.random.RandomState(5)
    B, S, D = 2, 128, 32
    (q, k, v), (tq, tk, tv) = _inputs(rng, (B, S, H, D), (B, S, G, D),
                                      "float32")
    ref = jax_ops.flash_attention(q, k, v, causal=True, interpret=True,
                                  block_q=64, block_k=64)
    out = ops.flash_attention(tq, tk, tv, causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5,
                               rtol=1e-2)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """The CUDA path's argument checks run on any device."""
    q = torch.zeros((1, 4, 4, 24))
    kv = torch.zeros((1, 4, 2, 24))
    pos = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        fa._check(q, kv, kv, pos, pos)
    q = torch.zeros((1, 4, 4, 32))
    with pytest.raises(ValueError, match="do not fit"):
        fa._check(q, torch.zeros((1, 4, 3, 32)), torch.zeros((1, 4, 3, 32)),
                  pos, pos)
    with pytest.raises(TypeError):
        fa._check(q.half(), q.half(), q.half(), pos, pos)
    with pytest.raises(ValueError, match="contiguous"):
        fa._check(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2),
                  pos, pos)
    with pytest.raises(ValueError, match="int32"):
        fa._check(q, q, q, pos.long(), pos)


def test_cuda_is_required_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def _fake_nvcc(tmp_path, body):
    """An ``nvcc`` on PATH that runs ``body`` with $out set to its -o."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do [ \"$1\" = -o ] && "
                    "out=$2; shift; done\n" + body + "\n")
    nvcc.chmod(0o755)
    return nvcc.parent


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A private csrc/ with two sources and a private build directory."""
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("a", "b"):
        (src / f"{name}.cu").write_text(f"// {name}\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    return src


def test_build_path_follows_the_source_hash(csrc):
    assert build.sources() == ["a", "b"]
    before = build.library_path("a")
    assert before.parent == build.BUILD_DIR
    assert before.name.startswith("liba-") and before.suffix == ".so"
    assert build.library_path("a") == before
    (csrc / "a.cu").write_text("// a, edited\n")
    assert build.library_path("a") != before


def test_build_all_compiles_every_stale_source(csrc, tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    bindir = _fake_nvcc(tmp_path, f'echo x >> {calls}; echo lib > "$out"')
    monkeypatch.setenv("PATH", f"{bindir}:/usr/bin:/bin")
    libs = build.build_all()
    assert [p.name.split("-")[0] for p in libs] == ["liba", "libb"]
    assert all(p.read_text() == "lib\n" for p in libs)
    assert len(calls.read_text().split()) == 2
    build.build_all()              # nothing stale: no second compile
    assert len(calls.read_text().split()) == 2
    assert not list(build.BUILD_DIR.glob(".*.so"))  # no temp files left


def test_build_failure_raises_with_the_compiler_log(csrc, tmp_path,
                                                    monkeypatch):
    bindir = _fake_nvcc(tmp_path, "echo 'error: no luck' >&2; exit 2")
    monkeypatch.setenv("PATH", f"{bindir}:/usr/bin:/bin")
    with pytest.raises(RuntimeError, match="no luck"):
        build.build_all()
    assert not list(build.BUILD_DIR.glob("*.so"))


def test_build_without_nvcc_raises(csrc, tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_wrapper_alignment_rule():
    """q/k/v are read as 16-byte vectors and must be aligned; positions are
    read one int at a time, so a view at any offset is taken."""
    q = torch.zeros((1, 4, 2, 16))
    pos = torch.arange(9, dtype=torch.int32)[5:9]      # 20-byte offset
    fa._check(q, q, q, pos, pos)
    odd = torch.zeros(4 * 2 * 16 + 1)[1:].view(1, 4, 2, 16)
    with pytest.raises(ValueError, match="aligned"):
        fa._check(odd, q, q, pos, pos)


def test_build_all_picks_up_every_source_of_the_package(tmp_path,
                                                        monkeypatch):
    """The real csrc/ holds the three kernels; build_all compiles each
    with its own nvcc (a fake one here) into the build directory."""
    assert build.sources() == ["fill", "flash_attention", "gla_scan"]
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    calls = tmp_path / "calls"
    bindir = _fake_nvcc(tmp_path, f'echo "$out" >> {calls}; echo lib > "$out"')
    monkeypatch.setenv("PATH", f"{bindir}:/usr/bin:/bin")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    libs = build.build_all()
    assert [p.name.split("-")[0] for p in libs] == [
        "libfill", "libflash_attention", "libgla_scan"]
    assert all(p.parent == build.BUILD_DIR for p in libs)
    assert len(calls.read_text().split()) == 3


def _gla_args(B=1, T=8, H=2, K=16, V=16, dtype=torch.float32):
    return (torch.zeros((B, T, H, K), dtype=dtype),
            torch.zeros((B, T, H, K), dtype=dtype),
            torch.zeros((B, T, H, V), dtype=dtype),
            torch.zeros((B, T, H, K)), None, None)


def test_gla_wrapper_rejects_what_the_kernel_does_not_take():
    """The CUDA path's argument checks run on any device."""
    gs._check(*_gla_args())
    gs._check(*_gla_args(dtype=torch.bfloat16))
    r, k, v, w, _, _ = _gla_args()
    with pytest.raises(ValueError, match="must be in"):
        gs._check(*_gla_args(K=24))
    with pytest.raises(ValueError, match="must be in"):
        gs._check(*_gla_args(V=128))
    with pytest.raises(ValueError, match="do not fit"):
        gs._check(r, k[:, :4], v, w, None, None)
    with pytest.raises(ValueError, match="do not fit"):
        gs._check(r, k, v[:, :, :1], w, None, None)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gs._check(*_gla_args(dtype=torch.float16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gs._check(r, k.bfloat16(), v, w, None, None)
    with pytest.raises(TypeError, match="logw must be float32"):
        gs._check(r, k, v, w.bfloat16(), None, None)
    with pytest.raises(TypeError, match="u must be float32"):
        gs._check(r, k, v, w, torch.zeros((2, 16), dtype=torch.float64),
                  None)
    with pytest.raises(ValueError, match="u must be"):
        gs._check(r, k, v, w, torch.zeros((16, 2)), None)
    with pytest.raises(ValueError, match="initial_state must be"):
        gs._check(r, k, v, w, None, torch.zeros((1, 2, 16, 8)))
    with pytest.raises(ValueError, match="contiguous"):
        gs._check(r.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  w.transpose(1, 2), None, None)
    with pytest.raises(ValueError, match="need r/k/logw"):
        gs._check(r[0], k[0], v[0], w[0], None, None)


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to drive the wrappers'
    CUDA path on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("kernel", ["gla_scan", "flash_attention",
                                    "flash_attention_backward"])
def test_cuda_tensor_launches_or_raises_never_falls_back(kernel, tmp_path,
                                                         monkeypatch):
    """On a CUDA tensor the wrappers (and ops) build and launch the kernel
    or raise; here nvcc is missing, so they raise, and the plain version is
    never run and the launch count never moves."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))

    def no_fallback(*a, **k):
        raise AssertionError("fell back to the plain version")

    if kernel == "gla_scan":
        monkeypatch.setattr(gs, "gla_scan_ref", no_fallback)
        args = [t.as_subclass(_OnCuda) for t in _gla_args()[:4]]
        u = torch.zeros((2, 16)).as_subclass(_OnCuda)
        calls = [lambda: gs.gla_scan(*args, u),
                 lambda: ops.gla(*args, u)]
        counter = gs.gla_scan
    elif kernel == "flash_attention":
        monkeypatch.setattr(fa, "flash_attention_ref", no_fallback)
        q = torch.zeros((1, 4, 2, 16)).as_subclass(_OnCuda)
        pos = torch.arange(4, dtype=torch.int32).as_subclass(_OnCuda)
        calls = [lambda: fa.flash_attention(q, q, q, qpos=pos, kpos=pos)]
        counter = fa.flash_attention
    else:  # the training forward and the backward kernels (bf16)
        monkeypatch.setattr(fa, "flash_attention_ref", no_fallback)
        monkeypatch.setattr(fa, "flash_attention_bwd_ref", no_fallback)
        q = torch.zeros((1, 4, 2, 16),
                        dtype=torch.bfloat16).as_subclass(_OnCuda)
        lse = torch.zeros((1, 2, 4)).as_subclass(_OnCuda)
        pos = torch.arange(4, dtype=torch.int32).as_subclass(_OnCuda)
        calls = [lambda: fa.flash_attention_fwd_lse(q, q, q, qpos=pos,
                                                    kpos=pos),
                 lambda: fa.flash_attention_backward(q, q, q, q, lse, q,
                                                     qpos=pos, kpos=pos)]
        counter = fa.flash_attention_backward
        forward_launches = fa.flash_attention.launches
    before = counter.launches
    for call in calls:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert counter.launches == before
    if kernel == "flash_attention_backward":
        assert fa.flash_attention.launches == forward_launches
