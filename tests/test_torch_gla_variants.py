"""The GLA-scan kernels' dispatch, and the tc kernel's arithmetic on the CPU.

``_tc_arithmetic`` transcribes what ``gla_fwd_tc`` (csrc/gla_scan.cu)
computes, in plain torch: chunks of 32 cut into two sub-chunks of 16; A
factored at b = cw_15 into two bf16 factors r e^{cwp - b} and k e^{b - cw},
whose exponents are both <= 0 where the sub-chunks meet (clamped there at
0, which acts only on a positive logw) and within +-64 log2 inside a
sub-chunk whose decay spans no more (a "safe" one);
per-element exponents inside any other sub-chunk; the u term on A's
diagonal, A rounded to bf16, r e^{cwp} and k e^{cw_last - cw} rounded to
bf16, S rounded to bf16 only as the operand of the inter-chunk product,
f32 sums. It is held against the JAX package's sequential
oracle ``gla_ref`` and its Pallas kernel in interpret mode, on the same
numpy inputs, at the bf16 tolerance of tests/test_kernels.py: the
factorisation is exponent-safe before any card runs it."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.gla_scan import gla_pallas  # noqa: E402
from repro.models import recurrence as jrec  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import gla_scan as gs  # noqa: E402

# tests/test_kernels.py: the Pallas GLA kernel in bf16 against its oracle
ATOL, RTOL = 0.15, 5e-2
SUB = 16
WIDE = 64 * float(np.log(2.0))   # the kernel's kWide, in nats


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _tc_arithmetic(r, k, v, logw, u=None, initial_state=None):
    """gla_fwd_tc's arithmetic on f32 tensors holding bf16 values: r/k/logw
    (B, T, H, K), v (B, T, H, V) -> (y rounded to bf16, f32 state)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    C = gs.CHUNK
    pad = -T % C
    r, k, v, logw = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                     for x in (r, k, v, logw))
    uf = torch.ones((H, K)) if u is None else u
    S = (torch.zeros((B, H, K, V)) if initial_state is None
         else initial_state.clone())
    lower = torch.tril(torch.ones((SUB, SUB)), diagonal=-1)
    eye = torch.eye(C)
    # the factors' exponent caps by row: 0 on the rows that meet across
    # the sub-chunks (r's second sub-chunk, k's first), else WIDE
    second = (torch.arange(C) >= SUB)[:, None]
    cap_q = torch.where(second, 0.0, WIDE)
    cap_k = torch.where(second, WIDE, 0.0)
    ys = []
    for t0 in range(0, T + pad, C):
        rb, kb, wb = (x[:, t0:t0 + C].permute(0, 2, 1, 3)
                      for x in (r, k, logw))            # (B, H, C, K)
        vb = v[:, t0:t0 + C].permute(0, 2, 1, 3)        # (B, H, C, V)
        cw = torch.cumsum(wb, dim=2)
        cwp = torch.cat([torch.zeros_like(cw[:, :, :1]), cw[:, :, :-1]],
                        dim=2)                          # cw_{t-1} itself
        last = cw[:, :, -1:]
        ref = cw[:, :, SUB - 1:SUB]                     # b = cw_15
        rq = _bf16(rb * torch.exp(cwp))
        ks = _bf16(kb * torch.exp(last - cw))
        qf = _bf16(rb * torch.exp(torch.minimum(cwp - ref, cap_q)))
        kf = _bf16(kb * torch.exp(torch.minimum(ref - cw, cap_k)))
        A = torch.einsum("bhtk,bhjk->bhtj", qf, kf)
        wide = (((-ref) > WIDE).any(dim=-1)[..., 0],          # (B, H)
                ((ref - last) > WIDE).any(dim=-1)[..., 0])
        for s, w in zip((slice(0, SUB), slice(SUB, C)), wide):
            e = (cwp[:, :, s, None, :] - cw[:, :, None, s, :]).clamp(max=0.0)
            per_element = torch.einsum("bhtk,bhjk,bhtjk->bhtj", rb[:, :, s],
                                       kb[:, :, s], torch.exp(e))
            A[:, :, s, s] = torch.where(w[..., None, None], per_element,
                                        A[:, :, s, s]) * lower
        A[:, :, :SUB, SUB:] = 0.0
        du = torch.einsum("bhtk,hk,bhtk->bht", rb, uf, kb)
        A = _bf16(A + du[..., None] * eye)
        y = (torch.einsum("bhtk,bhkv->bhtv", rq, _bf16(S))
             + torch.einsum("bhtj,bhjv->bhtv", A, vb))
        ys.append(_bf16(y))
        S = S * torch.exp(last[:, :, 0, :, None]) + torch.einsum(
            "bhtk,bhtv->bhkv", ks, vb)
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)[:, :T]
    return y, S


def _inputs(B, T, H, K, V, seed, logw_const=None):
    """tests/test_kernels.py's draw; r, k, v rounded to bf16 once, so both
    sides see the same numbers. ``logw_const`` "wide" draws decays of up to
    e^20 a step, so that some sub-chunks are safe and some not."""
    rng = np.random.RandomState(seed)
    r = rng.randn(B, T, H, K).astype(np.float32)
    k = (rng.randn(B, T, H, K) * 0.3).astype(np.float32)
    v = rng.randn(B, T, H, V).astype(np.float32)
    if logw_const is None:
        logw = -np.exp(rng.randn(B, T, H, K).clip(-3, 1)).astype(np.float32)
    elif logw_const == "wide":
        logw = -np.exp((2 * rng.randn(B, T, H, K)).clip(-3, 3)).astype(
            np.float32)
    else:
        logw = np.full((B, T, H, K), logw_const, np.float32)
    u = (rng.randn(H, K) * 0.1).astype(np.float32)
    s0 = rng.randn(B, H, K, V).astype(np.float32)
    r, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
               for x in (r, k, v))
    return r, k, v, logw, u, s0


def _close(port, ref):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=ATOL,
                               rtol=RTOL)


def _check_against_jax(B, T, H, K, V, use_u, init, logw_const, seed):
    r, k, v, logw, u, s0 = _inputs(B, T, H, K, V, seed, logw_const)
    u = u if use_u else None
    s0 = s0 if init else None
    t = [None if x is None else torch.from_numpy(x)
         for x in (r, k, v, logw, u, s0)]
    y, s = _tc_arithmetic(*t[:5], initial_state=t[5])
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    j = [None if x is None else jnp.asarray(x) for x in (r, k, v, logw, u)]
    y_r, s_r = jrec.gla_ref(*j, initial_state=None if s0 is None
                            else jnp.asarray(s0))
    _close(y, y_r)
    _close(s, s_r)
    if T % gs.CHUNK == 0 and s0 is None:   # the Pallas kernel's domain
        y_p, s_p = gla_pallas(*j, chunk=gs.CHUNK, interpret=True)
        _close(y, y_p)
        _close(s, s_p)


@pytest.mark.parametrize("use_u,init", [(False, False), (True, False),
                                        (False, True), (True, True)])
@pytest.mark.parametrize("T", [64, 77])
@pytest.mark.parametrize("K,V", [(16, 16), (16, 64), (64, 16), (64, 64)])
def test_tc_arithmetic_matches_jax(K, V, T, use_u, init):
    _check_against_jax(1, T, 2, K, V, use_u, init, None, seed=K + V + T)


@pytest.mark.parametrize("T", [64, 77])
@pytest.mark.parametrize("logw_const", [-60.0, -float(np.exp(6.0)), "wide"])
@pytest.mark.parametrize("K,V", [(16, 64), (64, 64)])
def test_tc_arithmetic_is_exponent_safe_at_extreme_decay(K, V, logw_const,
                                                          T):
    """A step's decay of e^-60 or e^-403 (RWKV6's strongest): a chunk's cw
    reaches ~-1.3e4, every sub-chunk takes its pairs per element, the
    factors across the sub-chunks keep exponents <= 0, so nothing
    overflows, and the adjacent pair keeps its exact 0 exponent across the
    sub-chunk boundary (t = 16, j = 15: both factors are e^0). "wide" mixes
    safe and unsafe sub-chunks."""
    _check_against_jax(2, T, 2, K, V, True, True, logw_const, seed=7)


def test_tc_arithmetic_matches_the_plain_version():
    """At the plain version's own bf16 inputs the two differ only by the tc
    kernel's roundings."""
    r, k, v, logw, u, s0 = (torch.from_numpy(x) for x in
                            _inputs(2, 100, 3, 64, 64, seed=11))
    y, s = _tc_arithmetic(r, k, v, logw, u, s0)
    y_ref, s_ref = gs.gla_scan_ref(r.bfloat16(), k.bfloat16(), v.bfloat16(),
                                   logw, u, initial_state=s0)
    _close(y, y_ref.float())
    _close(s, s_ref)


def test_choose_variant():
    assert gs.choose_variant(torch.bfloat16) == "tc"
    assert gs.choose_variant(torch.float32) == "simt"


def test_variant_arguments_are_checked():
    z = torch.zeros((1, 4, 2, 16))
    v = torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError, match="variant"):
        gs.gla_scan(z, z, v, z, variant="wgmma")
    with pytest.raises(TypeError, match="bfloat16"):
        gs.gla_scan(z, z, v, z, variant="tc")
    zb, vb = z.bfloat16(), v.bfloat16()
    # the CPU path runs the plain version whatever kernel is named
    for variant in ("simt", "tc", None):
        y, s = gs.gla_scan(zb, zb, vb, z, variant=variant)
        assert y.dtype == torch.bfloat16 and s.dtype == torch.float32


def test_launch_counts_by_variant_start_at_zero_per_variant():
    assert tuple(gs.gla_scan.launches_by_variant) == gs.VARIANTS == (
        "tc", "simt")
    assert all(isinstance(n, int)
               for n in gs.gla_scan.launches_by_variant.values())


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,variant", [
    (torch.bfloat16, None), (torch.bfloat16, "tc"),
    (torch.bfloat16, "simt"), (torch.float32, None),
    (torch.float32, "simt")])
def test_every_variant_launches_or_raises(dtype, variant, tmp_path,
                                          monkeypatch):
    """On a CUDA tensor each variant builds and launches its kernel or
    raises; nvcc is missing here, so it raises before any launch or count,
    and the plain version never runs."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))

    def no_fallback(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(gs, "gla_scan_ref", no_fallback)
    rk = torch.zeros((1, 8, 2, 16), dtype=dtype).as_subclass(_OnCuda)
    v = torch.zeros((1, 8, 2, 32), dtype=dtype).as_subclass(_OnCuda)
    w = torch.zeros((1, 8, 2, 16)).as_subclass(_OnCuda)
    before = dict(gs.gla_scan.launches_by_variant)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gs.gla_scan(rk, rk, v, w, variant=variant)
    assert gs.gla_scan.launches_by_variant == before
