"""The port's GLA recurrence (models/recurrence.py) against the JAX package's,
and ops.gla on CPU tensors (the kernel's plain version, gla_scan_ref)
against the Pallas kernel in interpret mode, with the same numpy inputs on
both sides and the tolerances of tests/test_recurrence.py and
tests/test_kernels.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.gla_scan import gla_pallas  # noqa: E402
from repro.models import recurrence as jrec  # noqa: E402
from repro_torch.kernels import gla_scan as gs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import recurrence as rec  # noqa: E402

# tests/test_recurrence.py: chunked vs sequential at 5e-4 / 1e-3
ATOL, RTOL = 5e-4, 1e-3
# tests/test_kernels.py: the Pallas kernel vs its oracle
KERNEL_TOL = {"float32": (7e-4, 2e-3), "bfloat16": (0.15, 5e-2)}


def _inputs(B, T, H, K, V, seed=0, clip=(-4, 2), dtype="float32"):
    """tests/test_recurrence.py's draw, as numpy f32 (r, k, v rounded to
    ``dtype`` once, so both sides see the same numbers)."""
    rng = np.random.RandomState(seed)
    r = rng.randn(B, T, H, K).astype(np.float32)
    k = (rng.randn(B, T, H, K) * 0.3).astype(np.float32)
    v = rng.randn(B, T, H, V).astype(np.float32)
    logw = -np.exp(rng.randn(B, T, H, K).astype(np.float32).clip(*clip))
    u = (rng.randn(H, K) * 0.1).astype(np.float32)
    if dtype == "bfloat16":
        r, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                   for x in (r, k, v))
    return r, k, v, logw.astype(np.float32), u


def _jax(*xs, dtype="float32"):
    return [None if x is None else jnp.asarray(x, getattr(jnp, dtype))
            for x in xs]


def _torch(*xs, dtype="float32"):
    return [None if x is None else torch.from_numpy(x).to(
        getattr(torch, dtype)) for x in xs]


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=rtol)


CHUNKED_CASES = [
    # (B, T, H, K, V, chunk, use_u, seed): test_recurrence.py's sweep
    (1, 8, 1, 4, 4, 8, True, 0),
    (2, 32, 3, 16, 8, 16, False, 1),
    (3, 64, 2, 4, 8, 32, True, 2),
    (1, 96, 1, 16, 4, 32, True, 3),
    (2, 96, 2, 16, 8, 96, False, 5),
]


@pytest.mark.parametrize("B,T,H,K,V,chunk,use_u,seed", CHUNKED_CASES)
def test_gla_chunked_matches_jax(B, T, H, K, V, chunk, use_u, seed):
    r, k, v, logw, u = _inputs(B, T, H, K, V, seed)
    u = u if use_u else None
    y_j, s_j = jrec.gla_chunked(*_jax(r, k, v, logw, u), chunk=chunk)
    y, s = rec.gla_chunked(*_torch(r, k, v, logw, u), chunk=chunk)
    _close(y, y_j)
    _close(s, s_j)
    with pytest.raises(ValueError, match="divisible"):
        rec.gla_chunked(*_torch(r, k, v, logw, u), chunk=T - 1)


@pytest.mark.parametrize("use_u", [True, False])
def test_gla_step_and_ref_match_jax(use_u):
    B, T, H, K, V = 2, 12, 3, 8, 4
    r, k, v, logw, u = _inputs(B, T, H, K, V, seed=6)
    u = u if use_u else None
    state = np.random.RandomState(9).randn(B, H, K, V).astype(np.float32)
    args_j, args_t = _jax(r, k, v, logw), _torch(r, k, v, logw)
    y_j, s_j = jrec.gla_step(jnp.asarray(state), *(a[:, 0] for a in args_j),
                             None if u is None else jnp.asarray(u))
    st = torch.from_numpy(state)
    y, s = rec.gla_step(st, *(a[:, 0] for a in args_t),
                        None if u is None else torch.from_numpy(u))
    _close(y, y_j, 1e-5, 1e-5)
    _close(s, s_j, 1e-5, 1e-5)
    assert torch.equal(st, torch.from_numpy(state))  # not written in place
    y_j, s_j = jrec.gla_ref(*_jax(r, k, v, logw, u),
                            initial_state=jnp.asarray(state))
    y, s = rec.gla_ref(*_torch(r, k, v, logw, u), initial_state=st)
    _close(y, y_j, 1e-5, 1e-5)
    _close(s, s_j, 1e-5, 1e-5)


@pytest.mark.parametrize("logw_value", [-60.0, -float(np.exp(6.0))])
def test_extreme_decay_is_stable_and_matches_the_oracle(logw_value):
    """w -> 0 (RWKV6's clip allows -exp(6) ~ -403 a step): every exponent is
    <= 0, so nothing overflows, and ops.gla (the kernel's form) agrees with
    JAX's sequential oracle at the kernel tolerance."""
    B, T, H, K, V = 1, 64, 2, 8, 8
    r, k, v, _, u = _inputs(B, T, H, K, V, seed=3)
    logw = np.full((B, T, H, K), logw_value, np.float32)
    y, s = rec.gla_chunked(*_torch(r, k, v, logw, u), chunk=32)
    assert bool(torch.isfinite(y).all() and torch.isfinite(s).all())
    y_r, s_r = jrec.gla_ref(*_jax(r, k, v, logw, u))
    y_k, s_k = ops.gla(*_torch(r, k, v, logw, u))
    atol, rtol = KERNEL_TOL["float32"]
    _close(y_k, y_r, atol, rtol)
    _close(s_k, s_r, atol, rtol)
    if logw_value == -60.0:   # tests/test_recurrence.py's case
        y_j, s_j = jrec.gla_chunked(*_jax(r, k, v, logw, u), chunk=32)
        _close(y, y_j)
        _close(s, s_j)


def test_difference_form_loses_the_adjacent_exponent_at_extreme_decay():
    """A fault of the reference arithmetic: with cw_prev = cw - logw, the
    adjacent pair's exponent cw_prev_t - cw_{t-1} (exactly 0 in exact
    arithmetic) is the rounding error of |cw| ~ 1.3e4, so at logw = -exp(6)
    JAX's gla_chunked is ~6e-3 off its own sequential oracle at K = 64. The
    kernel's form (``shifted_prev=True``: cw_prev_t is cw_{t-1} itself)
    stays within 1e-4."""
    B, T, H, K, V = 2, 96, 4, 64, 64
    r, k, v, _, u = _inputs(B, T, H, K, V, seed=3)
    logw = np.full((B, T, H, K), -float(np.exp(6.0)), np.float32)
    y_r, _ = jrec.gla_ref(*_jax(r, k, v, logw, u))
    y_j, _ = jrec.gla_chunked(*_jax(r, k, v, logw, u), chunk=32)
    assert np.abs(np.asarray(y_j) - np.asarray(y_r)).max() > 1e-3
    y, _ = rec.gla_chunked(*_torch(r, k, v, logw, u), chunk=32,
                           shifted_prev=True)
    _close(y, y_r, 1e-4, 1e-4)


def test_no_decay_reduces_to_linear_attention():
    B, T, H, K, V = 1, 16, 1, 4, 4
    r, k, v, _, _ = _inputs(B, T, H, K, V, seed=4)
    logw = np.zeros((B, T, H, K), np.float32)
    _, s = rec.gla_chunked(*_torch(r, k, v, logw), chunk=8)
    _close(s, np.einsum("bthk,bthv->bhkv", k, v), 1e-4, 1e-3)


def test_initial_state_carries_as_in_jax():
    """Splitting a sequence and carrying the state equals the one-shot
    computation, in the port as in JAX, for gla_chunked and ops.gla."""
    B, T, H, K, V = 2, 64, 2, 8, 8
    r, k, v, logw, u = _inputs(B, T, H, K, V, seed=7)
    t = _torch(r, k, v, logw)
    uu = torch.from_numpy(u)
    y_full, s_full = rec.gla_chunked(*t, uu, chunk=16)
    y1, s1 = rec.gla_chunked(*(x[:, :32] for x in t), uu, chunk=16)
    y2, s2 = rec.gla_chunked(*(x[:, 32:] for x in t), uu, chunk=16,
                             initial_state=s1)
    _close(torch.cat([y1, y2], 1), y_full.numpy())
    _close(s2, s_full.numpy())
    j = _jax(r, k, v, logw)
    _, js1 = jrec.gla_chunked(*(x[:, :32] for x in j), jnp.asarray(u),
                              chunk=16)
    jy2, js2 = jrec.gla_chunked(*(x[:, 32:] for x in j), jnp.asarray(u),
                                chunk=16, initial_state=js1)
    _close(y2, jy2)
    _close(s2, js2)
    ky2, ks2 = ops.gla(*(x[:, 32:] for x in t), uu, initial_state=s1)
    _close(ky2, jy2)
    _close(ks2, js2)


# tests/test_kernels.py GLA_SHAPES: (B, T, H, K, V, chunk)
GLA_SHAPES = [
    (1, 64, 1, 8, 8, 16),
    (2, 128, 3, 16, 32, 32),
    (1, 256, 2, 64, 64, 64),
    (2, 96, 2, 16, 16, 32),
]


@pytest.mark.parametrize("B,T,H,K,V,chunk", GLA_SHAPES)
@pytest.mark.parametrize("use_u", [True, False])
def test_ops_gla_matches_pallas(B, T, H, K, V, chunk, use_u):
    r, k, v, logw, u = _inputs(B, T, H, K, V, seed=0, clip=(-3, 1))
    u = u if use_u else None
    y_j, s_j = gla_pallas(*_jax(r, k, v, logw, u), chunk=chunk,
                          interpret=True)
    y, s = ops.gla(*_torch(r, k, v, logw, u))
    atol, rtol = KERNEL_TOL["float32"]
    _close(y, y_j, atol, rtol)
    _close(s, s_j, atol, rtol)
    assert y.dtype == torch.float32 and s.dtype == torch.float32


def test_ops_gla_bf16_matches_pallas():
    B, T, H, K, V = 1, 64, 2, 16, 16
    r, k, v, logw, _ = _inputs(B, T, H, K, V, seed=3, clip=(-3, 1),
                               dtype="bfloat16")
    y_j, s_j = gla_pallas(*_jax(r, k, v, dtype="bfloat16"),
                          jnp.asarray(logw), None, chunk=32, interpret=True)
    y, s = ops.gla(*_torch(r, k, v, dtype="bfloat16"),
                   torch.from_numpy(logw))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    atol, rtol = KERNEL_TOL["bfloat16"]
    _close(y, y_j, atol, rtol)
    _close(s, s_j, atol, rtol)


@pytest.mark.parametrize("T,use_u,init", [(77, True, True), (5, False, True),
                                          (45, False, False)])
def test_ops_gla_ragged_T_matches_jax_chunk_T(T, use_u, init):
    """T that 32 does not divide: the kernel (and gla_scan_ref) mask the
    last chunk; JAX's models take chunk = T. Same function."""
    B, H, K, V = 2, 3, 16, 32
    r, k, v, logw, u = _inputs(B, T, H, K, V, seed=8)
    u = u if use_u else None
    s0 = (np.random.RandomState(2).randn(B, H, K, V).astype(np.float32)
          if init else None)
    y_j, s_j = jrec.gla_chunked(
        *_jax(r, k, v, logw, u), chunk=T,
        initial_state=None if s0 is None else jnp.asarray(s0))
    y, s = ops.gla(*_torch(r, k, v, logw, u),
                   initial_state=None if s0 is None
                   else torch.from_numpy(s0))
    atol, rtol = KERNEL_TOL["float32"]
    _close(y, y_j, atol, rtol)
    _close(s, s_j, atol, rtol)
    assert y.shape == (B, T, H, V)


def test_make_gla_picks_the_implementation():
    B, T, H, K, V = 1, 40, 2, 8, 8
    t = _torch(*_inputs(B, T, H, K, V, seed=1)[:4])
    y_c, s_c = rec.make_gla("chunked")(*t)
    y_w, s_w = rec.gla_chunked(*t, chunk=T)            # 32 does not divide
    assert torch.equal(y_c, y_w) and torch.equal(s_c, s_w)
    assert rec.make_gla("kernel") is ops.gla
    y_k, s_k = rec.make_gla("kernel")(*t)
    _close(y_k, y_c.numpy(), 1e-5, 1e-4)
    _close(s_k, s_c.numpy(), 1e-5, 1e-4)
    with pytest.raises(ValueError, match="gla_impl"):
        rec.make_gla("pallas")


def test_gla_scan_ref_pads_to_the_kernel_chunk():
    """The plain version runs chunks of gs.CHUNK whatever T is; padding rows
    (r = k = v = logw = 0) leave the state and y of the real rows as the
    sequential oracle has them."""
    B, T, H, K, V = 1, 33, 1, 8, 8
    t = _torch(*_inputs(B, T, H, K, V, seed=5)[:4])
    y, s = gs.gla_scan_ref(*t)
    y_r, s_r = rec.gla_ref(*t)
    assert y.shape == (B, T, H, V)
    _close(y, y_r.numpy(), 1e-5, 1e-4)
    _close(s, s_r.numpy(), 1e-5, 1e-4)
