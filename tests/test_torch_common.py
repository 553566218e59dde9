"""The port's models/common.py against repro.models.common, in f32 on the
CPU, with the same numpy inputs on both sides."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import common as jcm  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402

# f32 on both sides; only the order of f32 sums differs
ATOL, RTOL = 2e-5, 1e-5


def _both(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol,
                               rtol=RTOL)


def test_rms_norm():
    rng = np.random.RandomState(0)
    jx, tx = _both(rng.randn(2, 5, 64) * 3)
    js, ts = _both(rng.rand(64) + 0.5)
    _close(tcm.rms_norm(tx, ts), jcm.rms_norm(jx, js))


def test_layer_norm():
    rng = np.random.RandomState(1)
    jx, tx = _both(rng.randn(2, 5, 64) * 3 + 1)
    js, ts = _both(rng.rand(64) + 0.5)
    jb, tb = _both(rng.randn(64))
    _close(tcm.layer_norm(tx, ts, tb), jcm.layer_norm(jx, js, jb))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(theta):
    rng = np.random.RandomState(2)
    jx, tx = _both(rng.randn(2, 33, 4, 16))
    pos = np.arange(7, 40)
    np.testing.assert_array_equal(tcm.rope_freqs(16, theta),
                                  jcm.rope_freqs(16, theta))
    _close(tcm.apply_rope(tx, torch.from_numpy(pos), theta),
           jcm.apply_rope(jx, jnp.asarray(pos), theta), atol=1e-4)


ATTN_CASES = [
    # (B, Sq, Sk, H, G, D, causal, window, qoff, kvalid)
    (2, 32, 32, 4, 2, 16, True, 0, 0, None),
    (1, 16, 48, 4, 1, 32, False, 0, 0, None),     # cross, MQA
    (2, 64, 64, 8, 2, 16, True, 16, 0, None),     # sliding window
    (2, 1, 40, 4, 2, 16, True, 0, 30, 31),        # decode vs a ring cache
    (1, 8, 16, 2, 2, 16, True, 0, -4, None),      # rows with no valid key
]


def _attn_inputs(B, Sq, Sk, H, G, D, qoff, kvalid, seed):
    rng = np.random.RandomState(seed)
    q = _both(rng.randn(B, Sq, H, D))
    k = _both(rng.randn(B, Sk, G, D))
    v = _both(rng.randn(B, Sk, G, D))
    qpos = np.arange(Sq) + qoff
    kpos = np.arange(Sk)
    if kvalid is not None:
        kpos = np.where(kpos < kvalid, kpos, -1)
    return q, k, v, _both(qpos.astype(np.int32)), _both(kpos.astype(np.int32))


@pytest.mark.parametrize("impl", ["ref", "chunked"])
@pytest.mark.parametrize("B,Sq,Sk,H,G,D,causal,window,qoff,kvalid",
                         ATTN_CASES)
def test_attention(impl, B, Sq, Sk, H, G, D, causal, window, qoff, kvalid):
    (jq, tq), (jk, tk), (jv, tv), (jqp, tqp), (jkp, tkp) = _attn_inputs(
        B, Sq, Sk, H, G, D, qoff, kvalid, seed=3)
    kw = dict(causal=causal, window=window)
    jfn, tfn = getattr(jcm, f"attention_{impl}"), getattr(
        tcm, f"attention_{impl}")
    extra = {"block_k": 16} if impl == "chunked" else {}
    ref = jfn(jq, jk, jv, qpos=jqp.astype(jnp.int32), kpos=jkp, **kw,
              **extra)
    out = tfn(tq, tk, tv, qpos=tqp, kpos=tkp, **kw, **extra)
    _close(out, ref)


@pytest.mark.parametrize("S,W", [(64, 16), (96, 32)])
def test_attention_banded(S, W):
    (jq, tq), (jk, tk), (jv, tv), _, _ = _attn_inputs(
        2, S, S, 4, 2, 16, 0, None, seed=4)
    _close(tcm.attention_banded(tq, tk, tv, window=W),
           jcm.attention_banded(jq, jk, jv, window=W))


def test_make_attention_routes_flash_to_the_kernel_wrapper():
    from repro_torch.kernels import ops
    fn = tcm.make_attention("flash", causal=True)
    assert fn.func is ops.flash_attention
    assert tcm.make_attention("ref") is tcm.attention_ref
    assert tcm.make_attention("chunked") is tcm.attention_chunked
