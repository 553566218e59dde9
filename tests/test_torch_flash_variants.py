"""The flash-attention kernels' dispatch and the split kernel's plain
version: ``flash_decode_ref`` (per-split partials and their merge) against
``flash_attention_ref`` and against the JAX package's Pallas kernel in
interpret mode, on the same numpy inputs; ``choose_variant`` and
``decode_splits`` at the serving shapes."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# tests/test_kernels.py: f32 atol 2e-5, rtol 1e-2
ATOL, RTOL = 2e-5, 1e-2
N_SPLITS = [1, 2, 3, 7]


def _ring(C, last):
    """kpos of a C-slot ring after positions 0..last (slot p % C holds the
    newest p, -1 where nothing was written): wrapped, so not sorted."""
    kpos = np.full(C, -1, np.int32)
    p = np.arange(max(0, last + 1 - C), last + 1)
    kpos[p % C] = p
    return kpos


def _causal(Sk, pos):
    return np.where(np.arange(Sk) <= pos, np.arange(Sk), -1).astype(np.int32)


# name -> (B, H, G, D, Sk, qpos, kpos, window); Sk tiles by 64 so the Pallas
# kernel takes it (block_q=1, block_k=64)
DECODE_CASES = {
    "one_head_a_group": (2, 3, 3, 32, 128, 90, _causal(128, 90), 0),
    "four_heads_a_group": (2, 8, 2, 32, 192, 150, _causal(192, 150), 0),
    "five_heads_window": (2, 10, 2, 64, 256, 200, np.arange(256,
                                                            dtype=np.int32),
                          48),
    "wrapped_ring": (2, 10, 2, 32, 128, 300, _ring(128, 300), 128),
    # the first tile's slots are empty: the first split(s) see no key
    "masked_first_tile": (1, 4, 1, 16, 192, 170,
                          np.where(np.arange(192) < 64, -1,
                                   np.arange(192)).astype(np.int32), 0),
}


def _inputs(seed, B, H, G, D, Sk):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 1, H, D).astype(np.float32),
            rng.randn(B, Sk, G, D).astype(np.float32),
            rng.randn(B, Sk, G, D).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _pallas(name):
    """The JAX package's Pallas kernel on one decode case (cached: the four
    n_split cases share it)."""
    B, H, G, D, Sk, pos, kpos, window = DECODE_CASES[name]
    q, k, v = _inputs(len(name), B, H, G, D, Sk)
    out = jax_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, qpos=jnp.asarray([pos], jnp.int32),
        kpos=jnp.asarray(kpos), block_q=1, block_k=64, interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("n_split", N_SPLITS)
@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_ref_matches_plain_version_and_pallas(name, n_split):
    B, H, G, D, Sk, pos, kpos, window = DECODE_CASES[name]
    q, k, v = (torch.from_numpy(a) for a in _inputs(len(name), B, H, G, D,
                                                      Sk))
    kw = dict(causal=True, window=window,
              qpos=torch.tensor([pos], dtype=torch.int32),
              kpos=torch.from_numpy(kpos))
    out = fa.flash_decode_ref(q, k, v, n_split=n_split, **kw)
    np.testing.assert_allclose(out.numpy(),
                               fa.flash_attention_ref(q, k, v, **kw).numpy(),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out.numpy(), _pallas(name), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("n_split", N_SPLITS)
@pytest.mark.parametrize("Sk", [1, 40, 100, 203])
def test_decode_ref_ragged_keys(Sk, n_split):
    """Sk that no tile size divides (the serving cache has 544 slots): the
    last range is short, and ranges past the last tile are empty."""
    B, H, G, D = 2, 8, 2, 32
    q, k, v = (torch.from_numpy(a) for a in _inputs(Sk, B, H, G, D, Sk))
    kw = dict(causal=True, qpos=torch.tensor([Sk - 1], dtype=torch.int32),
              kpos=torch.arange(Sk, dtype=torch.int32))
    np.testing.assert_allclose(
        fa.flash_decode_ref(q, k, v, n_split=n_split, **kw).numpy(),
        fa.flash_attention_ref(q, k, v, **kw).numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n_split", N_SPLITS)
def test_decode_ref_row_with_no_valid_key_is_zero(n_split):
    """Every key masked in every range: m = NEG_INF, l = 0 everywhere, and
    the merge gives exactly 0, not NaN."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(7, 2, 4, 2, 16, 300))
    out = fa.flash_decode_ref(q, k, v, n_split=n_split, causal=True,
                              qpos=torch.tensor([-5], dtype=torch.int32))
    assert bool((out == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_ref_keeps_the_input_dtype(dtype):
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _inputs(8, 1, 4, 1, 32, 64))
    out = fa.flash_decode_ref(q, k, v, n_split=2,
                              qpos=torch.tensor([63], dtype=torch.int32))
    assert out.dtype == dtype and out.shape == q.shape
    ref = fa.flash_attention_ref(q, k, v,
                                 qpos=torch.tensor([63], dtype=torch.int32))
    atol = 2e-2 if dtype == torch.bfloat16 else ATOL
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               atol=atol, rtol=RTOL)


def test_decode_ref_rejects_no_split():
    q, k, v = (torch.from_numpy(a) for a in _inputs(9, 1, 2, 1, 16, 8))
    with pytest.raises(ValueError, match="n_split"):
        fa.flash_decode_ref(q, k, v, n_split=0)


# the serving runs' attention calls: (B, Sq, Sk, H, G, dtype) -> (variant,
# n_split on a 132-SM H100)
SERVING = {
    "qwen3_prefill": ((8, 512, 512, 32, 8, torch.bfloat16), ("tc", None)),
    "qwen3_decode": ((8, 1, 544, 32, 8, torch.bfloat16), ("split", 9)),
    "hymba_prefill": ((8, 2048, 2048, 25, 5, torch.bfloat16), ("tc", None)),
    "hymba_decode": ((8, 1, 1024, 25, 5, torch.bfloat16), ("split", 16)),
}


@pytest.mark.parametrize("name", sorted(SERVING))
def test_variant_and_splits_at_the_serving_shapes(name):
    (B, Sq, Sk, H, G, dtype), (variant, n_split) = SERVING[name]
    assert fa.choose_variant(dtype, Sq) == variant
    if variant == "split":
        got = fa.decode_splits(B, G, Sk, 132)
        assert got == n_split
        tiles = -(-Sk // fa.TILE_KEYS)
        per = -(-tiles // got)
        assert per == 1                     # one tile a block
        assert B * G * got <= fa.DECODE_BLOCKS_PER_SM * 132  # one wave


@pytest.mark.parametrize("Sq,dtype,variant", [
    (1, torch.float32, "split"), (1, torch.bfloat16, "split"),
    (2, torch.float32, "simt"), (512, torch.float32, "simt"),
    (2, torch.bfloat16, "tc"), (2048, torch.bfloat16, "tc")])
def test_choose_variant(Sq, dtype, variant):
    assert fa.choose_variant(dtype, Sq) == variant


@pytest.mark.parametrize("B,G,Sk,n_sm,want", [
    (1, 1, 1, 132, 1),          # one key: one range
    (1, 1, 64 * 1000, 132, 500),  # 660 ranges wanted: 2 tiles each
    (64, 64, 4096, 132, 1),     # the grid fills the card without a split
    (8, 8, 544, 78, 5),         # fewer SMs: 6 ranges wanted, 2 tiles each
])
def test_decode_splits(B, G, Sk, n_sm, want):
    got = fa.decode_splits(B, G, Sk, n_sm)
    assert got == want
    tiles = -(-Sk // fa.TILE_KEYS)
    assert 1 <= got <= tiles
    per = -(-tiles // got)
    assert (got - 1) * per < tiles          # no empty range


def test_variant_argument_is_checked():
    q = torch.zeros((1, 4, 2, 16))
    kv = torch.zeros((1, 4, 1, 16))
    with pytest.raises(ValueError, match="variant"):
        fa.flash_attention(q, kv, kv, variant="wgmma")
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(q, kv, kv, variant="tc")
    with pytest.raises(ValueError, match="Sq == 1"):
        fa.flash_attention(q, kv, kv, variant="split")
    # the CPU path runs the plain version whatever kernel is named
    out = fa.flash_attention(q.bfloat16(), kv.bfloat16(), kv.bfloat16(),
                             variant="simt")
    assert out.dtype == torch.bfloat16


def test_launch_counts_by_variant_start_at_zero_per_variant():
    assert set(fa.flash_attention.launches_by_variant) == set(fa.VARIANTS)
    assert all(isinstance(n, int)
               for n in fa.flash_attention.launches_by_variant.values())


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("Sq,dtype", [(1, torch.float32),
                                      (1, torch.bfloat16),
                                      (4, torch.bfloat16),
                                      (4, torch.float32)])
def test_every_variant_launches_or_raises(Sq, dtype, tmp_path, monkeypatch):
    """On a CUDA tensor each variant builds and launches its kernel or
    raises; nvcc is missing here, so it raises before any launch or count,
    and neither plain version runs."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))

    def no_fallback(*a, **k):
        raise AssertionError("fell back to a plain version")

    monkeypatch.setattr(fa, "flash_attention_ref", no_fallback)
    monkeypatch.setattr(fa, "flash_decode_ref", no_fallback)
    q = torch.zeros((1, Sq, 4, 16), dtype=dtype).as_subclass(_OnCuda)
    kv = torch.zeros((1, 8, 2, 16), dtype=dtype).as_subclass(_OnCuda)
    qpos = torch.arange(Sq, dtype=torch.int32).as_subclass(_OnCuda)
    kpos = torch.arange(8, dtype=torch.int32).as_subclass(_OnCuda)
    before = dict(fa.flash_attention.launches_by_variant)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa.flash_attention(q, kv, kv, qpos=qpos, kpos=kpos)
    assert fa.flash_attention.launches_by_variant == before
