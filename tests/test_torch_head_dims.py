"""Head dims: every config's attention, at full width and on a
tensor-parallel rank, has a kernel instantiation (``HEAD_DIMS``); the
kernels' plain versions at stablelm-12b's head dim 160 against the JAX
package's Pallas kernel in interpret mode; a narrow stablelm-12b at head
dim 160 against the JAX model; the dry run's stand-ins and the CUDA path
apply one head-dim rule, and at head dim 160 the CUDA path goes to the
kernel, never to a plain version. f32 on the CPU."""
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import meta  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import kv_index  # noqa: E402

ARCHS = sorted(tconfigs.ARCHS)
D160 = 160
# tests/test_torch_kernels.py's GQA check against JAX's ops: atol 3e-5,
# rtol 1e-2 (f32, only the summation order differs)
ATOL, RTOL = 3e-5, 1e-2
# tests/test_torch_transformer.py: f32 on both sides
MODEL_ATOL = MODEL_RTOL = 1e-4


def rank_heads(cfg, M):
    """(q heads, kv heads) of a rank of M on 'model': gcd(H, M) head
    groups, each reading the kv heads ``kv_index`` gives it (as the tp
    runs of chip_smoke.py place them)."""
    T = math.gcd(cfg.n_heads, M)
    Hl = cfg.n_heads // T
    if T == M and cfg.n_kv_heads % M == 0:
        return Hl, cfg.n_kv_heads // M
    return Hl, len(kv_index(cfg, T, 0))


def test_ten_configs():
    assert len(ARCHS) == 10
    assert {tconfigs.get_config(a).hdim for a in ARCHS} == {64, 128, 160}


@pytest.mark.parametrize("M", [1, 4, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_every_config_head_dim_has_a_kernel(arch, M):
    """The full width (M 1) and a rank of 4 and of 16 'model' ranks: the
    head dim is one the kernels take, and the CUDA path's checks take the
    rank's (B, S, H, D) and (B, S, G, D)."""
    cfg = tconfigs.get_config(arch)
    assert cfg.hdim in fa.HEAD_DIMS
    H, G = rank_heads(cfg, M)
    q = torch.zeros((1, 2, H, cfg.hdim))
    kv = torch.zeros((1, 2, G, cfg.hdim))
    pos = torch.arange(2, dtype=torch.int32)
    fa._check(q, kv, kv, pos, pos)


def _pallas(q, k, v, *, causal, window, qpos, kpos, block_q):
    return np.asarray(jax_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, qpos=jnp.asarray(qpos), kpos=jnp.asarray(kpos),
        block_q=block_q, block_k=64, interpret=True))


def _ring(C, last):
    """kpos of a C-slot ring after positions 0..last, -1 where nothing
    was written."""
    kpos = np.full(C, -1, np.int32)
    p = np.arange(max(0, last + 1 - C), last + 1)
    kpos[p % C] = p
    return kpos


# name -> (causal, window, kpos of 192 keys, the last query's position)
MASKS = {
    "causal": (True, 0, np.arange(192, dtype=np.int32), 191),
    "window": (True, 48, np.arange(192, dtype=np.int32), 191),
    # a ring with -1 slots, wrapped: unsorted positions
    "ring": (True, 0, np.where(np.arange(192) % 5 == 3, -1,
                               _ring(192, 250)).astype(np.int32), 250),
    "cross": (False, 0, np.arange(192, dtype=np.int32), 191),
}
# the plain versions at D 160: prefill (64 queries), decode (one query) as
# the fused split kernel computes it at n_split 1 and 3, and the two-step
# decode of a cache split over 4 ranks
PLAIN = ("attention", "decode_split1", "decode_split3", "partials_merge")


@functools.lru_cache(maxsize=None)
def _d160_inputs(mask, plain):
    causal, window, kpos, last = MASKS[mask]
    B, H, G, Sk = 2, 4, 2, kpos.shape[0]
    Sq = 64 if plain == "attention" else 1
    rng = np.random.RandomState(len(mask) + 7 * len(plain))
    q = rng.randn(B, Sq, H, D160).astype(np.float32)
    k, v = (rng.randn(B, Sk, G, D160).astype(np.float32) for _ in range(2))
    qpos = np.arange(last - Sq + 1, last + 1, dtype=np.int32)
    return q, k, v, qpos, kpos, causal, window


@pytest.mark.parametrize("plain", PLAIN)
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_plain_versions_match_pallas_at_head_dim_160(mask, plain):
    q, k, v, qpos, kpos, causal, window = _d160_inputs(mask, plain)
    ref = _pallas(q, k, v, causal=causal, window=window, qpos=qpos,
                  kpos=kpos, block_q=q.shape[1])
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(causal=causal, window=window, qpos=torch.from_numpy(qpos),
              kpos=torch.from_numpy(kpos))
    if plain == "attention":
        out = fa.flash_attention_ref(tq, tk, tv, **kw)
    elif plain.startswith("decode_split"):
        out = fa.flash_decode_ref(tq, tk, tv, n_split=int(plain[-1]), **kw)
    else:
        B, _, H, _ = q.shape
        C = k.shape[1] // 4
        parts = torch.stack([fa.flash_decode_partials_ref(
            tq, tk[:, r * C:(r + 1) * C], tv[:, r * C:(r + 1) * C],
            causal=causal, window=window, qpos=kw["qpos"],
            kpos=kw["kpos"][r * C:(r + 1) * C]) for r in range(4)])
        assert parts.shape == (4, B * H, 2 + D160)
        out = fa.flash_decode_merge_ref(parts, torch.float32).reshape(
            q.shape)
    assert out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_partials_of_a_rank_with_no_valid_key_merge_to_nothing():
    """A rank whose slots are all empty gives m = NEG_INF, l = 0, acc = 0
    at D 160, and adds nothing to the merge."""
    q, k, v, qpos, kpos, causal, window = _d160_inputs("causal",
                                                      "partials_merge")
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    empty = torch.full((k.shape[1],), -1, dtype=torch.int32)
    full = torch.from_numpy(kpos)
    pos = torch.from_numpy(qpos)
    none = fa.flash_decode_partials_ref(tq, tk, tv, qpos=pos, kpos=empty)
    assert bool((none[:, 0] == fa.NEG_INF).all())
    assert bool((none[:, 1:] == 0).all())
    some = fa.flash_decode_partials_ref(tq, tk, tv, qpos=pos, kpos=full)
    merged = fa.flash_decode_merge_ref(torch.stack([none, some]),
                                       torch.float32)
    alone = fa.flash_decode_merge_ref(some[None], torch.float32)
    assert torch.equal(merged, alone)


# a narrow stablelm-12b: its features (layernorm, full rotary, no QKV
# bias) at head dim 160, 2 heads on 1 kv head
NARROW = dict(head_dim=D160, d_model=320, n_heads=2, n_kv_heads=1,
              n_layers=2)
B, S, CACHE_PAD = 2, 16, 4


def _narrow_cfgs():
    return (jconfigs.get_config("stablelm-12b").smoke().scaled(**NARROW),
            tconfigs.get_config("stablelm-12b").smoke().scaled(**NARROW))


@functools.lru_cache(maxsize=None)
def _jax_side():
    """JAX params (perturbed, so the layernorms' biases and scales carry
    signal) and its forward, prefill and two decode steps."""
    jcfg, _ = _narrow_cfgs()
    assert jcfg.norm == "layernorm" and jcfg.hdim == D160
    model = jax_build(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(7)
    params = jax.tree_util.tree_map(
        lambda a: a + (0.1 * rng.randn(*a.shape)).astype(a.dtype)
        if a.ndim <= 2 and a.shape[-1] != jcfg.padded_vocab
        and a.shape[0] != jcfg.padded_vocab else a, params)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab, (B, S + 2)
                                            ).astype(np.int32)
    jt = jnp.asarray(toks)
    out = {"forward": model.forward(params, {"tokens": jt}, remat=False)}
    out["prefill"], cache = model.prefill(params, {"tokens": jt[:, :S]},
                                          cache_len=S + CACHE_PAD)
    out["cache_k"], out["cache_v"] = cache.k, cache.v
    out["decode1"], cache = model.decode_step(params, cache,
                                              jt[:, S:S + 1], jnp.int32(S))
    out["decode2"], cache = model.decode_step(
        params, cache, jt[:, S + 1:S + 2], jnp.int32(S + 1))
    return np_params, toks, {k: np.asarray(v) for k, v in out.items()}


def _close(port, ref):
    np.testing.assert_allclose(port.float().detach().numpy(), ref,
                               atol=MODEL_ATOL, rtol=MODEL_RTOL)


@pytest.mark.parametrize("attn_impl", ["flash", "chunked"])
@pytest.mark.parametrize("step", ["forward", "prefill", "decode"])
def test_narrow_stablelm_at_head_dim_160_matches_jax(step, attn_impl):
    np_params, toks, ref = _jax_side()
    _, tcfg = _narrow_cfgs()
    model = build_model(tcfg, device="cpu", attn_impl=attn_impl)
    model.load_state_dict(params_from_jax(tcfg, np_params), strict=True)
    toks = torch.from_numpy(toks)
    with torch.no_grad():
        if step == "forward":
            _close(model.forward({"tokens": toks}), ref["forward"])
            return
        logits, cache = model.prefill({"tokens": toks[:, :S]},
                                      cache_len=S + CACHE_PAD)
        if step == "prefill":
            _close(logits, ref["prefill"])
            _close(cache.k, ref["cache_k"])
            _close(cache.v, ref["cache_v"])
            return
        lg1, cache = model.decode_step(cache, toks[:, S:S + 1], S)
        _close(lg1, ref["decode1"])
        lg2, _ = model.decode_step(cache, toks[:, S + 1:S + 2], S + 1)
        _close(lg2, ref["decode2"])


def _stand_in_call(stand_in, D):
    M = torch.device("meta")
    q = torch.empty(2, 1, 8, D, device=M)
    kv = torch.empty(2, 64, 2, D, device=M)
    pos = torch.arange(64, dtype=torch.int32, device=M)
    if stand_in == "flash_attention":
        return meta.flash_attention(q, kv, kv, pos[:1], pos, True, 0)
    if stand_in == "flash_decode_partials":
        return meta.flash_decode_partials(q, kv, kv, pos[:1], pos, True, 0)
    part = torch.empty(4, 16, 2 + D, device=M)
    return meta.flash_decode_merge(part, torch.bfloat16)


STAND_INS = ("flash_attention", "flash_decode_partials",
             "flash_decode_merge")


@pytest.mark.parametrize("stand_in", STAND_INS)
def test_stand_in_refuses_a_head_dim_the_kernels_lack(stand_in):
    with pytest.raises(ValueError, match="head_dim 24"):
        _stand_in_call(stand_in, 24)


@pytest.mark.parametrize("stand_in", STAND_INS)
def test_stand_in_takes_head_dim_160(stand_in):
    out = _stand_in_call(stand_in, D160)
    assert out.device.type == "meta"
    want = {"flash_attention": (2, 1, 8, D160),
            "flash_decode_partials": (16, 2 + D160),
            "flash_decode_merge": (16, D160)}[stand_in]
    assert tuple(out.shape) == want


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_call(wrapper, D):
    def cuda(t):
        return t.as_subclass(_OnCuda)

    q = cuda(torch.zeros((1, 1, 4, D), dtype=torch.bfloat16))
    kv = cuda(torch.zeros((1, 8, 2, D), dtype=torch.bfloat16))
    qpos = cuda(torch.zeros(1, dtype=torch.int32))
    kpos = cuda(torch.arange(8, dtype=torch.int32))
    if wrapper == "flash_attention":
        return fa.flash_attention(q, kv, kv, qpos=qpos, kpos=kpos)
    if wrapper == "flash_decode_partials":
        return fa.flash_decode_partials(q, kv, kv, qpos=qpos, kpos=kpos)
    return fa.flash_decode_merge(cuda(torch.zeros((4, 4, 2 + D))),
                                 torch.bfloat16)


@pytest.mark.parametrize("D,error", [(D160, "nvcc not found"),
                                     (24, "head_dim 24")])
@pytest.mark.parametrize("wrapper", STAND_INS)
def test_cuda_path_at_head_dim_160_goes_to_the_kernel(wrapper, D, error,
                                                      tmp_path, monkeypatch):
    """On a CUDA tensor each wrapper takes D 160 past its checks to the
    kernel's build (nvcc is missing here, so it raises there, before any
    launch or count) and never to a plain version; D 24 still raises."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))

    def no_fallback(*a, **k):
        raise AssertionError("fell back to a plain version")

    for name in ("flash_attention_ref", "flash_decode_ref",
                 "flash_decode_partials_ref", "flash_decode_merge_ref"):
        monkeypatch.setattr(fa, name, no_fallback)
    before = fa.flash_attention.launches
    with pytest.raises((RuntimeError, ValueError), match=error):
        _cuda_call(wrapper, D)
    assert fa.flash_attention.launches == before
