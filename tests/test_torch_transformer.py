"""The port's TransformerLM against repro.models.transformer on the dense
smoke configs, with JAX's params carried over by params_from_jax: forward
logits, prefill logits + ring cache + kpos, two decode steps, and the
serving steps' greedy tokens. f32 on the CPU."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.train import make_prefill_step as jax_prefill_step  # noqa: E402
from repro.train import make_serve_step as jax_serve_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_jax, to_tensor  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import make_prefill_step, make_serve_step  # noqa: E402

# f32 on both sides: only summation order differs. Far inside the repo's
# own decode==forward bound of 2e-2 (tests/test_models_smoke.py:65).
ATOL, RTOL = 1e-4, 1e-4
B, S, CACHE_PAD = 2, 16, 4

CASES = {
    # name -> (arch, smoke overrides); the features each dense arch adds
    "qwen3-4b": ("qwen3-4b", {}),                  # qk_norm
    "qwen2.5-14b": ("qwen2.5-14b", {}),            # qkv_bias
    "granite-3-2b": ("granite-3-2b", {}),          # tied embeddings
    "stablelm-12b": ("stablelm-12b", {}),          # layernorm
    "qwen3-4b-padded": ("qwen3-4b", {"vocab": 250}),   # -1e9 vocab tail
}


def _cfgs(case):
    arch, over = CASES[case]
    return (jconfigs.get_config(arch).smoke().scaled(**over),
            tconfigs.get_config(arch).smoke().scaled(**over))


@functools.lru_cache(maxsize=None)
def _jax_side(case):
    """JAX params (perturbed so zero biases and unit norms carry signal) and
    the reference outputs, computed once per case."""
    jcfg, _ = _cfgs(case)
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
    full = model.forward(params, {"tokens": jt}, remat=False)
    pf_logits, cache = model.prefill(params, {"tokens": jt[:, :S]},
                                     cache_len=S + CACHE_PAD)
    out = {"forward": full, "prefill": pf_logits, "cache_k": cache.k,
           "cache_v": cache.v, "kpos": cache.kpos}
    lg1, cache = model.decode_step(params, cache, jt[:, S:S + 1],
                                   jnp.int32(S))
    lg2, cache = model.decode_step(params, cache, jt[:, S + 1:S + 2],
                                   jnp.int32(S + 1))
    out.update(decode1=lg1, decode2=lg2, cache_k2=cache.k)
    return np_params, toks, {k: np.asarray(v) for k, v in out.items()}


def _port(case, attn_impl="flash"):
    np_params, toks, ref = _jax_side(case)
    _, tcfg = _cfgs(case)
    model = build_model(tcfg, device="cpu", attn_impl=attn_impl)
    model.load_state_dict(params_from_jax(tcfg, np_params), strict=True)
    return model, torch.from_numpy(toks), ref


def _close(port, ref):
    np.testing.assert_allclose(port.float().numpy(), ref, atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("attn_impl", ["flash", "ref", "chunked"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_prefill_decode_match_jax(case, attn_impl):
    model, toks, ref = _port(case, attn_impl)
    _close(model.forward({"tokens": toks}), ref["forward"])
    logits, cache = model.prefill({"tokens": toks[:, :S]},
                                  cache_len=S + CACHE_PAD)
    _close(logits, ref["prefill"])
    _close(cache.k, ref["cache_k"])
    _close(cache.v, ref["cache_v"])
    np.testing.assert_array_equal(cache.kpos.numpy(), ref["kpos"])
    lg1, cache = model.decode_step(cache, toks[:, S:S + 1], S)
    _close(lg1, ref["decode1"])
    lg2, cache = model.decode_step(cache, toks[:, S + 1:S + 2], S + 1)
    _close(lg2, ref["decode2"])
    _close(cache.k, ref["cache_k2"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_matches_forward(case):
    """prefill(S) + decode(S), decode(S+1) == forward(S+2), in the port."""
    model, toks, _ = _port(case)
    full = model.forward({"tokens": toks})
    _, cache = model.prefill({"tokens": toks[:, :S]}, cache_len=S + 2)
    lg1, cache = model.decode_step(cache, toks[:, S:S + 1], S)
    lg2, cache = model.decode_step(cache, toks[:, S + 1:S + 2], S + 1)
    assert float((full[:, S] - lg1[:, 0]).abs().max()) < ATOL
    assert float((full[:, S + 1] - lg2[:, 0]).abs().max()) < ATOL
    np.testing.assert_array_equal(cache.kpos.numpy(), np.arange(S + 2))


def test_padded_vocab_tail_is_masked():
    model, toks, _ = _port("qwen3-4b-padded")
    logits = model.forward({"tokens": toks})
    assert logits.shape[-1] == 256
    assert bool((logits[..., 250:] == -1e9).all())


@pytest.mark.parametrize("case", ["qwen3-4b", "granite-3-2b"])
def test_serving_steps_give_jax_greedy_tokens(case):
    """make_prefill_step + G-1 make_serve_step calls generate JAX's tokens."""
    np_params, toks, _ = _jax_side(case)
    jcfg, tcfg = _cfgs(case)
    G = 5
    jmodel = jax_build(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jprefill = jax.jit(jax_prefill_step(jmodel, cache_len=S + G))
    jdecode = jax.jit(jax_serve_step(jmodel))
    nxt, cache = jprefill(jparams, {"tokens": jnp.asarray(toks[:, :S])})
    want = [nxt]
    for i in range(G - 1):
        nxt, _, cache = jdecode(jparams, cache, want[-1], jnp.int32(S + i))
        want.append(nxt)
    want = np.concatenate([np.asarray(w) for w in want], axis=1)

    model, ttoks, _ = _port(case)
    prefill = make_prefill_step(model, cache_len=S + G)
    decode = make_serve_step(model)
    nxt, cache = prefill({"tokens": ttoks[:, :S]})
    got = [nxt]
    for i in range(G - 1):
        nxt, logits, cache = decode(cache, got[-1], S + i)
        assert logits.shape == (B, 1, tcfg.padded_vocab)
        got.append(nxt)
    got = torch.cat(got, dim=1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_params_from_jax_bf16_and_layout():
    """ml_dtypes bf16 leaves come over bit for bit; stacked leaves split per
    layer in JAX's (in, out) layout."""
    jcfg, tcfg = _cfgs("qwen3-4b")
    jcfg = jcfg.scaled(dtype="bfloat16")
    tcfg = tcfg.scaled(dtype="bfloat16")
    params = jax.tree_util.tree_map(
        np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(3)))
    sd = params_from_jax(tcfg, params)
    wq = params["layers"]["attn"]["wq"]
    assert wq.dtype.name == "bfloat16"
    t = sd["layers.1.attn.wq"]
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == wq.shape[1:]
    np.testing.assert_array_equal(t.float().numpy(),
                                  wq[1].astype(np.float32))
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    assert to_tensor(np.zeros(3, np.float32)).dtype == torch.float32


def test_init_params_reproduces_init_distributions():
    """init_params draws the JAX package's distributions (not its numbers):
    fan-in scaled weights, 1/sqrt(d) embeddings, unit norms, zero biases."""
    _, tcfg = _cfgs("qwen2.5-14b")
    tcfg = tcfg.scaled(d_model=256, d_ff=512)
    model = build_model(tcfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    layer = model.layers[0]
    d = tcfg.d_model
    assert abs(layer.attn.wq.std().item() - d ** -0.5) < 0.1 * d ** -0.5
    assert abs(layer.mlp.wo.std().item() - tcfg.d_ff ** -0.5) \
        < 0.1 * tcfg.d_ff ** -0.5
    assert abs(model.embed.std().item() - d ** -0.5) < 0.1 * d ** -0.5
    assert bool((layer.ln1.scale == 1).all())
    assert bool((layer.attn.bq == 0).all())
