"""The port's Rwkv6LM and HymbaLM against repro.models.rwkv6 / hymba on the
smoke configs, with JAX's params carried over by params_from_jax: forward
logits, prefill logits and every cache field, two decode steps, and the
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
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.hymba import HymbaLM  # noqa: E402
from repro_torch.models.rwkv6 import Rwkv6LM  # noqa: E402
from repro_torch.train import make_prefill_step, make_serve_step  # noqa: E402

# f32 on both sides: only summation order differs (as in
# tests/test_torch_transformer.py)
ATOL, RTOL = 1e-4, 1e-4
B, CACHE_PAD = 2, 4

CASES = {
    # name -> (arch, prompt length S)
    "rwkv6-7b": ("rwkv6-7b", 32),          # chunked in chunks of 32
    "rwkv6-7b-ragged": ("rwkv6-7b", 20),   # JAX takes chunk = T
    "hymba-1.5b": ("hymba-1.5b", 16),      # inside the smoke window of 32
    # S = 2 x window: JAX's banded attention path, and the ring wraps
    "hymba-1.5b-banded": ("hymba-1.5b", 64),
}
CACHE_FIELDS = {"ssm": ("state", "shift_att", "shift_ffn"),
                "hybrid": ("k", "v", "kpos", "ssm", "shift")}
# leaves initialised to zeros or ones; at init mu = 0 and u = 0 switch the
# token shift and the u-bonus off, which would make the comparison vacuous
ZERO_OR_ONE = ("mu", "w0", "u", "ln_x", "a_log", "dt_bias", "norm",
               "attn_norm", "scale")


def _cfgs(arch):
    return (jconfigs.get_config(arch).smoke(),
            tconfigs.get_config(arch).smoke())


def _perturb(params, seed=7):
    """Move every zero/one-initialised leaf off its init: mu into (0, 1),
    the others by 0.1 N(0, 1)."""
    rng = np.random.RandomState(seed)

    def f(path, a):
        name = path[-1].key
        if name == "mu":
            return a + rng.uniform(0.0, 1.0, a.shape).astype(a.dtype)
        if name in ZERO_OR_ONE:
            return a + (0.1 * rng.randn(*a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(f, params)


@functools.lru_cache(maxsize=None)
def _jax_side(case):
    arch, S = CASES[case]
    jcfg, _ = _cfgs(arch)
    model = jax_build(jcfg)
    params = _perturb(model.init(jax.random.PRNGKey(0)))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab, (B, S + 2)
                                            ).astype(np.int32)
    jt = jnp.asarray(toks)
    out = {"forward": model.forward(params, {"tokens": jt}, remat=False)}
    logits, cache = model.prefill(params, {"tokens": jt[:, :S]},
                                  cache_len=S + CACHE_PAD)
    out["prefill"] = logits
    fields = CACHE_FIELDS[jcfg.family]
    out.update({f"cache1.{f}": getattr(cache, f) for f in fields})
    lg1, cache = model.decode_step(params, cache, jt[:, S:S + 1],
                                   jnp.int32(S))
    lg2, cache = model.decode_step(params, cache, jt[:, S + 1:S + 2],
                                   jnp.int32(S + 1))
    out.update(decode1=lg1, decode2=lg2)
    out.update({f"cache2.{f}": getattr(cache, f) for f in fields})
    return np_params, toks, {k: np.asarray(v) for k, v in out.items()}


def _port(case, **impls):
    np_params, toks, ref = _jax_side(case)
    _, tcfg = _cfgs(CASES[case][0])
    model = build_model(tcfg, device="cpu", **impls)
    model.load_state_dict(params_from_jax(tcfg, np_params), strict=True)
    return model, torch.from_numpy(toks), ref


def _close(port, ref):
    np.testing.assert_allclose(port.float().numpy(), ref, atol=ATOL,
                               rtol=RTOL)


def _impls():
    out = []
    for case in sorted(CASES):
        attns = ["flash", "ref", "chunked"] if "hymba" in case else ["flash"]
        out += [(case, g, a) for g in ("kernel", "chunked") for a in attns]
    return out


@pytest.mark.parametrize("case,gla_impl,attn_impl", _impls())
def test_forward_prefill_decode_match_jax(case, gla_impl, attn_impl):
    model, toks, ref = _port(case, gla_impl=gla_impl, attn_impl=attn_impl)
    S = CASES[case][1]
    fields = CACHE_FIELDS[model.cfg.family]
    _close(model.forward({"tokens": toks}), ref["forward"])
    logits, cache = model.prefill({"tokens": toks[:, :S]},
                                  cache_len=S + CACHE_PAD)
    _close(logits, ref["prefill"])
    for f in fields:
        _close(getattr(cache, f), ref[f"cache1.{f}"])
    lg1, cache = model.decode_step(cache, toks[:, S:S + 1], S)
    _close(lg1, ref["decode1"])
    lg2, cache = model.decode_step(cache, toks[:, S + 1:S + 2], S + 1)
    _close(lg2, ref["decode2"])
    for f in fields:
        _close(getattr(cache, f), ref[f"cache2.{f}"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_matches_forward(case):
    """prefill(S) + decode(S), decode(S+1) == forward(S+2), in the port."""
    model, toks, _ = _port(case)
    S = CASES[case][1]
    full = model.forward({"tokens": toks})
    _, cache = model.prefill({"tokens": toks[:, :S]}, cache_len=S + 2)
    lg1, cache = model.decode_step(cache, toks[:, S:S + 1], S)
    lg2, cache = model.decode_step(cache, toks[:, S + 1:S + 2], S + 1)
    assert float((full[:, S] - lg1[:, 0]).abs().max()) < ATOL
    assert float((full[:, S + 1] - lg2[:, 0]).abs().max()) < ATOL


def test_rwkv_decode_from_init_cache_matches_forward():
    """Token by token from the zero state of init_cache (the O(1) path
    alone, as JAX's init_cache starts it) gives forward's logits."""
    model, toks, ref = _port("rwkv6-7b")
    cache = model.init_cache(B)
    jcache = jax_build(_cfgs("rwkv6-7b")[0]).init_cache(B, 1)
    for f in CACHE_FIELDS["ssm"]:
        assert tuple(getattr(cache, f).shape) == getattr(jcache, f).shape
        assert not bool(getattr(cache, f).any())
    for t in range(8):
        lg, cache = model.decode_step(cache, toks[:, t:t + 1], t)
        _close(lg[:, 0], ref["forward"][:, t])


@pytest.mark.parametrize("case", ["rwkv6-7b", "hymba-1.5b-banded"])
def test_serving_steps_give_jax_greedy_tokens(case):
    """make_prefill_step + G-1 make_serve_step calls generate JAX's tokens."""
    np_params, toks, _ = _jax_side(case)
    arch, S = CASES[case]
    jcfg, tcfg = _cfgs(arch)
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


@pytest.mark.parametrize("arch,cls", [("rwkv6-7b", Rwkv6LM),
                                      ("hymba-1.5b", HymbaLM)])
def test_build_model_full_size_has_the_jax_param_count(arch, cls):
    """build_model no longer raises for the recurrent families; at full
    width and depth (on the meta device: nothing is allocated) the port has
    exactly the JAX model's parameters."""
    model = build_model(arch, device="meta")
    assert isinstance(model, cls) and model.gla_impl == "kernel"
    n = sum(p.numel() for p in model.parameters())
    assert n == jax_build(jconfigs.get_config(arch)).n_params()
    with pytest.raises(ValueError, match="gla_impl"):
        build_model(arch, device="meta", gla_impl="pallas")


def test_params_from_jax_nested_and_bare_layer_leaves():
    """hymba's attn_norm is a bare (L, H*hd) array under layers; rwkv6's
    att.mu is (L, 5, d): both split per layer, values intact."""
    for arch, path, leaf in (("hymba-1.5b", "attn_norm", ("attn_norm",)),
                             ("rwkv6-7b", "att.mu", ("att", "mu"))):
        jcfg, tcfg = _cfgs(arch)
        params = jax.tree_util.tree_map(
            np.asarray, _perturb(jax_build(jcfg).init(jax.random.PRNGKey(2))))
        stacked = params["layers"]
        for key in leaf:
            stacked = stacked[key]
        sd = params_from_jax(tcfg, params)
        for i in range(tcfg.n_layers):
            np.testing.assert_array_equal(sd[f"layers.{i}.{path}"].numpy(),
                                          stacked[i])
        model = build_model(tcfg, device="cpu")
        model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_init_params_reaches_the_recurrent_parameters(arch):
    """init_params fills the new parameter modules with the JAX init styles:
    zero mixes/decays/bonus, unit norms, fan-in scaled projections."""
    _, tcfg = _cfgs(arch)
    model = build_model(tcfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    layer = model.layers[0]
    d = tcfg.d_model
    if arch == "rwkv6-7b":
        zeros, ones = (layer.att.mu, layer.att.w0, layer.att.u,
                       layer.ffn.mu), (layer.att.ln_x,)
        scaled = layer.att.wr
    else:
        zeros, ones = (layer.ssm.a_log, layer.ssm.dt_bias), (
            layer.attn_norm, layer.ssm.norm)
        scaled = layer.ssm.wx
    assert all(bool((p == 0).all()) for p in zeros)
    assert all(bool((p == 1).all()) for p in ones)
    assert abs(scaled.std().item() - d ** -0.5) < 0.2 * d ** -0.5
