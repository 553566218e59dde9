"""The port's moe (dbrx-132b, arctic-480b), encdec (whisper-medium) and vlm
(internvl2-26b) families against repro.models on their smoke configs, with
JAX's params carried over by params_from_jax: forward logits, prefill
logits and every cache field, two decode steps, the serving flow's greedy
tokens, one train step (and one with int8 compression), plus the MoE
dispatch at a capacity that drops tokens and every family's init_cache.
f32 on the CPU."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.train import OptConfig as JOpt  # noqa: E402
from repro.train import TrainConfig as JTrain  # noqa: E402
from repro.train import adamw_init as jax_adamw_init  # noqa: E402
from repro.train import adamw_update as jax_adamw_update  # noqa: E402
from repro.train import make_prefill_step as jax_prefill_step  # noqa: E402
from repro.train import make_serve_step as jax_serve_step  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro.train.compress import compress_decompress as jax_cd  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.models import (build_model, prefix_len,  # noqa: E402
                                side_inputs)
from repro_torch.models import moe  # noqa: E402
from repro_torch.serve.lm import serve  # noqa: E402
from repro_torch.train import (OptConfig, TrainConfig, adamw_init,  # noqa: E402
                               adamw_update, make_train_step)
from repro_torch.train.compress import compress_decompress  # noqa: E402
from repro_torch.train.optimizer import decays  # noqa: E402

# f32 on both sides: only summation order differs, as in
# tests/test_torch_transformer.py. The MoE meets it because the routing
# inputs are continuous draws: no two experts tie on a probability, so
# torch.topk and jax.lax.top_k pick the same experts
ATOL, RTOL = 1e-4, 1e-4
# one train step, as tests/test_torch_train.py holds it
LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-4
P_ATOL, P_RTOL = 2e-5, 2e-4
LR = 1e-5
B, S, CACHE_PAD, N_FRAMES = 2, 16, 4, 40

ARCHS = ["dbrx-132b", "arctic-480b", "whisper-medium", "internvl2-26b"]
CACHE_FIELDS = {"moe": ("k", "v", "kpos"), "vlm": ("k", "v", "kpos"),
                "encdec": ("k", "v", "kpos", "xk", "xv")}
# zero/one-initialised leaves (norm scales and biases, the projector's ln):
# moved off their init so that each carries signal
ZERO_OR_ONE = ("scale", "bias", "ln", "q_norm", "k_norm", "bq", "bk", "bv")


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread a test process (the test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (jconfigs.get_config(arch).smoke(),
            tconfigs.get_config(arch).smoke())


def _perturb(params, seed=7):
    rng = np.random.RandomState(seed)

    def f(path, a):
        if path[-1].key in ZERO_OR_ONE:
            return a + (0.1 * rng.randn(*a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(f, params)


@functools.lru_cache(maxsize=None)
def _jax_side(arch):
    """JAX params, the inputs and the reference outputs, once per arch."""
    jcfg, tcfg = _cfgs(arch)
    model = jax_build(jcfg)
    params = _perturb(model.init(jax.random.PRNGKey(0)))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab, (B, S + 2)
                                            ).astype(np.int32)
    side = side_inputs(tcfg, B, seed=2, n_frames=N_FRAMES)
    jside = {k: jnp.asarray(v) for k, v in side.items()}
    jt = jnp.asarray(toks)
    off = prefix_len(jcfg)
    out = {"forward": model.forward(params, dict(jside, tokens=jt),
                                    remat=False)}
    logits, cache = model.prefill(params, dict(jside, tokens=jt[:, :S]),
                                  cache_len=off + S + CACHE_PAD)
    out["prefill"] = logits
    fields = CACHE_FIELDS[jcfg.family]
    out.update({f"cache1.{f}": getattr(cache, f) for f in fields})
    lg1, cache = model.decode_step(params, cache, jt[:, S:S + 1],
                                   jnp.int32(off + S))
    lg2, cache = model.decode_step(params, cache, jt[:, S + 1:S + 2],
                                   jnp.int32(off + S + 1))
    out.update(decode1=lg1, decode2=lg2)
    out.update({f"cache2.{f}": getattr(cache, f) for f in fields})
    return np_params, toks, side, {k: np.asarray(v) for k, v in out.items()}


def _port(arch, **impls):
    np_params, toks, side, ref = _jax_side(arch)
    _, tcfg = _cfgs(arch)
    model = build_model(tcfg, device="cpu", **impls)
    model.load_state_dict(params_from_jax(tcfg, np_params), strict=True)
    tside = {k: torch.from_numpy(v) for k, v in side.items()}
    return model, torch.from_numpy(toks), tside, ref


def _close(port, ref):
    np.testing.assert_allclose(port.float().numpy(), ref, atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("attn_impl", ["flash", "ref", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch, attn_impl):
    model, toks, side, ref = _port(arch, attn_impl=attn_impl)
    off = prefix_len(model.cfg)
    fields = CACHE_FIELDS[model.cfg.family]
    _close(model.forward(dict(side, tokens=toks)), ref["forward"])
    logits, cache = model.prefill(dict(side, tokens=toks[:, :S]),
                                  cache_len=off + S + CACHE_PAD)
    _close(logits, ref["prefill"])
    for f in fields:
        _close(getattr(cache, f), ref[f"cache1.{f}"])
    lg1, cache = model.decode_step(cache, toks[:, S:S + 1], off + S)
    _close(lg1, ref["decode1"])
    lg2, cache = model.decode_step(cache, toks[:, S + 1:S + 2], off + S + 1)
    _close(lg2, ref["decode2"])
    for f in fields:
        _close(getattr(cache, f), ref[f"cache2.{f}"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """prefill(S) + decode(S), decode(S+1) == forward(S+2), in the port."""
    model, toks, side, _ = _port(arch)
    off = prefix_len(model.cfg)
    full = model.forward(dict(side, tokens=toks))
    _, cache = model.prefill(dict(side, tokens=toks[:, :S]),
                             cache_len=off + S + 2)
    lg1, cache = model.decode_step(cache, toks[:, S:S + 1], off + S)
    lg2, _ = model.decode_step(cache, toks[:, S + 1:S + 2], off + S + 1)
    torch.testing.assert_close(lg1[:, 0], full[:, off + S], atol=ATOL,
                               rtol=RTOL)
    torch.testing.assert_close(lg2[:, 0], full[:, off + S + 1], atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_gives_jax_greedy_tokens(arch):
    """serve() with JAX's params, prompts and side inputs generates the
    tokens of JAX's jitted prefill and serving steps, the vlm's positions
    counting its patch prefix."""
    np_params, toks, side, _ = _jax_side(arch)
    jcfg, tcfg = _cfgs(arch)
    G, off = 5, prefix_len(jcfg)
    jmodel = jax_build(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jprefill = jax.jit(jax_prefill_step(jmodel, cache_len=off + S + G))
    jdecode = jax.jit(jax_serve_step(jmodel))
    batch = {k: jnp.asarray(v) for k, v in side.items()}
    nxt, cache = jprefill(jparams, dict(batch,
                                        tokens=jnp.asarray(toks[:, :S])))
    want = [nxt]
    for i in range(G - 1):
        nxt, _, cache = jdecode(jparams, cache, want[-1],
                                jnp.int32(off + S + i))
        want.append(nxt)
    want = np.concatenate([np.asarray(w) for w in want], axis=1)
    res = serve(tcfg, B, S, G, device="cpu",
                params=params_from_jax(tcfg, np_params),
                prompts=toks[:, :S], inputs=side)
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    assert tuple(res.logits.shape) == (B, G - 1, tcfg.padded_vocab)
    assert bool(torch.isfinite(res.logits).all())


@functools.lru_cache(maxsize=None)
def _jax_step(arch, compress):
    np_params, toks, side, _ = _jax_side(arch)
    jcfg, _ = _cfgs(arch)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    opt = JOpt(lr=LR, warmup_steps=0, weight_decay=0.1)
    step = jax.jit(jax_train_step(jax_build(jcfg),
                                  JTrain(opt=opt, compress_grads=compress)))
    opt_state = jax_adamw_init(params)
    if compress:
        opt_state["ef"] = jax.tree_util.tree_map(
            lambda p: jnp.zeros(p.shape, jnp.float32), params)
    batch = {k: jnp.asarray(v) for k, v in side.items()}
    new_p, new_o, met = step(params, opt_state,
                             dict(batch, tokens=jnp.asarray(toks)))
    return (jax.tree_util.tree_map(np.asarray, new_p),
            {k: float(v) for k, v in met.items()})


def _assert_trees_close(got, want, atol, rtol):
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, compress):
    """One make_train_step from JAX's params on the same batch (tokens and
    side inputs): loss, grad_norm, lr and every updated param; attention
    through the kernel's autograd Function, whose backward is the caller's
    plain function."""
    _, tcfg = _cfgs(arch)
    jp, jm = _jax_step(arch, compress)
    model, toks, side, _ = _port(arch)
    tc = TrainConfig(opt=OptConfig(lr=LR, warmup_steps=0, weight_decay=0.1),
                     compress_grads=compress)
    state = adamw_init(dict(model.named_parameters()))
    state, met = make_train_step(model, tc)(state, dict(side, tokens=toks))
    assert float(met["loss"]) == pytest.approx(jm["loss"], rel=LOSS_RTOL)
    assert float(met["grad_norm"]) == pytest.approx(jm["grad_norm"],
                                                    rel=GNORM_RTOL)
    assert float(met["lr"]) == pytest.approx(jm["lr"], rel=1e-6)
    _assert_trees_close(params_to_numpy(tcfg, model.state_dict()), jp,
                        P_ATOL, P_RTOL)


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-26b"])
def test_adamw_decays_as_jax_on_encoder_and_projector(arch):
    """With zero grads the decay is the whole update: JAX decays every leaf
    of the stacked encoder (its norms included), frontend.proj and the
    projector's matrices, and not enc_norm or projector.ln."""
    np_params, _, _, _ = _jax_side(arch)
    _, tcfg = _cfgs(arch)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    cfg = dict(lr=0.1, warmup_steps=0, weight_decay=0.5, grad_clip=0.0)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    jp, _, _ = jax_adamw_update(JOpt(**cfg), zeros, jax_adamw_init(params),
                                params)
    model, _, _, _ = _port(arch)
    pp = dict(model.named_parameters())
    adamw_update(OptConfig(**cfg), {n: torch.zeros_like(p)
                                    for n, p in pp.items()},
                 adamw_init(pp), pp)
    _assert_trees_close(params_to_numpy(tcfg, model.state_dict()),
                        jax.tree_util.tree_map(np.asarray, jp), 1e-7, 1e-6)
    names = {"whisper-medium": (["encoder.1.ln1.scale", "frontend.proj"],
                                ["enc_norm.scale", "final_norm.bias"]),
             "internvl2-26b": (["projector.w1", "layers.0.ln1.scale"],
                               ["projector.ln", "final_norm.scale"])}[arch]
    assert all(decays(n, pp[n]) for n in names[0])
    assert not any(decays(n, pp[n]) for n in names[1])


def test_compress_scales_the_stacked_encoder_as_jax():
    """The int8 scale is per JAX leaf: the encoder's layers of one path
    share the scale of their stack."""
    np_params, _, _, _ = _jax_side("whisper-medium")
    _, tcfg = _cfgs("whisper-medium")
    rng = np.random.RandomState(2)
    jef, tef = None, None
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda a: jnp.asarray((rng.randn(*a.shape) * 1e-3
                                   ).astype(np.float32)), np_params)
        jdeq, jef = jax_cd(g, jef)
        tdeq, tef = compress_decompress(params_from_jax(
            tcfg, jax.tree_util.tree_map(np.asarray, g)), tef)
        _assert_trees_close(params_to_numpy(tcfg, tdeq),
                            jax.tree_util.tree_map(np.asarray, jdeq), 1e-9,
                            1e-6)


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-26b"])
def test_params_round_trip(arch):
    """params_to_numpy(params_from_jax(tree)) gives back JAX's tree: the
    encoder restacked over encoder_layers, frontend, enc_norm and the
    projector in place."""
    np_params, _, _, _ = _jax_side(arch)
    _, tcfg = _cfgs(arch)
    back = params_to_numpy(tcfg, params_from_jax(tcfg, np_params))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(np_params))
    for path, want in jax.tree_util.tree_flatten_with_path(np_params)[0]:
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ MoE --
def test_capacity_matches_jax():
    for arch in ("dbrx-132b", "arctic-480b"):
        jcfg, tcfg = _cfgs(arch)
        for T, cf in ((8, 1.25), (64, 1.25), (4096, 1.25), (777, 0.3),
                      (100_000, 2.0)):
            assert moe.capacity(dataclasses.replace(tcfg, capacity_factor=cf),
                                T) == jax_moe.capacity(
                dataclasses.replace(jcfg, capacity_factor=cf), T)
    jcfg, tcfg = _cfgs("arctic-480b")
    jfull, tfull = (jconfigs.get_config("arctic-480b"),
                    tconfigs.get_config("arctic-480b"))
    assert moe.capacity(tfull, 4096) == jax_moe.capacity(jfull, 4096) == 128


@pytest.mark.parametrize("arch", ["dbrx-132b", "arctic-480b"])
def test_moe_ffn_drops_the_same_pairs_as_jax(arch):
    """A router skewed towards expert 0 overflows its capacity (C = 128 for
    T = 256 at capacity_factor 0.5): tokens are dropped, the port drops
    the same (token, choice) pairs as JAX, and its output agrees."""
    jcfg, tcfg = _cfgs(arch)
    jcfg = dataclasses.replace(jcfg, capacity_factor=0.5)
    tcfg = dataclasses.replace(tcfg, capacity_factor=0.5)
    rng = np.random.RandomState(3)
    Bm, Sm, d, E = 2, 128, tcfg.d_model, tcfg.n_experts
    x = rng.randn(Bm, Sm, d).astype(np.float32)
    fin = 2 * tcfg.d_ff if tcfg.act == "swiglu" else tcfg.d_ff
    p = {"router": (rng.randn(d, E) / np.sqrt(d)).astype(np.float32),
         "wi": (rng.randn(E, d, fin) / np.sqrt(d)).astype(np.float32),
         "wo": (rng.randn(E, tcfg.d_ff, d) / np.sqrt(tcfg.d_ff)
                ).astype(np.float32)}
    x += 1.0                        # a shared direction, which the
    p["router"][:, 0] += 3.0 / d    # router's column 0 favours
    T, C = Bm * Sm, moe.capacity(tcfg, Bm * Sm)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want, _ = jax_moe.moe_ffn(jcfg, jp, jnp.asarray(x))

    experts = moe.Experts(tcfg, torch.device("cpu"))
    for k, v in p.items():
        getattr(experts, k).data.copy_(torch.from_numpy(v))
    tx = torch.from_numpy(x)
    got, _ = moe.moe_ffn(tcfg, experts, tx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)

    # the dropped pairs: the port's, and JAX's read from its own routing
    _, topi, _ = moe.route(tcfg, experts.router, tx.reshape(T, d))
    order, _, keep = moe.dispatch(tcfg, topi, C)
    dropped = {(int(i) // tcfg.moe_topk, int(i) % tcfg.moe_topk)
               for i in order[~keep]}
    _, jtopi, _ = jax_moe.route(jcfg, jp["router"],
                                jnp.asarray(x.reshape(T, d)))
    jtopi = np.asarray(jtopi)
    np.testing.assert_array_equal(topi.numpy(), jtopi)
    # JAX's rule: pairs stably sorted by expert, so within an expert in
    # (token, choice) order; a pair past the first C of its expert drops
    seen, jdropped = np.zeros(E, int), set()
    for e in range(E):
        for t, j in sorted((t, j) for t in range(T)
                           for j in range(tcfg.moe_topk) if jtopi[t, j] == e):
            if seen[e] >= C:
                jdropped.add((t, j))
            seen[e] += 1
    assert seen.max() > C
    assert len(dropped) == np.maximum(seen - C, 0).sum() > 0
    assert dropped == jdropped
    # each token with a dropped choice lost that choice's share: its output
    # moved against the run with room for every pair
    roomy = dataclasses.replace(jcfg, capacity_factor=8.0)
    full, _ = jax_moe.moe_ffn(roomy, jp, jnp.asarray(x))
    moved = np.abs(np.asarray(full) - np.asarray(want)).reshape(T, d).max(1)
    assert {t for t, _ in dropped} == set(np.nonzero(moved > 1e-6)[0])


# ------------------------------------------------------------ init_cache --
INIT_CACHE = {
    # arch -> the cache's fields (qwen3-4b: the dense family, which moe and
    # vlm inherit)
    "qwen3-4b": ("k", "v", "kpos"),
    "hymba-1.5b": ("k", "v", "kpos", "ssm", "shift"),
    "rwkv6-7b": ("state", "shift_att", "shift_ffn"),
    "whisper-medium": ("k", "v", "kpos", "xk", "xv"),
    "dbrx-132b": ("k", "v", "kpos"),
    "internvl2-26b": ("k", "v", "kpos"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(INIT_CACHE))
def test_init_cache_matches_jax(arch, dtype):
    jcfg = jconfigs.get_config(arch).smoke().scaled(dtype=dtype)
    tcfg = tconfigs.get_config(arch).smoke().scaled(dtype=dtype)
    want = jax_build(jcfg).init_cache(3, 12)
    got = build_model(tcfg, device="cpu").init_cache(3, 12)
    for f in INIT_CACHE[arch]:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert tuple(g.shape) == w.shape, f
        assert str(g.dtype).split(".")[-1] == str(w.dtype), f
        np.testing.assert_array_equal(g.float().numpy(),
                                      w.astype(np.float32), err_msg=f)
