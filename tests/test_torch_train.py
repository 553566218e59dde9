"""The port's training step against repro.train on the smoke configs, f32
on the CPU: the LR schedule, AdamW (with JAX's weight-decay decision on
stacked leaves), the global norm, the cross entropy, int8 compression with
error feedback, and one full make_train_step (n_micro 1 and 2, with and
without compression) on every dense arch, rwkv6 and hymba, and three
steps on one batch, with JAX's params carried over by params_from_jax. Plus the microbatch identity and
the overfit run of tests/test_train.py, on the port alone."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.transformer import softmax_xent as jax_xent  # noqa: E402
from repro.train import OptConfig as JOpt  # noqa: E402
from repro.train import TrainConfig as JTrain  # noqa: E402
from repro.train import adamw_init as jax_adamw_init  # noqa: E402
from repro.train import adamw_update as jax_adamw_update  # noqa: E402
from repro.train import lr_schedule as jax_lr  # noqa: E402
from repro.train import make_train_step as jax_train_step  # noqa: E402
from repro.train.compress import compress_decompress as jax_cd  # noqa: E402
from repro.train.compress import quantize_int8 as jax_q8  # noqa: E402
from repro.train.optimizer import global_norm as jax_gnorm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import (opt_state_from_jax, params_from_jax,  # noqa: E402
                                 params_to_numpy)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import softmax_xent  # noqa: E402
from repro_torch.train import (OptConfig, TrainConfig, adamw_init,  # noqa: E402
                               adamw_update, init_train_state, lr_schedule,
                               make_train_step)
from repro_torch.train.compress import (compress_decompress,  # noqa: E402
                                        quantize_int8)
from repro_torch.train.optimizer import decays, global_norm  # noqa: E402

B = 4


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread a test process (the test workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# one step: the loss and the gradient norm agree to f32 summation order;
# params at tests/test_train.py:59's tolerance. AdamW's first step moves a
# param by ~lr * sign(g), so a near-zero gradient whose sign the summation
# order flips moves it by up to 2 * lr: LR is kept at atol / 2
LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-4
P_ATOL, P_RTOL = 2e-5, 2e-4
LR = 1e-5

CASES = {
    # name -> (arch, seq len, smoke overrides)
    "qwen3-4b": ("qwen3-4b", 32, {}),                  # qk_norm
    "qwen2.5-14b": ("qwen2.5-14b", 32, {}),            # qkv_bias
    "granite-3-2b": ("granite-3-2b", 32, {}),          # tied embeddings
    "stablelm-12b": ("stablelm-12b", 32, {}),          # layernorm
    "qwen3-4b-padded": ("qwen3-4b", 32, {"vocab": 250}),   # -1e9 tail
    "rwkv6-7b": ("rwkv6-7b", 32, {}),                  # GLA with u
    "hymba-1.5b": ("hymba-1.5b", 16, {}),              # inside the window
    # S = 2 x window: JAX's banded attention, the kernel's banded backward
    "hymba-1.5b-banded": ("hymba-1.5b", 64, {}),
}
VARIANTS = {"n_micro1": dict(n_micro=1), "n_micro2": dict(n_micro=2),
            "compress": dict(compress_grads=True)}
# zero/one-initialised leaves (mu = 0 and u = 0 switch RWKV6's token shift
# and u-bonus off, a zero bias has no effect): moved off their init
ZERO_OR_ONE = ("mu", "w0", "u", "ln_x", "a_log", "dt_bias", "norm",
               "attn_norm", "scale", "bias", "bq", "bk", "bv", "q_norm",
               "k_norm")


def _cfgs(case):
    arch, _, over = CASES[case]
    return (jconfigs.get_config(arch).smoke().scaled(**over),
            tconfigs.get_config(arch).smoke().scaled(**over))


def _perturb(params, seed=7):
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
def _params(case):
    jcfg, _ = _cfgs(case)
    model = jax_build(jcfg)
    params = _perturb(model.init(jax.random.PRNGKey(0)))
    return model, params


def _tokens(case, seed=1):
    jcfg, _ = _cfgs(case)
    return np.random.RandomState(seed).randint(
        0, jcfg.vocab, (B, CASES[case][1])).astype(np.int32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_model(case, params):
    _, tcfg = _cfgs(case)
    m = build_model(tcfg, device="cpu")
    m.load_state_dict(params_from_jax(tcfg, _np(params)))
    return m


def _assert_trees_close(got, want, atol, rtol):
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------- optimizer --
@pytest.mark.parametrize("cfg", [
    dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
    dict(lr=3e-4, warmup_steps=0, total_steps=150, min_lr_ratio=0.0),
])
def test_lr_schedule_matches_jax(cfg):
    for s in (0, 5, 10, 55, 100, 200):
        want = float(jax_lr(JOpt(**cfg), jnp.int32(s)))
        got = float(lr_schedule(OptConfig(**cfg),
                                torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), s
    got = [float(lr_schedule(OptConfig(**cfg), torch.tensor(s)))
           for s in (0, 5, 10, 100)]
    if cfg["warmup_steps"] == 10:   # as tests/test_train.py checks JAX
        assert got[0] == 0.0 and got[1] == pytest.approx(0.5)
        assert got[2] == pytest.approx(1.0) and got[3] == pytest.approx(0.1)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_jax(state_dtype, clip):
    """Three AdamW steps on qwen3-4b's smoke tree (stacked layer leaves) and
    the same grads: params, moments, step, grad_norm and lr."""
    case = "qwen3-4b"
    _, params = _params(case)
    _, tcfg = _cfgs(case)
    cfg = dict(lr=0.05, warmup_steps=1, total_steps=10, weight_decay=0.1,
               grad_clip=clip, state_dtype=state_dtype)
    rng = np.random.RandomState(3)
    jstate = jax_adamw_init(params, state_dtype)
    m = _port_model(case, params)
    pp = dict(m.named_parameters())
    state = adamw_init(pp, state_dtype)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)),
            params)
        params, jstate, jmet = jax_adamw_update(JOpt(**cfg), g, jstate,
                                                params)
        state, met = adamw_update(OptConfig(**cfg),
                                  params_from_jax(tcfg, _np(g)), state, pp)
        assert float(met["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-5)
        assert float(met["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 3
    tol = (1e-6, 1e-5) if state_dtype == "float32" else (1e-5, 1e-2)
    _assert_trees_close(params_to_numpy(tcfg, m.state_dict()), _np(params),
                        *tol)
    want_opt = opt_state_from_jax(tcfg, _np(jstate))
    for key in ("m", "v"):
        assert state[key].keys() == want_opt[key].keys()
        for name, t in state[key].items():
            assert t.dtype == getattr(torch, state_dtype)
            np.testing.assert_allclose(t.float().numpy(),
                                       want_opt[key][name].float().numpy(),
                                       atol=tol[0], rtol=tol[1],
                                       err_msg=f"{key}/{name}")


def test_adamw_decays_layer_norms_not_final_norm():
    """JAX decays a leaf iff p.ndim >= 2 on its stacked (L, ...) leaf: every
    layer norm scale decays, final_norm does not. With zero grads the
    decay is the whole update: p <- p - lr * wd * p."""
    case = "qwen3-4b"
    _, params = _params(case)
    _, tcfg = _cfgs(case)
    cfg = dict(lr=0.1, warmup_steps=0, weight_decay=0.5, grad_clip=0.0)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    jp, _, _ = jax_adamw_update(JOpt(**cfg), zeros,
                                jax_adamw_init(params), params)
    m = _port_model(case, params)
    pp = dict(m.named_parameters())
    before = {n: p.detach().clone() for n, p in pp.items()}
    adamw_update(OptConfig(**cfg), {n: torch.zeros_like(p)
                                    for n, p in pp.items()},
                 adamw_init(pp), pp)
    _assert_trees_close(params_to_numpy(tcfg, m.state_dict()), _np(jp),
                        1e-7, 1e-6)
    lr_now = float(jax_lr(JOpt(**cfg), jnp.int32(1)))
    for name in ("layers.0.ln1.scale", "layers.1.attn.q_norm", "embed"):
        assert decays(name, pp[name])
        torch.testing.assert_close(pp[name].detach(), before[name] * (
            1 - lr_now * 0.5))
    assert not decays("final_norm.scale", pp["final_norm.scale"])
    torch.testing.assert_close(pp["final_norm.scale"].detach(),
                               before["final_norm.scale"])


def test_global_norm_matches_jax():
    _, params = _params("rwkv6-7b")
    _, tcfg = _cfgs("rwkv6-7b")
    got = float(global_norm(params_from_jax(tcfg, _np(params))))
    assert got == pytest.approx(float(jax_gnorm(params)), rel=1e-6)


@pytest.mark.parametrize("masked", ["last", "random", "all"])
def test_softmax_xent_matches_jax(masked):
    rng = np.random.RandomState(5)
    logits = (3 * rng.randn(3, 7, 50)).astype(np.float32)
    targets = rng.randint(0, 50, (3, 7)).astype(np.int32)
    mask = np.ones((3, 7), np.float32)
    if masked == "last":
        mask[:, -1] = 0
    elif masked == "random":
        mask = (rng.rand(3, 7) > 0.4).astype(np.float32)
    else:
        mask[:] = 0
    jl, jd = jax_xent(jnp.asarray(logits), jnp.asarray(targets),
                      jnp.asarray(mask))
    jg = jax.grad(lambda x: jax_xent(x, jnp.asarray(targets),
                                     jnp.asarray(mask))[0])(
        jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    tl, td = softmax_xent(x, torch.as_tensor(targets), torch.as_tensor(mask))
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-6,
                                               abs=1e-7)
    assert float(td) == float(jd)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), atol=1e-7,
                               rtol=1e-5)


# -------------------------------------------------------------- compress --
def test_quantize_int8_matches_jax():
    rng = np.random.RandomState(0)
    for x in (rng.randn(256) * 0.01, rng.randn(4, 33) * 5,
              np.arange(-127, 128, dtype=np.float64) / 2,  # halves: to even
              np.zeros(8)):
        x = x.astype(np.float32)
        jq, js = jax_q8(jnp.asarray(x))
        tq, ts = quantize_int8(torch.as_tensor(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        err = np.abs(tq.numpy().astype(np.float32) * float(ts) - x)
        assert err.max() <= float(ts) / 2 + 1e-9


def test_compress_decompress_matches_jax_with_error_feedback():
    """Five steps of the int8 round trip on rwkv6-7b's smoke tree: the port
    quantizes its per-layer leaves at the scale of their stacked JAX leaf,
    so the decompressed grads and the residuals agree."""
    _, params = _params("rwkv6-7b")
    _, tcfg = _cfgs("rwkv6-7b")
    rng = np.random.RandomState(2)
    jef, tef = None, None
    for _ in range(5):
        g = jax.tree_util.tree_map(
            lambda a: jnp.asarray((rng.randn(*a.shape) * 1e-3
                                   ).astype(np.float32)), params)
        jdeq, jef = jax_cd(g, jef)
        tdeq, tef = compress_decompress(params_from_jax(tcfg, _np(g)), tef)
        _assert_trees_close(params_to_numpy(tcfg, tdeq), _np(jdeq), 1e-9,
                            1e-6)
        _assert_trees_close(params_to_numpy(tcfg, tef), _np(jef), 1e-9,
                            1e-5)


# ------------------------------------------------------------ train step --
@functools.lru_cache(maxsize=None)
def _jax_step(case, variant):
    model, params = _params(case)
    opt = JOpt(lr=LR, warmup_steps=0, weight_decay=0.1)
    step = jax.jit(jax_train_step(model, JTrain(opt=opt, **VARIANTS[variant])))
    opt_state = jax_adamw_init(params)
    if variant == "compress":
        opt_state["ef"] = jax.tree_util.tree_map(
            lambda p: jnp.zeros(p.shape, jnp.float32), params)
    new_p, new_o, met = step(params, opt_state,
                             {"tokens": jnp.asarray(_tokens(case))})
    return _np(new_p), _np(new_o), {k: float(v) for k, v in met.items()}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case, variant):
    """One make_train_step from JAX's params on the same batch: loss,
    grad_norm, lr and every updated param (attention through the kernel's
    autograd Function, GLA through the kernel's)."""
    _, params = _params(case)
    _, tcfg = _cfgs(case)
    jp, jo, jm = _jax_step(case, variant)
    m = _port_model(case, params)
    tc = TrainConfig(opt=OptConfig(lr=LR, warmup_steps=0, weight_decay=0.1),
                     **VARIANTS[variant])
    state = adamw_init(dict(m.named_parameters()))
    state, met = make_train_step(m, tc)(
        state, {"tokens": torch.as_tensor(_tokens(case))})
    assert float(met["loss"]) == pytest.approx(jm["loss"], rel=LOSS_RTOL)
    assert float(met["grad_norm"]) == pytest.approx(jm["grad_norm"],
                                                    rel=GNORM_RTOL)
    assert float(met["lr"]) == pytest.approx(jm["lr"], rel=1e-6)
    assert int(state["step"]) == 1
    _assert_trees_close(params_to_numpy(tcfg, m.state_dict()), jp, P_ATOL,
                        P_RTOL)
    if variant == "compress":
        _assert_residuals_close(params_to_numpy(tcfg, state["ef"]), jo["ef"])


# three steps on one batch: AdamW's first step moves a param by ~lr *
# sign(g) whatever the gradient's size, so after one step the params
# cannot tell a wrong gradient from a right one; after three the moments
# weigh the gradients. The param changes agree as ||dp_port - dp_jax|| /
# ||dp_jax|| over every leaf; a port run with zero gradients into the
# mixer's input projections (as a detached kernel output gives) must land
# above the limit, or the check could not fail
STEPS, STEPS_RTOL = 3, 1e-2
CONTROL_ZEROED = ("attn.wq", "attn.wk", "attn.wv", "att.wr", "att.wk",
                  "att.wv")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}{key}/").items()}
    return {prefix: np.asarray(tree, np.float64)}


def _change_rel(got, want, p0):
    got, want, p0 = _flat(got), _flat(want), _flat(p0)
    num = sum(np.square(got[k] - want[k]).sum() for k in want)
    return float(np.sqrt(num / sum(np.square(want[k] - p0[k]).sum()
                                   for k in want)))


@pytest.mark.parametrize("case", ["qwen3-4b", "rwkv6-7b",
                                  "hymba-1.5b-banded"])
def test_three_train_steps_match_jax(case):
    """Three make_train_step steps from JAX's params: the param changes
    agree with JAX's, and the control's do not."""
    model, params = _params(case)
    _, tcfg = _cfgs(case)
    opt = dict(lr=LR, warmup_steps=0, weight_decay=0.1)
    batch = jnp.asarray(_tokens(case))
    step = jax.jit(jax_train_step(model, JTrain(opt=JOpt(**opt))))
    jp, jo = params, jax_adamw_init(params)
    for _ in range(STEPS):
        jp, jo, _ = step(jp, jo, {"tokens": batch})
    got = {}
    for side, zeroed in (("port", ()), ("control", CONTROL_ZEROED)):
        m = _port_model(case, params)
        for name, p in m.named_parameters():
            if name.endswith(zeroed):
                p.register_hook(torch.zeros_like)
        tstep = make_train_step(m, TrainConfig(opt=OptConfig(**opt)))
        state = adamw_init(dict(m.named_parameters()))
        for _ in range(STEPS):
            state, _ = tstep(state, {"tokens": torch.as_tensor(
                _tokens(case))})
        got[side] = _change_rel(params_to_numpy(tcfg, m.state_dict()),
                                _np(jp), _np(params))
    assert got["port"] <= STEPS_RTOL < got["control"], got


def _assert_residuals_close(got, want):
    """Error-feedback residuals r = g - s round(g / s), s the step of the
    leaf's int8 grid (|r| <= s / 2). Where g rounds alike, r differs as g
    does, by the summation order, far below s / 100 (~1e-5 |g|, |g| <=
    127 s). Where g sat at a rounding tie and the two orders rounded it to
    neighbouring steps, r moves by s, at most 2 max|r|; such ties are rare
    (under 1% of the elements)."""
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        diff = np.abs(g - w)
        off = diff > 1e-7 + 0.005 * np.abs(w).max()
        key = jax.tree_util.keystr(path)
        assert off.mean() < 0.01, (key, int(off.sum()))
        assert diff.max() <= 2.0001 * np.abs(w).max() + 1e-7, key


def test_microbatch_accumulation_matches_full_batch():
    """tests/test_train.py's check on the port: the mean of the microbatch
    losses is the full-batch loss and the updated params agree."""
    _, tcfg = _cfgs("qwen3-4b")
    batch = {"tokens": torch.as_tensor(np.random.RandomState(0).randint(
        0, tcfg.vocab, (4, 32)), dtype=torch.int32)}
    opt = OptConfig(lr=1e-2, warmup_steps=0, grad_clip=0.0,
                    weight_decay=0.0)
    out = []
    for n in (1, 2):
        m = build_model(tcfg, device="cpu")
        state = init_train_state(m, torch.Generator().manual_seed(0),
                                 TrainConfig(opt=opt))
        state, met = make_train_step(m, TrainConfig(opt=opt, n_micro=n))(
            state, batch)
        out.append((float(met["loss"]), m.state_dict()))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-5)
    for name, a in out[0][1].items():
        torch.testing.assert_close(a, out[1][1][name], atol=2e-5, rtol=2e-4)


def test_overfit_tiny_model():
    """A few dozen steps on one batch must crush the loss (the JAX
    package's 'this actually trains' check, on the port)."""
    tcfg = tconfigs.get_config("granite-3-2b").smoke().scaled(vocab=64,
                                                              n_layers=2)
    m = build_model(tcfg, device="cpu")
    tc = TrainConfig(opt=OptConfig(lr=3e-3, warmup_steps=5, total_steps=200,
                                   weight_decay=0.0))
    state = init_train_state(m, torch.Generator().manual_seed(0), tc)
    batch = {"tokens": torch.as_tensor(np.random.RandomState(1).randint(
        0, 64, (2, 32)), dtype=torch.int32)}
    step = make_train_step(m, tc)
    losses = []
    for _ in range(60):
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


def test_init_train_state_with_compression():
    tcfg = tconfigs.get_config("qwen3-4b").smoke()
    m = build_model(tcfg, device="cpu")
    tc = TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=0),
                     compress_grads=True)
    state = init_train_state(m, torch.Generator().manual_seed(0), tc)
    names = [n for n, _ in m.named_parameters()]
    assert list(state["ef"]) == names == list(state["m"])
    state, met = make_train_step(m, tc)(state, {"tokens": torch.zeros(
        (2, 16), dtype=torch.int32)})
    assert torch.isfinite(met["loss"]) and "ef" in state
    assert all(p.grad is None for p in m.parameters())


def test_train_lm_flow_checkpoints_and_resumes(tmp_path, capsys):
    """python -m repro_torch.train.lm on the CPU: JoSS-placed batches, the
    train step, async checkpoints, then a resume from the latest one."""
    from repro_torch.train import lm
    args = ["--smoke", "--device", "cpu", "--batch", "4", "--seq-len", "32",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "4"]
    lm.main(args + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "final checkpoint: step 6" in out
    assert "data locality: host=" in out and "off-pod=0.00" in out
    lm.main(args + ["--steps", "10", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "step   10  loss" in out
    assert "final checkpoint: step 10" in out


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_in_pieces_gives_the_same_bits(monkeypatch, state_dtype):
    """Leaves above ``optimizer.CHUNK`` elements are updated in flat
    pieces: with CHUNK cut to 37, every leaf of a bf16 tree (odd sizes
    included) takes the piecewise path, and params and moments come out
    bit-equal to the whole-leaf update (no clipping: the clip scale comes
    from the norm, which adds the pieces' sums and so agrees only to f32
    rounding)."""
    from repro_torch.train import optimizer as opt
    gen = torch.Generator().manual_seed(11)
    shapes = {"layers.0.w": (13, 29), "layers.0.b": (29,), "embed": (50, 8),
              "norm": (8,)}
    cfg = OptConfig(lr=0.05, warmup_steps=1, total_steps=10,
                    weight_decay=0.1, grad_clip=0.0, state_dtype=state_dtype)
    grads = [{n: torch.randn(s, generator=gen).to(torch.bfloat16)
              for n, s in shapes.items()} for _ in range(3)]
    init = {n: torch.randn(s, generator=gen).to(torch.bfloat16)
            for n, s in shapes.items()}
    out = []
    for chunk in (opt.CHUNK, 37):
        monkeypatch.setattr(opt, "CHUNK", chunk)
        params = {n: t.clone() for n, t in init.items()}
        state = adamw_init(params, state_dtype)
        norms = []
        for g in grads:
            state, met = adamw_update(cfg, g, state, params)
            norms.append(float(met["grad_norm"]))
        out.append((params, state, norms))
    (p1, s1, n1), (p2, s2, n2) = out
    for n in shapes:
        assert torch.equal(p1[n], p2[n]), n
        assert torch.equal(s1["m"][n], s2["m"][n])
        assert torch.equal(s1["v"][n], s2["v"][n])
    assert n2 == pytest.approx(n1, rel=1e-6)
    monkeypatch.setattr(opt, "CHUNK", 37)
    assert float(global_norm(grads[0])) == pytest.approx(n1[0], rel=1e-6)
