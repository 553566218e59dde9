"""Tensor parallelism over the 'model' axis (``repro_torch.sharding.tp``)
for the families beside the dense one: moe (dbrx-132b, arctic-480b), vlm
(internvl2-26b), encdec (whisper-medium), ssm (rwkv6-7b) and hybrid
(hymba-1.5b), against the JAX package.

- The plan: on the production (16, 16) mesh every family's
  tensor-parallel leaves are the groups of its ``tp_roles`` that the
  rules split over 'model' alone.
- The per-rank counts: JAX's train, prefill and decode steps compiled with
  ``tree_shardings`` on (8, 1) and (2, 4) ('data', 'model') meshes of 8
  fake CPU devices (one JAX process), their per-device flops and
  argument bytes, against the port's dry run (``launch.dryrun.reckon``)
  on ``MeshShape``s of the same shapes, as ``test_torch_tp.py`` holds the
  dense family: the ratio of (2, 4)'s figure to (8, 1)'s, the port's
  within RATIO_TOL of JAX's. One smoke config a family, scaled so that
  heads, kv heads, d_ff, experts and the padded vocab divide 8.
- The numerics: each family's smoke config run as M virtual 'model'
  ranks (``tp.place_virtual``) against JAX's model on the same
  parameters: logits, loss and every gradient, the prefill and decode
  steps over the split caches (the KV rings and encdec's cross K/V over
  the ranks' slots, rwkv6's and hymba's states over the ranks' heads,
  the MoE decode on each rank's E/M experts). At M 8 the smoke configs'
  4 heads do not divide: their head groups repeat on 2 ranks each (JAX's
  fallback), and the 4 experts stay whole (the dense dispatch).
- The MoE decode on held experts: each rank's E/M experts' rows of the
  dense dispatch, summed over the ranks, give the dense dispatch's bits
  and drop JAX's pairs.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import ShapeCell  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import (build_model, moe, prefix_len,  # noqa: E402
                                side_inputs)
from repro_torch.models.moe_ep import moe_ffn_held  # noqa: E402
from repro_torch.models.transformer import SplitCache, kv_index  # noqa: E402
from repro_torch.sharding import DEFAULT_RULES, MeshShape  # noqa: E402
from repro_torch.sharding import tp as tpm  # noqa: E402
from repro_torch.train import TrainConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY_ARCHS = ("dbrx-132b", "arctic-480b", "internvl2-26b",
                "whisper-medium", "rwkv6-7b", "hymba-1.5b")


# ------------------------------------------------------------ the plan --
def _meta(arch, **over):
    return build_model(tconfigs.get_config(arch).scaled(**over),
                       device="meta")


#: the leaves of each family's groups that the production rules do not
#: split over 'model' alone at M 16: hymba-1.5b's 25 heads do not divide,
#: so its per-head SSM leaves stay whole (their compute repeats)
WHOLE_AT_16 = {"hymba-1.5b": ("ssm.wdt", "ssm.a_log", "ssm.dt_bias")}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_production_plan_names_every_familys_groups(arch):
    """On the (16, 16) mesh a family's tensor-parallel leaves are its
    roles' groups whose dims the rules split over 'model': the
    attention (with hymba's output norm), the MLPs, the vocab, encdec's
    encoder and cross-attention, rwkv6's time- and channel-mix, hymba's
    SSM projections; never the experts, arctic's or internvl2's dense
    whole-only leaves, or vlm's projector."""
    model = _meta(arch, n_layers=2,
                  **({"encoder_layers": 2} if arch == "whisper-medium"
                     else {}))
    leaves = tpm.tp_leaves(model, MeshShape.of(data=16, model=16),
                           DEFAULT_RULES)
    roles = model.tp_roles()
    whole = {n for n in roles
             if any(n.endswith(w) for w in WHOLE_AT_16.get(arch, ()))}
    assert set(leaves) == set(roles) - whole
    assert not any(".moe." in n or "projector" in n for n in leaves)
    per_layer = {
        "dbrx-132b": ("attn.wq", "attn.wo"),
        "arctic-480b": ("attn.wq", "dense_mlp.wi", "dense_mlp.wo"),
        "internvl2-26b": ("attn.wk", "mlp.wi", "mlp.wo"),
        "whisper-medium": ("attn.wq", "xattn.wk", "xattn.wo", "mlp.wi"),
        "rwkv6-7b": ("att.wr", "att.wB", "att.w0", "att.u", "att.ln_x",
                     "att.wo", "ffn.wk", "ffn.wv"),
        "hymba-1.5b": ("attn.wq", "attn_norm", "ssm.wx", "ssm.wB",
                       "ssm.norm", "ssm.wo", "mlp.wi"),
    }[arch]
    assert {f"layers.1.{n}" for n in per_layer} <= set(leaves)
    assert leaves["embed"] == (0, False)
    if arch == "whisper-medium":
        assert "encoder.1.attn.wv" in leaves and "encoder.0.mlp.wo" in leaves


# ----------------------------------------------------------- the counts --
#: the meshes, (data, model): each config's ratio is its second mesh's
#: figure over its first's. The moe config's base is (1, 8): at
#: 'model' 1 JAX's MoE falls back to the dense dispatch on the global
#: batch, its (E, C, d) buffer replicated over 'data' (every data rank
#: computes every token's experts). The port's data rank keeps and drops
#: JAX's pairs (``moe_ep.global_pairs``) but computes its own kept pairs
#: only, in min(C, T / |data|) rows an expert, so its expert flops stay a
#: fraction of JAX's compiled count by design; at 'model' 8 both run
#: expert-parallel
MESHES = ((8, 1), (2, 4))
BASE = {"moe": (1, 8)}
#: the cells: kind -> (seq_len, global batch), n_micro 1
CELLS = {"train": (128, 8), "prefill": (256, 8), "decode": (256, 8)}
#: one config a family: its smoke config with heads, kv heads, d_ff,
#: experts and the padded vocab dividing 8
DIV8 = dict(n_heads=8, d_model=128)
COUNT_CFGS = {
    "moe": ("arctic-480b", dict(DIV8, n_kv_heads=8, n_experts=8)),
    "vlm": ("internvl2-26b", dict(DIV8, n_kv_heads=8)),
    "encdec": ("whisper-medium", dict(DIV8, n_kv_heads=8)),
    "ssm": ("rwkv6-7b", dict(DIV8, n_kv_heads=8)),
    "hybrid": ("hymba-1.5b", dict(DIV8, n_kv_heads=8)),
}
#: the figures each kind holds (``test_torch_tp.py``'s: a decode step's
#: attention repeats on every 'model' rank in JAX's)
HELD = {"train": ("flops", "argument_bytes"),
        "prefill": ("flops", "argument_bytes"),
        "decode": ("argument_bytes",)}
#: the port's ratio against JAX's: |port / jax - 1|
RATIO_TOL = 0.2
#: seconds for the JAX process
JAX_TIMEOUT_S = 600

JAX_PROG = textwrap.dedent("""
    import json, sys
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.configs.base import ShapeCell
    from repro.launch.dryrun import opt_shapes
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.models import build_model
    from repro.models.common import axes_tree, shape_tree
    from repro.sharding import DEFAULT_RULES as rules, tree_shardings, use_rules
    from repro.train import (TrainConfig, make_prefill_step, make_serve_step,
                             make_train_step)
    from repro.train.optimizer import opt_state_axes
    spec = json.loads(sys.argv[2])
    out = {}
    for name, (arch, over) in spec["cfgs"].items():
        model = build_model(get_config(arch).smoke().scaled(**over))
        specs = model.param_specs()
        shapes = shape_tree(specs)
        for shape in (spec["meshes"] if name in spec["base"] else
                      spec["meshes"][:2]):
            mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2)
            psh = tree_shardings(mesh, rules, axes_tree(specs), shapes)
            for kind, (S, B) in spec["cells"].items():
                cell = ShapeCell(kind, S, B, kind)
                with jax.set_mesh(mesh), use_rules(mesh, rules):
                    if kind in ("train", "prefill"):
                        batch = model.input_specs(cell)
                        bsh = tree_shardings(mesh, rules,
                                             model.input_axes(cell), batch)
                    if kind == "train":
                        ost = opt_shapes(shapes, "float32")
                        osh = tree_shardings(mesh, rules, opt_state_axes(
                            specs, mesh, rules, zero1=True), ost)
                        low = jax.jit(make_train_step(
                            model, TrainConfig(n_micro=1)),
                            in_shardings=(psh, osh, bsh)).lower(
                                shapes, ost, batch)
                    elif kind == "prefill":
                        low = jax.jit(make_prefill_step(model),
                                      in_shardings=(psh, bsh)).lower(
                                          shapes, batch)
                    else:
                        inp = model.input_specs(cell)
                        ax = model.input_axes(cell)
                        tsh = tree_shardings(
                            mesh, rules, {"t": ax["tokens"]},
                            {"t": inp["tokens"]})["t"]
                        csh = tree_shardings(mesh, rules, model.cache_axes(),
                                             inp["cache"])
                        low = jax.jit(make_serve_step(model),
                                      in_shardings=(psh, csh, tsh, None)
                                      ).lower(shapes, inp["cache"],
                                              inp["tokens"], inp["pos"])
                    comp = low.compile()
                key = f"{name}/{kind}/{shape[0]}x{shape[1]}"
                out[key] = {
                    "flops": analyze_hlo(comp.as_text(), 8).flops,
                    "argument_bytes":
                        comp.memory_analysis().argument_size_in_bytes}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""")


def _key(name, kind, shape):
    return f"{name}/{kind}/{shape[0]}x{shape[1]}"


@pytest.fixture(scope="module")
def jax_counts(tmp_path_factory):
    """JAX's per-device figures of every (config, kind, mesh), from one
    process with 8 fake CPU devices."""
    out = tmp_path_factory.mktemp("tpf") / "jax.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    spec = {"cfgs": COUNT_CFGS, "meshes": MESHES + tuple(BASE.values()),
            "cells": CELLS, "base": sorted(BASE)}
    proc = subprocess.run([sys.executable, "-c", JAX_PROG, str(out),
                           json.dumps(spec)], env=env, cwd=REPO,
                          capture_output=True, text=True,
                          timeout=JAX_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


@functools.lru_cache(maxsize=None)
def _port_counts(name, kind, shape):
    S, B = CELLS[kind]
    arch, over = COUNT_CFGS[name]
    cfg = tconfigs.get_config(arch).smoke().scaled(**over)
    row = dryrun.reckon(cfg, ShapeCell(kind, S, B, kind),
                        MeshShape(("data", "model"), shape), DEFAULT_RULES,
                        TrainConfig(n_micro=1) if kind == "train" else None)
    return {"flops": row["flops_per_dev"],
            "argument_bytes": row["memory"]["argument_bytes"]}


@pytest.mark.parametrize("kind", sorted(CELLS))
@pytest.mark.parametrize("name", sorted(COUNT_CFGS))
def test_per_rank_ratios_follow_jax(jax_counts, name, kind):
    """Moving ranks from 'data' to 'model', the port's per-rank flops and
    argument bytes change as JAX's compiled step's do: the compute split
    over 'model', not repeated; the weights, the experts and the decode
    cache (or state) shrink."""
    base, shape = BASE.get(name, MESHES[0]), MESHES[1]
    for fig in HELD[kind]:
        want = (jax_counts[_key(name, kind, shape)][fig]
                / jax_counts[_key(name, kind, base)][fig])
        got = (_port_counts(name, kind, shape)[fig]
               / _port_counts(name, kind, base)[fig])
        assert abs(got / want - 1) <= RATIO_TOL, (fig, got, want)


# ------------------------------------------------------- the numerics --
#: f32 on both sides, summation order apart (tests/test_torch_tp.py's)
ATOL, RTOL = 1e-4, 1e-4
#: the gradients: tests/test_torch_tp.py's, the absolute part scaled by a
#: leaf's largest element where that exceeds 1: rwkv6's ``u`` gradient
#: reaches ~2e2 beside elements of ~1e-1, and there the unsharded port
#: itself lands 5-13 x GRAD_ATOL from JAX (the GLA scan's f32 sums)
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
B, S, STEPS, N_FRAMES = 4, 16, 3, 32
#: M 2 and 4: the smoke configs' 4 heads divide; 8: they do not (head
#: groups of 2 ranks, JAX's fallback)
RANKS = (2, 4, 8)


def _cache_len(cfg):
    """The prompt, the prefix and the decode steps, rounded up to
    divide by every M of RANKS."""
    return -(-(prefix_len(cfg) + S + STEPS) // 8) * 8


@functools.lru_cache(maxsize=None)
def _jax_side(arch):
    """JAX's params (perturbed off their unit norms and zero biases),
    the inputs, and its logits, loss, gradients and decode logits."""
    jcfg = jconfigs.get_config(arch).smoke()
    tcfg = tconfigs.get_config(arch).smoke()
    model = jax_build(jcfg)
    params = model.init(jax.random.PRNGKey(3))
    rng = np.random.RandomState(5)
    params = jax.tree_util.tree_map(
        lambda a: a + (0.1 * rng.randn(*a.shape)).astype(a.dtype)
        if a.ndim <= 2 and a.shape[-1] != jcfg.padded_vocab
        and a.shape[0] != jcfg.padded_vocab else a, params)
    toks = np.random.RandomState(2).randint(
        0, jcfg.vocab, (B, S + STEPS)).astype(np.int32)
    side = side_inputs(tcfg, B, seed=4, n_frames=N_FRAMES)
    jside = {k: jnp.asarray(v) for k, v in side.items()}
    jt = jnp.asarray(toks)
    batch = dict(jside, tokens=jt[:, :S])
    (loss, _), grads = jax.value_and_grad(
        lambda p: model.loss(p, batch, remat=False), has_aux=True)(params)
    out = {"forward": model.forward(params, batch, remat=False),
           "loss": loss}
    off = prefix_len(jcfg)
    logits, cache = model.prefill(params, batch, cache_len=_cache_len(jcfg))
    out["prefill"] = logits
    for t in range(S, S + STEPS):
        lg, cache = model.decode_step(params, cache, jt[:, t:t + 1],
                                      jnp.int32(off + t))
        out[f"decode{t}"] = lg
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (tree(params), toks, side,
            {k: np.asarray(v) for k, v in out.items()}, tree(grads))


def _virtual(arch, M):
    np_params, toks, side, ref, grads = _jax_side(arch)
    cfg = tconfigs.get_config(arch).smoke()
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, np_params), strict=True)
    leaves = tpm.place_virtual(model, M)
    assert leaves and model.tp.M == M
    side = {k: torch.from_numpy(v) for k, v in side.items()}
    return model, torch.from_numpy(toks), side, ref, grads


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread a test process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("M", RANKS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_tensor_parallel_training_matches_jax(arch, M):
    """Logits, loss and every gradient of M virtual ranks equal JAX's
    single-program ones (the function GSPMD splits)."""
    model, toks, side, ref, grads = _virtual(arch, M)
    batch = dict(side, tokens=toks[:, :S])
    np.testing.assert_allclose(model.forward(batch).numpy(), ref["forward"],
                               atol=ATOL, rtol=RTOL)
    loss, _ = model.loss(batch, remat=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref["loss"]), rtol=1e-5)
    got = _leaves(params_to_numpy(model.cfg, {
        n: p.grad for n, p in model.named_parameters()}))
    want = _leaves(grads)
    assert set(got) == set(want)
    for k in want:
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_ATOL * scale,
                                   rtol=GRAD_RTOL, err_msg=k)


def _rank_cache(cache, cfg, M):
    """What each rank of the split cache holds: the KV ring's slots (and
    encdec's cross K/V's), a state's heads."""
    assert isinstance(cache, SplitCache)
    parts = cache.parts
    fam = cfg.family
    if fam == "ssm":
        return [tuple(c.state.shape[2:3]) for c in parts]
    out = [(c.k.shape[2],) for c in parts]
    if fam == "encdec":
        out = [o + (c.xk.shape[2],) for o, c in zip(out, parts)]
    if fam == "hybrid":
        out = [o + (c.ssm.shape[2],) for o, c in zip(out, parts)]
    return out


@pytest.mark.parametrize("M", RANKS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_tensor_parallel_decode_matches_jax(arch, M):
    """The prefill and three decode steps of M virtual ranks over the
    split caches equal JAX's logits; each rank holds its slots of every
    KV ring (and of encdec's cross K/V) and its heads of a state."""
    model, toks, side, ref, _ = _virtual(arch, M)
    cfg = model.cfg
    off = prefix_len(cfg)
    C = _cache_len(cfg)
    with torch.no_grad():
        logits, cache = model.prefill(dict(side, tokens=toks[:, :S]),
                                      cache_len=C)
        np.testing.assert_allclose(logits.numpy(), ref["prefill"],
                                   atol=ATOL, rtol=RTOL)
        heads = cfg.n_heads // (4 if M == 8 else M)   # gcd(4, M) groups
        want = {"ssm": (heads,), "encdec": (C // M, N_FRAMES // 2 // M),
                "hybrid": (C // M, heads)}.get(cfg.family, (C // M,))
        assert _rank_cache(cache, cfg, M) == [want] * M
        for t in range(S, S + STEPS):
            lg, cache = model.decode_step(cache, toks[:, t:t + 1], off + t)
            np.testing.assert_allclose(lg.numpy(), ref[f"decode{t}"],
                                       atol=ATOL, rtol=RTOL, err_msg=str(t))


# -------------------------------------------- the MoE decode, held experts --
@pytest.mark.parametrize("M", (2, 4))
@pytest.mark.parametrize("arch", ["dbrx-132b", "arctic-480b"])
def test_held_experts_decode_is_the_dense_dispatch_and_drops_jaxs(arch, M):
    """A decode step's 256 tokens (S 1) through a router skewed towards
    expert 0 at capacity factor 0.5 (C 128): each of M ranks runs its E/M
    experts' rows; the sum over the ranks is the dense dispatch's output
    bit for bit, within ATOL of JAX's ``moe_ffn``, and drops as many
    pairs as JAX's routing does."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch).smoke(),
                               capacity_factor=0.5)
    tcfg = dataclasses.replace(tconfigs.get_config(arch).smoke(),
                               capacity_factor=0.5)
    rng = np.random.RandomState(3)
    T, d, E = 256, tcfg.d_model, tcfg.n_experts
    x = rng.randn(T, 1, d).astype(np.float32) + 1.0
    fin = 2 * tcfg.d_ff if tcfg.act == "swiglu" else tcfg.d_ff
    p = {"router": (rng.randn(d, E) / np.sqrt(d)).astype(np.float32),
         "wi": (rng.randn(E, d, fin) / np.sqrt(d)).astype(np.float32),
         "wo": (rng.randn(E, tcfg.d_ff, d) / np.sqrt(tcfg.d_ff)
                ).astype(np.float32)}
    p["router"][:, 0] += 3.0 / d
    experts = moe.Experts(tcfg, torch.device("cpu"))
    for k, v in p.items():
        getattr(experts, k).data.copy_(torch.from_numpy(v))
    tx = torch.from_numpy(x)
    with torch.no_grad():
        dense, _ = moe.moe_ffn(tcfg, experts, tx)
        held, _, dropped = moe_ffn_held(tcfg, experts, tx, M)
    assert torch.equal(held, dense)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want, _ = jax_moe.moe_ffn(jcfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(held.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    _, jtopi, _ = jax_moe.route(jcfg, jp["router"],
                                jnp.asarray(x.reshape(T, d)))
    C = jax_moe.capacity(jcfg, T)
    counts = np.bincount(np.asarray(jtopi).reshape(-1), minlength=E)
    assert dropped == np.maximum(counts - C, 0).sum() > 0


# -------------------------------------- heads that repeat on every rank --
@pytest.mark.parametrize("arch", ["hymba-1.5b", "internvl2-26b"])
def test_heads_repeated_on_every_rank_match_the_unsharded_model(arch):
    """9 heads over 3 kv heads at M 4: gcd(9, 4) = 1, so every rank runs
    all 9 heads (hymba-1.5b's 25 at M 16) and reads the 3 kv heads they
    span (``kv_index``); the logits, prefill and decode equal the
    unsharded model's."""
    cfg = tconfigs.get_config(arch).smoke().scaled(
        n_heads=9, n_kv_heads=3, d_model=144)
    ref = build_model(cfg, device="cpu")
    ref.init_params(torch.Generator().manual_seed(11))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(ref.state_dict())
    assert tpm.place_virtual(model, 4)
    assert len(kv_index(cfg, 1, 0)) == 3
    toks = torch.from_numpy(np.random.RandomState(12).randint(
        0, cfg.vocab, (2, S + 1)).astype(np.int64))
    side = {k: torch.from_numpy(v)
            for k, v in side_inputs(cfg, 2, seed=13).items()}
    batch = dict(side, tokens=toks[:, :S])
    C, off = _cache_len(cfg), prefix_len(cfg)
    with torch.no_grad():
        np.testing.assert_allclose(model.forward(batch).numpy(),
                                   ref.forward(batch).numpy(),
                                   atol=ATOL, rtol=RTOL)
        want, wc = ref.prefill(batch, cache_len=C)
        got, gc = model.prefill(batch, cache_len=C)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=RTOL)
        want, _ = ref.decode_step(wc, toks[:, S:], off + S)
        got, _ = model.decode_step(gc, toks[:, S:], off + S)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=RTOL)
