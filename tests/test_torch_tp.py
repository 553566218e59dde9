"""Tensor parallelism over the 'model' axis (``repro_torch.sharding.tp``)
for the dense family, against the JAX package.

- The per-rank counts: JAX's train, prefill and decode steps compiled with
  ``tree_shardings`` on (8, 1), (2, 4) and (1, 8) ('data', 'model') meshes
  of 8 fake CPU devices (one JAX process, as tests/test_torch_mesh.py's),
  their per-device flops (``repro.launch.hlo_analysis.analyze_hlo``) and
  argument bytes (``memory_analysis``), against the port's dry run
  (``launch.dryrun.reckon``) on ``MeshShape``s of the same shapes: the
  ratio of each mesh's figure to the (8, 1) one's, the port's within
  RATIO_TOL of JAX's.
- The numerics: the port's model run as M virtual 'model' ranks in one
  process (``tp.place_virtual``: each rank's pieces of the whole leaves,
  the sums over the ranks in rank order) against JAX's model on the same
  parameters: logits, loss and every gradient, the prefill and decode
  steps over the cache split over the ranks' slots.
- The decode kernel's two steps (``flash_decode_partials`` and
  ``flash_decode_merge``, their plain versions on the CPU): the ranks'
  partials over their slots, merged, equal ``flash_attention_ref`` over
  the whole cache.
"""
import functools
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
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import ShapeCell  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import SplitCache  # noqa: E402
from repro_torch.sharding import DEFAULT_RULES, MeshShape  # noqa: E402
from repro_torch.sharding import tp as tpm  # noqa: E402
from repro_torch.train import TrainConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ----------------------------------------------------------- the counts --
#: the meshes, (data, model); the first is every ratio's denominator
MESHES = ((8, 1), (2, 4), (1, 8))
#: the cells: kind -> (seq_len, global batch), n_micro 1
CELLS = {"train": (128, 8), "prefill": (256, 8), "decode": (256, 8)}
#: count configs: qwen3-4b's smoke (its 4 heads do not divide 8: JAX's
#: fallback) and one scaled so heads, d_ff and the padded vocab divide 8
COUNT_CFGS = {"smoke": {}, "div8": dict(n_heads=8, n_kv_heads=2,
                                        d_model=128)}
#: the figures each kind holds: flops where both count the same work
#: (a decode step's flops: JAX repeats its attention on every 'model'
#: rank), argument bytes everywhere
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
    for name, over in spec["cfgs"].items():
        model = build_model(get_config("qwen3-4b").smoke().scaled(**over))
        specs = model.param_specs()
        shapes = shape_tree(specs)
        for shape in spec["meshes"]:
            mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2)
            psh = tree_shardings(mesh, rules, axes_tree(specs), shapes)
            for kind, (S, B) in spec["cells"].items():
                cell = ShapeCell(kind, S, B, kind)
                with jax.set_mesh(mesh), use_rules(mesh, rules):
                    if kind == "train":
                        ost = opt_shapes(shapes, "float32")
                        osh = tree_shardings(mesh, rules, opt_state_axes(
                            specs, mesh, rules, zero1=True), ost)
                        batch = model.input_specs(cell)
                        bsh = tree_shardings(mesh, rules,
                                             model.input_axes(cell), batch)
                        low = jax.jit(make_train_step(
                            model, TrainConfig(n_micro=1)),
                            in_shardings=(psh, osh, bsh)).lower(
                                shapes, ost, batch)
                    elif kind == "prefill":
                        batch = model.input_specs(cell)
                        bsh = tree_shardings(mesh, rules,
                                             model.input_axes(cell), batch)
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
    import json
    out = tmp_path_factory.mktemp("tp") / "jax.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    spec = {"cfgs": COUNT_CFGS, "meshes": MESHES, "cells": CELLS}
    proc = subprocess.run([sys.executable, "-c", JAX_PROG, str(out),
                           json.dumps(spec)], env=env, cwd=REPO,
                          capture_output=True, text=True,
                          timeout=JAX_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


@functools.lru_cache(maxsize=None)
def _port_counts(name, kind, shape):
    S, B = CELLS[kind]
    cfg = tconfigs.get_config("qwen3-4b").smoke().scaled(**COUNT_CFGS[name])
    row = dryrun.reckon(cfg, ShapeCell(kind, S, B, kind),
                        MeshShape(("data", "model"), shape), DEFAULT_RULES,
                        TrainConfig(n_micro=1) if kind == "train" else None)
    return {"flops": row["flops_per_dev"],
            "argument_bytes": row["memory"]["argument_bytes"]}


@pytest.mark.parametrize("shape", MESHES[1:], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", sorted(CELLS))
@pytest.mark.parametrize("name", sorted(COUNT_CFGS))
def test_per_rank_ratios_follow_jax(jax_counts, name, kind, shape):
    """Moving ranks from 'data' to 'model', the port's per-rank flops and
    argument bytes change as JAX's compiled step's do: the compute stays
    flat (split over 'model', not repeated), the weights and the decode
    cache shrink."""
    base = MESHES[0]
    for fig in HELD[kind]:
        want = (jax_counts[_key(name, kind, shape)][fig]
                / jax_counts[_key(name, kind, base)][fig])
        got = (_port_counts(name, kind, shape)[fig]
               / _port_counts(name, kind, base)[fig])
        assert abs(got / want - 1) <= RATIO_TOL, (fig, got, want)


def test_production_dense_train_is_tensor_parallel():
    """qwen3-4b train_4k on the 16 x 16 mesh: a rank computes its share
    of the model, not its 'model' group's whole (useful flop fraction
    0.042 under storage sharding)."""
    row = dryrun.lower_cell("qwen3-4b", "train_4k")
    assert row["useful_flop_fraction"] >= 0.4, row["useful_flop_fraction"]
    assert row["flops_per_dev"] < 2 * row["model_flops_global"] / 256


# ------------------------------------------------------------ the plan --
def _meta(arch, **over):
    return build_model(tconfigs.get_config(arch).scaled(**over),
                       device="meta")


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_tp_leaves_are_the_dense_familys(arch):
    """At M = 16 every leaf of the dense family's roles goes
    tensor-parallel (their dims divide); the other families' leaves are
    groups of their own roles (tests/test_torch_tp_families.py holds
    each family's)."""
    model = _meta(arch, n_layers=2)
    leaves = tpm.tp_leaves(model, MeshShape.of(data=16, model=16),
                           DEFAULT_RULES)
    if model.cfg.family != "dense":
        assert leaves and set(leaves) <= set(model.tp_roles())
        assert leaves["embed"] == (0, False)
        return
    assert set(leaves) == set(model.tp_roles())
    assert leaves["layers.0.mlp.wi"] == (1, True)
    assert leaves["embed"] == (0, False)
    assert all(k in leaves for k in ("layers.1.attn.wq", "layers.1.attn.wo"))


def test_a_group_that_does_not_divide_stays_whole():
    """d_ff 40 at M = 16: the rules split ``wi`` (80 columns) but not
    ``wo`` (40 rows), so the MLP keeps storage sharding; the attention and
    vocab still go tensor-parallel. Where heads x hd do not divide, the
    attention stays whole too."""
    model = _meta("qwen3-4b", n_layers=1, d_ff=40)
    leaves = tpm.tp_leaves(model, MeshShape.of(model=16), DEFAULT_RULES)
    assert not any(".mlp." in n for n in leaves)
    assert "layers.0.attn.wq" in leaves and "embed" in leaves
    model = _meta("qwen3-4b", n_layers=1, n_heads=5, n_kv_heads=1,
                  head_dim=3)
    leaves = tpm.tp_leaves(model, MeshShape.of(model=16), DEFAULT_RULES)
    assert not any(".attn." in n for n in leaves)


@pytest.mark.parametrize("paired", (False, True))
def test_pieces_rebuild_the_whole_leaf(paired):
    """Rank r's piece of SwiGLU's ``wi`` is its gate columns beside its up
    columns; the pieces rebuild JAX's layout."""
    full = torch.arange(6 * 16, dtype=torch.float32).reshape(6, 16)
    role = (1, paired)
    pieces = [tpm.piece(full, role, 4, r) for r in range(4)]
    assert torch.equal(tpm.whole(pieces, role), full)
    if paired:
        gate, up = pieces[1].chunk(2, dim=1)
        assert torch.equal(gate, full[:, 2:4])
        assert torch.equal(up, full[:, 10:12])


# ------------------------------------------------------- the numerics --
#: f32 on both sides, summation order apart (tests/test_torch_transformer.py)
ATOL, RTOL = 1e-4, 1e-4
#: the gradients: f32, summed over the ranks in another order
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
B, S, CACHE_LEN, STEPS = 8, 16, 24, 3
CASES = {
    "qwen3-4b": ("qwen3-4b", {}),                  # qk_norm
    "qwen2.5-14b": ("qwen2.5-14b", {}),            # qkv_bias
    "granite-3-2b": ("granite-3-2b", {}),          # tied embeddings
    "stablelm-12b": ("stablelm-12b", {}),          # layernorm
    "qwen3-4b-padded": ("qwen3-4b", {"vocab": 250}),   # -1e9 vocab tail
}
#: M 2: a rank's kv heads are its own columns; 4: a head a rank, the kv
#: heads gathered; 8: the 4 heads do not divide (head groups of 2 ranks)
RANKS = (2, 4, 8)


@functools.lru_cache(maxsize=None)
def _jax_side(case):
    """JAX's params (perturbed off their unit norms and zero biases),
    tokens, and its logits, loss, gradients and decode logits."""
    arch, over = CASES[case]
    jcfg = jconfigs.get_config(arch).smoke().scaled(**over)
    model = jax_build(jcfg)
    params = model.init(jax.random.PRNGKey(3))
    rng = np.random.RandomState(5)
    params = jax.tree_util.tree_map(
        lambda a: a + (0.1 * rng.randn(*a.shape)).astype(a.dtype)
        if a.ndim <= 2 and a.shape[-1] != jcfg.padded_vocab
        and a.shape[0] != jcfg.padded_vocab else a, params)
    toks = np.random.RandomState(2).randint(
        0, jcfg.vocab, (B, S + STEPS)).astype(np.int32)
    jt = jnp.asarray(toks)
    batch = {"tokens": jt[:, :S]}
    (loss, _), grads = jax.value_and_grad(
        lambda p: model.loss(p, batch, remat=False), has_aux=True)(params)
    out = {"forward": model.forward(params, batch, remat=False),
           "loss": loss}
    logits, cache = model.prefill(params, batch, cache_len=CACHE_LEN)
    out["prefill"] = logits
    for t in range(S, S + STEPS):
        lg, cache = model.decode_step(params, cache, jt[:, t:t + 1],
                                      jnp.int32(t))
        out[f"decode{t}"] = lg
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (tree(params), toks, {k: np.asarray(v) for k, v in out.items()},
            tree(grads))


def _virtual(case, M, attn_impl="flash"):
    np_params, toks, ref, grads = _jax_side(case)
    arch, over = CASES[case]
    cfg = tconfigs.get_config(arch).smoke().scaled(**over)
    model = build_model(cfg, device="cpu", attn_impl=attn_impl)
    model.load_state_dict(params_from_jax(cfg, np_params), strict=True)
    leaves = tpm.place_virtual(model, M)
    assert leaves and model.tp.M == M
    return model, torch.from_numpy(toks), ref, grads


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("M", RANKS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_parallel_training_matches_jax(case, M):
    """Logits, loss and every gradient of M virtual ranks equal JAX's
    single-program ones (the function GSPMD splits)."""
    model, toks, ref, grads = _virtual(case, M)
    batch = {"tokens": toks[:, :S]}
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
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=k)


@pytest.mark.parametrize("M", RANKS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_parallel_decode_matches_jax(case, M):
    """The prefill and three decode steps of M virtual ranks, the cache
    split over their slots (CACHE_LEN / M each), equal JAX's logits."""
    model, toks, ref, _ = _virtual(case, M)
    with torch.no_grad():
        logits, cache = model.prefill({"tokens": toks[:, :S]},
                                      cache_len=CACHE_LEN)
        np.testing.assert_allclose(logits.numpy(), ref["prefill"],
                                   atol=ATOL, rtol=RTOL)
        assert isinstance(cache, SplitCache) and cache.slots == CACHE_LEN
        assert [c.k.shape[2] for c in cache.parts] == [CACHE_LEN // M] * M
        for t in range(S, S + STEPS):
            lg, cache = model.decode_step(cache, toks[:, t:t + 1], t)
            np.testing.assert_allclose(lg.numpy(), ref[f"decode{t}"],
                                       atol=ATOL, rtol=RTOL, err_msg=str(t))


@pytest.mark.parametrize("M", (2, 4))
def test_plain_attention_decodes_without_the_kernel(M, monkeypatch):
    """A model built with attn_impl "ref" decodes over the split cache
    through the plain versions of the kernel's two steps: no flash
    wrapper is called, and the logits equal JAX's."""
    model, toks, ref, _ = _virtual("qwen3-4b", M, attn_impl="ref")

    def refuse(*args, **kw):
        raise AssertionError("a flash wrapper was called")

    for name in ("flash_attention", "flash_decode_partials",
                 "flash_decode_merge"):
        monkeypatch.setattr(fa, name, refuse)
    with torch.no_grad():
        _, cache = model.prefill({"tokens": toks[:, :S]},
                                 cache_len=CACHE_LEN)
        assert isinstance(cache, SplitCache)
        for t in range(S, S + STEPS):
            lg, cache = model.decode_step(cache, toks[:, t:t + 1], t)
            np.testing.assert_allclose(lg.numpy(), ref[f"decode{t}"],
                                       atol=ATOL, rtol=RTOL, err_msg=str(t))


# ------------------------------------------------ the two-step decode --
def _decode_inputs(Sk, kpos, dtype, seed, Bq=2, H=8, G=2, D=64):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(Bq, 1, H, D, generator=g).to(dtype)
    k = torch.randn(Bq, Sk, G, D, generator=g).to(dtype)
    v = torch.randn(Bq, Sk, G, D, generator=g).to(dtype)
    return q, k, v, torch.as_tensor(kpos, dtype=torch.int32)


def _split_decode(q, k, v, qpos, kpos, M, window):
    """Each of M ranks' partials over its slots, merged in rank order."""
    C = k.shape[1] // M
    parts = torch.stack([fa.flash_decode_partials(
        q, k[:, r * C:(r + 1) * C], v[:, r * C:(r + 1) * C], causal=True,
        window=window, qpos=qpos, kpos=kpos[r * C:(r + 1) * C])
        for r in range(M)])
    assert parts.shape == (M, q.shape[0] * q.shape[2], 2 + q.shape[3])
    Bq, _, H, D = q.shape
    return fa.flash_decode_merge(parts, q.dtype).reshape(Bq, 1, H, D)


#: decode cases: name -> (slots, kpos of the ring, query position, window)
DECODE_CASES = {
    # S_max 544 over 4 ranks: 136 slots each, not a multiple of the
    # kernel's 64-key tile; the last 12 slots still empty
    "ragged_544": (544, np.r_[np.arange(532), -np.ones(12)], 531, 0),
    # a 128-slot ring after position 300, window 100: slot p % 128 holds
    # p, the oldest slots outside the window
    "windowed_ring": (128, np.array([300 - (300 - s) % 128
                                     for s in range(128)]), 300, 100),
}


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_partials_merged_over_ranks_equal_attention(case, dtype):
    Sk, kpos, qp, window = DECODE_CASES[case]
    q, k, v, kpos = _decode_inputs(Sk, kpos, dtype, seed=Sk)
    qpos = torch.tensor([qp], dtype=torch.int32)
    got = _split_decode(q, k, v, qpos, kpos, 4, window)
    want = fa.flash_attention_ref(q, k, v, causal=True, window=window,
                                  qpos=qpos, kpos=kpos)
    atol = 1e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=atol, rtol=1e-3)
    # one rank: the merge of a single partial is the split kernel's plain
    # version over the whole cache
    one = _split_decode(q, k, v, qpos, kpos, 1, window)
    ref = fa.flash_decode_ref(q, k, v, n_split=1, causal=True,
                              window=window, qpos=qpos, kpos=kpos)
    np.testing.assert_allclose(one.float().numpy(), ref.float().numpy(),
                               atol=atol, rtol=1e-3)


def test_decode_partials_of_a_rank_with_no_valid_key():
    """A rank whose slots are all empty gives m = NEG_INF, l = 0,
    acc = 0, and adds nothing to the merge."""
    q, k, v, kpos = _decode_inputs(128, np.r_[np.arange(64), -np.ones(64)],
                                   torch.float32, seed=9)
    qpos = torch.tensor([63], dtype=torch.int32)
    part = fa.flash_decode_partials(q, k[:, 64:], v[:, 64:], qpos=qpos,
                                    kpos=kpos[64:])
    assert bool((part[:, 0] == fa.NEG_INF).all())
    assert not part[:, 1:].any()
    got = _split_decode(q, k, v, qpos, kpos, 2, 0)
    want = fa.flash_attention_ref(q, k, v, qpos=qpos, kpos=kpos)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-4)
