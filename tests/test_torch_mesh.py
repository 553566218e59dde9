"""The port's multi-rank layer against the JAX package: the hierarchical
collectives, the MapReduce mesh shuffle (JoSS policies A and B), the
expert-parallel MoE and its dense fallback on the global batch, the
sharded train step (against the port's
single-device step and JAX's sharded step), whose collectives the dry run
reckons byte for byte, tensor-parallel over 'model' for the dense family,
and the sharded serving step with the KV cache split over 'model'.

One module-scoped run starts 8 gloo ranks (tests/torch_mesh_ranks.py)
beside one JAX process with 8 fake CPU devices (``jax.set_mesh``, as the
JAX tests' ``run_sub``), all at once; each test reads its part of their
outputs. ``_partition_pack`` needs no ranks: it is held to JAX's in this
process. JAX's recipes are those of tests/test_multidevice.py (:28, :50,
:78)."""
import collections
import os
import subprocess
import sys
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.mapreduce import JOBS as JJOBS  # noqa: E402
from repro.mapreduce import engine as jengine  # noqa: E402
from repro_torch import mapreduce as mr  # noqa: E402
from repro_torch.configs import ShapeCell, get_config  # noqa: E402
from repro_torch.convert import params_to_numpy  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.moe import (capacity, dispatch,  # noqa: E402
                                    moe_ffn, route)
from repro_torch.models.moe_ep import moe_ffn_ep_virtual  # noqa: E402
from repro_torch.sharding import MeshShape  # noqa: E402
from repro_torch.train import (adamw_init, make_prefill_step,  # noqa: E402
                               make_serve_step, make_train_step)
from repro_torch.mapreduce import engine  # noqa: E402
from repro_torch.mapreduce.jobs import EMPTY, KVBatch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(REPO, "tests", "torch_mesh_ranks.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_mesh_ranks as ranks_mod  # noqa: E402

WORLD = 8
#: seconds for the whole group and the JAX process; past it every process
#: is killed and the tests fail (the JAX process, which compiles every
#: run's steps, took 371 s under the whole suite's load with its 9 train
#: and 5 serving runs)
DEADLINE_S = 600
#: JAX's tolerance for the float collectives (test_multidevice.py:45)
RTOL = 1e-6
#: the jobs JAX's own mesh_mapreduce runs: for II (whose map reads the
#: shard group's index as its doc id) it raises under JAX 0.9 ("pvary is
#: a invariant->variant collective"), so the port's II is held to WC's
#: reducers and to the Counter instead
JAX_JOBS = ("WC",)
#: JAX's EP tolerance (test_multidevice.py::test_moe_ep_matches_dense_dispatch)
EP_ATOL, EP_RTOL = 2e-4, 1e-3
#: the EP aux against JAX's (the same per-rank estimator, pmean'd)
AUX_ATOL = 1e-5
#: test_torch_train.py::test_three_train_steps_match_jax's tolerance on
#: the parameters' change over three steps
STEPS_RTOL = 1e-2
#: the sharded step's gradient norms against the single-device step's:
#: the same f32 gradients, summed over the ranks in another order
NORM_RTOL = 1e-5
#: the losses and gradient norms against JAX's step (XLA's and torch's
#: kernels, f32)
JAX_STEP_RTOL = 1e-5
#: the sharded serving run's logits against the single-device port's and
#: JAX's (f32)
SERVE_ATOL = 1e-4
#: the runs of the dense family
TP_RUNS = ("flat", "pod", "layers", "tp24", "tp18")

JAX_PROG = textwrap.dedent("""
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from functools import partial
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.mapreduce import JOBS, mesh_mapreduce
    from repro.sharding.collectives import (flat_psum, hierarchical_psum,
                                            two_hop_all_to_all)
    sys.path.insert(0, sys.argv[2])
    from torch_mesh_ranks import MR_RUNS, mr_shards
    out = {}
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    x = jnp.arange(8 * 16, dtype=jnp.float32).reshape(8, 16)
    for name, fn in (("hier", hierarchical_psum), ("flat", flat_psum)):
        out["psum_" + name] = np.asarray(shard_map(
            partial(fn, data_axis="data", pod_axis="pod"), mesh=mesh,
            in_specs=P("model"), out_specs=P("model"), check_rep=False)(x))
    mesh = jax.make_mesh((2, 4), ("pod", "model"))
    x = jnp.arange(8 * 8 * 3, dtype=jnp.float32).reshape(8, 8, 3)
    spec = P(("pod", "model"))
    out["a2a_flat"] = np.asarray(shard_map(
        lambda xl: jax.lax.all_to_all(xl[0], ("pod", "model"), split_axis=0,
                                      concat_axis=0, tiled=True)[None],
        mesh=mesh, in_specs=spec, out_specs=spec)(x))
    out["a2a_hier"] = np.asarray(shard_map(
        lambda xl: two_hop_all_to_all(xl[0], pod_axis="pod",
                                      inner_axis="model")[None],
        mesh=mesh, in_specs=spec, out_specs=spec)(x))
    toks, lens = (jnp.asarray(a) for a in mr_shards())
    for run, (shape, names, shuffle, shard) in MR_RUNS.items():
        mesh = jax.make_mesh(shape, names)
        for job in ("WC",):   # II raises under JAX 0.9: see JAX_JOBS
            with jax.set_mesh(mesh):
                res = mesh_mapreduce(JOBS[job], toks, lens, mesh,
                                     shuffle_axes=shuffle, shard_axes=shard)
            for field, val in zip(("unique_keys", "counts", "n_unique",
                                   "dropped"), res):
                out[f"mr_{run}_{job}_{field}"] = np.asarray(val)
    import repro.configs as jconfigs
    from repro.models.moe_ep import moe_ffn_ep
    from repro.sharding import DEFAULT_RULES, use_rules
    from jax.sharding import AxisType
    from torch_mesh_ranks import (EP_CASES, EP_MESH, FALLBACK_MESH, ep_cfg,
                                  ep_inputs)
    for case in EP_CASES:
        # the fallback cases' dense dispatch under GSPMD needs auto axes
        # (JAX 0.9's explicit ones refuse its sharding constraints)
        mesh = (jax.make_mesh(*FALLBACK_MESH[case],
                              axis_types=(AxisType.Auto,) * 2)
                if case in FALLBACK_MESH else jax.make_mesh(*EP_MESH))
        cfg = ep_cfg(case, jconfigs)
        x, p, _ = ep_inputs(case)
        p = {k: jnp.asarray(v) for k, v in p.items()}
        with use_rules(mesh, DEFAULT_RULES):
            y, aux = jax.jit(lambda pp, xx: moe_ffn_ep(cfg, pp, xx))(
                p, jnp.asarray(x))
        out[f"ep_{case}_out"] = np.asarray(y)
        out[f"ep_{case}_aux"] = np.asarray(aux)
    # test_multidevice.py:107's sharded step, run: JAX's make_train_step
    # jitted with the parameters placed by tree_shardings, from the
    # port's seeded parameters; JAX 0.9's make_mesh gives explicit axes,
    # under which the model's gathers do not resolve, so the axes are
    # GSPMD's auto ones, as the package was written for
    import dataclasses
    from repro.models import build_model
    from repro.models.common import axes_tree, shape_tree
    from repro.sharding import tree_shardings
    from repro.train import OptConfig, TrainConfig, adamw_init, make_train_step
    from repro_torch.convert import params_to_numpy
    from torch_mesh_ranks import STEP_OPT, STEP_RUNS, step_batch, step_model
    for run, (arch, shape, names, n_micro, steps, _, over, *rest) in (
            STEP_RUNS.items()):
        rules = DEFAULT_RULES.updated(**(rest[0] if rest else {}))
        mesh = jax.make_mesh(shape, names,
                             axis_types=(AxisType.Auto,) * len(names))
        model = build_model(jconfigs.get_config(arch).smoke().scaled(**over))
        specs = model.param_specs()
        port = step_model(run)
        params = jax.tree_util.tree_map(
            lambda a, s: jnp.asarray(a, s.dtype),
            params_to_numpy(port.cfg, port.state_dict()), shape_tree(specs))
        psh = tree_shardings(mesh, rules, axes_tree(specs), shape_tree(specs))
        params = jax.device_put(params, psh)
        opt = adamw_init(params)
        batch = {k: jnp.asarray(v) for k, v in step_batch(run).items()}
        step = make_train_step(model, TrainConfig(
            n_micro=n_micro, opt=OptConfig(**dataclasses.asdict(STEP_OPT))))
        losses, norms = [], []
        with jax.set_mesh(mesh), use_rules(mesh, rules):
            # the parameters come back placed as they went in, so the
            # next step takes them (the compiler may pick another
            # sharding for a replicated leaf's output)
            fn = jax.jit(step, in_shardings=(psh, None, None),
                         out_shardings=(psh, None, None))
            for _ in range(steps):
                params, opt, m = fn(params, opt, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        out[f"jstep_{run}_losses"] = np.array(losses)
        out[f"jstep_{run}_grad_norms"] = np.array(norms)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"jstep_{run}_param_{jax.tree_util.keystr(path)}"] = (
                np.asarray(leaf, np.float32))
    # the sharded serving runs: JAX's prefill and serve steps jitted with
    # the shardings of tree_shardings on the same meshes
    from repro.train import make_prefill_step, make_serve_step
    from torch_mesh_ranks import SERVE_RUNS, serve_batch, serve_model
    for run, (arch, shape, names, _, P, steps, S_max, *over) in (
            SERVE_RUNS.items()):
        mesh = jax.make_mesh(shape, names,
                             axis_types=(AxisType.Auto,) * len(names))
        model = build_model(jconfigs.get_config(arch).smoke().scaled(
            **(over[0] if over else {})))
        specs = model.param_specs()
        port = serve_model(run)
        params = jax.tree_util.tree_map(
            lambda a, s: jnp.asarray(a, s.dtype),
            params_to_numpy(port.cfg, port.state_dict()), shape_tree(specs))
        psh = tree_shardings(mesh, DEFAULT_RULES, axes_tree(specs),
                             shape_tree(specs))
        params = jax.device_put(params, psh)
        batch = {k: jnp.asarray(v) for k, v in serve_batch(run).items()}
        toks = batch["tokens"]
        cache_sh = tree_shardings(mesh, DEFAULT_RULES, model.cache_axes(),
                                  model.cache_specs(toks.shape[0], S_max))
        with jax.set_mesh(mesh), use_rules(mesh, DEFAULT_RULES):
            nxt, cache = jax.jit(make_prefill_step(model, cache_len=S_max),
                                 in_shardings=(psh, None),
                                 out_shardings=(None, cache_sh))(
                params, batch)
            serve = jax.jit(make_serve_step(model),
                            in_shardings=(psh, cache_sh, None, None),
                            out_shardings=(None, None, cache_sh))
            got, logits = [np.asarray(nxt)], []
            for t in range(P, P + steps):
                nxt, lg, cache = serve(params, cache, nxt, t)
                got.append(np.asarray(nxt))
                logits.append(np.asarray(lg)[:, 0])
        out[f"{run}_tokens"] = np.concatenate(got, axis=1)
        out[f"{run}_logits"] = np.stack(logits, axis=1)
    np.savez(sys.argv[1], **out)
""")


def _tail(path, n=3000):
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError:
        return ""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the 8 ranks and the JAX process together; wait for all of
    them up to DEADLINE_S, then kill whatever still runs. Returns
    ([rank outputs], JAX outputs)."""
    d = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    jax_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu")
    procs = {}
    try:
        for name, argv, penv in (
                [("jax", [sys.executable, "-c", JAX_PROG, str(d / "jax.npz"),
                          os.path.join(REPO, "tests")], jax_env)]
                + [(f"rank{r}", [sys.executable, RANKS, str(r), str(WORLD),
                                 str(d / "rendezvous"), str(d)], env)
                   for r in range(WORLD)]):
            err = open(d / f"{name}.err", "w")
            procs[name] = (subprocess.Popen(argv, env=penv, cwd=REPO,
                                            stdout=err, stderr=err), err)
        end = time.monotonic() + DEADLINE_S
        for name, (p, _) in procs.items():
            try:
                p.wait(timeout=max(1.0, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        failed = {name: p.returncode for name, (p, _) in procs.items()
                  if p.returncode != 0}
    finally:
        for p, err in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
    assert not failed, "\n".join(
        f"--- {name}: exit {rc} (None: killed at the {DEADLINE_S} s "
        f"deadline)\n{_tail(d / f'{name}.err')}"
        for name, rc in failed.items())
    return ([dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)],
            dict(np.load(d / "jax.npz")))


def test_hierarchical_psum_equals_flat_and_jax(runs):
    got, want = runs
    # rank (pod, data, model) holds the rows of model coordinate m = r % 2
    for name in ("psum_hier", "psum_flat"):
        full = np.concatenate([got[m][name] for m in (0, 1)])
        np.testing.assert_allclose(full, want[name], rtol=RTOL)
        for r in range(WORLD):
            np.testing.assert_array_equal(got[r][name], got[r % 2][name])
    np.testing.assert_allclose(np.concatenate([got[m]["psum_hier"]
                                               for m in (0, 1)]),
                               np.concatenate([got[m]["psum_flat"]
                                               for m in (0, 1)]), rtol=RTOL)


def test_grad_allreduce_sums_over_the_batch_axes(runs):
    """make_grad_allreduce sums each leaf over (pod, data), the ranks of
    one model coordinate; hierarchical and flat agree."""
    got, _ = runs
    trees = [ranks_mod.grad_tree(r) for r in range(WORLD)]
    for r in range(WORLD):
        peers = [q for q in range(WORLD) if q % 2 == r % 2]
        want_w = sum(trees[q]["w"] for q in peers).numpy()
        want_bx = sum(trees[q]["b"]["x"] for q in peers).numpy()
        for form in ("grad_hier", "grad_flat"):
            np.testing.assert_allclose(got[r][f"{form}_w"], want_w,
                                       rtol=RTOL, atol=1e-6)
            np.testing.assert_allclose(got[r][f"{form}_bx"], want_bx,
                                       rtol=RTOL, atol=1e-6)


def test_two_hop_all_to_all_equals_flat_and_jax(runs):
    got, want = runs
    hier = np.stack([got[r]["a2a_hier"] for r in range(WORLD)])
    flat = np.stack([got[r]["a2a_flat"] for r in range(WORLD)])
    np.testing.assert_array_equal(hier, flat)
    np.testing.assert_array_equal(hier, want["a2a_hier"])
    np.testing.assert_array_equal(flat, want["a2a_flat"])


@pytest.mark.parametrize("job", ranks_mod.MR_JOBS)
@pytest.mark.parametrize("run", sorted(ranks_mod.MR_RUNS))
def test_mesh_mapreduce_equals_jax_per_reducer(runs, run, job):
    """Every reducer's unique keys, counts, n_unique and dropped equal
    JAX's bit for bit (II: its keys, n_unique and dropped equal JAX's WC
    reducers', whose keys are the same tokens); every rank gathers the
    same rows."""
    got, want = runs
    pre = f"mr_{run}_{job}_"
    ref = f"mr_{run}_{job if job in JAX_JOBS else 'WC'}_"
    keys = got[0][pre + "unique_keys"]
    assert keys.dtype == np.int64
    np.testing.assert_array_equal(keys, want[ref + "unique_keys"]
                                  .astype(np.int64))
    fields = ("counts", "n_unique", "dropped") if job in JAX_JOBS else (
        "n_unique", "dropped")
    for field in fields:
        np.testing.assert_array_equal(got[0][pre + field], want[ref + field])
    assert int(got[0][pre + "dropped"].sum()) == 0
    for r in range(1, WORLD):
        for field in ("unique_keys", "counts", "n_unique", "dropped",
                      "records", "cross_pod"):
            np.testing.assert_array_equal(got[r][pre + field],
                                          got[0][pre + field])
        np.testing.assert_array_equal(got[r][pre + "own_cross_pod"],
                                      got[0][pre + "cross_pod"][r:r + 1])


@pytest.mark.parametrize("job", ranks_mod.MR_JOBS)
@pytest.mark.parametrize("run", sorted(ranks_mod.MR_RUNS))
def test_mesh_mapreduce_merges_to_the_counter_and_local(runs, run, job):
    """The reducers' rows, merged, equal the Counter of JAX's test and the
    port's local_mapreduce of each shard, merged; II's values are the
    shard group's index summed."""
    got, _ = runs
    pre = f"mr_{run}_{job}_"
    shape, names, _, shard = ranks_mod.MR_RUNS[run]
    sizes = dict(zip(names, shape))
    D = int(np.prod([sizes[a] for a in ranks_mod.MR_RUNS[run][2]]))
    keys, counts = got[0][pre + "unique_keys"], got[0][pre + "counts"]
    merged, seen = collections.Counter(), set()
    for g, (krow, crow) in enumerate(zip(keys, counts)):
        for k, c in zip(krow, crow):
            if k != EMPTY:
                # a key has one reducer in each shuffle group (a pod
                # under policy A)
                assert (g // D, k) not in seen
                seen.add((g // D, k))
                merged[int(k)] += int(c)
    toks, lens = ranks_mod.mr_shards()
    local = len(toks) // int(np.prod([dict(zip(names, shape))[a]
                                      for a in shard]))
    expect, via_local = {}, collections.Counter()
    for i, (row, lrow) in enumerate(zip(toks, lens)):
        for t in row[row >= 0]:
            expect[int(t)] = expect.get(int(t), 0) + (
                1 if job == "WC" else i // local)
        k, v, n = mr.local_mapreduce(mr.JOBS["WC"], row, lrow, device="cpu")
        via_local.update(dict(zip(k[:int(n)].tolist(), v[:int(n)].tolist())))
    assert dict(merged) == expect
    if job == "WC":
        assert merged == via_local
    assert int(got[0][pre + "records"].sum()) == int((toks >= 0).sum())


def test_policy_a_keeps_every_record_in_its_pod_and_b_does_not(runs):
    got, _ = runs
    for job in ranks_mod.MR_JOBS:
        a = got[0][f"mr_policy_a_{job}_cross_pod"]
        b = got[0][f"mr_policy_b_{job}_cross_pod"]
        assert int(a.sum()) == 0
        assert (b > 0).all(), b
        # no pod on the (8,) mesh
        assert int(got[0][f"mr_data8_{job}_cross_pod"].sum()) == 0


def test_hint_redistributes_a_dtensor_and_host_mesh(runs):
    got, _ = runs
    for r in range(WORLD):
        assert bool(got[r]["hint_sharded"])
        assert bool(got[r]["hint_full_equal"])
        assert int(got[r]["hint_local_rows"]) == 16 // WORLD
        assert tuple(got[r]["host_mesh_shape"]) == (1, WORLD)
        assert tuple(got[r]["host_mesh_names"]) == ("data", "model")


# ------------------------------------------------- expert-parallel MoE --
def _ep_rows(got, key, case="nodrop"):
    """The case's EP output over the batch: data rank di's rows (ranks
    M di ... M di + M - 1 hold them, the same for every model rank)."""
    D, M = ranks_mod.ep_mesh(case)[0]
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r][key], got[r - r % M][key])
    return np.concatenate([got[M * di][key] for di in range(D)])


def _dense(case, grads=False):
    x, p, w = ranks_mod.port_experts(case, requires_grad=grads)
    x.requires_grad_(grads)
    y, aux = moe_ffn(ranks_mod.ep_cfg(case), p, x)
    if grads:
        (y * w).sum().backward()
    return y.detach().numpy(), float(aux.detach()), x, p


def _aux_close(got, want, case):
    for r in range(WORLD):
        assert abs(float(got[r][f"ep_{case}_aux"])
                   - float(want[f"ep_{case}_aux"])) <= AUX_ATOL


def test_moe_ep_equals_dense_and_jax(runs):
    """JAX's recipe, capacity factor 8.0 (no drops): the port's EP equals
    its dense moe_ffn and JAX's moe_ffn_ep; aux equals JAX's."""
    got, want = runs
    ep = _ep_rows(got, "ep_nodrop_out")
    dense, _, _, _ = _dense("nodrop")
    np.testing.assert_allclose(ep, dense, atol=EP_ATOL, rtol=EP_RTOL)
    np.testing.assert_allclose(ep, want["ep_nodrop_out"], atol=EP_ATOL,
                               rtol=EP_RTOL)
    _aux_close(got, want, "nodrop")
    assert int(got[0]["ep_nodrop_all_to_all"]) == 2


def test_moe_ep_drops_equal_jax(runs):
    """Capacity factor 0.5: the local capacity drops pairs (the output
    leaves the dense one), the same pairs as JAX's EP drops."""
    got, want = runs
    ep = _ep_rows(got, "ep_drops_out")
    dense, _, _, _ = _dense("drops")
    assert not np.allclose(ep, dense, atol=EP_ATOL, rtol=EP_RTOL)
    np.testing.assert_allclose(ep, want["ep_drops_out"], atol=EP_ATOL,
                               rtol=EP_RTOL)
    _aux_close(got, want, "drops")


@pytest.mark.parametrize("case", sorted(ranks_mod.FALLBACK_MESH))
def test_moe_fallback_drops_equal_jax_global(runs, case):
    """JAX's dense fallback under the rules, at 'model' 1 (m1_drops) and
    at a decode step's one token with the experts split over 'model' 4
    (held_drops): the ranks' rows, each dispatched after one all-gather
    of the ranks' per-expert counts, equal JAX's dispatch of the global
    batch and the port's own on one device, where about half of the
    pairs drop; aux is JAX's. The control: each data rank's dispatch of
    its own rows alone (the local capacity) leaves JAX's output."""
    got, want = runs
    key = f"ep_{case}_out"
    out = _ep_rows(got, key, case)
    x, p, _ = ranks_mod.port_experts(case)
    cfg = ranks_mod.ep_cfg(case)
    with torch.no_grad():
        dense, _ = moe_ffn(cfg, p, x)
        T = x.shape[0] * x.shape[1]
        _, topi, _ = route(cfg, p.router, x.reshape(T, -1))
        _, _, keep = dispatch(cfg, topi, capacity(cfg, T))
        D = ranks_mod.ep_mesh(case)[0][0]
        local = torch.cat([moe_ffn(cfg, p, xr)[0] for xr in x.chunk(D)])
    assert 0 < int((~keep).sum()) < keep.numel()
    np.testing.assert_allclose(out, want[key], atol=EP_ATOL, rtol=EP_RTOL)
    np.testing.assert_allclose(out, dense.numpy(), atol=EP_ATOL,
                               rtol=EP_RTOL)
    assert not np.allclose(local.numpy(), want[key], atol=EP_ATOL,
                           rtol=EP_RTOL)
    _aux_close(got, want, case)
    for r in range(WORLD):
        assert int(got[r][f"ep_{case}_all_gather"]) == 1
        assert int(got[r][f"ep_{case}_all_to_all"]) == 0


def test_moe_ep_gradient_equals_dense(runs):
    """The EP backward (the exchanges' reverse, the sequence slice's
    gather) gives the dense path's gradients: x by data rank, the router
    whole on each model rank, each rank's block of the experts."""
    got, _ = runs
    _, _, x, p = _dense("nodrop", grads=True)
    np.testing.assert_allclose(_ep_rows(got, "ep_grad_x"), x.grad.numpy(),
                               atol=EP_ATOL, rtol=EP_RTOL)
    np.testing.assert_allclose(
        sum(got[4 * di]["ep_grad_router"] for di in range(2)),
        p.router.grad.numpy(), atol=EP_ATOL, rtol=EP_RTOL)
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r]["ep_grad_router"],
                                      got[r - r % 4]["ep_grad_router"])
    for k in ("wi", "wo"):
        np.testing.assert_allclose(
            sum(got[r][f"ep_grad_{k}"] for r in range(WORLD)),
            getattr(p, k).grad.numpy(), atol=EP_ATOL, rtol=EP_RTOL)


def test_moe_lm_runs_expert_parallel_under_the_rules(runs):
    """MoETransformerLM under use_rules, no mesh argument: one exchange
    pair a layer, logits equal to its dense dispatch's."""
    got, _ = runs
    for r in range(WORLD):
        np.testing.assert_allclose(got[r]["lm_ep"], got[r]["lm_dense"],
                                   atol=EP_ATOL, rtol=EP_RTOL)
        assert int(got[r]["lm_ep_all_to_all"]) == 2 * 2


# ------------------------------------------------- the sharded train step --
#: the runs whose expert-parallel dispatch drops pairs: their single-
#: device step runs each MoE layer's FFN as the mesh's D data x M model
#: ranks do, in one process (``moe_ffn_ep_virtual`` on each data rank's
#: rows of the microbatch, each rank's local capacity)
EP_DROP_RUNS = ("moe24_micro",)
#: the dropping runs' controls, single-device steps that drop other
#: pairs: "local", each data rank's dense dispatch of its own rows alone
#: (the port's fallback before the exchange); "old_rows", the
#: microbatches the sharded step took before it took JAX's rows
#: (``_old_rows``); "dense", the dense dispatch of each whole microbatch
#: (for the expert-parallel run: its local capacities drop other pairs;
#: there the old rows would not, since each rank's microbatch is the
#: same blocks of B / (n D) rows in either layout, in other slots)
CONTROLS = {"moe81_drops": "local", "moe81_micro": "old_rows",
            "moe24_micro": "dense"}


def _data_model(run):
    """(|batch axes|, |model|) of a run's mesh."""
    shape = ranks_mod.STEP_RUNS[run][1]
    return int(np.prod(shape[:-1])), shape[-1]


def _ffn_by_data_rank(model, D, M=None):
    """Each MoE layer's FFN on the D data ranks' rows of its input, each
    alone: the expert-parallel body of M ranks, or the dense dispatch
    (M None)."""
    cfg = model.cfg
    assert not cfg.moe_dense_residual

    def ffn(p, h):
        return torch.cat([moe_ffn(cfg, p.moe, hr)[0] if M is None else
                          moe_ffn_ep_virtual(cfg, p.moe, hr, M)[0]
                          for hr in h.chunk(D)])

    model.ffn = ffn


def _old_rows(run):
    """The row order under which the single-device step's microbatches,
    split over the data ranks, hold what the sharded step's did before it
    took JAX's rows: data rank r's block of the global batch, split into
    n_micro pieces."""
    _, _, _, n, _, (B, _) = ranks_mod.STEP_RUNS[run][:6]
    D = _data_model(run)[0]
    b = B // (n * D)
    return [r * B // D + m * b + j for m in range(n) for r in range(D)
            for j in range(b)]


def _single_device(run, control=None):
    """The run's steps on one device, from the same parameters: (p0,
    params, losses, gradient norms), the parameters by state_dict name;
    ``control`` one of CONTROLS' layouts."""
    model = ranks_mod.step_model(run)
    D, M = _data_model(run)
    if control == "local":
        _ffn_by_data_rank(model, D)
    elif run in EP_DROP_RUNS and control != "dense":
        _ffn_by_data_rank(model, D, M)
    p0 = {n: t.detach().numpy().copy() for n, t in model.named_parameters()}
    tcfg = ranks_mod.step_tcfg(run)
    step = make_train_step(model, tcfg)
    state = adamw_init(dict(model.named_parameters()))
    batch = {k: torch.from_numpy(v)
             for k, v in ranks_mod.step_batch(run).items()}
    if control == "old_rows":
        batch = {k: v[_old_rows(run)] for k, v in batch.items()}
    losses, norms = [], []
    for _ in range(ranks_mod.STEP_RUNS[run][4]):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return p0, {n: t.detach().numpy() for n, t in model.named_parameters()
                }, losses, norms


def _change_rel(got, want, p0):
    """|got - want| / |want - p0| over all leaves: the parameters' change
    against the reference's change."""
    num = sum(np.square(got[n] - want[n]).sum() for n in want)
    den = sum(np.square(want[n] - p0[n]).sum() for n in want)
    assert den > 0
    return np.sqrt(num / den)


@pytest.mark.parametrize("run", sorted(ranks_mod.STEP_RUNS))
def test_sharded_step_matches_the_single_device_step(runs, run):
    """Three steps (two for the MoE and encdec runs, one for rwkv6's) on
    the mesh stay within the single-device step's tolerance: every rank
    ends with the same
    parameters; their change is the single-device change within
    STEPS_RTOL; the losses and the gradient norms agree (the norm shows
    a wrong gradient scale, which AdamW's update does not)."""
    got, _ = runs
    p0, want, losses, norms = _single_device(run)
    pre = f"step_{run}_param_"
    for r in range(WORLD):
        for n in want:
            np.testing.assert_array_equal(got[r][pre + n], got[0][pre + n])
        np.testing.assert_array_equal(got[r][f"step_{run}_grad_norms"],
                                      got[0][f"step_{run}_grad_norms"])
    assert _change_rel({n: got[0][pre + n] for n in want}, want,
                       p0) <= STEPS_RTOL
    np.testing.assert_allclose(got[0][f"step_{run}_losses"], losses,
                               rtol=1e-5)
    np.testing.assert_allclose(got[0][f"step_{run}_grad_norms"], norms,
                               rtol=NORM_RTOL)
    layers = set(got[0][f"step_{run}_zero1_layers"].tolist())
    if run == "layers":
        # ZeRO-1 on the stacked layers dim: each data rank owns a layer
        assert layers == {f"layers.{i}.attn.{b}" for i in range(2)
                          for b in ("bq", "bk", "bv")}
    elif run == "rwkv24":
        # rwkv6's ln_x (64,) split over 'model' 4: the same rule
        assert layers == {f"layers.{i}.att.ln_x" for i in range(2)}
    else:
        assert not layers


@pytest.mark.parametrize("run", sorted(ranks_mod.STEP_RUNS))
def test_sharded_step_matches_jax(runs, run):
    """The same steps against JAX's make_train_step jitted on the same
    mesh from the same parameters (test_multidevice.py:107's recipe,
    run): the parameters' change within STEPS_RTOL of JAX's, the losses
    and the gradient norms within JAX_STEP_RTOL."""
    got, want = runs
    arch, *_, over = ranks_mod.STEP_RUNS[run][:7]
    cfg = get_config(arch).smoke().scaled(**over)
    pre = f"step_{run}_param_"
    names = [k[len(pre):] for k in got[0] if k.startswith(pre)]
    port = _jax_leaves(params_to_numpy(cfg, {
        n: torch.from_numpy(got[0][pre + n]) for n in names}))
    p0 = _jax_leaves(params_to_numpy(
        cfg, ranks_mod.step_model(run).state_dict()))
    jpre = f"jstep_{run}_param_"
    jax_p = {k[len(jpre):]: v for k, v in want.items() if k.startswith(jpre)}
    assert set(jax_p) == set(port)
    assert _change_rel(port, jax_p, p0) <= STEPS_RTOL
    for key in ("losses", "grad_norms"):
        np.testing.assert_allclose(got[0][f"step_{run}_{key}"],
                                   want[f"jstep_{run}_{key}"],
                                   rtol=JAX_STEP_RTOL, err_msg=key)


@pytest.mark.parametrize("run", sorted(CONTROLS))
def test_sharded_step_drops_leave_their_control(runs, run):
    """The dropping runs' controls (CONTROLS) drop other pairs: the
    losses and gradient norms that the sharded step shares with the
    single-device step and JAX's leave each control's by more than the
    tolerances that hold them there."""
    got, _ = runs
    _, _, losses, norms = _single_device(run, CONTROLS[run])
    assert not np.allclose(got[0][f"step_{run}_losses"], losses,
                           rtol=JAX_STEP_RTOL)
    assert not np.allclose(got[0][f"step_{run}_grad_norms"], norms,
                           rtol=NORM_RTOL)


def _jax_leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("run", sorted(ranks_mod.STEP_RUNS))
def test_sharded_step_collectives_equal_the_dry_run(runs, run):
    """Every rank's collectives over the run's steps, per (kind, group
    size): calls and bytes equal the dry run's reckoning of the same
    tiny cell, times the steps."""
    got, _ = runs
    arch, shape, names, _, steps, (B, S), over = ranks_mod.STEP_RUNS[run][:7]
    row = dryrun.reckon(get_config(arch).smoke().scaled(**over),
                        ShapeCell("tiny", S, B, "train"),
                        MeshShape(names, shape), ranks_mod.step_rules(run),
                        ranks_mod.step_tcfg(run))
    want = {(k, n): (c * steps, b * steps) for k, n, c, b in row["log"]}
    assert row["collective_bytes_per_dev"] > 0
    for r in range(WORLD):
        pre = f"step_{run}_log_"
        moved = {(str(k), int(n)): (int(c), int(b)) for k, n, c, b in zip(
            got[r][pre + "kind"], got[r][pre + "n"], got[r][pre + "calls"],
            got[r][pre + "nbytes"])}
        assert moved == want, (r, moved, want)


@pytest.mark.parametrize("run", sorted(ranks_mod.STEP_RUNS))
def test_sharded_step_places_the_dense_family_tensor_parallel(runs, run):
    """The dense runs hold their attention, MLP and vocab leaves as
    tensor-parallel pieces over 'model' (the norms stay whole); every
    run holds all of its family's roles so (at the smoke sizes every
    group divides by M; at 'model' 1 none, as nothing splits), never the
    MoE experts."""
    got, _ = runs
    leaves = set(got[0][f"step_{run}_tp_leaves"].tolist())
    arch, *_, over = ranks_mod.STEP_RUNS[run][:7]
    cfg = get_config(arch).smoke().scaled(**over)
    roles = set(build_model(cfg, device="meta").tp_roles())
    assert leaves == (roles if _data_model(run)[1] > 1 else set())
    assert not any(".moe." in n for n in leaves)
    if run not in TP_RUNS:
        return
    per_layer = {"attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.wi",
                 "mlp.wo"} | ({"attn.bq", "attn.bk", "attn.bv"}
                              if cfg.qkv_bias else set())
    want = {"embed", "lm_head"} | {f"layers.{i}.{n}" for i in
                                   range(cfg.n_layers) for n in per_layer}
    assert leaves == want


def _serve_rows(got, run, key):
    """A serving run's output over the requests: data rank di's rows
    (the ranks of one data coordinate hold them alike)."""
    shape = ranks_mod.SERVE_RUNS[run][1]
    M = shape[-1]
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r][f"{run}_{key}"],
                                      got[r - r % M][f"{run}_{key}"])
    return np.concatenate([got[M * di][f"{run}_{key}"]
                           for di in range(WORLD // M)])


def _serve_single_device(run):
    """A serving run's tokens and decode logits on one device."""
    _, _, _, _, P, steps, S_max = ranks_mod.SERVE_RUNS[run][:7]
    model = ranks_mod.serve_model(run)
    nxt, cache = make_prefill_step(model, cache_len=S_max)(
        {k: torch.from_numpy(v)
         for k, v in ranks_mod.serve_batch(run).items()})
    serve = make_serve_step(model)
    got, logits = [nxt], []
    for t in range(P, P + steps):
        nxt, lg, cache = serve(cache, nxt, t)
        got.append(nxt)
        logits.append(lg[:, 0])
    return torch.cat(got, 1).numpy(), torch.stack(logits, 1).numpy()


@pytest.mark.parametrize("run", sorted(ranks_mod.SERVE_RUNS))
def test_sharded_serve_equals_single_device_and_jax(runs, run):
    """The prefill and 8 greedy decode steps, the cache split over
    'model': the tokens equal the single-device port's and JAX's sharded
    serving steps', the logits within SERVE_ATOL."""
    got, want = runs
    assert all(bool(got[r][f"{run}_tp"]) for r in range(WORLD))
    toks, logits = (_serve_rows(got, run, k) for k in ("tokens", "logits"))
    one_toks, one_logits = _serve_single_device(run)
    np.testing.assert_array_equal(toks, one_toks)
    np.testing.assert_array_equal(toks, want[f"{run}_tokens"])
    np.testing.assert_allclose(logits, one_logits, rtol=0, atol=SERVE_ATOL)
    np.testing.assert_allclose(logits, want[f"{run}_logits"], rtol=0,
                               atol=SERVE_ATOL)


@pytest.mark.parametrize("run", sorted(ranks_mod.SERVE_RUNS))
def test_sharded_serve_splits_the_cache_over_model(runs, run):
    """Each rank holds S_max/M slots of the cache (and of encdec's cross
    K/V, S_max/2 positions), H/M heads of rwkv6's state and E/M experts;
    a decode step exchanges the attention partials or the vocab's best
    (all-gathers over 'model') and sums the row-parallel products
    (all-reduces)."""
    got, _ = runs
    _, shape, names, *_ = ranks_mod.SERVE_RUNS[run]
    S_max = ranks_mod.SERVE_RUNS[run][6]
    cfg = ranks_mod.serve_cfg(run)
    M = dict(zip(names, shape))["model"]
    want = {"slots": [S_max // M], "xslots": [S_max // 2 // M],
            "heads": [cfg.n_heads // M], "experts": [cfg.n_experts // M]}
    fam = {"dense": ("slots",), "moe": ("slots", "experts"),
           "encdec": ("slots", "xslots"), "ssm": ("heads",)}[cfg.family]
    for r in range(WORLD):
        held = {k: got[r][f"{run}_{k}"].tolist() for k in want
                if f"{run}_{k}" in got[r]}
        assert held == {k: want[k] for k in fam}, (r, held)
        kinds = dict(zip(got[r][f"{run}_log_kind"].tolist(),
                         got[r][f"{run}_log_calls"].tolist()))
        assert kinds.get("all-gather", 0) > 0 and kinds.get(
            "all-reduce", 0) > 0, kinds


# ----------------------------------------------------- _partition_pack --
def _kv_pair(job, kind, n, seed):
    """JAX's run_map output of one shard, and the same records as the
    port's KVBatch."""
    tok, lng = mr.corpus(kind, n, seed=seed)
    kv = jengine.run_map(JJOBS[job], jnp.asarray(tok), jnp.asarray(lng), 3)
    port = KVBatch(torch.from_numpy(np.asarray(kv.keys).astype(np.int64)),
                   torch.from_numpy(np.array(kv.values)),
                   torch.from_numpy(np.array(kv.nbytes)), kv.cap)
    return kv, port


@pytest.mark.parametrize("kind", ("web", "non-web"))
@pytest.mark.parametrize("job", sorted(mr.JOBS))
def test_partition_pack_matches_jax(job, kind):
    """Bit-equal buckets and dropped count at JAX's mesh capacity (slack
    4, 8 destinations) and at a small slack that overflows."""
    kv, port = _kv_pair(job, kind, 1024, 5)
    n_valid = int((port.keys != EMPTY).sum())
    assert n_valid > 8
    for n_dest, cap_dest, overflow in ((8, 4 * -(-kv.cap // 8), False),
                                       (4, n_valid // 8, True)):
        K, V, DR = jengine._partition_pack(kv, n_dest, cap_dest)
        k, v, dr = engine._partition_pack(port, n_dest, cap_dest)
        assert k.shape == (n_dest, cap_dest) and k.dtype == torch.int64
        assert v.dtype == torch.int32 and dr.dtype == torch.int32
        np.testing.assert_array_equal(k.numpy(),
                                      np.asarray(K).astype(np.int64))
        np.testing.assert_array_equal(v.numpy(), np.asarray(V))
        assert int(dr) == int(DR)
        assert (int(dr) > 0) == overflow


def test_partition_pack_of_the_ports_own_map():
    """The port's run_map feeds the pack the records JAX's does."""
    for job in sorted(mr.JOBS):
        kv, port = _kv_pair(job, "web", 700, 9)
        tok, lng = mr.corpus("web", 700, seed=9)
        own = engine.run_map(mr.JOBS[job], torch.from_numpy(tok),
                             torch.from_numpy(lng), 3)
        a = engine._partition_pack(own, 8, 4 * -(-own.cap // 8))
        b = engine._partition_pack(port, 8, 4 * -(-port.cap // 8))
        for x, y in zip(a, b):
            assert torch.equal(x, y)
