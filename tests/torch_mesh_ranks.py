"""One rank of the gloo group that tests/test_torch_mesh.py starts:

    python tests/torch_mesh_ranks.py RANK WORLD RENDEZVOUS_FILE OUT_DIR

Every rank runs every multi-rank check of the port's mesh layer in one
start-up and writes what it got to OUT_DIR/rank<RANK>.npz; the test
compares the files with each other, with the JAX package's outputs and
with single-process references. A failure exits non-zero with its
traceback on stderr, which the test puts in its assertion message.
"""
import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import mapreduce as mr  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import make_host_mesh  # noqa: E402
from repro_torch.models import build_model, side_inputs  # noqa: E402
from repro_torch.models.moe import Experts  # noqa: E402
from repro_torch.models.moe_ep import moe_ffn_ep  # noqa: E402
from repro_torch.sharding import DEFAULT_RULES, hint, use_rules  # noqa: E402
from repro_torch.sharding import collectives as col  # noqa: E402
from repro_torch.serve.sharded import ShardedServing  # noqa: E402
from repro_torch.sharding.params import stored  # noqa: E402
from repro_torch.train import OptConfig, TrainConfig  # noqa: E402
from repro_torch.train.sharded import ShardedTraining  # noqa: E402

#: seconds a collective may wait for the other ranks
TIMEOUT_S = 120
#: (mesh shape, axis names, shuffle_axes, shard_axes) of each mapreduce run
MR_RUNS = {"data8": ((8,), ("data",), ("data",), ("data",)),
           "policy_a": ((2, 4), ("pod", "data"), ("data",), ("pod", "data")),
           "policy_b": ((2, 4), ("pod", "data"), ("pod", "data"),
                        ("pod", "data"))}
MR_JOBS = ("WC", "II")


#: expert-parallel MoE cases, JAX's test_moe_ep_matches_dense_dispatch
#: recipe on a (2, 4) ('data', 'model') mesh (dbrx smoke with 8 experts,
#: top-2): case -> (capacity factor, x's (B, S), x's seed); "drops" has
#: local capacity 8 for 64 (token, choice) pairs a rank over 8 experts.
#: The fallback cases run JAX's dense dispatch of the global batch, on
#: their own meshes (FALLBACK_MESH): "m1_drops" at 'model' 1 (capacity
#: 128 for the batch's 2048 pairs; 256 a rank, which alone would drop
#: none), "held_drops" a decode step's one token on (2, 4), each rank's
#: experts' rows of the buffer (capacity 128 for 2048 pairs)
EP_CASES = {"nodrop": (8.0, (2, 32), 0), "drops": (0.5, (2, 128), 1),
            "m1_drops": (0.5, (8, 128), 2), "held_drops": (0.5, (1024, 1), 3)}
EP_MESH = ((2, 4), ("data", "model"))
FALLBACK_MESH = {"m1_drops": ((8, 1), ("data", "model")),
                 "held_drops": ((2, 4), ("data", "model"))}
#: sharded train step runs: name -> (arch, mesh shape, axis names, n_micro,
#: steps, tokens (B, S), smoke overrides[, rule overrides])
STEP_RUNS = {
    "flat": ("qwen3-4b", (4, 2), ("data", "model"), 2, 3, (8, 32), {}),
    "pod": ("qwen3-4b", (2, 2, 2), ("pod", "data", "model"), 2, 3,
            (8, 32), {}),
    "moe": ("dbrx-132b", (2, 4), ("data", "model"), 1, 2, (4, 32),
            dict(n_experts=8, moe_topk=2, capacity_factor=8.0)),
    # dropping pairs: at 'model' 1, JAX's dense dispatch of the global
    # batch (capacity 128 for 2048 pairs), in one microbatch and in two
    # (capacity 128 for 1024 pairs each: which rows share a microbatch
    # decides the drops); on (2, 4) in two microbatches, the
    # expert-parallel dispatch of each rank's rows of each (local
    # capacity 8 for 64 pairs a rank)
    "moe81_drops": ("dbrx-132b", (8, 1), ("data", "model"), 1, 2, (8, 128),
                    dict(n_experts=8, moe_topk=2, capacity_factor=0.5)),
    "moe81_micro": ("dbrx-132b", (8, 1), ("data", "model"), 2, 2, (16, 64),
                    dict(n_experts=8, moe_topk=2, capacity_factor=0.5)),
    "moe24_micro": ("dbrx-132b", (2, 4), ("data", "model"), 2, 2, (8, 64),
                    dict(n_experts=8, moe_topk=2, capacity_factor=0.5)),
    # qkv biases (64,) split over 'model': ZeRO-1 goes on the stacked
    # layers dim (2 layers over |data| 2), each data rank one layer
    "layers": ("qwen2.5-14b", (2, 2, 2), ("pod", "data", "model"), 2, 3,
               (8, 32), {}),
    # the fsdp archs' rules (launch/dryrun.py::arch_rules): weights split
    # over 'data' too, gathered with a reduce-scatter backward; the
    # experts gathered over 'data' before the expert-parallel exchange
    "fsdp": ("dbrx-132b", (2, 2, 2), ("pod", "data", "model"), 1, 2,
             (4, 32), dict(n_experts=8, moe_topk=2, capacity_factor=8.0),
             dict(embed="data", expert_in="data")),
    # tensor parallelism over 'model' 4: a head (and half a kv head) a
    # rank, the kv heads gathered; and over 'model' 8, where the 4 heads
    # do not divide: head groups of 2 ranks, q gathered (JAX's fallback)
    "tp24": ("qwen3-4b", (2, 4), ("data", "model"), 2, 3, (8, 32), {}),
    "tp18": ("qwen3-4b", (1, 8), ("data", "model"), 2, 3, (8, 32), {}),
    # the other families tensor-parallel over 'model' 4 (the moe run
    # above is dbrx's): whisper's encoder, decoder and cross-attention,
    # rwkv6's time- and channel-mix on a head a rank
    "encdec24": ("whisper-medium", (2, 4), ("data", "model"), 1, 2, (8, 32),
                 {}),
    # one step: AdamW's first update is lr * sign(g), and rwkv6's
    # near-zero gradients flip sign under another f32 summation order, so
    # its second step's gradient norm moves by ~1-2e-5 between any two
    # orders (the ranks', one device's, JAX's; either GLA form)
    "rwkv24": ("rwkv6-7b", (2, 4), ("data", "model"), 1, 1, (8, 32), {}),
}
#: the sharded serving runs: name -> (arch, mesh shape, axis names,
#: requests, prompt length, decode steps, cache slots S_max[, smoke
#: overrides]), f32; on (2, 4) a rank's kv heads are gathered (G 2 < M 4)
#: and the cache's slots sliced, on (4, 2) a rank's own kv head goes to
#: the other rank's slots (an all_to_all). The moe run holds 2 of 8
#: experts a rank (expert-parallel at prefill, the rank's experts' rows
#: of the dense dispatch at decode; a capacity that drops nothing, so the
#: single-device dispatch keeps the same pairs), the encdec run its slots
#: of the self and cross K/V, the rwkv6 run a head of the state
SERVE_RUNS = {"serve24": ("qwen3-4b", (2, 4), ("data", "model"), 4, 20, 8,
                          32),
              "serve42": ("qwen3-4b", (4, 2), ("data", "model"), 4, 20, 8,
                          32),
              "serve_moe24": ("dbrx-132b", (2, 4), ("data", "model"), 4, 20,
                              8, 32, dict(n_experts=8, moe_topk=2,
                                          capacity_factor=8.0)),
              "serve_encdec24": ("whisper-medium", (2, 4), ("data", "model"),
                                 4, 20, 8, 32),
              "serve_rwkv24": ("rwkv6-7b", (2, 4), ("data", "model"), 4, 20,
                               8, 32)}
STEP_OPT = OptConfig(lr=1e-3, warmup_steps=0)
#: the seed of the runs' parameters (torch.Generator on the CPU)
STEP_SEED = 0


def ep_cfg(case, pkg_configs=None):
    """The case's config, from ``pkg_configs.get_config`` (the JAX
    package's, for the JAX process; the port's by default)."""
    cf = EP_CASES[case][0]
    return (pkg_configs.get_config if pkg_configs else get_config)(
        "dbrx-132b").smoke().scaled(n_experts=8, moe_topk=2,
                                    capacity_factor=cf)


def ep_inputs(case):
    """numpy (x, {router, wi, wo}, loss weights) of a case, in f32."""
    _, (B, S), seed = EP_CASES[case]
    cfg = ep_cfg(case)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    rng = np.random.RandomState(100 + seed)
    p = {"router": rng.randn(d, E).astype(np.float32),
         "wi": (rng.randn(E, d, 2 * f) / np.sqrt(d)).astype(np.float32),
         "wo": (rng.randn(E, f, d) / np.sqrt(f)).astype(np.float32)}
    x = np.random.RandomState(seed).randn(B, S, d).astype(np.float32)
    w = rng.randn(B, S, d).astype(np.float32)
    return x, p, w


def port_experts(case, requires_grad=False):
    x, p, w = ep_inputs(case)
    e = Experts(ep_cfg(case), torch.device("cpu"))
    with torch.no_grad():
        for k, v in p.items():
            getattr(e, k).copy_(torch.from_numpy(v))
    e.requires_grad_(requires_grad)
    return torch.from_numpy(x), e, torch.from_numpy(w)


def step_tokens(run):
    arch, _, _, _, _, (B, S), over = STEP_RUNS[run][:7]
    vocab = get_config(arch).smoke().scaled(**over).vocab
    return np.random.RandomState(0).randint(0, vocab, (B, S)).astype(
        np.int32)


def with_side(arch, toks, n_frames):
    """numpy batch of the tokens and the family's side inputs (encdec's
    frames, n_frames of them, seed 3)."""
    cfg = get_config(arch).smoke()
    return dict(side_inputs(cfg, toks.shape[0], seed=3, n_frames=n_frames),
                tokens=toks)


def step_batch(run):
    """The run's numpy batch: its tokens, and S frames for encdec (the
    dry run's cell of the same shape)."""
    arch, _, _, _, _, (B, S) = STEP_RUNS[run][:6]
    return with_side(arch, step_tokens(run), S)


def step_model(run):
    """The run's model with its seeded parameters, on the CPU."""
    arch, *_, over = STEP_RUNS[run][:7]
    model = build_model(get_config(arch).smoke().scaled(**over),
                        device="cpu")
    model.init_params(torch.Generator().manual_seed(STEP_SEED))
    return model


def step_tcfg(run):
    return TrainConfig(n_micro=STEP_RUNS[run][3], opt=STEP_OPT)


def step_rules(run):
    over = STEP_RUNS[run][7] if len(STEP_RUNS[run]) > 7 else {}
    return DEFAULT_RULES.updated(**over)


def ep_mesh(case):
    """(shape, axis names) of a case's mesh."""
    return FALLBACK_MESH.get(case, EP_MESH)


def run_moe_ep(rank, out):
    """moe_ffn_ep on each data rank's rows of the batch: outputs, aux, the
    collectives and the no-drop case's gradients; then MoETransformerLM
    under the rules."""
    for case in EP_CASES:
        mesh = init_device_mesh("cpu", ep_mesh(case)[0],
                                mesh_dim_names=ep_mesh(case)[1])
        di = mesh.get_coordinate()[0]
        x, p, w = port_experts(case, requires_grad=case == "nodrop")
        b = x.shape[0] // mesh.size(0)
        xr = x[di * b:(di + 1) * b].clone().requires_grad_(case == "nodrop")
        col.LOG.reset()
        with use_rules(mesh, DEFAULT_RULES):
            y, aux = moe_ffn_ep(ep_cfg(case), p, xr)
        for kind in ("all-to-all", "all-gather"):
            out[f"ep_{case}_{kind.replace('-', '_')}"] = np.array(
                col.LOG.n_calls().get(kind, 0))
        out[f"ep_{case}_out"] = y.detach().numpy()
        out[f"ep_{case}_aux"] = aux.detach().numpy()
        if case == "nodrop":
            (y * w[di:di + 1]).sum().backward()
            out["ep_grad_x"] = xr.grad.numpy()
            for k in ("router", "wi", "wo"):
                out[f"ep_grad_{k}"] = getattr(p, k).grad.numpy()
    mesh = init_device_mesh("cpu", EP_MESH[0], mesh_dim_names=EP_MESH[1])
    di = mesh.get_coordinate()[0]
    model = step_model("moe")
    toks = torch.from_numpy(step_tokens("moe"))[2 * di:2 * di + 2]
    with torch.no_grad():
        out["lm_dense"] = model.logits({"tokens": toks}).numpy()
        col.LOG.reset()
        with use_rules(mesh, DEFAULT_RULES):
            out["lm_ep"] = model.logits({"tokens": toks}).numpy()
    out["lm_ep_all_to_all"] = np.array(col.LOG.n_calls().get("all-to-all",
                                                             0))


def run_sharded_steps(rank, out):
    """Each STEP_RUNS run: the sharded step from the seeded parameters,
    its losses and gradient norms, the collectives it ran (per (kind,
    group size): calls and bytes over all its steps) and the full
    parameters after it."""
    for run, (_, shape, names, _, steps, *_) in STEP_RUNS.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        model = step_model(run)
        tcfg = step_tcfg(run)
        sharded = ShardedTraining(model, mesh, step_rules(run))
        state = sharded.init_opt_state(tcfg.opt.state_dtype)
        step = sharded.make_step(tcfg)
        batch = {k: torch.from_numpy(v) for k, v in step_batch(run).items()}
        col.LOG.reset()
        losses, norms = [], []
        for _ in range(steps):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        log = col.LOG.snapshot()
        out[f"step_{run}_losses"] = np.array(losses)
        out[f"step_{run}_grad_norms"] = np.array(norms)
        out[f"step_{run}_zero1_layers"] = np.array(sorted(
            n for n, z in sharded.zero1.items()
            if z is not None and z[0] == "layers"))
        keys = sorted(log["calls"])
        out[f"step_{run}_log_kind"] = np.array([k for k, _ in keys])
        out[f"step_{run}_log_n"] = np.array([n for _, n in keys])
        out[f"step_{run}_log_calls"] = np.array([log["calls"][k]
                                                 for k in keys])
        out[f"step_{run}_log_nbytes"] = np.array([log["nbytes"][k]
                                                  for k in keys])
        out[f"step_{run}_tp_leaves"] = np.array(sorted(
            n for n, pl in sharded.plan.items() if pl.tp is not None))
        for name, t in sharded.whole().items():
            out[f"step_{run}_param_{name}"] = t.numpy()


def serve_cfg(run):
    over = SERVE_RUNS[run][7] if len(SERVE_RUNS[run]) > 7 else {}
    return get_config(SERVE_RUNS[run][0]).smoke().scaled(**over)


def serve_model(run):
    """The serving run's model with its seeded parameters, f32, on the
    CPU."""
    model = build_model(serve_cfg(run), device="cpu")
    model.init_params(torch.Generator().manual_seed(STEP_SEED + 1))
    return model


def serve_tokens(run):
    arch, _, _, N, P = SERVE_RUNS[run][:5]
    vocab = get_config(arch).smoke().vocab
    return np.random.RandomState(1).randint(0, vocab, (N, P)).astype(
        np.int32)


def serve_batch(run):
    """The run's numpy prompt batch: its tokens, and S_max frames for
    encdec (S_max / 2 cross K/V positions)."""
    return with_side(SERVE_RUNS[run][0], serve_tokens(run),
                     SERVE_RUNS[run][6])


def rank_holds(serving, cache):
    """What a serving rank holds: per cache part its ring's slots (and
    encdec's cross K/V's), a state's heads; the experts of layer 0."""
    out = {}
    parts = cache.parts
    if hasattr(parts[0], "k"):
        out["slots"] = [c.k.shape[2] for c in parts]
    if hasattr(parts[0], "xk"):
        out["xslots"] = [c.xk.shape[2] for c in parts]
    if hasattr(parts[0], "state"):
        out["heads"] = [c.state.shape[2] for c in parts]
    if serving.model.cfg.n_experts:
        out["experts"] = [stored(serving.model, "layers.0.moe.wi").shape[0]]
    return out


def run_sharded_serve(rank, out):
    """Each SERVE_RUNS run on its mesh: the prefill, then greedy decode
    steps on the rank's rows; its tokens, each step's whole logits
    (gathered over 'model'), the cache slots it holds and the
    collectives of one decode step."""
    for run, (_, shape, names, N, P, steps, S_max, *_) in SERVE_RUNS.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        serving = ShardedServing(serve_model(run), mesh, DEFAULT_RULES)
        batch = {k: serving.rows(torch.from_numpy(v))
                 for k, v in serve_batch(run).items()}
        nxt, cache = serving.prefill(batch, cache_len=S_max)
        got, logits = [nxt], []
        for t in range(P, P + steps):
            col.LOG.reset()
            nxt, parts, cache = serving.decode(cache, nxt, t)
            log = col.LOG.snapshot()
            logits.append(serving.logits(parts)[:, 0])
            got.append(nxt)
        out[f"{run}_tokens"] = torch.cat(got, dim=1).numpy()
        out[f"{run}_logits"] = torch.stack(logits, dim=1).numpy()
        for k, v in rank_holds(serving, cache).items():
            out[f"{run}_{k}"] = np.array(v)
        out[f"{run}_tp"] = np.array(serving.tp is not None)
        keys = sorted(log["calls"])
        out[f"{run}_log_kind"] = np.array([k for k, _ in keys])
        out[f"{run}_log_calls"] = np.array([log["calls"][k] for k in keys])


def mr_shards():
    """JAX's test_mesh_mapreduce_matches_local recipe: 8 non-web shards of
    512 tokens, seeds 0-7."""
    toks, lens = zip(*(mr.corpus("non-web", 512, seed=s) for s in range(8)))
    return np.stack(toks), np.stack(lens)


def grad_tree(rank):
    g = torch.Generator().manual_seed(100 + rank)
    return {"w": torch.randn(4, 6, generator=g),
            "b": {"x": torch.randn(2, 3, generator=g)}}


def run(rank, out):
    # hierarchical_psum = flat_psum on (2, 2, 2), JAX's recipe: x (8, 16)
    # split by 'model' over dim 0
    mesh3 = init_device_mesh("cpu", (2, 2, 2),
                             mesh_dim_names=("pod", "data", "model"))
    m = mesh3.get_coordinate()[2]
    x = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    x = x[m * 4:(m + 1) * 4]
    out["psum_hier"] = col.hierarchical_psum(x, mesh3).numpy()
    out["psum_flat"] = col.flat_psum(x, mesh3).numpy()
    for name, hier in (("grad_hier", True), ("grad_flat", False)):
        red = col.make_grad_allreduce(mesh3, hierarchical=hier)(
            grad_tree(rank))
        out[f"{name}_w"] = red["w"].numpy()
        out[f"{name}_bx"] = red["b"]["x"].numpy()
    # two_hop_all_to_all = the flat exchange on (2, 4), JAX's recipe: x
    # (8 ranks, 8 dest chunks, 3)
    mesh2 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("pod", "model"))
    x = torch.arange(8 * 8 * 3, dtype=torch.float32).reshape(8, 8, 3)[rank]
    flat = torch.empty_like(x)
    dist.all_to_all_single(flat, x, group=col.axes_group(mesh2,
                                                         ("pod", "model")))
    out["a2a_flat"] = flat.numpy()
    out["a2a_hier"] = col.two_hop_all_to_all(x, mesh2, pod_axis="pod",
                                             inner_axis="model").numpy()
    # mesh_mapreduce, and the rows gathered into JAX's layout
    toks, lens = mr_shards()
    for run_name, (shape, names, shuffle, shard) in MR_RUNS.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        for job in MR_JOBS:
            res = mr.mesh_mapreduce(mr.JOBS[job], toks, lens, mesh,
                                    shuffle_axes=shuffle, shard_axes=shard)
            full = mr.gather_groups(res, mesh, shard)
            for field, val in full._asdict().items():
                out[f"mr_{run_name}_{job}_{field}"] = val.numpy()
            out[f"mr_{run_name}_{job}_own_cross_pod"] = res.cross_pod.numpy()
    # hint: a DTensor is redistributed to the rules' placements
    mesh_pd = init_device_mesh("cpu", (2, 4), mesh_dim_names=("pod", "data"))
    full = torch.arange(16 * 4, dtype=torch.float32).reshape(16, 4)
    dt = distribute_tensor(full, mesh_pd, [Replicate(), Replicate()])
    with use_rules(mesh_pd, DEFAULT_RULES):
        y = hint(dt, ("batch", "embed"))
    out["hint_sharded"] = np.array(
        tuple(y.placements) == (Shard(0), Shard(0)))
    out["hint_full_equal"] = np.array(torch.equal(y.full_tensor(), full))
    out["hint_local_rows"] = np.array(y.to_local().shape[0])
    host = make_host_mesh(device="cpu")
    out["host_mesh_shape"] = np.array(tuple(host.shape))
    out["host_mesh_names"] = np.array(host.mesh_dim_names)
    run_moe_ep(rank, out)
    run_sharded_steps(rank, out)
    run_sharded_serve(rank, out)


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    rendezvous, out_dir = sys.argv[3], sys.argv[4]
    # the ranks share the CPUs with each other and with other test workers
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{rendezvous}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        out = {}
        run(rank, out)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
