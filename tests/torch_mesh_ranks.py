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
from repro_torch.launch import make_host_mesh  # noqa: E402
from repro_torch.sharding import DEFAULT_RULES, hint, use_rules  # noqa: E402
from repro_torch.sharding import collectives as col  # noqa: E402

#: seconds a collective may wait for the other ranks
TIMEOUT_S = 120
#: (mesh shape, axis names, shuffle_axes, shard_axes) of each mapreduce run
MR_RUNS = {"data8": ((8,), ("data",), ("data",), ("data",)),
           "policy_a": ((2, 4), ("pod", "data"), ("data",), ("pod", "data")),
           "policy_b": ((2, 4), ("pod", "data"), ("pod", "data"),
                        ("pod", "data"))}
MR_JOBS = ("WC", "II")


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
