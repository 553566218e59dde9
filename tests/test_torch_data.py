"""The port's JoSS data pipeline (data/pipeline.py, with its copies of the
job model, policy B and the cluster's shard placement) against
repro.data.pipeline; and its checkpoints: a round trip, the manifest's
commit rule, async saves, and each package reading the other's files."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.job import Job as JaxJob  # noqa: E402
from repro.core.policies import policy_b as jax_policy_b  # noqa: E402
from repro.core.queues import ClusterQueues  # noqa: E402
from repro.core.topology import HostId as JaxHostId  # noqa: E402
from repro.core.topology import VirtualCluster as JaxCluster  # noqa: E402
from repro.data import JossDataPipeline as JaxPipeline  # noqa: E402
from repro.data import TokenStore as JaxStore  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.train import adamw_init as jax_adamw_init  # noqa: E402
from repro.train import checkpoint as jax_ckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import (opt_state_from_jax, params_from_jax,  # noqa: E402
                                 params_to_numpy)
from repro_torch.core.job import Job  # noqa: E402
from repro_torch.core.policies import policy_b  # noqa: E402
from repro_torch.core.topology import HostId, VirtualCluster  # noqa: E402
from repro_torch.data import JossDataPipeline, TokenStore  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import adamw_init  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

PIPES = {
    # name -> (hosts per pod, replication, global batch, joss)
    "two_pods": ([4, 4], 1, 8, True),
    "replicated": ([4, 4], 2, 8, True),
    "three_uneven": ([3, 5, 2], 2, 6, True),
    "round_robin": ([4, 4], 1, 8, False),
    "one_pod": ([6], 3, 4, True),
}


def _pipe(pkg, name, seed_store=0, seed_pipe=1):
    shape, rep, gb, joss = PIPES[name]
    cluster_cls, store_cls, pipe_cls = pkg
    store = store_cls(cluster_cls(shape), n_shards=24, seqs_per_shard=12,
                      seq_len=16, vocab=300, replication=rep,
                      seed=seed_store)
    return pipe_cls(store, global_batch=gb, seed=seed_pipe, joss=joss)


JAX_PKG = (JaxCluster, JaxStore, JaxPipeline)
PORT_PKG = (VirtualCluster, TokenStore, JossDataPipeline)


@pytest.mark.parametrize("name", list(PIPES))
def test_pipeline_matches_jax(name):
    """Same seeds: the same shard->pod assignment, pod shard lists, batches
    and locality report (rates and bytes)."""
    want = _pipe(JAX_PKG, name)
    got = _pipe(PORT_PKG, name)
    assert got.assignment == want.assignment
    assert got.pod_shards == want.pod_shards
    for sid, sh in want.store.shards.items():
        np.testing.assert_array_equal(got.store.shards[sid].tokens,
                                      sh.tokens)
    for a, b in zip(got.batches(6), want.batches(6)):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert (dataclasses.asdict(got.locality_report())
            == dataclasses.asdict(want.locality_report()))
    assert got.locality_report().int_bytes == want.locality_report().int_bytes


def test_joss_pipeline_reads_locally():
    """Policy B puts every shard on a pod that holds it: no read crosses
    pods, where the placement-blind round robin does."""
    joss = _pipe(PORT_PKG, "two_pods")
    rr = _pipe(PORT_PKG, "round_robin")
    list(joss.batches(10))
    list(rr.batches(10))
    assert joss.locality_report().off_pod_rate == 0.0
    assert rr.locality_report().off_pod_rate > 0.0


def test_batches_need_a_batch_per_pod():
    store = TokenStore(VirtualCluster([2, 2, 2]), n_shards=4,
                       seqs_per_shard=4, seq_len=8, vocab=10)
    with pytest.raises(ValueError):
        JossDataPipeline(store, global_batch=4)


@pytest.mark.parametrize("seed", range(5))
def test_policy_b_matches_jax(seed):
    """Random placements on a 3-pod cluster, some shards unplaced: the
    same per-task pods and reduce pod."""
    rng = np.random.RandomState(seed)
    shape = [3, 2, 4]
    jc, tc = JaxCluster(shape), VirtualCluster(shape)
    sids = [f"s{i}" for i in range(15)]
    for s in sids[:12]:
        n = rng.randint(1, 4)
        picks = [(int(p), int(rng.randint(shape[p])))
                 for p in rng.choice(3, size=n)]
        picks = list(dict.fromkeys(picks))
        jc.place_shard(s, [JaxHostId(*p) for p in picks])
        tc.place_shard(s, [HostId(*p) for p in picks])
    bytes_ = [int(b) for b in rng.randint(1, 100, len(sids))]
    want = jax_policy_b(JaxJob("j", "j", "t", sids, bytes_), jc,
                        ClusterQueues(3))
    got = policy_b(Job("j", "j", "t", sids, bytes_), tc)
    assert (got.map_assignment, got.reduce_pod, got.policy) == (
        want.map_assignment, want.reduce_pod, want.policy)
    assert got.pods_used() == want.pods_used()
    for s in sids[:12]:
        for h in jc.hosts():
            wr, wl = jc.nearest_replica(s, h.hid)
            tr, tl = tc.nearest_replica(s, HostId(h.hid.pod, h.hid.index))
            assert (tr.pod, tr.index, tl.value) == (wr.pod, wr.index,
                                                    wl.value)


# ------------------------------------------------------------ checkpoint --
def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"embed": torch.randn(5, 3, generator=g).bfloat16(),
                       "layers.0.w": torch.randn(3, 4, generator=g),
                       "layers.1.w": torch.randn(3, 4, generator=g)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "m": {"x": torch.zeros(2, dtype=torch.bfloat16)},
                    "flags": torch.tensor([True, False])}}


def _assert_equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_equal_trees(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert torch.equal(a[k], b[k]), k


def test_checkpoint_round_trip(tmp_path):
    tree = _tree()
    d = ckpt.save(str(tmp_path), 3, tree, shard_leaves=2)
    assert d.endswith("step_000000003")
    assert ckpt.latest_step(str(tmp_path)) == 3
    got, step = ckpt.restore(str(tmp_path))
    assert step == 3
    _assert_equal_trees(got, tree)
    got, _ = ckpt.restore(str(tmp_path), tree)
    _assert_equal_trees(got, tree)
    bad = dict(tree, opt=dict(tree["opt"], step=torch.zeros(2)))
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), bad)
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), dict(tree, extra=torch.zeros(1)))


def test_checkpoint_commit_rule_and_gc(tmp_path):
    root = str(tmp_path)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(root)
    for s in (1, 2, 3, 4):
        ckpt.save(root, s, {"x": torch.full((2,), float(s))})
    (tmp_path / "step_000000009").mkdir()      # no manifest: ignored
    (tmp_path / "step_000000010.tmp").mkdir()  # an unfinished write
    assert ckpt.latest_step(root) == 4
    removed = ckpt.gc_old(root, keep=2)
    assert len(removed) == 2
    assert ckpt.latest_step(root) == 4
    assert float(ckpt.restore(root, step=3)[0]["x"][0]) == 3.0


def test_async_checkpointer_snapshots_at_submit(tmp_path):
    """submit copies the tree to the host at once: training may go on
    writing the same tensors in place while the copy is written."""
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    x = torch.zeros(1000)
    for s in (1, 2, 3):
        x.fill_(float(s))
        saver.submit(s, {"x": x})
        x.fill_(-1.0)
    saver.wait()
    assert saver.last_committed == 3
    assert ckpt.latest_step(str(tmp_path)) == 3
    got, _ = ckpt.restore(str(tmp_path))
    assert bool((got["x"] == 3.0).all())
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000002", "step_000000003"]


def test_train_state_round_trip(tmp_path):
    """A bf16 model's params and its AdamW state through AsyncCheckpointer
    come back bit-equal."""
    cfg = tconfigs.get_config("hymba-1.5b").smoke().scaled(dtype="bfloat16")
    m = build_model(cfg, device="cpu")
    m.init_params(torch.Generator().manual_seed(0))
    opt = adamw_init(dict(m.named_parameters()), "bfloat16")
    for name, t in opt["m"].items():
        t.normal_(generator=torch.Generator().manual_seed(len(name)))
    opt["step"] += 5
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.submit(5, {"params": m.state_dict(), "opt": opt})
    saver.wait()
    got, step = ckpt.restore(str(tmp_path), {"params": m.state_dict(),
                                             "opt": opt})
    assert step == 5
    _assert_equal_trees(got, {"params": m.state_dict(), "opt": opt})


def test_port_reads_jax_checkpoint(tmp_path):
    """A checkpoint written by repro.train.checkpoint.save (bf16 params as
    raw bytes, the AdamW state) reads back in the port and converts into
    the model and the optimizer state."""
    jcfg = jconfigs.get_config("qwen3-4b").smoke().scaled(dtype="bfloat16")
    tcfg = tconfigs.get_config("qwen3-4b").smoke().scaled(dtype="bfloat16")
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    opt = jax_adamw_init(params)
    opt["m"] = jax.tree_util.tree_map(lambda a: a + 0.5, opt["m"])
    opt["step"] = jnp.int32(11)
    jax_ckpt.save(str(tmp_path), 11, {"params": params, "opt": opt})
    tree, step = ckpt.restore(str(tmp_path))
    assert step == 11
    m = build_model(tcfg, device="cpu")
    m.load_state_dict(params_from_jax(tcfg, tree["params"]))
    want = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, params))
    for name, t in m.state_dict().items():
        assert t.dtype == want[name].dtype
        assert torch.equal(t, want[name]), name
    state = opt_state_from_jax(tcfg, tree["opt"])
    assert int(state["step"]) == 11 and state["step"].shape == ()
    assert all(bool((t == 0.5).all()) for t in state["m"].values())
    assert state["m"].keys() == want.keys()


def test_jax_reads_port_checkpoint(tmp_path):
    """The other way: the port's params restacked by params_to_numpy, and a
    bf16 tensor as raw bytes, read back by repro.train.checkpoint."""
    tcfg = tconfigs.get_config("rwkv6-7b").smoke()
    jcfg = jconfigs.get_config("rwkv6-7b").smoke()
    m = build_model(tcfg, device="cpu")
    m.init_params(torch.Generator().manual_seed(3))
    x = torch.randn(4, 5).bfloat16()
    ckpt.save(str(tmp_path), 2, {"params": params_to_numpy(
        tcfg, m.state_dict()), "x": x})
    like = {"params": jax_build(jcfg).init(jax.random.PRNGKey(1)),
            "x": jnp.zeros((4, 5), jnp.bfloat16)}
    tree, step = jax_ckpt.restore(str(tmp_path), like)
    assert step == 2
    back = params_from_jax(tcfg, tree["params"])
    for name, t in m.state_dict().items():
        assert torch.equal(back[name], t), name
    np.testing.assert_array_equal(np.asarray(tree["x"], np.float32),
                                  x.float().numpy())


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-26b",
                                  "dbrx-132b"])
def test_checkpoints_cross_read_encdec_vlm_moe_trees(tmp_path, arch):
    """Both directions on the trees with leaves beside the stacked layers:
    encdec's frontend, stacked encoder and enc_norm, vlm's projector (bf16
    params as raw bytes), and the moe's expert stacks. A JAX checkpoint
    loads into the port's model bit for bit; the port's params, restacked
    by params_to_numpy, read back in JAX equal to its own tree."""
    jcfg = jconfigs.get_config(arch).smoke().scaled(dtype="bfloat16")
    tcfg = tconfigs.get_config(arch).smoke().scaled(dtype="bfloat16")
    params = jax_build(jcfg).init(jax.random.PRNGKey(4))
    jax_ckpt.save(str(tmp_path / "jax"), 3, {"params": params})
    tree, step = ckpt.restore(str(tmp_path / "jax"))
    assert step == 3
    m = build_model(tcfg, device="cpu")
    m.load_state_dict(params_from_jax(tcfg, tree["params"]), strict=True)
    want = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, params))
    assert m.state_dict().keys() == want.keys()
    for name, t in m.state_dict().items():
        assert t.dtype == want[name].dtype and torch.equal(t, want[name]), \
            name

    ckpt.save(str(tmp_path / "port"), 4, {"params": params_to_numpy(
        tcfg, m.state_dict())})
    back, step = jax_ckpt.restore(str(tmp_path / "port"), {"params": params})
    assert step == 4
    for path, w in jax.tree_util.tree_flatten_with_path(params)[0]:
        g = back["params"]
        for k in path:
            g = g[k.key]
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w, np.float32),
                                      err_msg=jax.tree_util.keystr(path))
