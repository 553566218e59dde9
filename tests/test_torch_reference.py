"""The port's naive dispatch reference (``repro_torch.core.reference``) on
the CPU: the JAX package's fast-path equivalences (``test_dispatch_fastpath``)
run on the port — the indexed stack and the reference stack give equal
``SimResult`` metrics and equal per-task assignment sequences — and the
port's reference gives the same metrics and pick sequences as JAX's
reference on the same seeded workloads."""
import random
import types

import pytest

pytest.importorskip("torch")

import repro.core.assigners as jax_assigners  # noqa: E402
import repro.core.job as jax_job  # noqa: E402
import repro.core.joss as jax_joss  # noqa: E402
import repro.core.queues as jax_queues  # noqa: E402
import repro.core.reference as jax_reference  # noqa: E402
import repro.core.topology as jax_topology  # noqa: E402
import repro.sim.cluster_sim as jax_sim  # noqa: E402
import repro.sim.workloads as jax_workloads  # noqa: E402
import repro_torch.core.assigners as assigners  # noqa: E402
import repro_torch.core.job as job  # noqa: E402
import repro_torch.core.joss as joss  # noqa: E402
import repro_torch.core.queues as queues  # noqa: E402
import repro_torch.core.reference as reference  # noqa: E402
import repro_torch.core.topology as topology  # noqa: E402
import repro_torch.sim.cluster_sim as sim  # noqa: E402
import repro_torch.sim.workloads as workloads  # noqa: E402

ALGOS = ("joss-t", "joss-j", "fifo", "fair", "capacity")


def _pkg(a, j, js, q, r, t, s, w):
    return types.SimpleNamespace(assigners=a, job=j, joss=js, queues=q,
                                 reference=r, topology=t, sim=s, workloads=w)


PORT = _pkg(assigners, job, joss, queues, reference, topology, sim,
            workloads)
JAX = _pkg(jax_assigners, jax_job, jax_joss, jax_queues, jax_reference,
           jax_topology, jax_sim, jax_workloads)


# --------------------------------------------------------------- helpers --
def random_cluster_and_jobs(pkg, seed: int, n_jobs: int = 12):
    """test_dispatch_fastpath's random topology and workload, replicated
    shards included, built from ``pkg``'s classes."""
    rng = random.Random(seed)
    k = rng.randint(2, 4)
    cluster = pkg.topology.VirtualCluster(
        [rng.randint(2, 6) for _ in range(k)])
    hosts = [h.hid for h in cluster.hosts()]
    jobs = []
    for j in range(n_jobs):
        m = rng.randint(1, 10)
        sids = [f"s{seed}/{j}/{b}" for b in range(m)]
        for s in sids:
            reps = rng.sample(hosts, rng.randint(1, min(3, len(hosts))))
            cluster.place_shard(s, reps)
        jobs.append(pkg.job.Job(
            name=f"j{j}", code_key=f"code{j % 4}", input_type="web",
            shard_ids=sids, shard_bytes=[128.0] * m,
            n_reducers=rng.randint(1, 3),
            true_fp=rng.choice([0.1, 0.6, 1.0, 3.0]),
            submit_time=rng.random() * 60.0))
    return cluster, jobs


def run_sim(pkg, reference_stack: bool, name: str, seed: int):
    """(metrics, per-task assignment sequence) of one simulation, job ids
    replaced by submission index so the two packages compare."""
    cluster, jobs = random_cluster_and_jobs(pkg, seed)
    idx = {j.job_id: i for i, j in enumerate(jobs)}
    factory = (pkg.reference.make_reference_algorithm if reference_stack
               else pkg.joss.make_algorithm)
    algo = factory(name, cluster)
    if hasattr(algo, "registry"):
        for j in jobs:
            if j.code_key in ("code0", "code1"):
                algo.registry.record(j, j.true_fp)
    res = pkg.sim.Simulator(cluster, algo, jobs, seed=7).run()
    seq = [((log.task.tid[0], idx[log.task.tid[1]], *log.task.tid[2:]),
            (log.host.pod, log.host.index), log.start, log.finish,
            getattr(log.locality, "name", log.locality), log.bytes_local,
            log.bytes_pod, log.bytes_offpod)
           for log in res.task_logs]
    metrics = (res.wtt, res.int_bytes, res.pod_bytes,
               sorted((idx[k], v) for k, v in res.job_finish.items()))
    return metrics, seq


def pick_sequence(pkg, fast: bool, jta: bool):
    """test_dispatch_fastpath's scripted slot offers (JTA defer churn
    included) through one assigner: the (job, index) picked per offer."""
    if jta:
        cls = pkg.assigners.JTA if fast else pkg.reference.ReferenceJTA
    else:
        cls = pkg.assigners.TTA if fast else pkg.reference.ReferenceTTA
    rng = random.Random(42)
    cluster = pkg.topology.VirtualCluster([3, 3])
    hosts = [h.hid for h in cluster.hosts()]
    qs = pkg.queues.ClusterQueues(cluster)
    if not cls.needs_task_index:
        qs.set_map_task_indexing(False)
    assigner = cls(cluster, qs)
    tasks = []
    for j in range(6):
        for b in range(rng.randint(1, 5)):
            sid = f"q/{j}/{b}"
            cluster.place_shard(sid, rng.sample(hosts, 2))
            tasks.append(pkg.job.MapTask(j, b, sid, 128))
    for t in tasks:
        if t.job_id < 2:
            qs.mq_fifo.append(t)
        else:
            qs.pods[t.job_id % 2].mq0.append(t)
    seq = []
    for _ in range(3 * len(tasks)):
        got = assigner.next_map_task(hosts[rng.randrange(len(hosts))])
        seq.append(None if got is None else (got.job_id, got.index))
    return seq


# ------------------------------------------- the port's own equivalences --
@pytest.mark.parametrize("name", ALGOS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_simulation_equivalence_randomized(name, seed):
    assert run_sim(PORT, False, name, seed) == run_sim(PORT, True, name,
                                                       seed)


@pytest.mark.parametrize("name", ("joss-t", "joss-j"))
def test_simulation_equivalence_paper_workload(name):
    def run(factory):
        cluster = workloads.make_cluster((4, 4))
        jobs = workloads.small_workload(cluster, seed=5, n_jobs=12)
        idx = {j.job_id: i for i, j in enumerate(jobs)}
        algo = factory(name, cluster)
        for j in workloads.profiling_prelude(cluster):
            algo.registry.record(j, j.true_fp)
        res = sim.Simulator(cluster, algo, jobs, seed=5).run()
        return (res.wtt, res.int_bytes, res.pod_bytes,
                [((log.task.tid[0], idx[log.task.tid[1]],
                   *log.task.tid[2:]), log.host, log.start)
                 for log in res.task_logs])
    assert run(joss.make_algorithm) == run(reference.make_reference_algorithm)


@pytest.mark.parametrize("jta", [False, True], ids=["tta", "jta"])
def test_assigner_pick_sequence_equivalence(jta):
    fast = pick_sequence(PORT, True, jta)
    assert fast == pick_sequence(PORT, False, jta)
    assert any(p is not None for p in fast)


def test_fifo_pick_matches_reference_scan():
    for case in range(20):
        out = []
        for pick in (assigners.fifo_pick_map,
                     reference.reference_fifo_pick_map):
            cluster = topology.VirtualCluster([2, 2])
            hosts = [h.hid for h in cluster.hosts()]
            q = queues.TaskQueue("t", cluster)
            rng = random.Random(1000 + case)
            for j in range(2):
                for b in range(rng.randint(2, 6)):
                    sid = f"f/{case}/{j}/{b}"
                    if rng.random() < 0.8:
                        cluster.place_shard(
                            sid, rng.sample(hosts, rng.randint(1, 2)))
                    q.append(job.MapTask(j, b, sid, 128))
            seq = []
            while q:
                t = pick(q, hosts[rng.randrange(len(hosts))], cluster)
                seq.append((t.job_id, t.index))
            out.append(seq)
        assert out[0] == out[1]


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError, match="unknown algorithm"):
        reference.make_reference_algorithm("lifo",
                                           topology.VirtualCluster([2]))


# ------------------------------------------- the port against JAX's stack --
@pytest.mark.parametrize("name", ALGOS)
def test_reference_matches_jax_reference(name):
    """Port reference against JAX reference on one seeded workload:
    equal metrics and equal per-task pick sequences."""
    ours = run_sim(PORT, True, name, 4)
    assert ours == run_sim(JAX, True, name, 4)
    assert ours[1]


@pytest.mark.parametrize("jta", [False, True], ids=["tta", "jta"])
def test_reference_pick_sequence_matches_jax(jta):
    assert pick_sequence(PORT, False, jta) == pick_sequence(JAX, False, jta)
