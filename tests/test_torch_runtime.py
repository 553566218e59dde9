"""The port's fault-tolerance runtime (``repro_torch.runtime``) on the CPU:
the JAX package's runtime tests on the port, then ``HealthTracker``,
``SpeculativeLauncher`` and ``plan_elastic_remesh`` driven alongside the
JAX ones on the same seeded event sequences, every answer compared."""
import dataclasses
import random

import pytest

pytest.importorskip("torch")

from repro.core.topology import VirtualCluster as JaxCluster  # noqa: E402
from repro.runtime import HealthTracker as JaxHealth  # noqa: E402
from repro.runtime import SpeculativeLauncher as JaxSpec  # noqa: E402
from repro.runtime import plan_elastic_remesh as jax_plan  # noqa: E402
from repro_torch.core.topology import VirtualCluster  # noqa: E402
from repro_torch.runtime import (HealthTracker, HostState,  # noqa: E402
                                 SpeculativeLauncher, plan_elastic_remesh)


# --------------------------------------------- the JAX tests, on the port --
def test_health_state_machine():
    ht = HealthTracker(suspect_after=5, dead_after=10)
    ht.beat("h1", now=0.0)
    ht.beat("h2", now=0.0)
    assert ht.sweep(4.0) == []
    assert ht.state("h1") is HostState.HEALTHY
    ht.sweep(6.0)
    assert ht.state("h1") is HostState.SUSPECT
    ht.beat("h2", 6.0)
    assert ht.sweep(11.0) == ["h1"]
    assert ht.state("h2") is HostState.SUSPECT
    assert ht.alive() == ["h2"]
    ht.beat("h2", 12.0)
    assert ht.state("h2") is HostState.HEALTHY
    assert ht.state("never-seen") is HostState.DEAD


def test_speculative_launcher_policy():
    sp = SpeculativeLauncher(slack=2.0, min_samples=3, max_backups=1)
    for i in range(3):
        sp.task_started(f"t{i}", now=0.0)
        sp.task_finished(f"t{i}", now=10.0)
    sp.task_started("slow", now=100.0)
    assert sp.stragglers(now=115.0) == []
    assert sp.stragglers(now=125.0) == ["slow"]
    sp.backup_launched("slow")
    assert sp.stragglers(now=200.0) == []
    sp.task_finished("slow", now=205.0)
    assert sp.stragglers(now=300.0) == []


def test_elastic_plan_reassigns_orphans():
    cluster = VirtualCluster([4, 4, 4])
    shard_home = {f"s{i}": i % 3 for i in range(9)}
    plan = plan_elastic_remesh(cluster, [0, 2], shard_home, model_parallel=4)
    orphans = {s for s, h in shard_home.items() if h == 1}
    assert set(plan.orphan_reassignment) == orphans
    assert set(plan.orphan_reassignment.values()) <= {0, 2}
    assert plan.new_td == pytest.approx(2.0)
    assert plan.new_n_avg == pytest.approx(4.0)
    assert plan.batch_scale == pytest.approx(2 / 3)


def test_elastic_single_pod_td_infinite_and_no_survivors_raise():
    cluster = VirtualCluster([4, 4])
    assert plan_elastic_remesh(cluster, [1], {},
                               model_parallel=2).new_td == float("inf")
    with pytest.raises(ValueError, match="no surviving pods"):
        plan_elastic_remesh(cluster, [], {})


# ------------------------------------------ alongside JAX, seeded events --
@pytest.mark.parametrize("seed", range(4))
def test_health_tracker_matches_jax(seed):
    """Random beats and sweeps over 12 hosts: every sweep's newly dead
    list, every host's state and the alive list agree at every step."""
    rng = random.Random(seed)
    kw = dict(suspect_after=rng.uniform(2, 8), dead_after=rng.uniform(9, 20))
    ours, theirs = HealthTracker(**kw), JaxHealth(**kw)
    hosts = [f"h{i}" for i in range(12)]
    now = 0.0
    for _ in range(400):
        now += rng.expovariate(2.0)
        if rng.random() < 0.7:
            h = rng.choice(hosts)
            ours.beat(h, now)
            theirs.beat(h, now)
        else:
            assert ours.sweep(now) == theirs.sweep(now)
        assert ours.alive() == theirs.alive()
        assert [ours.state(h).value for h in hosts] \
            == [theirs.state(h).value for h in hosts]


@pytest.mark.parametrize("seed", range(4))
def test_speculative_launcher_matches_jax(seed):
    """Random task starts, finishes, straggler polls and backup launches:
    the straggler lists and the running median agree at every step."""
    rng = random.Random(100 + seed)
    kw = dict(slack=rng.uniform(1.2, 2.5), min_samples=rng.randint(2, 6),
              max_backups=rng.randint(1, 2))
    ours, theirs = SpeculativeLauncher(**kw), JaxSpec(**kw)
    running, now, n = [], 0.0, 0
    for _ in range(600):
        now += rng.expovariate(1.0)
        r = rng.random()
        if r < 0.35 or not running:
            tid = f"t{n}"
            n += 1
            running.append(tid)
            ours.task_started(tid, now)
            theirs.task_started(tid, now)
        elif r < 0.65:
            tid = running.pop(rng.randrange(len(running)))
            ours.task_finished(tid, now)
            theirs.task_finished(tid, now)
        else:
            got = ours.stragglers(now)
            assert got == theirs.stragglers(now)
            for tid in got[:1]:
                ours.backup_launched(tid)
                theirs.backup_launched(tid)
        assert ours.median() == theirs.median()


@pytest.mark.parametrize("seed", range(6))
def test_elastic_remesh_matches_jax(seed):
    """Random pod layouts, survivor sets and shard homes: equal plans,
    field by field."""
    rng = random.Random(200 + seed)
    sizes = [rng.randint(2, 16) for _ in range(rng.randint(2, 6))]
    survivors = sorted(rng.sample(range(len(sizes)),
                                  rng.randint(1, len(sizes))))
    homes = {f"s{i}": rng.randrange(len(sizes))
             for i in range(rng.randint(0, 40))}
    mp = rng.choice([1, 2, 4, 16])
    ours = plan_elastic_remesh(VirtualCluster(sizes), survivors, homes,
                               model_parallel=mp)
    theirs = jax_plan(JaxCluster(sizes), survivors, homes, model_parallel=mp)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
