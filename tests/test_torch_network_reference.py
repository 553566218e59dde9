"""The port's per-flow reference fabric (``repro_torch.sim.network_reference``)
on the CPU: ``make_fabric`` builds it for ``allocator="reference"``, it gives
trajectories bit-identical to the port's class-aggregated fast path on the
end-to-end fabric cases of the JAX package's ``tests/test_fabric_fastpath.py``,
and both equal the JAX package's reference on the same cases. Exact equality
throughout: both sides run the same float64 Python arithmetic."""
import importlib
import types

import pytest

pytest.importorskip("torch")

from repro_torch.sim.engine import EventKernel  # noqa: E402
from repro_torch.sim.network import (FabricConfig, NetworkFabric,  # noqa: E402
                                     make_fabric)
from repro_torch.sim.network_reference import \
    ReferenceNetworkFabric  # noqa: E402
from repro_torch.sim.workloads import make_cluster  # noqa: E402

VARIANTS = ("static", "churn", "churn+durability", "speculative")


def _pkg(name):
    imp = importlib.import_module
    return types.SimpleNamespace(
        joss=imp(f"{name}.core.joss"), topo=imp(f"{name}.core.topology"),
        sim=imp(f"{name}.sim.cluster_sim"), net=imp(f"{name}.sim.network"),
        wl=imp(f"{name}.sim.workloads"), el=imp(f"{name}.elastic"),
        golden=imp(f"{name}.sim.golden"), engine=imp(f"{name}.sim.engine"))


PORT, JAX = _pkg("repro_torch"), _pkg("repro")


def _e2e(p, allocator, variant, elastic_links=None):
    """The fastpath suite's end-to-end case, built from package ``p``."""
    links = p.wl.fabric_links((4, 4), wan_oversub=8.0)
    cluster = p.wl.make_cluster((4, 4), links=links)
    jobs = p.wl.small_workload(cluster, seed=11, n_jobs=12)
    algo = p.joss.make_algorithm("joss-t", cluster)
    for j in p.wl.profiling_prelude(cluster):
        algo.registry.record(j, j.true_fp)
    cfg_kw, elastic = {}, None
    if variant in ("churn", "churn+durability"):
        dur = (p.el.DurabilityConfig(rereplicate=True, rerep_delay=5.0,
                                     checkpoint=True)
               if variant == "churn+durability" else None)
        elastic = p.el.ElasticEngine(
            cluster, churn=p.el.ChurnConfig(seed=12, fail_rate=4.0,
                                            rejoin_delay=60.0),
            autoscaler=p.el.FixedFleet(), durability=dur)
    elif variant == "speculative":
        cfg_kw = dict(speculative=True,
                      slow_hosts={p.topo.HostId(0, 0): 4.0})
    if elastic_links is not None:
        elastic_links = p.topo.ElasticLinks(**elastic_links)
    cfg = p.sim.SimConfig(fabric=p.net.FabricConfig(
        allocator=allocator, elastic=elastic_links), **cfg_kw)
    res = p.sim.Simulator(cluster, algo, jobs, config=cfg, seed=11,
                          elastic=elastic).run()
    assert len(res.job_finish) == 12
    return res


def _fabric_state(res):
    f = res.fabric
    return (f.completion_log, f.link_util, f.n_flows, f.n_cancelled,
            f.mb_total, f.stall_s, f.by_kind)


def test_make_fabric_selects_reference():
    cluster = make_cluster((2, 2))
    assert isinstance(make_fabric(cluster, FabricConfig()), NetworkFabric)
    assert isinstance(
        make_fabric(cluster, FabricConfig(allocator="reference")),
        ReferenceNetworkFabric)
    with pytest.raises(ValueError, match="unknown fabric allocator"):
        make_fabric(cluster, FabricConfig(allocator="bogus"))


@pytest.mark.parametrize("variant", VARIANTS)
def test_end_to_end_bit_identity(variant):
    fast = _e2e(PORT, "fast", variant)
    ref = _e2e(PORT, "reference", variant)
    jax_ref = _e2e(JAX, "reference", variant)
    assert fast.fabric.completion_log, "scenario produced no flows"
    assert _fabric_state(fast) == _fabric_state(ref) == _fabric_state(jax_ref)
    sig = PORT.golden.full_signature(ref)
    assert PORT.golden.full_signature(fast) == sig
    assert JAX.golden.full_signature(jax_ref) == sig


def test_end_to_end_bit_identity_with_elastic_links():
    el = dict(host_up=220.0, host_down=220.0, wan_per_host=35.0)
    fast = _e2e(PORT, "fast", "churn+durability", el)
    ref = _e2e(PORT, "reference", "churn+durability", el)
    jax_ref = _e2e(JAX, "reference", "churn+durability", el)
    assert _fabric_state(fast) == _fabric_state(ref) == _fabric_state(jax_ref)
    assert (PORT.golden.full_signature(fast)
            == PORT.golden.full_signature(ref)
            == JAX.golden.full_signature(jax_ref))


class _Sim:
    pass


def _bare(p, allocator, links):
    cluster = p.wl.make_cluster((2, 2), links=p.topo.LinkCapacities(**links))
    fab = p.net.make_fabric(cluster, p.net.FabricConfig(allocator=allocator))
    k = p.engine.EventKernel()
    fab.attach(_Sim(), k)
    return fab, k


def _choreograph(fab, k):
    """Start/cancel script over shared classes, rebalances, cancels and a
    late joiner (the fastpath suite's); returns the completion trace."""
    trace, fids = [], {}

    def done(tag):
        return lambda now: trace.append((tag, now))

    for i in range(6):
        fids[f"a{i}"] = fab.start_flow(0.0, 40.0 + 3.0 * i, 0, 0, 110.0,
                                       "intra", done(f"a{i}"))
    for i in range(5):
        fids[f"b{i}"] = fab.start_flow(0.0, 60.0 + 5.0 * i, 0, 1, 35.0,
                                       "inter", done(f"b{i}"))
    for i in range(3):
        fids[f"c{i}"] = fab.start_flow(0.0, 25.0 + 7.0 * i, None, 1, 35.0,
                                       "ext", done(f"c{i}"))
    k.call_at(0.4, lambda now: fab.cancel(fids["b3"], now))
    k.call_at(0.9, lambda now: fab.cancel(fids["a5"], now))
    k.call_at(1.3, lambda now: fab.start_flow(now, 80.0, 1, 0, 110.0,
                                              "late", done("late")))
    k.call_at(1.3, lambda now: fab.cancel(fids["c2"], now))
    k.run()
    s = fab.finalize(2.0)
    return trace, s.completion_log, s.link_util, s.n_cancelled, s.by_kind


@pytest.mark.parametrize("wan", [95.0, 35.0, 1e6])
def test_choreographed_reference_equals_fast_and_jax(wan):
    links = dict(pod_up=260.0, pod_down=260.0, wan=wan)
    ref = _choreograph(*_bare(PORT, "reference", links))
    # 16 started, 3 cancelled (one of them, c2, finishes first on the
    # uncontended WAN)
    assert len(ref[0]) == (13 if wan > 1e3 else 12)
    assert ref == _choreograph(*_bare(PORT, "fast", links))
    assert ref == _choreograph(*_bare(JAX, "reference", links))


def test_reference_rates_after_each_start_equal_fast():
    links = dict(pod_up=300.0, pod_down=300.0, wan=70.0)
    (fa, _), (fr, _) = (_bare(PORT, "fast", links),
                        _bare(PORT, "reference", links))
    script = [(0, 1, 35.0), (0, 1, 35.0), (0, 0, 110.0), (None, 1, 35.0),
              (1, 0, 35.0), (0, 1, 20.0), (0, 0, 110.0), (1, 1, 110.0)]
    for i, (src, dst, cap) in enumerate(script):
        fa.start_flow(0.0, 50.0 + i, src, dst, cap, "t", lambda n: None)
        fr.start_flow(0.0, 50.0 + i, src, dst, cap, "t", lambda n: None)
        assert ({fid: f.rate for fid, f in fa._flows.items()}
                == {fid: f.rate for fid, f in fr._flows.items()})


def test_reference_starved_flow_resumes():
    """A flow whose elastic downlink drops to zero gets rate 0.0 and arms
    no completion; it finishes once a host brings capacity back."""
    from repro_torch.core.topology import ElasticLinks
    cluster = make_cluster((2, 2))
    fab = make_fabric(cluster, FabricConfig(
        allocator="reference",
        elastic=ElasticLinks(host_up=100.0, host_down=100.0)))
    k = EventKernel()
    fab.attach(_Sim(), k)
    done = []
    fab.start_flow(0.0, 100.0, 0, 1, 1e6, "t", done.append)
    assert next(iter(fab._flows.values())).rate == 200.0
    for hid in [h.hid for h in cluster.pods[1].hosts]:
        fab.on_host_lost(cluster.remove_host(hid), 0.25)
    assert next(iter(fab._flows.values())).rate == 0.0
    k.run()
    assert done == [] and len(fab._flows) == 1
    fab.on_host_added(cluster.add_host(1).hid, 10.0)
    k.run()
    assert done == [10.5]
