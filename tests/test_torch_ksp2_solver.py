"""The port solver's device-assisted KSP2 (``GpuSpfSolver._prime_ksp2``
over openr_tpu_torch/ops/ksp2.py) against the port's CPU oracle, on the
cases of tests/test_ksp2.py (the kernels and the resident rows against
the JAX package: tests/test_torch_ksp2.py).

``GpuSpfSolver(device="cpu")`` and ``SpfSolver`` run on independent
copies of the state (the k-paths cache is shared state), and the RIBs
must be equal: the square, three vantages of grid(5), the KSP2 subset
of a WAN beside the fast path, an overloaded root, churn re-primes over
one and six rounds, and a delta budget of one pair; with no host
``run_spf`` on the device side; the KSP2 state LRU past four vantages;
the UCMP resolver reusing the KSP2 base field. The port runs on CPU
tensors, so every kernel runs its plain PyTorch version.
"""

import dataclasses
import types

import numpy as np
import pytest

from tests.test_torch_solver import assert_rib_equal
from tests.torch_jax_state import jax_state_barrier  # noqa: F401

INF_E = 1 << 29
KSP2 = "KSP2_ED_ECMP"


@pytest.fixture(scope="module")
def port():
    """The port's modules, with torch held to one thread while this
    module's tests run."""
    import torch

    from openr_tpu_torch import types as ptypes
    from openr_tpu_torch.decision import gpu_solver, spf_solver
    from openr_tpu_torch.models import topologies as ptopo
    from openr_tpu_torch.ops import ksp2

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(
        torch=torch, types=ptypes, gpu_solver=gpu_solver,
        spf_solver=spf_solver, topologies=ptopo, ksp2=ksp2,
    )
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def fresh_caps(port, monkeypatch):
    """The sticky caps start empty in every test: they are module state,
    and one test's caps would change another's b_cap and its init /
    delta branch."""
    monkeypatch.setattr(port.ksp2, "_cap_highwater", {})


def _fresh(port, gen):
    adj_dbs, prefix_dbs = gen()
    return port.topologies.build_states(adj_dbs, prefix_dbs)


def _count_spf(link_state):
    """Wrap ``run_spf`` of a port LinkState to count its calls."""
    calls = {"spf": 0}
    orig = link_state.run_spf

    def counting(root, use_link_metric=True, links_to_ignore=()):
        calls["spf"] += 1
        return orig(root, use_link_metric, links_to_ignore)

    link_state.run_spf = counting
    return calls


def _run_both(port, me, gen, **kw):
    """The oracle and the device solver on independent state (the
    k-paths cache is shared state), RIBs equal. -> (oracle RIB, device
    solver, host run_spf calls on the device side)."""
    cpu_states, cpu_ps = _fresh(port, gen)
    gpu_states, gpu_ps = _fresh(port, gen)
    calls = _count_spf(gpu_states["0"])
    want = port.spf_solver.SpfSolver(me, **kw).build_route_db(
        me, cpu_states, cpu_ps)
    gpu = port.gpu_solver.GpuSpfSolver(me, device="cpu", **kw)
    got = gpu.build_route_db(me, gpu_states, gpu_ps)
    assert_rib_equal(want, got, me)
    return want, gpu, calls["spf"]


def _grid(port, side):
    pfa = port.types.PrefixForwardingAlgorithm
    return lambda: port.topologies.grid(side, forwarding_algorithm=getattr(
        pfa, KSP2))


def _wan(port):
    return lambda: port.topologies.wan(regions=2, region_side=4, ksp2_every=5)


def test_ksp2_square_device_matches_oracle(port):
    """The 2 x 2 grid: two edge-disjoint L-paths to the far corner, both
    label-stacked; a second build over unchanged state finds the k-paths
    cache primed and does no device work (the warm return)."""
    gen = _grid(port, 2)
    want, gpu, spf = _run_both(port, "node-0-0", gen)
    route = want.unicast_routes["fd00::4/128"]
    assert len(route.nexthops) == 2
    assert all(nh.mpls_action is not None for nh in route.nexthops)
    assert spf == 0 and gpu.last_timing["ksp2_rows"] == 3
    states, ps = _fresh(port, gen)
    gpu = port.gpu_solver.GpuSpfSolver("node-0-0", device="cpu")
    gpu.build_route_db("node-0-0", states, ps)
    assert_rib_equal(want, gpu.build_route_db("node-0-0", states, ps))
    assert gpu.last_timing == {}  # no ksp2_* keys: nothing was primed


@pytest.mark.parametrize("me", ["node-0-0", "node-2-3", "node-4-4"])
def test_ksp2_grid_vantages_need_zero_host_dijkstras(port, me):
    """Three vantages of grid(5): the RIB equals the oracle's, and the
    build runs no host run_spf (the k = 1 field from the device base
    SSSP, the second pass from the masked batch)."""
    _, gpu, spf = _run_both(port, me, _grid(port, 5))
    assert spf == 0, "KSP2 build fell back to a host Dijkstra"
    assert gpu.last_timing["ksp2_rows"] == 24


def test_ksp2_subset_mixed_with_fast_path(port):
    """SR_MPLS / KSP2 prefixes over a plain-IP WAN: the fast path solves
    the IP rows, the KSP2 rows get the batched second pass, one RIB."""
    pfa = port.types.PrefixForwardingAlgorithm
    want, gpu, spf = _run_both(port, "r00-n00-00", _wan(port))
    algos = {e.best_prefix_entry.forwarding_algorithm
             for e in want.unicast_routes.values()
             if e.best_prefix_entry is not None}
    assert pfa.KSP2_ED_ECMP in algos and pfa.SP_ECMP in algos
    assert spf == 0
    _, fast, slow, ksp2, by_area = gpu._partition
    assert ksp2 and by_area == {"0": ksp2} and fast["0"] and not slow


def test_ksp2_overloaded_root_still_routes(port):
    """run_spf exempts the root from its own transit drain: the prime
    restores the root's out-edges in uploaded copies — the resident
    planes keep the drain, and no base field is cached."""

    def gen():
        adj_dbs, prefix_dbs = _grid(port, 3)()
        return [dataclasses.replace(db, is_overloaded=True)
                if db.this_node_name == "node-0-0" else db
                for db in adj_dbs], prefix_dbs

    want, gpu, _ = _run_both(port, "node-0-0", gen)
    assert want.unicast_routes
    ad = gpu._area_dev["0"]
    np.testing.assert_array_equal(ad.shift_w.numpy(), ad.plan.shift_w)
    assert (ad.plan.shift_w >= INF_E).any()
    assert gpu._ksp2_base == {} and gpu._ksp2_certs == {}


def _set_metric(port, states_list, adj_dbs, victim, metric):
    t = port.types
    db = next(d for d in adj_dbs if d.this_node_name == victim)
    new = t.AdjacencyDatabase(
        this_node_name=victim,
        adjacencies=tuple(dataclasses.replace(a, metric=metric)
                          for a in db.adjacencies),
        node_label=db.node_label, area="0")
    for states in states_list:
        states["0"].update_adjacency_database(new)


@pytest.mark.parametrize("cell,me,victims,metrics", [
    ("grid", "node-0-0", ["node-1-1"], [5]),
    ("wan", "r00-n00-00", ["r00-n00-01", "r01-n02-02", "r00-n01-01"] * 2,
     [1, 90, 3, 40, 7, 1]),
])
def test_ksp2_churn_stays_parity_exact(port, cell, me, victims, metrics):
    """Churn re-primes the k-paths cache from fresh device fields: one
    round on grid(4), and six rounds on the WAN through the trace-reuse
    certificates and the previous generation's delta rows, victims near
    and far from the vantage, metrics that move first paths. Every round
    equals the oracle's RIB with no host run_spf, and every round after
    the first refreshes the rows as deltas."""
    gen = _grid(port, 4) if cell == "grid" else _wan(port)
    cpu_states, cpu_ps = _fresh(port, gen)
    gpu_states, gpu_ps = _fresh(port, gen)
    calls = _count_spf(gpu_states["0"])
    cpu = port.spf_solver.SpfSolver(me)
    gpu = port.gpu_solver.GpuSpfSolver(me, device="cpu")
    assert_rib_equal(cpu.build_route_db(me, cpu_states, cpu_ps),
                     gpu.build_route_db(me, gpu_states, gpu_ps), "round 0")
    adj_dbs, _ = gen()
    kinds = []
    for rnd, (victim, metric) in enumerate(zip(victims, metrics)):
        _set_metric(port, (cpu_states, gpu_states), adj_dbs, victim, metric)
        assert_rib_equal(cpu.build_route_db(me, cpu_states, cpu_ps),
                         gpu.build_route_db(me, gpu_states, gpu_ps),
                         f"round {rnd + 1} ({victim}, {metric})")
        tm = gpu.last_timing
        kinds.append("init" if tm.get("ksp2_init") else "delta")
    assert calls["spf"] == 0
    assert kinds == ["delta"] * len(victims)


def test_ksp2_delta_overflow_falls_back_to_full_rows(port, monkeypatch):
    """A row deviating in more nodes than the delta budget ships whole —
    the same RIB either way."""
    monkeypatch.setattr(port.ksp2, "_DELTA_K", 1)
    gen = _grid(port, 4)
    cpu_states, cpu_ps = _fresh(port, gen)
    gpu_states, gpu_ps = _fresh(port, gen)
    cpu = port.spf_solver.SpfSolver("node-0-0")
    gpu = port.gpu_solver.GpuSpfSolver("node-0-0", device="cpu")
    gpu.build_route_db("node-0-0", gpu_states, gpu_ps)
    _set_metric(port, (cpu_states, gpu_states), gen()[0], "node-1-1", 7)
    assert_rib_equal(cpu.build_route_db("node-0-0", cpu_states, cpu_ps),
                     gpu.build_route_db("node-0-0", gpu_states, gpu_ps))
    assert gpu.last_timing["ksp2_overflow_rows"] > 0


def test_ksp2_state_lru_keeps_four_vantages(port):
    """Five vantages through one solver: each RIB equals the oracle's, and
    the KSP2 state (rows, base, certificates) of the least recent vantage
    is evicted past four."""
    gen = _grid(port, 4)
    states, ps = _fresh(port, gen)
    gpu = port.gpu_solver.GpuSpfSolver("node-0-0", device="cpu")
    vantages = ["node-0-0", "node-1-2", "node-3-3", "node-2-0", "node-0-3"]
    for me in vantages:
        ref_states, ref_ps = _fresh(port, gen)
        want = port.spf_solver.SpfSolver(me).build_route_db(me, ref_states,
                                                            ref_ps)
        assert_rib_equal(want, gpu.build_route_db(me, states, ps), me)
    kept = [("0", me) for me in vantages[1:]]
    assert list(gpu._ksp2_lru) == kept
    for cache in (gpu._ksp2_rows, gpu._ksp2_base, gpu._ksp2_certs):
        assert sorted(cache) == sorted(kept)


def test_ucmp_reuses_the_ksp2_base_field(port, monkeypatch):
    """A vantage with UCMP and KSP2 prefixes in one area computes the
    unmasked base field once per topology generation: the UCMP resolver
    takes the KSP2 prime's field before its own cache (as the JAX
    ``_UcmpAccel._base_for``)."""
    gs = port.gpu_solver
    t = port.types
    calls = []
    real = gs.base_sssp

    def counting(*a, **k):
        calls.append(a[5])
        return real(*a, **k)

    monkeypatch.setattr(gs, "base_sssp", counting)

    def gen():
        adj_dbs, pdbs = _grid(port, 4)()
        ucmp = t.PrefixForwardingAlgorithm.SP_UCMP_PREFIX_WEIGHT_PROPAGATION
        for node, w in (("node-3-3", 2), ("node-3-2", 5)):
            pdbs.append(t.PrefixDatabase(
                this_node_name=node, area="0", prefix_entries=(
                    t.PrefixEntry(prefix="fd10::1/128",
                                  forwarding_algorithm=ucmp, weight=w),)))
        return adj_dbs, pdbs

    cpu_states, cpu_ps = _fresh(port, gen)
    gpu_states, gpu_ps = _fresh(port, gen)
    cpu = port.spf_solver.SpfSolver("node-0-0", enable_ucmp=True)
    gpu = gs.GpuSpfSolver("node-0-0", device="cpu", enable_ucmp=True)
    for rnd in range(2):
        if rnd:
            _set_metric(port, (cpu_states, gpu_states), gen()[0],
                        "node-1-1", 4)
        got = gpu.build_route_db("node-0-0", gpu_states, gpu_ps)
        assert_rib_equal(cpu.build_route_db("node-0-0", cpu_states, cpu_ps),
                         got, f"round {rnd}")
        assert got.unicast_routes["fd10::1/128"].ucmp_weight is not None
        assert len(calls) == rnd + 1, "one base field per generation"
    assert gpu._ucmp_accel.base == {}
