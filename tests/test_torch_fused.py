"""Fused small-area groups in the port: ``gpu_solver.fused_pipeline``
(K1s, K1, K2, K3 and K4 with a leading area axis, one launch a step for
every area, each area's loops gated and counted on their own) against
the JAX package's ``tpu_solver._fused_pipeline`` lane for lane, each
lane's trips and rounds against its own unfused run, and the solver's
grouping (``fuse_small_areas``, ``fuse_n_cap``, ``small_graph_nodes``)
against the JAX package's CPU oracle on the two-area scenario of
tests/test_async_dispatch.py::TestFusedDispatch.

The same numpy inputs go through a fresh ``jax.jit`` of the raw fused
pipeline on the CPU backend (no AOT cache) and through the port on CPU
tensors, where every kernel runs its plain version (a loop over the
lanes under the same per-lane gates). Everything is int32: tolerance 0.

Port modules import inside the fixture so that collecting this file in
a worker that never runs it imports no torch.
"""

import dataclasses
import types

import numpy as np
import pytest

from openr_tpu.decision.spf_solver import SpfSolver
from openr_tpu.decision.tpu_solver import _fused_pipeline
from openr_tpu.models import topologies
from openr_tpu.types import (
    AdjacencyDatabase,
    PrefixDatabase,
    PrefixEntry,
)
from tests.test_link_state import adj
from tests.test_torch_lfa import _weighted
from tests.test_torch_pipeline import jax_inputs
from tests.test_torch_solver import assert_rib_equal, to_port
from tests.torch_jax_state import jax_state_barrier  # noqa: F401

FIELDS = ("delta_buf", "full_buf", "metric", "s3w", "nhw", "lfa_slot",
          "lfa_metric")


@pytest.fixture(scope="module")
def port():
    """The port's modules, with torch held to one thread while this
    module's tests run."""
    import torch

    from openr_tpu_torch import types as ptypes
    from openr_tpu_torch import weights
    from openr_tpu_torch.decision import gpu_solver
    from openr_tpu_torch.models import topologies as ptopo
    from openr_tpu_torch.runtime.counters import counters

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(torch=torch, types=ptypes, weights=weights,
                                gpu_solver=gpu_solver, topologies=ptopo,
                                counters=counters)
    torch.set_num_threads(prev)


# -- the fused pipeline against _fused_pipeline ----------------------------

# (metric seed or None for unit metrics, root) of each lane: one grid
# shape, its own weights and vantage, so lanes converge in different trips
LANES = [(1, "node-0-0"), (None, "node-6-6"), (3, "node-11-2")]


def _lane_inputs(g, prev_seed):
    """g lanes of one 12 x 12 grid shape: (JAX args of each lane,
    static)."""
    lanes, static = [], None
    for i, (seed, me) in enumerate(LANES[:g]):
        adj_dbs, pdbs = topologies.grid(12, node_labels=False)
        if seed is not None:
            adj_dbs = _weighted(adj_dbs, seed)
        states, ps = topologies.build_states(adj_dbs, pdbs)
        args, st = jax_inputs(states, ps, me, prev_seed=(
            None if prev_seed is None else prev_seed + i))
        if prev_seed is not None:
            rng = np.random.default_rng(prev_seed + 10 * i)
            args[12] = rng.integers(-1, 3, st["p_cap"]).astype(np.int32)
            args[13] = rng.integers(0, 4, st["p_cap"]).astype(np.int32)
        key = {k: v for k, v in st.items() if k != "delta_exp"}
        if static is None:
            static = st
        assert key == {k: v for k, v in static.items()
                       if k != "delta_exp"}, "lanes must share a shape"
        lanes.append(args)
    return lanes, static


@pytest.mark.parametrize("g,kernel,lfa,prev_seed", [
    (2, "sync", False, None),
    (3, "sync", True, 4),
    (2, "bucketed", True, None),
    (3, "bucketed", False, 7),
])
def test_fused_pipeline_matches_jax_per_lane(port, g, kernel, lfa,
                                             prev_seed):
    """Every lane's delta_buf, full_buf and resident outputs equal
    ``_fused_pipeline``'s; every lane's trips and rounds equal its own
    unfused run of the port's pipeline, and the lanes' counts differ."""
    lanes, st = _lane_inputs(g, prev_seed)
    dexp = st["delta_exp"] if kernel == "bucketed" else 0
    if kernel == "bucketed":
        assert dexp > 0, "the case must engage the bucketed kernel"
    budget = 4096
    run = _fused_pipeline.__wrapped__(
        g, st["n_cap"], st["s_cap"], st["r_cap"], st["kr_cap"],
        st["has_res"], st["d_cap"], st["p_cap"], st["a_cap"], budget, lfa,
        False, True, kernel, dexp,
    )
    want = run(*[tuple(lane[i] for lane in lanes) for i in range(14)])
    names = port.weights.JAX_ARGS
    kw = dict(has_res=st["has_res"], sentinels=True, kernel=kernel,
              delta_exp=dexp, budget=budget, lfa=lfa)
    inputs = [port.weights.from_jax_state(lane, device="cpu")
              for lane in lanes]
    got = port.gpu_solver.fused_pipeline(
        [tuple(x[n] for n in names) for x in inputs], **kw)
    assert len(got) == g
    counts = []
    for i, (out, ref, x) in enumerate(zip(got, want, inputs)):
        for field, w in zip(FIELDS, ref):
            gv = getattr(out, field).numpy()
            w = np.asarray(w)
            assert gv.dtype == np.int32 and gv.shape == w.shape, field
            np.testing.assert_array_equal(gv, w, err_msg=f"lane {i} {field}")
        single = port.gpu_solver.pipeline(**x, **kw)
        np.testing.assert_array_equal(single.full_buf.numpy(),
                                      out.full_buf.numpy())
        assert (int(out.trips), int(out.rounds)) == (
            single.trips, single.rounds), f"lane {i}"
        assert (int(out.full_buf[1]), int(out.full_buf[-1])) == (
            single.trips, single.rounds), f"lane {i}"
        counts.append((single.trips, single.rounds))
    assert len(set(counts)) > 1, f"lanes must converge apart: {counts}"


def test_lane_gates_stop_a_converged_lane(port):
    """The lane gates of the sync loop, on the plain versions: a lane
    whose seed plane is already its fixpoint runs one trip and stops;
    the others run on. The stopped lane's counters and plane stay put
    however long the others take."""
    torch = port.torch
    from openr_tpu_torch.ops import relax

    lanes, st = _lane_inputs(2, None)
    x = [port.weights.from_jax_state(lane, device="cpu") for lane in lanes]
    stack = {k: torch.stack([xi[k] for xi in x])
             for k in ("deltas", "shift_w", "res_rows", "res_nbr", "res_w",
                       "root_nbr", "root_w")}
    roots = torch.tensor([xi["root"] for xi in x], dtype=torch.int32)
    solved, counts = relax.plan_sssp_lanes(
        stack["deltas"], stack["shift_w"], stack["res_rows"],
        stack["res_nbr"], stack["res_w"], roots, stack["root_nbr"],
        stack["root_w"], st["has_res"], "sync")
    # lane 1 restarts from its own fixpoint, lane 0 from the seeds
    sw, residual, dist0 = relax.sssp_init(
        stack["shift_w"], stack["res_rows"], stack["res_nbr"],
        stack["res_w"], roots, stack["root_nbr"], stack["root_w"])
    dist0[1] = solved[1]
    lanes_state = relax.Lanes(2, "cpu")
    dist, trips, _ = relax.solve_from(
        stack["deltas"], sw, residual if st["has_res"] else None, dist0,
        "sync", lanes=lanes_state)
    assert trips == int(counts[0, 0]) > 1
    assert lanes_state.cnt[1].tolist() == [1, relax.UNROLL]
    assert lanes_state.cnt[0].tolist() == counts[0].tolist()
    assert torch.equal(dist, solved)


# -- the solver's grouping ---------------------------------------------------

def _multi_area(sizes):
    """``hub`` in one ring per area (ring size per area from ``sizes``),
    each other member announcing one loopback — the two-area scenario of
    tests/test_async_dispatch.py::_dual_area_states for sizes (4, 4).
    -> (adj_dbs, prefix_dbs) as JAX-package values."""
    adj_dbs, pdbs = [], []
    for a, n in enumerate(sizes):
        area = chr(ord("a") + a)
        members = ["hub"] + [f"{area}{i}" for i in range(n - 1)]
        adjs = {m: [] for m in members}
        for i in range(n):
            u, v = members[i], members[(i + 1) % n]
            adjs[u].append(adj(u, v))
            adjs[v].append(adj(v, u))
        adj_dbs += [AdjacencyDatabase(this_node_name=m, adjacencies=tuple(al),
                                      area=area) for m, al in adjs.items()]
        pdbs += [PrefixDatabase(
            this_node_name=m, area=area,
            prefix_entries=(PrefixEntry(prefix=f"fd00:{area}::{i + 1}/128"),),
        ) for i, m in enumerate(members[1:])]
    return adj_dbs, pdbs


def _both_states(port, adj_dbs, pdbs):
    want = topologies.build_states(adj_dbs, pdbs)
    got = port.topologies.build_states(
        to_port(adj_dbs, port.types), to_port(pdbs, port.types)
    )
    return want, got


def _cnt(port, key):
    return int(port.counters.get_counter(key) or 0)


def _spy(port, monkeypatch):
    """Count the solver's pipeline and fused_pipeline calls."""
    gs = port.gpu_solver
    calls = {"pipeline": 0, "fused_pipeline": 0}
    for name in calls:
        real = getattr(gs, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(gs, name, spy)
    return calls


def test_fused_dispatch_parity_and_counters(port, monkeypatch):
    """TestFusedDispatch in the port's types: the hub's two same-shape
    areas solve in ONE fused dispatch (fused == 2, one dispatch and two
    areas counted, two full solves) with the oracle's RIB; with
    fuse_small_areas off both areas solve apart (fused == 0) with the
    same RIB."""
    (states, ps), (pstates, pps) = _both_states(port, *_multi_area((4, 4)))
    me = "hub"
    want = SpfSolver(me).build_route_db(me, states, ps)
    calls = _spy(port, monkeypatch)
    d0 = _cnt(port, "decision.device.fused_dispatches")
    a0 = _cnt(port, "decision.device.fused_areas")
    s0 = _cnt(port, "decision.solver.full.solves")
    fused = port.gpu_solver.GpuSpfSolver(me, device="cpu")
    assert_rib_equal(want, fused.build_route_db(me, pstates, pps), "fused")
    assert fused.last_device_stats.get("fused") == 2
    assert _cnt(port, "decision.device.fused_dispatches") == d0 + 1
    assert _cnt(port, "decision.device.fused_areas") == a0 + 2
    assert _cnt(port, "decision.solver.full.solves") == s0 + 2
    assert calls == {"pipeline": 0, "fused_pipeline": 1}
    # the delta pull of an unchanged state
    assert_rib_equal(want, fused.build_route_db(me, pstates, pps), "warm")

    d1 = _cnt(port, "decision.device.fused_dispatches")
    unfused = port.gpu_solver.GpuSpfSolver(me, device="cpu",
                                           fuse_small_areas=False)
    assert_rib_equal(want, unfused.build_route_db(me, pstates, pps),
                     "unfused")
    assert unfused.last_device_stats.get("fused") == 0
    assert _cnt(port, "decision.device.fused_dispatches") == d1
    assert calls["pipeline"] == 2


@pytest.mark.parametrize("kw", [{}, {"incremental_spf": True,
                                     "enable_lfa": True}])
def test_fused_churn_stays_in_parity(port, kw):
    """TestFusedDispatch's churn (a link metric 5, 17, 3 in both areas)
    — with the incremental solve on, which a fused group never takes,
    and LFA: every build equals the oracle and stays fused."""
    adj_dbs, pdbs = _multi_area((4, 4))
    (states, ps), (pstates, pps) = _both_states(port, adj_dbs, pdbs)
    me = "hub"
    cpu = SpfSolver(me, enable_lfa=kw.get("enable_lfa", False))
    gpu = port.gpu_solver.GpuSpfSolver(me, device="cpu", **kw)
    assert_rib_equal(cpu.build_route_db(me, states, ps),
                     gpu.build_route_db(me, pstates, pps), "cold")
    for metric in (5, 17, 3):
        for area in ("a", "b"):
            u, v = f"{area}0", f"{area}1"
            db = AdjacencyDatabase(
                this_node_name=u, area=area,
                adjacencies=(adj(u, "hub"), adj(u, v, metric)),
            )
            states[area].update_adjacency_database(db)
            pstates[area].update_adjacency_database(to_port(db, port.types))
        assert_rib_equal(cpu.build_route_db(me, states, ps),
                         gpu.build_route_db(me, pstates, pps),
                         f"metric {metric}")
        st = gpu.last_device_stats
        assert st["fused"] == 2 and not st.get("incremental"), st


def test_fuse_n_cap_and_group_of_one_take_the_single_path(port,
                                                          monkeypatch):
    """Areas above fuse_n_cap and a shape with one area each solve on
    their own; the RIB is the oracle's."""
    (states, ps), (pstates, pps) = _both_states(
        port, *_multi_area((4, 4, 9)))
    me = "hub"
    want = SpfSolver(me).build_route_db(me, states, ps)
    calls = _spy(port, monkeypatch)
    solver = port.gpu_solver.GpuSpfSolver(me, device="cpu")
    assert_rib_equal(want, solver.build_route_db(me, pstates, pps), "mixed")
    # the two 4-rings fuse; the 9-ring has a shape of its own
    assert calls == {"pipeline": 1, "fused_pipeline": 1}
    capped = port.gpu_solver.GpuSpfSolver(me, device="cpu", fuse_n_cap=4)
    assert_rib_equal(want, capped.build_route_db(me, pstates, pps), "capped")
    assert calls == {"pipeline": 4, "fused_pipeline": 1}
    assert capped.last_device_stats["fused"] == 0


def test_small_graph_nodes_sends_small_areas_to_the_oracle(port,
                                                           monkeypatch):
    """An area below small_graph_nodes routes through the oracle while a
    larger one solves on the device; when every area is below it the
    whole solve is the oracle's. The RIB is the oracle's either way."""
    (states, ps), (pstates, pps) = _both_states(port, *_multi_area((4, 12)))
    me = "hub"
    want = SpfSolver(me).build_route_db(me, states, ps)
    calls = _spy(port, monkeypatch)
    solver = port.gpu_solver.GpuSpfSolver(me, device="cpu",
                                          small_graph_nodes=8)
    assert_rib_equal(want, solver.build_route_db(me, pstates, pps), "split")
    assert calls == {"pipeline": 1, "fused_pipeline": 0}
    assert set(solver.last_timing["areas"]) == {"b"}
    whole = port.gpu_solver.GpuSpfSolver(me, device="cpu",
                                         small_graph_nodes=100)
    assert_rib_equal(want, whole.build_route_db(me, pstates, pps), "whole")
    assert calls == {"pipeline": 1, "fused_pipeline": 0}
    assert whole.last_timing == {}


def test_decision_config_carries_fuse_n_cap(port):
    from openr_tpu_torch.config import DecisionConfig

    kw = dataclasses.replace(DecisionConfig(), fuse_n_cap=64).solver_kwargs()
    solver = port.gpu_solver.GpuSpfSolver("hub", device="cpu", **kw)
    assert solver.fuse_n_cap == 64 and solver.fuse_small_areas
