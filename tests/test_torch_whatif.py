"""The port's what-if sweeps (openr_tpu_torch/ops/sweep.py, csrc/sweep.cu,
K10 of csrc/ksp2.cu) and engine (openr_tpu_torch/decision/whatif.py).

- ``sweep`` against a fresh jit of the JAX package's
  ``ops/sweep.py::_make_sweep`` (not ``sweep_batch``, whose
  ``instrument_jit`` path installs AOT executables): verdicts, trips,
  rounds and the distance planes, with and without a residual, one and
  two roots, pad lanes and pad slots, for the sync and the
  bucketed-named reference sweeps (the reference runs the synchronous
  rounds for both).
- ``WhatIfEngine`` over ``GpuSpfSolver(device="cpu")``: the N-1 verdicts
  and distance rows against a host ``run_spf`` of the LSDB without the
  link (a full mesh, a grid, a fat tree and a ring), N-2 on a ring,
  ``max_scenarios``, ``fuse_n_cap`` chunking, node and link drains
  against the host field, and an armed ``solver.whatif`` fault.

Everything is int32: tolerance 0.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest

from openr_tpu.models import topologies
from openr_tpu.ops import sweep as jsweep
from openr_tpu.ops.edgeplan import _ensure_edge_loc, build_plan, edge_loc_of
from tests.torch_jax_state import jax_state_barrier  # noqa: F401

INF_E = 1 << 29
AREA = "0"


@pytest.fixture(scope="module")
def port():
    """The port's modules, with torch held to one thread while this
    module's tests run."""
    import torch

    from openr_tpu_torch.decision import gpu_solver, whatif
    from openr_tpu_torch.models import topologies as ptopo
    from openr_tpu_torch.ops import sweep
    from openr_tpu_torch.runtime import counters, faults
    from openr_tpu_torch.runtime.tracing import tracer

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(
        torch=torch, gpu_solver=gpu_solver, whatif=whatif, topologies=ptopo,
        sweep=sweep, counters=counters.counters, faults=faults,
        tracer=tracer,
    )
    torch.set_num_threads(prev)


# -- the sweep kernel against _make_sweep -------------------------------------

_SWEEP_CELLS = {
    "grid4": lambda: topologies.grid(4),
    "fabric": lambda: topologies.fabric(pods=4, planes=2, ssws_per_plane=2,
                                        rsws_per_pod=4),
}


def _overlays(plan, ls, lanes, es, er, seed):
    """Random failed links, one or two a lane, as the engine writes them:
    lane 0 the identity, the last lane a pad lane (all slots pads)."""
    rng = np.random.default_rng(seed)
    r_cap, kr_cap = plan.res_nbr.shape
    sh_idx = np.full((lanes, es), plan.s_cap * plan.n_cap, np.int32)
    sh_val = np.zeros((lanes, es), np.int32)
    rs_idx = np.full((lanes, er), r_cap * kr_cap, np.int32)
    rs_val = np.zeros((lanes, er), np.int32)
    links = [ln for ln in ls.ordered_all_links() if ln.is_up()]
    for lane in range(1, lanes - 1):
        si = ri = 0
        for li in rng.choice(len(links), size=1 + lane % 2, replace=False):
            link = links[li]
            for src in (link.n1, link.n2):
                kind, a, b = edge_loc_of(plan, link, src)
                if kind == "s":
                    sh_idx[lane, si] = a * plan.n_cap + b
                    sh_val[lane, si] = INF_E
                    si += 1
                else:
                    rs_idx[lane, ri] = a * kr_cap + b
                    rs_val[lane, ri] = INF_E
                    ri += 1
    return sh_idx, sh_val, rs_idx, rs_val


@pytest.mark.parametrize("cell,kernel,return_dist,r", [
    ("grid4", "sync", True, 1),
    ("grid4", "bucketed", False, 2),
    ("grid4", "bucketed", True, 2),
    ("fabric", "sync", False, 2),
    ("fabric", "bucketed", True, 1),
    ("fabric", "sync", True, 2),
])
def test_sweep_matches_make_sweep(port, cell, kernel, return_dist, r):
    """The port's ``sweep`` equals ``_make_sweep``'s outputs, tuple for
    tuple — verdicts, trips, the planes, rounds — over 8 lanes (the
    identity, six scenarios, a pad lane); the fabric's pod-crossing
    spine links sit in the residual ELL."""
    adj_dbs, _ = _SWEEP_CELLS[cell]()
    states, _ = topologies.build_states(adj_dbs, [])
    ls = states[AREA]
    plan = build_plan(ls)
    _ensure_edge_loc(plan)
    has_res = plan.k_res > 0
    assert has_res == (cell == "fabric")
    lanes, es, er = 8, 8, 8
    ov = _overlays(plan, ls, lanes, es, er, seed=r)
    names = sorted(ls.node_names())
    roots = np.array([plan.node_index[n] for n in names[:r]], np.int32)
    r_cap, kr_cap = plan.res_nbr.shape
    delta_exp = plan.delta_exp if kernel == "bucketed" else 0
    bound = jsweep.sweep_max_trips(plan.n_cap)
    fn = jax.jit(jsweep._make_sweep(
        lanes, r, es, er, plan.n_cap, plan.s_cap, r_cap, kr_cap, has_res,
        bound, return_dist, kernel, delta_exp))
    planes = (plan.deltas, plan.shift_w, plan.res_rows, plan.res_nbr,
              plan.res_w)
    want = [np.asarray(x) for x in fn(*planes, roots, *ov)]
    t = port.torch.tensor
    got = port.sweep.sweep(*(t(a) for a in planes), t(roots),
                           *(t(a) for a in ov), has_res=has_res,
                           max_trips=bound, return_dist=return_dist)
    assert len(got) == len(want) == (6 if return_dist else 5)
    for w, g in zip(want, got):
        g = g.numpy() if isinstance(g, port.torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, w)
    # a pad lane is the identity overlay: judged equal to lane 0
    assert not (want[0][-1] or want[1][-1] or want[2][-1])
    assert int(want[-1]) == int(want[3]) * 8


# -- the engine ---------------------------------------------------------------

def _solved_engine(port, gen, **solver_kw):
    adj_dbs, prefix_dbs = gen()
    states, ps = port.topologies.build_states(adj_dbs, prefix_dbs)
    me = sorted(states[AREA].node_names())[0]
    solver = port.gpu_solver.GpuSpfSolver(me, device="cpu", **solver_kw)
    assert solver.build_route_db(me, states, ps) is not None
    return (port.whatif.WhatIfEngine(solver), adj_dbs, prefix_dbs, states,
            ps, me)


def _host_field(port, adj_dbs, prefix_dbs, root, link=None, drain=None):
    """The host's run_spf from ``root`` on the LSDB rebuilt without
    ``link``, or with node ``drain`` overloaded (no transit through it,
    still a destination — the drain preview's semantics). -> {node:
    metric}."""
    dbs = []
    for db in adj_dbs:
        if link is not None and db.this_node_name in (link.n1, link.n2):
            drop = ((link.n2, link.if1) if db.this_node_name == link.n1
                    else (link.n1, link.if2))
            db = dataclasses.replace(db, adjacencies=tuple(
                a for a in db.adjacencies
                if (a.other_node_name, a.if_name) != drop))
        if db.this_node_name == drain:
            db = dataclasses.replace(db, is_overloaded=True)
        dbs.append(db)
    states, _ = port.topologies.build_states(dbs, prefix_dbs)
    spf = states[AREA].run_spf(root)
    return {name: spf[name].metric for name in spf}


@pytest.mark.parametrize("name", ["mesh5", "grid4", "fat_tree", "ring8"])
def test_n1_sweep_matches_host_spf(port, name):
    """Every up link's scenario: its distance row equals a host run_spf
    without the link, and its verdicts (unreachable, stretch, partition)
    follow from the two fields — in one dispatch."""
    gen = {
        "mesh5": lambda: port.topologies.full_mesh(5),
        "grid4": lambda: port.topologies.grid(4),
        "fat_tree": lambda: port.topologies.fat_tree(pods=2, planes=2),
        "ring8": lambda: port.topologies.ring(8),
    }[name]
    eng, adj_dbs, pdbs, states, ps, me = _solved_engine(port, gen)
    d0 = port.counters.get_counter("whatif.device.batched_dispatches") or 0
    job = eng.plan_sweep(states, ps, order=1, return_dist=True)
    out = job.run()
    plan = job.ad.plan
    assert out["dispatches"] == len(job.dist_planes) == 1
    assert (port.counters.get_counter("whatif.device.batched_dispatches")
            - d0) == 1
    row_of = {scen.name: job.dist_planes[0][i, 0]
              for i, scen in enumerate(job.chunks[0].scenarios, start=1)}
    base = job.dist_planes[0][0, 0]
    links = [ln for ln in states[AREA].ordered_all_links() if ln.is_up()]
    assert out["scenarios"] == len(links) == len(row_of)
    verdict = {r["scenario"]: r for r in out["rows"]}
    for link in links:
        scen = f"{link.n1}|{link.n2}"
        want = _host_field(port, adj_dbs, pdbs, me, link=link)
        got = row_of[scen]
        unreachable = stretch = 0
        for node, idx in plan.node_index.items():
            if node not in want:
                assert got[idx] >= INF_E, (scen, node)
                unreachable += int(base[idx] < INF_E)
            else:
                assert int(got[idx]) == want[node], (scen, node)
                stretch = max(stretch, want[node] - int(base[idx]))
        v = verdict[scen]
        assert (v["unreachable_pairs"], v["max_stretch"],
                v["partitioned"]) == (unreachable, stretch, unreachable > 0)


def test_n2_ring_partitions_and_truncation(port):
    """ring(8) N-2: every pair of failures partitions the ring, no single
    one does; max_scenarios keeps the first scenarios and counts the
    rest."""
    eng, _, _, states, ps, _ = _solved_engine(
        port, lambda: port.topologies.ring(8))
    out = eng.sweep(states, ps, order=2)
    assert out["scenarios"] == 8 + 28
    pairs = [r for r in out["rows"] if "+" in r["scenario"]]
    assert len(pairs) == 28 and all(r["partitioned"] for r in pairs)
    assert not any(r["partitioned"] for r in out["rows"]
                   if "+" not in r["scenario"])
    cut = eng.sweep(states, ps, order=2, max_scenarios=10)
    assert cut["scenarios"] == 10 and cut["truncated"] == 26


def test_fuse_n_cap_chunks_the_sweep(port):
    """fuse_n_cap = 1 splits grid(4)'s N-2 sweep (24 + 276 scenarios)
    into dispatches of _batch_cap = 2048 // 16 lanes; the verdicts equal
    the one-dispatch sweep's at the default knob."""
    gen = lambda: port.topologies.grid(4)  # noqa: E731
    eng, _, _, states, ps, _ = _solved_engine(port, gen)
    whole = eng.sweep(states, ps, order=2)
    small, _, _, s_states, s_ps, _ = _solved_engine(port, gen, fuse_n_cap=1)
    cap = small._batch_cap(small.solver._area_dev[AREA].plan.n_cap, 1)
    chunked = small.sweep(s_states, s_ps, order=2)
    assert whole["dispatches"] == 1 and cap == 128
    assert whole["scenarios"] == 300
    assert chunked["dispatches"] == 3
    assert chunked["rows"] == whole["rows"]
    assert chunked["trips"] == whole["trips"]


@pytest.mark.parametrize("target", ["node", "link"])
def test_drain_preview_matches_host_spf(port, target):
    """A node drain (its out-edges removed: no transit, still a
    destination) and a link drain, seen from the vantage: every impacted
    node's before / after metric equals the host fields', and the
    impacted set is the nodes whose metric grew (or that were lost)."""
    eng, adj_dbs, pdbs, states, ps, me = _solved_engine(
        port, lambda: port.topologies.grid(4))
    before = _host_field(port, adj_dbs, pdbs, me)
    if target == "node":
        out = eng.drain(states, ps, node="node-0-1", top=16)
        after = _host_field(port, adj_dbs, pdbs, me, drain="node-0-1")
    else:
        out = eng.drain(states, ps, link="node-0-0|node-0-1", top=16)
        link = next(ln for ln in states[AREA].ordered_all_links()
                    if {ln.n1, ln.n2} == {"node-0-0", "node-0-1"})
        after = _host_field(port, adj_dbs, pdbs, me, link=link)
    grew = {n for n in before if after.get(n, INF_E) > before[n]}
    assert {i["node"] for i in out["impacted"]} == grew and grew
    for item in out["impacted"]:
        assert item["before"] == before[item["node"]]
        assert item["after"] == after.get(item["node"])
    assert out["changed_nodes"] == len(grew) and not out["partitioned"]


def test_armed_whatif_fault_leaves_the_solver_healthy(port):
    """An armed ``solver.whatif`` fault fails the sweep — at its entry, or
    at the dispatch of a planned job, whose trace then closes as an
    error — and the live solver still builds its RIB; the next sweep's
    trace closes as "whatif"."""
    eng, _, _, states, ps, me = _solved_engine(
        port, lambda: port.topologies.grid(3))
    port.faults.registry.arm("solver.whatif")
    try:
        with pytest.raises(port.faults.FaultInjected):
            eng.sweep(states, ps)
        job = eng.plan_sweep(states, ps)
        port.faults.registry.arm("solver.whatif")
        with pytest.raises(port.faults.FaultInjected):
            job.run()
    finally:
        port.faults.registry.clear("solver.whatif")
    failed = port.tracer.traces(1)[0]
    assert (failed["name"], failed["status"]) == ("whatif.sweep", "error")
    assert eng.sweep(states, ps)["scenarios"] == 12
    done = port.tracer.traces(1)[0]
    assert (done["status"], done["attributes"]["scenarios"]) == ("whatif", 12)
    assert [sp["name"] for sp in done["spans"]] == ["whatif.snapshot",
                                                    "whatif.dispatch"]
    assert eng.solver.build_route_db(me, states, ps).unicast_routes
