"""LFA (RFC 5286 loop-free alternate) backup next hops in the port: the
LFA branch of K3 (``ops/select.py``) and the LFA columns of K4
(``ops/compact.py``) against the JAX package's ``_plan_pipeline`` and
``_incr_pipeline`` at ``lfa=True``, input for input, and
``GpuSpfSolver(enable_lfa=True)`` against the JAX package's CPU oracle
``SpfSolver(enable_lfa=True)``, on the topologies of tests/test_lfa.py.

The same numpy inputs go through the jitted JAX pipelines on the CPU
backend (fresh ``jax.jit`` of the raw pipeline closures, no AOT cache)
and through the port on CPU tensors, which run each kernel's plain
PyTorch version. Everything is int32: tolerance 0 — the pull buffers,
the resident outputs (the LFA slot and metric among them) and the
distance plane byte for byte. RIBs are compared by value through
``canon`` (tests/test_torch_solver.py).

Port modules import inside the fixture so that collecting this file in
a worker that never runs it imports no torch.
"""

import dataclasses
import types

import numpy as np
import pytest

from openr_tpu.decision.spf_solver import SpfSolver
from openr_tpu.decision.tpu_solver import (
    _fast_path_eligible,
    _incr_pipeline,
    _pack_matrix,
    _plan_pipeline,
)
from openr_tpu.models import topologies
from openr_tpu.ops.csr import build_prefix_matrix
from openr_tpu.ops.edgeplan import build_plan, drain_dirty, sync_plan
from openr_tpu.types import Adjacency, AdjacencyDatabase, PrefixMetrics
from tests.test_link_state import adj, adj_db
from tests.test_spf_solver import prefix_db
from tests.test_torch_pipeline import jax_inputs
from tests.test_torch_solver import assert_rib_equal, to_port
from tests.torch_jax_state import jax_state_barrier  # noqa: F401

DIRTY_CAP = 64
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

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(torch=torch, types=ptypes, weights=weights,
                                gpu_solver=gpu_solver, topologies=ptopo)
    torch.set_num_threads(prev)


# -- the tests/test_lfa.py topologies ---------------------------------------

def _triangle(w_ab=1, w_ac=2, w_bc=1, drained_c=False):
    return [
        adj_db("a", [adj("a", "b", w_ab), adj("a", "c", w_ac)]),
        adj_db("b", [adj("b", "a", w_ab), adj("b", "c", w_bc)]),
        adj_db("c", [adj("c", "a", w_ac), adj("c", "b", w_bc)],
               is_overloaded=drained_c),
    ]


def _skew_rsw(adj_dbs):
    """tests/test_lfa.py's weighted fat tree: one uplink of every rsw at
    metric 10, so the others are primaries and it a loop-free backup."""
    out = []
    for db in adj_dbs:
        if db.this_node_name.startswith("rsw"):
            db = dataclasses.replace(db, adjacencies=tuple(
                dataclasses.replace(a, metric=10) if i == 0 else a
                for i, a in enumerate(db.adjacencies)
            ))
        out.append(db)
    return out


def _weighted(adj_dbs, seed):
    """Symmetric random metrics 1..9 on every link, from ``seed``."""
    rng = np.random.default_rng(seed)
    metric = {}
    out = []
    for db in adj_dbs:
        adjs = []
        for a in db.adjacencies:
            key = tuple(sorted((db.this_node_name, a.other_node_name)))
            metric.setdefault(key, int(rng.integers(1, 10)))
            adjs.append(dataclasses.replace(a, metric=metric[key]))
        out.append(dataclasses.replace(db, adjacencies=tuple(adjs)))
    return out


def _case(name):
    """-> (adj_dbs, prefix_dbs, vantages) as JAX-package values."""
    if name == "triangle":
        return (_triangle(), [prefix_db("b", "fd00::b/128"),
                              prefix_db("c", "fd00::c/128")], ["a"])
    if name == "overloaded_neighbor":
        return (_triangle(1, 1, 1, drained_c=True),
                [prefix_db("b", "fd00::b/128"),
                 prefix_db("c", "fd00::c/128")], ["a"])
    if name == "grid":
        adj_dbs, pdbs = topologies.grid(4)
        return adj_dbs, pdbs, ["node-0-0", "node-1-2", "node-3-3"]
    if name == "fat_tree":
        adj_dbs, pdbs = topologies.fat_tree()
        return adj_dbs, pdbs, ["rsw-0-0", "ssw-0-0"]
    if name == "weighted_fat_tree":
        adj_dbs, pdbs = topologies.fat_tree()
        return _skew_rsw(adj_dbs), pdbs, ["rsw-0-0"]
    if name == "random_mesh":
        adj_dbs, pdbs = topologies.random_mesh(25, seed=11)
        return _weighted(adj_dbs, 11), pdbs, ["node-0", "node-7"]
    if name == "drained_and_anycast":
        adj_dbs, _ = topologies.grid(4)
        adj_dbs = [dataclasses.replace(db, is_overloaded=True)
                   if db.this_node_name == "node-1-1" else db
                   for db in adj_dbs]
        pdbs = [
            prefix_db("node-0-3", "fd00::100/128",
                      metrics=PrefixMetrics(path_preference=1000)),
            prefix_db("node-3-0", "fd00::100/128",
                      metrics=PrefixMetrics(path_preference=1000)),
            prefix_db("node-3-3", "fd00::200/128"),
        ]
        return adj_dbs, pdbs, ["node-0-0", "node-2-2"]
    raise KeyError(name)


CASES = ["triangle", "overloaded_neighbor", "grid", "fat_tree",
         "weighted_fat_tree", "random_mesh", "drained_and_anycast"]


def _shape(st, budget):
    return (st["n_cap"], st["s_cap"], st["r_cap"], st["kr_cap"],
            st["has_res"], st["d_cap"], st["p_cap"], st["a_cap"], budget)


def _assert_outputs(got, want, fields=FIELDS):
    for field, w in zip(fields, want):
        g = getattr(got, field).numpy()
        assert g.dtype == np.int32 and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)


# -- K3 / K4 at lfa=True: byte parity with _plan_pipeline ------------------

@pytest.mark.parametrize("name,kernel,prev_seed,budget", [
    ("triangle", "sync", None, 4096),
    ("overloaded_neighbor", "sync", 3, 4096),
    ("grid", "bucketed", 1, 4096),
    ("fat_tree", "sync", None, 4096),
    ("weighted_fat_tree", "sync", 2, 4096),
    # a budget below the changed-row count: overflow + pad slots
    ("random_mesh", "sync", 4, 4),
    ("random_mesh", "bucketed", None, 4096),
    ("drained_and_anycast", "bucketed", 5, 4096),
])
def test_lfa_pipeline_bytes_match_jax(port, name, kernel, prev_seed,
                                      budget):
    """delta_buf, full_buf (the LFA columns after the next-hop words in
    both, the LFA diff in the changed rows) and the resident metric,
    s3w, nhw, lfa_slot and lfa_metric equal ``_plan_pipeline`` at
    lfa=True; previous LFA columns drawn at random exercise the diff."""
    adj_dbs, pdbs, vantages = _case(name)
    states, ps = topologies.build_states(adj_dbs, pdbs)
    args, st = jax_inputs(states, ps, vantages[0], prev_seed=prev_seed)
    if prev_seed is not None:
        rng = np.random.default_rng(prev_seed + 100)
        args[12] = rng.integers(-1, 3, st["p_cap"]).astype(np.int32)
        args[13] = rng.integers(0, 4, st["p_cap"]).astype(np.int32)
    dexp = st["delta_exp"] if kernel == "bucketed" else 0
    if kernel == "bucketed":
        assert dexp > 0, "the case must engage the bucketed kernel"
    run = _plan_pipeline.__wrapped__(
        *_shape(st, budget), True, False, True, False, kernel, dexp)
    want = [np.asarray(a) for a in run(*args)]
    got = port.gpu_solver.pipeline(
        **port.weights.from_jax_state(args, device="cpu"),
        has_res=st["has_res"], sentinels=True, kernel=kernel,
        delta_exp=dexp, budget=budget, lfa=True,
    )
    _assert_outputs(got, want)
    if name in ("triangle", "weighted_fat_tree", "random_mesh"):
        assert (want[5] >= 0).any(), "the case must have an alternate"


# -- the incremental pipeline at lfa=True, through churn --------------------

@pytest.mark.parametrize("kernel", ["sync", "bucketed"])
def test_lfa_incremental_pipeline_bytes_match_jax_through_churn(port,
                                                                kernel):
    """Six metric changes from seed 3 on a weighted random mesh, each
    through the changelog path (host plan in place, drained dirty
    tuples): ``_incr_pipeline(lfa=True)`` and the port's incremental
    pipeline agree byte for byte on both buffers, the resident outputs
    and the distance plane, step after step (one step with cone limit 0
    falls back on the device)."""
    adj_dbs, pdbs = topologies.random_mesh(24, seed=5)
    adj_dbs = _weighted(adj_dbs, 5)
    states, ps = topologies.build_states(adj_dbs, pdbs)
    ls, me = states["0"], "node-0"
    plan = build_plan(ls)
    prefixes = [p for p, e in ps.prefixes().items()
                if _fast_path_eligible(e)]
    matrix = build_prefix_matrix(ps, plan.node_index, "0", prefixes)
    _, mbuf = _pack_matrix(matrix, plan.node_overloaded)
    p_cap, a_cap = matrix.ann_node.shape
    r_cap, kr_cap = plan.res_nbr.shape
    has_res = plan.k_res > 0
    dexp = plan.delta_exp if kernel == "bucketed" else 0
    root = np.int32(plan.node_index[me])

    def lane():
        root_nbr, root_w, _ = plan.out_links(ls, me)
        return [plan.deltas.copy(), plan.shift_w.copy(),
                plan.res_rows.copy(), plan.res_nbr.copy(),
                plan.res_w.copy(), mbuf, root, root_nbr, root_w]

    d_cap = lane()[7].shape[0]
    shape = (plan.n_cap, plan.s_cap, r_cap, kr_cap, has_res, d_cap, p_cap,
             a_cap, 4096)
    zeros = [np.zeros(p_cap, np.int32), np.zeros((p_cap, 1), np.int32),
             np.zeros((p_cap, 1), np.int32), np.zeros(p_cap, np.int32),
             np.zeros(p_cap, np.int32)]
    cold = _plan_pipeline.__wrapped__(*shape, True, False, True, True,
                                      kernel, dexp)
    out = [np.asarray(a) for a in cold(*lane(), *zeros)]
    prev, prev_dist = out[2:7], out[7]
    incr = _incr_pipeline.__wrapped__(*shape, DIRTY_CAP, True, False, True,
                                      kernel, dexp)
    dbs = {db.this_node_name: db for db in adj_dbs}
    edges = sorted({tuple(sorted((n, a.other_node_name)))
                    for n, db in dbs.items() for a in db.adjacencies})
    rng = np.random.default_rng(3)
    changed_lfa = 0
    for step in range(6):
        u, v = edges[rng.integers(len(edges))]
        m = int(rng.integers(1, 20))
        for x, y in ((u, v), (v, u)):
            db = dbs[x] = AdjacencyDatabase(
                this_node_name=x, area="0", adjacencies=tuple(
                    Adjacency(**{**a.__dict__, "metric": m})
                    if a.other_node_name == y else a
                    for a in dbs[x].adjacencies),
            )
            ls.update_adjacency_database(db)
        assert sync_plan(ls, plan) is plan, "metric churn applies in place"
        (s_idx, _, s_old), (r_idx, _, r_old), nbr_changed = drain_dirty(plan)
        assert not nbr_changed
        sd = _pad([] if s_idx is None else zip(s_idx.tolist(),
                                               s_old.tolist()),
                  plan.s_cap * plan.n_cap)
        rd = _pad([] if r_idx is None else zip(r_idx.tolist(),
                                               r_old.tolist()),
                  r_cap * kr_cap)
        limit = 0 if step == 4 else 1 << 20
        args = lane() + list(prev) + [prev_dist, *sd, *rd, np.int32(limit)]
        want = [np.asarray(a) for a in incr(*args)]
        got = port.gpu_solver.pipeline(
            **port.weights.from_jax_state(args, device="cpu"),
            has_res=has_res, sentinels=True, kernel=kernel, delta_exp=dexp,
            lfa=True,
        )
        _assert_outputs(got, want[:7])
        _assert_outputs(got, want[7:], ("dist",))
        assert int(want[1][-2]) == (limit == 0), f"step {step}: fell_back"
        changed_lfa += int((want[5] != prev[3]).sum())
        prev, prev_dist = want[2:7], want[7]
    assert changed_lfa > 0, "the churn must move some LFA columns"


def _pad(entries, pad_idx):
    idx = np.full(DIRTY_CAP, pad_idx, np.int32)
    old = np.zeros(DIRTY_CAP, np.int32)
    for j, (f, o) in enumerate(entries):
        idx[j], old[j] = f, o
    return idx, old


# -- the solver: RIB equal to the oracle with LFA ---------------------------

def _both_states(port, adj_dbs, pdbs):
    want = topologies.build_states(adj_dbs, pdbs)
    got = port.topologies.build_states(
        to_port(adj_dbs, port.types), to_port(pdbs, port.types)
    )
    return want, got


@pytest.mark.parametrize("name", CASES)
def test_lfa_rib_matches_cpu_oracle(port, name):
    """``GpuSpfSolver(device="cpu", enable_lfa=True)`` equals
    ``SpfSolver(enable_lfa=True)`` on every vantage, on the first build
    (full pull) and the second (delta pull)."""
    adj_dbs, pdbs, vantages = _case(name)
    (states, ps), (pstates, pps) = _both_states(port, adj_dbs, pdbs)
    with_lfa = 0
    for me in vantages:
        want = SpfSolver(me, enable_lfa=True).build_route_db(me, states, ps)
        solver = port.gpu_solver.GpuSpfSolver(me, device="cpu",
                                              enable_lfa=True)
        got = solver.build_route_db(me, pstates, pps)
        assert_rib_equal(want, got, f"{name}/{me}")
        assert_rib_equal(want, solver.build_route_db(me, pstates, pps),
                         f"{name}/{me} warm")
        with_lfa += sum(bool(r.lfa_nexthops)
                        for r in want.unicast_routes.values())
    if name in ("triangle", "weighted_fat_tree", "random_mesh"):
        assert with_lfa > 0, "the case must have an alternate"


def test_lfa_rib_matches_cpu_oracle_through_incremental_churn(port):
    """tests/test_lfa.py's random-mesh churn (a node's links down, then
    back at metric 7) and three metric changes, through the port's
    incremental solve with LFA: every build's RIB equals the oracle's
    with LFA, and the metric changes take the warm path."""
    adj_dbs, pdbs = topologies.random_mesh(25, seed=11)
    (states, ps), (pstates, pps) = _both_states(port, adj_dbs, pdbs)
    cpu = SpfSolver("node-0", enable_lfa=True)
    gpu = port.gpu_solver.GpuSpfSolver("node-0", device="cpu",
                                       enable_lfa=True, incremental_spf=True)
    victim = next(d for d in adj_dbs if d.this_node_name == "node-5")
    steps = [
        None,
        AdjacencyDatabase(this_node_name="node-5", adjacencies=(), area="0"),
        AdjacencyDatabase(
            this_node_name="node-5", area="0", adjacencies=tuple(
                dataclasses.replace(a, metric=7) for a in victim.adjacencies),
        ),
    ]
    dbs = {db.this_node_name: db for db in adj_dbs}
    for u, v, m in (("node-1", "node-2", 5), ("node-3", "node-4", 9),
                    ("node-1", "node-2", 2)):
        pair = []
        for x, y in ((u, v), (v, u)):
            dbs[x] = dataclasses.replace(dbs[x], adjacencies=tuple(
                dataclasses.replace(a, metric=m)
                if a.other_node_name == y else a
                for a in dbs[x].adjacencies))
            pair.append(dbs[x])
        steps.append(pair)
    warm = 0
    for i, change in enumerate(steps):
        for db in ([] if change is None else
                   change if isinstance(change, list) else [change]):
            states["0"].update_adjacency_database(db)
            pstates["0"].update_adjacency_database(to_port(db, port.types))
        assert_rib_equal(
            cpu.build_route_db("node-0", states, ps),
            gpu.build_route_db("node-0", pstates, pps), f"step {i}",
        )
        st = gpu.last_device_stats
        warm += bool(st.get("incremental") and not st.get("fell_back"))
    assert warm >= 3, warm
