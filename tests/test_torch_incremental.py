"""The port's incremental churn solve (openr_tpu_torch/ops/incremental.py
and the ``incr`` branch of decision/gpu_solver.pipeline) against the JAX
package's ``ops/incremental.py`` and ``tpu_solver._incr_pipeline``,
input for input, and ``GpuSpfSolver(incremental_spf=True)`` against the
port's own cold solve and the CPU oracle through randomized churn.

The same numpy inputs go through the jitted JAX functions on the CPU
backend and through the port on CPU tensors, which run each kernel's
plain PyTorch version. Everything is int32: every comparison is exact
(tolerance 0) — distance and parent planes, trips, rounds, cone,
fell_back and the pull buffers byte for byte.

Port modules import inside the fixture so that collecting this file in
a worker that never runs it imports no torch.
"""

import dataclasses
import random
import types
import zlib
from functools import partial

import jax
import numpy as np
import pytest

from openr_tpu.decision.tpu_solver import (
    _fast_path_eligible,
    _incr_pipeline,
    _pack_matrix,
    _plan_pipeline,
    _plan_sssp,
)
from openr_tpu.models import topologies
from openr_tpu.ops import incremental as jincr
from openr_tpu.ops import relax as jrelax
from openr_tpu.ops.csr import build_prefix_matrix
from openr_tpu.ops.edgeplan import build_plan, drain_dirty, sync_plan
from openr_tpu.types import Adjacency, AdjacencyDatabase
from tests.torch_jax_state import jax_state_barrier  # noqa: F401

INF_E = 1 << 29
DIRTY_CAP = 64
# the chain case's ring: its cone, below lane 0's first edge, is 78
# forest levels deep (more than four trips of eight steps)
CHAIN_NODES = 80


@pytest.fixture(scope="module")
def port():
    """The port's modules, with torch held to one thread while this
    module's tests run."""
    import torch

    from openr_tpu_torch import types as ptypes
    from openr_tpu_torch import weights
    from openr_tpu_torch.decision import gpu_solver, spf_solver
    from openr_tpu_torch.models import topologies as ptopo
    from openr_tpu_torch.ops import incremental
    from openr_tpu_torch.runtime.counters import counters

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(
        torch=torch, types=ptypes, weights=weights, gpu_solver=gpu_solver,
        spf_solver=spf_solver, topologies=ptopo, incremental=incremental,
        counters=counters,
    )
    torch.set_num_threads(prev)


def _state(name):
    """-> (states, prefix state, vantage) of a JAX-package topology."""
    if name == "grid":
        adj_dbs, pdbs = topologies.grid(5, node_labels=False)
        me = "node-2-2"
    elif name == "fat_tree":
        adj_dbs, pdbs = topologies.fat_tree()
        me = "rsw-0-0"
    elif name == "chain":
        # with the root's links masked, each lane of a ring is one path
        # through every other node: a forest as deep as the ring
        adj_dbs, pdbs = topologies.ring(CHAIN_NODES, node_labels=False)
        me = "node-0"
    else:
        adj_dbs, pdbs = topologies.random_mesh(24, seed=5)
        me = "node-0"
    states, ps = topologies.build_states(adj_dbs, pdbs)
    return adj_dbs, states, ps, me


def _pad(entries, pad_idx):
    """[(flat, old)] -> (idx, old) int32 [DIRTY_CAP], pads out of range
    (with junk old values, which must drop)."""
    idx = np.full(DIRTY_CAP, pad_idx, np.int32)
    old = np.full(DIRTY_CAP, 12345, np.int32)
    for j, (f, o) in enumerate(entries):
        idx[j], old[j] = f, o
    return idx, old


def _sssp_case(name):
    """Old and new weight planes over a real plan, the previous plane
    solved under the old ones, and dirty tuples holding: an increase on
    a parent-tree edge of lane 0 (one in the shift classes and one in
    the residual, where the plan has them), a decrease (an edge whose
    OLD weight was raised before the previous solve), an edge out of
    the root; pads fill the rest. On the chain the increase is lane 0's
    first forest edge, so its cone is the whole lane below it."""
    _, states, _, me = _state(name)
    ls = states["0"]
    plan = build_plan(ls)
    n_cap, s_cap = plan.n_cap, plan.s_cap
    r_cap, kr_cap = plan.res_nbr.shape
    has_res = plan.k_res > 0
    root = plan.node_index[me]
    root_nbr, root_w, _ = plan.out_links(ls, me)
    d_cap = root_nbr.shape[0]
    deltas = plan.deltas
    new = {"s": plan.shift_w.copy(), "r": plan.res_w.copy()}
    old = {k: v.copy() for k, v in new.items()}
    # every finite edge as (plane, flat slot, source, head)
    edges = [("s", k * n_cap + u, u, (u + int(deltas[k])) % n_cap)
             for k in range(s_cap) for u in range(n_cap)
             if new["s"][k, u] < INF_E]
    if has_res:
        edges += [("r", r * kr_cap + c, int(plan.res_nbr[r, c]),
                   int(plan.res_rows[r]))
                  for r in range(r_cap) for c in range(kr_cap)
                  if plan.res_rows[r] >= 0 and plan.res_nbr[r, c] >= 0
                  and new["r"][r, c] < INF_E]
    away = [e for e in edges if e[2] != root]
    # the decrease: old weight raised, new weight the plan's own
    # (the chain's middle edge is lane 0's first forest edge, which
    # takes the increase: its decrease is the next one)
    dec = away[len(away) // 2 + (name == "chain")]
    old[dec[0]].reshape(-1)[dec[1]] += 3
    sssp = jax.jit(partial(
        _plan_sssp, s_cap=s_cap, has_res=has_res, n_cap=n_cap, d_cap=d_cap,
        max_trips=jrelax.max_trips(n_cap), kernel="sync",
    ))
    prev, _, _ = sssp(deltas, old["s"], plan.res_rows, plan.res_nbr,
                      old["r"], root, root_nbr, root_w)
    prev = np.asarray(prev)

    def tight(e):
        w = old[e[0]].reshape(-1)[e[1]]
        return prev[0, e[2]] < INF_E and prev[0, e[2]] + w == prev[0, e[3]]

    if name == "chain":
        first = int(root_nbr[0])
        picks = [next(e for e in away if e[2] == first and e[3] != root
                      and e != dec and tight(e))]
    else:
        picks = [e for plane in ("s", "r")
                 for e in [next((e for e in away if e[0] == plane
                                 and e != dec and tight(e)), None)]
                 if e is not None]
    changes = [(e, 7) for e in picks]
    changes.append((next(e for e in edges if e[2] == root), 5))
    for e, bump in changes:
        new[e[0]].reshape(-1)[e[1]] += bump
    dirty = {"s": [], "r": []}
    for e in [dec] + [e for e, _ in changes]:
        dirty[e[0]].append((e[1], int(old[e[0]].reshape(-1)[e[1]])))
    sd_idx, sd_old = _pad(dirty["s"], s_cap * n_cap)
    rd_idx, rd_old = _pad(dirty["r"], r_cap * kr_cap)
    args = [deltas, new["s"], plan.res_rows, plan.res_nbr, new["r"],
            np.int32(root), root_nbr, root_w, prev, sd_idx, sd_old,
            rd_idx, rd_old]
    static = dict(s_cap=s_cap, has_res=has_res, n_cap=n_cap, d_cap=d_cap,
                  max_trips=jrelax.max_trips(n_cap))
    return args, static, plan.delta_exp, (old["s"], old["r"])


@pytest.mark.parametrize("name,kernel", [
    ("grid", "sync"), ("grid", "bucketed"), ("fat_tree", "sync"),
    ("mesh", "bucketed"), ("chain", "sync"),
])
def test_incremental_sssp_matches_jax(port, name, kernel):
    """old planes, parent plane and the whole incremental SSSP — dist,
    trips, cone, fell_back, rounds — equal the JAX functions', with cone
    budgets that hold (the whole plane, and the cone itself) and ones
    that fall back (0, and one below the cone). The chain's cone is
    deeper than four trips of the reference's loop."""
    torch = port.torch
    inc = port.incremental
    args, st, dexp, (old_shift, old_res) = _sssp_case(name)
    dexp = dexp if kernel == "bucketed" else 0
    if kernel == "bucketed":
        assert dexp > 0, "the case must engage the bucketed kernel"
    (deltas, new_shift, res_rows, res_nbr, new_res, root, root_nbr, root_w,
     prev, sd_idx, sd_old, rd_idx, rd_old) = args
    has_res, n_cap, d_cap = st["has_res"], st["n_cap"], st["d_cap"]
    t = {i: torch.tensor(np.asarray(a)) for i, a in enumerate(args)
         if i != 5}

    # B11: the old planes
    j_old = jax.jit(partial(jincr._old_planes, has_res=has_res))(
        new_shift, new_res, sd_idx, sd_old, rd_idx, rd_old)
    p_old = inc.old_planes(t[1], t[4], t[9], t[10], t[11], t[12], has_res)
    for w, g, ref in zip(j_old, p_old, (old_shift, old_res)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), ref)

    # B12: the parent forest under the root-masked old weights
    swm_old = old_shift.copy()
    swm_old[:, int(root)] = INF_E
    rwm_old = np.where(res_nbr == int(root), INF_E, old_res).astype(np.int32)
    j_par = np.asarray(jax.jit(partial(
        jincr._parent_plane, s_cap=st["s_cap"], has_res=has_res,
        n_cap=n_cap, d_cap=d_cap,
    ))(deltas, swm_old, res_rows, res_nbr, rwm_old, prev))
    p_par = inc.parent_plane(
        t[0], torch.tensor(swm_old), t[2], t[3], torch.tensor(rwm_old),
        t[8], st["s_cap"], has_res, n_cap, d_cap,
    )
    np.testing.assert_array_equal(p_par.numpy(), j_par)
    assert (j_par >= 0).sum() > n_cap // 2, "a real forest"
    _held_parent_planes(port, name, st["s_cap"], n_cap, has_res)

    # B13: the whole solve, held and fallen back
    run = jincr.jit_incremental_sssp(**st, kernel=kernel, delta_exp=dexp)
    cold = None
    want_cone = int(run(*args, np.int32(d_cap * n_cap))[2])
    for limit in (d_cap * n_cap, 0, want_cone, want_cone - 1):
        want = run(*args, np.int32(limit))
        stats = {}
        got = inc.incremental_sssp(
            *[t[i] for i in range(5)], int(root), t[6], t[7], *[
                t[i] for i in range(8, 13)], limit, **st, kernel=kernel,
            delta_exp=dexp, stats=stats,
        )
        dist, trips, cone, fell, rounds = got
        np.testing.assert_array_equal(dist.numpy(), np.asarray(want[0]))
        assert (trips, int(cone), bool(fell), rounds) == (
            int(want[1]), int(want[2]), bool(want[3]), int(want[4])
        ), limit
        assert int(cone) > 0, "the increase must re-anchor a cone"
        assert bool(fell) == (limit < want_cone)
        if name == "chain":
            # the Jacobi spread: a step a level, then one that changes
            # nothing
            assert int(cone) == CHAIN_NODES - 2
            assert int(stats["cone_trips"]) == CHAIN_NODES - 2 > 4 * 8
        if cold is None:
            cold = dist
        np.testing.assert_array_equal(dist.numpy(), cold.numpy())


def _held_parent_planes(port, name, s_cap, n_cap, has_res):
    """``parent_plane`` into a held plane pre-filled with -7, reused for
    the forests of two other roots, at 1 and 3 lanes, with the residual
    (where the plan has one) and without: every call equals the JAX
    ``_parent_plane`` on the same inputs (the held plane written
    whole)."""
    torch, inc = port.torch, port.incremental
    from openr_tpu_torch.ops import relax as prelax

    _, states, _, me = _state(name)
    ls = states["0"]
    plan = build_plan(ls)
    names = sorted(plan.node_index, key=plan.node_index.get)
    others = [n for n in names if n != me and plan.out_links(ls, n)[0].size
              ][:2]
    assert len(others) == 2
    t = {k: torch.tensor(getattr(plan, k)) for k in (
        "deltas", "shift_w", "res_rows", "res_nbr", "res_w")}
    held = {lanes: torch.full((lanes, n_cap), -7, dtype=torch.int32)
            for lanes in (1, 3)}
    for other in others:
        root = plan.node_index[other]
        nbr, w, _ = plan.out_links(ls, other)
        prev, _, _ = prelax.plan_sssp(
            t["deltas"], t["shift_w"], t["res_rows"], t["res_nbr"],
            t["res_w"], root, torch.tensor(nbr), torch.tensor(w), has_res)
        swm = plan.shift_w.copy()
        swm[:, root] = INF_E
        rwm = np.where(plan.res_nbr == root, INF_E, plan.res_w).astype(
            np.int32)
        for lanes, out in held.items():
            pl = prev[torch.arange(lanes) % prev.shape[0]].contiguous()
            for res in sorted({False, has_res}):
                want = np.asarray(jax.jit(partial(
                    jincr._parent_plane, s_cap=s_cap, has_res=res,
                    n_cap=n_cap, d_cap=lanes))(
                        plan.deltas, swm, plan.res_rows, plan.res_nbr, rwm,
                        pl.numpy()))
                got = inc.parent_plane(
                    t["deltas"], torch.tensor(swm), t["res_rows"],
                    t["res_nbr"], torch.tensor(rwm), pl, s_cap, res, n_cap,
                    lanes, out=out)
                assert got is out
                np.testing.assert_array_equal(out.numpy(), want)
                if res == has_res:
                    assert (want >= 0).any(), (other, lanes)


def _grid_churn_inputs(kernel, sentinels):
    """A cold JAX solve of the 5x5 grid, then a metric increase on a
    victim's links through the real changelog path: the new plan
    planes, the cold solve's outputs and distance plane, and the
    drained dirty tuples padded to a bucket."""
    adj_dbs, states, ps, me = _state("grid")
    ls = states["0"]
    plan = build_plan(ls)
    prefixes = [p for p, e in ps.prefixes().items()
                if _fast_path_eligible(e)]
    matrix = build_prefix_matrix(ps, plan.node_index, "0", prefixes)
    _, mbuf = _pack_matrix(matrix, plan.node_overloaded)
    root_nbr, root_w, _ = plan.out_links(ls, me)
    p_cap, a_cap = matrix.ann_node.shape
    d_cap = root_nbr.shape[0]
    r_cap, kr_cap = plan.res_nbr.shape
    dexp = plan.delta_exp if kernel == "bucketed" else 0
    shape = (plan.n_cap, plan.s_cap, r_cap, kr_cap, plan.k_res > 0, d_cap,
             p_cap, a_cap, 4096)
    zeros = [np.zeros(p_cap, np.int32), np.zeros((p_cap, 1), np.int32),
             np.zeros((p_cap, 1), np.int32)]
    lfa0 = [np.zeros(p_cap, np.int32)] * 2
    root = np.int32(plan.node_index[me])

    def lane(p):
        return [p.deltas.copy(), p.shift_w.copy(), p.res_rows.copy(),
                p.res_nbr.copy(), p.res_w.copy(), mbuf, root, root_nbr,
                root_w]

    cold = _plan_pipeline(*shape, False, False, sentinels, True, kernel,
                          dexp)
    out = [np.asarray(a) for a in cold(*lane(plan), *zeros, *lfa0)]
    prev_out, prev_dist = out[2:5], out[7]

    victim = adj_dbs[1]
    by = {d.this_node_name: d for d in adj_dbs}
    for db in [victim] + [by[a.other_node_name] for a in victim.adjacencies]:
        adjs = tuple(
            Adjacency(**{**a.__dict__, "metric": 40})
            if victim.this_node_name in (db.this_node_name,
                                         a.other_node_name) else a
            for a in db.adjacencies
        )
        ls.update_adjacency_database(AdjacencyDatabase(
            this_node_name=db.this_node_name, adjacencies=adjs, area="0",
        ))
    assert sync_plan(ls, plan) is plan, "metric churn applies in place"
    (s_idx, _, s_old), (r_idx, _, r_old), nbr_changed = drain_dirty(plan)
    assert s_idx is not None and not nbr_changed
    sd = _pad(zip(s_idx.tolist(), s_old.tolist()), plan.s_cap * plan.n_cap)
    rd = _pad([] if r_idx is None else zip(r_idx.tolist(), r_old.tolist()),
              r_cap * kr_cap)
    args = lane(plan) + list(prev_out) + lfa0 + [prev_dist, *sd, *rd]
    incr = _incr_pipeline(*shape, DIRTY_CAP, False, False, sentinels, kernel,
                          dexp)
    return args, incr, shape, dexp


@pytest.mark.parametrize("kernel,sentinels", [
    ("sync", True), ("bucketed", False),
])
def test_incremental_pipeline_bytes_match_jax(port, kernel, sentinels):
    """The port's incremental pipeline against ``_incr_pipeline`` called
    directly: delta_buf, full_buf (the [cone, fell_back] tail included,
    after the sentinel pair or without it) and the emitted distance
    plane byte for byte, warm and — with cone_limit 0 — fallen back."""
    args, incr, shape, dexp = _grid_churn_inputs(kernel, sentinels)
    for limit in (1 << 20, 0):
        full = args + [np.int32(limit)]
        want = [np.asarray(a) for a in incr(*full)]
        got = port.gpu_solver.pipeline(
            **port.weights.from_jax_state(full, device="cpu"),
            has_res=shape[4], sentinels=sentinels, kernel=kernel,
            delta_exp=dexp,
        )
        for field, w in (("delta_buf", want[0]), ("full_buf", want[1]),
                         ("dist", want[7])):
            g = getattr(got, field).numpy()
            assert g.dtype == np.int32 and g.shape == w.shape, field
            np.testing.assert_array_equal(g, w, err_msg=field)
        cone, fell = int(want[1][-3]), int(want[1][-2])
        assert cone > 0 and fell == (limit == 0), (cone, fell)


# -- the solver through churn -------------------------------------------------

class _Churn:
    """Symmetric churn over a live port LinkState: metric changes and
    link down/up on both directions of an edge, through the real update
    path (changelog -> host plan -> K5 scatter)."""

    def __init__(self, port, adj_dbs, states):
        self.t = port.types
        self.states = states
        self.dbs = {db.this_node_name: db for db in adj_dbs}

    def _put(self, db):
        self.dbs[db.this_node_name] = db
        self.states["0"].update_adjacency_database(db)

    def _rebuild(self, db, adjs):
        return self.t.AdjacencyDatabase(
            this_node_name=db.this_node_name, adjacencies=tuple(adjs),
            node_label=db.node_label, area="0",
        )

    def set_metric(self, u, v, metric):
        for a_name, b_name in ((u, v), (v, u)):
            db = self.dbs[a_name]
            self._put(self._rebuild(db, [
                dataclasses.replace(a, metric=metric)
                if a.other_node_name == b_name else a
                for a in db.adjacencies
            ]))

    def link_down(self, u, v):
        for a_name, b_name in ((u, v), (v, u)):
            db = self.dbs[a_name]
            self._put(self._rebuild(db, [
                a for a in db.adjacencies if a.other_node_name != b_name
            ]))

    def edges(self):
        return [(name, a.other_node_name)
                for name, db in sorted(self.dbs.items())
                for a in db.adjacencies if name < a.other_node_name]


ME = "node-2-2"


def _trio(port, **incr_kw):
    """-> (solve, counter reader): the port's incremental solver, its
    cold solver and its CPU oracle on the port's 5x5 grid; ``solve``
    asserts all three RIBs equal and returns the incremental solver's
    last_device_stats."""
    adj_dbs, pdbs = port.topologies.grid(5, node_labels=False)
    states, ps = port.topologies.build_states(adj_dbs, pdbs)
    churn = _Churn(port, adj_dbs, states)
    churn.ps = ps
    gs = port.gpu_solver
    incr = gs.GpuSpfSolver(ME, device="cpu", incremental_spf=True, **incr_kw)
    cold = gs.GpuSpfSolver(ME, device="cpu")
    cpu = port.spf_solver.SpfSolver(ME)

    def rib(db):
        return dict(db.unicast_routes.items()), db.mpls_routes

    def solve(ctx, vantage=ME):
        want = rib(cpu.build_route_db(vantage, states, ps))
        got = rib(incr.build_route_db(vantage, states, ps))
        assert got == want, f"{ctx}: incremental vs oracle"
        assert rib(cold.build_route_db(vantage, states, ps)) == want, ctx
        return incr.last_device_stats

    return churn, solve, incr


def _cnt(port, key):
    return int(port.counters.get_counter(key) or 0)


def _held_init_apart(incr, seen: dict) -> None:
    """The vantage's held K1s outputs (``_VantageState.init``) and its
    held K6 parent plane (``_VantageState.par``) share no storage with
    its ``prev_dist`` (the last solve's returned plane), and stay the
    same tensors from one solve to the next while the vantage's shapes
    do. ``seen`` maps a shape key to the storages first held."""
    (vs,) = incr._vstates.values()
    if vs.init is None:
        assert vs.par is None
        return
    sw, res, dist0 = vs.init
    held = {t.untyped_storage().data_ptr()
            for t in (sw, *res, dist0, vs.par)}
    assert len(held) == 6
    assert vs.par.shape == vs.prev_dist.shape
    assert vs.prev_dist.untyped_storage().data_ptr() not in held
    assert seen.setdefault(vs.shape_key, held) == held


def test_randomized_churn_incremental_equals_cold_and_oracle(port):
    """Randomized metric increase / decrease and link down / up, 10
    rounds from seed 7: on every round the incremental RIB equals the
    port's cold RIB and its CPU oracle's, and the warm path runs on at
    least 5 rounds, each through the K1s outputs the vantage holds,
    which never alias its ``prev_dist`` (``_held_init_apart``)."""
    churn, solve, incr = _trio(port)
    assert not solve("round0").get("incremental")
    assert next(iter(incr._vstates.values())).init is None
    seen = {}
    rng = np.random.default_rng(7)
    metrics = (1, 3, 50, 100000)
    edges = churn.edges()
    warm = 0
    down = None  # at most one link down at a time
    for i in range(10):
        if down is not None and rng.integers(3) == 0:
            u, v, su, sv = down
            churn._put(su)
            churn._put(sv)
            ctx = f"round{i + 1}: up {u}<->{v}"
            down = None
        elif down is None and rng.integers(4) == 0:
            while True:
                u, v = edges[rng.integers(len(edges))]
                if ME not in (u, v):
                    break
            down = (u, v, churn.dbs[u], churn.dbs[v])
            churn.link_down(u, v)
            ctx = f"round{i + 1}: down {u}<->{v}"
        else:
            u, v = edges[rng.integers(len(edges))]
            m = int(metrics[rng.integers(len(metrics))])
            churn.set_metric(u, v, m)
            ctx = f"round{i + 1}: metric {u}<->{v}={m}"
        st = solve(ctx)
        _held_init_apart(incr, seen)
        if st.get("incremental") and not st.get("fell_back"):
            warm += 1
    assert warm >= 5, warm
    assert seen


def test_mixed_churn_soak_equals_oracle(port):
    """tests/test_tpu_solver.py's 30-step mixed soak in the port's types:
    random flaps, metric changes, drains and UCMP / ECMP prefix adds and
    withdrawals on ``random_mesh(28, seed=5)`` with UCMP and LFA on, the
    device path forced (``small_graph_nodes=0``) and incremental; after
    every step the RIB equals the port's own oracle. The warm path must
    carry most steps, some with a cone to re-anchor."""
    t = port.types
    rng = random.Random(20260730)
    adj_dbs, prefix_dbs = port.topologies.random_mesh(28, seed=5)
    states, ps = port.topologies.build_states(adj_dbs, prefix_dbs)
    ls = states["0"]
    names = [db.this_node_name for db in adj_dbs]
    by_name = {db.this_node_name: db for db in adj_dbs}
    me = "node-0"
    cpu = port.spf_solver.SpfSolver(me, enable_ucmp=True, enable_lfa=True)
    dev = port.gpu_solver.GpuSpfSolver(
        me, device="cpu", enable_ucmp=True, enable_lfa=True,
        incremental_spf=True, small_graph_nodes=0)
    algos = (t.PrefixForwardingAlgorithm.SP_ECMP,
             t.PrefixForwardingAlgorithm.SP_UCMP_PREFIX_WEIGHT_PROPAGATION,
             t.PrefixForwardingAlgorithm.SP_UCMP_ADJ_WEIGHT_PROPAGATION)

    def prefix_db(node, prefix, delete=False, **entry_kw):
        return t.PrefixDatabase(
            this_node_name=node,
            prefix_entries=(t.PrefixEntry(prefix=prefix, **entry_kw),),
            area="0", delete_prefix=delete)

    def mutate(step):
        kind = rng.randrange(5)
        victim = rng.choice(names[1:])  # never isolate the vantage
        db = by_name[victim]
        if kind == 0:  # flap down
            ls.update_adjacency_database(t.AdjacencyDatabase(
                this_node_name=victim, adjacencies=(), area="0"))
        elif kind == 1:  # restore / metric churn (crc32: no hash seed)
            ls.update_adjacency_database(t.AdjacencyDatabase(
                this_node_name=victim, adjacencies=tuple(
                    dataclasses.replace(a, metric=1 + (step + zlib.crc32(
                        a.other_node_name.encode())) % 9)
                    for a in db.adjacencies), area="0"))
        elif kind == 2:  # drain toggle
            ls.update_adjacency_database(t.AdjacencyDatabase(
                this_node_name=victim, adjacencies=db.adjacencies,
                is_overloaded=(step % 2 == 0), area="0"))
        elif kind == 3:  # anycast UCMP / ECMP prefix add
            algo = rng.choice(algos)
            for node in rng.sample(names[1:], 3):
                ps.update_prefix_database(prefix_db(
                    node, f"fd00:5{step % 8}::/64", forwarding_algorithm=algo,
                    weight=rng.randrange(1, 9)))
        else:  # withdraw
            node = rng.choice(names[1:])
            ps.update_prefix_database(prefix_db(
                node, f"fd00:5{step % 8}::/64", delete=True))

    warm = coned = 0
    for step in range(30):
        mutate(step)
        want = cpu.build_route_db(me, states, ps)
        got = dev.build_route_db(me, states, ps)
        if want is None:
            assert got is None, f"soak step {step}"
            continue
        assert dict(got.unicast_routes.items()) == dict(
            want.unicast_routes.items()), f"soak step {step}"
        assert got.mpls_routes == want.mpls_routes, f"soak step {step}"
        st = dev.last_device_stats
        if st.get("incremental") and not st.get("fell_back"):
            warm += 1
            coned += st["cone"] > 0
    assert warm >= 15 and coned >= 5, (warm, coned)


def test_cone_fraction_zero_falls_back_on_device(port):
    churn, solve, _ = _trio(port, incremental_cone_frac=0.0)
    solve("cold")
    s0 = _cnt(port, "decision.solver.incr.solves")
    f0 = _cnt(port, "decision.solver.incr.full_fallbacks")
    churn.set_metric("node-0-1", "node-0-2", 60)
    churn.set_metric("node-1-2", "node-2-2", 60)  # ME's own parent edge
    st = solve("frac0-increase")
    assert st.get("incremental") is True, st
    assert st["cone"] > 0 and st["fell_back"] is True, st
    assert _cnt(port, "decision.solver.incr.full_fallbacks") == f0 + 1
    assert _cnt(port, "decision.solver.incr.solves") == s0


def test_host_gates_dispatch_the_cold_solve(port, monkeypatch):
    """Zero-weight edges, an oversized dirty set and a journal gap each
    dispatch the cold solve (counted as a full fallback), with the RIB
    still equal; the warm path re-engages once the gate clears."""
    gs = port.gpu_solver
    churn, solve, incr = _trio(port)
    solve("cold")

    def gated(ctx):
        f0 = _cnt(port, "decision.solver.incr.full_fallbacks")
        s0 = _cnt(port, "decision.solver.incr.solves")
        st = solve(ctx)
        assert not st.get("incremental"), (ctx, st)
        assert _cnt(port, "decision.solver.incr.full_fallbacks") == f0 + 1
        assert _cnt(port, "decision.solver.incr.solves") == s0

    # an oversized dirty set
    monkeypatch.setattr(gs, "_DIRTY_BUCKETS", (1,))
    churn.set_metric("node-0-1", "node-1-1", 7)
    gated("dirty overflow")
    monkeypatch.setattr(gs, "_DIRTY_BUCKETS", (64, 256, 1024, 4096))
    churn.set_metric("node-0-1", "node-1-1", 9)
    assert solve("re-engage").get("incremental") is True

    # a journal gap: 17 builds of another vantage of the same area each
    # drain one epoch; the journal keeps 16
    for _ in range(17):
        incr.build_route_db("node-0-0", churn.states, churn.ps)
    churn.set_metric("node-0-1", "node-1-1", 4)
    gated("journal gap")
    churn.set_metric("node-0-1", "node-1-1", 5)
    assert solve("after gap").get("incremental") is True

    # a zero-weight edge: sticky on the plan
    churn.set_metric("node-0-0", "node-0-1", 0)
    gated("zero weight")
    churn.set_metric("node-0-0", "node-0-1", 5)
    gated("after zero weight")


def test_layout_changes_reset_the_journal_and_reconcile(port):
    """A new link that lands in a fresh residual slot (the residual
    layout changes) and a new node (a same-capacity plan rebuild,
    reconciled by the diff scatter) each journal a reset marker: that
    build is cold, the next is warm again. After every build the
    resident planes equal the host plan's."""
    torch = port.torch
    churn, solve, incr = _trio(port)
    solve("cold")

    def resident_matches_plan():
        ad = incr._area_dev["0"]
        for f in ("deltas", "shift_w", "res_rows", "res_nbr", "res_w"):
            assert torch.equal(getattr(ad, f),
                               torch.tensor(getattr(ad.plan, f))), f

    def add_link(u, v, tag):
        base = churn.dbs[u].adjacencies[0]
        for a, b, ia, ib in ((u, v, "a", "b"), (v, u, "b", "a")):
            db = churn.dbs[a]
            churn._put(churn._rebuild(db, db.adjacencies + (
                dataclasses.replace(base, other_node_name=b,
                                    if_name=f"{tag}{ia}",
                                    other_if_name=f"{tag}{ib}"),
            )))

    def add_node(name, to):
        churn.dbs[name] = port.types.AdjacencyDatabase(
            this_node_name=name, adjacencies=(), node_label=0, area="0",
        )
        add_link(to, name, "y")

    for ctx, change in (
        ("fresh residual slot",
         lambda: add_link("node-0-0", "node-4-4", "x")),
        ("new node", lambda: add_node("node-9", "node-0-1")),
    ):
        change()
        st = solve(ctx)
        assert not st.get("incremental"), (ctx, st)
        assert incr._area_dev["0"].drain_log[-1][1] is None, ctx
        resident_matches_plan()
        churn.set_metric("node-1-1", "node-1-2", 30)
        assert solve(f"after {ctx}").get("incremental") is True, ctx
        resident_matches_plan()


def test_scatter_set_plain_drops_pads_and_rejects_duplicates(port):
    """K5 drops pads (negative, at and past the plane's end) and rejects
    a duplicate; its two-segment form (a sync's shift and residual
    entries, staged as views of one buffer) equals ``_scatter_jit`` on
    each plane, with pads, indices past the plane and an empty
    segment."""
    from openr_tpu.decision.tpu_solver import _scatter_jit

    torch = port.torch
    inc = port.incremental
    plane = torch.arange(12, dtype=torch.int32).view(3, 4)
    idx = torch.tensor([5, -1, 12, 0, 99], dtype=torch.int32)
    vals = torch.tensor([50, 60, 70, 80, 90], dtype=torch.int32)
    inc.scatter_set(plane, idx, vals)
    want = torch.arange(12, dtype=torch.int32)
    want[5], want[0] = 50, 80
    assert torch.equal(plane.view(-1), want)
    with pytest.raises(ValueError, match="unique"):
        inc.scatter_set(plane, torch.tensor([3, 7, 3], dtype=torch.int32),
                        torch.tensor([1, 2, 3], dtype=torch.int32))

    scatter = _scatter_jit.__wrapped__(False)
    rng = np.random.default_rng(21)
    a0 = rng.integers(0, 1 << 20, (4, 32), dtype=np.int32)
    b0 = rng.integers(0, 1 << 20, (6, 8), dtype=np.int32)
    segs = {
        # live slots, a pad at the end, indices past the plane
        "both": ([3, 40, 127, 128, 500], [0, 47, 48, 1000]),
        "a only": ([7, 128, 64], []),
        "b only": ([], [5, 48, 9, 77]),
    }
    for label, (ia, ib) in segs.items():
        ia, ib = np.asarray(ia, np.int32), np.asarray(ib, np.int32)
        va = rng.integers(1, 99, ia.size, dtype=np.int32)
        vb = rng.integers(1, 99, ib.size, dtype=np.int32)
        buf = torch.tensor(np.concatenate([ia, va, ib, vb]))
        views = torch.split(buf, [ia.size, va.size, ib.size, vb.size])
        a, b = torch.tensor(a0), torch.tensor(b0)
        inc.scatter_set(a, views[0], views[1], b, views[2], views[3])
        for got, p0, ix, vx in ((a, a0, ia, va), (b, b0, ib, vb)):
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(scatter(p0, ix, vx)), label)
        assert torch.equal(a, torch.tensor(a0)) == (ia.size == 0)


def _old_planes_case(name, dirty):
    """A plan's new resident planes and dirty tuples over them: ``mixed``
    holds a slot in the root's shift column, a residual slot (one whose
    source is the root where the plan has one) and high pads with junk
    old values; ``pads`` holds pads only; ``empty`` no entry at all."""
    _, states, _, me = _state(name)
    plan = build_plan(states["0"])
    root = plan.node_index[me]
    n_cap, s_cap = plan.n_cap, plan.s_cap
    r_cap, kr_cap = plan.res_nbr.shape
    s_lim, r_lim = s_cap * n_cap, r_cap * kr_cap
    rng = np.random.default_rng(16)
    s_idx, r_idx = [], []
    if dirty == "mixed":
        s_idx = [n_cap + root] + [
            int(f) for f in rng.choice(s_lim, 6, replace=False)
            if f != n_cap + root][:5]
        from_root = np.flatnonzero(plan.res_nbr.ravel() == root)
        r_idx = sorted({*from_root[:1].tolist(),
                        *rng.choice(r_lim, 3, replace=False).tolist()})
    if dirty != "empty":
        s_idx += [s_lim, s_lim + 5]
        r_idx += [r_lim, r_lim + 3]

    def tup(idx):
        idx = np.asarray(idx, np.int32)
        return idx, rng.integers(1, 60, idx.size, dtype=np.int32)

    return plan, root, tup(s_idx), tup(r_idx)


@pytest.mark.parametrize("name,dirty", [
    ("grid", "mixed"), ("mesh", "mixed"), ("fat_tree", "pads"),
    ("mesh", "empty"),
])
def test_old_planes_root_masked_match_jax(port, name, dirty):
    """The old planes, one ``old_plane`` a plane: unmasked equal to the
    JAX ``_old_planes``, and with the root mask equal to ``_old_planes``
    followed by ``incremental_sssp``'s mask (the root's shift column and
    the residual slots out of the root at INF_E), the root winning over
    a dirty value; pads drop."""
    torch, inc = port.torch, port.incremental
    plan, root, (sdi, sdo), (rdi, rdo) = _old_planes_case(name, dirty)
    has_res = plan.k_res > 0
    assert has_res == (name != "grid")
    j_shift, j_res = (np.asarray(a) for a in jax.jit(partial(
        jincr._old_planes, has_res=has_res))(
            plan.shift_w, plan.res_w, sdi, sdo, rdi, rdo))
    want = (j_shift.copy(), j_res)
    want[0][:, root] = INF_E
    if has_res:
        want = (want[0], np.where(plan.res_nbr == root, INF_E, j_res))
    t = [torch.tensor(a) for a in (plan.shift_w, plan.res_w, sdi, sdo, rdi,
                                   rdo)]
    got = inc.old_planes(*t, has_res, root, torch.tensor(plan.res_nbr))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    for g, w in zip(inc.old_planes(*t, has_res), (j_shift, j_res)):
        np.testing.assert_array_equal(g.numpy(), w)
    if dirty == "mixed":
        assert (sdi // plan.n_cap == 1).any() and (
            sdi % plan.n_cap == root).any(), "a dirty slot in the root column"
        assert (want[0][:, root] == INF_E).all()
    if dirty != "mixed":
        np.testing.assert_array_equal(want[0][:, root], INF_E)
        np.testing.assert_array_equal(
            np.delete(want[0], root, axis=1),
            np.delete(plan.shift_w, root, axis=1))


def test_cone_seed_plain_matches_jax_seed_plane(port):
    """K7's plain version (each dirty entry's head, source and increase
    computed once, shared by the lanes; the whole plane written) equals
    the JAX seed plane: ``incremental_sssp`` with no spread trip and no
    relaxation trip returns the warm seed built from it (the plane with
    the seeds at INF_E, the root pins min-ed in) and its sum as the
    cone. The grid seeds in the shift classes (the residual's seeds are
    held to JAX through the cone of ``test_incremental_sssp_matches_jax``
    on the mesh and the fat tree)."""
    torch, inc = port.torch, port.incremental
    from openr_tpu_torch.ops import relax as prelax

    args, st, _, _ = _sssp_case("grid")
    (deltas, new_shift, res_rows, res_nbr, new_res, root, root_nbr, root_w,
     prev, sd_idx, sd_old, rd_idx, rd_old) = args
    limit = st["d_cap"] * st["n_cap"]
    warm, trips, cone, fell, rounds = jincr.jit_incremental_sssp(
        **dict(st, max_trips=0), kernel="sync")(*args, np.int32(limit))
    assert (int(trips), bool(fell), int(rounds)) == (0, False, 0)
    t = {i: torch.tensor(np.asarray(a)) for i, a in enumerate(args)
         if i != 5}
    root = int(root)
    swm_new, residual, dist0 = prelax.sssp_init(
        t[1], t[2], t[3], t[4], root, t[6], t[7])
    swm_old, rwm_old = inc.old_planes(t[1], t[4], t[9], t[10], t[11],
                                      t[12], False, root, t[3])
    par = inc.parent_plane(t[0], swm_old, t[2], t[3], rwm_old, t[8],
                           st["s_cap"], False, st["n_cap"], st["d_cap"])
    aff = inc.cone_seed(par, swm_new, residual[2], t[0], t[2], t[3], root,
                        t[9], t[10], t[11], t[12], False)
    assert aff.dtype == torch.int32 and set(aff.unique().tolist()) == {0, 1}
    assert int(aff.sum()) == int(cone)
    _, _, increased = inc.cone_seed_heads(
        st["n_cap"], swm_new, residual[2], t[0], t[2], t[3], root, t[9],
        t[10], t[11], t[12], False)
    # the tree edge's increase; the root edge's is masked on both sides
    assert int(increased.sum()) == 1 and int(cone) > 0
    warm = np.asarray(warm)
    np.testing.assert_array_equal(
        aff.numpy(), ((warm == INF_E) & (prev < INF_E)).astype(np.int32))
    plane, _ = inc.cone_finish(aff, t[8], dist0, t[6], t[7], limit)
    np.testing.assert_array_equal(plane.numpy(), warm)
