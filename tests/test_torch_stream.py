"""The port's streaming churn epochs (the ``stream`` branch of
openr_tpu_torch/decision/gpu_solver.pipeline, K4 ``[stream]`` in
ops/compact.py, ``GpuSpfSolver(streaming_pipeline=True)``) against the
JAX package's ``tpu_solver._stream_pipeline`` and ``ops/stream.py``,
input for input, and the streaming solver against the port's cold solve
and the CPU oracle.

The JAX pipeline is a fresh jit of the raw function
(``_stream_pipeline.__wrapped__(..., donate=False)``); no
``TpuSpfSolver`` is built here. The port runs on CPU tensors, which run
each kernel's plain PyTorch version. Everything is int32: every
comparison is exact (tolerance 0) — the bucketed payload with its ok
column, the full buffer, the published planes and the distance plane
byte for byte.

The solver cases mirror tests/test_stream_pipeline.py's first four
(randomized churn parity, the device diff against the host diff with
withdrawals, the epoch sequence the make-before-break drill programs —
compared here as update batches, Fib is not ported — and the idle
epoch's byte count), then the budget adaptation and an abandoned
collect.
"""

import dataclasses
import types

import numpy as np
import pytest

from openr_tpu.decision.tpu_solver import (
    _fast_path_eligible,
    _pack_matrix,
    _stream_pipeline,
)
from openr_tpu.models import topologies
from openr_tpu.ops import stream as jstream
from openr_tpu.ops.csr import build_prefix_matrix
from openr_tpu.ops.edgeplan import build_plan, drain_dirty, sync_plan
from openr_tpu.types import Adjacency, AdjacencyDatabase
from tests.test_torch_incremental import _Churn, _pad
from tests.test_torch_lfa import _skew_rsw, _weighted
from tests.torch_jax_state import jax_state_barrier  # noqa: F401

DIRTY_CAP = 64
FIELDS = ("delta_buf", "full_buf", "metric", "s3w", "nhw", "lfa_slot",
          "lfa_metric", "dist")
ME = "node-2-2"


@pytest.fixture(scope="module")
def port():
    """The port's modules, with torch held to one thread while this
    module's tests run."""
    import torch

    from openr_tpu_torch import config, weights
    from openr_tpu_torch import types as ptypes
    from openr_tpu_torch.decision import gpu_solver, spf_solver
    from openr_tpu_torch.models import topologies as ptopo
    from openr_tpu_torch.ops import compact, stream
    from openr_tpu_torch.runtime.counters import counters

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(
        torch=torch, types=ptypes, weights=weights, gpu_solver=gpu_solver,
        spf_solver=spf_solver, topologies=ptopo, compact=compact,
        stream=stream, counters=counters, config=config,
    )
    torch.set_num_threads(prev)


# -- the stream pipeline against _stream_pipeline ------------------------------

def _stream_case(port, name, kernel, lfa):
    """A cold solve (the port's, whose parity tests/test_torch_lfa.py
    and test_torch_pipeline.py hold), then a metric change on a victim's
    links through the real changelog path: the stream pipeline's 20
    inputs (numpy, the cone budget last) and its static shape."""
    if name == "grid":
        adj_dbs, pdbs = topologies.grid(9, node_labels=False)
        adj_dbs, me = _weighted(adj_dbs, 3), "node-4-4"
    elif name == "fat_tree":
        adj_dbs, pdbs = topologies.fat_tree()
        adj_dbs, me = _skew_rsw(adj_dbs), "rsw-0-0"
    else:
        adj_dbs, pdbs = topologies.random_mesh(24, seed=5)
        adj_dbs, me = _weighted(adj_dbs, 5), "node-0"
    states, ps = topologies.build_states(adj_dbs, pdbs)
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
    if kernel == "bucketed":
        assert dexp > 0, "the case must engage the bucketed kernel"
    shape = (plan.n_cap, plan.s_cap, r_cap, kr_cap, plan.k_res > 0, d_cap,
             p_cap, a_cap, 4096)
    wa, wd = -(-a_cap // 16), -(-d_cap // 16)
    zeros = [np.zeros(p_cap, np.int32), np.zeros((p_cap, wa), np.int32),
             np.zeros((p_cap, wd), np.int32), np.zeros(p_cap, np.int32),
             np.zeros(p_cap, np.int32)]
    root = np.int32(plan.node_index[me])

    def lane(p):
        return [p.deltas.copy(), p.shift_w.copy(), p.res_rows.copy(),
                p.res_nbr.copy(), p.res_w.copy(), mbuf, root, root_nbr,
                root_w]

    cold = port.gpu_solver.pipeline(
        **port.weights.from_jax_state(lane(plan) + zeros, device="cpu"),
        has_res=shape[4], kernel=kernel, delta_exp=dexp, lfa=lfa,
        emit_dist=True,
    )
    prev_out = [getattr(cold, f).numpy() for f in FIELDS[2:7]]
    prev_dist = cold.dist.numpy()
    metric = 1 if name == "mesh" else 40

    victim = adj_dbs[1]
    by = {d.this_node_name: d for d in adj_dbs}
    for db in [victim] + [by[a.other_node_name] for a in victim.adjacencies]:
        adjs = tuple(
            Adjacency(**{**a.__dict__, "metric": metric})
            if victim.this_node_name in (db.this_node_name,
                                         a.other_node_name) else a
            for a in db.adjacencies
        )
        ls.update_adjacency_database(AdjacencyDatabase(
            this_node_name=db.this_node_name, adjacencies=adjs, area="0",
        ))
    assert sync_plan(ls, plan) is plan, "metric churn applies in place"
    (s_idx, _, s_old), (r_idx, _, r_old), nbr_changed = drain_dirty(plan)
    assert not nbr_changed
    sd = _pad([] if s_idx is None else zip(s_idx.tolist(), s_old.tolist()),
              plan.s_cap * plan.n_cap)
    rd = _pad([] if r_idx is None else zip(r_idx.tolist(), r_old.tolist()),
              r_cap * kr_cap)
    args = (lane(plan) + list(prev_out) + [prev_dist, *sd, *rd]
            + [np.int32(1 << 20)])
    return args, zeros, shape, dexp


@pytest.mark.parametrize("name,kernel,lfa,sbudget", [
    ("grid", "sync", False, 64),
    ("grid", "bucketed", True, 256),
    ("grid", "bucketed", False, 1024),
    ("fat_tree", "sync", True, 64),
    ("fat_tree", "sync", False, 256),
    ("mesh", "bucketed", False, 256),
    ("mesh", "sync", True, 64),
])
def test_stream_pipeline_bytes_match_jax(port, name, kernel, lfa, sbudget):
    """The port's streaming epoch against ``_stream_pipeline`` called
    directly: the bucketed payload (ok column, LFA columns, sentinel and
    cone tails), the full buffer, the five published planes and the
    distance plane byte for byte — for a churn epoch, and for an epoch
    against zeroed previous planes, where every ok row changed (over the
    budget on the 81-row grid at budget 64). With LFA on the grid, the
    zeroed epoch also at budget 64: the LFA columns over the budget."""
    args, zeros, shape, dexp = _stream_case(port, name, kernel, lfa)
    p_cap = shape[6]
    legs = [("churn", args[9:14], sbudget), ("zeroed prev", zeros, sbudget)]
    if lfa and sbudget > 64 < p_cap:
        legs.append(("zeroed prev, budget 64", zeros, 64))
    runs = {}
    for label, prev, sbudget in legs:
        if sbudget not in runs:
            runs[sbudget] = _stream_pipeline.__wrapped__(
                *shape, DIRTY_CAP, sbudget, lfa, False, True, kernel, dexp,
                donate=False,
            )
        run = runs[sbudget]
        full = args[:9] + list(prev) + args[14:]
        want = [np.asarray(a) for a in run(*full)]
        got = port.gpu_solver.pipeline(
            **port.weights.from_jax_state(full, device="cpu"),
            has_res=shape[4], sentinels=True, kernel=kernel, delta_exp=dexp,
            lfa=lfa, stream=sbudget,
        )
        for field, w in zip(FIELDS, want):
            g = getattr(got, field).numpy()
            assert g.dtype == np.int32 and g.shape == w.shape, (label, field)
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {field}")
        count = int(want[0][0])
        assert count > 0, label
        if label.startswith("zeroed prev") and p_cap > sbudget:
            assert count > sbudget, "the epoch must run over its budget"


@pytest.mark.parametrize("lfa,sentinels", [
    (False, True), (True, True), (False, False), (True, False),
])
def test_buffer_lens_equal_stream_payload_len(port, lfa, sentinels):
    """The port's budgets and payload length are the JAX package's, and
    K4's streaming delta buffer has exactly that length."""
    pst = port.stream
    assert pst.STREAM_BUDGETS == jstream.STREAM_BUDGETS
    for n in (0, 1, 63, 64, 65, 255, 256, 1024, 1025, 4096, 4097, 10 ** 6):
        assert pst.stream_budget(n) == jstream.stream_budget(n), n
    for b in pst.STREAM_BUDGETS:
        for wa, wd in ((1, 1), (1, 2), (3, 1)):
            want = jstream.stream_payload_len(b, wa, wd, lfa, sentinels)
            assert pst.stream_payload_len(b, wa, wd, lfa, sentinels) == want
            n_delta, _ = port.compact.buffer_lens(
                8192, wa, wd, b, sentinels, incr=True, lfa=lfa, stream=True)
            assert n_delta == want, (b, wa, wd)
    # the classic delta payload stays as it was: no ok column
    assert (port.compact.buffer_lens(8192, 1, 1, 64, True, True)[0]
            == jstream.stream_payload_len(64, 1, 1, False, True) - 64)


# -- the streaming solver ------------------------------------------------------

def _grid(port, n=5):
    adj_dbs, pdbs = port.topologies.grid(n, node_labels=False)
    states, ps = port.topologies.build_states(adj_dbs, pdbs)
    return _Churn(port, adj_dbs, states), states, ps


def _rib(db):
    return dict(db.unicast_routes.items()), db.mpls_routes


def _stream_info(solver):
    return solver.last_timing.get("stream") or {}


def test_randomized_churn_stream_equals_cold_and_oracle(port):
    """Randomized metric changes and link down / up from a seed: the
    streaming solver's RIB equals the port's cold solve and the oracle
    at every epoch, and most epochs stream."""
    churn, states, ps = _grid(port)
    gs = port.gpu_solver
    strm = gs.GpuSpfSolver(ME, device="cpu", streaming_pipeline=True)
    cold = gs.GpuSpfSolver(ME, device="cpu")
    cpu = port.spf_solver.SpfSolver(ME)

    def solve(ctx):
        want = _rib(cpu.build_route_db(ME, states, ps))
        assert _rib(strm.build_route_db(ME, states, ps)) == want, ctx
        assert _rib(cold.build_route_db(ME, states, ps)) == want, ctx

    solve("round0")
    assert not _stream_info(strm), "a first solve is cold"
    rng = np.random.default_rng(23)
    metrics = (1, 3, 50, 100000)
    edges = churn.edges()
    engaged = 0
    down = None
    for i in range(10):
        if down is not None and rng.integers(3) == 0:
            u, v, db_u, db_v = down
            churn._put(db_u)
            churn._put(db_v)
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
        solve(ctx)
        if _stream_info(strm).get("epochs"):
            engaged += 1
            assert strm.last_device_stats["stream"]["budget"] in (
                port.stream.STREAM_BUDGETS), ctx
    # root-link churn legitimately takes the classic path
    assert engaged >= 5, engaged


def _corner_out_and_back(churn):
    """A corner isolated (its loopback leaves the RIB through the
    ok-transition lane), then restored."""
    saved = [churn.dbs[n] for n in ("node-0-0", "node-0-1", "node-1-0")]
    churn.link_down("node-0-0", "node-0-1")
    churn.link_down("node-0-0", "node-1-0")
    yield "withdraw-corner"
    for db in saved:
        churn._put(db)
    yield "restore-corner"


def _withdrawals(churn):
    churn.set_metric("node-0-1", "node-1-1", 40)
    yield "metric-inc"
    yield from _corner_out_and_back(churn)


def _mbb_epochs(churn):
    """The epochs tests/test_stream_pipeline.py's make-before-break drill
    programs: metric steps, then a withdrawal and its restore."""
    for m, ctx in ((30, "mbb-clean"), (44, "mbb-cleanup"),
                   (51, "mbb-retry")):
        churn.set_metric("node-0-1", "node-1-1", m)
        yield ctx
    yield from _corner_out_and_back(churn)


@pytest.mark.parametrize("script", ["withdrawals", "mbb_epochs"])
def test_stream_update_batches_equal_host_diff(port, script):
    """Each epoch's RIB delta (updated routes, deleted prefixes) from
    the streaming solver, whose rows come from the device diff with the
    ok bit, equals the classic path's — which re-derives route-ok on the
    host — through withdrawals and restores."""
    churn, states, ps = _grid(port)
    gs = port.gpu_solver
    strm = gs.GpuSpfSolver(ME, device="cpu", streaming_pipeline=True)
    host = gs.GpuSpfSolver(ME, device="cpu", incremental_spf=True)
    s_db = strm.build_route_db(ME, states, ps)
    h_db = host.build_route_db(ME, states, ps)
    steps = _withdrawals if script == "withdrawals" else _mbb_epochs
    saw_delete = saw_update = False
    for ctx in steps(churn):
        s_new = strm.build_route_db(ME, states, ps)
        h_new = host.build_route_db(ME, states, ps)
        assert _stream_info(strm).get("epochs") == 1, ctx
        s_upd = s_db.calculate_update(s_new)
        h_upd = h_db.calculate_update(h_new)
        assert dict(s_upd.unicast_routes_to_update) == dict(
            h_upd.unicast_routes_to_update), ctx
        assert sorted(s_upd.unicast_routes_to_delete) == sorted(
            h_upd.unicast_routes_to_delete), ctx
        saw_delete |= bool(s_upd.unicast_routes_to_delete)
        saw_update |= bool(s_upd.unicast_routes_to_update)
        s_db, h_db = s_new, h_new
    assert saw_delete and saw_update


def test_idle_epoch_downloads_one_budget_payload(port):
    """An epoch in which no row changed still ships one whole payload at
    budget 64: exactly 4 * stream_payload_len(64, ...) bytes, the same as
    a within-budget churn epoch, and 0 changed rows."""
    churn, states, ps = _grid(port)
    strm = port.gpu_solver.GpuSpfSolver(ME, device="cpu",
                                        streaming_pipeline=True)
    strm.build_route_db(ME, states, ps)
    vs = strm._vstates[("0", ME)]
    wa = -(-vs.crib.matrix.ann_node.shape[1] // 16)
    wd = -(-len(vs.links_tuple) // 16)
    want = 4 * port.stream.stream_payload_len(64, wa, wd, False, True)
    assert want == 1308
    churn.set_metric("node-0-1", "node-1-1", 9)
    strm.build_route_db(ME, states, ps)
    st = _stream_info(strm)
    assert st["epochs"] == 1 and st["changed_rows"] > 0, st
    assert strm.last_timing["bytes_downloaded"] == want
    for i in range(2):
        strm.build_route_db(ME, states, ps)
        st = _stream_info(strm)
        assert st["epochs"] == 1 and st["changed_rows"] == 0, (i, st)
        assert st["overflows"] == 0
        assert strm.last_timing["bytes_downloaded"] == want, i
        assert strm.last_device_stats["stream"] == {"budget": 64,
                                                    "overflow": False}


def test_budget_grows_past_an_overflow_and_settles(port):
    """Over-budget epochs pull the full buffer too and grow the budget
    to the bucket their churn needs; quiet epochs settle it back to 64.
    Every epoch's RIB equals the oracle's."""
    churn, states, ps = _grid(port, 9)
    me = "node-4-4"
    strm = port.gpu_solver.GpuSpfSolver(me, device="cpu",
                                        streaming_pipeline=True)
    cpu = port.spf_solver.SpfSolver(me)
    counters = port.counters
    overflows0 = int(counters.get_counter("decision.stream.overflows") or 0)
    strm.build_route_db(me, states, ps)
    vs = strm._vstates[("0", me)]
    seen = []

    def epoch(ctx):
        budget = vs.stream_budget
        db = strm.build_route_db(me, states, ps)
        assert _rib(db) == _rib(cpu.build_route_db(me, states, ps)), ctx
        st = strm.last_device_stats
        assert st["stream"]["budget"] == budget, ctx
        seen.append((budget, st["changed_rows"], st["stream"]["overflow"],
                     vs.stream_budget))
        return st

    churn.set_metric("node-4-6", "node-4-7", 7)
    epoch("flap east of the root")
    # every link of the root: every route's metric moves
    for nbr in ("node-3-4", "node-5-4", "node-4-3", "node-4-5"):
        churn.set_metric(me, nbr, 3)
    st = epoch("root links")
    assert st["full_pull"] and st["changed_rows"] > 64
    n_delta = 4 * port.stream.stream_payload_len(64, 1, 1, False, True)
    assert strm.last_timing["bytes_downloaded"] > n_delta
    churn.set_metric("node-4-6", "node-4-7", 1)
    epoch("the flap back, at the grown budget")
    epoch("idle")
    assert seen == [
        (64, seen[0][1], False, 64),
        (64, seen[1][1], True, 256),
        (256, seen[2][1], False, 64),
        (64, 0, False, 64),
    ], seen
    assert 0 < seen[0][1] <= 64 and 64 < seen[1][1] <= 256
    assert (int(counters.get_counter("decision.stream.overflows"))
            - overflows0) == 1


def test_abandoned_collect_costs_one_full_rebuild(port):
    """A streaming dispatch whose collect never runs leaves the vantage
    invalid: the next solve rebuilds in full (the full pull, the RIB
    equal to the oracle's), and the one after streams again."""
    churn, states, ps = _grid(port)
    strm = port.gpu_solver.GpuSpfSolver(ME, device="cpu",
                                        streaming_pipeline=True)
    cpu = port.spf_solver.SpfSolver(ME)
    strm.build_route_db(ME, states, ps)
    churn.set_metric("node-0-1", "node-1-1", 12)
    pending = strm.dispatch_route_db(ME, states, ps)
    assert pending is not None and pending.areas[0]["stream"] == 64
    assert not strm._vstates[("0", ME)].valid
    del pending  # abandoned
    churn.set_metric("node-3-3", "node-3-4", 6)
    db = strm.build_route_db(ME, states, ps)
    st = strm.last_device_stats
    assert st["full_pull"] and not st.get("incremental"), st
    assert not _stream_info(strm)
    assert _rib(db) == _rib(cpu.build_route_db(ME, states, ps))
    churn.set_metric("node-3-3", "node-3-4", 2)
    db = strm.build_route_db(ME, states, ps)
    assert _stream_info(strm).get("epochs") == 1
    assert _rib(db) == _rib(cpu.build_route_db(ME, states, ps))


def test_streaming_option_is_a_bool_and_implies_incremental(port):
    gs = port.gpu_solver
    with pytest.raises(ValueError, match="bool"):
        gs.GpuSpfSolver(ME, device="cpu", streaming_pipeline=1)
    with pytest.raises(ValueError, match="bool"):
        port.config.DecisionConfig(streaming_pipeline="yes")
    kw = dataclasses.replace(port.config.DecisionConfig(),
                             streaming_pipeline=True,
                             incremental_spf=False).solver_kwargs()
    solver = gs.GpuSpfSolver(ME, device="cpu", **kw)
    assert solver.streaming_pipeline and solver.incremental_spf
