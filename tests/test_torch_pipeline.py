"""The port's cold pipeline (openr_tpu_torch/decision/gpu_solver.pipeline:
SSSP, K3 selection, K4 compaction) against the JAX package's
``tpu_solver._plan_pipeline``, input for input.

The device inputs are built once with the JAX package's host code
(edge plan, prefix matrix, packed announcer buffer, root tables), run
through the jitted JAX pipeline on the CPU backend, carried across with
``openr_tpu_torch.weights.from_jax_state`` and run through the port's
pipeline on CPU tensors (each kernel's plain PyTorch version). Every
output is int32 and must be byte-identical: delta_buf, full_buf,
metric, s3w, nhw (trips, rounds and the route-ok rows ride the
buffers).
"""

import dataclasses
import types

import numpy as np
import pytest

from openr_tpu.decision.tpu_solver import (
    _fast_path_eligible,
    _pack_matrix,
    _plan_pipeline,
)
from openr_tpu.models import topologies
from openr_tpu.ops.csr import build_prefix_matrix
from openr_tpu.ops.edgeplan import build_plan
from openr_tpu.types import AdjacencyDatabase, PrefixMetrics
from tests.test_spf_solver import prefix_db
from tests.torch_jax_state import jax_state_barrier  # noqa: F401


@pytest.fixture(scope="module")
def port():
    """The port's pipeline and weight carry-over, with torch held to one
    thread while this module's tests run."""
    import torch

    from openr_tpu_torch import weights
    from openr_tpu_torch.decision import gpu_solver

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(torch=torch, weights=weights,
                                gpu_solver=gpu_solver)
    torch.set_num_threads(prev)


def jax_inputs(states, ps, me, area="0", prev_seed=None):
    """(args, static) for one (area, vantage) cold solve, built with the
    JAX solver's host code: ``args`` in the pipeline's argument order
    (numpy), ``static`` its shape parameters. ``prev_seed`` draws the
    previous outputs at random (some rows equal to the solve's, most
    not) instead of the first solve's zeros."""
    ls = states[area]
    plan = build_plan(ls)
    prefixes = [
        p for p, e in ps.prefixes().items()
        if _fast_path_eligible(e) and {a for _, a in e} == {area}
    ]
    matrix = build_prefix_matrix(ps, plan.node_index, area, prefixes)
    _, mbuf = _pack_matrix(matrix, plan.node_overloaded)
    root_nbr, root_w, _ = plan.out_links(ls, me)
    p_cap, a_cap = matrix.ann_node.shape
    d_cap = root_nbr.shape[0]
    wa, wd = -(-a_cap // 16), -(-d_cap // 16)
    prev = [np.zeros(p_cap, np.int32), np.zeros((p_cap, wa), np.int32),
            np.zeros((p_cap, wd), np.int32)]
    if prev_seed is not None:
        rng = np.random.default_rng(prev_seed)
        prev = [rng.integers(0, 3, size=a.shape).astype(np.int32)
                for a in prev]
    args = [
        plan.deltas, plan.shift_w, plan.res_rows, plan.res_nbr, plan.res_w,
        mbuf, np.int32(plan.node_index[me]), root_nbr, root_w, *prev,
        np.zeros(p_cap, np.int32), np.zeros(p_cap, np.int32),
    ]
    r_cap, kr_cap = plan.res_nbr.shape
    static = dict(
        n_cap=plan.n_cap, s_cap=plan.s_cap, r_cap=r_cap, kr_cap=kr_cap,
        has_res=plan.k_res > 0, d_cap=d_cap, p_cap=p_cap, a_cap=a_cap,
        delta_exp=plan.delta_exp,
    )
    return args, static


def _anycast_mesh():
    """random mesh with drained nodes, anycast prefixes over every
    selection stage, a min-nexthop gate and v4 loopbacks"""
    adj_dbs, prefix_dbs = topologies.random_mesh(24, seed=5)
    states, ps = topologies.build_states(adj_dbs, prefix_dbs)
    for db in adj_dbs[3:5]:
        states["0"].update_adjacency_database(AdjacencyDatabase(
            this_node_name=db.this_node_name, adjacencies=db.adjacencies,
            is_overloaded=True, area="0",
        ))
    for i, node in enumerate(("node-3", "node-9", "node-17")):
        ps.update_prefix_database(prefix_db(
            node, "fd00::a0/128",
            metrics=PrefixMetrics(path_preference=1000 - (i == 2) * 10),
        ))
        ps.update_prefix_database(prefix_db(
            node, "fd00::a1/128", metrics=PrefixMetrics(distance=1 + i),
        ))
        ps.update_prefix_database(prefix_db(
            node, "fd00::a2/128",
            metrics=PrefixMetrics(source_preference=200 + (i == 1)),
        ))
    ps.update_prefix_database(prefix_db("node-4", "fd00::a3/128"))
    ps.update_prefix_database(prefix_db("node-3", "fd00::a3/128"))
    ps.update_prefix_database(prefix_db("node-8", "fd00::a4/128",
                                        min_nexthop=2))
    ps.update_prefix_database(prefix_db("node-11", "10.9.0.0/24"))
    return states, ps, "node-0"


def _wide():
    """A weighted full mesh of 20 nodes (the root has 19 out-slots, so
    the next hops take two 16-bit words) with two anycast prefixes of
    more than 16 announcers (two selection words): one announced by 18
    nodes, the root among them, at mixed preferences and distances; one
    by 17 nodes at equal ones (ECMP over many announcers)."""
    adj_dbs, prefix_dbs = topologies.full_mesh(20)
    rng = np.random.default_rng(11)
    metric = {}
    adj_dbs = [dataclasses.replace(db, adjacencies=tuple(
        dataclasses.replace(a, metric=metric.setdefault(
            tuple(sorted((db.this_node_name, a.other_node_name))),
            int(rng.integers(1, 4))))
        for a in db.adjacencies)) for db in adj_dbs]
    states, ps = topologies.build_states(adj_dbs, prefix_dbs)
    for i in range(18):
        ps.update_prefix_database(prefix_db(
            f"node-{i}", "fd00::a5/128",
            metrics=PrefixMetrics(path_preference=1000 - (i % 3 == 2) * 10,
                                  distance=1 + i % 2)))
    for i in range(1, 18):
        ps.update_prefix_database(prefix_db(f"node-{i}", "fd00::a6/128"))
    return states, ps, "node-0"


def _case(name):
    if name == "wide":
        return _wide()
    if name == "grid":
        adj_dbs, prefix_dbs = topologies.grid(5)
        states, ps = topologies.build_states(adj_dbs, prefix_dbs)
        return states, ps, "node-2-1"
    if name == "fat_tree":
        adj_dbs, prefix_dbs = topologies.fat_tree()
        states, ps = topologies.build_states(adj_dbs, prefix_dbs)
        return states, ps, "rsw-0-0"
    return _anycast_mesh()


@pytest.mark.parametrize(
    "name,kernel,prev_seed,budget,block_v4",
    [
        ("grid", "bucketed", None, 4096, False),
        ("fat_tree", "sync", 1, 4096, False),
        # a budget below the changed-row count: overflow + pad slots
        ("anycast_mesh", "bucketed", 2, 4, True),
        ("anycast_mesh", "sync", None, 4096, False),
        # A > 16 and D > 16 (two words each), an announcer at the root,
        # a budget below the changed rows
        ("wide", "sync", 3, 8, True),
    ],
)
def test_pipeline_bytes_match_jax(port, name, kernel, prev_seed, budget,
                                  block_v4):
    states, ps, me = _case(name)
    args, st = jax_inputs(states, ps, me, prev_seed=prev_seed)
    dexp = st["delta_exp"] if kernel == "bucketed" else 0
    if kernel == "bucketed":
        assert dexp > 0, "the case must engage the bucketed kernel"
    run = _plan_pipeline(
        st["n_cap"], st["s_cap"], st["r_cap"], st["kr_cap"], st["has_res"],
        st["d_cap"], st["p_cap"], st["a_cap"], budget, False, block_v4,
        True, False, kernel, dexp,
    )
    want = [np.asarray(a) for a in run(*args)]
    got = port.gpu_solver.pipeline(
        **port.weights.from_jax_state(args, device="cpu"),
        has_res=st["has_res"], block_v4=block_v4, sentinels=True,
        kernel=kernel, delta_exp=dexp, budget=budget,
    )
    for field, w in zip(("delta_buf", "full_buf", "metric", "s3w", "nhw"),
                        want):
        g = getattr(got, field).numpy()
        assert g.dtype == np.int32 and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert (got.trips, got.rounds) == (int(want[1][1]), int(want[1][-1]))
    if name == "wide":
        assert st["a_cap"] > 16 and st["d_cap"] > 16
        assert (got.s3w[:, 1] != 0).any() and (got.nhw[:, 1] != 0).any()
    if budget < st["p_cap"]:
        assert int(want[0][0]) > budget, "the case must overflow the budget"


def test_pipeline_pads_with_last_row(port):
    """Pad slots past the ok count carry index p_cap and row p_cap-1's
    values (the fixed-size nonzero fills with p_cap, the gather clips) —
    not the last ok row's."""
    torch = port.torch
    states, ps, me = _case("grid")
    args, st = jax_inputs(states, ps, me)
    kw = port.weights.from_jax_state(args, device="cpu")
    out = port.gpu_solver.pipeline(
        **kw, has_res=st["has_res"], kernel="sync",
    )
    p_cap = st["p_cap"]
    okc = int(out.full_buf[0])
    assert 0 < okc < p_cap
    oidx = out.full_buf[2:2 + p_cap]
    metric = out.full_buf[2 + p_cap:2 + 2 * p_cap]
    assert torch.all(oidx[okc:] == p_cap)
    assert torch.all(metric[okc:] == out.metric[p_cap - 1])
