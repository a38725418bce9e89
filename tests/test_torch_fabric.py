"""The port's whole-fabric step (openr_tpu_torch/ops/fabric.py,
csrc/fabric.cu: K21 ``fabric_relax``, K22 ``unpack_bits``, with K1s
seeds and K3 selection over a root axis; ``parallel/sharding.py``) and
``GpuSpfSolver.build_fabric_route_dbs`` against the JAX package's
``parallel/sharding.py::sharded_fabric_step`` on a one-device mesh
(``make_mesh(1)``) and the port's CPU oracle.

The JAX step runs as the reference runs it; no ``TpuSpfSolver`` is
built. The port's step gets the JAX host mirror's arrays
(``weights.fabric_inputs_from_jax``) and, through its own
``sharded_fabric_step``, its own mirror of the same LSDB in its own
types. All seven arrays and the convergence vote must be equal, byte
for byte; with a trip bound too small for some roots both packages
raise ``Unconverged`` for the same roots and, unchecked, return the
same arrays. The solver's RIBs are held to the port's ``SpfSolver``, as
tests/test_sharding.py's ``fabric_vs_oracle`` holds the reference's.
The port runs on CPU tensors (the plain versions).
"""

import re
import types

import numpy as np
import pytest

from openr_tpu.models import topologies
from openr_tpu.ops.csr import build_prefix_matrix
from openr_tpu.ops.edgeplan import build_plan
from openr_tpu.parallel.sharding import (
    Unconverged,
    make_mesh,
    sharded_fabric_step,
)
from tests.test_torch_legacy import _mesh_scenario
from tests.test_torch_solver import assert_rib_equal, to_port
from tests.torch_jax_state import jax_state_barrier  # noqa: F401

OUTPUTS = ("dist", "metric", "s3", "nh_mask", "lfa_slot", "lfa_metric", "ok")


@pytest.fixture(scope="module")
def port():
    """The port's modules, with torch held to one thread while this
    module's tests run."""
    import torch

    from openr_tpu_torch import types as ptypes, weights
    from openr_tpu_torch.decision import gpu_solver, spf_solver
    from openr_tpu_torch.models import topologies as ptopo
    from openr_tpu_torch.ops import csr, edgeplan, fabric
    from openr_tpu_torch.parallel import sharding

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(
        torch=torch, types=ptypes, weights=weights, gpu_solver=gpu_solver,
        spf_solver=spf_solver, topologies=ptopo, csr=csr, edgeplan=edgeplan,
        fabric=fabric, sharding=sharding,
    )
    torch.set_num_threads(prev)


CELLS = {
    "grid6": lambda: topologies.grid(6),
    "mesh": _mesh_scenario,  # drains, a down link, parallel links, v4
    "fabric": lambda: topologies.fabric(4, 2, 3, 4),  # residual ELL
    "mesh40": lambda: topologies.random_mesh(40, 3, seed=4),  # residual
}


def _cell(port, name):
    """(JAX plan, matrix, port plan, matrix, roots, out_nbr, out_w) for
    every node of the cell as a root."""
    adj_dbs, pdbs = CELLS[name]()
    states, ps = topologies.build_states(adj_dbs, pdbs)
    plan = build_plan(states["0"])
    matrix = build_prefix_matrix(ps, plan.node_index, "0")
    pstates, pps = port.topologies.build_states(
        to_port(adj_dbs, port.types), to_port(pdbs, port.types))
    pplan = port.edgeplan.build_plan(pstates["0"])
    pmatrix = port.csr.build_prefix_matrix(pps, pplan.node_index, "0")
    assert pplan.node_names == plan.node_names
    return (plan, matrix, pplan, pmatrix,
            *port.fabric.root_tables(plan, states["0"], plan.node_names)[:3])


def _unconverged_roots(err) -> list:
    return [int(x) for x in re.search(r"roots \[([^\]]*)\]", str(err))
            .group(1).replace(",", " ").split()]


def _assert_same(want, got, what):
    for f, a, b in zip(OUTPUTS, want, got):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (what, f)
        assert np.array_equal(a, b), (what, f)


@pytest.mark.parametrize("name,lfa,block_v4", [
    ("grid6", False, False), ("grid6", True, False), ("mesh", True, True),
    ("mesh", False, True), ("fabric", True, False),
])
def test_fabric_step_matches_jax(port, name, lfa, block_v4):
    """All seven arrays and the convergence vote equal the JAX step's,
    from the JAX mirror's arrays and from the port's own mirror."""
    plan, matrix, pplan, pmatrix, roots, out_nbr, out_w = _cell(port, name)
    n_trips = 4
    want = sharded_fabric_step(make_mesh(1), plan, matrix, roots, out_nbr,
                               out_w, n_trips, lfa=lfa, block_v4=block_v4,
                               with_ok=True)
    kw = port.weights.fabric_inputs_from_jax(plan, matrix, roots, out_nbr,
                                             out_w, device="cpu")
    out = port.fabric.fabric_step(**kw, n_trips=n_trips, lfa=lfa,
                                  block_v4=block_v4)
    assert out.converged.all()
    unpack = port.fabric.unpack_bits
    _assert_same(want, (out.dist, out.metric, unpack(out.s3w, kw["a_cap"]),
                        unpack(out.nhw, out_nbr.shape[1]), out.lfa_slot,
                        out.lfa_metric, out.ok), "jax mirror")
    # checked: it raises unless every root converged
    got = port.sharding.sharded_fabric_step(
        None, pplan, pmatrix, roots, out_nbr, out_w, n_trips, lfa=lfa,
        block_v4=block_v4, with_ok=True, device="cpu")
    _assert_same(want, got, "port mirror")
    if lfa and name == "mesh":  # seeded metrics: loop-free alternates
        assert int((np.asarray(want[4]) >= 0).sum()) > 0
    if block_v4:
        v4 = np.flatnonzero(matrix.is_v4[:len(matrix.prefix_list)])
        assert v4.size and not np.asarray(want[6])[:, v4].any()


@pytest.mark.parametrize("name,n_trips", [("mesh40", 1), ("mesh40", 0)])
def test_fabric_unconverged_matches_jax(port, name, n_trips):
    """Below the diameter bound both packages raise for the same roots
    and, unchecked, return the same arrays (the planes after exactly
    n_trips trips) and the same vote."""
    plan, matrix, pplan, pmatrix, roots, out_nbr, out_w = _cell(port, name)
    with pytest.raises(Unconverged) as jerr:
        sharded_fabric_step(make_mesh(1), plan, matrix, roots, out_nbr,
                            out_w, n_trips, lfa=True)
    with pytest.raises(port.sharding.Unconverged) as perr:
        port.sharding.sharded_fabric_step(None, pplan, pmatrix, roots,
                                          out_nbr, out_w, n_trips, lfa=True,
                                          device="cpu")
    bad = _unconverged_roots(jerr.value)
    assert bad == _unconverged_roots(perr.value)
    assert 0 < len(bad) <= len(roots)
    want = sharded_fabric_step(make_mesh(1), plan, matrix, roots, out_nbr,
                               out_w, n_trips, check_convergence=False,
                               lfa=True, with_ok=True)
    got = port.sharding.sharded_fabric_step(
        None, pplan, pmatrix, roots, out_nbr, out_w, n_trips,
        check_convergence=False, lfa=True, with_ok=True, device="cpu")
    _assert_same(want, got, "unconverged")
    kw = port.weights.fabric_inputs_from_jax(plan, matrix, roots, out_nbr,
                                             out_w, device="cpu")
    out = port.fabric.fabric_step(**kw, n_trips=n_trips, lfa=True)
    assert np.flatnonzero(~out.converged).tolist() == bad


def test_fabric_extent_plain(port):
    """K21e's plain version: 1 + the last column of finite weight, over
    rows with tombstones inside, all-INF rows and full rows."""
    t = port.torch
    inf = 1 << 29
    w = np.full((5, 6), inf, np.int32)
    w[0, :2] = 3
    w[1, [0, 4]] = 1  # a tombstone between live entries
    w[3, :] = 7
    w[4, 5] = 0
    got = port.fabric.fabric_extent_plain(t.tensor(w))
    assert got.dtype == t.int32
    assert got.tolist() == [2, 5, 0, 6, 6]


def test_fabric_extent_plain_live_classes(port):
    """K21e's class pass: a class row is live where it holds a finite
    weight (K21 runs only those); without residual rows the extent is
    None."""
    t = port.torch
    inf = 1 << 29
    sw = np.full((4, 6), inf, np.int32)
    sw[0, 5] = 2
    sw[2, :] = 1
    sw[3, 0] = 0
    res_w = np.full((3, 4), inf, np.int32)
    res_w[1, 2] = 9
    ext, live = port.fabric.fabric_extent_plain(t.tensor(res_w),
                                                t.tensor(sw))
    assert ext.tolist() == [0, 3, 0]
    assert live.dtype == t.int32 and live.tolist() == [1, 0, 1, 1]
    ext, live = port.fabric.fabric_extent(None, t.tensor(sw))
    assert ext is None and live.tolist() == [1, 0, 1, 1]


def test_row_table(port):
    """K21's node -> row table: the numpy inverse of ``res_rows`` with
    the pad rows (-1) dropped and -1 for a node without a row; a
    tensor's table is a tensor on its device; a node with two rows, or
    a row past ``n_cap``, raises."""
    t = port.torch
    rng = np.random.default_rng(5)
    n_cap = 64
    rows = np.full(40, -1, np.int32)
    at = rng.choice(40, 25, replace=False)
    rows[at] = rng.choice(n_cap, 25, replace=False)
    want = np.full(n_cap, -1, np.int32)
    for r, v in enumerate(rows):
        if v >= 0:
            want[v] = r
    got = port.fabric.row_table(rows, n_cap)
    np.testing.assert_array_equal(got, want)
    got_t = port.fabric.row_table(t.tensor(rows), n_cap)
    assert got_t.dtype == t.int32 and got_t.device.type == "cpu"
    np.testing.assert_array_equal(got_t.numpy(), want)
    dup = rows.copy()
    dup[np.flatnonzero(rows < 0)[0]] = rows[at[0]]
    with pytest.raises(ValueError, match="unique"):
        port.fabric.row_table(dup, n_cap)
    with pytest.raises(ValueError):
        port.fabric.row_table(np.array([n_cap], np.int32), n_cap)


def _fabric_vs_oracle(port, states, ps, roots, solver=None, **kw):
    solver = solver or port.gpu_solver.GpuSpfSolver(roots[0], device="cpu",
                                                    **kw)
    dbs = solver.build_fabric_route_dbs(roots, states, ps)
    for root in roots:
        want = port.spf_solver.SpfSolver(root, **kw).build_route_db(
            root, states, ps)
        if want is None:
            assert dbs[root] is None, root
            continue
        assert_rib_equal(want, dbs[root], f"fabric vantage {root}")
    return solver, dbs


def _port_states(port, gen):
    adj_dbs, pdbs = gen()
    return port.topologies.build_states(adj_dbs, pdbs), adj_dbs


def test_fabric_route_dbs_all_vantages(port):
    (states, ps), _ = _port_states(port, lambda: port.topologies.grid(6))
    roots = sorted(states["0"].get_adjacency_databases())
    solver, dbs = _fabric_vs_oracle(port, states, ps, roots)
    assert len(dbs) == 36
    st = solver.last_fabric_stats
    assert st["roots"] == 36 and st["retries"] == 0
    assert st["bytes_downloaded"] > 0


def test_fabric_route_dbs_with_lfa(port):
    """LFA backups on the mesh cell (seeded metrics, drains, a down
    link, parallel links, an overloaded vantage) equal the oracle's."""
    adj_dbs, pdbs = _mesh_scenario()
    states, ps = port.topologies.build_states(to_port(adj_dbs, port.types),
                                              to_port(pdbs, port.types))
    _, dbs = _fabric_vs_oracle(port, states, ps,
                               ["node-0", "node-3", "node-12"],
                               enable_lfa=True)
    assert any(r.lfa_nexthops for db in dbs.values()
               for r in db.unicast_routes.values())


def test_fabric_route_dbs_drained_and_churn(port):
    T = port.types
    (states, ps), adj_dbs = _port_states(
        port, lambda: port.topologies.random_mesh(30, seed=3))
    ls = states["0"]
    victim = next(d for d in adj_dbs if d.this_node_name == "node-7")
    ls.update_adjacency_database(T.AdjacencyDatabase(
        this_node_name="node-7", adjacencies=victim.adjacencies,
        is_overloaded=True, area="0"))
    roots = ["node-0", "node-7", "node-15"]
    solver, _ = _fabric_vs_oracle(port, states, ps, roots)
    # metric churn, then the same solver recomputes
    ls.update_adjacency_database(T.AdjacencyDatabase(
        this_node_name="node-3",
        adjacencies=tuple(
            T.Adjacency(**{**a.__dict__, "metric": 9})
            for a in next(d for d in adj_dbs
                          if d.this_node_name == "node-3").adjacencies),
        area="0"))
    _fabric_vs_oracle(port, states, ps, roots, solver=solver)


def test_fabric_unknown_root_returns_none(port):
    (states, ps), _ = _port_states(port, lambda: port.topologies.grid(4))
    solver = port.gpu_solver.GpuSpfSolver("node-0-0", device="cpu")
    dbs = solver.build_fabric_route_dbs(["node-0-0", "not-a-node"], states,
                                        ps)
    assert dbs["not-a-node"] is None
    assert dbs["node-0-0"] is not None


def test_fabric_trip_bound_retry_from_cold_solver(port):
    """A fresh solver has no measured trip count (last_trips == 0): the
    bound starts at 2 trips and the vote drives the doubling retry on a
    grid whose corners need more."""
    (states, ps), _ = _port_states(port, lambda: port.topologies.grid(12))
    solver = port.gpu_solver.GpuSpfSolver("node-0-0", device="cpu")
    assert solver.last_trips == 0
    _fabric_vs_oracle(port, states, ps, ["node-0-0", "node-11-11"],
                      solver=solver)
    st = solver.last_fabric_stats
    assert st["retries"] >= 1 and st["n_trips"] == 2 << st["retries"]


def test_last_trips_from_cold_solves_only(port):
    """last_trips is the last cold solve's trips, never an incremental
    one's, and seeds the fabric bound at 2 * last_trips + 1."""
    T = port.types
    (states, ps), adj_dbs = _port_states(port,
                                         lambda: port.topologies.grid(6))
    me = "node-2-2"
    solver = port.gpu_solver.GpuSpfSolver(me, device="cpu",
                                          incremental_spf=True,
                                          spf_kernel="sync")
    solver.build_route_db(me, states, ps)
    cold = solver.last_trips
    assert cold == solver.last_timing["trips"] > 0
    db = next(d for d in adj_dbs if d.this_node_name == "node-4-4")
    states["0"].update_adjacency_database(T.AdjacencyDatabase(
        this_node_name="node-4-4",
        adjacencies=tuple(T.Adjacency(**{**a.__dict__, "metric": 3})
                          for a in db.adjacencies), area="0"))
    solver.build_route_db(me, states, ps)
    assert solver.last_device_stats.get("incremental")
    assert solver.last_trips == cold
    _fabric_vs_oracle(port, states, ps, [me, "node-0-5"], solver=solver)
    assert solver.last_fabric_stats["n_trips"] >= 2 * cold + 1


def test_fabric_refuses_a_wider_mesh_and_no_card(port):
    """A mesh of more than one device (a list of devices, made into a
    mesh as ``make_mesh`` factors it; here two CPU logical shards, batch
    2) splits the roots and gives the one-device step's arrays, and the
    solver's fabric RIB on it equals the oracle's; without a CUDA device
    the step and the solver still refuse, unless given the CPU. The name
    stays from when the wider mesh was refused too: the test id is
    kept, its no-card half unchanged."""
    plan, matrix, pplan, pmatrix, roots, out_nbr, out_w = _cell(port,
                                                                 "grid6")
    wide = port.sharding.sharded_fabric_step(["cpu", "cpu"], pplan, pmatrix,
                                             roots, out_nbr, out_w, 4)
    got = port.sharding.sharded_fabric_step(["cpu"], pplan, pmatrix, roots,
                                            out_nbr, out_w, 4)
    assert got[0].device.type == "cpu"
    for a, b in zip(wide, got):
        assert port.torch.equal(a, b)
    if not port.torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.sharding.sharded_fabric_step(None, pplan, pmatrix, roots,
                                              out_nbr, out_w, 4)
    (states, ps), _ = _port_states(port, lambda: port.topologies.grid(4))
    solver = port.gpu_solver.GpuSpfSolver("node-0-0", device="cpu")
    dbs = solver.build_fabric_route_dbs(["node-0-0"], states, ps,
                                        mesh=["cpu", "cpu"])
    assert solver.last_fabric_stats["mesh"] == {"batch": 2, "graph": 1}
    want = port.spf_solver.SpfSolver("node-0-0").build_route_db(
        "node-0-0", states, ps)
    assert list(dbs) == ["node-0-0"]
    assert dict(dbs["node-0-0"].unicast_routes.items()) == dict(
        want.unicast_routes.items())
