"""The port's multichip tier (openr_tpu_torch/parallel/sharding.py: the
mesh, ``mc_sssp``, ``mc_incremental_sssp``, ``sharded_fabric_step``;
``decision/gpu_solver.mc_pipeline`` and the solver's tier; K23
``ops/combine.shard_combine``; ``entry.dryrun_multichip``).

Against the JAX package, on ``make_mesh(8)`` over the suite's 8 virtual
CPU devices (batch 4 x graph 2), four shard-mapped executables and no
more, each compiled once for the module: ``make_mc_sssp`` (bucketed)
and ``make_mc_incremental_sssp`` (sync) on a residual ``random_mesh``,
``tpu_solver._mc_pipeline.__wrapped__`` (bucketed, LFA on) on the same
cell, and ``sharded_fabric_step`` on a small fabric. No ``TpuSpfSolver``
is built and no other JAX mesh. Tolerance 0 throughout: distances,
trips, rounds, cone and fell_back byte for byte (the reference reports
each batch group's first 'graph' member's bucketed rounds, and so does
the port).

Everything else runs on the port's side, on meshes of ``"cpu"`` logical
shards (the plain versions): other shard counts and batch / graph
splits, K23's plain version, ``GpuSpfSolver(device="cpu")`` on a mesh
and ``dryrun_multichip``. Those are held to the port's own one-device
results and its ``SpfSolver``, which earlier files hold to JAX. Inputs
come from seeded numpy generators and the package's topology makers.
"""

import types

import numpy as np
import pytest

from openr_tpu.models import topologies
from openr_tpu.ops.csr import build_prefix_matrix
from openr_tpu.ops.edgeplan import build_plan
from tests.test_torch_solver import assert_rib_equal, to_port
from tests.torch_jax_state import jax_state_barrier  # noqa: F401

INF = 1 << 29
D_CAP = 4  # the root tables' lanes, a multiple of make_mesh(8)'s batch
# (n devices, batch) -> the ('batch', 'graph') shape the reference's
# make_mesh gives (openr_tpu/parallel/sharding.py:42-67: graph 2 when
# n >= 4 and even, else 1, unless batch is given)
MESH_SHAPES = {(1, None): (1, 1), (2, None): (2, 1), (4, None): (2, 2),
               (6, None): (3, 2), (8, None): (4, 2), (8, 2): (2, 4),
               (6, 2): (2, 3)}
# the port-only mesh sweeps: shard counts 1, 2, 4, 8 and the (8, 2) split
PORT_MESHES = [(1, None), (2, None), (4, None), (8, None), (8, 2)]


@pytest.fixture(scope="module")
def port():
    """The port's modules, with torch held to one thread while this
    module's tests run."""
    import torch

    from openr_tpu_torch import entry, types as ptypes, weights
    from openr_tpu_torch.decision import gpu_solver, spf_solver
    from openr_tpu_torch.models import topologies as ptopo
    from openr_tpu_torch.ops import combine, fabric, relax
    from openr_tpu_torch.parallel import sharding

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(
        torch=torch, types=ptypes, weights=weights, gpu_solver=gpu_solver,
        spf_solver=spf_solver, topologies=ptopo, sharding=sharding,
        combine=combine, fabric=fabric, relax=relax, entry=entry,
    )
    torch.set_num_threads(prev)


def _cpu_mesh(port, n=8, batch=None):
    return port.sharding.make_mesh(n, batch=batch, devices=["cpu"] * n)


CELLS = {
    "mesh40": lambda: topologies.random_mesh(40, 3, seed=4),  # residual
    "grid6": lambda: topologies.grid(6),  # shift classes only
}


class Cell:
    """One LSDB's JAX host mirror, prefix matrix and root tables."""

    def __init__(self, name):
        adj_dbs, pdbs = CELLS[name]()
        states, self.ps = topologies.build_states(adj_dbs, pdbs)
        self.ls = states["0"]
        self.plan = build_plan(self.ls)
        self.matrix = build_prefix_matrix(self.ps, self.plan.node_index, "0")
        self.solved = {}  # the one-device solves, shared by the mesh cases

    def args(self, root: int, w_shift=None, w_res=None) -> tuple:
        """``make_mc_sssp``'s arguments for vantage ``root`` (the root
        tables cut or padded to D_CAP lanes), over new weight planes
        when given."""
        plan = self.plan
        nbr, w, _ = plan.out_links(self.ls, plan.node_names[root])
        nbr = np.pad(nbr, (0, max(0, D_CAP - nbr.shape[0])),
                     constant_values=-1)[:D_CAP]
        w = np.pad(w, (0, max(0, D_CAP - w.shape[0])),
                   constant_values=INF)[:D_CAP]
        return (plan.deltas,
                plan.shift_w if w_shift is None else w_shift,
                plan.res_rows, plan.res_nbr,
                plan.res_w if w_res is None else w_res,
                np.int32(plan.node_index[plan.node_names[root]]), nbr, w)

    def static(self, kernel: str) -> dict:
        from openr_tpu_torch.ops.relax import max_trips

        plan = self.plan
        de = max(plan.delta_exp, 1) if kernel == "bucketed" else 0
        return dict(s_cap=plan.s_cap, has_res=plan.k_res > 0,
                    n_cap=plan.n_cap, d_cap=D_CAP,
                    max_trips=max_trips(plan.n_cap), kernel=kernel,
                    delta_exp=de)

    def churn(self, seed: int, cap: int = 64):
        """New weight planes (4 shift slots up, 2 down, 2 residual slots
        up) and the padded dirty tuples of the change."""
        plan = self.plan
        rng = np.random.default_rng(seed)
        old_sw, old_rw = plan.shift_w, plan.res_w
        pick = rng.choice(np.flatnonzero(old_sw.ravel() < INF), 6,
                          replace=False)
        new_sw = old_sw.copy().ravel()
        new_sw[pick[:4]] += 7
        new_sw[pick[4:]] = np.maximum(new_sw[pick[4:]] - 1, 1)
        sdi = np.full(cap, plan.s_cap * plan.n_cap, np.int32)
        sdo = np.zeros(cap, np.int32)
        sdi[:6], sdo[:6] = pick, old_sw.ravel()[pick]
        rdi = np.full(cap, old_rw.size, np.int32)
        rdo = np.zeros(cap, np.int32)
        new_rw = old_rw.copy().ravel()
        if plan.k_res > 0:
            rp = rng.choice(np.flatnonzero(old_rw.ravel() < INF), 2,
                            replace=False)
            new_rw[rp] += 11
            rdi[:2], rdo[:2] = rp, old_rw.ravel()[rp]
        return (new_sw.reshape(old_sw.shape), new_rw.reshape(old_rw.shape),
                (sdi, sdo, rdi, rdo))


@pytest.fixture(scope="module")
def cells():
    return {name: Cell(name) for name in CELLS}


# -- the JAX side: four executables on make_mesh(8) ------------------------

@pytest.fixture(scope="module")
def jmesh():
    from openr_tpu.parallel.sharding import make_mesh

    return make_mesh(8)


@pytest.fixture(scope="module")
def jax_mc_sssp(jmesh, cells):
    """Executable 1: ``make_mc_sssp`` bucketed on mesh40."""
    import jax
    from openr_tpu.parallel.sharding import make_mc_sssp

    st = cells["mesh40"].static("bucketed")
    return jax.jit(make_mc_sssp(jmesh, *st.values()))


@pytest.fixture(scope="module")
def jax_mc_incr(jmesh, cells):
    """Executable 2: ``make_mc_incremental_sssp`` sync on mesh40."""
    import jax
    from openr_tpu.parallel.sharding import make_mc_incremental_sssp

    st = cells["mesh40"].static("sync")
    return jax.jit(make_mc_incremental_sssp(jmesh, *st.values()))


@pytest.fixture(scope="module")
def cold_planes(jax_mc_sssp, cells):
    """The converged mesh40 planes of roots 0, 3, 5 and 7 (the distance
    fixpoint is unique: bucketed's equal sync's)."""
    out = {}
    for root in (0, 3, 5, 7):
        args = cells["mesh40"].args(root)
        out[root] = (args, [np.asarray(a) for a in jax_mc_sssp(*args)])
    return out


def _planes(port, grid):
    """The lanes of a port planes grid in batch order (member 0 of each
    group), after checking the members of each group hold equal planes."""
    torch = port.torch
    for row in grid:
        for t in row[1:]:
            assert torch.equal(row[0], t)
    return torch.cat([row[0] for row in grid]).numpy()


def test_mc_sssp_bucketed_matches_jax(port, jmesh, cells, cold_planes):
    """dist, trips and rounds of ``mc_sssp`` (bucketed) equal
    ``make_mc_sssp``'s on make_mesh(8) from four vantages of a residual
    random mesh; the port's make_mesh(8) has the JAX mesh's shape."""
    mesh = _cpu_mesh(port)
    assert dict(mesh.shape) == dict(jmesh.shape)
    st = cells["mesh40"].static("bucketed")
    for root, (args, (jd, jt, jr)) in cold_planes.items():
        grid, trips, rounds = port.sharding.mc_sssp(
            mesh, **port.weights.mc_inputs_from_jax(mesh, args), **st)
        np.testing.assert_array_equal(_planes(port, grid), jd)
        assert trips == jt.tolist(), (root, trips)
        assert rounds == jr.tolist(), (root, rounds)


@pytest.mark.parametrize("root,limit", [(3, 1 << 20), (7, 0), (0, 1 << 20)])
def test_mc_incremental_sync_matches_jax(port, cells, cold_planes,
                                         jax_mc_incr, root, limit):
    """dist, trips, cone, fell_back and rounds of ``mc_incremental_sssp``
    (sync) equal ``make_mc_incremental_sssp``'s after seeded metric
    churn, warm (a large cone budget) and falling back (budget 0). The
    parents are the reference's multichip ones (the max over members),
    so the cone is its, not the single-card K6's."""
    cell = cells["mesh40"]
    args, (prev, _, _) = cold_planes[root]
    new_sw, new_rw, dirty = cell.churn(seed=root + 11)
    iargs = (*cell.args(root, new_sw, new_rw), prev, *dirty,
             np.int32(limit))
    jd, jt, jc, jf, jr = (np.asarray(a) for a in jax_mc_incr(*iargs))
    mesh = _cpu_mesh(port)
    grid, trips, cone, fell, rounds = port.sharding.mc_incremental_sssp(
        mesh, **port.weights.mc_inputs_from_jax(mesh, iargs),
        **cell.static("sync"))
    np.testing.assert_array_equal(_planes(port, grid), jd)
    assert trips == jt.tolist()
    assert rounds == jr.tolist()
    assert (int(cone), int(fell)) == (int(jc[0]), int(jf[0]))
    assert int(fell) == int(limit == 0) and int(cone) > 0


def _single_sssp(port, cell, key, args, st):
    """The port's one-device SSSP on the same inputs (held to JAX's
    ``plan_sssp`` by tests/test_torch_relax.py), once per ``key`` and
    kernel for the module."""
    key = (key, st["kernel"])
    if key not in cell.solved:
        t = [port.torch.tensor(np.asarray(a)) for a in args]
        cell.solved[key] = port.relax.plan_sssp(
            *t[:5], int(args[5]), t[6], t[7], st["has_res"], st["kernel"],
            st["delta_exp"])
    return cell.solved[key]


@pytest.mark.parametrize("n,batch", PORT_MESHES)
@pytest.mark.parametrize("name", ["mesh40", "grid6"])
def test_mc_sssp_equals_one_device_on_every_mesh(port, cells, name, n,
                                                 batch):
    """On 1, 2, 4 and 8 CPU logical shards and the (8, 2) split, both
    kernels' planes equal the port's one-device SSSP from two vantages;
    under sync the slowest group's trips and rounds equal the one-device
    loop's (a combined relaxation is one whole relaxation)."""
    cell = cells[name]
    mesh = _cpu_mesh(port, n, batch)
    for kernel in ("sync", "bucketed"):
        st = cell.static(kernel)
        for root in (0, 7):
            args = cell.args(root)
            grid, trips, rounds = port.sharding.mc_sssp(
                mesh, **port.weights.mc_inputs_from_jax(mesh, args), **st)
            dist, s_trips, s_rounds = _single_sssp(port, cell, root, args,
                                                   st)
            np.testing.assert_array_equal(_planes(port, grid), dist.numpy())
            assert len(trips) == len(rounds) == mesh.shape["batch"]
            if kernel == "sync":
                assert (max(trips), max(rounds)) == (s_trips, s_rounds)


@pytest.mark.parametrize("n,batch", PORT_MESHES)
def test_mc_incremental_equals_cold_on_every_mesh(port, cells, n, batch):
    """The incremental mc SSSP on every mesh, both kernels, warm and
    falling back: its planes equal the one-device cold SSSP over the new
    weights, and it falls back exactly when the budget is 0."""
    cell = cells["mesh40"]
    mesh = _cpu_mesh(port, n, batch)
    new_sw, new_rw, dirty = cell.churn(seed=23)
    for kernel, root, limit in (("bucketed", 5, 1 << 20), ("sync", 3, 0),
                                ("bucketed", 7, 0), ("sync", 0, 1 << 20)):
        st = cell.static(kernel)
        prev, _, _ = _single_sssp(port, cell, root, cell.args(root), st)
        new_args = cell.args(root, new_sw, new_rw)
        want, _, _ = _single_sssp(port, cell, (root, 23), new_args, st)
        iargs = (*new_args, prev.numpy(), *dirty, np.int32(limit))
        grid, trips, cone, fell, rounds = port.sharding.mc_incremental_sssp(
            mesh, **port.weights.mc_inputs_from_jax(mesh, iargs), **st)
        np.testing.assert_array_equal(_planes(port, grid), want.numpy())
        assert int(fell) == int(limit == 0) and int(cone) > 0, (kernel, root)


def _mirror(port, mesh, plan):
    sh = port.sharding
    lay = sh.plan_shardings(mesh, plan.n_cap, plan.res_rows.shape[0], 0)
    return {
        "deltas": sh.place(mesh, plan.deltas, lay["replicated"]),
        "shift_w": sh.place(mesh, plan.shift_w, lay["shift_w"]),
        "res_rows": sh.place(mesh, plan.res_rows, lay["res_rows"]),
        "res_nbr": sh.place(mesh, plan.res_nbr, lay["res_2d"]),
        "res_w": sh.place(mesh, plan.res_w, lay["res_2d"]),
    }


def test_mc_pipeline_buffers_match_jax(port, jmesh, cells):
    """The mc pipeline's pull buffers, resident outputs and distance
    plane equal ``tpu_solver._mc_pipeline``'s on make_mesh(8) (bucketed,
    LFA on). After churn, scattered into the owning shards in place
    (K5 [mc]), the incremental mc pipeline's buffers equal the port's
    one-device incremental pipeline's but for the counters, and its
    cone and fell_back equal ``mc_incremental_sssp``'s."""
    from openr_tpu.decision import tpu_solver
    from openr_tpu_torch.ops.incremental import scatter_window_plain

    torch = port.torch
    gs = port.gpu_solver
    cell = cells["mesh40"]
    plan, matrix = cell.plan, cell.matrix
    args = cell.args(5)
    _, mbuf = tpu_solver._pack_matrix(matrix, plan.node_overloaded)
    p_cap, a_cap = matrix.ann_node.shape
    st = cell.static("bucketed")
    r_cap, kr_cap = plan.res_nbr.shape
    wa, wd = -(-a_cap // 16), -(-D_CAP // 16)
    prev = [np.zeros(p_cap, np.int32), np.zeros((p_cap, wa), np.int32),
            np.zeros((p_cap, wd), np.int32), np.zeros(p_cap, np.int32),
            np.zeros(p_cap, np.int32)]
    cold = tpu_solver._mc_pipeline.__wrapped__(
        jmesh, plan.n_cap, plan.s_cap, r_cap, kr_cap, st["has_res"], D_CAP,
        p_cap, a_cap, tpu_solver._DELTA_BUDGET, True, False, True, True,
        "bucketed", st["delta_exp"])
    want = [np.asarray(a)
            for a in cold(*args[:5], mbuf, *args[5:], *prev)]

    mesh = _cpu_mesh(port)
    mirror = _mirror(port, mesh, plan)
    kw = dict(has_res=st["has_res"], n_cap=plan.n_cap, s_cap=plan.s_cap,
              kernel="bucketed", delta_exp=st["delta_exp"], lfa=True)
    mbuf_t = torch.tensor(mbuf)
    out, info = gs.mc_pipeline(mesh, mirror, mbuf_t, int(args[5]), args[6],
                               args[7], *(torch.tensor(a) for a in prev),
                               **kw)
    got = [out.delta_buf, out.full_buf, out.metric, out.s3w, out.nhw,
           out.lfa_slot, out.lfa_metric]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(_planes(port, out.dist), want[7])
    assert info.halo_exchanges == out.trips > 0
    assert sorted(info.shard_end) == [f"{b}.{g}" for b in range(4)
                                      for g in range(2)]

    # churn: the dirty slots scattered into the shards that own them,
    # every part a card holds in one multi-part call (K5 [mc]), equal to
    # the per-part scatter
    new_sw, new_rw, dirty = cell.churn(seed=5)
    for name, old, new in (("shift_w", plan.shift_w, new_sw),
                           ("res_w", plan.res_w, new_rw)):
        flat = np.flatnonzero(new.ravel() != old.ravel()).astype(np.int32)
        each = [(t.clone(), mirror[name].window(b, g)[0])
                for b, g, t in mirror[name].distinct()]
        calls = []

        def idx_on(dev, f=flat, a=new):
            calls.append(dev)
            return torch.tensor(f), torch.tensor(a.ravel()[f])

        port.sharding.scatter_sharded(mirror[name], idx_on)
        (targets,) = port.sharding._scatter_targets(mirror[name]).values()
        assert len(calls) == 1 and len(targets[0]) == len(each) > 1
        shape2 = new.shape if new.ndim == 2 else (1, new.size)
        f_t, v_t = torch.tensor(flat), torch.tensor(new.ravel()[flat])
        for (t, lo), part in zip(each, targets[0]):
            win = (lo, 0) if mirror[name].layout.axis == 0 else (0, lo)
            scatter_window_plain(t.view(part.shape), f_t, v_t, shape2, *win)
            assert torch.equal(t.view(part.shape), part)
        axis = mirror[name].layout.axis
        for b, g, t in mirror[name].distinct():
            lo, hi = mirror[name].window(b, g)
            np.testing.assert_array_equal(
                t.numpy(), np.take(new, range(lo, hi), axis=axis))
    limit = 1 << 20
    out_i, _ = gs.mc_pipeline(
        mesh, mirror, mbuf_t, int(args[5]), args[6], args[7], *got[2:7],
        incr=(out.dist, *dirty, limit), **kw)
    t = [torch.tensor(np.asarray(a)) for a in args[:5]]
    t[1], t[4] = torch.tensor(new_sw), torch.tensor(new_rw)
    one = gs.pipeline(*t, mbuf_t, int(args[5]), torch.tensor(args[6]),
                      torch.tensor(args[7]), *got[2:7],
                      incr=(torch.tensor(want[7]),
                            *(torch.tensor(d) for d in dirty), limit),
                      has_res=st["has_res"], kernel="bucketed",
                      delta_exp=st["delta_exp"], lfa=True)
    # the counters: trips at 1, cone, fell_back and rounds at the tail
    for a, b in ((out_i.delta_buf, one.delta_buf),
                 (out_i.full_buf, one.full_buf)):
        a, b = a.numpy(), b.numpy()
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[2:-3], b[2:-3])
    for a, b in ((out_i.metric, one.metric), (out_i.s3w, one.s3w),
                 (out_i.nhw, one.nhw), (out_i.lfa_slot, one.lfa_slot),
                 (out_i.lfa_metric, one.lfa_metric)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(_planes(port, out_i.dist), one.dist.numpy())
    iargs = (*cell.args(5, new_sw, new_rw), want[7], *dirty,
             np.int32(limit))
    _, _, cone, fell, _ = port.sharding.mc_incremental_sssp(
        mesh, **port.weights.mc_inputs_from_jax(mesh, iargs), **st)
    full = out_i.full_buf.numpy()
    assert (full[-3], full[-2]) == (int(cone), int(fell))
    assert full[-3] > 0 and full[-2] == 0


def _fabric_cell(name):
    adj_dbs, pdbs = {
        "mesh40": CELLS["mesh40"],
        "fabric": lambda: topologies.fabric(4, 2, 3, 4),  # residual ELL
    }[name]()
    states, ps = topologies.build_states(adj_dbs, pdbs)
    plan = build_plan(states["0"])
    matrix = build_prefix_matrix(ps, plan.node_index, "0")
    return plan, matrix, states["0"]


@pytest.fixture(scope="module")
def fabric_cells(port):
    out = {}
    for name in ("fabric", "mesh40"):
        plan, matrix, ls = _fabric_cell(name)
        tables = port.fabric.root_tables(plan, ls, plan.node_names)[:3]
        out[name] = (plan, matrix, *tables)
    return out


def test_mesh_fabric_step_matches_jax(port, jmesh, fabric_cells):
    """All seven arrays of the port's ``sharded_fabric_step`` on 8 CPU
    logical shards equal the reference's on make_mesh(8), LFA on, over a
    fabric with a residual ELL, from 16 roots (4 a batch group)."""
    from openr_tpu.parallel.sharding import sharded_fabric_step

    plan, matrix, roots, out_nbr, out_w = fabric_cells["fabric"]
    tables = (roots[:16], out_nbr[:16], out_w[:16])
    want = sharded_fabric_step(jmesh, plan, matrix, *tables, 4, lfa=True,
                               with_ok=True)
    got = port.sharding.sharded_fabric_step(
        _cpu_mesh(port), plan, matrix, *tables, 4, lfa=True, with_ok=True)
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert w.shape == tuple(g.shape) and w.dtype == g.numpy().dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("name,n,batch", [
    ("mesh40", 2, None), ("fabric", 4, None), ("fabric", 6, 2),
    ("mesh40", 8, 2)])
def test_mesh_fabric_step_equals_one_device(port, fabric_cells, name, n,
                                            batch):
    """On other meshes (graph 3 pads the node axis with INF_E columns)
    the step's seven arrays equal the port's one-device step's from 12
    roots, LFA on; the mesh's shape is the reference's factoring."""
    plan, matrix, roots, out_nbr, out_w = fabric_cells[name]
    mesh = _cpu_mesh(port, n, batch)
    assert (mesh.shape["batch"], mesh.shape["graph"]) == MESH_SHAPES[
        (n, batch)]
    tables = (roots[:12], out_nbr[:12], out_w[:12])
    got = port.sharding.sharded_fabric_step(mesh, plan, matrix, *tables, 4,
                                            lfa=True, with_ok=True)
    want = port.sharding.sharded_fabric_step(["cpu"], plan, matrix, *tables,
                                             4, lfa=True, with_ok=True)
    n_pad = -(-plan.n_cap // mesh.shape["graph"]) * mesh.shape["graph"]
    assert got[0].shape[1] == n_pad
    assert bool((got[0][:, plan.n_cap:] == INF).all())
    for g, w in zip((got[0][:, :plan.n_cap],) + tuple(got[1:]), want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_mesh_fabric_unconverged_matches_one_device(port, fabric_cells):
    """At n_trips 1 the step on 4 shards raises Unconverged for the same
    roots as the one-device step (whose vote tests/test_torch_fabric.py
    holds to JAX's)."""
    import re

    plan, matrix, roots, out_nbr, out_w = fabric_cells["mesh40"]
    errs = []
    for mesh in (_cpu_mesh(port, 4), ["cpu"]):
        with pytest.raises(port.sharding.Unconverged) as err:
            port.sharding.sharded_fabric_step(mesh, plan, matrix, roots,
                                              out_nbr, out_w, 1, lfa=True)
        errs.append(re.search(r"roots \[([^\]]*)\]", str(err.value)).group(1))
    assert errs[0] == errs[1] != ""


@pytest.mark.parametrize("n,batch", sorted(MESH_SHAPES, key=str))
def test_make_mesh_factors_as_the_reference(port, n, batch):
    """The port factors n devices as the reference's make_mesh does, in
    device order, batch-major; a batch that does not divide raises."""
    mesh = _cpu_mesh(port, n, batch)
    assert (mesh.shape["batch"], mesh.shape["graph"]) == MESH_SHAPES[
        (n, batch)]
    assert mesh.size == n and len(list(mesh.shards())) == n
    with pytest.raises(ValueError):
        port.sharding.make_mesh(n, batch=n + 1, devices=["cpu"] * n)
    with pytest.raises(ValueError):
        port.sharding.make_mesh(n + 1, devices=["cpu"] * n)


def test_plan_shardings_replicates_an_axis_that_does_not_split(port):
    """``plan_shardings`` splits the shift columns over 'graph', the
    residual rows over 'graph' and the lanes over 'batch', and keeps an
    axis that does not divide whole on every shard (the reference's
    fallback); ``place`` then holds one tensor a distinct part."""
    sh = port.sharding
    mesh = _cpu_mesh(port, 6, 2)  # batch 2 x graph 3
    lay = sh.plan_shardings(mesh, 96, 9, 4)
    assert lay["shift_w"] == sh.Layout(1, "graph")
    assert lay["res_rows"] == lay["res_2d"] == sh.Layout(0, "graph")
    assert lay["root_vec"] == lay["dist"] == sh.Layout(0, "batch")
    lay = sh.plan_shardings(mesh, 64, 8, 3)
    for role in ("shift_w", "res_rows", "res_2d", "root_vec", "dist"):
        assert lay[role] == sh.REPLICATED, role
    arr = np.arange(2 * 96, dtype=np.int32).reshape(2, 96)
    placed = sh.place(mesh, arr, sh.Layout(1, "graph"))
    assert len(list(placed.distinct())) == 3
    assert placed.nbytes() == arr.nbytes
    np.testing.assert_array_equal(sh.gather(placed, 1, 2).numpy(), arr)


@pytest.mark.parametrize("op", ["min", "max", "sum"])
def test_shard_combine_plain(port, op):
    """K23's plain version: the min / max / sum over the members (a sum
    wraps modulo 2^32, as psum's int32 add), each member left holding
    the result, the flag set only where it differs from ``ref``."""
    torch = port.torch
    rng = np.random.default_rng(7)
    planes = [torch.tensor(rng.integers(0, 50, (3, 5)), dtype=torch.int32)
              for _ in range(3)]
    planes[0][0, 0] = (1 << 31) - 1
    ref = {"min": np.minimum, "max": np.maximum, "sum": np.add}[op]
    want = ref.reduce([p.numpy() for p in planes], dtype=np.int32)
    flag = torch.zeros(1, dtype=torch.int32)
    port.combine.shard_combine(planes, op, ref=torch.tensor(want), flag=flag)
    assert int(flag) == 0
    for p in planes:
        np.testing.assert_array_equal(p.numpy(), want)
    port.combine.shard_combine(planes, op, ref=torch.tensor(want), flag=flag)
    assert int(flag) == int(op == "sum")
    with pytest.raises(ValueError):
        port.combine.shard_combine(planes, "prod")


@pytest.mark.parametrize("op", ["min", "max", "sum"])
def test_shard_combine_groups_plain(port, op):
    """The grouped combine's plain form, and the grouped wrapper on CPU
    tensors: every group (1 to 8 groups of 1 to 16 members, widths 0 and
    not a multiple of 4) holds ``shard_combine_plain`` of its own
    members, each group's flag is set only where its result differs
    from its ref, and each ``also`` group is combined by ``also_op``."""
    torch = port.torch
    comb = port.combine
    rng = np.random.default_rng(23)
    fold = {"min": np.minimum, "max": np.maximum, "sum": np.add}[op]
    for n_groups, members, width in ((1, 1, 7), (3, 2, 5), (8, 16, 13),
                                     (2, 4, 0), (4, 2, 9)):
        def planes(n):
            return [[rng.integers(-50, 50, n).astype(np.int32)
                     for _ in range(members)] for _ in range(n_groups)]

        groups, also = planes(width), planes(width + 2)
        folded = [fold.reduce(p, dtype=np.int32) for p in groups]
        # group 0's ref is its result (flag stays 0), the others differ
        refs = [f if q == 0 else f + 1 for q, f in enumerate(folded)]
        want_also = [np.minimum.reduce(p) for p in also]
        for fn in (comb.shard_combine_groups_plain, comb.shard_combine_groups):
            got = [[torch.tensor(a) for a in p] for p in groups]
            got_also = [[torch.tensor(a) for a in p] for p in also]
            flags = [torch.zeros(1, dtype=torch.int32) for _ in groups]
            fn(got, op, [torch.tensor(r) for r in refs], flags, got_also,
               "min")
            for q in range(n_groups):
                for t in got[q]:
                    np.testing.assert_array_equal(t.numpy(), folded[q])
                for t in got_also[q]:
                    np.testing.assert_array_equal(t.numpy(), want_also[q])
                assert int(flags[q]) == int(q > 0 and width > 0), (q, width)
            # the one-group call is the grouped call of one group
            one = [torch.tensor(a) for a in groups[-1]]
            comb.shard_combine(one, op)
            np.testing.assert_array_equal(one[0].numpy(), folded[-1])
    with pytest.raises(ValueError):
        comb.shard_combine_groups([[torch.zeros(3, dtype=torch.int32)]],
                                  "min", also=[])


def _port_lsdb(port, gen):
    adj_dbs, pdbs = gen()
    pstates, pps = port.topologies.build_states(
        to_port(adj_dbs, port.types), to_port(pdbs, port.types))
    return adj_dbs, pstates, pps


def _churn_node(port, ls, victim, bump):
    ls.update_adjacency_database(port.types.AdjacencyDatabase(
        this_node_name=victim.this_node_name,
        adjacencies=tuple(port.types.Adjacency(**{
            **a.__dict__, "metric": a.metric + bump})
            for a in victim.adjacencies),
        area="0"))


@pytest.mark.parametrize("incr", [False, True])
def test_multichip_production_path_parity(port, incr):
    """``build_route_db`` through the multichip tier (threshold below the
    area's n_cap, 8 CPU logical shards, batch 4): the RIB equals the
    port's oracle and its single-device solve, LFA backups included,
    through a cold solve, metric churn, restore, a link flap and its
    restore (tests/test_sharding.py:191-255 in the port's types); the
    tier's stats and counters as asserted there."""
    from openr_tpu_torch.runtime.counters import counters

    adj_dbs, states, ps = _port_lsdb(port, lambda: topologies.grid(8))
    adj_dbs = to_port(adj_dbs, port.types)
    root = adj_dbs[0].this_node_name
    ls = states["0"]
    gs = port.gpu_solver
    cpu = port.spf_solver.SpfSolver(root, enable_lfa=True)
    single = gs.GpuSpfSolver(root, device="cpu", enable_lfa=True,
                             incremental_spf=incr)
    mc = gs.GpuSpfSolver(root, device="cpu", enable_lfa=True,
                         incremental_spf=incr, multichip_n_cap_threshold=32,
                         multichip_batch=4, multichip_devices=["cpu"] * 8)
    eng0 = counters.get_counter("decision.solver.multichip.engaged") or 0

    def check(ctx):
        mc_db = mc.build_route_db(root, states, ps)
        assert_rib_equal(cpu.build_route_db(root, states, ps), mc_db,
                         f"mc vs oracle: {ctx}")
        assert_rib_equal(single.build_route_db(root, states, ps), mc_db,
                         f"mc vs single-device: {ctx}")

    check("cold")
    info = mc.last_timing["multichip"]
    assert info["shards"] == 8 and info["batch"] == 4 and info["graph"] == 2
    assert len(info["shard_ms"]) == 8
    assert mc.last_device_stats["multichip"]["shards"] == 8
    assert counters.get_counter("decision.solver.multichip.shards") == 8
    _churn_node(port, ls, adj_dbs[1], 7)
    check("metric churn")
    if incr:
        st = mc.last_device_stats
        assert st["incremental"] and not st["fell_back"], st
    _churn_node(port, ls, adj_dbs[1], 0)
    check("restore")
    victim = adj_dbs[5]
    ls.update_adjacency_database(port.types.AdjacencyDatabase(
        this_node_name=victim.this_node_name, adjacencies=(), area="0"))
    check("flap down")
    ls.update_adjacency_database(port.types.AdjacencyDatabase(
        this_node_name=victim.this_node_name,
        adjacencies=tuple(port.types.Adjacency(**{**a.__dict__, "metric": 3})
                          for a in victim.adjacencies), area="0"))
    check("flap restore")
    eng1 = counters.get_counter("decision.solver.multichip.engaged") or 0
    assert eng1 == eng0 + 5, (eng0, eng1)


def test_multichip_halo_per_relaxation_and_per_epoch(port):
    """halo_exchanges == rounds under sync, == bucket epochs under
    bucketed, and fewer (tests/test_relax.py:282-299)."""
    _, states, ps = _port_lsdb(
        port, lambda: topologies.grid(4, node_labels=False))
    kw = dict(device="cpu", multichip_n_cap_threshold=4, multichip_batch=4,
              multichip_devices=["cpu"] * 8)
    gs = port.gpu_solver
    sync = gs.GpuSpfSolver("node-1-1", spf_kernel="sync", **kw)
    buck = gs.GpuSpfSolver("node-1-1", spf_kernel="bucketed", **kw)
    sync.build_route_db("node-1-1", states, ps)
    buck.build_route_db("node-1-1", states, ps)
    s_st, b_st = sync.last_device_stats, buck.last_device_stats
    assert s_st["halo_exchanges"] == s_st["rounds"] > 0, s_st
    assert b_st["spf_kernel"] == "bucketed"
    assert b_st["halo_exchanges"] == b_st["bucket_epochs"] > 0, b_st
    assert b_st["halo_exchanges"] < s_st["halo_exchanges"]
    assert buck.last_timing["halo_exchanges"] == b_st["halo_exchanges"]


def test_multichip_tier_off_below_threshold_and_flip_falls_back_once(port):
    """Below the threshold the tier never engages. Above it, turning
    ``force_single_chip`` on and off flips the area's placement: each
    flip re-puts the mirror, and the next incremental solve after it
    takes the cold seed exactly once."""
    adj_dbs, states, ps = _port_lsdb(port, lambda: topologies.grid(8))
    root = "node-0-0"
    gs = port.gpu_solver
    off = gs.GpuSpfSolver(root, device="cpu", multichip_devices=["cpu"] * 8)
    off.build_route_db(root, states, ps)
    assert not off.last_timing.get("multichip")
    assert "multichip" not in off.last_device_stats
    assert off._area_dev["0"].mc_mesh is None

    oracle = port.spf_solver.SpfSolver(root)
    mc = gs.GpuSpfSolver(root, device="cpu", incremental_spf=True,
                         multichip_n_cap_threshold=32,
                         multichip_devices=["cpu"] * 4)
    ls = states["0"]
    victim = next(db for db in to_port(adj_dbs, port.types)
                  if db.this_node_name == "node-3-3")
    seq = []
    for step, single in enumerate((False, False, True, True, False, False)):
        mc.force_single_chip = single
        _churn_node(port, ls, victim, step % 3)
        db = mc.build_route_db(root, states, ps)
        assert_rib_equal(oracle.build_route_db(root, states, ps), db, step)
        st = mc.last_device_stats
        seq.append((bool(st.get("multichip")), bool(st.get("incremental"))))
    assert seq == [(True, False), (True, True), (False, False),
                   (False, True), (True, False), (True, True)], seq


def test_mc_mesh_for_keeps_the_reference_rungs(port):
    """``_mc_mesh_for``: a mesh whose graph axis does not divide the
    area's n_cap keeps the tier off (a 6-shard mesh of batch 2 has graph
    3; n_cap 64), and the area solves on one device, equal to the
    oracle; the threshold is compared strictly (n_cap == threshold stays
    off)."""
    _, states, ps = _port_lsdb(port, lambda: topologies.grid(6))
    root = "node-0-0"
    gs = port.gpu_solver
    s = gs.GpuSpfSolver(root, device="cpu", multichip_n_cap_threshold=16,
                        multichip_batch=2, multichip_devices=["cpu"] * 6)
    assert s._mc_mesh_for(64) is None and s._mc_mesh_for(96) is not None
    db = s.build_route_db(root, states, ps)
    assert s._area_dev["0"].plan.n_cap == 64
    assert s._area_dev["0"].mc_mesh is None
    assert_rib_equal(port.spf_solver.SpfSolver(root).build_route_db(
        root, states, ps), db)
    s = gs.GpuSpfSolver(root, device="cpu", multichip_n_cap_threshold=64,
                        multichip_devices=["cpu"] * 2)
    assert s._mc_mesh_for(64) is None
    assert s._mc_mesh_for(128).shape == {"batch": 2, "graph": 1}


def test_dryrun_multichip_cpu(port, capsys):
    """The port's dry run on 8 CPU logical shards passes its three
    oracles and prints the reference's line; without a CUDA device the
    dry run and a mesh of the visible cards raise unless given the
    CPU."""
    line = port.entry.dryrun_multichip(8, device="cpu")
    assert line.startswith("dryrun_multichip ok: mesh={'batch': 4, "
                           "'graph': 2} roots=8 nodes=1024")
    assert line in capsys.readouterr().out
    if not port.torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.entry.dryrun_multichip(8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.sharding.make_mesh(8)


def test_one_device_paths_read_the_tier_mirror_gathered(port):
    """Paths that solve on one card (a what-if sweep, a one-device
    whole-fabric step) on an area the multichip tier holds read its
    mirror gathered whole, and answer as on a one-device solver."""
    from openr_tpu_torch.decision import whatif

    _, states, ps = _port_lsdb(port, lambda: topologies.grid(6))
    root = "node-0-0"
    gs = port.gpu_solver
    mc = gs.GpuSpfSolver(root, device="cpu", multichip_n_cap_threshold=16,
                         multichip_devices=["cpu"] * 4)
    one = gs.GpuSpfSolver(root, device="cpu")
    for s in (mc, one):
        s.build_route_db(root, states, ps)
    assert mc._area_dev["0"].mc_mesh is not None
    rows = [whatif.WhatIfEngine(s).sweep(states, ps)["rows"]
            for s in (mc, one)]
    assert rows[0] == rows[1] and len(rows[0]) > 0
    names = ["node-0-0", "node-3-2", "node-5-5"]
    dbs = [s.build_fabric_route_dbs(names, states, ps, mesh=["cpu"])
           for s in (mc, one)]
    for nm in names:
        assert_rib_equal(dbs[1][nm], dbs[0][nm], nm)
