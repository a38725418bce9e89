"""The port's legacy ELL kernels (openr_tpu_torch/ops/legacy.py,
csrc/legacy.cu: K18 ``ell_relax``, K19 ``ell_next_hop``, K20
``ell_select``), their compositions (``gpu_solver.legacy_pipeline``,
``sssp_batch``, ``sssp_all_pairs``) and the graft entry
(``openr_tpu_torch/entry.py``) against the JAX package's
``decision/tpu_solver.py:177-300`` and ``__graft_entry__.entry``.

The JAX functions are fresh ``jax.jit``s of the raw kernels
(``_sssp_kernel``, ``_next_hop_kernel``, ``_select_kernel``, their vmap
and the pipeline as ``_jitted_pipeline`` composes it, and
``_jitted_sssp_batch``); no ``TpuSpfSolver`` is built. K18's packed
mirror and its trips are also held, on seeded padded mirrors (down
links, overloaded transit nodes and roots, an unreachable component,
metrics up to 2^28, ``n_cap`` not a multiple of 32; R in 1, 31, 33),
to ``UNROLL`` rounds of the padded round ``ell_relax_plain``. Both
packages get the same mirror: the port's tensors carry the JAX
``EllGraph``'s arrays (``weights.ell_from_jax``),
and the port's own ``build_ell`` / ``build_prefix_matrix`` on the same
LSDB in its own types must give those arrays field for field. The port
runs on CPU tensors, so every kernel runs its plain PyTorch version.
All int32 and bool: tolerance 0. Distances are also held to a host
``run_spf``.
"""

import random
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest

import __graft_entry__
from openr_tpu.decision import tpu_solver as jts
from openr_tpu.models import topologies
from openr_tpu.ops.csr import build_ell, build_prefix_matrix
from openr_tpu.types import Adjacency, AdjacencyDatabase, PrefixMetrics
from tests.test_link_state import adj
from tests.test_spf_solver import prefix_db
from tests.test_torch_solver import to_port
from tests.torch_jax_state import jax_state_barrier  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
INF = 1 << 30


@pytest.fixture(scope="module")
def port():
    """The port's modules, with torch held to one thread while this
    module's tests run."""
    import torch

    from openr_tpu_torch import entry, types as ptypes, weights
    from openr_tpu_torch.decision import gpu_solver
    from openr_tpu_torch.models import topologies as ptopo
    from openr_tpu_torch.ops import csr, legacy

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(
        torch=torch, types=ptypes, weights=weights, gpu_solver=gpu_solver,
        topologies=ptopo, csr=csr, legacy=legacy, entry=entry,
    )
    torch.set_num_threads(prev)


# -- scenarios ----------------------------------------------------------------

def _mesh_scenario():
    """random_mesh(24, seed=7) with seeded metrics 1-9, two overloaded
    nodes (node-3, node-5), one link down (node-0's side of node-0 ->
    node-1 overloaded), a parallel link node-2 == node-4 of another
    metric, and anycast prefixes whose announcers differ in path and
    source preference, advertised distance and drain."""
    adj_dbs, pdbs = topologies.random_mesh(24, seed=7)
    rng = random.Random(7)
    metric = {}
    out = []
    for db in adj_dbs:
        me = db.this_node_name
        adjs = []
        for a in db.adjacencies:
            key = tuple(sorted((me, a.other_node_name)))
            w = metric.setdefault(key, rng.randint(1, 9))
            adjs.append(adj(me, a.other_node_name, w, is_overloaded=(
                me == "node-0" and a.other_node_name == "node-1")))
        if me in ("node-2", "node-4"):
            other = "node-4" if me == "node-2" else "node-2"
            adjs.append(Adjacency(
                other_node_name=other, if_name=f"if2-{me}-{other}",
                other_if_name=f"if2-{other}-{me}", metric=2))
        out.append(AdjacencyDatabase(
            this_node_name=me, adjacencies=tuple(adjs), area=db.area,
            is_overloaded=me in ("node-3", "node-5")))
    pdbs = list(pdbs) + [
        prefix_db("node-9", "fd00::100/128",
                  metrics=PrefixMetrics(path_preference=500)),
        prefix_db("node-15", "fd00::100/128",
                  metrics=PrefixMetrics(path_preference=1000)),
        prefix_db("node-11", "fd00::200/128",
                  metrics=PrefixMetrics(distance=3)),
        prefix_db("node-20", "fd00::200/128",
                  metrics=PrefixMetrics(distance=1)),
        prefix_db("node-7", "fd00::300/128",
                  metrics=PrefixMetrics(source_preference=900)),
        prefix_db("node-13", "fd00::300/128"),
        # drained announcers: the not-drained one wins, else all drained
        prefix_db("node-3", "fd00::400/128"),
        prefix_db("node-17", "fd00::400/128"),
        prefix_db("node-3", "fd00::500/128"),
        prefix_db("node-5", "fd00::500/128"),
        prefix_db("node-8", "10.0.0.0/24"),
        prefix_db("node-19", "10.0.0.0/24"),
    ]
    return out, pdbs


SCENARIOS = {
    "grid6": (lambda: topologies.grid(6), ("node-0-0", "node-2-3")),
    # node-3 is an overloaded root: it still originates paths
    "mesh": (_mesh_scenario, ("node-0", "node-3", "node-12")),
}


def _jax_states(name):
    adj_dbs, pdbs = SCENARIOS[name][0]()
    return (adj_dbs, pdbs), topologies.build_states(adj_dbs, pdbs)


def _jax_mirror(name):
    (adj_dbs, pdbs), (states, ps) = _jax_states(name)
    graph = build_ell(states["0"])
    matrix = build_prefix_matrix(ps, graph.node_index, "0")
    return (adj_dbs, pdbs), states, graph, matrix


# fresh jits of the raw JAX kernels
_jax_sssp = jax.jit(jts._sssp_kernel)
_jax_next_hop = jax.jit(jts._next_hop_kernel)
_jax_select = jax.jit(jts._select_kernel)
_jax_pipeline = jts._jitted_pipeline.__wrapped__()
_jax_batch = jax.jit(jax.vmap(jts._sssp_kernel, in_axes=(None,) * 4 + (0,)))


def _np(t):
    return t.numpy() if hasattr(t, "numpy") else np.asarray(t)


def _equal(want, got, what):
    want, got = np.asarray(want), _np(got)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    assert want.dtype == got.dtype, (what, want.dtype, got.dtype)
    assert np.array_equal(want, got), what


def _matrix_tensors(port, matrix):
    t = port.torch

    def put(arr):
        return t.tensor(np.ascontiguousarray(arr))

    return (put(matrix.ann_node), put(matrix.ann_valid),
            put(matrix.path_pref), put(matrix.source_pref),
            put(matrix.dist_adv))


# -- tests -------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_csr_mirror_matches_jax(port, name):
    """The port's build_ell / out_table / build_prefix_matrix equal the
    JAX copies field for field on the same LSDB in the port's types."""
    (adj_dbs, pdbs), _, graph, matrix = _jax_mirror(name)
    pstates, pps = port.topologies.build_states(
        to_port(adj_dbs, port.types), to_port(pdbs, port.types))
    pgraph = port.csr.build_ell(pstates["0"])
    pmatrix = port.csr.build_prefix_matrix(pps, pgraph.node_index, "0")
    assert int(port.csr.INF32) == INF
    for f in ("n_nodes", "n_cap", "k_cap", "node_names", "node_index",
              "index_version"):
        assert getattr(pgraph, f) == getattr(graph, f), f
    for f in ("in_nbr", "in_w", "in_up", "node_overloaded", "node_valid",
              "edge_src", "edge_dst", "edge_w", "edge_up"):
        _equal(getattr(graph, f), getattr(pgraph, f), f)
    for r in SCENARIOS[name][1]:
        idx = graph.node_index[r]
        want, got = graph.out_table(idx), pgraph.out_table(idx)
        assert want[0].shape[0] >= 4 and want[0].shape[0] & (
            want[0].shape[0] - 1) == 0
        for f, a, b in zip(("nbr", "w", "up"), want[:3], got[:3]):
            _equal(a, b, f"out_table {r} {f}")
        assert [(lk.n1, lk.n2, lk.if1, lk.if2) for lk in want[3]] == [
            (lk.n1, lk.n2, lk.if1, lk.if2) for lk in got[3]]
    assert pmatrix.prefix_list == matrix.prefix_list
    for f in ("ann_node", "ann_valid", "path_pref", "source_pref",
              "dist_adv", "min_nexthop", "is_v4"):
        _equal(getattr(matrix, f), getattr(pmatrix, f), f)


@pytest.mark.parametrize("name,root", [
    (name, r) for name in sorted(SCENARIOS) for r in SCENARIOS[name][1]])
def test_legacy_kernels_match_jax(port, name, root):
    """K18 (distances), K19 (slot masks), K20 (selection) and the
    pipeline equal the JAX kernels byte for byte; the distances equal a
    host run_spf."""
    t, lg = port.torch, port.legacy
    _, states, graph, matrix = _jax_mirror(name)
    ridx = graph.node_index[root]
    r_nbr, r_w, r_up, _ = graph.out_table(ridx)
    jargs = (graph.in_nbr, graph.in_w, graph.in_up, graph.node_overloaded)
    ell = port.weights.ell_from_jax(graph, device="cpu")
    pargs = (ell["in_nbr"], ell["in_w"], ell["in_up"], ell["node_over"])
    p_root = (t.tensor(r_nbr), t.tensor(r_w), t.tensor(r_up))
    p_mat = _matrix_tensors(port, matrix)

    want_dist = _jax_sssp(*jargs, np.int32(ridx))
    got_dist, trips = lg.ell_sssp(
        *pargs, t.tensor([ridx], dtype=t.int32))
    _equal(want_dist, got_dist[0], "dist")
    assert 1 <= trips <= port.gpu_solver.max_trips(graph.n_cap)
    spf = states["0"].run_spf(root)
    for v, nm in enumerate(graph.node_names):
        assert int(got_dist[0, v]) == (spf[nm].metric if nm in spf else INF)

    want_nh = _jax_next_hop(*jargs, np.int32(ridx), want_dist, r_nbr, r_w,
                            r_up)
    got_nh, _ = lg.ell_next_hops(got_dist[0], *pargs, ridx, *p_root)
    _equal(want_nh, got_nh, "nh")
    assert bool(np.asarray(want_nh).any())

    want_sel = _jax_select(want_dist, want_nh, graph.node_overloaded,
                           matrix.ann_node, matrix.ann_valid,
                           matrix.path_pref, matrix.source_pref,
                           matrix.dist_adv)
    got_sel = lg.ell_select(got_dist[0], got_nh, ell["node_over"], *p_mat)
    for f, a, b in zip(("metric", "s3", "nh_mask", "has_route"), want_sel,
                       got_sel):
        _equal(a, b, f)

    want = _jax_pipeline(*jargs, np.int32(ridx), r_nbr, r_w, r_up,
                         matrix.ann_node, matrix.ann_valid, matrix.path_pref,
                         matrix.source_pref, matrix.dist_adv)
    got = port.gpu_solver.legacy_pipeline(*pargs, ridx, *p_root, *p_mat)
    for f, a, b in zip(("dist", "metric", "s3", "nh_mask", "has_route"),
                       want, got):
        _equal(a, b, f"pipeline {f}")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_sssp_all_pairs_matches_jax_and_run_spf(port, name):
    """sssp_all_pairs (every node) and sssp_batch (a root subset, a
    root repeated) equal the JAX vmapped kernel and a host run_spf."""
    _, states, graph, _ = _jax_mirror(name)
    want = _jax_batch(graph.in_nbr, graph.in_w, graph.in_up,
                      graph.node_overloaded,
                      np.arange(graph.n_nodes, dtype=np.int32))
    got = port.gpu_solver.sssp_all_pairs(graph, device="cpu")
    _equal(want, got, "all pairs")
    ls = states["0"]
    for i in range(0, graph.n_nodes, 5):
        spf = ls.run_spf(graph.node_names[i])
        row = [spf[nm].metric if nm in spf else INF
               for nm in graph.node_names]
        assert got[i, :graph.n_nodes].tolist() == row
    roots = np.array([3, 0, 3], np.int32)
    ell = port.weights.ell_from_jax(graph, device="cpu")
    sub = port.gpu_solver.sssp_batch(
        ell["in_nbr"], ell["in_w"], ell["in_up"], ell["node_over"],
        port.torch.tensor(roots))
    _equal(np.asarray(want)[roots], sub, "batch")


def test_entry_matches_jax(port):
    """The port's entry() builds the JAX entry()'s arguments and its
    forward step returns the JAX forward step's outputs."""
    jfn, jargs = __graft_entry__.entry()
    fn, args = port.entry.entry(device="cpu")
    assert len(args) == len(jargs) == 13
    for i, (a, b) in enumerate(zip(jargs, args)):
        if i == 4:
            assert int(a) == b
        else:
            _equal(a, b, f"arg {i}")
    want = jax.jit(jfn)(*jargs)
    got = fn(*args)
    assert len(got) == len(want) == 4
    for f, a, b in zip(("metric", "s3", "nh_mask", "has_route"), want, got):
        _equal(a, b, f)
    assert int(got[3].sum()) == 64  # every node's loopback, its own too


def test_legacy_entry_points_need_a_card_or_cpu(port):
    """Without a CUDA device the new entry points raise unless given
    device='cpu'; a CPU run is the plain versions (no launch counted)."""
    if port.torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    graph = _jax_mirror("grid6")[2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.gpu_solver.sssp_all_pairs(graph)
    counters = (port.legacy.ell_trip, port.legacy.ell_transpose,
                port.legacy.ell_next_hop, port.legacy.ell_select)
    before = [c.launches for c in counters]
    fn, args = port.entry.entry(device="cpu")
    fn(*args)
    port.gpu_solver.sssp_all_pairs(graph, device="cpu")
    assert [c.launches for c in counters] == before


def test_new_modules_import_without_jax():
    """Importing the legacy, fabric, combine, sharding and entry modules
    pulls in neither jax nor any module of openr_tpu."""
    code = (
        "import importlib, sys\n"
        "def bad():\n"
        "    return {m for m in sys.modules\n"
        "            if m.split('.')[0] in ('jax', 'jaxlib', 'openr_tpu')}\n"
        "before = bad()\n"
        "for m in ('ops.legacy', 'ops.fabric', 'ops.combine', 'parallel',\n"
        "          'parallel.sharding', 'entry', 'weights'):\n"
        "    importlib.import_module('openr_tpu_torch.' + m)\n"
        "print(sorted(bad() - before))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


# -- K18's packed mirror and trips ---------------------------------------------

# seeded padded mirrors: (n_nodes, n_cap, k_cap, metric max, share of
# links down, overloaded nodes, roots drawn from the overloaded ones,
# two components with no link between them)
K18_CASES = {
    "down_links": (40, 45, 6, 9, 0.3, 0, False, False),
    "overloaded_transit": (40, 45, 6, 9, 0.0, 6, False, False),
    "overloaded_root": (40, 45, 6, 9, 0.1, 6, True, False),
    "unreachable": (40, 45, 6, 9, 0.0, 2, False, True),
    "metric_2p28": (40, 45, 6, 1 << 28, 0.1, 2, False, False),
    "n_cap_64": (50, 64, 5, 99, 0.1, 3, True, False),
}


def _k18_mirror(case, r):
    """(in_nbr, in_w, in_up, node_over, roots) numpy arrays of a seeded
    padded mirror: every slot of a real node drawn (or a pad, -1), pad
    nodes without slots."""
    n, n_cap, k_cap, wmax, down, n_over, over_roots, split = \
        K18_CASES[case]
    rng = np.random.default_rng(sorted(K18_CASES).index(case) * 100 + r)
    in_nbr = np.full((n_cap, k_cap), -1, np.int32)
    in_w = np.full((n_cap, k_cap), INF, np.int32)
    in_up = np.zeros((n_cap, k_cap), bool)
    half = n // 2
    for v in range(n):
        lo, hi = ((0, half) if v < half else (half, n)) if split else (0, n)
        others = [u for u in range(lo, hi) if u != v]
        deg = int(rng.integers(1, k_cap + 1))
        slots = np.sort(rng.choice(k_cap, deg, replace=False))
        in_nbr[v, slots] = rng.choice(others, deg)
        in_w[v, slots] = rng.integers(1, wmax + 1, deg)
        in_up[v, slots] = rng.random(deg) >= down
    node_over = np.zeros(n_cap, bool)
    over = rng.choice(n, n_over, replace=False) if n_over else []
    node_over[over] = True
    pool = over if over_roots else np.arange(n)
    roots = rng.choice(pool, r)
    if over_roots and r > 1:
        roots[1:] = rng.choice(n, r - 1)  # the first is overloaded
    return in_nbr, in_w, in_up, node_over, roots.astype(np.int32)


def _padded_rounds(port, mirror, roots, dist, rounds, seed):
    """``rounds`` rounds of ell_relax_plain -> (plane, flag)."""
    t = port.torch
    flag = t.zeros(1, dtype=t.int32)
    out = t.empty_like(dist)
    for k in range(rounds):
        port.legacy.ell_relax_plain(dist, out, flag, *mirror, roots,
                                    seed and k == 0)
        dist, out = out, dist
    return dist, int(flag)


@pytest.mark.parametrize("r", [1, 31, 33])
@pytest.mark.parametrize("case", sorted(K18_CASES))
def test_k18_packed_trip_matches_padded_rounds_and_jax(port, case, r):
    """The packed mirror keeps each live slot (real, up) of its node with
    its source's overload bit; a plain trip over it (from the seed, and
    from a wavefront on the plane of R's tiling) equals UNROLL rounds of
    ell_relax_plain, flag included; ell_sssp equals the JAX vmapped
    kernel at tolerance 0 with the plain loop's trips."""
    t, lg = port.torch, port.legacy
    arrays = _k18_mirror(case, r)
    in_nbr, in_w, in_up, node_over, roots_np = arrays
    n_cap = in_nbr.shape[0]
    mirror = (t.tensor(in_nbr), t.tensor(in_w), t.tensor(in_up),
              t.tensor(node_over))
    roots = t.tensor(roots_np)
    if case == "overloaded_root":
        assert node_over[roots_np[0]]

    row_ptr, slots = lg.pack_ell(*arrays[:4])
    live = (in_nbr >= 0) & in_up
    assert row_ptr[0] == 0 and np.array_equal(np.diff(row_ptr),
                                              live.sum(axis=1))
    for v in range(n_cap):
        got = slots[row_ptr[v]:row_ptr[v + 1]]
        src = got[:, 0] & lg.SLOT_SRC
        assert np.array_equal(src, in_nbr[v][live[v]])
        assert np.array_equal(got[:, 0] < 0, node_over[src])
        assert np.array_equal(got[:, 1], in_w[v][live[v]])
    packed = lg.packed_mirror(*mirror)
    assert np.array_equal(packed.row_ptr.numpy(), row_ptr)
    assert np.array_equal(packed.slots.numpy(), slots)
    assert lg.packed_mirror(*mirror) is packed

    shape = lg.plane_shape(r, n_cap)
    assert lg.batched(r) == (r >= 32)
    assert shape == ((n_cap, 64) if r == 33 else (r, n_cap))
    flags = t.full((2,), 5, dtype=t.int32)

    def trip(start, k):
        """A plain trip k from ``start`` [r, n_cap] (ignored at k = 0)
        on R's tiling -> (result [r, n_cap], the trip's flag word)."""
        cur = t.full(shape, -7, dtype=t.int32)
        spare = t.full(shape, -7, dtype=t.int32)
        lg.plane_words(cur, r).copy_(start.t())
        out = lg.ell_trip(cur, spare, flags, packed, roots, k)
        assert out is cur
        if lg.batched(r):  # pad columns are never written
            assert bool((cur[:, r:] == -7).all())
            assert bool((spare[:, r:] == -7).all())
        assert int(flags[(k + 1) & 1]) == 0
        return lg.plane_words(out, r).t(), int(flags[k & 1])

    seed_want, seed_flag = _padded_rounds(
        port, mirror, roots, t.empty((r, n_cap), dtype=t.int32), 8, True)
    got, f = trip(t.empty((r, n_cap), dtype=t.int32), 0)
    _equal(seed_want.numpy(), got, f"{case} seed trip")
    assert f == seed_flag == 1
    mid, _ = _padded_rounds(port, mirror, roots,
                            t.empty((r, n_cap), dtype=t.int32), 2, True)
    want, want_flag = _padded_rounds(port, mirror, roots, mid.clone(), 8,
                                     False)
    got, f = trip(mid, 1)
    _equal(want.numpy(), got, f"{case} wavefront trip")
    assert f == want_flag

    dist, trips = lg.ell_sssp(*mirror, roots)
    plain, plain_trips = lg.run_rounds(
        lambda s, d, fl, seed: lg.ell_relax_plain(s, d, fl, *mirror, roots,
                                                  seed),
        t.empty((r, n_cap), dtype=t.int32),
        port.gpu_solver.max_trips(n_cap))
    assert trips == plain_trips
    _equal(plain.numpy(), dist, f"{case} ell_sssp == plain loop")
    want = jts._jitted_sssp_batch()(in_nbr, in_w, in_up, node_over,
                                    roots_np)
    _equal(want, dist, f"{case} ell_sssp == JAX")
    if case == "unreachable":
        assert bool((dist == INF).any())
