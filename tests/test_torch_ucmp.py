"""The port's UCMP weight propagation (openr_tpu_torch/ops/ucmp.py,
csrc/ucmp.cu) and its distance field, the unmasked single-root SSSP
(openr_tpu_torch/ops/ksp2.base_sssp), against the JAX package's
``ops/ucmp.py::_ucmp_fn`` and ``ops/ksp2.py::_base_sssp_fn``, input for
input, and ``GpuSpfSolver(enable_ucmp=True)`` against the CPU oracle.

The JAX functions are fresh jits of the raw factories
(``_ucmp_fn.__wrapped__``, ``_base_sssp_fn.__wrapped__``); no
``TpuSpfSolver`` is built here. The port runs on CPU tensors, which run
each kernel's plain PyTorch version. Weights and distances are int32
and the overflow flag and round count are exact: tolerance 0. The
float32 overflow shadow is summed in the JAX package's order, so the
flag equals the reference's also within rounding of 2^30.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest

from openr_tpu.decision.link_state import LinkState
from openr_tpu.models import topologies
from openr_tpu.ops import ucmp as jucmp
from openr_tpu.ops.edgeplan import build_plan
from openr_tpu.ops.ksp2 import _base_sssp_fn
from openr_tpu.types import PrefixForwardingAlgorithm
from tests.test_link_state import adj, adj_db
from tests.test_torch_solver import to_port
from tests.torch_jax_state import jax_state_barrier  # noqa: F401

INF_E = 1 << 29
PREFIX = PrefixForwardingAlgorithm.SP_UCMP_PREFIX_WEIGHT_PROPAGATION
ADJ = PrefixForwardingAlgorithm.SP_UCMP_ADJ_WEIGHT_PROPAGATION


@pytest.fixture(scope="module")
def port():
    """The port's modules, with torch held to one thread while this
    module's tests run."""
    import torch

    from openr_tpu_torch import types as ptypes
    from openr_tpu_torch.decision import gpu_solver, link_state
    from openr_tpu_torch.decision import prefix_state, spf_solver
    from openr_tpu_torch.models import topologies as ptopo
    from openr_tpu_torch.ops import ksp2, ucmp

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(
        torch=torch, types=ptypes, gpu_solver=gpu_solver,
        link_state=link_state, prefix_state=prefix_state,
        spf_solver=spf_solver, topologies=ptopo, ksp2=ksp2, ucmp=ucmp,
    )
    torch.set_num_threads(prev)


# -- topologies (tests/test_tpu_solver.py's ucmp_states, copied) ---------------

_UCMP_TOPO = {
    "r": ["a", "b"],
    "a": ["r", "c", "d"],
    "b": ["r", "d", "e"],
    "c": ["a", "l1"],
    "d": ["a", "b", "l1", "l2"],
    "e": ["b", "l2"],
    "l1": ["c", "d"],
    "l2": ["d", "e"],
}


def ucmp_adj_dbs(weight=None):
    """Two-level DAG with multipath, unit metrics: r - {a, b};
    a - {c, d}; b - {d, e}; c - l1; d - {l1, l2}; e - l2. l1 / l2 are
    equidistant (3) from r. Link weights 10 + ord(o) % 7 unless
    ``weight`` gives one for every link."""
    return [
        adj_db(node, [
            adj(node, o, weight=weight if weight is not None
                else 10 + ord(o[0]) % 7)
            for o in others
        ])
        for node, others in _UCMP_TOPO.items()
    ]


def _fabric_dbs():
    adj_dbs, _ = topologies.fabric(pods=4, planes=2, ssws_per_plane=2,
                                   rsws_per_pod=4)
    return adj_dbs


def _both(port, adj_dbs):
    """(JAX LinkState, port LinkState) over the same adjacencies."""
    jls = LinkState("0")
    pls = port.link_state.LinkState("0")
    for db in adj_dbs:
        jls.update_adjacency_database(db)
        pls.update_adjacency_database(to_port(db, port.types))
    return jls, pls


# fresh jits of the raw JAX factories, one per shape for this module
_jax_ucmp = functools.lru_cache(None)(jucmp._ucmp_fn.__wrapped__)
_jax_base_fn = functools.lru_cache(None)(_base_sssp_fn.__wrapped__)


def _jax_base(plan, root):
    r_cap, kr_cap = plan.res_nbr.shape
    fn = _jax_base_fn(plan.n_cap, plan.s_cap, r_cap, kr_cap, plan.k_res > 0)
    return np.asarray(fn(plan.deltas, plan.shift_w, plan.res_rows,
                         plan.res_nbr, plan.res_w, np.int32(root)))


def _port_base(port, plan, root):
    t = port.torch.tensor
    dist, trips = port.ksp2.base_sssp(
        t(plan.deltas), t(plan.shift_w), t(plan.res_rows), t(plan.res_nbr),
        t(plan.res_w), root, plan.k_res > 0)
    return dist.numpy(), trips


def _propagate_both(port, adj_dbs, root, leaves, prefix):
    """(JAX (reach, w, overflow, rounds), the port's), both from the same
    leaves over the JAX base field, and the two edge sets."""
    jls, pls = _both(port, adj_dbs)
    plan = build_plan(jls)
    dist = _jax_base(plan, plan.node_index[root])
    je = jucmp.UcmpEdges(jls, plan.node_overloaded, plan.n_cap)
    pe = port.ucmp.UcmpEdges(pls, plan.node_overloaded, plan.n_cap,
                             device="cpu")
    for name in ("src", "dst", "w_eff", "adj_w"):
        np.testing.assert_array_equal(getattr(pe, name).numpy(),
                                      np.asarray(getattr(je, f"d_{name}")))
    leaf = np.zeros(plan.n_cap, bool)
    leaf_w = np.zeros(plan.n_cap, np.int32)
    for name, w in leaves.items():
        leaf[plan.node_index[name]] = True
        leaf_w[plan.node_index[name]] = w
    fn = _jax_ucmp(je.e_cap, je.n_cap, prefix)
    want = [np.asarray(x) for x in fn(je.d_src, je.d_dst, je.d_w_eff,
                                      je.d_adj_w, dist, leaf, leaf_w)]
    t = port.torch.tensor
    got = port.ucmp.ucmp_propagate(pe.tensors(), t(dist), t(leaf),
                                   t(leaf_w), prefix, pe.max_deg)
    return want, got, (je, pe), plan


def _assert_same(want, got, ctx):
    reach, w, overflow, rounds = got
    np.testing.assert_array_equal(reach.numpy(), want[0], err_msg=ctx)
    np.testing.assert_array_equal(w.numpy(), want[1], err_msg=ctx)
    assert (bool(overflow), rounds) == (bool(want[2]), int(want[3])), ctx


def _fabric_leaves():
    """Remote rsw leaves of one anycast prefix, weights 1..9 from a
    seed."""
    rng = np.random.default_rng(7)
    return {f"pod{p:03d}-rsw{i:02d}": int(rng.integers(1, 10))
            for p in (1, 2, 3) for i in (0, 2)}


@pytest.mark.parametrize("topo,prefix", [
    ("ucmp", True), ("ucmp", False), ("fabric", True), ("fabric", False),
])
def test_ucmp_fixpoint_matches_jax(port, topo, prefix):
    """reach, w, overflow and rounds of ``ucmp_propagate`` equal
    ``_ucmp_fn``'s in both propagation modes."""
    if topo == "ucmp":
        dbs, root, leaves = ucmp_adj_dbs(), "r", {"l1": 3, "l2": 5}
    else:
        dbs, root, leaves = _fabric_dbs(), "pod000-rsw00", _fabric_leaves()
    want, got, _, plan = _propagate_both(port, dbs, root, leaves, prefix)
    _assert_same(want, got, topo)
    assert want[0][plan.node_index[root]] and int(want[3]) > 2
    assert not want[2]


@pytest.mark.parametrize("l1,l2,over", [
    (1 << 29, 1 << 29, True),          # far above 2^30: int32 wraps
    (357913975, 1, True),              # 2^30 + 104: the shadow rounds up
    (357913941, 1, False),             # 2^30 + 2: the shadow rounds to 2^30
    (357913841, 1, False),             # just below 2^30
])
def test_ucmp_overflow_flag_matches_jax_near_2_30(port, l1, l2, over):
    """Prefix mode on the two-level DAG, where the root's weight is
    3 * (l1 + l2): the overflow flag comes from a float32 shadow, so
    within rounding of 2^30 it is the shadow's verdict, not the exact
    sum's — the port's equals the reference's on both sides of it."""
    want, got, _, plan = _propagate_both(
        port, ucmp_adj_dbs(), "r", {"l1": l1, "l2": l2}, True)
    _assert_same(want, got, f"{l1}, {l2}")
    assert bool(want[2]) is over
    wrapped = (3 * (l1 + l2) + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert int(want[1][plan.node_index["r"]]) == wrapped


def _zero_link_dbs():
    """The two-level DAG plus a zero-metric link c - d."""
    return [
        dataclasses.replace(db, adjacencies=db.adjacencies + (adj(
            db.this_node_name, "d" if db.this_node_name == "c" else "c",
            metric=0, weight=10),))
        if db.this_node_name in ("c", "d") else db
        for db in ucmp_adj_dbs()
    ]


def test_ucmp_round_bound_counts_as_overflow(port):
    """A zero-metric link makes a 2-cycle of DAG edges: prefix weights
    grow every round, the n_cap + 2 bound fires and reports overflow —
    in both packages, after the same rounds."""
    want, got, (je, pe), plan = _propagate_both(
        port, _zero_link_dbs(), "r", {"l1": 3, "l2": 5}, True)
    _assert_same(want, got, "zero-weight cycle")
    assert pe.zero_w_unsafe and je.zero_w_unsafe
    assert bool(want[2]) and int(want[3]) == plan.n_cap + 2


@pytest.mark.parametrize("guard", ["zero_weight", "adj_weight", "leaf_weight"])
def test_ucmp_guards_take_the_host_walk(port, guard):
    """The three guards of ``propagate`` — a zero-weight edge, a link
    weight past 2^30 in adjacency mode, a leaf weight past 2^30 — answer
    (None, None, True) in both packages, and the solver's RIB, which the
    host walk then computes, equals the oracle's."""
    algo, leaves = PREFIX, {"l1": 3, "l2": 5}
    if guard == "zero_weight":
        dbs = _zero_link_dbs()
    elif guard == "adj_weight":
        dbs, algo = ucmp_adj_dbs(weight=(1 << 30) + 1), ADJ
    else:
        dbs, leaves = ucmp_adj_dbs(), {"l1": (1 << 30) + 1, "l2": 5}
    jls, pls = _both(port, dbs)
    plan = build_plan(jls)
    dist = _jax_base(plan, plan.node_index["r"])
    je = jucmp.UcmpEdges(jls, plan.node_overloaded, plan.n_cap)
    pe = port.ucmp.UcmpEdges(pls, plan.node_overloaded, plan.n_cap,
                             device="cpu")
    prefix = algo == PREFIX
    assert jucmp.propagate(je, dist, leaves, prefix) == (None, None, True)
    got = port.ucmp.propagate(pe, port.torch.tensor(dist), leaves, prefix)
    assert got == (None, None, True)
    assert (pe.zero_w_unsafe, pe.adj_w_unsafe) == (je.zero_w_unsafe,
                                                   je.adj_w_unsafe)
    states = {"0": pls}
    ps = _prefixes(port, algo, leaves)
    gpu = port.gpu_solver.GpuSpfSolver("r", device="cpu", enable_ucmp=True)
    want = port.spf_solver.SpfSolver("r", enable_ucmp=True).build_route_db(
        "r", states, ps)
    got_db = gpu.build_route_db("r", states, ps)
    assert dict(got_db.unicast_routes.items()) == dict(
        want.unicast_routes.items())
    assert NotImplemented in gpu._ucmp_accel.results.values()


@pytest.mark.parametrize("name", ["grid", "fat_tree", "mesh"])
def test_base_sssp_matches_jax(port, name):
    """The unmasked single-root field, the root a transit node, equals
    ``_base_sssp_fn``'s — with residual edges on the fat tree — and its
    trips are the JAX loop's bound or fewer."""
    if name == "grid":
        adj_dbs, _ = topologies.grid(6, node_labels=False)
        roots = ["node-2-2", "node-0-0"]
    elif name == "fat_tree":
        adj_dbs, _ = topologies.fat_tree()
        roots = ["rsw-0-0", "ssw-0-0"]
    else:
        adj_dbs, _ = topologies.random_mesh(24, seed=5)
        roots = ["node-0", "node-9"]
    jls, _ = _both(port, adj_dbs)
    plan = build_plan(jls)
    if name == "fat_tree":
        assert plan.k_res > 0, "the case must carry residual edges"
    for me in roots:
        root = plan.node_index[me]
        want = _jax_base(plan, root)
        got, trips = _port_base(port, plan, root)
        np.testing.assert_array_equal(got, want, err_msg=me)
        assert got[root] == 0 and (got < INF_E).sum() == len(adj_dbs)
        assert 1 <= trips <= max(2, -(-plan.n_cap // 8) + 2)


# -- the solver ----------------------------------------------------------------

def _prefixes(port, algo, leaves, prefixes=("fd00::100/128",), ps=None):
    """``ps`` (a new PrefixState by default) with each of ``prefixes``
    announced by every leaf at its weight, under ``algo``."""
    t = port.types
    ps = port.prefix_state.PrefixState() if ps is None else ps
    for node, w in leaves.items():
        ps.update_prefix_database(t.PrefixDatabase(
            this_node_name=node, area="0",
            prefix_entries=tuple(
                t.PrefixEntry(prefix=p, forwarding_algorithm=t.
                              PrefixForwardingAlgorithm(algo.value),
                              weight=w)
                for p in prefixes),
        ))
    return ps


def _rib(db):
    return dict(db.unicast_routes.items()), db.mpls_routes


def _engaged(gpu):
    return [v for v in gpu._ucmp_accel.results.values()
            if v is not None and v is not NotImplemented]


@pytest.mark.parametrize("algo", [PREFIX, ADJ])
def test_ucmp_solver_matches_oracle(port, algo):
    """Every vantage of the two-level DAG and a fabric root with anycast
    prefixes over remote rsws (beside the loopbacks the fast path
    solves): the RIB equals SpfSolver(enable_ucmp=True)'s, and the device
    resolver answered (no host walk)."""
    _, pls = _both(port, ucmp_adj_dbs())
    ps = _prefixes(port, algo, {"l1": 3, "l2": 5})
    for me in ("r", "a", "b"):
        gpu = port.gpu_solver.GpuSpfSolver(me, device="cpu",
                                           enable_ucmp=True)
        want = port.spf_solver.SpfSolver(me, enable_ucmp=True)
        got = gpu.build_route_db(me, {"0": pls}, ps)
        assert _rib(got) == _rib(want.build_route_db(me, {"0": pls}, ps)), me
        assert got.unicast_routes["fd00::100/128"].ucmp_weight is not None
        assert _engaged(gpu), me
    adj_dbs, pdbs = port.topologies.fabric(pods=4, planes=2, ssws_per_plane=2,
                                           rsws_per_pod=4)
    states, fps = port.topologies.build_states(adj_dbs, pdbs)
    _prefixes(port, algo, _fabric_leaves(), ("fd10::1/128", "fd10::2/128"),
              fps)
    me = "pod000-rsw00"
    gpu = port.gpu_solver.GpuSpfSolver(me, device="cpu", enable_ucmp=True)
    got = gpu.build_route_db(me, states, fps)
    want = port.spf_solver.SpfSolver(me, enable_ucmp=True).build_route_db(
        me, states, fps)
    assert _rib(got) == _rib(want)
    # the two anycast prefixes share one resolve
    assert len(_engaged(gpu)) == 1


def test_ucmp_solver_through_churn(port):
    """Metric churn changes the DAG: the per-generation edges, base
    field and result memo refresh and the RIB still equals the
    oracle's."""
    _, pls = _both(port, ucmp_adj_dbs())
    states = {"0": pls}
    ps = _prefixes(port, PREFIX, {"l1": 3, "l2": 5})
    gpu = port.gpu_solver.GpuSpfSolver("r", device="cpu", enable_ucmp=True)
    cpu = port.spf_solver.SpfSolver("r", enable_ucmp=True)
    t = port.types

    def r_links(m):
        return t.AdjacencyDatabase(this_node_name="r", adjacencies=(
            to_port(adj("r", "a", metric=m, weight=10 + ord("a") % 7),
                    t),
            to_port(adj("r", "b", weight=10 + ord("b") % 7), t)))

    weights = []
    for ctx, m in (("before", None), ("stretched", 5), ("healed", 1)):
        if m is not None:
            pls.update_adjacency_database(r_links(m))
        got = gpu.build_route_db("r", states, ps)
        assert _rib(got) == _rib(cpu.build_route_db("r", states, ps)), ctx
        assert _engaged(gpu), ctx
        weights.append(got.unicast_routes["fd00::100/128"].ucmp_weight)
    assert weights[0] == weights[2] != weights[1]
