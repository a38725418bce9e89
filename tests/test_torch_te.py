"""The port's differentiable TE (openr_tpu_torch/ops/te.py, csrc/te.cu) and
``WhatIfEngine.optimize`` (openr_tpu_torch/decision/whatif.py).

- ``te_step_plain`` against fresh jits of the JAX package's
  ``ops/sweep.py::_make_te`` (never its ``te_step`` factory, whose
  ``instrument_jit`` path installs AOT executables), fed the same arrays
  through ``weights.te_inputs_from_jax``: loss, grad, util and cost on
  grid(4) (shift classes only), ring(8) and a fabric (residual rows),
  at several tau / tau_util and metric scales.
- The plain kernels' trip-slice interfaces (the slices ``chip_smoke.py``
  holds each kernel to): a run split in two equals the whole run.
- ``WhatIfEngine.optimize`` over ``GpuSpfSolver(device="cpu")`` against
  the JAX ``OptimizeJob.run`` loop transcribed over the same fresh jit,
  on the cases of ``tests/test_whatif.py``: grid(3) (iters 2, lr 0.05)
  and the diamond (iters 30, lr 0.05). The port's planning arrays equal
  the ones the JAX ``plan_optimize`` builds from ``openr_tpu.ops.edgeplan``
  for the same LSDB.

No JAX solver or engine is built. Five TE shape classes are compiled,
each once (module-scoped cache).

Tolerance, float32, fixed before the first comparison: each output
within 1e-4 of its largest magnitude (loss, cost, util), grad — second
order, summed over the trips — within 1e-3 of its largest magnitude.
"""

import types

import jax
import numpy as np
import pytest

from openr_tpu.models import topologies
from openr_tpu.ops import sweep as jsweep
from openr_tpu.ops.edgeplan import (
    INF32E,
    MAX_METRIC,
    _ensure_edge_loc,
    _next_pow2,
    edge_loc_of,
    sync_plan,
)
from tests.torch_jax_state import jax_state_barrier  # noqa: F401

AREA = "0"
TOL = {"loss": 1e-4, "grad": 1e-3, "util": 1e-4, "cost": 1e-4}


@pytest.fixture(scope="module")
def port():
    """The port's modules, with torch held to one thread while this
    module's tests run."""
    import torch

    from openr_tpu_torch import weights
    from openr_tpu_torch.decision import gpu_solver, whatif
    from openr_tpu_torch.models import topologies as ptopo
    from openr_tpu_torch.ops import te
    from openr_tpu_torch.runtime import counters
    from openr_tpu_torch.runtime.tracing import tracer
    from openr_tpu_torch.types import PrefixForwardingAlgorithm

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(
        torch=torch, weights=weights, gpu_solver=gpu_solver, whatif=whatif,
        topologies=ptopo, te=te, counters=counters.counters, tracer=tracer,
        PFA=PrefixForwardingAlgorithm,
    )
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jit_te():
    """Fresh ``jax.jit(_make_te(...))`` by static arguments, each class
    compiled once in this module."""
    cache = {}

    def get(static):
        if static not in cache:
            cache[static] = jax.jit(jsweep._make_te(*static))
        return cache[static]

    return get


def assert_close(got, want, tol, label, unit=0.0):
    """|got - want| within ``tol`` of want's largest magnitude, plus one
    ``unit`` where both sides were rounded to it (the engine reports
    losses to 4 places and utilizations to 3)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, label
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + unit, f"{label}: err {err} > {tol} * {scale}"


# -- the reference's planning, transcribed over openr_tpu.ops.edgeplan --------

def _jax_theta_slots(plan):
    """plan_optimize's theta0, slots and link names (whatif.py:525-556)."""
    n_cap, kr_cap = plan.n_cap, plan.res_nbr.shape[1]
    links = [ln for ln in plan._links_sorted if ln.is_up()]
    theta0, sh_idx, sh_link, rs_idx, rs_link, names = [], [], [], [], [], []
    for li, ln in enumerate(links):
        names.append(f"{ln.n1}|{ln.n2}")
        theta0.append(float(min(ln.metric_from_node(ln.n1), MAX_METRIC)))
        for src in (ln.n1, ln.n2):
            loc = edge_loc_of(plan, ln, src)
            if loc is None:
                continue
            kind, a, b = loc
            if kind == "s":
                if plan.shift_w[a, b] >= INF32E:
                    continue
                sh_idx.append(a * n_cap + b)
                sh_link.append(li)
            else:
                if plan.res_w[a, b] >= INF32E:
                    continue
                rs_idx.append(a * kr_cap + b)
                rs_link.append(li)
    return theta0, sh_idx, sh_link, rs_idx, rs_link, names


def _pad(a, n, fill, dtype=np.int32):
    out = np.full(n, fill, dtype)
    out[:len(a)] = a
    return out


def _jax_arrays(plan, theta0, sh_idx, sh_link, rs_idx, rs_link, demands):
    """OptimizeJob.run's padded step inputs (whatif.py:651-688): ->
    (args without tau / tau_util, the te_step static arguments)."""
    n_cap, s_cap = plan.n_cap, plan.s_cap
    r_cap, kr_cap = plan.res_nbr.shape
    srcs = np.asarray(sorted({s for s, _, _ in demands}), np.int32)
    row_of = {int(s): i for i, s in enumerate(srcs)}
    l_cap = _next_pow2(len(theta0), 4)
    es = _next_pow2(max(1, len(sh_idx)), 4)
    er = _next_pow2(max(1, len(rs_idx)), 4)
    s_cap_d = _next_pow2(len(srcs), 2)
    d_cap = _next_pow2(len(demands), 2)
    theta = _pad(np.asarray(theta0, np.float32), l_cap, 1.0, np.float32)
    args = (
        theta, plan.deltas, plan.res_rows, plan.res_nbr,
        _pad(sh_idx, es, s_cap * n_cap), _pad(sh_link, es, 0),
        _pad(rs_idx, er, r_cap * kr_cap), _pad(rs_link, er, 0),
        _pad(srcs, s_cap_d, 0),
        _pad([row_of[s] for s, _, _ in demands], d_cap, 0),
        _pad([d for _, d, _ in demands], d_cap, 0),
        _pad([v for _, _, v in demands], d_cap, 0.0, np.float32),
    )
    return args, (l_cap, s_cap_d, d_cap, es, er, n_cap, s_cap, r_cap,
                  kr_cap, plan.k_res > 0)


def _jax_plan(gen, demands):
    """The reference's planning (whatif.py:525-572) of the LSDB ``gen()``
    builds: the edge plan, theta / slots / link names, the resolved
    demands and the rejected count. (Every demand of these cases is
    reachable; the baseline sweep that bounds the trips is held to
    ``_make_sweep`` in ``tests/test_torch_whatif.py``.)"""
    adj_dbs, prefix_dbs = gen()
    states, _ = topologies.build_states(adj_dbs, prefix_dbs)
    plan = sync_plan(states[AREA], None)
    _ensure_edge_loc(plan)
    theta0, sh_idx, sh_link, rs_idx, rs_link, names = _jax_theta_slots(plan)
    dem, bad = [], 0
    for d in demands:
        si = plan.node_index.get(d["src"])
        di = plan.node_index.get(d["dst"])
        if si is None or di is None or si == di:
            bad += 1
            continue
        dem.append((si, di, float(d.get("volume", 1.0))))
    return types.SimpleNamespace(
        plan=plan, theta0=theta0, slots=(sh_idx, sh_link, rs_idx, rs_link),
        names=names, demands=dem, rejected=bad)


def _jax_optimize(jit_te, jp, trips, iters, lr, tau=1.0, tau_util=None):
    """OptimizeJob.run's loop (whatif.py:690-741) over a fresh jit."""
    args, static = _jax_arrays(jp.plan, jp.theta0, *jp.slots, jp.demands)
    step = jit_te(static + (trips,))
    theta, rest = args[0], args[1:]
    t32, tu32 = np.float32(tau), np.float32(tau_util or tau)
    loss_curve, util0 = [], None
    for _ in range(iters):
        loss, grad, util, _ = step(theta, *rest, t32, tu32)
        util = np.asarray(util)
        if util0 is None:
            util0 = util
        loss_curve.append(round(float(loss), 4))
        theta = np.clip(theta - lr * np.asarray(grad), 1.0,
                        float(MAX_METRIC)).astype(np.float32)
    util1 = np.asarray(step(theta, *rest, t32, tu32)[2])
    n = len(jp.theta0)
    proposed = np.clip(np.rint(theta[:n]), 1, MAX_METRIC).astype(int)
    changes = [
        {"link": jp.names[i], "metric": int(round(jp.theta0[i])),
         "proposed": int(proposed[i]),
         "utilization": round(float(util1[i]), 3)}
        for i in range(n) if int(proposed[i]) != int(round(jp.theta0[i]))
    ]
    return {"loss_curve": loss_curve, "changes": changes,
            "max_util_before": round(float(util0[:n].max()), 3),
            "max_util_after": round(float(util1[:n].max()), 3)}


# -- te_step_plain against _make_te -------------------------------------------

_CELLS = {
    "grid4": lambda: topologies.grid(4),
    "ring8": lambda: topologies.ring(8),
    "fabric": lambda: topologies.fabric(pods=4, planes=2, ssws_per_plane=2,
                                        rsws_per_pod=4),
}
# 3 demand sources, 12 demands, a trip bound past every cell's diameter
_TRIPS = 16


def _cell_inputs(cell, scale, seed, noise=0.5):
    """A cell's JAX step inputs: theta from the link metrics times
    ``scale`` plus seeded noise (up to ``noise``), seeded sources and
    demands."""
    adj_dbs, prefix_dbs = _CELLS[cell]()
    states, _ = topologies.build_states(adj_dbs, prefix_dbs)
    plan = sync_plan(states[AREA], None)
    _ensure_edge_loc(plan)
    theta0, *slots, _ = _jax_theta_slots(plan)
    rng = np.random.default_rng(seed)
    theta0 = [t * scale + float(rng.uniform(0.0, noise)) for t in theta0]
    n = plan.n_nodes
    srcs = rng.choice(n, 3, replace=False)
    demands = []
    for i in range(12):
        s, d = int(srcs[i % 3]), int(rng.integers(n))
        demands.append((s, d if d != s else (d + 1) % n,
                        float(rng.integers(1, 5))))
    args, static = _jax_arrays(plan, theta0, *slots, demands)
    assert static[-1] == (cell == "fabric" or cell == "ring8")
    return args, static + (_TRIPS,)


@pytest.mark.parametrize("cell,tau,tau_util,scale,seed", [
    ("grid4", 1.0, 1.0, 1.0, 0),
    ("grid4", 0.7, 0.5, 3.0, 1),
    ("ring8", 1.0, 1.0, 1.0, 2),
    ("ring8", 2.5, 1.0, 3.0, 3),
    ("fabric", 1.0, 1.0, 1.0, 4),
    ("fabric", 0.3, 2.0, 1.0, 5),
])
def test_te_step_plain_matches_make_te(port, jit_te, cell, tau, tau_util,
                                       scale, seed):
    """(loss, grad, util, cost) of ``te_step_plain`` — and of ``te_step``
    on CPU tensors, which runs the same plain versions — equal a fresh
    jit of ``_make_te`` on the same arrays; fabric's spine tier and
    ring(8)'s links ride the residual ELL, grid(4)'s the shift
    classes."""
    args, static = _cell_inputs(cell, scale, seed)
    want = jit_te(static)(*args, np.float32(tau), np.float32(tau_util))
    n_cap, trips, has_res = static[5], static[-1], static[-2]
    plan, theta, t, tu = port.weights.te_inputs_from_jax(
        (*args, tau, tau_util), n_cap=n_cap, trips=trips, has_res=has_res,
        device="cpu")
    assert plan.has_res == has_res and theta.numel() == static[0]
    got = port.te.te_step_plain(plan, theta, t, tu)
    step = port.te.te_step(plan, theta, t, tu)
    for name, g, s, w in zip(("loss", "grad", "util", "cost"), got, step,
                             want):
        w = np.asarray(w)
        assert g.dtype == port.torch.float32 and tuple(g.shape) == w.shape
        assert port.torch.equal(g, s), name
        assert_close(g.numpy(), w, TOL[name], f"{cell} {name}")
    assert float(np.abs(np.asarray(want[2])).max()) > 0


@pytest.mark.parametrize("cell,noise", [
    ("grid4", 0.0), ("ring8", 0.0), ("fabric", 0.5)])
def test_te_derivatives_match_finite_differences(port, cell, noise):
    """In float64, ``util`` is the derivative of ``cost`` and ``grad`` that
    of ``loss`` along seeded directions, to central differences — the
    forward-over-reverse second order included. grid(4) and ring(8) at
    the link metrics themselves (the optimizer's first step, where
    equal-cost paths tie); the fabric off them: at its integer metrics a
    node's residual candidate, its class chain and its own distance tie
    three ways, a kink of the cost where the reference's tie rules (1/4,
    3/4) are not the mean of the one-sided slopes that a central
    difference takes. No JAX: the port's plain versions alone."""
    torch, te = port.torch, port.te
    args, static = _cell_inputs(cell, 1.0, 8, noise=noise)
    plan, theta, tau, tau_u = port.weights.te_inputs_from_jax(
        (*args, 1.0, 1.0), n_cap=static[5], trips=static[-1],
        has_res=static[-2], device="cpu")
    theta = theta.double()
    loss, grad, util, cost = te.te_step_plain(plan, theta, tau, tau_u)
    assert grad.dtype == torch.float64 and float(util.abs().max()) > 0
    rng = np.random.default_rng(9)
    eps = 1e-4
    for _ in range(2):
        u = torch.from_numpy(rng.standard_normal(plan.l_cap))
        lp, _, _, cp = te.te_step_plain(plan, theta + eps * u, tau, tau_u)
        lm, _, _, cm = te.te_step_plain(plan, theta - eps * u, tau, tau_u)
        for name, fd, d in (("util", (cp - cm) / (2 * eps), util @ u),
                            ("grad", (lp - lm) / (2 * eps), grad @ u)):
            scale = float(d.abs()) + 1e-3
            assert abs(float(fd - d)) <= 1e-6 * scale, (cell, name, fd, d)


# -- the plain kernels' trip slices -------------------------------------------

@pytest.mark.parametrize("cell", ["grid4", "fabric"])
def test_te_kernels_compose_over_trip_slices(port, cell):
    """Each plain kernel run over trips [0, 9) then [9, 16) from the kept
    boundary state equals its run over [0, 16) — the slice interface
    (``seed=False``) the kernels are held to on the card — and the
    wrappers run the plain versions on CPU tensors, counting no
    launch."""
    torch, te = port.torch, port.te
    args, static = _cell_inputs(cell, 1.0, 7)
    plan, theta, tau, _ = port.weights.te_inputs_from_jax(
        (*args, 1.0, 1.0), n_cap=static[5], trips=static[-1],
        has_res=static[-2], device="cpu")
    s, n, T, cut = plan.srcs.numel(), plan.n_cap, plan.trips, 9
    fields = torch.empty((T + 1, s, n))
    launches = te.te_relax.launches
    te.te_relax(plan, theta, fields, tau)
    assert te.te_relax.launches == launches
    part = fields.clone()
    part[1:] = 0.0
    te.te_relax(plan, theta, part[:cut + 1], tau)
    tail = part[cut:].clone()
    te.te_relax(plan, theta, tail, tau, seed=False)
    assert torch.equal(part[:cut + 1], fields[:cut + 1])
    assert torch.equal(tail, fields[cut:])
    v = torch.softmax(torch.linspace(-1.0, 1.0, plan.l_cap), 0)
    tf = torch.empty_like(fields)
    te.te_relax_jvp(plan, theta, v, fields, tf, tau)
    tf2 = torch.empty_like(fields)
    te.te_relax_jvp(plan, theta, v, fields[:cut + 1], tf2[:cut + 1], tau)
    te.te_relax_jvp(plan, theta, v, fields[cut:], tf2[cut:], tau,
                    seed=False)
    assert torch.equal(tf, tf2)

    def bufs(n_lam):
        return ([torch.empty((s, n)) for _ in range(n_lam)]
                + [torch.empty((s, plan.sh_link.numel())),
                   torch.empty((s, plan.rs_link.numel()))])

    whole, split = bufs(1), bufs(1)
    te.te_relax_vjp(plan, theta, fields, *whole, tau)
    te.te_relax_vjp(plan, theta, fields[cut:], *split, tau)
    te.te_relax_vjp(plan, theta, fields[:cut + 1], *split, tau, seed=False)
    assert all(torch.equal(a, b) for a, b in zip(whole, split))
    assert float(te.te_link_sum(plan, *whole[1:]).abs().max()) > 0
    whole2, split2 = bufs(2), bufs(2)
    te.te_relax_vjp_jvp(plan, theta, v, fields, tf, *whole2, tau)
    te.te_relax_vjp_jvp(plan, theta, v, fields[cut:], tf[cut:], *split2,
                        tau)
    te.te_relax_vjp_jvp(plan, theta, v, fields[:cut + 1], tf[:cut + 1],
                        *split2, tau, seed=False)
    assert all(torch.equal(a, b) for a, b in zip(whole2, split2))
    # K16's adjoint half is K14's
    assert torch.equal(whole2[0], whole[0])


def test_te_wrappers_marshal_their_launches(port, monkeypatch):
    """On a CUDA tensor each wrapper launches its own entry point of
    ``csrc/te.cu`` with one argument for each letter of its signature
    (a tensor of the letter's dtype or None where it names a tensor),
    counts the launch, and refuses a buffer of the wrong shape or a tau
    outside the kernels' domain — checked here with the launch
    recorded instead of run (no card)."""
    torch, te = port.torch, port.te
    args, static = _cell_inputs("fabric", 1.0, 3)
    plan, theta, tau, tau_u = port.weights.te_inputs_from_jax(
        (*args, 1.0, 1.0), n_cap=static[5], trips=static[-1],
        has_res=static[-2], device="cpu")
    calls = []
    monkeypatch.setattr(te, "_is_cpu", lambda t: False)
    monkeypatch.setattr(te.cuda, "launch",
                        lambda lib, fn, sig, *a: calls.append((lib, fn, sig,
                                                               a)))
    s, n, T = plan.srcs.numel(), plan.n_cap, plan.trips
    fields, tfields = torch.empty((T + 1, s, n)), torch.empty((T + 1, s, n))
    lam, lam_t = torch.empty((s, n)), torch.empty((s, n))
    ct = (torch.empty((s, plan.sh_link.numel())),
          torch.empty((s, plan.rs_link.numel())))
    v = torch.empty(plan.l_cap)
    before = {f: getattr(te, f).launches for f in (
        "te_relax", "te_relax_jvp", "te_relax_vjp", "te_relax_vjp_jvp",
        "te_link_sum", "te_loss")}
    te.te_relax(plan, theta, fields, tau)
    te.te_relax_jvp(plan, theta, v, fields, tfields, tau)
    te.te_relax_vjp(plan, theta, fields, lam, *ct, tau)
    te.te_relax_vjp_jvp(plan, theta, v, fields, tfields, lam, lam_t, *ct,
                        tau)
    te.te_link_sum(plan, *ct)
    te.te_loss(plan, v, fields[-1], tau_u)
    assert [(lib, fn) for lib, fn, _, _ in calls] == [
        ("te", f) for f in before]
    dtypes = {"t": torch.int32, "T": torch.float32}
    for _, fn, sig, a in calls:
        assert len(sig) == len(a), fn
        assert set(sig) <= {"t", "T", "i", "f"}, fn
        for letter, x in zip(sig, a):
            if letter in dtypes:
                assert x is None or x.dtype == dtypes[letter], (fn, letter)
            else:
                assert isinstance(x, float if letter == "f" else int), (
                    fn, letter)
    assert all(getattr(te, f).launches == k + 1 for f, k in before.items())
    with pytest.raises(ValueError):
        te.te_relax_vjp(plan, theta, fields, lam[:, :-1], *ct, tau)
    with pytest.raises(ValueError):
        te.te_relax(plan, theta, fields, te.MAX_TAU * 2)


# -- WhatIfEngine.optimize against the JAX loop -------------------------------

def _diamond(topo, pfa):
    """tests/test_whatif.py:353's diamond: a cheap and an expensive
    branch from s to t."""
    nodes = {"s": ["a", "b"], "a": ["s", "t"], "b": ["s", "t"],
             "t": ["a", "b"]}
    metric = {("s", "b"): 4, ("b", "s"): 4, ("b", "t"): 4, ("t", "b"): 4}
    return topo._mk_dbs(
        {n: [topo._adj(n, o, metric=metric.get((n, o), 1)) for o in p]
         for n, p in nodes.items()},
        AREA, pfa.SP_ECMP, True)


_GRID3_DEMANDS = [
    {"src": "node-0-0", "dst": "node-2-2", "volume": 4.0},
    {"src": "node-0-2", "dst": "node-2-0"},
    {"src": "node-0-0", "dst": "node-0-0"},  # rejected: src == dst
    {"src": "node-0-0", "dst": "nope"},  # rejected: unknown
]
_DIAMOND_DEMANDS = [{"src": "s", "dst": "t", "volume": 10.0}]


def _engine(port, gen, me):
    adj_dbs, prefix_dbs = gen()
    states, ps = port.topologies.build_states(adj_dbs, prefix_dbs)
    solver = port.gpu_solver.GpuSpfSolver(me, device="cpu")
    assert solver.build_route_db(me, states, ps) is not None
    return port.whatif.WhatIfEngine(solver), states, ps


@pytest.mark.parametrize("case", ["grid3", "diamond"])
def test_optimize_matches_jax_loop(port, jit_te, case):
    """The port's plan equals the reference's planning over
    ``openr_tpu.ops.edgeplan`` (theta0, slots, link names, demands,
    rejected, trips, the padded step inputs), and ``optimize`` equals
    the JAX loop: the loss curve within tolerance, the proposed changes
    (link, metric, proposed value) equal, the utilizations within
    tolerance."""
    from openr_tpu.models.topologies import _adj, _mk_dbs
    from openr_tpu.types import PrefixForwardingAlgorithm

    if case == "grid3":
        gen_j, gen_p = (lambda: topologies.grid(3),
                        lambda: port.topologies.grid(3))
        me, demands, iters = "node-0-0", _GRID3_DEMANDS, 2
    else:
        jtopo = types.SimpleNamespace(_adj=_adj, _mk_dbs=_mk_dbs)
        gen_j = lambda: _diamond(jtopo, PrefixForwardingAlgorithm)  # noqa
        gen_p = lambda: _diamond(port.topologies, port.PFA)  # noqa: E731
        me, demands, iters = "s", _DIAMOND_DEMANDS, 30
    jp = _jax_plan(gen_j, demands)
    eng, states, ps = _engine(port, gen_p, me)
    job = eng.plan_optimize(states, ps, demands, iters=iters, lr=0.05)
    assert job.link_names == jp.names
    np.testing.assert_array_equal(job.theta0, np.float32(jp.theta0))
    for got, want in zip((*job.sh, *job.rs), jp.slots):
        np.testing.assert_array_equal(got, np.asarray(want, np.int32))
    assert job.demands == jp.demands and len(job.rejected) == jp.rejected
    # the diameter's trips (8 relaxations each) + 2, at least 8
    assert job.trips == 18
    args, _ = _jax_arrays(jp.plan, jp.theta0, *jp.slots, jp.demands)
    for got, want in zip(job.arrays(), (args[0], *args[4:])):
        np.testing.assert_array_equal(got, want)
    want = _jax_optimize(jit_te, jp, job.trips, iters, 0.05)
    out = job.run()
    assert len(out["loss_curve"]) == iters
    assert_close(out["loss_curve"], want["loss_curve"], TOL["loss"],
                 f"{case} loss_curve", unit=1e-4)
    key = [(c["link"], c["metric"], c["proposed"]) for c in out["changes"]]
    assert key == [(c["link"], c["metric"], c["proposed"])
                   for c in want["changes"]]
    if want["changes"]:
        assert_close([c["utilization"] for c in out["changes"]],
                     [c["utilization"] for c in want["changes"]],
                     TOL["util"], f"{case} utilization", unit=1e-3)
    for name in ("max_util_before", "max_util_after"):
        assert_close(out[name], want[name], TOL["util"], f"{case} {name}",
                     unit=1e-3)
    if case == "diamond":
        # tests/test_whatif.py:353's own claims
        assert out["loss_curve"][-1] < out["loss_curve"][0]
        assert out["changes"]


def test_optimize_smoke_structure(port):
    """tests/test_whatif.py:328 in the port's types: rejected demands,
    finite losses, proposals in range, the counter, the trace and its
    spans, the ValueError cases."""
    eng, states, ps = _engine(port, lambda: port.topologies.grid(3),
                              "node-0-0")
    before = port.counters.get_counter("whatif.optimizes") or 0
    out = eng.optimize(states, ps, _GRID3_DEMANDS, iters=2, lr=0.05)
    assert out["iters"] == 2 and len(out["loss_curve"]) == 2
    assert out["demands"] == 2 and out["rejected_demands"] == 2
    assert np.isfinite(out["loss_curve"]).all()
    assert out["max_util_before"] > 0 and out["optimize_ms"] > 0
    for ch in out["changes"]:
        assert 1 <= ch["proposed"] <= MAX_METRIC
    assert port.counters.get_counter("whatif.optimizes") - before == 1
    trace = port.tracer.traces(1)[0]
    assert (trace["name"], trace["status"]) == ("whatif.optimize", "whatif")
    assert [sp["name"] for sp in trace["spans"]] == [
        "whatif.snapshot", "whatif.dispatch", "whatif.gd"]
    assert trace["spans"][-1]["attributes"]["kernel"].startswith(
        "te_step[l=16,s=2,d=2,n=16,t=")
    with pytest.raises(ValueError):
        eng.optimize(states, ps, [])
    with pytest.raises(ValueError):
        eng.optimize(states, ps, [{"src": "nope", "dst": "node-0-0"}])
    assert port.tracer.traces(1)[0]["status"] == "error"
