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
    recorded instead of run (no card). K14 and K16 pass their cluster
    layout (``adjoint_layout`` for a card of 132 SMs) and the plan's
    held scratch, the same buffers on every call."""
    torch, te = port.torch, port.te
    args, static = _cell_inputs("fabric", 1.0, 3)
    plan, theta, tau, tau_u = port.weights.te_inputs_from_jax(
        (*args, 1.0, 1.0), n_cap=static[5], trips=static[-1],
        has_res=static[-2], device="cpu")
    calls = []
    monkeypatch.setattr(te, "_is_cpu", lambda t: False)
    monkeypatch.setattr(te, "_sm_count", lambda card: 132)
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
    n_plan = len(te._PLAN_SIG)
    c = plan.deltas.numel()
    scr = []
    for (_, fn, _, a), tan in ((calls[2], False), (calls[3], True)):
        lay = te.adjoint_layout(s, n, c, tan, 132)
        tabs = te.adjoint_tables(plan.held["host"], c, lay)
        assert a[n_plan + 10:n_plan + 17] == (
            lay.cluster, lay.span, int(lay.own_smem), int(lay.field_smem),
            int(lay.gx_smem), lay.smem, lay.threads), fn
        assert a[n_plan + 8:n_plan + 10] == (tabs["es"], tabs["er"])
        for k, name in enumerate(("order", "e0", "r0", "snbr", "slnk",
                                  "rsrc", "rlnk", "rslot")):
            assert torch.equal(a[n_plan + k], torch.from_numpy(tabs[name]))
        assert lay.smem <= te.SMEM_BLOCK and lay.threads <= te.ADJ_THREADS
        scr.append(a[n_plan + 17:n_plan + 19])
        assert a[n_plan + 19] is None  # the row scalars in shared memory
        assert tuple(scr[-1][0].shape) == (2 * (tabs["es"] + tabs["er"]
                                                + c * n),)
        assert tuple(scr[-1][1].shape) == (s, tabs["er"] + c * n)
    # the scratch is the plan's, the same for K14 and K16 at one layout
    assert [t.data_ptr() for t in scr[0]] == [t.data_ptr() for t in scr[1]]
    with pytest.raises(ValueError):
        te.te_relax_vjp(plan, theta, fields, lam[:, :-1], *ct, tau)
    with pytest.raises(ValueError):
        te.te_relax(plan, theta, fields, te.MAX_TAU * 2)


@pytest.mark.parametrize("cell", ["grid4", "fabric"])
def test_te_plan_adjoint_tables(port, cell):
    """``te_plan``'s tables for the adjoint's cluster launch agree with
    the ones they are built from: ``rc_pos`` puts every live residual
    entry at its place among the entries by receiver (``inv_ent``), so a
    node's received cotangents are the one run ``inv_ptr[j]`` to
    ``inv_ptr[j + 1]`` and their sum in that run's order is the sum over
    ``inv_ent``'s, bit for bit; ``row_fill`` counts each row's live
    entries; ``dem_ptr`` / ``dem_ids`` list each source's demands in
    demand order; the host tables ``adjoint_tables`` reads agree with
    the plan's device tables."""
    te = port.te
    args, static = _cell_inputs(cell, 1.0, 7)
    plan, _, _, _ = port.weights.te_inputs_from_jax(
        (*args, 1.0, 1.0), n_cap=static[5], trips=static[-1],
        has_res=static[-2], device="cpu")
    n = plan.n_cap
    host = plan.held["host"]
    inv_ptr, inv_ent = plan.inv_ptr.numpy(), host["inv_ent"]
    rc_pos = host["rc_pos"]
    n_live = len(inv_ent)
    assert (host["inv_ptr"] == inv_ptr).all() and inv_ptr[-1] == n_live
    assert (n_live > 0) == plan.has_res
    assert sorted(rc_pos) == list(range(n_live))
    assert (inv_ent[rc_pos] == np.arange(n_live)).all()
    # each live entry (row-major) and the node it sends to
    nbr = plan.res_nbr.numpy()
    fill = (nbr >= 0).sum(axis=1) * (plan.res_rows.numpy() >= 0)
    ent_nbr = np.concatenate([nbr[r, :f] for r, f in enumerate(fill)] or
                             [np.zeros(0, np.int32)])
    assert len(ent_nbr) == n_live
    assert (host["ent_nbr"] == ent_nbr).all()
    assert (plan.row_fill.numpy() == fill).all()
    assert (host["row_start"] == np.cumsum(fill) - fill).all()
    k = nbr.shape[1]
    flat = np.concatenate([r * k + np.arange(f) for r, f in enumerate(fill)]
                          or [np.zeros(0, np.int64)])
    assert (host["ent_lnk"] == plan.rs_lnk.numpy()[flat]).all()
    # the residual slots: each live plane word's, in rs_flat's order
    rs_slot = host["rs_slot"]
    assert (rs_slot[flat] >= 0).all() and (host["ent_slot"] == rs_slot[flat]
                                           ).all()
    words = np.flatnonzero(rs_slot >= 0)
    assert (plan.rs_flat.numpy()[rs_slot[words]] == words).all()
    rng = np.random.default_rng(3)
    sent = rng.standard_normal(n_live).astype(np.float32)
    recv = np.zeros(n_live, np.float32)
    recv[rc_pos] = sent  # phase 1's writes
    for j in range(n):
        run = np.arange(inv_ptr[j], inv_ptr[j + 1])
        assert (ent_nbr[inv_ent[run]] == j).all()
        assert (np.diff(inv_ent[run]) > 0).all()  # row-major within a run
        a = b = np.float32(0.0)
        for e in run:
            a = np.float32(a + recv[e])
            b = np.float32(b + sent[inv_ent[e]])
        assert a == b
    dem_row, dem_ptr = plan.dem_row.numpy(), plan.dem_ptr.numpy()
    dem_ids = plan.dem_ids.numpy()
    assert dem_ptr[0] == 0 and dem_ptr[-1] == len(dem_row)
    for src in range(plan.srcs.numel()):
        assert list(dem_ids[dem_ptr[src]:dem_ptr[src + 1]]) == list(
            np.flatnonzero(dem_row == src))
    node_fill = np.zeros(n, np.int64)
    rows = plan.res_rows.numpy()
    node_fill[rows[rows >= 0]] = fill[rows >= 0]
    assert (host["node_fill"] == node_fill).all()


@pytest.mark.parametrize("cell,n_sm", [
    ("grid4", 132), ("fabric", 132), ("fabric", 6), ("fabric", 1)])
def test_adjoint_tables_interleave_rows(port, cell, n_sm):
    """``adjoint_tables`` at the layout of a card of ``n_sm`` SMs (one to
    eight blocks a source, 32 to 1,024 threads): each position's row, in
    column order, at its sender indices e0 + 32 c (neighbour, link), no
    two entries on one index; and each node's received entries at r0 +
    32 c are its run of ``inv_ent``, in order, each naming its sender's
    block rank and index there, its link and its slot — the entries the
    kernel's receivers walk every trip."""
    te = port.te
    args, static = _cell_inputs(cell, 1.0, 7)
    plan, _, _, _ = port.weights.te_inputs_from_jax(
        (*args, 1.0, 1.0), n_cap=static[5], trips=static[-1],
        has_res=static[-2], device="cpu")
    n, c = plan.n_cap, plan.deltas.numel()
    for tan in (False, True):
        lay = te.adjoint_layout(plan.srcs.numel(), n, c, tan, n_sm)
        t = te.adjoint_tables(plan.held["host"], c, lay)
        order = t["order"]
        assert sorted(order) == list(range(n))
        row_of, rows = plan.row_of.numpy(), plan.res_nbr.numpy()
        k = rows.shape[1]
        host = plan.held["host"]
        rs_lnk, rs_slot = plan.rs_lnk.numpy(), host["rs_slot"]
        fill = plan.row_fill.numpy()
        seen = np.zeros(t["es"], bool)
        for pos, i in enumerate(order):
            r = row_of[i]
            if r < 0:
                continue
            idx = t["e0"][pos] + 32 * np.arange(fill[r])
            assert not seen[idx].any()
            seen[idx] = True
            assert (t["snbr"][idx] == rows[r, :fill[r]]).all()
            assert (t["slnk"][idx] == rs_lnk[r * k:r * k + fill[r]]).all()
        assert seen.sum() == plan.inv_ptr[-1]
        # each live entry (row-major): its sender node, link and slot
        sender = plan.res_rows.numpy()[host["ent_row"]]
        flat = host["ent_row"] * k + host["ent_col"]
        inv_ptr, inv_ent = plan.inv_ptr.numpy(), host["inv_ent"]
        seen = np.zeros(max(t["er"], 1), bool)
        for pos, j in enumerate(order):
            run = inv_ent[inv_ptr[j]:inv_ptr[j + 1]]
            idx = t["r0"][pos] + 32 * np.arange(len(run))
            assert not seen[idx].any()
            seen[idx] = True
            src = t["rsrc"][idx]
            assert ((src >> 24) * lay.span + (src & 0xffffff)
                    == sender[run]).all()
            assert (t["rlnk"][idx] == rs_lnk[flat[run]]).all()
            assert (t["rslot"][idx] == rs_slot[flat[run]]).all()
        assert seen.sum() == plan.inv_ptr[-1]


@pytest.mark.parametrize("fills,threads", [
    ("fabric10k", 1024), ("fabric10k", 256), ("uneven", 64),
    ("flat", 1024)])
def test_adjoint_order_deals_rows_to_warps(port, fills, threads):
    """``adjoint_order``: every block of the cluster visits exactly the
    nodes of its own span, each warp's 32 lanes take rows of about one
    fill, and the warps' work (their rows' longest fill a pass) is
    within one group of even — where index order puts a pod's eight
    fill-100 rows beside its 64 fill-8 rows in a warp. One fill: index
    order."""
    te = port.te
    rng = np.random.default_rng(5)
    if fills == "fabric10k":
        # 96 pods of 8 fsws (100 entries) and 64 rsws (8), 288 spines
        # (96), pads to 8,192
        pod = [100] * 8 + [8] * 64
        node_fill = np.array(pod * 96 + [96] * 288 + [0] * 992)
    elif fills == "uneven":
        node_fill = rng.integers(0, 130, 1000)
    else:
        node_fill = np.full(3000, 5)
    n, n_cls = len(node_fill), 4
    lay = te.adjoint_layout(64, n, n_cls, True, 132)._replace(
        threads=threads)
    order = te.adjoint_order(node_fill, n_cls, lay)
    assert sorted(order) == list(range(n))
    if fills == "flat":
        assert (order == np.arange(n)).all()
        return
    cost = 3 * node_fill + 2 * n_cls
    for q in range(lay.cluster):
        lo, hi = q * lay.span, min(n, (q + 1) * lay.span)
        part = order[lo:hi]
        assert sorted(part) == list(range(lo, hi))
        warps = np.zeros(-(-threads // 32))
        naive = np.zeros_like(warps)
        for at in range(0, hi - lo, 32):
            w = (at % threads) // 32
            warps[w] += cost[part[at:at + 32]].max()
            naive[w] += cost[lo + at:min(hi, lo + at + 32)].max()
            # a warp's rows: one fill, or two neighbours in fill order
            got = sorted(node_fill[part[at:at + 32]])
            want = sorted(node_fill[lo:hi])[::-1]
            assert got[-1] - got[0] <= max(
                want[i] - want[i + 31] for i in range(len(want) - 31))
        assert warps.max() - warps.min() <= cost.max()
        if fills == "fabric10k":
            assert warps.max() < 0.75 * naive.max()


@pytest.mark.parametrize("n_src,n_cap,n_cls,tan,want", [
    # whatif1k and fabric10k on an H100 (132 SMs): the card full, every
    # buffer in shared memory but K16's received class cotangents at
    # fabric10k
    (32, 1024, 4, False, (4, 256, True, True, True, 13312, 256)),
    (32, 1024, 4, True, (4, 256, True, True, True, 23552, 256)),
    (64, 8192, 4, False, (2, 4096, True, True, True, 180224, 1024)),
    (64, 8192, 4, True, (2, 4096, True, True, False, 180224, 1024)),
    # past shared memory, each buffer where it still fits: the received
    # class cotangents, then the field, then a block's own nodes go to
    # device memory
    (64, 12288, 4, False, (2, 6144, True, True, False, 172032, 1024)),
    (64, 16384, 4, True, (2, 8192, True, False, False, 229376, 1024)),
    (64, 24000, 4, True, (2, 12000, False, True, False, 192000, 1024)),
    (64, 32768, 4, True, (2, 16384, False, False, False, 0, 1024)),
    # many sources: one block each; one source: eight
    (200, 1000, 3, False, (1, 1000, True, True, True, 36000, 1024)),
    (1, 100, 2, False, (8, 13, True, True, True, 764, 32)),
])
def test_adjoint_layout(port, n_src, n_cap, n_cls, tan, want):
    """``adjoint_layout``: the largest cluster whose blocks fit on the
    SMs, the spans that tile the nodes, and what shared memory holds."""
    te = port.te
    lay = te.adjoint_layout(n_src, n_cap, n_cls, tan, 132)
    assert tuple(lay) == want
    assert lay.cluster * lay.span >= n_cap > (lay.cluster - 1) * lay.span
    assert n_src * lay.cluster <= 132 or lay.cluster == 1
    assert lay.smem <= te.SMEM_BLOCK


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
