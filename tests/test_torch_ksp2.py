"""The port's device KSP2 kernels and resident rows
(openr_tpu_torch/ops/ksp2.py, csrc/ksp2.cu) against the JAX package's
``ops/ksp2.py`` (the solver glue: tests/test_torch_ksp2_solver.py).

- The masked batch (K10 overlays + K1s seeds + K1 rows) and the delta
  compaction (K11) against fresh jits of ``_masked_rows_fn`` /
  ``_masked_rows_delta_fn`` (their ``__wrapped__`` factories), with masks
  taken from real first paths, residual masks, pad rows and slots, rows
  that do not change and a ``k_cap`` small enough to overflow.
- ``masked_rows_update`` against the JAX package's, step for step: cold
  init, delta, speculative hit and miss, the chunked path, sticky caps;
  and a JAX cold init carried across (``weights.masked_rows_state_from_
  jax``) followed by a port delta step.

No ``TpuSpfSolver`` is built. The port runs on CPU tensors, so every
kernel runs its plain PyTorch version. Everything is int32: tolerance 0.
"""

import functools
import types

import numpy as np
import pytest

from openr_tpu.models import topologies
from openr_tpu.ops import ksp2 as jksp2
from openr_tpu.ops.edgeplan import _ensure_edge_loc, build_plan, edge_loc_of
from tests.torch_jax_state import jax_state_barrier  # noqa: F401

INF_E = 1 << 29


@pytest.fixture(scope="module")
def port():
    """The port's modules, with torch held to one thread while this
    module's tests run."""
    import torch

    from openr_tpu_torch import weights
    from openr_tpu_torch.ops import ksp2

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(torch=torch, weights=weights, ksp2=ksp2)
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def fresh_caps(port, monkeypatch):
    """Both packages' sticky caps start empty in every test (they are
    module state: one test's caps would change another's b_cap and its
    init / delta branch), and the JAX update runs on fresh jits."""
    monkeypatch.setattr(port.ksp2, "_cap_highwater", {})
    monkeypatch.setattr(jksp2, "_cap_highwater", {})
    monkeypatch.setattr(jksp2, "_masked_rows_fn", _jax_rows_fn)
    monkeypatch.setattr(jksp2, "_masked_rows_delta_fn", _jax_delta_fn)


# fresh jits of the raw JAX factories, one per shape for this module
_jax_rows_fn = functools.lru_cache(None)(jksp2._masked_rows_fn.__wrapped__)
_jax_delta_fn = functools.lru_cache(None)(
    jksp2._masked_rows_delta_fn.__wrapped__)

_CELLS = {
    "grid4": (lambda: topologies.grid(4), "node-0-0"),
    "wan": (lambda: topologies.wan(regions=2, region_side=4, ksp2_every=5),
            "r00-n00-00"),
    "fabric": (lambda: topologies.fabric(pods=4, planes=2, ssws_per_plane=2,
                                         rsws_per_pod=4), "pod000-rsw00"),
}


def _cell(name):
    """-> (JAX LinkState, its plan with edge locations, root index,
    mask_locs: per destination the directed edges of its first paths)."""
    gen, root = _CELLS[name]
    adj_dbs, _ = gen()
    states, _ = topologies.build_states(adj_dbs, [])
    ls = states["0"]
    plan = build_plan(ls)
    _ensure_edge_loc(plan)
    locs = []
    for dest in sorted(ls.node_names()):
        if dest == root or len(locs) == 11:
            continue
        row = []
        for path in ls.get_kth_paths(root, dest, 1):
            for link in path:
                row.append(edge_loc_of(plan, link, link.n1))
                row.append(edge_loc_of(plan, link, link.n2))
        locs.append(row)
    return ls, plan, plan.node_index[root], locs


def _mask_arrays(plan, locs, b_cap, ms_cap, mr_cap):
    r_cap, kr_cap = plan.res_nbr.shape
    mask_s = np.full((b_cap, ms_cap), plan.s_cap * plan.n_cap, np.int32)
    mask_r = np.full((b_cap, mr_cap), r_cap * kr_cap, np.int32)
    for i, row in enumerate(locs):
        si = ri = 0
        for kind, a, b in row:
            if kind == "s":
                mask_s[i, si] = a * plan.n_cap + b
                si += 1
            else:
                mask_r[i, ri] = a * kr_cap + b
                ri += 1
    return mask_s, mask_r


def _plan_args(plan):
    return (plan.deltas, plan.shift_w, plan.res_rows, plan.res_nbr,
            plan.res_w)


def _tensors(port, arrays):
    return tuple(port.torch.tensor(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("name", ["grid4", "wan", "fabric"])
def test_masked_rows_match_jax(port, name):
    """K10 + K1s + K1: the [b_cap, n_cap] masked rows equal
    ``_masked_rows_fn``'s — 11 real rows and 5 pad rows, pad slots, and
    on the fabric residual masks."""
    _, plan, root, locs = _cell(name)
    mask_s, mask_r = _mask_arrays(plan, locs, 16, 32, 32)
    if name == "fabric":
        assert (mask_r < mask_r.max()).any(), "the case needs residual masks"
    r_cap, kr_cap = plan.res_nbr.shape
    has_res = plan.k_res > 0
    fn = _jax_rows_fn(plan.n_cap, plan.s_cap, r_cap, kr_cap, has_res, 16, 32,
                      32)
    want = np.asarray(fn(*_plan_args(plan), np.int32(root), mask_s, mask_r))
    got = port.ksp2.masked_rows(*_tensors(port, _plan_args(plan)), root,
                                *_tensors(port, (mask_s, mask_r)), has_res)
    np.testing.assert_array_equal(got.numpy(), want)
    # the masks matter: some row differs from the unmasked field
    assert (want[:len(locs)] != want[-1]).any()


@pytest.mark.parametrize("name,k_cap", [
    ("grid4", 2), ("wan", 64), ("fabric", 4), ("fabric", 64),
])
def test_masked_rows_delta_match_jax(port, name, k_cap):
    """K11: the packed [cnt | idx | val] buffer and the rows equal
    ``_masked_rows_delta_fn``'s against a previous matrix in which one row
    is unchanged, the others rotated — with k_cap small enough that rows
    overflow (cnt > k_cap) and large enough that none do."""
    _, plan, root, locs = _cell(name)
    mask_s, mask_r = _mask_arrays(plan, locs, 16, 32, 32)
    r_cap, kr_cap = plan.res_nbr.shape
    has_res = plan.k_res > 0
    rows = np.asarray(_jax_rows_fn(
        plan.n_cap, plan.s_cap, r_cap, kr_cap, has_res, 16, 32, 32)(
            *_plan_args(plan), np.int32(root), mask_s, mask_r))
    prev = np.roll(rows, 1, axis=0)
    prev[3] = rows[3]
    fn = _jax_delta_fn(plan.n_cap, plan.s_cap, r_cap, kr_cap, has_res, 16,
                       32, 32, k_cap)
    w_packed, w_dist = fn(*_plan_args(plan), np.int32(root), mask_s, mask_r,
                          prev)
    g_packed, g_dist = port.ksp2.masked_rows_delta(
        *_tensors(port, _plan_args(plan)), root,
        *_tensors(port, (mask_s, mask_r, prev)), has_res, k_cap)
    np.testing.assert_array_equal(g_packed.numpy(), np.asarray(w_packed))
    np.testing.assert_array_equal(g_dist.numpy(), np.asarray(w_dist))
    cnt = np.asarray(w_packed)[:, 0]
    assert cnt[3] == 0
    if k_cap < 8:
        assert (cnt > k_cap).any(), "the case must overflow"
    else:
        assert (cnt > 0).any() and (cnt <= k_cap).all()


def _bump(plan, locs, row, w):
    """Copies of the plan's weight planes with the first shift edge of
    ``locs[row]`` (both directions) set to ``w``: churn that moves that
    row's field."""
    sw, rw = plan.shift_w.copy(), plan.res_w.copy()
    for kind, a, b in locs[row][:2]:
        (sw if kind == "s" else rw)[a, b] = w
    return sw, rw


def _update_both(port, jstate, pstate, plan, sw, rw, root, key, locs,
                 spec=False, k_budget=0):
    """One masked_rows_update on each package over the same planes (with
    a speculative dispatch first when ``spec``): -> the two changed lists,
    the two last_stats."""
    jargs = (sw, plan.res_rows, plan.res_nbr, rw, plan.deltas)
    pargs = _tensors(port, jargs)
    jspec = pspec = None
    if spec:
        jspec = jksp2.masked_rows_dispatch(jstate, plan, *jargs, root,
                                           k_budget)
        pspec = port.ksp2.masked_rows_dispatch(pstate, plan, *pargs, root,
                                               k_budget)
        assert (jspec is None) == (pspec is None)
    want = jksp2.masked_rows_update(jstate, plan, *jargs, root, key, locs,
                                    k_budget, spec=jspec)
    got = port.ksp2.masked_rows_update(pstate, plan, *pargs, root, key, locs,
                                       k_budget, spec=pspec)
    return want, got, dict(jksp2.last_stats), dict(port.ksp2.last_stats)


def _assert_same_update(jstate, pstate, want, got, jstats, pstats, ctx):
    assert len(want) == len(got), ctx
    for w, g in zip(want, got):
        if w is None or w is True:
            assert g is w, ctx
        else:
            np.testing.assert_array_equal(g, w, err_msg=ctx)
    np.testing.assert_array_equal(pstate.host_rows, jstate.host_rows,
                                  err_msg=ctx)
    assert pstats == jstats, ctx
    assert (pstate.b_cap, pstate.ms_cap, pstate.mr_cap) == (
        jstate.b_cap, jstate.ms_cap, jstate.mr_cap), ctx
    if jstate.d_prev is None:
        assert pstate.d_prev is None, ctx
    else:
        np.testing.assert_array_equal(pstate.d_prev.numpy(),
                                      np.asarray(jstate.d_prev), err_msg=ctx)


@pytest.mark.parametrize("name", ["grid4", "fabric"])
def test_masked_rows_update_flow_matches_jax(port, name, monkeypatch):
    """The resident-row flow, step for step against the JAX package's:
    cold init; churn through the delta path (one row overflowing a small
    budget); a speculative hit (masks unchanged); a speculative miss (a
    row's masks changed: the token is dropped, the delta path runs
    against the untouched previous rows); fewer rows under sticky caps;
    and the chunked stateless path past the resident-row bound."""
    _, plan, root, locs = _cell(name)
    jstate, pstate = jksp2.MaskedRowsState(), port.ksp2.MaskedRowsState()
    key = tuple(range(len(locs)))
    steps = [
        ("init", plan.shift_w, plan.res_w, locs, False, 0),
        ("delta", *_bump(plan, locs, 2, 9), locs, False, 0),
        ("overflow", *_bump(plan, locs, 5, 40), locs, False, 2),
        ("spec hit", *_bump(plan, locs, 5, 3), locs, True, 0),
        ("spec miss", *_bump(plan, locs, 5, 3),
         [row[:2] if len(row) > 2 else row for row in locs], True, 0),
    ]
    seen = set()
    for ctx, sw, rw, step_locs, spec, k_budget in steps:
        want, got, jstats, pstats = _update_both(
            port, jstate, pstate, plan, sw, rw, root, key, step_locs, spec,
            k_budget)
        _assert_same_update(jstate, pstate, want, got, jstats, pstats, ctx)
        seen.update(k for k in pstats if k in ("init", "spec_hit"))
        if ctx == "overflow":
            assert pstats["overflow_rows"] > 0
        if ctx == "spec miss":
            assert "spec_hit" not in pstats and "init" not in pstats
    assert seen == {"init", "spec_hit"}
    # fewer rows: the caps stay where they grew (sticky)
    want, got, jstats, pstats = _update_both(
        port, jstate, pstate, plan, plan.shift_w, plan.res_w, root,
        key[:3], locs[:3])
    _assert_same_update(jstate, pstate, want, got, jstats, pstats, "sticky")
    assert pstate.b_cap == 16 and pstats["init"] == 1
    assert port.ksp2._cap_highwater == jksp2._cap_highwater
    # the chunked path: more rows than the resident bound, no resident state
    monkeypatch.setattr(port.ksp2, "_MAX_RESIDENT_ROWS", 4)
    monkeypatch.setattr(jksp2, "_MAX_RESIDENT_ROWS", 4)
    want, got, jstats, pstats = _update_both(
        port, jstate, pstate, plan, plan.shift_w, plan.res_w, root, key,
        locs)
    _assert_same_update(jstate, pstate, want, got, jstats, pstats, "chunked")
    assert pstate.d_prev is None and pstate.mask_s is None


def test_jax_state_carried_into_a_port_delta_step(port):
    """A JAX cold init, carried across with
    ``weights.masked_rows_state_from_jax``, then a delta step on each
    side: the port's packed buffer equals the JAX delta step's byte for
    byte, and so do the refreshed rows and their host mirror."""
    _, plan, root, locs = _cell("wan")
    jstate = jksp2.MaskedRowsState()
    key = tuple(range(len(locs)))
    jksp2.masked_rows_update(jstate, plan, plan.shift_w, plan.res_rows,
                             plan.res_nbr, plan.res_w, plan.deltas, root,
                             key, locs)
    pstate = port.weights.masked_rows_state_from_jax(jstate, device="cpu")
    assert pstate.host_rows is not jstate.host_rows
    sw, rw = _bump(plan, locs, 4, 25)
    r_cap, kr_cap = plan.res_nbr.shape
    k_cap = min(jksp2._DELTA_K, jksp2._next_pow2(plan.n_cap, 64))
    fn = _jax_delta_fn(plan.n_cap, plan.s_cap, r_cap, kr_cap, plan.k_res > 0,
                       jstate.b_cap, jstate.ms_cap, jstate.mr_cap, k_cap)
    w_packed, _ = fn(plan.deltas, sw, plan.res_rows, plan.res_nbr, rw,
                     np.int32(root), jstate.mask_s, jstate.mask_r,
                     jstate.d_prev)
    g_packed, _ = port.ksp2.masked_rows_delta(
        *_tensors(port, (plan.deltas, sw, plan.res_rows, plan.res_nbr, rw)),
        root, *_tensors(port, (pstate.mask_s, pstate.mask_r)), pstate.d_prev,
        plan.k_res > 0, k_cap)
    np.testing.assert_array_equal(g_packed.numpy(), np.asarray(w_packed))
    assert np.asarray(w_packed)[:, 0].any()
    want, got, jstats, pstats = _update_both(
        port, jstate, pstate, plan, sw, rw, root, key, locs)
    _assert_same_update(jstate, pstate, want, got, jstats, pstats, "carried")
    assert "init" not in pstats
