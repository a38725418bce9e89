"""The port's SSSP relaxation (K1s init, K1 Jacobi step, K2 Δ-stepping
ladder — openr_tpu_torch/ops/relax.py) against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX functions
(``ops/relax.make_relax`` / ``run_sync`` / ``run_bucketed`` and
``tpu_solver._plan_sssp``, jitted on the JAX CPU backend) and through
the port's loops on CPU tensors, which run each kernel's plain PyTorch
version. Outputs are int32 and must be equal: tolerance 0 for the
distance planes and for the trip and round counts.

Port modules import inside the fixture so that collecting this file in
a worker that never runs it imports no torch.
"""

import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openr_tpu.decision.tpu_solver import _plan_sssp
from openr_tpu.models import topologies
from openr_tpu.ops import relax as jrelax
from openr_tpu.ops.edgeplan import build_plan
from tests.torch_jax_state import jax_state_barrier  # noqa: F401

INF_E = 1 << 29


@pytest.fixture(scope="module")
def port():
    """The port's relax module, with torch held to one thread while
    this module's tests run."""
    import torch

    from openr_tpu_torch.ops import relax

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield types.SimpleNamespace(torch=torch, relax=relax)
    torch.set_num_threads(prev)


def _random_plane(rng, n_cap, s_cap, d_cap, r_cap, kr_cap):
    """A random shift-decomposed graph: signed class shifts (two pad
    classes with shift 0 / all-INF weights), ~1/8 INF edges, and a
    residual ELL with clipped pad rows and repeated destinations."""
    deltas = rng.integers(-n_cap + 1, n_cap, size=s_cap).astype(np.int32)
    deltas[-2:] = 0
    shift_w = rng.integers(0, 9, size=(s_cap, n_cap)).astype(np.int32)
    shift_w[rng.random((s_cap, n_cap)) < 0.125] = INF_E
    shift_w[-2:] = INF_E
    rows = rng.integers(0, n_cap, size=r_cap).astype(np.int32)
    rows[:2] = rows[2]  # repeated destination rows
    rows[-1] = -1  # a pad row, clipped to row 0
    nbr = rng.integers(0, n_cap, size=(r_cap, kr_cap)).astype(np.int32)
    rw = rng.integers(0, 40, size=(r_cap, kr_cap)).astype(np.int32)
    rw[-1] = INF_E
    dist0 = np.full((d_cap, n_cap), INF_E, np.int32)
    dist0[np.arange(d_cap), rng.integers(0, n_cap, size=d_cap)] = 0
    return deltas, shift_w, (np.clip(rows, 0, n_cap - 1), nbr, rw), dist0


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("kernel", ["sync", "bucketed"])
def test_relax_loops_match_jax_on_random_planes(port, seed, kernel):
    torch = port.torch
    n_cap, s_cap, d_cap = 64, 6, 3
    rng = np.random.default_rng(seed)
    deltas, shift_w, residual, dist0 = _random_plane(
        rng, n_cap, s_cap, d_cap, r_cap=5, kr_cap=3
    )
    delta_exp = jrelax.derive_delta_exp(deltas, shift_w)

    def jax_solve(deltas, shift_w, rows, nbr, rw, dist0):
        relax = jrelax.make_relax(
            deltas, s_cap, lambda k: shift_w[k], residual=(rows, nbr, rw)
        )
        if kernel == "bucketed":
            return jrelax.run_bucketed(
                relax, dist0, deltas, shift_w, lambda k: shift_w[k],
                n_cap, s_cap, delta_exp,
            )
        return jrelax.run_sync(relax, dist0, jrelax.max_trips(n_cap))

    want = jax.jit(jax_solve)(
        jnp.asarray(deltas), jnp.asarray(shift_w),
        *(jnp.asarray(a) for a in residual), jnp.asarray(dist0),
    )

    t = [torch.tensor(a) for a in (deltas, shift_w, *residual, dist0)]
    t_deltas, t_sw, t_res, t_dist0 = t[0], t[1], tuple(t[2:5]), t[5]

    def step(dist, out, flag):
        port.relax.relax_step(dist, out, flag, t_deltas, t_sw, t_res)

    if kernel == "bucketed":
        got = port.relax.run_bucketed(
            step, t_dist0, t_deltas, t_sw, n_cap, s_cap, delta_exp
        )
    else:
        got = port.relax.run_sync(step, t_dist0, port.relax.max_trips(n_cap))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert (got[1], got[2]) == (int(want[1]), int(want[2]))


def _sssp_case(name):
    if name == "grid":
        adj_dbs, _ = topologies.grid(6)
        me = "node-2-3"
    elif name == "fat_tree":
        adj_dbs, _ = topologies.fat_tree()
        me = "rsw-0-0"
    else:
        adj_dbs, _ = topologies.random_mesh(30, seed=7)
        me = "node-4"
    states, _ = topologies.build_states(adj_dbs, [])
    ls = states["0"]
    plan = build_plan(ls)
    root_nbr, root_w, _ = plan.out_links(ls, me)
    return plan, plan.node_index[me], root_nbr, root_w


@pytest.mark.parametrize("name", ["grid", "fat_tree", "random_mesh"])
def test_plan_sssp_matches_jax(port, name):
    """K1s root masking + seeds, then the default kernel for the plan
    (bucketed where it derived a Δ) and the sync rounds."""
    torch = port.torch
    plan, root, root_nbr, root_w = _sssp_case(name)
    has_res = plan.k_res > 0
    arrays = (plan.deltas, plan.shift_w, plan.res_rows, plan.res_nbr,
              plan.res_w)
    kernels = ["sync"] + (["bucketed"] if plan.delta_exp > 0 else [])
    for kernel in kernels:
        dexp = plan.delta_exp if kernel == "bucketed" else 0

        def jax_solve(*a, kernel=kernel, dexp=dexp):
            return _plan_sssp(
                *a, plan.s_cap, has_res, plan.n_cap, root_nbr.shape[0],
                jrelax.max_trips(plan.n_cap), kernel, dexp,
            )

        want = jax.jit(jax_solve)(
            *(jnp.asarray(a) for a in arrays), jnp.int32(root),
            jnp.asarray(root_nbr), jnp.asarray(root_w),
        )
        t = [torch.tensor(a) for a in arrays]
        got = port.relax.plan_sssp(
            *t, root, torch.tensor(root_nbr), torch.tensor(root_w),
            has_res, kernel, dexp,
        )
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert (got[1], got[2]) == (int(want[1]), int(want[2])), kernel


def _held_init_matches_jax(port, residual: bool, g: int) -> None:
    """``sssp_init_plain(..., out=held)`` twice into the same held
    outputs (first filled with -7), with other roots and seeds: each call
    writes every word — equal to a fresh call without ``out`` — its seed
    plane is ``_plan_sssp``'s (no trip: the seed plane itself), its mask
    the one ``_plan_sssp`` applies (the root's class column and the
    residual slots out of the root at INF_E, the indices clipped), and
    the SSSP from the held outputs reaches ``_plan_sssp``'s fixpoint, lane
    for lane."""
    torch, relax = port.torch, port.relax
    n_cap, s_cap, d_cap, r_cap, kr_cap = 64, 6, 3, 5, 3
    rng = np.random.default_rng(41 + g + 2 * residual)
    planes = [_random_plane(rng, n_cap, s_cap, d_cap, r_cap, kr_cap)
              for _ in range(g)]
    deltas, shift_w = (np.stack([p[i] for p in planes]) for i in (0, 1))
    rows, nbr, rw = (np.stack([p[2][j] for p in planes]) for j in range(3))
    rows[:, -1] = -1  # a pad row, clipped by K1s
    nbr[:, 0, 0] = n_cap + 3  # an index past the plane, clipped
    jitted = {trips: jax.jit(partial(
        _plan_sssp, s_cap=s_cap, has_res=residual, n_cap=n_cap, d_cap=d_cap,
        max_trips=trips)) for trips in (0, relax.max_trips(n_cap))}
    held = None
    for call in range(2):
        roots = rng.integers(0, n_cap, size=g).astype(np.int32)
        nbr[:, 1, 1] = roots  # a residual slot out of the root
        seeds = rng.integers(-1, n_cap + 2, size=(g, d_cap)).astype(np.int32)
        seeds_w = rng.integers(1, 9, size=(g, d_cap)).astype(np.int32)
        seeds_w[:, -1] = INF_E  # a lane without a live seed
        args = [torch.tensor(a if g > 1 else a[0]) for a in (
            shift_w, rows, nbr, rw)]
        root = torch.tensor(roots) if g > 1 else int(roots[0])
        sargs = [torch.tensor(a if g > 1 else a[0]) for a in (seeds, seeds_w)]
        if held is None:
            held = relax.init_outputs(*args, sargs[0], n_cap)
            for t in (held[0], *held[1], held[2]):
                t.fill_(-7)
        got = relax.sssp_init_plain(*args, root, *sargs, out=held)
        assert got is held
        fresh = relax.sssp_init_plain(*args, root, *sargs)
        for h, f in zip((held[0], *held[1], held[2]),
                        (fresh[0], *fresh[1], fresh[2])):
            assert h.dtype == torch.int32
            np.testing.assert_array_equal(h.numpy(), f.numpy())
        res_t = held[1] if residual else None
        for lane in range(g):
            r = int(roots[lane])

            def lane_of(t):
                return (t[lane] if g > 1 else t).numpy()

            def jax_plan(trips, lane=lane, r=r):
                return jitted[trips](
                    deltas[lane], shift_w[lane], rows[lane], nbr[lane],
                    rw[lane], np.int32(r), seeds[lane], seeds_w[lane])

            np.testing.assert_array_equal(lane_of(held[2]),
                                          np.asarray(jax_plan(0)[0]))
            want_sw = shift_w[lane].copy()
            want_sw[:, r] = INF_E
            np.testing.assert_array_equal(lane_of(held[0]), want_sw)
            np.testing.assert_array_equal(lane_of(held[1][0]),
                                          np.clip(rows[lane], 0, n_cap - 1))
            np.testing.assert_array_equal(lane_of(held[1][1]),
                                          np.clip(nbr[lane], 0, n_cap - 1))
            np.testing.assert_array_equal(
                lane_of(held[1][2]),
                np.where(nbr[lane] == r, INF_E, rw[lane]))
            want = jax_plan(relax.max_trips(n_cap))
            got_d, trips, rounds = relax.solve_from(
                torch.tensor(deltas[lane]),
                held[0][lane] if g > 1 else held[0],
                None if res_t is None else tuple(
                    (t[lane] if g > 1 else t) for t in res_t),
                (held[2][lane] if g > 1 else held[2]).clone())
            np.testing.assert_array_equal(got_d.numpy(), np.asarray(want[0]))
            assert (trips, rounds) == (int(want[1]), int(want[2]))


def test_sssp_init_masks_root_and_seeds(port):
    """K1s alone: the root column of every class is INF_E, residual
    weights from the root are INF_E, indices are clipped, and each lane
    seeds 0 at its live out-neighbour only. Then K1s into held outputs
    (``out=``), reused across calls, against the JAX ``_plan_sssp``:
    with and without a residual, one lane and three stacked lanes
    (``_held_init_matches_jax``)."""
    for residual, g in ((True, 1), (False, 1), (True, 3)):
        _held_init_matches_jax(port, residual, g)
    torch = port.torch
    shift_w = torch.arange(16, dtype=torch.int32).view(2, 8)
    res_rows = torch.tensor([3, -1], dtype=torch.int32)
    res_nbr = torch.tensor([[2, 5], [-1, 9]], dtype=torch.int32)
    res_w = torch.tensor([[4, 6], [7, 8]], dtype=torch.int32)
    seeds = torch.tensor([1, 6, -1], dtype=torch.int32)
    seeds_w = torch.tensor([3, INF_E, INF_E], dtype=torch.int32)
    sw, (rows_c, nbr_c, rw), dist0 = port.relax.sssp_init(
        shift_w, res_rows, res_nbr, res_w, 5, seeds, seeds_w
    )
    assert sw[:, 5].tolist() == [INF_E, INF_E]
    assert sw[:, :5].tolist() == shift_w[:, :5].tolist()
    assert rows_c.tolist() == [3, 0]
    assert nbr_c.tolist() == [[2, 5], [0, 7]]
    assert rw.tolist() == [[4, INF_E], [7, 8]]
    want = np.full((3, 8), INF_E, np.int32)
    want[0, 1] = 0
    np.testing.assert_array_equal(dist0.numpy(), want)


@pytest.mark.parametrize("case", ["one", "lanes", "mc"])
def test_ladder_classes_match_jax_top_k(port, case):
    """K2's class pick (``ladder_classes`` / ``ladder_classes_mc`` on CPU
    tensors) against ``jax.lax.top_k`` and the formulas of
    ``openr_tpu/ops/relax.py:227-232``: light-edge scores that tie across
    the cut, s_cap above ``LADDER_WIDTH`` so the pick truncates, stacked
    lanes (vmapped as ``_fused_pipeline`` does), and an ``[mc]`` window
    whose light edges outside it do not count and whose rows are INF_E
    there. Shifts come back reduced mod n_cap. Tolerance 0."""
    torch, relax = port.torch, port.relax
    n_cap, s_cap, dq = 64, 12, 8
    s_lad = min(s_cap, relax.LADDER_WIDTH)
    assert s_cap > s_lad
    g = 3 if case == "lanes" else 1
    col0, w_cols = (32, 32) if case == "mc" else (0, n_cap)
    rng = np.random.default_rng(29)
    # light edges per class inside the window: sorted, the 8th and 9th
    # tie, so the pick keeps the lower class of equal scores
    counts = np.array([5, 9, 5, 2, 9, 5, 7, 5, 2, 5, 7, 3])
    sw = rng.integers(dq + 1, 60, size=(g, s_cap, n_cap)).astype(np.int32)
    sw[rng.random(sw.shape) < 0.2] = INF_E
    for lane in range(g):
        perm = rng.permutation(s_cap) if lane else np.arange(s_cap)
        for k in range(s_cap):
            cols = col0 + rng.choice(w_cols, counts[perm[k]], replace=False)
            sw[lane, k, cols] = rng.integers(0, dq + 1, size=cols.size)
        if case == "mc":  # light edges outside the window
            sw[lane, :, :col0][rng.random((s_cap, col0)) < 0.5] = 1
    deltas = rng.integers(-n_cap + 1, n_cap, size=(g, s_cap)).astype(np.int32)

    def jax_pick(score_w, deltas):
        def w_of(k):
            return jax.lax.dynamic_update_slice(
                jnp.full((n_cap,), INF_E, jnp.int32), score_w[k], (col0,))

        score = jnp.sum((score_w <= dq).astype(jnp.int32), axis=-1)
        _, lad_idx = jax.lax.top_k(score, s_lad)
        w_base = jax.vmap(w_of)(lad_idx)
        return jnp.where(w_base <= dq, w_base, INF_E), deltas[lad_idx]

    local = sw[:, :, col0:col0 + w_cols]
    want_w, want_d = jax.vmap(jax_pick)(jnp.asarray(local),
                                        jnp.asarray(deltas))
    want_w, want_d = np.asarray(want_w), np.mod(np.asarray(want_d), n_cap)
    if case == "lanes":
        got = relax.ladder_classes(torch.tensor(sw), torch.tensor(deltas),
                                   dq, s_lad)
    elif case == "mc":
        got = relax.ladder_classes_mc(torch.tensor(local[0]),
                                      torch.tensor(deltas[0]), dq, s_lad,
                                      col0, n_cap)
        want_w, want_d = want_w[0], want_d[0]
    else:
        got = relax.ladder_classes(torch.tensor(sw[0]),
                                   torch.tensor(deltas[0]), dq, s_lad)
        want_w, want_d = want_w[0], want_d[0]
    np.testing.assert_array_equal(got[0].numpy(), want_w)
    np.testing.assert_array_equal(got[1].numpy(), want_d)


@pytest.mark.parametrize("s_lad", [3, 4])
@pytest.mark.parametrize("layout", ["plane", "lanes", "gated"])
def test_ladder_pass_plain_matches_class_and_rung_steps(port, layout,
                                                        s_lad):
    """``ladder_pass_plain`` — one pass in one call — against the steps
    it replaces in ``run_bucketed``: ``s_lad`` ``ladder_apply_plain``
    calls with the host's buffer swaps, then ``ladder_rung_plain``, over
    two passes of run_bucketed's stamps. Random planes, one plane or
    stacked lanes; gated, lane 1 is shut from the start and lane 2's
    plane is at its fixpoint, so it runs the first pass without a change
    and neither doubles its rung nor runs the second. Equal planes (both
    buffers), returned plane, rungs, flag, stamps and counters."""
    torch, relax = port.torch, port.relax
    n_cap, d_cap = 32, 2
    g = 1 if layout == "plane" else 3
    rng = np.random.default_rng(41 + s_lad)
    dist = rng.integers(0, 200, size=(g, d_cap, n_cap)).astype(np.int32)
    dist[rng.random(dist.shape) < 0.5] = INF_E
    if layout == "gated":
        dist[2] = INF_E
    w = rng.integers(0, 9, size=(g, s_lad, n_cap)).astype(np.int32)
    w[rng.random(w.shape) < 0.25] = INF_E
    d = rng.integers(0, n_cap, size=(g, s_lad)).astype(np.int32)
    if layout == "plane":
        dist, w, d = dist[0], w[0], d[0]

    def run(use_pass):
        cur = torch.tensor(dist)
        spare = torch.full_like(cur, -3)
        wr, dr = torch.tensor(w), torch.tensor(d)
        bufs = [(torch.full_like(wr, -7), torch.full_like(dr, -7))
                for _ in range(2)]
        flag = torch.zeros(1, dtype=torch.int32)
        lanes = relax.Lanes(g, "cpu") if layout == "gated" else None
        if lanes is not None:
            lanes.st[1, 0] = -5
        flags = []
        for q in range(2):  # passes 0 and 1 of epoch 0

            def gate(thr, put=(relax.KEEP, relax.KEEP), inc=(0, 0)):
                return None if lanes is None else lanes.gate(thr, put, inc)

            thr = (-1, q - 1 if q else relax.ALWAYS)
            w2, d2 = bufs[q]
            if use_pass:
                cur, spare = relax.ladder_pass_plain(
                    cur, spare, wr, dr, w2, d2, flag,
                    gate(thr, (0, q), (0, 1)))
            else:
                for k in range(s_lad):
                    relax.ladder_apply_plain(cur, spare, wr, dr, k, flag,
                                             gate(thr, (0, q),
                                                  (0, int(k == 0))))
                    cur, spare = spare, cur
                relax.ladder_rung_plain(wr, dr, w2, d2, gate((-1, q)))
            wr, dr = w2, d2
            flags.append(int(flag))
            flag.zero_()
        out = [cur, spare, *bufs[0], *bufs[1], torch.tensor(flags)]
        if lanes is not None:
            out += [lanes.st, lanes.cnt]
        return out

    got, want = run(True), run(False)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(got[-1 if layout != "gated" else -3][0]) == 1
    if layout == "gated":
        st, cnt = got[-2], got[-1]
        assert st[1, 0] == -5 and cnt[1].tolist() == [0, 0]
        assert cnt[2].tolist() == [0, 1]
        # lane 2's rung doubled in neither pass
        assert (got[2][2] == -7).all() and (got[4][2] == -7).all()
