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

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openr_tpu.decision.tpu_solver import _plan_sssp
from openr_tpu.models import topologies
from openr_tpu.ops import relax as jrelax
from openr_tpu.ops.edgeplan import build_plan

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


def test_sssp_init_masks_root_and_seeds(port):
    """K1s alone: the root column of every class is INF_E, residual
    weights from the root are INF_E, indices are clipped, and each lane
    seeds 0 at its live out-neighbour only."""
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
