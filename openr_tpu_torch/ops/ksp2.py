"""The unmasked single-root SSSP: the distance field UCMP propagates over.

``base_sssp`` is the port of ``ops/ksp2.py::_base_sssp_fn`` (its body
``_make_one_sssp`` without edge masks) of the JAX package: one [n_cap]
row of shortest distances from ``root`` over the shift-decomposed
mirror. Unlike the ECMP pipeline's SSSP (G minus the root, one lane per
out-neighbour) the root may transit and the weights are the resident
planes unmasked. The loop is the JAX one: ``UNROLL`` Jacobi
relaxations a trip, exit on the first trip that changes nothing, at
most ``max(2, ceil(n_cap / 8) + 2)`` trips — ``relax.max_trips``.

It runs on the kernels of ``csrc/relax.cu``: K1s with no class and no
ELL extent writes only the one-row seed plane (0 at the root), then K1
``relax_shift`` / ``relax_residual`` relax it over the resident planes
as they are — no masked copy, the residual kernel clips the ELL's pad
indices as it reads them. The wrapper counts its own launches in
``base_sssp.launches``. The masked batch of KSP2 (``_masked_rows_fn``,
``_masked_rows_delta_fn``) is not ported yet.
"""

from __future__ import annotations

import torch

from openr_tpu_torch.ops.relax import (
    INF_E,
    _is_cpu,
    _launch_relax,
    _launch_seed,
    max_trips,
    relax_step_plain,
    run_sync,
)


def base_sssp_plain(deltas, shift_w, res_rows, res_nbr, res_w, root: int,
                    has_res: bool):
    n_cap = shift_w.shape[1]
    dist0 = torch.full((1, n_cap), INF_E, dtype=torch.int32,
                       device=shift_w.device)
    dist0[0, root] = 0
    residual = (res_rows.clamp(0, n_cap - 1), res_nbr.clamp(0, n_cap - 1),
                res_w) if has_res else None

    def step(dist, out, flag):
        relax_step_plain(dist, out, flag, deltas, shift_w, residual)

    dist, trips, _ = run_sync(step, dist0, max_trips(n_cap))
    return dist[0], trips


def base_sssp(deltas, shift_w, res_rows, res_nbr, res_w, root: int,
              has_res: bool):
    """-> (dist int32 [n_cap], trips): shortest distances from ``root``
    (INF_E where unreachable) over the resident mirror — deltas [s_cap],
    shift_w [s_cap, n_cap], the residual ELL res_rows [r_cap], res_nbr /
    res_w [r_cap, kr_cap] — unmasked, the root a transit node like any
    other."""
    if _is_cpu(shift_w):
        return base_sssp_plain(deltas, shift_w, res_rows, res_nbr, res_w,
                               root, has_res)
    n_cap = shift_w.shape[1]
    dist0 = _launch_seed(root, n_cap, shift_w.device)
    base_sssp.launches += 1
    residual = (res_rows, res_nbr, res_w) if has_res else None

    def step(dist, out, flag):
        base_sssp.launches += _launch_relax(dist, out, flag, deltas,
                                            shift_w, residual)

    dist, trips, _ = run_sync(step, dist0, max_trips(n_cap))
    return dist[0], trips


base_sssp.launches = 0
