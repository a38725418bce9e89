"""Batched what-if sweeps over the resident shift-decomposed mirror.

The port of ``ops/sweep.py::_make_sweep`` / ``sweep_batch`` of the JAX
package. A what-if scenario — a failed link, a drained node — is a
handful of directed-edge weight overrides on top of the mirror the
solver already keeps on the card. ``sweep`` solves a batch of ``b``
such overlays of ``r`` roots in one dispatch:

  1. K10 ``overlay_planes`` (``csrc/ksp2.cu``): each lane's private
     planes, the shared mirror with its overrides (values as given, pads
     past the plane dropped);
  2. K1s seeds every lane's r rows with 0 at its root; the root
     transits, as in the reference;
  3. K1 rounds with a leading lane axis, one launch a step;
  4. K12 ``sweep_verdicts`` (``csrc/sweep.cu``): per lane, against lane
     0 (the identity overlay), the unreachable count, the max stretch and
     the changed count.

The rounds are synchronous whatever kernel the solver runs, as in the
reference: ``_make_sweep``'s ``kernel`` string parameter is shadowed by
its inner function ``kernel``, so its ``kernel == "bucketed"`` test is
false and every reference sweep, the bucketed-named ones included, runs
``run_sync`` (its trips and rounds show it). The lanes need no gates: a
lane's trips under ``vmap`` are those of its own loop, and the batch
loop stops on the first trip in which no lane changed, which is the
largest of them — ``trips_max``, with ``rounds_max = trips_max *
UNROLL``; a converged lane does not change under further relaxations,
so its plane is the same.

Lane 0 of every batch is the identity overlay, so the baseline rides
the same dispatch. Verdicts come back as three int32 [b] arrays; the
distance planes only with ``return_dist``.
"""

from __future__ import annotations

import torch

from openr_tpu_torch.ops import cuda
from openr_tpu_torch.ops.ksp2 import lane_inputs, seed_rows
from openr_tpu_torch.ops.relax import (
    INF_E,
    _is_cpu,
    max_trips,
    relax_step,
    run_sync,
)


def sweep_max_trips(n_cap: int) -> int:
    """Worst-case trips of a sweep SSSP — the live pipeline's bound (a
    failure only lengthens paths, never past the n-node chain)."""
    return max_trips(n_cap)


# -- K12: per-lane verdicts against lane 0 ------------------------------------

def sweep_verdicts_plain(dist):
    base = dist[0]
    valid = (base < INF_E)[None]
    dims = tuple(range(1, dist.dim()))
    unreachable = (valid & (dist >= INF_E)).sum(dim=dims, dtype=torch.int32)
    reach = valid & (dist < INF_E)
    stretch = torch.where(reach, dist - base[None], 0).amax(dim=dims)
    changed = (valid & (dist != base[None])).sum(dim=dims, dtype=torch.int32)
    return unreachable, stretch.to(torch.int32), changed


def sweep_verdicts(dist):
    """-> (unreachable, stretch, changed), int32 [b] each, of the lanes'
    distance planes dist [b, r, n_cap] against lane 0's: over the words
    lane 0 reaches, the count the lane cannot reach, the largest
    increase among those it still reaches (0 floor from the others), and
    the count whose value differs."""
    if _is_cpu(dist):
        return sweep_verdicts_plain(dist)
    b = dist.shape[0]
    out = torch.empty((3, b), dtype=torch.int32, device=dist.device)
    cuda.launch("sweep", "sweep_verdicts", "ttttLi",
                dist, out[0], out[1], out[2], dist[0].numel(), b)
    sweep_verdicts.launches += 1
    return out[0], out[1], out[2]


sweep_verdicts.launches = 0


# -- the sweep ----------------------------------------------------------------

def sweep(deltas, shift_w, res_rows, res_nbr, res_w, roots, sh_idx, sh_val,
          rs_idx, rs_val, *, has_res: bool, max_trips: int,
          return_dist: bool):
    """``b`` overlay lanes of ``r`` roots over the resident mirror —
    deltas [s_cap], shift_w [s_cap, n_cap], res_rows [r_cap], res_nbr /
    res_w [r_cap, kr_cap] — with roots int32 [r], sh_idx / sh_val [b,
    es] flat into [s_cap * n_cap] (pad s_cap * n_cap), rs_idx / rs_val
    [b, er] flat into [r_cap * kr_cap] (pad r_cap * kr_cap). Returns the
    reference's tuple: ``(unreachable [b], stretch [b], changed [b],
    trips_max[, dist [b, r, n_cap]], rounds_max)`` — the verdicts int32
    tensors, the counts ints."""
    b = sh_idx.shape[0]
    n_cap = shift_w.shape[1]
    deltas_b, sw, residual = lane_inputs(
        deltas, shift_w, res_rows, res_nbr, res_w, sh_idx, sh_val, rs_idx,
        rs_val, has_res)
    dist0 = seed_rows(roots, b, n_cap)

    def step(dist, out, flag):
        relax_step(dist, out, flag, deltas_b, sw, residual)

    dist, trips, rounds = run_sync(step, dist0, max_trips)
    verdicts = sweep_verdicts(dist)
    if return_dist:
        return (*verdicts, trips, dist, rounds)
    return (*verdicts, trips, rounds)
