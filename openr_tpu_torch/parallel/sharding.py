"""The whole-fabric step (the port of ``parallel/sharding.py``'s
``sharded_fabric_step`` and ``_sharded_fabric_fn``) on one card.

The reference runs every requested root's SSSP and best-route selection
over a ('batch', 'graph') mesh: roots data-parallel over 'batch', the
node columns of the weight planes over 'graph' with a ``pmin`` per
relaxation. On a machine with one device its mesh is 1 x 1 and the
``pmin`` does nothing; that is what this module computes, on the card
of its tensors (``ops/fabric.fabric_step``). A mesh wider than one card
raises ``NotImplementedError``: the cross-card split (NCCL
``all_reduce(MIN)`` in place of ``pmin``) is not ported yet. Roots are
not padded to a batch axis; the results are the same by construction.
"""

from __future__ import annotations

import numpy as np
import torch

from openr_tpu_torch.ops.fabric import fabric_step, unpack_bits
from openr_tpu_torch.ops.select import pack_matrix


class Unconverged(AssertionError):
    """The fixed trip bound was below the graph's diameter bound."""


def one_card(mesh, device) -> torch.device:
    """The card a whole-fabric step runs on: ``device`` (resolved as the
    port's entry points resolve it) for ``mesh=None``, else the one
    device of ``mesh`` (a sequence of devices). More than one device
    raises until the cross-card split is ported."""
    from openr_tpu_torch.decision.gpu_solver import resolve_device

    if mesh is None:
        return resolve_device(device)
    devices = list(mesh)
    if len(devices) != 1:
        raise NotImplementedError(
            f"a whole-fabric mesh of {len(devices)} devices: the cross-card "
            f"split is not ported; pass mesh=None for the solver's card"
        )
    return resolve_device(devices[0])


def sharded_fabric_step(mesh, plan, matrix, roots, out_nbr, out_w,
                        n_trips: int, check_convergence: bool = True,
                        lfa: bool = False, block_v4: bool = False,
                        with_ok: bool = False, *, device="cuda"):
    """Run the whole-fabric step for ``roots`` on one card.

    plan: ``ops/edgeplan.EdgePlan``; matrix: ``ops/csr.PrefixMatrix``;
    roots [Rt] int32; out_nbr / out_w [Rt, D]: per-root out-edge tables
    (pad slots -1 / INF_E); n_trips: the trip bound (``UNROLL``
    relaxations each). With ``check_convergence`` a root whose planes
    were still changing after ``n_trips`` trips raises ``Unconverged``.
    ``mesh`` is None (the card of ``device``) or a sequence of one
    device.

    Returns, as tensors on the card, (dist [Rt, N_cap], metric [Rt,
    P_cap], s3 [Rt, P_cap, A] selected-announcer masks, nh_mask [Rt,
    P_cap, D], lfa_slot [Rt, P_cap] (-1 = none; only meaningful with
    lfa=True), lfa_metric [Rt, P_cap]); with ``with_ok`` also the
    route-level ok mask [Rt, P_cap] (v4 rows blocked per ``block_v4``).
    ``ops/fabric.fabric_step`` returns the convergence vote too."""
    dev = one_card(mesh, device)

    def put(arr):
        return torch.tensor(np.ascontiguousarray(arr), dtype=torch.int32,
                            device=dev)

    p_cap, a_cap = matrix.ann_node.shape
    _, mbuf = pack_matrix(matrix, plan.node_overloaded)
    out = fabric_step(
        put(plan.deltas), put(plan.shift_w), put(plan.res_rows),
        put(plan.res_nbr), put(plan.res_w), put(mbuf), put(roots),
        put(out_nbr), put(out_w), n_trips=int(n_trips),
        has_res=plan.k_res > 0, p_cap=p_cap, a_cap=a_cap, lfa=lfa,
        block_v4=block_v4,
    )
    if check_convergence and not out.converged.all():
        raise Unconverged(
            f"fabric SSSP unconverged for roots "
            f"{np.asarray(roots)[~out.converged].tolist()}: raise n_trips "
            f"({n_trips})"
        )
    res = (out.dist, out.metric, unpack_bits(out.s3w, a_cap),
           unpack_bits(out.nhw, out_nbr.shape[1]), out.lfa_slot,
           out.lfa_metric)
    if with_ok:
        res += (out.ok,)
    return res
