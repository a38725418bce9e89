"""Carry the JAX solver's device inputs across to the port.

The system has no weights: what a solve reads from the device is the
resident mirror, the packed announcer matrix, the root tables and the
previous solve's outputs — and, for the incremental solve, the previous
distance plane, the dirty tuples and the cone budget. ``from_jax_state``
converts those arrays, as numpy arrays in the JAX pipeline's argument
order, into the port's tensors, so a test can feed the same device
inputs to both pipelines. ``masked_rows_state_from_jax`` carries a
vantage's resident KSP2 rows (``ops/ksp2.MaskedRowsState``) across, so
the port's next refresh is a delta step against the rows the JAX
solver left. ``te_inputs_from_jax`` turns the padded arrays of a JAX TE
step (``ops/sweep.py::te_step``) into the port's ``te_step`` arguments.
``ell_from_jax`` carries a JAX ``ops/csr.EllGraph``'s mirror into the
legacy kernels' tensors, and ``fabric_inputs_from_jax`` a JAX
``EdgePlan``, ``PrefixMatrix`` and root tables into the whole-fabric
step's (``ops/fabric.fabric_step``). ``mc_inputs_from_jax`` splits one
JAX multichip SSSP call's arguments into the per-shard tensors of the
port's (``parallel/sharding.mc_sssp`` / ``mc_incremental_sssp``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from openr_tpu_torch.decision.gpu_solver import resolve_device
from openr_tpu_torch.ops.ksp2 import MaskedRowsState
from openr_tpu_torch.ops.legacy import ell_tensors
from openr_tpu_torch.ops.select import pack_matrix
from openr_tpu_torch.ops.te import TePlan, te_plan
from openr_tpu_torch.parallel.sharding import REPLICATED, Layout, place

# the JAX pipeline's positional arguments, in order
JAX_ARGS = (
    "deltas", "shift_w", "res_rows", "res_nbr", "res_w", "mbuf",
    "root", "root_nbr", "root_w",
    "prev_metric", "prev_s3w", "prev_nhw",
    "prev_lfa_slot", "prev_lfa_metric",
)

# the six trailing inputs of the JAX incremental pipeline
# (tpu_solver._incr_pipeline)
JAX_INCR_ARGS = (
    "prev_dist", "s_dirty_idx", "s_dirty_old", "r_dirty_idx",
    "r_dirty_old", "cone_limit",
)


def from_jax_state(args, device="cuda") -> dict:
    """``args``: the JAX pipeline's inputs as numpy arrays (or anything
    ``np.asarray`` takes), in ``JAX_ARGS`` order, optionally followed by
    the incremental pipeline's six (``JAX_INCR_ARGS``). Returns the
    keyword arguments of ``gpu_solver.pipeline``: int32 tensors on
    ``device``, ``root`` as an int and, with the incremental six,
    ``incr`` as their tuple (``cone_limit`` an int)."""
    n = len(JAX_ARGS)
    if len(args) not in (n, n + len(JAX_INCR_ARGS)):
        raise ValueError(
            f"expected {n} or {n + len(JAX_INCR_ARGS)} arrays, got {len(args)}"
        )
    dev = resolve_device(device)

    def tensor(arr):
        return torch.tensor(
            np.ascontiguousarray(np.asarray(arr), dtype=np.int32), device=dev
        )

    out = {}
    for name, arr in zip(JAX_ARGS, args):
        out[name] = int(np.asarray(arr)) if name == "root" else tensor(arr)
    if len(args) > n:
        *planes, cone_limit = args[n:]
        out["incr"] = (*(tensor(a) for a in planes),
                       int(np.asarray(cone_limit)))
    return out


def masked_rows_state_from_jax(jstate, plan=None,
                               device="cuda") -> MaskedRowsState:
    """The port's ``MaskedRowsState`` holding what a JAX
    ``ops/ksp2.MaskedRowsState`` holds: its resident rows ``d_prev``
    (anything ``np.asarray`` takes) as an int32 tensor on ``device``,
    copies of its host mirror and of its last masks, its caps and its
    destination key. ``plan`` is the plan the state is next refreshed
    with (the JAX state's own by default): the refresh takes the delta
    path only for the plan object the state names."""
    dev = resolve_device(device)
    state = MaskedRowsState()
    state.dest_key = tuple(jstate.dest_key)
    state.plan = jstate.plan if plan is None else plan
    if jstate.d_prev is not None:
        state.d_prev = torch.tensor(
            np.ascontiguousarray(np.asarray(jstate.d_prev), dtype=np.int32),
            device=dev,
        )
    if jstate.host_rows is not None:
        state.host_rows = np.array(jstate.host_rows, np.int32)
    state.b_cap, state.ms_cap, state.mr_cap = (
        jstate.b_cap, jstate.ms_cap, jstate.mr_cap)
    for name in ("mask_s", "mask_r"):
        arr = getattr(jstate, name)
        setattr(state, name, None if arr is None else np.array(arr, np.int32))
    return state


# the JAX TE step's positional arguments, in order
JAX_TE_ARGS = (
    "theta", "deltas", "res_rows", "res_nbr", "sh_idx", "sh_link",
    "rs_idx", "rs_link", "srcs", "dem_row", "dem_dst", "dem_vol", "tau",
    "tau_util",
)


def te_inputs_from_jax(args, *, n_cap: int, trips: int, has_res: bool,
                       device="cuda") -> tuple[TePlan, torch.Tensor, float,
                                               float]:
    """``args``: a JAX TE step's inputs (numpy arrays or anything
    ``np.asarray`` takes) in ``JAX_TE_ARGS`` order, padded as
    ``OptimizeJob.run`` pads them; ``n_cap``, ``trips`` and ``has_res``
    are the step's static arguments. Returns the port's ``te_step``
    arguments: ``(plan, theta, tau, tau_util)``, the tensors on
    ``device``."""
    if len(args) != len(JAX_TE_ARGS):
        raise ValueError(
            f"expected {len(JAX_TE_ARGS)} arrays, got {len(args)}")
    a = dict(zip(JAX_TE_ARGS, (np.asarray(x) for x in args)))
    dev = resolve_device(device)
    theta = torch.tensor(np.ascontiguousarray(a["theta"], np.float32),
                         device=dev)
    plan = te_plan(
        a["deltas"], a["res_rows"], a["res_nbr"], a["sh_idx"], a["sh_link"],
        a["rs_idx"], a["rs_link"], a["srcs"], a["dem_row"], a["dem_dst"],
        a["dem_vol"], n_cap=n_cap, l_cap=theta.numel(), trips=trips,
        has_res=has_res, device=dev,
    )
    return plan, theta, float(a["tau"]), float(a["tau_util"])


def ell_from_jax(graph, device="cuda") -> dict:
    """The ELL mirror of a JAX ``ops/csr.EllGraph`` (numpy arrays) as the
    legacy kernels take it: ``in_nbr`` / ``in_w`` int32, ``in_up`` bool
    [n_cap, k_cap] and ``node_over`` bool [n_cap], on ``device``."""
    return dict(zip(("in_nbr", "in_w", "in_up", "node_over"),
                    ell_tensors(graph, resolve_device(device))))


def fabric_inputs_from_jax(plan, matrix, roots, out_nbr, out_w,
                           device="cuda") -> dict:
    """The whole-fabric step's inputs from the JAX host mirror: a JAX
    ``ops/edgeplan.EdgePlan`` and ``ops/csr.PrefixMatrix`` (numpy
    arrays) and the roots [Rt] with their out-slot tables [Rt, D], as
    ``sharded_fabric_step`` takes them. Returns the keyword arguments
    of ``ops/fabric.fabric_step`` but its flags (``lfa``,
    ``block_v4``, ``n_trips``): int32 tensors on ``device``, the
    announcer matrix packed as the solver packs it (drain bit from the
    plan's overloaded nodes, the v4 bit, min_nh)."""
    dev = resolve_device(device)

    def put(arr):
        return torch.tensor(np.ascontiguousarray(np.asarray(arr)),
                            dtype=torch.int32, device=dev)

    # packed as the solver packs it, memoized on a copy: the JAX matrix
    # keeps its own memo
    _, mbuf = pack_matrix(dataclasses.replace(matrix, _mbuf=None),
                          np.asarray(plan.node_overloaded))
    p_cap, a_cap = matrix.ann_node.shape
    return {
        "deltas": put(plan.deltas), "shift_w": put(plan.shift_w),
        "res_rows": put(plan.res_rows), "res_nbr": put(plan.res_nbr),
        "res_w": put(plan.res_w), "mbuf": put(mbuf), "roots": put(roots),
        "out_nbr": put(out_nbr), "out_w": put(out_w),
        "has_res": bool(plan.k_res > 0), "p_cap": p_cap, "a_cap": a_cap,
    }


# the JAX multichip SSSP's positional arguments
# (parallel/sharding.py::make_mc_sssp) and how its in_specs lay each out;
# the incremental one (make_mc_incremental_sssp) takes six more
JAX_MC_ARGS = (
    ("deltas", REPLICATED), ("shift_w", Layout(1, "graph")),
    ("res_rows", REPLICATED), ("res_nbr", REPLICATED),
    ("res_w", REPLICATED), ("root", None), ("root_nbr", Layout(0, "batch")),
    ("root_w", Layout(0, "batch")),
)
JAX_MC_INCR_ARGS = (
    ("prev_dist", Layout(0, "batch")), ("s_dirty_idx", REPLICATED),
    ("s_dirty_old", REPLICATED), ("r_dirty_idx", REPLICATED),
    ("r_dirty_old", REPLICATED), ("cone_limit", None),
)


def mc_inputs_from_jax(mesh, args) -> dict:
    """``args``: one JAX multichip SSSP call's inputs (numpy arrays or
    anything ``np.asarray`` takes) in ``make_mc_sssp``'s order, optionally
    followed by ``make_mc_incremental_sssp``'s six more. Returns the
    keyword arguments of ``parallel/sharding.mc_sssp`` (or
    ``mc_incremental_sssp``) but their static ones: each array split as
    the JAX in_specs split it over ``mesh`` (a ``Mesh``), a grid
    ``[batch][graph]`` of int32 tensors on the shards' devices; ``root``
    and ``cone_limit`` as ints."""
    names = JAX_MC_ARGS + JAX_MC_INCR_ARGS
    if len(args) not in (len(JAX_MC_ARGS), len(names)):
        raise ValueError(
            f"expected {len(JAX_MC_ARGS)} or {len(names)} arrays, got "
            f"{len(args)}")
    out = {}
    for (name, layout), arr in zip(names, args):
        arr = np.asarray(arr)
        out[name] = int(arr) if layout is None else place(
            mesh, arr, layout).parts
    return out
