"""GPU route-computation backend: the Decision solve, cold,
incremental and streaming, with LFA backup next hops, fused small-area
groups and UCMP weights.

``GpuSpfSolver.build_route_db(my_node, {area: LinkState}, PrefixState)``
computes the same ``DecisionRouteDb`` as the CPU oracle
(``decision/spf_solver.py``), with the hot path on an NVIDIA GPU. Per
area whose prefixes are all single-area IP + SP_ECMP announcements
(``_fast_path_eligible``), one ``pipeline`` call runs:

  1. ``ops/relax.plan_sssp``: batched SSSP [D, n_cap] from the root's D
     out-neighbours in G-minus-root over the shift-decomposed mirror
     (ops/edgeplan.py) — K1s init, then bucketed Δ-stepping (K2 ladder
     + K1 handoff relaxation) or synchronous K1 rounds. With
     ``incremental_spf`` an eligible vantage runs
     ``ops/incremental.incremental_sssp`` instead: the same loops from
     its previous distance plane, with the affected cone behind metric
     increases re-anchored (K5 old planes, K6 parent forest, K7/K8 cone,
     K9 seed), falling back to the cold seed on the device when the
     cone exceeds ``cone_limit``.
  2. ``ops/select.select_routes`` (K3): true distances and the ECMP
     predicate from via = root_w + dist_d, reference-order best-route
     selection, next-hop masks, 16-bit word packing, route-ok filter,
     and with ``enable_lfa`` the RFC 5286 backup slot and metric.
  3. ``ops/compact.compact_outputs`` (K4): the changed-rows delta
     payload against the vantage's previous resident outputs and the
     ok-rows full payload, sentinel counts in both tails.

Areas of one vantage that share a shape (``fuse_key``) and have at most
``fuse_n_cap`` node slots run as ONE ``fused_pipeline`` call (the port
of ``tpu_solver._fused_pipeline``): the cold pipeline with a leading
area axis on every kernel, one launch per step for all of them, each
area's loops counted on its own. Areas below ``small_graph_nodes`` go
to the oracle.

The host pulls ONE buffer per area — the full payload on a vantage's
first solve (or after its matrix / shape changed), the delta payload
after — and patches the vantage's ColumnarRib, whose lazy view becomes
the RIB's unicast routes. Everything else (cross-area or non-fast-path
prefixes, static routes, MPLS label routes) goes through the oracle, as
in the JAX solver. Changelog churn reaches the resident weight planes
as a K5 scatter of the drained dirty slots, journalled per drain epoch
so a vantage's previous plane can be advanced across several drains.
With ``streaming_pipeline`` every epoch the incremental gate passes is
a streaming epoch (the port of ``tpu_solver._dispatch_stream``): the
delta payload takes the vantage's bucketed budget
(``ops/stream.STREAM_BUDGETS``) and carries the device route-ok bit per
changed row, so the host applies the rows with ``apply_rows_packed``
and unpacks no words; an over-budget epoch pulls the full buffer too
and grows the budget. The vantage keeps two plane sets and swaps them
at dispatch (the JAX solver donates its buffers).

With ``enable_ucmp`` the oracle's UCMP weight walk is answered on the
device (``_UcmpAccel``, the oracle's ``ucmp_resolver``): the root's
unmasked distance field (``ops/ksp2.base_sssp``) and the DAG weight
fixpoint (``ops/ucmp.py``), with the host walk whenever the device
cannot answer exactly.

KSP2 prefixes (SR_MPLS + KSP2_ED_ECMP, ``_ksp2_eligible``) of a single
area have that area primed on the device before the oracle assembles
their routes (``_prime_ksp2``, the port of the JAX solver's): the
root's unmasked field backs the oracle's SPF memo, and every
destination's second-pass field (its first paths' links removed) comes
from one masked batch (``ops/ksp2.masked_rows_update``: K10 overlays,
K1 rows, K11 deltas against the previous generation's rows), traced on
the host into the k-paths cache. The oracle's selection, canonical
trace and label assembly then run unchanged, with no host Dijkstra.

An area whose node capacity exceeds ``multichip_n_cap_threshold``
solves on the multichip tier when its mesh has two or more devices
(``_mc_mesh_for``; by default the visible cards, ``multichip_devices``
names others — a list that repeats one card makes logical shards on
it): the area's mirror lies on the ('batch', 'graph') mesh as
``parallel/sharding.plan_shardings`` says, churn scatters each dirty
slot into its owning shard in place (K5 [mc]), and ``mc_pipeline`` runs
the mesh SSSP (``parallel/sharding.mc_sssp`` / ``mc_incremental_sssp``)
and the selection tail over the gathered lanes. Such an area never
fuses and never streams, as in the reference.

``build_fabric_route_dbs`` answers every requested vantage of a
single-area LSDB from ONE whole-fabric step (the port of the
reference's sharded fabric path: each root's SSSP, the root masked as
transit, a convergence vote, K3 per root; ``ops/fabric.
fabric_step_grid``) — over the resident mirror on the solver's card by
default, else with the roots split over 'batch' and the weight columns
over 'graph' of a mesh —, one ColumnarRib per vantage. ``legacy_pipeline``, ``sssp_batch`` and
``sssp_all_pairs`` are the legacy ELL pipeline and the all-roots SSSP
(``ops/legacy.py``, K18-K20) of the graft entry (``entry.py``).

``device`` defaults to "cuda" and raises without a CUDA device unless
the caller passes ``device="cpu"``, which runs each kernel's plain
PyTorch version (the tests do).
"""

from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from openr_tpu_torch.decision.columnar_rib import ColumnarRib, LazyUnicastRoutes
from openr_tpu_torch.decision.link_state import LinkState, NodeUcmpResult
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.decision.rib import DecisionRouteDb
from openr_tpu_torch.decision.spf_solver import SpfSolver
from openr_tpu_torch.ops.compact import compact_outputs
from openr_tpu_torch.ops.csr import EllGraph, PrefixMatrix, build_prefix_matrix
from openr_tpu_torch.ops import legacy
from openr_tpu_torch.ops import ksp2 as ksp2_ops
from openr_tpu_torch.ops.edgeplan import (
    _ensure_edge_loc,
    drain_dirty,
    edge_loc_of,
    prewarm_edge_loc,
    sync_plan,
)
from openr_tpu_torch.ops.incremental import incremental_sssp, scatter_set
from openr_tpu_torch.ops.ksp2 import (
    MaskedRowsState,
    base_sssp,
    masked_rows_dispatch,
    masked_rows_update,
    pull_async,
    pull_wait,
)
from openr_tpu_torch.ops.relax import (
    INF_E,
    init_outputs,
    max_trips,
    plan_sssp,
    plan_sssp_lanes,
)
from openr_tpu_torch.ops.select import pack_matrix, select_routes
from openr_tpu_torch.ops.stream import STREAM_BUDGETS, stream_budget
from openr_tpu_torch.ops.ucmp import UcmpEdges, propagate
from openr_tpu_torch.runtime.counters import counters
from openr_tpu_torch.types import PrefixForwardingAlgorithm, PrefixForwardingType

# rows shipped per delta pull; more changed rows fall back to the full
# pull (the host reads the count first)
DELTA_BUDGET = 4096

# areas of at most this many node slots fuse into one dispatch
FUSE_N_CAP = 4096

# incremental-solve dirty buffers pad to one of these sizes (shared by
# the shift and residual buffers); a larger merged dirty set takes the
# cold solve
_DIRTY_BUCKETS = (64, 256, 1024, 4096)


def _dirty_bucket(n: int) -> Optional[int]:
    for b in _DIRTY_BUCKETS:
        if n <= b:
            return b
    return None


def _merge_drain_log(ad: "_AreaDev", since_epoch: int):
    """Merge the area's drain journal entries newer than ``since_epoch``
    into ({shift_flat: old}, {res_flat: old}) maps holding each dirty
    slot's weight AS OF since_epoch (the epoch of the vantage's resident
    distance plane). None when the window cannot be rebuilt — a journal
    gap (deque overflow), a reset marker (mirror rebuild or residual
    layout change) or a missing epoch — and the caller takes the cold
    solve."""
    if ad.drain_epoch == since_epoch:
        return {}, {}
    s_map: dict = {}
    r_map: dict = {}
    expected = since_epoch + 1
    for epoch, s_d, r_d in ad.drain_log:
        if epoch <= since_epoch:
            continue
        if epoch != expected or s_d is None:
            return None
        for f, old in s_d.items():
            s_map.setdefault(f, old)
        for f, old in r_d.items():
            r_map.setdefault(f, old)
        expected += 1
    if expected != ad.drain_epoch + 1:
        return None
    return s_map, r_map


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on: CUDA unless the caller
    asks for the CPU. No silent fallback — "cuda" without a CUDA device
    raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _ucmp_weight_anomalies(w) -> int:
    """Numerically unhealthy entries of an int32 UCMP weight field: the
    negative ones (int32 wraparound)."""
    return 0 if w is None else int((np.asarray(w) < 0).sum())


_UCMP_ALGOS = (
    PrefixForwardingAlgorithm.SP_UCMP_ADJ_WEIGHT_PROPAGATION,
    PrefixForwardingAlgorithm.SP_UCMP_PREFIX_WEIGHT_PROPAGATION,
)


def _fast_path_eligible(entries) -> bool:
    """Device fast path covers IP + SP_ECMP announcements without prepend
    labels; anything else routes through the CPU oracle."""
    for entry in entries.values():
        if (
            entry.forwarding_type != PrefixForwardingType.IP
            or entry.forwarding_algorithm != PrefixForwardingAlgorithm.SP_ECMP
            or entry.prepend_label is not None
        ):
            return False
    return True


def _ksp2_eligible(entries) -> bool:
    """KSP2 prefixes (SR_MPLS + KSP2_ED_ECMP on every announcement) get
    the device-assisted path: the batched masked SSSP for the
    per-destination second pass, the oracle's code for selection, trace
    and label assembly."""
    for entry in entries.values():
        if (
            entry.forwarding_type != PrefixForwardingType.SR_MPLS
            or entry.forwarding_algorithm
            != PrefixForwardingAlgorithm.KSP2_ED_ECMP
        ):
            return False
    return True


class PipelineOut(NamedTuple):
    delta_buf: torch.Tensor
    full_buf: torch.Tensor
    metric: torch.Tensor
    s3w: torch.Tensor
    nhw: torch.Tensor
    # host ints; 0-d int32 device tensors (the lane's own counters) for a
    # lane of a fused solve
    trips: object
    rounds: object
    # CUDA events on a CUDA device, None on the CPU: [start, SSSP done,
    # selection done, compaction done] for a cold solve; [start, old
    # planes done, parent plane done, seed plane done, SSSP done,
    # selection done, compaction done] for an incremental one
    events: Optional[list]
    # the [D, n_cap] distance plane (the next incremental solve's seed)
    # with emit_dist or incr, else None
    dist: Optional[torch.Tensor] = None
    # sweeps of the incremental solve's cone closure, an int32 0-d tensor
    # on the host (from a card: pinned, filled behind the solve, so read
    # it after the pull; 0 for a cold solve)
    cone_trips: object = 0
    # the LFA columns int32 [P] (the previous ones passed through when
    # the solve ran without LFA)
    lfa_slot: Optional[torch.Tensor] = None
    lfa_metric: Optional[torch.Tensor] = None


def _host_word(t: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor on the host holding ``t``'s value: from a card, a
    pinned copy queued behind the work before it on the current stream,
    so reading it after that stream's next pull costs no sync of its
    own."""
    if not t.is_cuda:
        return t
    host = torch.empty((), dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _timing_events(t: torch.Tensor, n: int):
    """(events or None, mark): ``n`` CUDA events when ``t`` lies on a
    card, and a function that records the next one on that card's
    current stream."""
    events = None
    if t.is_cuda:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    pending = iter(events or ())

    def mark():
        ev = next(pending, None)
        if ev is not None:
            ev.record(torch.cuda.current_stream(t.device))

    return events, mark


def _lfa_tail(sel, prev_lfa_slot, prev_lfa_metric, lfa: bool):
    """-> (lfa_slot, lfa_metric, K4's lfa columns or None) from a
    ``select_routes`` result: the new columns with ``lfa``, else the
    previous ones passed through."""
    if not lfa:
        return prev_lfa_slot, prev_lfa_metric, None
    slot, alt = sel[4:]
    return slot, alt, (slot, alt, prev_lfa_slot, prev_lfa_metric)


def pipeline(deltas, shift_w, res_rows, res_nbr, res_w, mbuf, root: int,
             root_nbr, root_w, prev_metric, prev_s3w, prev_nhw,
             prev_lfa_slot=None, prev_lfa_metric=None, *,
             has_res: bool, block_v4: bool = False, sentinels: bool = True,
             kernel: str = "sync", delta_exp: int = 0,
             budget: int = DELTA_BUDGET, incr=None,
             emit_dist: bool = False, lfa: bool = False, stream: int = 0,
             out=None, init_out=None, par_out=None) -> PipelineOut:
    """One solve for one (area, vantage) on the device of its tensors.
    Inputs are the resident mirror (deltas [s_cap], shift_w [s_cap,
    n_cap], the residual ELL res_rows [r_cap] / res_nbr, res_w [r_cap,
    kr_cap]), the packed announcer matrix mbuf [6*P*A], the root's index
    and out-slot tables root_nbr / root_w [D], and the previous solve's
    outputs prev_metric [P], prev_s3w [P, ceil(A/16)], prev_nhw [P,
    ceil(D/16)], prev_lfa_slot / prev_lfa_metric [P] (zeros before the
    first; the LFA pair defaults to zeros) — the JAX pipeline's 14
    inputs, in its order. All int32.

    ``lfa`` adds the RFC 5286 backup columns to the selection, the diff
    and both payloads; without it the previous LFA columns pass through.
    ``incr``, when given, is the incremental solve's ``(prev_dist [D,
    n_cap], s_dirty_idx, s_dirty_old, r_dirty_idx, r_dirty_old,
    cone_limit)`` (the JAX ``_incr_pipeline``'s six trailing inputs):
    the SSSP starts from the previous plane, and (cone, fell_back) join
    both buffers' tails. The distance plane is returned in ``dist``
    with ``incr`` or ``emit_dist``.

    ``stream`` (a ``STREAM_BUDGETS`` bucket, with ``incr``) makes this
    the streaming epoch (the port of ``tpu_solver._stream_pipeline``):
    the delta payload takes that budget and carries the route-ok bit of
    each changed row (``ops/stream.py`` layout). ``out`` is the plane
    set K3 writes the published columns into — (metric, s3w, nhw,
    lfa_slot, lfa_metric), a set no input aliases — instead of new
    tensors. ``init_out`` (with ``incr``) is K1s's outputs held by the
    caller for the incremental solve (``relax.init_outputs``); the cold
    solve allocates its own, since its seed plane becomes the returned
    distance plane. ``par_out`` (with ``incr``) is K6's parent plane held
    by the caller, read only inside the solve."""
    p_cap = prev_metric.shape[0]
    a_cap = mbuf.numel() // (6 * p_cap)
    if prev_lfa_slot is None:
        prev_lfa_slot = torch.zeros_like(prev_metric)
        prev_lfa_metric = torch.zeros_like(prev_metric)
    events, mark = _timing_events(shift_w, 4 if incr is None else 7)
    mark()
    incr_tail = None
    spread = {"cone_trips": 0}
    if incr is None:
        dist_d, trips, rounds = plan_sssp(
            deltas, shift_w, res_rows, res_nbr, res_w, root, root_nbr,
            root_w, has_res, kernel, delta_exp,
        )
    else:
        s_cap, n_cap = shift_w.shape
        dist_d, trips, cone, fell_back, rounds = incremental_sssp(
            deltas, shift_w, res_rows, res_nbr, res_w, root, root_nbr,
            root_w, *incr, s_cap, has_res, n_cap, root_nbr.shape[0],
            max_trips(n_cap), kernel, delta_exp, mark=mark, stats=spread,
            init_out=init_out, par_out=par_out,
        )
        incr_tail = (cone, fell_back)
        spread["cone_trips"] = _host_word(spread["cone_trips"])
    mark()
    sel = select_routes(dist_d, root_w, root, mbuf, p_cap, a_cap, block_v4,
                        lfa, None if out is None
                        else out[:3] + (tuple(out[3:5]) if lfa else ()))
    metric, s3w, nhw, ok = sel[:4]
    lfa_slot, lfa_metric, lfa_cols = _lfa_tail(sel, prev_lfa_slot,
                                               prev_lfa_metric, lfa)
    mark()
    flags = mbuf[p_cap * a_cap:2 * p_cap * a_cap].view(p_cap, a_cap)
    delta_buf, full_buf = compact_outputs(
        metric, s3w, nhw, ok, prev_metric, prev_s3w, prev_nhw, flags,
        trips, rounds, stream or budget, sentinels, incr_tail, lfa_cols,
        bool(stream),
    )
    mark()
    keep = incr is not None or emit_dist
    return PipelineOut(delta_buf, full_buf, metric, s3w, nhw, trips, rounds,
                       events, dist_d if keep else None,
                       spread["cone_trips"], lfa_slot, lfa_metric)


def fused_pipeline(lane_args, *, has_res: bool, block_v4: bool = False,
                   sentinels: bool = True, kernel: str = "sync",
                   delta_exp: int = 0, budget: int = DELTA_BUDGET,
                   lfa: bool = False) -> list:
    """The cold ``pipeline`` for ``g`` same-shape areas in one dispatch
    (the port of ``tpu_solver._fused_pipeline``, a vmap over stacked
    areas). ``lane_args`` holds each area's 14 ``pipeline`` inputs, in
    order (``root`` an int). They stack on a leading area axis and every
    kernel of the solve — K1s, K1, K2, K3, K4 — launches once a step for
    all of them; each area's loops stop and count on their own, so its
    trips and rounds equal its unfused solve's. Always cold and without
    a distance plane, as the JAX group dispatch. Returns one
    ``PipelineOut`` an area, its tensors views of the stacked outputs
    and its trips / rounds the area's own device counters."""
    g = len(lane_args)
    cols = list(zip(*lane_args))
    ref = cols[0][0]
    roots = torch.tensor([int(r) for r in cols[6]], dtype=torch.int32,
                         device=ref.device)
    (deltas, shift_w, res_rows, res_nbr, res_w, mbuf, _, root_nbr, root_w,
     prev_metric, prev_s3w, prev_nhw, prev_lfa_slot, prev_lfa_metric) = [
        None if i == 6 else torch.stack(c) for i, c in enumerate(cols)]
    p_cap = prev_metric.shape[1]
    a_cap = mbuf.shape[1] // (6 * p_cap)
    events, mark = _timing_events(ref, 4)
    mark()
    dist_d, counts = plan_sssp_lanes(
        deltas, shift_w, res_rows, res_nbr, res_w, roots, root_nbr, root_w,
        has_res, kernel, delta_exp,
    )
    mark()
    sel = select_routes(dist_d, root_w, roots, mbuf, p_cap, a_cap, block_v4,
                        lfa)
    metric, s3w, nhw, ok = sel[:4]
    lfa_slot, lfa_metric, lfa_cols = _lfa_tail(sel, prev_lfa_slot,
                                               prev_lfa_metric, lfa)
    mark()
    flags = mbuf.view(g, 6, p_cap, a_cap)[:, 1]
    delta_buf, full_buf = compact_outputs(
        metric, s3w, nhw, ok, prev_metric, prev_s3w, prev_nhw, flags,
        counts, None, budget, sentinels, None, lfa_cols,
    )
    mark()
    return [
        PipelineOut(delta_buf[i], full_buf[i], metric[i], s3w[i], nhw[i],
                    counts[i, 0], counts[i, 1], events, None, 0,
                    lfa_slot[i], lfa_metric[i])
        for i in range(g)
    ]


class McInfo(NamedTuple):
    """What a multichip solve reports beside its pipeline outputs."""

    shards: int
    batch: int
    graph: int
    # per shard "b.g": the end of its batch group's loop — (the
    # dispatch's start, that end) as CUDA events on the shard's card
    # (an event pair must share a card), else ms on the host clock
    # since the dispatch began
    shard_end: dict
    # the group combines: rounds under sync, epochs under bucketed
    halo_exchanges: int
    # the root tables and dirty tuples uploaded to the shards
    bytes_uploaded: int

    def shard_ms(self) -> dict:
        """Per shard: ms from the dispatch's start until its batch group
        left its loop. Reads the events: call after the pull."""
        return {k: v[0].elapsed_time(v[1]) if isinstance(v, tuple) else v
                for k, v in self.shard_end.items()}


def mc_pipeline(mesh, mirror: dict, mbuf, root: int, root_nbr, root_w,
                prev_metric, prev_s3w, prev_nhw, prev_lfa_slot,
                prev_lfa_metric, *, has_res: bool, n_cap: int, s_cap: int,
                block_v4: bool = False, sentinels: bool = True,
                kernel: str = "sync", delta_exp: int = 0,
                budget: int = DELTA_BUDGET, incr=None, lfa: bool = False):
    """``pipeline`` on the multichip tier's ('batch', 'graph') mesh (the
    port of ``tpu_solver._mc_pipeline`` / ``_mc_incr_pipeline``): the SSSP
    core is ``parallel/sharding.mc_sssp`` (or ``mc_incremental_sssp``
    with ``incr``) over the area's resident mirror as the mesh holds it
    (``mirror``: ``Sharded`` deltas, shift_w, res_rows, res_nbr, res_w;
    the residual is gathered whole at use), the root tables (numpy, D a
    multiple of the batch axis) split over 'batch'; the gathered lanes
    then run the selection tail (K3, K4) on the device of ``mbuf`` and
    the previous outputs, as the reference's tail runs on a replicated
    plane. ``incr`` is ``(prev_dist, s_dirty_idx, s_dirty_old,
    r_dirty_idx, r_dirty_old, cone_limit)``: the previous planes as the
    mesh holds them (a grid, each batch group its lanes), the dirty
    tuples as numpy arrays. trips and rounds are the max over the batch
    groups. Returns ``(PipelineOut, McInfo)``; the output's ``dist`` is
    the grid of planes (the next incremental solve's seed, each group's
    lanes staying home)."""
    from openr_tpu_torch.parallel import sharding

    dev = mbuf.device
    p_cap = prev_metric.shape[0]
    a_cap = mbuf.numel() // (6 * p_cap)
    d_cap = root_nbr.shape[0]
    cuda_ev = dev.type == "cuda"
    events, mark = _timing_events(prev_metric, 4)
    t0 = time.perf_counter()
    mark()
    shard_end = {}
    starts = {}
    for _, _, sdev in mesh.shards() if cuda_ev else ():
        if sdev not in starts:
            starts[sdev] = torch.cuda.Event(enable_timing=True)
            starts[sdev].record(torch.cuda.current_stream(sdev))

    def done(b):
        for j, sdev in enumerate(mesh.devices[b]):
            if cuda_ev:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(sdev))
                shard_end[f"{b}.{j}"] = (starts[sdev], ev)
            else:
                shard_end[f"{b}.{j}"] = (time.perf_counter() - t0) * 1e3

    whole = {}

    def at_use(name, b, j):
        """The residual whole on the shard's card (one copy a card)."""
        key = (name, mesh.devices[b][j])
        if key not in whole:
            whole[key] = sharding.gather(mirror[name], b, j)
        return whole[key]

    grid = sharding._grid
    lanes = sharding.Layout(0, "batch")
    placed = [sharding.place(mesh, root_nbr, lanes),
              sharding.place(mesh, root_w, lanes)]
    kw = dict(
        deltas=mirror["deltas"].parts, shift_w=mirror["shift_w"].parts,
        res_rows=grid(mesh, lambda b, j: at_use("res_rows", b, j)),
        res_nbr=grid(mesh, lambda b, j: at_use("res_nbr", b, j)),
        res_w=grid(mesh, lambda b, j: at_use("res_w", b, j)),
        root=int(root), root_nbr=placed[0].parts, root_w=placed[1].parts,
    )
    static = dict(s_cap=s_cap, has_res=has_res, n_cap=n_cap, d_cap=d_cap,
                  max_trips=max_trips(n_cap), kernel=kernel,
                  delta_exp=delta_exp, done=done)
    incr_tail = None
    if incr is None:
        planes, trips, rounds = sharding.mc_sssp(mesh, **kw, **static)
    else:
        prev_dist, sdi, sdo, rdi, rdo, cone_limit = incr
        dirty = [sharding.place(mesh, a) for a in (sdi, sdo, rdi, rdo)]
        placed += dirty
        planes, trips, cone, fell_back, rounds = (
            sharding.mc_incremental_sssp(
                mesh, **kw, prev_dist=prev_dist, s_dirty_idx=dirty[0].parts,
                s_dirty_old=dirty[1].parts, r_dirty_idx=dirty[2].parts,
                r_dirty_old=dirty[3].parts, cone_limit=int(cone_limit),
                **static))
        incr_tail = (cone.to(dev), fell_back.to(dev))
    dist_d = torch.cat([row[0].to(dev) for row in planes])
    mark()
    trips, rounds_n = max(trips), max(rounds)
    sel = select_routes(dist_d, torch.tensor(root_w, device=dev), root, mbuf,
                        p_cap, a_cap, block_v4, lfa)
    metric, s3w, nhw, ok = sel[:4]
    lfa_slot, lfa_metric, lfa_cols = _lfa_tail(sel, prev_lfa_slot,
                                               prev_lfa_metric, lfa)
    mark()
    flags = mbuf[p_cap * a_cap:2 * p_cap * a_cap].view(p_cap, a_cap)
    delta_buf, full_buf = compact_outputs(
        metric, s3w, nhw, ok, prev_metric, prev_s3w, prev_nhw, flags,
        trips, rounds_n, budget, sentinels, incr_tail, lfa_cols,
    )
    mark()
    info = McInfo(mesh.size, mesh.shape["batch"], mesh.shape["graph"],
                  shard_end, trips if kernel == "bucketed" else rounds_n,
                  sum(a.nbytes() for a in placed) + 4 * d_cap)
    return PipelineOut(delta_buf, full_buf, metric, s3w, nhw, trips,
                       rounds_n, events, planes, 0, lfa_slot,
                       lfa_metric), info


def legacy_pipeline(in_nbr, in_w, in_up, node_over, root, root_nbr,
                    root_w, root_up, ann_node, ann_valid, path_pref,
                    source_pref, dist_adv) -> tuple:
    """The legacy single-graph pipeline (the port of
    ``tpu_solver._jitted_pipeline`` and of ``__graft_entry__.entry``'s
    forward step) on the device of its tensors: K18 trips from
    ``root``, K19 rounds for its slot masks, K20 selection. Inputs are
    the JAX pipeline's 13, in its order: the ELL mirror (``in_nbr`` /
    ``in_w`` int32, ``in_up`` bool [n_cap, k_cap], ``node_over`` bool
    [n_cap]), the root's index and out-slot table (``root_nbr`` /
    ``root_w`` int32, ``root_up`` bool [D], ``EllGraph.out_table``) and
    the announcer matrix (``ann_node`` int32, ``ann_valid`` bool,
    ``path_pref`` / ``source_pref`` / ``dist_adv`` int32 [P, A]).
    Returns ``(dist [n_cap], metric [P], s3 [P, A], nh_mask [P, D],
    has_route [P])``."""
    root = int(root)
    roots = torch.tensor([root], dtype=torch.int32, device=in_nbr.device)
    dist = legacy.ell_sssp(in_nbr, in_w, in_up, node_over, roots)[0][0]
    nh, _ = legacy.ell_next_hops(dist, in_nbr, in_w, in_up, node_over, root,
                                 root_nbr, root_w, root_up)
    metric, s3, nh_mask, has_route = legacy.ell_select(
        dist, nh, node_over, ann_node, ann_valid, path_pref, source_pref,
        dist_adv,
    )
    return dist, metric, s3, nh_mask, has_route


def sssp_batch(in_nbr, in_w, in_up, node_over, roots) -> torch.Tensor:
    """Distances int32 [R, n_cap] from each root of the int32 tensor
    ``roots`` [R] over the ELL mirror (INF = 2^30 where unreachable): the
    port of ``tpu_solver._jitted_sssp_batch``, K18 trips on the device
    of the tensors."""
    return legacy.ell_sssp(in_nbr, in_w, in_up, node_over, roots)[0]


def sssp_all_pairs(graph: EllGraph, roots=None,
                   device="cuda") -> torch.Tensor:
    """Batched SSSP from many roots of an ``EllGraph`` (every node by
    default): int32 [R, n_cap] on ``device`` (the port of
    ``tpu_solver.sssp_all_pairs``)."""
    dev = resolve_device(device)
    if roots is None:
        roots = np.arange(graph.n_nodes, dtype=np.int32)
    (roots,) = legacy.to_device(dev, np.asarray(roots, np.int32))
    # K18 reads only the packed mirror: the padded one stays on the host
    return legacy.sssp_packed(legacy.packed_tensors(graph, dev), roots)[0]


class _AreaDev:
    """Per-area resident device state: plan tensors + announcer matrix."""

    __slots__ = (
        "plan", "deltas", "shift_w", "res_rows", "res_nbr", "res_w",
        "matrix_key", "matrix", "flags", "mbuf", "matrix_version",
        "pack_over", "drain_epoch", "drain_log", "mc_mesh", "whole",
    )

    def __init__(self):
        self.plan = None
        # the multichip tier's mesh (None: one device); the mirror
        # tensors are then parallel/sharding.Sharded arrays on it, and
        # ``whole`` maps a device to the mirror gathered whole there,
        # emptied whenever the mirror changes
        self.mc_mesh = None
        self.whole = {}
        self.deltas = self.shift_w = None
        self.res_rows = self.res_nbr = self.res_w = None
        self.matrix_key = None
        self.matrix: Optional[PrefixMatrix] = None
        self.flags: Optional[np.ndarray] = None
        self.mbuf = None
        # bumped whenever the matrix is rebuilt: the row -> prefix
        # mapping may change at identical shapes, so every vantage's
        # delta state must reset against the new rows
        self.matrix_version = 0
        # node_overloaded snapshot at the last pack: an unchanged
        # snapshot skips the O(6*P*A) host concat
        self.pack_over: Optional[np.ndarray] = None
        # drain journal for the incremental solve: one entry per sync
        # epoch — (epoch, {shift_flat: old_w}, {res_flat: old_w}) of
        # that drain's pre-write weights, or (epoch, None, None) as a
        # reset marker (mirror rebuild or residual layout change). A
        # vantage whose plane is k epochs old merges the last k
        # entries; the bounded deque turns a long-idle vantage into a
        # journal gap (cold solve) rather than unbounded host state.
        self.drain_epoch = 0
        self.drain_log = deque(maxlen=16)


    def single(self, device=None) -> tuple:
        """The resident mirror (deltas, shift_w, res_rows, res_nbr,
        res_w) as tensors on one device: the tensors themselves, or on
        the multichip tier the shards' parts gathered whole on
        ``device`` (the mesh's first by default; once after each change
        of the mirror) for the paths that solve on one card (UCMP, KSP2,
        what-if, a one-device fabric step)."""
        names = ("deltas", "shift_w", "res_rows", "res_nbr", "res_w")
        if self.mc_mesh is None:
            return tuple(getattr(self, k) for k in names)
        from openr_tpu_torch.parallel.sharding import canonical, gather

        dev = self.mc_mesh.first if device is None else canonical(device)
        if dev not in self.whole:
            self.whole[dev] = tuple(
                gather(getattr(self, k), 0, 0).to(dev) for k in names)
        return self.whole[dev]


class _VantageState:
    """Per-(area, vantage) output state: the previous solve's resident
    outputs + the columnar RIB the host patches from pulls."""

    __slots__ = ("shape_key", "matrix_version", "prev", "spare", "crib",
                 "links_tuple", "valid", "prev_dist", "dist_epoch",
                 "root_sig", "stream_budget", "init", "par")

    def __init__(self):
        self.shape_key = None
        self.matrix_version = -1
        # (metric, s3w, nhw, lfa_slot, lfa_metric) device tensors
        self.prev = None
        # the streaming epoch's second plane set: an epoch's K3 writes
        # into it while its K4 diff reads ``prev``, then the two swap
        self.spare = None
        # streaming changed-rows budget (an ops/stream.STREAM_BUDGETS
        # bucket): grows past an overflow, settles back on quiet epochs
        self.stream_budget = STREAM_BUDGETS[0]
        self.crib: Optional[ColumnarRib] = None
        self.links_tuple: tuple = ()
        self.valid = False
        # incremental seed state: the [D, N] distance plane of the last
        # solve, the area drain epoch it belongs to, and the root
        # out-link signature it was computed under (lane <-> neighbour
        # map + per-lane link-up mask; a flipped lane goes between
        # all-INF and finite, which a warm re-relax cannot express)
        self.prev_dist = None
        self.dist_epoch = -1
        self.root_sig = None
        # K1s's outputs for the incremental solves (relax.init_outputs),
        # sized with the vantage's shapes and dropped with them: written
        # anew by every incremental solve, never its returned plane, so
        # never ``prev_dist``
        self.init = None
        # K6's parent plane for the incremental solves, held likewise:
        # written whole and read only inside a solve, never returned
        self.par = None


class _UcmpAccel:
    """The oracle's ``ucmp_resolver`` (the port of the JAX solver's
    ``_UcmpAccel``): resolves UCMP weights with the device fixpoint
    (``ops/ucmp.py``) over the root's unmasked distance field
    (``ops/ksp2.base_sssp``) instead of the host heap walk. It answers
    ``NotImplemented`` — the host walk then runs — whenever its area
    state is stale (a single-prefix rebuild, an area solved entirely by
    the oracle, a cross-area prefix) or the fixpoint overflowed."""

    def __init__(self, solver: "GpuSpfSolver"):
        self.solver = solver
        # area -> (generation, plan, UcmpEdges)
        self.edges: dict[str, tuple] = {}
        # (area, root) -> (generation, plan, device field, host field)
        self.base: dict[tuple, tuple] = {}
        # per-generation memo: anycast prefixes share one announcer set,
        # so identical (leaves, mode) resolve once
        self.results: dict[tuple, object] = {}
        self._results_gen: dict[str, int] = {}

    def _base_for(self, area: str, root: str, ridx: int, link_state,
                  ad: "_AreaDev"):
        gen = link_state.generation
        plan = ad.plan
        # the KSP2 prime of this generation computed the same field
        cached = self.solver._ksp2_base.get((area, root))
        if cached is not None and cached[0] == gen and cached[1] is plan:
            return cached[2], cached[3]
        mine = self.base.get((area, root))
        if mine is not None and mine[0] == gen and mine[1] is plan:
            return mine[2], mine[3]
        d_base, _ = base_sssp(*ad.single(self.solver.device), ridx,
                              plan.k_res > 0)
        base_np = d_base.cpu().numpy()
        self.base[(area, root)] = (gen, plan, d_base, base_np)
        return d_base, base_np

    def _edges_for(self, area: str, link_state, plan) -> UcmpEdges:
        gen = link_state.generation
        hit = self.edges.get(area)
        if hit is not None and hit[0] == gen and hit[1] is plan:
            return hit[2]
        edges = UcmpEdges(link_state, plan.node_overloaded, plan.n_cap,
                          upload=self.solver._upload)
        self.edges[area] = (gen, plan, edges)
        return edges

    def __call__(self, root, area, link_state, dst_weights,
                 use_prefix_weight):
        solver = self.solver
        ad = solver._area_dev.get(area)
        gen = link_state.generation
        if (
            not dst_weights
            or ad is None
            or ad.plan is None
            or ad.plan.synced_generation != gen
            or link_state.is_node_overloaded(root)
        ):
            return NotImplemented
        plan = ad.plan
        ridx = plan.node_index.get(root)
        if ridx is None:
            return NotImplemented
        if self._results_gen.get(area) != gen:
            self.results = {
                k: v for k, v in self.results.items() if k[0] != area
            }
            self._results_gen[area] = gen
        rkey = (
            area, root, tuple(sorted(dst_weights.items())),
            bool(use_prefix_weight),
        )
        if rkey in self.results:
            return self.results[rkey]
        d_base, base_np = self._base_for(area, root, ridx, link_state, ad)
        # the caller filtered the leaves to the best metric, so they are
        # equidistant; the host walk's guard, mirrored
        leaf_metrics = {
            int(base_np[plan.node_index[n]])
            for n in dst_weights
            if n in plan.node_index
        }
        if len(leaf_metrics) != 1 or INF_E in leaf_metrics:
            self.results[rkey] = None
            return None
        edges = self._edges_for(area, link_state, plan)
        reach, w, overflow = propagate(edges, d_base, dst_weights,
                                       use_prefix_weight)
        if solver.enable_sentinels:
            if overflow:
                solver.last_sentinels["ucmp_overflow"] = (
                    solver.last_sentinels.get("ucmp_overflow", 0) + 1
                )
                counters.increment("decision.sentinel.ucmp_overflow")
            bad = _ucmp_weight_anomalies(w)
            if bad:
                solver.last_sentinels["ucmp_bad_weights"] = (
                    solver.last_sentinels.get("ucmp_bad_weights", 0) + bad
                )
                counters.increment("decision.sentinel.ucmp_bad_weights",
                                   bad)
        if overflow:
            # the host walk's Python ints are exact; memoized so sibling
            # anycast prefixes skip the device round trip
            self.results[rkey] = NotImplemented
            return NotImplemented
        res = self._assemble(root, ridx, link_state, plan, base_np, reach, w,
                             dst_weights)
        self.results[rkey] = res
        return res

    @staticmethod
    def _assemble(root, ridx, link_state, plan, base_np, reach, w,
                  dst_weights):
        """The root-local finish: per-interface next-hop weights from the
        propagated field, gcd-normalized (O(degree(root)))."""
        res = NodeUcmpResult(0)
        if root in dst_weights:
            # the root announces: its weight is its own advertisement,
            # and equidistant leaves cannot chain (as the host walk)
            res.weight = dst_weights[root]
            return res
        if not reach[ridx]:
            return None
        my_dist = int(base_np[ridx])
        index = plan.node_index
        for link in link_state.ordered_links_from_node(root):
            if not link.is_up():
                continue
            nbr = link.other_node(root)
            j = index.get(nbr)
            if j is None or not reach[j]:
                continue
            if my_dist + link.metric_from_node(root) != int(base_np[j]):
                continue  # not a shortest-path DAG edge
            res.add_next_hop_link(
                link.iface_from_node(root), link, nbr, int(w[j])
            )
        res.weight = int(w[ridx])
        res.normalize_next_hop_weights()
        return res


class _PendingBuild:
    """A solve between dispatch_route_db (LSDB reads + device work) and
    collect_route_db (the buffer pulls + RIB patch)."""

    __slots__ = ("route_db", "areas", "t_pipe0", "bytes_uploaded",
                 "ksp2_timing")

    def __init__(self, route_db, areas, t_pipe0, bytes_uploaded,
                 ksp2_timing=None):
        self.route_db = route_db
        self.areas = areas
        self.t_pipe0 = t_pipe0
        self.bytes_uploaded = bytes_uploaded
        # the ksp2_* keys of this build's KSP2 prime (last_timing)
        self.ksp2_timing = ksp2_timing or {}


def _memo_prefix_matrix(prefix_state: PrefixState, link_state: LinkState,
                        node_index: dict, area: str,
                        prefixes: list) -> PrefixMatrix:
    """The area's announcer matrix, memoized on the PrefixState: it is a
    pure derivation of (prefix generation, area, link_state.generation —
    which pins the node-index mapping — and the prefix list), so a fresh
    solver over live state (a restart in process, another vantage)
    skips the 100k-prefix packing loop."""
    cache = getattr(prefix_state, "_matrix_memo", None)
    if cache is None:
        cache = prefix_state._matrix_memo = {}
    key = (prefix_state.generation, area, link_state.generation)
    hit = cache.get(area)
    if hit is not None and hit[0] == key and hit[1] == prefixes:
        return hit[2]
    matrix = build_prefix_matrix(prefix_state, node_index, area, prefixes)
    cache[area] = (key, prefixes, matrix)
    return matrix


class GpuSpfSolver:
    """Drop-in for SpfSolver.build_route_db with the hot path on the
    GPU. Differentially tested against the CPU oracle and, input for
    input, against the JAX package's pipeline."""

    _MAX_FOREIGN_VANTAGES = 4
    _MAX_KSP2_STATES = 4

    def __init__(
        self, my_node_name: str, device="cuda",
        small_graph_nodes: int = 0,
        enable_numerical_sentinels: bool = True,
        fuse_small_areas: bool = True,
        fuse_n_cap: int = FUSE_N_CAP,
        incremental_spf: bool = False,
        incremental_cone_frac: float = 0.25,
        spf_kernel: str = "bucketed",
        multichip_n_cap_threshold: int = 131072,
        multichip_batch: int = 0,
        multichip_devices=None,
        streaming_pipeline: bool = False,
        **solver_kwargs,
    ):
        self.device = resolve_device(device)
        if not isinstance(streaming_pipeline, bool):
            raise ValueError(
                f"streaming_pipeline must be a bool, got "
                f"{streaming_pipeline!r}"
            )
        if spf_kernel not in ("sync", "bucketed"):
            raise ValueError(f"unknown spf_kernel {spf_kernel!r}")
        self.my_node_name = my_node_name
        # a whole solve whose areas all have fewer nodes than this, and
        # any such area of a larger solve, goes to the oracle: it beats
        # a device round trip there
        self.small_graph_nodes = int(small_graph_nodes)
        # same-shape areas of at most fuse_n_cap node slots solve in one
        # fused dispatch
        self.fuse_small_areas = bool(fuse_small_areas)
        self.fuse_n_cap = int(fuse_n_cap)
        # "bucketed" runs Δ-stepping wherever the plan derived a usable
        # Δ (plan.delta_exp > 0) and the sync rounds otherwise; "sync"
        # forces the sync rounds everywhere
        self.spf_kernel = spf_kernel
        self.enable_sentinels = enable_numerical_sentinels
        # incremental SSSP: seed each eligible solve from the vantage's
        # previous distance plane and re-anchor only the affected cone;
        # the result is bit-identical to the cold solve. The cold solve
        # runs on a first solve, shape / root churn, a journal gap,
        # zero-weight edges, an oversized dirty set, in a fused group,
        # and — decided on the device — when the cone exceeds
        # incremental_cone_frac of the area's node-lanes.
        # streaming epochs: an incremental solve that pulls a bucketed
        # changed-rows payload with the device route-ok bit and swaps the
        # vantage's two plane sets in place. Implies incremental_spf;
        # every epoch the incremental gate refuses (first solve, shape /
        # root churn, journal gaps, fused groups) takes the classic path
        self.streaming_pipeline = streaming_pipeline
        self.incremental_spf = bool(incremental_spf) or streaming_pipeline
        self.incremental_cone_frac = float(incremental_cone_frac)
        # the multichip tier: an area whose n_cap exceeds the threshold
        # solves on a ('batch', 'graph') mesh of multichip_devices (the
        # visible cards by default; the solver's CPU for a CPU solver)
        # when it has two or more; multichip_batch sets the batch axis
        # (0: make_mesh's factoring). force_single_chip keeps the tier
        # off while set; the next sync of an area flips it back.
        self.multichip_n_cap_threshold = int(multichip_n_cap_threshold)
        self.multichip_batch = int(multichip_batch)
        self.multichip_devices = (None if multichip_devices is None
                                  else list(multichip_devices))
        self.force_single_chip = False
        self._mc_mesh: object = False  # False: not resolved yet
        self.cpu = SpfSolver(my_node_name, **solver_kwargs)
        # UCMP weights resolve on the device through the oracle's
        # resolver hook (the host walk answers when the hook cannot)
        self._ucmp_accel = _UcmpAccel(self)
        self.cpu.ucmp_resolver = self._ucmp_accel
        self._area_dev: dict[str, _AreaDev] = {}
        self._vstates: dict[tuple, _VantageState] = {}
        self._vantage_lru: OrderedDict[tuple, None] = OrderedDict()
        # ((generation, areas), fast_by_area, slow, ksp2, ksp2_by_area)
        self._partition = None
        # KSP2 state per (area, vantage), the last _MAX_KSP2_STATES
        # vantages kept: the base field (generation, plan, device field,
        # host field), the resident masked rows, the trace-reuse
        # certificates
        self._ksp2_base: dict[tuple, tuple] = {}
        self._ksp2_rows: dict[tuple, MaskedRowsState] = {}
        self._ksp2_certs: dict[tuple, dict] = {}
        self._ksp2_lru: OrderedDict[tuple, None] = OrderedDict()
        self._ksp2_timing: dict = {}
        self._bytes_uploaded = 0
        # CUDA event pairs around the dirty-weight scatters of this solve,
        # and the pairs read and free for the next ones
        self._scatter_events: list = []
        self._event_pool: list = []
        # host-to-device copies made by _stage (the scatter's and the
        # incremental solve's small uploads)
        self._staged_copies = 0
        self._last_exec_incr = None
        # numerical-health sentinels of the last solve, summed over areas
        self.last_sentinels: dict = {}
        # the last area's solve statistics (incremental, cone,
        # fell_back, changed_rows, trips, rounds, fused, ...)
        self.last_device_stats: dict = {}
        # wall-time and device-time breakdown of the last solve
        self.last_timing: dict = {}
        # the trips of the last cold solve (never an incremental one's):
        # the seed of the whole-fabric step's trip bound
        self.last_trips: int = 0
        # time split and counts of the last build_fabric_route_dbs
        self.last_fabric_stats: dict = {}

    # static-route passthroughs keep the Decision actor backend-agnostic
    def update_static_unicast_routes(self, to_update, to_delete) -> None:
        self.cpu.update_static_unicast_routes(to_update, to_delete)

    def update_static_mpls_routes(self, to_update, to_delete) -> None:
        self.cpu.update_static_mpls_routes(to_update, to_delete)

    def create_route_for_prefix_or_get_static(
        self, my_node_name, area_link_states, prefix_state, prefix
    ):
        """Single-prefix rebuilds have no batch to amortize a launch
        over: the oracle answers them."""
        return self.cpu.create_route_for_prefix_or_get_static(
            my_node_name, area_link_states, prefix_state, prefix
        )

    @property
    def static_unicast_routes(self):
        return self.cpu.static_unicast_routes

    @property
    def static_mpls_routes(self):
        return self.cpu.static_mpls_routes

    # -- build -------------------------------------------------------------

    def build_route_db(
        self,
        my_node_name: str,
        area_link_states: dict[str, LinkState],
        prefix_state: PrefixState,
    ) -> Optional[DecisionRouteDb]:
        pending = self.dispatch_route_db(
            my_node_name, area_link_states, prefix_state
        )
        if pending is None:
            return None
        return self.collect_route_db(pending)

    def dispatch_route_db(
        self,
        my_node_name: str,
        area_link_states: dict[str, LinkState],
        prefix_state: PrefixState,
    ) -> Optional[_PendingBuild]:
        """Phase 1: every LSDB read, mirror upload and pipeline launch,
        plus the oracle's host routes. Returns None when this vantage
        is in no area's graph."""
        if not any(
            ls.has_node(my_node_name) for ls in area_link_states.values()
        ):
            return None
        self.last_timing = {}
        self.last_sentinels = {}
        self._bytes_uploaded = 0
        self._scatter_events = []
        t_pipe0 = time.perf_counter()
        if all(
            ls.node_count() < self.small_graph_nodes
            for ls in area_link_states.values()
        ):
            db = self.cpu.build_route_db(
                my_node_name, area_link_states, prefix_state
            )
            return _PendingBuild(db, [], t_pipe0, 0)
        fast_by_area, slow, ksp2, ksp2_by_area = self._partition_prefixes(
            prefix_state, area_link_states
        )
        route_db = DecisionRouteDb()
        small: list[str] = []
        preps: list[dict] = []
        for area, plist in fast_by_area.items():
            link_state = area_link_states[area]
            if not link_state.has_node(my_node_name):
                continue  # unreachable area for this vantage: no routes
            if link_state.node_count() < self.small_graph_nodes:
                small.extend(plist)
                continue
            preps.append(self._prep_vantage(
                my_node_name, area, link_state, prefix_state, plist
            ))
        # same-shape small areas batch into ONE dispatch; a group of one
        # goes back to the singles
        singles: list[dict] = []
        groups: dict[tuple, list] = {}
        for pv in preps:
            # a multichip-tier area never fuses (as the reference)
            if (self.fuse_small_areas and pv["mc"] is None
                    and pv["plan"].n_cap <= self.fuse_n_cap):
                groups.setdefault(pv["fuse_key"], []).append(pv)
            else:
                singles.append(pv)
        areas = []
        for group in groups.values():
            if len(group) < 2:
                singles.extend(group)
            else:
                areas.extend(self._dispatch_fused(group))
        areas.extend(self._dispatch_one(pv) for pv in singles)
        # the per-destination second passes batch on the device and prime
        # the k-paths cache; the oracle loop below then assembles the
        # KSP2 routes through its unchanged code. A KSP2 prefix announced
        # in a single area primes that area.
        self._ksp2_timing = {}
        for area, plist in ksp2_by_area.items():
            link_state = area_link_states[area]
            if not link_state.has_node(my_node_name):
                continue
            if link_state.node_count() < self.small_graph_nodes:
                continue  # host Dijkstras beat a device batch here
            self._prime_ksp2(my_node_name, area, link_state, prefix_state,
                             plist, fast_by_area.get(area, []))
        if self.cpu.enable_ucmp:
            self._prime_ucmp(my_node_name, area_link_states, prefix_state,
                             slow, fast_by_area)
        self._host_routes(
            my_node_name, area_link_states, prefix_state,
            slow + ksp2 + small, route_db,
        )
        return _PendingBuild(route_db, areas, t_pipe0, self._bytes_uploaded,
                             self._ksp2_timing)

    def collect_route_db(
        self, pending: Optional[_PendingBuild]
    ) -> Optional[DecisionRouteDb]:
        """Phase 2: pull each area's buffer, patch its ColumnarRib and
        assemble the timing breakdown."""
        if pending is None:
            return None
        route_db = pending.route_db
        if not pending.areas:
            self.last_timing = dict(pending.ksp2_timing)
            return route_db
        views = []
        totals: dict[str, float] = {}
        area_timing = {}
        trips = rounds = halo = epochs = 0
        multichip = False
        bytes_dl = 0
        kernels = set()
        stream = {"epochs": 0, "changed_rows": 0, "overflows": 0}
        for ctx in pending.areas:
            view, timing, stats = self._collect_area(ctx)
            views.append(view)
            area_timing[ctx["pv"]["area"]] = timing
            for k, v in timing.items():
                if v is not None:
                    totals[k] = totals.get(k, 0.0) + v
            trips += stats["trips"]
            rounds += stats["rounds"]
            halo += stats.get("halo_exchanges", 0)
            epochs += stats["bucket_epochs"]
            if stats.get("multichip"):
                multichip = stats["multichip"]
            bytes_dl += stats["bytes_downloaded"]
            kernels.add(stats["spf_kernel"])
            if "stream" in stats:
                stream["epochs"] += 1
                stream["changed_rows"] += stats["changed_rows"] or 0
                stream["overflows"] += int(stats["stream"]["overflow"])
            self.last_device_stats = stats
            if not stats.get("incremental"):
                # a warm re-relax converges in a trip or two: not a
                # diameter bound the whole-fabric step may reuse
                self.last_trips = stats["trips"]
            for sk, sv in stats.get("sentinels", {}).items():
                self.last_sentinels[sk] = self.last_sentinels.get(sk, 0) + sv
        # device routes shadow host/static entries for the same prefix
        route_db.unicast_routes = LazyUnicastRoutes(
            route_db.unicast_routes, views
        )
        counters.add_stat_value("decision.device.rounds", rounds)
        counters.add_stat_value("decision.device.bucket_epochs", epochs)
        if multichip:
            # once a solve: the tier is live
            counters.increment("decision.solver.multichip.engaged")
        if halo:
            counters.add_stat_value("decision.device.halo_exchanges", halo)
        self.last_timing = {
            **totals,
            "pipeline_wall_ms": (time.perf_counter() - pending.t_pipe0) * 1e3,
            "areas": area_timing,
            "trips": trips,
            "rounds": rounds,
            "bucket_epochs": epochs,
            "halo_exchanges": halo,
            "multichip": multichip,
            "spf_kernel": "bucketed" if "bucketed" in kernels else "sync",
            "bytes_uploaded": float(pending.bytes_uploaded),
            "bytes_downloaded": float(bytes_dl),
            **pending.ksp2_timing,
        }
        if stream["epochs"]:
            self.last_timing["stream"] = {**stream,
                                          "bytes_downloaded": bytes_dl}
        return route_db

    def _prime_ucmp(self, my_node_name, area_link_states, prefix_state,
                    slow, fast_by_area) -> None:
        """Before the oracle loop reaches the UCMP prefixes: sync their
        areas' device mirrors and prime each LinkState's SPF memo from
        the device base field, so the oracle's ``get_spf_result(root)``
        answers without a host Dijkstra and the resolver hook finds
        fresh area state."""
        by_area: set = set()
        for prefix in slow:
            entries = prefix_state.entries_for(prefix) or {}
            areas = {a for _, a in entries}
            if len(areas) != 1:
                continue  # cross-area: the oracle's host path
            if any(e.forwarding_algorithm in _UCMP_ALGOS
                   for e in entries.values()):
                by_area.add(next(iter(areas)))
        for area in sorted(by_area):
            link_state = area_link_states.get(area)
            if (
                link_state is None
                or not link_state.has_node(my_node_name)
                or link_state.node_count() < self.small_graph_nodes
                or link_state.is_node_overloaded(my_node_name)
            ):
                continue
            ad = self._sync_area(area, link_state, prefix_state,
                                 fast_by_area.get(area, []))
            ridx = ad.plan.node_index.get(my_node_name)
            if ridx is None:
                continue
            _, base_np = self._ucmp_accel._base_for(
                area, my_node_name, ridx, link_state, ad
            )
            node_index = ad.plan.node_index

            def metric_of(n, _idx=node_index, _base=base_np):
                j = _idx.get(n)
                if j is None:
                    return None
                v = int(_base[j])
                return None if v >= INF_E else v

            link_state.prime_spf_metrics(my_node_name, metric_of)

    def _prime_ksp2(self, my_node_name, area, link_state, prefix_state,
                    prefixes, fast) -> None:
        """Prime the LinkState's SPF memo and k-paths cache from device
        distance fields, so the oracle's unchanged KSP2 assembly
        (selection, canonical trace, label stacks) runs with no host
        Dijkstra (the port of the JAX solver's ``_prime_ksp2``):

          1. the unmasked base field (``base_sssp``), pulled once per
             (vantage, topology generation), backs a lazy SPF result —
             the reachability filter and the k = 1 trace metrics;
          2. every destination's second-pass field (its first paths'
             links removed) comes from one masked batch
             (``masked_rows_update``), shipped as deltas against the
             previous generation's rows.

        Parity is structural: the fields equal run_spf's metrics (SSSP
        values are unique) and the canonical trace reads only those
        values."""
        dests = sorted({
            node
            for pfx in prefixes
            for (node, a) in (prefix_state.entries_for(pfx) or {})
            if a == area
            and node != my_node_name
            and link_state.has_node(node)
        })
        if all(
            (my_node_name, d, 2) in link_state._kth_paths for d in dests
        ) and (my_node_name, True) in link_state._spf_results:
            return  # warm: nothing to prime, no device work

        t0 = time.perf_counter()
        ad = self._sync_area(area, link_state, prefix_state, fast)
        plan = ad.plan
        _ensure_edge_loc(plan)
        root_idx = plan.node_index[my_node_name]
        node_index = plan.node_index

        deltas, d_shift_w, res_rows, res_nbr, d_res_w = ad.single(self.device)
        root_overloaded = link_state.is_node_overloaded(my_node_name)
        if root_overloaded:
            # run_spf exempts the root from its own transit drain; the
            # mirror folded the drain into the root's out-edge weights,
            # so uploaded copies restore them (the resident planes, and
            # every other vantage, never see them)
            sw = plan.shift_w.copy()
            rw = plan.res_w.copy()
            for link in link_state.links_from_node(my_node_name):
                if not link.is_up():
                    continue
                w = min(link.metric_from_node(my_node_name), 1 << 28)
                kind, a, b = edge_loc_of(plan, link, my_node_name)
                if kind == "s":
                    sw[a, b] = w
                else:
                    rw[a, b] = w
            d_shift_w = self._upload(sw)
            d_res_w = self._upload(rw)

        # base (k = 1) field: one device SSSP and one [n_cap] pull per
        # (vantage, topology generation). The masked batch dispatches
        # speculatively (previous masks) right behind it, so its device
        # work and its copy overlap the base pull and the host traces.
        bkey = (area, my_node_name)
        self._touch_ksp2_state(bkey)
        gen = link_state.generation
        cached = None if root_overloaded else self._ksp2_base.get(bkey)
        rstate = self._ksp2_rows.get(bkey)
        if rstate is None:
            rstate = self._ksp2_rows[bkey] = MaskedRowsState()
        planes = (d_shift_w, res_rows, res_nbr, d_res_w, deltas)
        if cached is not None and cached[0] == gen and cached[1] is plan:
            d_base, base_np = cached[2], cached[3]
            spec = None  # same generation: the rows are current
        else:
            d_base, _ = base_sssp(deltas, d_shift_w, res_rows, res_nbr,
                                  d_res_w, root_idx, plan.k_res > 0)
            pending = pull_async(d_base)
            spec = masked_rows_dispatch(rstate, plan, *planes, root_idx)
            base_np = pull_wait(pending)
            if not root_overloaded:
                self._ksp2_base[bkey] = (gen, plan, d_base, base_np)
        t1 = time.perf_counter()

        def metric_of(n, _idx=node_index, _base=base_np):
            j = _idx.get(n)
            if j is None:
                return None
            v = int(_base[j])
            return None if v >= INF_E else v

        link_state.prime_spf_metrics(my_node_name, metric_of)

        # -- trace-reuse certificates -----------------------------------
        # A canonical trace is a pure function of (the dist values it
        # read, the link attributes at the nodes it visited). Each
        # destination's read set is kept; if since the last prime (a)
        # only "links" changelog events occurred, (b) no flapped link's
        # endpoint and no base-field change touches the read set, and (c)
        # for k = 2 the masked row is value-identical (device-verified),
        # the previous paths are primed again without a trace.
        certs = None if root_overloaded else self._ksp2_certs.get(bkey)
        reusable = certs is not None and certs["plan"] is plan
        flap_dirty: set = set()
        dirty: set = set()
        if reusable:
            events = link_state.events_since(certs["gen"])
            reusable = events is not None and all(
                ev[0] == "links" for ev in events
            )
            if reusable:
                for _kind, links in events:
                    for lk in links:
                        flap_dirty.add(lk.n1)
                        flap_dirty.add(lk.n2)
                dirty = set(flap_dirty)
                prev_base = certs["base_np"]
                if prev_base is not base_np:
                    names = plan.node_names
                    for j in np.nonzero(base_np != prev_base)[0]:
                        if j < len(names):
                            dirty.add(names[j])
        cert_dests = certs["dests"] if reusable else {}

        new_dests: dict = {}
        jobs = []  # (dest, ignore set, mask locs, cert, reads1, paths1)
        for dest in dests:
            if (my_node_name, dest, 2) in link_state._kth_paths:
                continue
            c = cert_dests.get(dest)
            reads1 = None
            paths1 = link_state._kth_paths.get((my_node_name, dest, 1))
            if paths1 is None:
                if (
                    c is not None
                    and c["reads1"] is not None
                    and not (c["reads1"] & dirty)
                ):
                    paths1, reads1 = c["paths1"], c["reads1"]
                else:
                    reads1 = set()

                    def rd1(n, _r=reads1, _m=metric_of):
                        _r.add(n)
                        return _m(n)

                    paths1 = link_state.trace_paths_on_dist(
                        my_node_name, dest, rd1, set()
                    )
                link_state.prime_kth_paths(my_node_name, dest, 1, paths1)
            if not paths1:
                link_state.prime_kth_paths(my_node_name, dest, 2, [])
                new_dests[dest] = {
                    "reads1": reads1, "paths1": paths1,
                    "locs": None, "reads2": set(), "paths2": [],
                }
                continue
            ignore = link_state.kth_paths_ignore_set(my_node_name, dest, 2)
            locs = []
            for link in ignore:
                locs.append(edge_loc_of(plan, link, link.n1))
                locs.append(edge_loc_of(plan, link, link.n2))
            jobs.append((dest, ignore, locs, c, reads1, paths1))
        t2 = time.perf_counter()
        if not jobs:
            if not root_overloaded:
                self._ksp2_certs[bkey] = {
                    "gen": link_state.generation, "plan": plan,
                    "base_np": base_np, "dests": new_dests,
                }
            self._ksp2_timing = {
                "ksp2_base_ms": (t1 - t0) * 1e3,
                "ksp2_k1_ms": (t2 - t1) * 1e3,
            }
            return

        changed = masked_rows_update(
            rstate, plan, *planes, root_idx,
            tuple(j[0] for j in jobs), [j[2] for j in jobs], spec=spec,
        )
        t3 = time.perf_counter()
        node_names = plan.node_names
        reused_traces = 0
        for i, (dest, ignore, locs, c, reads1, paths1) in enumerate(jobs):
            ch = changed[i]
            reuse = (
                c is not None
                and ch is not True
                and c["locs"] == locs
                and not (c["reads2"] & flap_dirty)
            )
            if reuse and ch is not None:
                # the row changed, but maybe nowhere this trace looked
                reuse = not any(
                    node_names[j] in c["reads2"]
                    for j in ch.tolist()
                    if j < len(node_names)
                )
            if reuse:
                paths2, reads2 = c["paths2"], c["reads2"]
                reused_traces += 1
            else:
                reads2 = set()
                row = rstate.host_rows[i]

                def dist_of(n, _r=reads2, _row=row, _idx=node_index):
                    _r.add(n)
                    j = _idx.get(n)
                    if j is None:
                        return None
                    v = int(_row[j])
                    return None if v >= INF_E else v

                paths2 = link_state.trace_paths_on_dist(
                    my_node_name, dest, dist_of, ignore
                )
            link_state.prime_kth_paths(my_node_name, dest, 2, paths2)
            new_dests[dest] = {
                "reads1": reads1 if reads1 is not None else (
                    c["reads1"] if c else None
                ),
                "paths1": paths1, "locs": locs,
                "reads2": reads2, "paths2": paths2,
            }
        if not root_overloaded:
            self._ksp2_certs[bkey] = {
                "gen": link_state.generation, "plan": plan,
                "base_np": base_np, "dests": new_dests,
            }
        self._ksp2_timing = dict(
            ksp2_base_ms=(t1 - t0) * 1e3,
            ksp2_k1_ms=(t2 - t1) * 1e3,
            ksp2_batch_ms=(t3 - t2) * 1e3,
            ksp2_trace_ms=(time.perf_counter() - t3) * 1e3,
            ksp2_reused_traces=reused_traces,
            **{f"ksp2_{k}": v for k, v in ksp2_ops.last_stats.items()},
        )

    # -- partition + host routes -----------------------------------------

    def _partition_prefixes(self, prefix_state, area_link_states):
        """-> (fast prefixes grouped by their single announcer area,
        prefixes for the oracle — ineligible attributes or announcers
        spanning areas —, every KSP2 prefix, the KSP2 prefixes grouped by
        their single announcer area for the device prime). Cached per
        (prefix generation, area set)."""
        key = (prefix_state.generation, tuple(sorted(area_link_states)))
        if self._partition is not None and self._partition[0] == key:
            return self._partition[1:]
        fast_by_area: dict[str, list] = {}
        ksp2_by_area: dict[str, list] = {}
        slow, ksp2 = [], []
        for prefix, entries in prefix_state.prefixes().items():
            areas = {a for _, a in entries}
            single = next(iter(areas)) if len(areas) == 1 else None
            if single not in area_link_states:
                single = None
            if _fast_path_eligible(entries):
                if single is not None:
                    fast_by_area.setdefault(single, []).append(prefix)
                else:
                    slow.append(prefix)
            elif _ksp2_eligible(entries):
                ksp2.append(prefix)
                if single is not None:
                    ksp2_by_area.setdefault(single, []).append(prefix)
            else:
                slow.append(prefix)
        self._partition = (key, fast_by_area, slow, ksp2, ksp2_by_area)
        return fast_by_area, slow, ksp2, ksp2_by_area

    def _host_routes(
        self, my_node_name, area_link_states, prefix_state, slow, route_db
    ) -> None:
        """CPU oracle path for irregular prefixes + statics + MPLS."""
        self.cpu.best_routes_cache.clear()
        for prefix in slow:
            route = self.cpu.create_route_for_prefix(
                my_node_name, area_link_states, prefix_state, prefix
            )
            if route is not None:
                route_db.add_unicast_route(route)
        for prefix, entry in self.cpu.static_unicast_routes.items():
            if prefix not in route_db.unicast_routes:
                route_db.add_unicast_route(entry)
        if self.cpu.enable_node_segment_label:
            for entry in self.cpu._node_label_routes(
                my_node_name, area_link_states
            ).values():
                route_db.add_mpls_route(entry)
        if self.cpu.enable_adjacency_labels:
            for entry in self.cpu._adj_label_routes(
                my_node_name, area_link_states
            ):
                route_db.add_mpls_route(entry)
        for entry in self.cpu.static_mpls_routes.values():
            route_db.add_mpls_route(entry)

    # -- whole-fabric RIBs ---------------------------------------------------

    def build_fabric_route_dbs(
        self,
        root_names: list[str],
        area_link_states: dict[str, LinkState],
        prefix_state: PrefixState,
        mesh=None,
    ) -> dict[str, Optional[DecisionRouteDb]]:
        """Every requested vantage's full RIB from ONE whole-fabric step
        on the solver's card (the port of
        ``TpuSpfSolver.build_fabric_route_dbs``): each root's SSSP over
        the area's resident mirror and its best-route selection, with
        LFA when enabled. ``mesh`` (a ``parallel/sharding.Mesh`` or a
        device list) defaults to the solver's card alone, whose step
        reads the resident mirror; a wider one splits the roots (padded
        to a multiple of the batch axis with the first root, as the
        reference pads) over 'batch' and the weight columns over
        'graph'. Either runs ``ops/fabric.fabric_step_grid``.

        Fast-path (IP / SP_ECMP) prefixes compute on the card; the
        oracle answers irregular prefixes, statics and MPLS per vantage,
        as in ``build_route_db``, with KSP2 primed per vantage. The trip
        bound starts at ``2 * last_trips + 1`` (one vantage's measured
        eccentricity bound; another root's can be about twice it) and
        doubles while the convergence vote fails, up to
        ``max_trips(n_cap)``; past it ``Unconverged`` raises. Unknown
        roots map to None; more than one area goes to the oracle. Each
        vantage gets one ColumnarRib, filled from the packed words K3
        emits (``set_full_packed``, the packed twin of the reference's
        ``set_full_arrays``)."""
        from openr_tpu_torch.ops.fabric import (
            fabric_step_grid,
            root_tables,
            row_table,
        )
        from openr_tpu_torch.parallel import sharding

        if mesh is None:
            mesh = sharding.Mesh([[self.device]])
        elif not isinstance(mesh, sharding.Mesh):
            mesh = sharding.make_mesh(devices=list(mesh))
        if len(area_link_states) != 1:
            return {
                r: self.cpu.build_route_db(r, area_link_states, prefix_state)
                for r in root_names
            }
        area, link_state = next(iter(area_link_states.items()))
        t0 = time.perf_counter()
        self._bytes_uploaded = 0
        fast_by_area, slow, ksp2, _ = self._partition_prefixes(
            prefix_state, area_link_states
        )
        fast = fast_by_area.get(area, [])

        result: dict[str, Optional[DecisionRouteDb]] = {}
        known = [r for r in root_names if link_state.has_node(r)]
        for r in root_names:
            if r not in known:
                result[r] = None
        stats: dict = {"roots": len(known)}

        if fast and known:
            ad = self._sync_area(area, link_state, prefix_state, fast)
            plan, matrix = ad.plan, ad.matrix
            b = mesh.shape["batch"]
            padded = known + [known[0]] * (-len(known) % b)
            roots, out_nbr, out_w, links = root_tables(plan, link_state,
                                                      padded)
            lfa = self.cpu.enable_lfa
            block_v4 = not (
                self.cpu.enable_v4 or self.cpu.v4_over_v6_nexthop
            )
            use_v4_allowed = not self.cpu.v4_over_v6_nexthop
            p_cap, a_cap = matrix.ann_node.shape
            if mesh == sharding.Mesh([[self.device]]):
                # the resident mirror, as a one-shard grid
                inputs = dict(
                    zip(("deltas", "shift_w", "res_rows", "res_nbr", "res_w",
                         "mbuf", "roots", "out_nbr", "out_w"),
                        ([[t]] for t in (
                            *ad.single(self.device), ad.mbuf,
                            self._upload(roots), self._upload(out_nbr),
                            self._upload(out_w)))),
                    has_res=plan.k_res > 0, p_cap=p_cap, a_cap=a_cap,
                    # K21's node -> row table, once a build of the plan
                    row_of=[[self._upload(row_table(plan.res_rows,
                                                    plan.n_cap))]])
            else:
                inputs = sharding.fabric_mesh_inputs(
                    mesh, plan, matrix, roots, out_nbr, out_w)
                self._bytes_uploaded += sharding.grid_nbytes(*(
                    v for v in inputs.values() if isinstance(v, list)))

            def step(n_trips, mark):
                return fabric_step_grid(**inputs, n_trips=n_trips, lfa=lfa,
                                        block_v4=block_v4, mark=mark)
            t1 = time.perf_counter()
            n_trips = max(2, 2 * self.last_trips + 1)
            cap_trips = max(4, max_trips(plan.n_cap))
            retries = 0
            probe = torch.empty(0, device=mesh.first)
            while True:
                events, mark = _timing_events(probe, 3)
                out = step(n_trips, mark)
                if out.converged.all():
                    break
                if n_trips >= cap_trips:
                    raise sharding.Unconverged(
                        f"fabric SSSP unconverged for roots "
                        f"{roots[~out.converged].tolist()} at the trip "
                        f"bound ({n_trips})"
                    )
                n_trips = min(2 * n_trips, cap_trips)
                retries += 1
            t2 = time.perf_counter()
            p_n = len(matrix.prefix_list)
            pulled = [out.metric, out.s3w, out.nhw, out.ok]
            if lfa:
                pulled += [out.lfa_slot, out.lfa_metric]
            host = [t[:len(known), :p_n].cpu().numpy() for t in pulled]
            metric, s3w, nhw, ok = host[:4]
            lfa_slot, lfa_metric = host[4:] if lfa else (None, None)
            t3 = time.perf_counter()
            for i, nm in enumerate(known):
                crib = ColumnarRib(
                    nm, matrix, list(links[i]), int(roots[i]),
                    block_v4, use_v4_allowed, lfa,
                )
                rows = np.flatnonzero(ok[i])
                crib.set_full_packed(
                    rows, metric[i][rows], s3w[i][rows], nhw[i][rows],
                    None if lfa_slot is None else lfa_slot[i][rows],
                    None if lfa_metric is None else lfa_metric[i][rows],
                )
                db = DecisionRouteDb()
                # routes stay columnar until a consumer iterates; host
                # routes land in the Lazy's overrides, which shadow the
                # view
                db.unicast_routes = LazyUnicastRoutes({}, [crib.view()])
                result[nm] = db
            t4 = time.perf_counter()
            stats.update({
                "sync_ms": (t1 - t0) * 1e3,
                # host wall of the step: launches, flag reads, retries
                "exec_ms": (t2 - t1) * 1e3,
                "pull_ms": (t3 - t2) * 1e3,
                "rib_ms": (t4 - t3) * 1e3,
                "trips": out.trips, "n_trips": n_trips, "retries": retries,
                "mesh": dict(mesh.shape),
                "bytes_uploaded": float(self._bytes_uploaded),
                "bytes_downloaded": float(sum(a.nbytes for a in host)),
            })
            if events:
                stats["sssp_ms"] = events[0].elapsed_time(events[1])
                stats["tail_ms"] = events[1].elapsed_time(events[2])

        t5 = time.perf_counter()
        for nm in known:
            db = result.get(nm)
            if db is None:
                db = result[nm] = DecisionRouteDb()
            if ksp2:
                # one batched masked-SSSP device pass per vantage instead
                # of one host Dijkstra per (vantage, KSP2 destination)
                self._prime_ksp2(
                    nm, area, link_state, prefix_state, ksp2, fast
                )
            self._host_routes(
                nm, area_link_states, prefix_state, slow + ksp2, db
            )
        stats["host_ms"] = (time.perf_counter() - t5) * 1e3
        stats["fabric_ms"] = (time.perf_counter() - t0) * 1e3
        self.last_fabric_stats = stats
        return result

    # -- device mirror -----------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> a resident int32 tensor on the solver's device
        (always a copy: the host plan arrays keep changing)."""
        self._bytes_uploaded += int(arr.nbytes)
        return torch.tensor(np.ascontiguousarray(arr), dtype=torch.int32,
                            device=self.device)

    def _stage(self, arrays, dev=None) -> list:
        """Host arrays -> int32 tensors on ``dev`` (the solver's device by
        default). On a card: views into one device buffer, sent by ONE
        non-blocking copy from one pinned block of PyTorch's caching host
        allocator (a copy from pinned memory never waits on the stream,
        unlike ``torch.tensor(..., device=)`` from pageable memory). The
        allocators make reuse safe: the host block returns to its pool
        only after the copy's event, the device block only when its
        views are dropped, ordered on the stream as any tensor's. On the
        CPU one ``torch.tensor`` each."""
        dev = self.device if dev is None else torch.device(dev)
        arrs = [np.asarray(a) for a in arrays]
        sizes = [a.size for a in arrs]
        self._bytes_uploaded += 4 * sum(sizes)
        if dev.type != "cuda":
            return [torch.tensor(np.ascontiguousarray(a), dtype=torch.int32,
                                 device=dev) for a in arrs]
        host = torch.empty(sum(sizes), dtype=torch.int32, pin_memory=True)
        words, off = host.numpy(), 0
        for a in arrs:
            words[off:off + a.size] = a.ravel()
            off += a.size
        flat = host.to(dev, non_blocking=True)
        self._staged_copies += 1
        return [v.view(a.shape) for v, a in zip(flat.split(sizes), arrs)]

    def staging_counts(self) -> dict:
        """The host-to-device copies ``_stage`` made on cards since the
        solver was made."""
        return {"copies": self._staged_copies}

    def _put(self, arr: np.ndarray, mesh=None, layout=None):
        """``_upload`` for a one-device area; on the multichip tier's mesh
        the array placed as ``layout`` says (``parallel/sharding.place``:
        one copy a card and part)."""
        if mesh is None:
            return self._upload(arr)
        from openr_tpu_torch.parallel.sharding import place

        out = place(mesh, arr, layout)
        self._bytes_uploaded += out.nbytes()
        return out

    def _scatter_counted(self, *segments) -> list:
        """Scatter each segment ``(d_arr, idx, vals)`` (at most two: a
        sync's shift and residual planes) into its resident tensor in
        place (K5); only the index and value buffers cross to the
        device, both segments in one staged copy, and one ``scatter_set``
        launch takes both. ``Sharded`` arrays on the multichip mesh take
        each entry on the shards that own it, in place (K5 [mc], the
        reference's ``_mc_scatter_jit``): one staged copy a card, then
        one ``scatter_parts`` launch a card and array. -> the arrays."""
        from openr_tpu_torch.parallel.sharding import Sharded, scatter_sharded

        d0 = segments[0][0]
        ref = next(d0.distinct())[2] if isinstance(d0, Sharded) else d0
        ev = None
        if ref.is_cuda:
            stream = torch.cuda.current_stream(ref.device)
            ev = (self._event_pool.pop() if self._event_pool else tuple(
                torch.cuda.Event(enable_timing=True) for _ in range(2)))
            ev[0].record(stream)
        host = [a for _, idx, vals in segments for a in (idx, vals)]
        if isinstance(d0, Sharded):
            bufs: dict = {}

            def on(dev):
                if dev not in bufs:
                    bufs[dev] = self._stage(host, dev)
                return bufs[dev]

            for k, (d_arr, _, _) in enumerate(segments):
                scatter_sharded(d_arr, lambda dev, k=k: on(dev)[2 * k:2 * k + 2])
        else:
            t = self._stage(host, ref.device)
            args = []
            for k, (d_arr, _, _) in enumerate(segments):
                args += [d_arr, t[2 * k], t[2 * k + 1]]
            scatter_set(*args)
        if ev:
            ev[1].record(stream)
            self._scatter_events.append(ev)
        return [d_arr for d_arr, _, _ in segments]

    def _diff_scatter(self, d_arr, old_np: np.ndarray, new_np: np.ndarray,
                      extra_idx=None, mesh=None, layout=None):
        """Reconcile a resident tensor to ``new_np`` by scattering only
        the positions where it differs from ``old_np``, whose content the
        device holds except at ``extra_idx`` (undrained dirty slots,
        always included). More than 25% changed: one whole upload."""
        diff = np.flatnonzero(old_np.ravel() != new_np.ravel())
        if extra_idx:
            diff = np.union1d(diff, np.asarray(extra_idx, np.int64))
        if diff.size == 0:
            return d_arr
        if diff.size * 4 > new_np.size:
            return self._put(new_np, mesh, layout)
        vals = np.ascontiguousarray(new_np.ravel()[diff])
        return self._scatter_counted((d_arr, diff.astype(np.int32), vals))[0]

    def _sync_area(self, area: str, link_state: LinkState,
                   prefix_state: PrefixState, prefixes: list) -> _AreaDev:
        ad = self._area_dev.get(area)
        if ad is None:
            ad = self._area_dev[area] = _AreaDev()
        old_plan = ad.plan
        plan = sync_plan(link_state, old_plan)
        ad.plan = plan
        # the multichip tier: placement is part of the mirror's identity,
        # so a tier flip (a capacity class crossing the threshold either
        # way, or force_single_chip) re-puts the whole mirror under the
        # new placement below, and that branch's journal reset marker
        # makes the incremental solve fall back exactly once
        mesh = self._mc_mesh_for(plan.n_cap)
        if mesh != ad.mc_mesh:
            ad.mc_mesh = mesh
            ad.deltas = None
            self._last_exec_incr = None
        lay = {}
        if mesh is not None:
            from openr_tpu_torch.parallel.sharding import plan_shardings

            lay = plan_shardings(mesh, plan.n_cap, plan.res_rows.shape[0], 0)
            counters.set_counter("decision.solver.multichip.shards",
                                 mesh.size)

        def put(arr, role):
            return self._put(arr, mesh, lay.get(role))

        def diff(d_arr, old_np, new_np, role, extra=None):
            return self._diff_scatter(d_arr, old_np, new_np, extra, mesh,
                                      lay.get(role))

        if plan is not old_plan or ad.deltas is None:
            # a same-capacity rebuild (index renumbering, class reshuffle
            # within the pow2 buckets) keeps the resident tensors and
            # ships only changed slots; the device holds the old plan's
            # content except at its undrained dirty slots, which the
            # diff folds in
            same_caps = (
                old_plan is not None
                and ad.deltas is not None
                and all(
                    getattr(old_plan, f).shape == getattr(plan, f).shape
                    for f in ("deltas", "shift_w", "res_rows", "res_nbr",
                              "res_w")
                )
            )
            if same_caps:
                n_cap_o = old_plan.n_cap
                kr_o = old_plan.res_nbr.shape[1]
                sd = [k * n_cap_o + u for k, u, _, _ in old_plan.dirty_shift]
                rd = [r * kr_o + c for r, c, _, _ in old_plan.dirty_res]
                ad.deltas = diff(ad.deltas, old_plan.deltas, plan.deltas,
                                 "replicated")
                ad.shift_w = diff(ad.shift_w, old_plan.shift_w,
                                  plan.shift_w, "shift_w", sd)
                if old_plan.dirty_res_nbr:
                    # residual slot layout changed without tracked
                    # indices: the residual mirror ships whole
                    ad.res_rows = put(plan.res_rows, "res_rows")
                    ad.res_nbr = put(plan.res_nbr, "res_2d")
                    ad.res_w = put(plan.res_w, "res_2d")
                else:
                    ad.res_rows = diff(ad.res_rows, old_plan.res_rows,
                                       plan.res_rows, "res_rows")
                    ad.res_nbr = diff(ad.res_nbr, old_plan.res_nbr,
                                      plan.res_nbr, "res_2d")
                    ad.res_w = diff(ad.res_w, old_plan.res_w, plan.res_w,
                                    "res_2d", rd)
            else:
                ad.deltas = put(plan.deltas, "replicated")
                ad.shift_w = put(plan.shift_w, "shift_w")
                ad.res_rows = put(plan.res_rows, "res_rows")
                ad.res_nbr = put(plan.res_nbr, "res_2d")
                ad.res_w = put(plan.res_w, "res_2d")
            plan.dirty_shift = []
            plan.dirty_res = []
            plan.dirty_res_nbr = False
            ad.whole = {}
            # the mirror changed without per-slot old values: no older
            # distance plane can be advanced across this epoch
            ad.drain_epoch += 1
            ad.drain_log.append((ad.drain_epoch, None, None))
            # the first churn after a cold build must not pay the edge
            # locator build inside its convergence window
            prewarm_edge_loc(plan)
        else:
            # changelog deltas were applied to the host plan in place:
            # scatter the drained slots into the resident planes and
            # journal their pre-drain values
            ((s_idx, s_val, s_old), (r_idx, r_val, r_old),
             nbr_changed) = drain_dirty(plan)
            if s_idx is not None or r_idx is not None or nbr_changed:
                ad.whole = {}
            # both planes' drained slots: one staged copy, one launch
            segs = [(role, idx, val) for role, idx, val in (
                ("shift_w", s_idx, s_val), ("res_w", r_idx, r_val))
                if idx is not None]
            if segs:
                done = self._scatter_counted(*[
                    (getattr(ad, role), idx, val) for role, idx, val in segs])
                for (role, _, _), arr in zip(segs, done):
                    setattr(ad, role, arr)
            ad.drain_epoch += 1
            if nbr_changed:
                ad.res_rows = put(plan.res_rows, "res_rows")
                ad.res_nbr = put(plan.res_nbr, "res_2d")
                # residual slots moved: journal old values no longer
                # name stable (row, col) edges — reset marker
                ad.drain_log.append((ad.drain_epoch, None, None))
            else:
                s_map = ({} if s_idx is None
                         else dict(zip(s_idx.tolist(), s_old.tolist())))
                r_map = ({} if r_idx is None
                         else dict(zip(r_idx.tolist(), r_old.tolist())))
                ad.drain_log.append((ad.drain_epoch, s_map, r_map))
        # announcer matrix: keyed on prefix churn + node-index stability
        mkey = (prefix_state.generation, plan.index_version)
        if ad.matrix_key != mkey or ad.matrix is None:
            ad.matrix = _memo_prefix_matrix(
                prefix_state, link_state, plan.node_index, area, prefixes
            )
            ad.matrix_key = mkey
            ad.matrix_version += 1
            ad.flags = None  # force re-pack
        if ad.flags is None or not np.array_equal(
            plan.node_overloaded, ad.pack_over
        ):
            flags, mbuf = pack_matrix(ad.matrix, plan.node_overloaded)
            ad.pack_over = plan.node_overloaded.copy()
            if ad.flags is None or not np.array_equal(flags, ad.flags):
                ad.flags = flags
                ad.mbuf = self._upload(mbuf)
        return ad

    def _touch_ksp2_state(self, bkey: tuple) -> None:
        lru = self._ksp2_lru
        lru[bkey] = None
        lru.move_to_end(bkey)
        while len(lru) > self._MAX_KSP2_STATES:
            old, _ = lru.popitem(last=False)
            self._ksp2_rows.pop(old, None)
            self._ksp2_base.pop(old, None)
            self._ksp2_certs.pop(old, None)

    def _touch_foreign_vantage(self, vkey: tuple) -> None:
        lru = self._vantage_lru
        lru[vkey] = None
        lru.move_to_end(vkey)
        while len(lru) > self._MAX_FOREIGN_VANTAGES:
            old, _ = lru.popitem(last=False)
            self._vstates.pop(old, None)

    # -- the fast path -------------------------------------------------------

    def _mc_devices(self) -> list:
        """The devices of the multichip tier's mesh: ``multichip_devices``,
        else every visible card for a CUDA solver (the counterpart of
        ``jax.devices()``), else the solver's one device."""
        if self.multichip_devices is not None:
            return [torch.device(d) for d in self.multichip_devices]
        if self.device.type == "cuda":
            return [torch.device(f"cuda:{i}")
                    for i in range(torch.cuda.device_count())]
        return [self.device]

    def _mc_mesh_for(self, n_cap: int):
        """The ('batch', 'graph') mesh the multichip tier solves an area
        of ``n_cap`` node slots on, or None when the tier stays off (the
        reference's ``_mc_mesh_for`` rungs): ``force_single_chip`` is
        set, the threshold is off or not exceeded, the mesh has fewer
        than two devices, or ``n_cap`` does not split over its graph
        axis."""
        if self.force_single_chip:
            return None
        thr = self.multichip_n_cap_threshold
        if thr <= 0 or n_cap <= thr:
            return None
        if self._mc_mesh is False:
            from openr_tpu_torch.parallel.sharding import make_mesh

            devs = self._mc_devices()
            self._mc_mesh = None if len(devs) < 2 else make_mesh(
                len(devs), batch=self.multichip_batch or None, devices=devs)
        mesh = self._mc_mesh
        if mesh is not None and n_cap % mesh.shape["graph"] != 0:
            return None
        return mesh

    def _prep_vantage(self, my_node_name: str, area: str,
                      link_state: LinkState, prefix_state: PrefixState,
                      prefixes: list) -> dict:
        """Host half of a fast-path solve: mirror sync, out-link
        extraction, vantage-state (re)init, the incremental gate. Returns
        the context ``_dispatch_one`` / ``_dispatch_fused`` consume."""
        t0 = time.perf_counter()
        ad = self._sync_area(area, link_state, prefix_state, prefixes)
        plan, matrix = ad.plan, ad.matrix
        root_idx = plan.node_index[my_node_name]
        root_nbr, root_w, links = plan.out_links(link_state, my_node_name)
        d_cap = root_nbr.shape[0]
        mc = ad.mc_mesh
        if mc is not None:
            # the lane axis splits over 'batch': pad it to a multiple.
            # Pad lanes are inert (INF_E seeds: all-INF rows that never
            # win the ECMP predicate, link-down for LFA, and the RIB
            # unpacks only len(links) next-hop bits)
            from openr_tpu_torch.parallel.sharding import pad_to

            d_pad = -(-d_cap // mc.shape["batch"]) * mc.shape["batch"]
            root_nbr = pad_to(root_nbr, d_pad, -1)
            root_w = pad_to(root_w, d_pad, INF_E)
            d_cap = d_pad
        p_cap, a_cap = matrix.ann_node.shape
        r_cap, kr_cap = plan.res_nbr.shape
        has_res = plan.k_res > 0
        shape_key = (
            plan.n_cap, plan.s_cap, r_cap, kr_cap, has_res, d_cap, p_cap,
            a_cap,
        )
        # next-hop address renumbering invalidates materialized routes
        # without any shape change; a tier flip reinitializes the vantage
        # (prev outputs and planes of one placement never feed the other)
        cache_key = shape_key + (link_state.nh_addr_version, mc)
        vkey = (area, my_node_name)
        if my_node_name != self.my_node_name:
            self._touch_foreign_vantage(vkey)
        vs = self._vstates.get(vkey)
        if vs is None:
            vs = self._vstates[vkey] = _VantageState()
        links_tuple = tuple(links)
        lfa = self.cpu.enable_lfa
        block_v4 = not (self.cpu.enable_v4 or self.cpu.v4_over_v6_nexthop)
        if self.spf_kernel == "bucketed" and plan.delta_exp > 0:
            kernel, delta_exp = "bucketed", plan.delta_exp
        else:
            kernel, delta_exp = "sync", 0
        if (
            vs.shape_key != cache_key
            or vs.matrix_version != ad.matrix_version
            or not vs.valid
            or vs.links_tuple != links_tuple
        ):
            # zero prev outputs: every row reads as changed, and the
            # first pull is the full one
            wa, wd = -(-a_cap // 16), -(-d_cap // 16)
            vs.prev = (
                self._upload(np.zeros(p_cap, np.int32)),
                self._upload(np.zeros((p_cap, wa), np.int32)),
                self._upload(np.zeros((p_cap, wd), np.int32)),
                self._upload(np.zeros(p_cap, np.int32)),
                self._upload(np.zeros(p_cap, np.int32)),
            )
            vs.shape_key = cache_key
            vs.matrix_version = ad.matrix_version
            vs.crib = ColumnarRib(
                my_node_name, matrix, list(links), root_idx,
                block_v4, not self.cpu.v4_over_v6_nexthop, lfa,
            )
            vs.links_tuple = links_tuple
            vs.valid = False
            vs.spare = None
            vs.prev_dist = None
            vs.dist_epoch = -1
            vs.root_sig = None
            vs.init = None
            vs.par = None
        root_sig = (root_nbr.tobytes(), (root_w < INF_E).tobytes())
        scatter_events, self._scatter_events = self._scatter_events, []
        return {
            "area": area, "ad": ad, "plan": plan, "vs": vs,
            "root_idx": root_idx, "root_nbr": root_nbr, "root_w": root_w,
            "fuse_key": (shape_key, lfa, block_v4, kernel, delta_exp),
            "has_res": has_res, "lfa": lfa, "block_v4": block_v4,
            "kernel": kernel, "delta_exp": delta_exp, "mc": mc,
            "d_cap": d_cap, "p_cap": p_cap, "a_cap": a_cap,
            "incr": self._incr_args(ad, vs, root_sig, d_cap),
            "root_sig": root_sig, "dist_epoch": ad.drain_epoch,
            "scatter_events": scatter_events, "t0": t0,
        }

    def _lane_args(self, pv: dict, roots=None) -> tuple:
        """The area's resident mirror and matrix, its root, and the root
        tables on the device (``roots``, or staged here): the first nine
        ``pipeline`` inputs."""
        ad = pv["ad"]
        if roots is None:
            roots = self._stage([pv["root_nbr"], pv["root_w"]])
        return (ad.deltas, ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w,
                ad.mbuf, pv["root_idx"], *roots)

    def _dispatch_one(self, pv: dict) -> dict:
        """Launch one area's pipeline (incremental where the gate
        allowed). With ``streaming_pipeline`` an incremental solve is a
        streaming epoch (the port of ``_dispatch_stream``): its delta
        payload takes the vantage's bucketed budget and carries the
        device route-ok bit. Where the JAX solver donates the previous
        planes, the vantage keeps two plane sets: this epoch's K3 writes
        the spare set while its K4 diff reads ``prev``, and the sets
        swap right after the dispatch. The vantage stays invalid until
        the collect commits, so an abandoned collect costs one full
        rebuild on the next solve, never a RIB that has diverged from
        the resident planes."""
        if pv["mc"] is not None:
            return self._dispatch_mc(pv)
        vs = pv["vs"]
        incr = roots = None
        if pv["incr"] is not None:
            incr, roots = self._incr_tensors(pv)
        sbudget, spare = 0, None
        if incr is not None and self.streaming_pipeline:
            sbudget = int(vs.stream_budget) or STREAM_BUDGETS[0]
            spare = vs.spare
            if spare is None:
                spare = tuple(torch.empty_like(t) for t in vs.prev)
        lane = self._lane_args(pv, roots)
        if incr is not None and vs.init is None:
            ad = pv["ad"]
            vs.init = init_outputs(ad.shift_w, ad.res_rows, ad.res_nbr,
                                   ad.res_w, lane[7], ad.plan.n_cap)
            vs.par = torch.empty_like(vs.prev_dist)
        t1 = time.perf_counter()
        out = pipeline(
            *lane, *vs.prev, has_res=pv["has_res"], block_v4=pv["block_v4"],
            sentinels=self.enable_sentinels, kernel=pv["kernel"],
            delta_exp=pv["delta_exp"], incr=incr,
            emit_dist=self.incremental_spf, lfa=pv["lfa"], stream=sbudget,
            out=spare, init_out=vs.init, par_out=vs.par,
        )
        ctx = {"pv": pv, "out": out, "fused": 0, "stream": sbudget,
               "was_valid": vs.valid,
               "incr_denom": None if incr is None else pv["incr"][1],
               "t1": t1, "t2": time.perf_counter()}
        if sbudget:
            # swap the plane sets: the set this epoch diffed against is
            # the next epoch's spare. The LFA columns pass through
            # without LFA, and then both sets share them, unwritten.
            vs.spare = vs.prev
            vs.prev = (out.metric, out.s3w, out.nhw, out.lfa_slot,
                       out.lfa_metric)
            vs.prev_dist = out.dist
            vs.dist_epoch = pv["dist_epoch"]
            vs.root_sig = pv["root_sig"]
            vs.valid = False
            # the probe's planes are the spare set two epochs on
            self._last_exec_incr = None
        elif incr is not None:
            # the inputs of the last incremental solve, for device-only
            # probes (chip_smoke.py): the lane tensors, the previous
            # outputs and the six incremental inputs
            self._last_exec_incr = (lane, vs.prev, incr)
        else:
            counters.increment("decision.solver.full.solves")
            if self.incremental_spf:
                # a first or ineligible solve, or a host-gate fallback
                # (journal gap, root churn, zero-weight edges, oversized
                # dirty set)
                counters.increment("decision.solver.incr.full_fallbacks")
        return ctx

    def _dispatch_mc(self, pv: dict) -> dict:
        """Launch one area's pipeline on the multichip tier
        (``mc_pipeline``; the port of ``_dispatch_one``'s mesh branch):
        cold, or incremental where the gate allowed, never streaming."""
        vs, ad, plan = pv["vs"], pv["ad"], pv["plan"]
        incr = None
        if pv["incr"] is not None:
            (sdi, sdo, rdi, rdo, cone_limit), _ = pv["incr"]
            incr = (vs.prev_dist, sdi, sdo, rdi, rdo, cone_limit)
        counters.increment("decision.solver.multichip.dispatches")
        self._last_exec_incr = None
        t1 = time.perf_counter()
        mirror = {k: getattr(ad, k) for k in (
            "deltas", "shift_w", "res_rows", "res_nbr", "res_w")}
        out, info = mc_pipeline(
            pv["mc"], mirror, ad.mbuf, pv["root_idx"], pv["root_nbr"],
            pv["root_w"], *vs.prev, has_res=pv["has_res"], n_cap=plan.n_cap,
            s_cap=plan.s_cap, block_v4=pv["block_v4"],
            sentinels=self.enable_sentinels, kernel=pv["kernel"],
            delta_exp=pv["delta_exp"], incr=incr, lfa=pv["lfa"],
        )
        self._bytes_uploaded += info.bytes_uploaded
        if incr is None:
            counters.increment("decision.solver.full.solves")
            if self.incremental_spf:
                counters.increment("decision.solver.incr.full_fallbacks")
        return {"pv": pv, "out": out, "fused": 0, "stream": 0,
                "was_valid": vs.valid,
                "incr_denom": None if incr is None else pv["incr"][1],
                "t1": t1, "t2": time.perf_counter(), "mc": info}

    def _incr_tensors(self, pv: dict) -> tuple:
        """-> (the incremental solve's six inputs: the vantage's distance
        plane, the dirty tuples on the device, the cone budget; the root
        tables on the device). The four dirty arrays and the two root
        tables cross in one staged copy (``_stage``)."""
        (sd_idx, sd_old, rd_idx, rd_old, cone_limit), _ = pv["incr"]
        t = self._stage([sd_idx, sd_old, rd_idx, rd_old, pv["root_nbr"],
                         pv["root_w"]])
        return (pv["vs"].prev_dist, *t[:4], cone_limit), tuple(t[4:])

    def _dispatch_fused(self, group: list) -> list:
        """ONE fused dispatch for a group of same-shape areas: the cold
        pipeline with a leading area axis (``fused_pipeline``), whatever
        the incremental gate said — as the JAX group dispatch."""
        g = len(group)
        pv0 = group[0]
        lanes = [self._lane_args(pv) + pv["vs"].prev for pv in group]
        self._bytes_uploaded += 4 * g  # the roots
        t1 = time.perf_counter()
        outs = fused_pipeline(
            lanes, has_res=pv0["has_res"], block_v4=pv0["block_v4"],
            sentinels=self.enable_sentinels, kernel=pv0["kernel"],
            delta_exp=pv0["delta_exp"], lfa=pv0["lfa"],
        )
        t2 = time.perf_counter()
        counters.increment("decision.device.fused_dispatches")
        counters.increment("decision.device.fused_areas", g)
        counters.increment("decision.solver.full.solves", g)
        return [{"pv": pv, "out": out, "fused": g, "stream": 0,
                 "was_valid": pv["vs"].valid, "incr_denom": None,
                 "t1": t1, "t2": t2} for pv, out in zip(group, outs)]

    def _incr_args(self, ad: _AreaDev, vs: _VantageState, root_sig: tuple,
                   d_cap: int):
        """The incremental gate: a resident distance plane whose epoch
        window the drain journal covers, an unchanged root out-link
        signature, no zero-weight edges and a dirty set that fits a
        bucket. -> ((s_dirty_idx, s_dirty_old, r_dirty_idx, r_dirty_old,
        cone_limit) host arrays, cone denominator) or None (cold
        solve)."""
        plan = ad.plan
        if not (
            self.incremental_spf
            and vs.valid
            and vs.prev_dist is not None
            and vs.root_sig == root_sig
            and not plan.has_zero_w
        ):
            return None
        merged = _merge_drain_log(ad, vs.dist_epoch)
        if merged is None:
            return None
        s_map, r_map = merged
        cap = _dirty_bucket(max(len(s_map), len(r_map), 1))
        if cap is None:
            return None
        r_cap, kr_cap = plan.res_nbr.shape
        # pads are out-of-range flat indices: they drop
        sd_idx = np.full(cap, plan.s_cap * plan.n_cap, np.int32)
        sd_old = np.zeros(cap, np.int32)
        sd_idx[:len(s_map)] = list(s_map.keys())
        sd_old[:len(s_map)] = list(s_map.values())
        rd_idx = np.full(cap, r_cap * kr_cap, np.int32)
        rd_old = np.zeros(cap, np.int32)
        rd_idx[:len(r_map)] = list(r_map.keys())
        rd_old[:len(r_map)] = list(r_map.values())
        denom = d_cap * plan.n_nodes
        cone_limit = int(np.int32(self.incremental_cone_frac * denom))
        return (sd_idx, sd_old, rd_idx, rd_old, cone_limit), denom

    def _collect_area(self, ctx: dict):
        """Pull the one buffer this solve consumes and patch the
        vantage's ColumnarRib. prev advances here, atomically with the
        patch, so an aborted solve is never treated as applied."""
        pv, out = ctx["pv"], ctx["out"]
        vs = pv["vs"]
        d_cap, p_cap, a_cap = pv["d_cap"], pv["p_cap"], pv["a_cap"]
        lfa = pv["lfa"]
        wa, wd = -(-a_cap // 16), -(-d_cap // 16)
        stream = ctx["stream"]
        b = stream or DELTA_BUDGET
        t2 = ctx["t2"]
        was_valid = ctx["was_valid"]
        dbuf = fbuf = None
        count = None
        if was_valid:
            dbuf = out.delta_buf.cpu().numpy()  # ONE pull
            count = int(dbuf[0])
        t3 = time.perf_counter()
        full_pull = count is None or count > b
        crib = vs.crib
        if full_pull:
            fbuf = out.full_buf.cpu().numpy()
            t3 = time.perf_counter()
            okc = int(fbuf[0])
            o = 2
            oidx = fbuf[o:o + p_cap]; o += p_cap
            metric = fbuf[o:o + p_cap]; o += p_cap
            s3w = fbuf[o:o + p_cap * wa].reshape(p_cap, wa); o += p_cap * wa
            nhw = fbuf[o:o + p_cap * wd].reshape(p_cap, wd); o += p_cap * wd
            lfa_slot = lfa_metric = None
            if lfa:
                lfa_slot = fbuf[o:o + p_cap][:okc]; o += p_cap
                lfa_metric = fbuf[o:o + p_cap][:okc]
            crib.set_full_packed(
                oidx[:okc], metric[:okc], s3w[:okc], nhw[:okc], lfa_slot,
                lfa_metric,
            )
            vs.valid = True
        elif count:
            o = 2
            cidx = dbuf[o:o + b]; o += b
            metric = dbuf[o:o + b]; o += b
            s3w = dbuf[o:o + b * wa].reshape(b, wa); o += b * wa
            nhw = dbuf[o:o + b * wd].reshape(b, wd); o += b * wd
            live = cidx < p_cap
            if stream:
                okb = dbuf[o:o + b][live][:count].astype(bool); o += b
            lfa_slot = lfa_metric = None
            if lfa:
                lfa_slot = dbuf[o:o + b][live][:count]; o += b
                lfa_metric = dbuf[o:o + b][live][:count]
            rows = (cidx[live][:count], metric[live][:count],
                    s3w[live][:count], nhw[live][:count])
            if stream:
                # the device route-ok bit rides the payload: no unpack
                crib.apply_rows_packed(*rows, okb, lfa_slot, lfa_metric)
            else:
                crib.apply_rows(*rows, lfa_slot, lfa_metric)
        if stream:
            # the planes swapped at dispatch; the patch above committed,
            # so the resident planes and the RIB agree again
            vs.valid = True
        else:
            vs.prev = (out.metric, out.s3w, out.nhw, out.lfa_slot,
                       out.lfa_metric)
        if out.dist is not None and not stream:
            # the next solve's warm seed, stamped with the drain epoch
            # and root signature it was computed under
            vs.prev_dist = out.dist
            vs.dist_epoch = pv["dist_epoch"]
            vs.root_sig = pv["root_sig"]
        sbuf = fbuf if full_pull else dbuf
        stats = {
            # both ride the buffer: [1] trips, [-1] rounds
            "trips": int(sbuf[1]),
            "rounds": int(sbuf[-1]),
            "spf_kernel": pv["kernel"],
            "bucket_epochs": (int(sbuf[1]) if pv["kernel"] == "bucketed"
                              else 0),
            "changed_rows": count,
            "full_pull": full_pull,
            "fused": ctx["fused"],
            "bytes_downloaded": (0 if dbuf is None else int(dbuf.nbytes))
            + (0 if fbuf is None else int(fbuf.nbytes)),
        }
        info = ctx.get("mc")
        if info is not None:
            # each combine of a group is one halo exchange: one a
            # relaxation under sync (rounds), one an epoch under bucketed
            stats["halo_exchanges"] = info.halo_exchanges
            stats["multichip"] = {
                "shards": info.shards, "batch": info.batch,
                "graph": info.graph,
                "shard_ms": info.shard_ms(),
            }
        if stream:
            stats["stream"] = {"budget": b, "overflow": full_pull}
            # the next epoch's bucket follows this one's churn
            vs.stream_budget = stream_budget(count or 0) or STREAM_BUDGETS[-1]
            counters.increment("decision.stream.epochs")
            counters.add_stat_value("decision.stream.changed_rows",
                                    count or 0)
            counters.add_stat_value("decision.stream.bytes_downloaded",
                                    stats["bytes_downloaded"])
            if full_pull:
                counters.increment("decision.stream.overflows")
        # the tail, back to front: [-1] rounds; after an incremental
        # solve [-3] cone and [-2] fell_back; the sentinels before those
        denom = ctx["incr_denom"]
        if denom is not None:
            cone, fell_back = int(sbuf[-3]), bool(sbuf[-2])
            stats.update(incremental=True, cone=cone, fell_back=fell_back,
                         cone_trips=int(out.cone_trips))
            counters.increment(
                "decision.solver.incr.full_fallbacks" if fell_back
                else "decision.solver.incr.solves"
            )
            counters.add_stat_value("decision.solver.incr.cone_frac",
                                    cone / max(denom, 1))
            counters.add_stat_value("decision.solver.incr.changed_rows",
                                    count or 0)
        if self.enable_sentinels:
            off = -3 if denom is not None else -1
            stats["sentinels"] = {
                "unreachable_rows": int(sbuf[off - 2]),
                "saturated_rows": int(sbuf[off - 1]),
            }
        t4 = time.perf_counter()
        timing = {
            "sync_ms": (ctx["t1"] - pv["t0"]) * 1e3,
            # host wall of the launches, the flag reads of the round
            # loops included (a fused group's launches count once for
            # each of its areas)
            "exec_ms": (t2 - ctx["t1"]) * 1e3,
            "pull_ms": (t3 - t2) * 1e3,
            "unpack_ms": (t4 - t3) * 1e3,
            "sssp_ms": None, "tail_ms": None, "compact_ms": None,
        }
        if out.events:
            ev = out.events
            phases = ("sssp_ms", "tail_ms", "compact_ms")
            if len(ev) == 7:
                phases = ("old_planes_ms", "parent_ms", "cone_ms") + phases
            for i, key in enumerate(phases):
                timing[key] = ev[i].elapsed_time(ev[i + 1])
            timing["scatter_ms"] = sum(
                a.elapsed_time(b) for a, b in pv["scatter_events"]
            )
            self._event_pool.extend(pv["scatter_events"])
        return crib.view(), timing, stats
