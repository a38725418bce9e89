"""GPU route-computation backend: the single-area Decision solve, cold
and incremental.

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
     selection, next-hop masks, 16-bit word packing, route-ok filter.
  3. ``ops/compact.compact_outputs`` (K4): the changed-rows delta
     payload against the vantage's previous resident outputs and the
     ok-rows full payload, sentinel counts in both tails.

The host pulls ONE buffer — the full payload on a vantage's first solve
(or after its matrix / shape changed), the delta payload after — and
patches the vantage's ColumnarRib, whose lazy view becomes the RIB's
unicast routes. Everything else (cross-area or non-fast-path prefixes,
static routes, MPLS label routes) goes through the oracle, as in the
JAX solver. Changelog churn reaches the resident weight planes as a
K5 scatter of the drained dirty slots, journalled per drain epoch so a
vantage's previous plane can be advanced across several drains. Not
ported yet, and refused rather than approximated: LFA backup next hops
(``enable_lfa``) and areas above ``multichip_n_cap_threshold``. The
fused-area and streaming solves of the JAX solver are not ported
either.

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
from openr_tpu_torch.decision.link_state import LinkState
from openr_tpu_torch.decision.prefix_state import PrefixState
from openr_tpu_torch.decision.rib import DecisionRouteDb
from openr_tpu_torch.decision.spf_solver import SpfSolver
from openr_tpu_torch.ops.compact import compact_outputs
from openr_tpu_torch.ops.csr import PrefixMatrix, build_prefix_matrix
from openr_tpu_torch.ops.edgeplan import (
    drain_dirty,
    prewarm_edge_loc,
    sync_plan,
)
from openr_tpu_torch.ops.incremental import incremental_sssp, scatter_set
from openr_tpu_torch.ops.relax import INF_E, max_trips, plan_sssp
from openr_tpu_torch.ops.select import select_routes
from openr_tpu_torch.runtime.counters import counters
from openr_tpu_torch.types import PrefixForwardingAlgorithm, PrefixForwardingType

# rows shipped per delta pull; more changed rows fall back to the full
# pull (the host reads the count first)
DELTA_BUDGET = 4096

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


def _pack_matrix(matrix: PrefixMatrix, node_over: np.ndarray) -> tuple:
    """(flags [P,A], mbuf int32 [6*P*A]) — validity, per-announcer drain
    and the per-prefix v4 bit (flag bit 2, announcer slot 0) fold into
    flag bits host-side; min_nexthop ships so the device can run the
    route-level ok filter."""
    idx = np.clip(matrix.ann_node, 0, None)
    flags = matrix.ann_valid.astype(np.int32) | (
        node_over[idx].astype(np.int32) << 1
    )
    if flags.shape[1]:
        flags[:, 0] |= matrix.is_v4.astype(np.int32) << 2
    mbuf = matrix._mbuf
    if mbuf is None:
        mbuf = matrix._mbuf = np.concatenate([
            matrix.ann_node.ravel(),
            flags.ravel(),
            matrix.path_pref.ravel(),
            matrix.source_pref.ravel(),
            matrix.dist_adv.ravel(),
            matrix.min_nexthop.ravel(),
        ]).astype(np.int32, copy=False)
    else:
        # only the flags plane depends on node_over; the upload copies,
        # so patching the host buffer in place is safe
        pa = flags.size
        mbuf[pa:2 * pa] = flags.ravel()
    return flags, mbuf


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


class PipelineOut(NamedTuple):
    delta_buf: torch.Tensor
    full_buf: torch.Tensor
    metric: torch.Tensor
    s3w: torch.Tensor
    nhw: torch.Tensor
    trips: int
    rounds: int
    # CUDA events on a CUDA device, None on the CPU: [start, SSSP done,
    # selection done, compaction done] for a cold solve; [start, old
    # planes done, parent plane done, seed plane done, SSSP done,
    # selection done, compaction done] for an incremental one
    events: Optional[list]
    # the [D, n_cap] distance plane (the next incremental solve's seed)
    # with emit_dist or incr, else None
    dist: Optional[torch.Tensor] = None
    # trips of the incremental solve's cone spread (0 for a cold solve)
    cone_trips: int = 0


def pipeline(deltas, shift_w, res_rows, res_nbr, res_w, mbuf, root: int,
             root_nbr, root_w, prev_metric, prev_s3w, prev_nhw, *,
             has_res: bool, block_v4: bool = False, sentinels: bool = True,
             kernel: str = "sync", delta_exp: int = 0,
             budget: int = DELTA_BUDGET, incr=None,
             emit_dist: bool = False) -> PipelineOut:
    """One solve for one (area, vantage) on the device of its tensors.
    Inputs are the resident mirror (deltas [s_cap], shift_w [s_cap,
    n_cap], the residual ELL res_rows [r_cap] / res_nbr, res_w [r_cap,
    kr_cap]), the packed announcer matrix mbuf [6*P*A], the root's index
    and out-slot tables root_nbr / root_w [D], and the previous solve's
    outputs prev_metric [P], prev_s3w [P, ceil(A/16)], prev_nhw [P,
    ceil(D/16)] (zeros before the first). All int32.

    ``incr``, when given, is the incremental solve's ``(prev_dist [D,
    n_cap], s_dirty_idx, s_dirty_old, r_dirty_idx, r_dirty_old,
    cone_limit)`` (the JAX ``_incr_pipeline``'s six trailing inputs):
    the SSSP starts from the previous plane, and (cone, fell_back) join
    both buffers' tails. The distance plane is returned in ``dist``
    with ``incr`` or ``emit_dist``."""
    p_cap = prev_metric.shape[0]
    a_cap = mbuf.numel() // (6 * p_cap)
    events = None
    if shift_w.is_cuda:
        n_ev = 4 if incr is None else 7
        events = [torch.cuda.Event(enable_timing=True) for _ in range(n_ev)]
    pending = iter(events or ())

    def mark():
        ev = next(pending, None)
        if ev is not None:
            ev.record()

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
        )
        incr_tail = (cone, fell_back)
    mark()
    metric, s3w, nhw, ok = select_routes(
        dist_d, root_w, root, mbuf, p_cap, a_cap, block_v4
    )
    mark()
    flags = mbuf[p_cap * a_cap:2 * p_cap * a_cap].view(p_cap, a_cap)
    delta_buf, full_buf = compact_outputs(
        metric, s3w, nhw, ok, prev_metric, prev_s3w, prev_nhw, flags,
        trips, rounds, budget, sentinels, incr_tail,
    )
    mark()
    keep = incr is not None or emit_dist
    return PipelineOut(delta_buf, full_buf, metric, s3w, nhw, trips, rounds,
                       events, dist_d if keep else None,
                       spread["cone_trips"])


class _AreaDev:
    """Per-area resident device state: plan tensors + announcer matrix."""

    __slots__ = (
        "plan", "deltas", "shift_w", "res_rows", "res_nbr", "res_w",
        "matrix_key", "matrix", "flags", "mbuf", "matrix_version",
        "pack_over", "drain_epoch", "drain_log",
    )

    def __init__(self):
        self.plan = None
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


class _VantageState:
    """Per-(area, vantage) output state: the previous solve's resident
    outputs + the columnar RIB the host patches from pulls."""

    __slots__ = ("shape_key", "matrix_version", "prev", "crib",
                 "links_tuple", "valid", "prev_dist", "dist_epoch",
                 "root_sig")

    def __init__(self):
        self.shape_key = None
        self.matrix_version = -1
        self.prev = None  # (metric, s3w, nhw) device tensors
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


class _PendingBuild:
    """A solve between dispatch_route_db (LSDB reads + device work) and
    collect_route_db (the buffer pulls + RIB patch)."""

    __slots__ = ("route_db", "areas", "t_pipe0", "bytes_uploaded")

    def __init__(self, route_db, areas, t_pipe0, bytes_uploaded):
        self.route_db = route_db
        self.areas = areas
        self.t_pipe0 = t_pipe0
        self.bytes_uploaded = bytes_uploaded


class GpuSpfSolver:
    """Drop-in for SpfSolver.build_route_db with the hot path on the
    GPU. Differentially tested against the CPU oracle and, input for
    input, against the JAX package's pipeline."""

    _MAX_FOREIGN_VANTAGES = 4

    def __init__(
        self, my_node_name: str, device="cuda",
        enable_numerical_sentinels: bool = True,
        incremental_spf: bool = False,
        incremental_cone_frac: float = 0.25,
        spf_kernel: str = "bucketed",
        multichip_n_cap_threshold: int = 131072,
        **solver_kwargs,
    ):
        self.device = resolve_device(device)
        if spf_kernel not in ("sync", "bucketed"):
            raise ValueError(f"unknown spf_kernel {spf_kernel!r}")
        self.my_node_name = my_node_name
        # "bucketed" runs Δ-stepping wherever the plan derived a usable
        # Δ (plan.delta_exp > 0) and the sync rounds otherwise; "sync"
        # forces the sync rounds everywhere
        self.spf_kernel = spf_kernel
        self.enable_sentinels = enable_numerical_sentinels
        # incremental SSSP: seed each eligible solve from the vantage's
        # previous distance plane and re-anchor only the affected cone;
        # the result is bit-identical to the cold solve. The cold solve
        # runs on a first solve, shape / root churn, a journal gap,
        # zero-weight edges, an oversized dirty set, and — decided on
        # the device — when the cone exceeds incremental_cone_frac of
        # the area's node-lanes.
        self.incremental_spf = bool(incremental_spf)
        self.incremental_cone_frac = float(incremental_cone_frac)
        self.multichip_n_cap_threshold = int(multichip_n_cap_threshold)
        self.cpu = SpfSolver(my_node_name, **solver_kwargs)
        if self.cpu.enable_lfa:
            raise NotImplementedError(
                "LFA backup next hops are not ported to the GPU solver yet"
            )
        self._area_dev: dict[str, _AreaDev] = {}
        self._vstates: dict[tuple, _VantageState] = {}
        self._vantage_lru: OrderedDict[tuple, None] = OrderedDict()
        self._partition = None  # ((generation, areas), fast_by_area, slow)
        self._bytes_uploaded = 0
        # CUDA event pairs around the dirty-weight scatters of this solve
        self._scatter_events: list = []
        self._last_exec_incr = None
        # numerical-health sentinels of the last solve, summed over areas
        self.last_sentinels: dict = {}
        # the last area's solve statistics (incremental, cone,
        # fell_back, changed_rows, trips, rounds, ...)
        self.last_device_stats: dict = {}
        # wall-time and device-time breakdown of the last solve
        self.last_timing: dict = {}

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
        fast_by_area, slow = self._partition_prefixes(
            prefix_state, area_link_states
        )
        route_db = DecisionRouteDb()
        areas = []
        for area, plist in fast_by_area.items():
            link_state = area_link_states[area]
            if not link_state.has_node(my_node_name):
                continue  # unreachable area for this vantage: no routes
            areas.append(self._dispatch_area(
                my_node_name, area, link_state, prefix_state, plist
            ))
        self._host_routes(
            my_node_name, area_link_states, prefix_state, slow, route_db
        )
        return _PendingBuild(route_db, areas, t_pipe0, self._bytes_uploaded)

    def collect_route_db(
        self, pending: Optional[_PendingBuild]
    ) -> Optional[DecisionRouteDb]:
        """Phase 2: pull each area's buffer, patch its ColumnarRib and
        assemble the timing breakdown."""
        if pending is None:
            return None
        route_db = pending.route_db
        if not pending.areas:
            return route_db
        views = []
        totals: dict[str, float] = {}
        area_timing = {}
        trips = rounds = 0
        bytes_dl = 0
        kernels = set()
        for ctx in pending.areas:
            view, timing, stats = self._collect_area(ctx)
            views.append(view)
            area_timing[ctx["area"]] = timing
            for k, v in timing.items():
                if v is not None:
                    totals[k] = totals.get(k, 0.0) + v
            trips += stats["trips"]
            rounds += stats["rounds"]
            bytes_dl += stats["bytes_downloaded"]
            kernels.add(stats["spf_kernel"])
            self.last_device_stats = stats
            for sk, sv in stats.get("sentinels", {}).items():
                self.last_sentinels[sk] = self.last_sentinels.get(sk, 0) + sv
        # device routes shadow host/static entries for the same prefix
        route_db.unicast_routes = LazyUnicastRoutes(
            route_db.unicast_routes, views
        )
        counters.add_stat_value("decision.device.rounds", rounds)
        self.last_timing = {
            **totals,
            "pipeline_wall_ms": (time.perf_counter() - pending.t_pipe0) * 1e3,
            "areas": area_timing,
            "trips": trips,
            "rounds": rounds,
            "spf_kernel": "bucketed" if "bucketed" in kernels else "sync",
            "bytes_uploaded": float(pending.bytes_uploaded),
            "bytes_downloaded": float(bytes_dl),
        }
        return route_db

    # -- partition + host routes -----------------------------------------

    def _partition_prefixes(self, prefix_state, area_link_states):
        """-> (fast prefixes grouped by their single announcer area,
        prefixes for the oracle). Cached per (generation, area set)."""
        key = (prefix_state.generation, tuple(sorted(area_link_states)))
        if self._partition is not None and self._partition[0] == key:
            return self._partition[1:]
        fast_by_area: dict[str, list] = {}
        slow = []
        for prefix, entries in prefix_state.prefixes().items():
            areas = {a for _, a in entries}
            single = next(iter(areas)) if len(areas) == 1 else None
            if (
                single in area_link_states
                and _fast_path_eligible(entries)
            ):
                fast_by_area.setdefault(single, []).append(prefix)
            else:
                slow.append(prefix)
        self._partition = (key, fast_by_area, slow)
        return fast_by_area, slow

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

    # -- device mirror -----------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> a resident int32 tensor on the solver's device
        (always a copy: the host plan arrays keep changing)."""
        self._bytes_uploaded += int(arr.nbytes)
        return torch.tensor(np.ascontiguousarray(arr), dtype=torch.int32,
                            device=self.device)

    def _scatter_counted(self, d_arr: torch.Tensor, idx: np.ndarray,
                         vals: np.ndarray) -> torch.Tensor:
        """Scatter (idx, vals) into the resident tensor in place (K5);
        only the index and value buffers cross to the device."""
        idx_t, vals_t = self._upload(idx), self._upload(vals)
        ev = None
        if d_arr.is_cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        scatter_set(d_arr, idx_t, vals_t)
        if ev:
            ev[1].record()
            self._scatter_events.append(ev)
        return d_arr

    def _diff_scatter(self, d_arr: torch.Tensor, old_np: np.ndarray,
                      new_np: np.ndarray, extra_idx=None) -> torch.Tensor:
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
            return self._upload(new_np)
        vals = np.ascontiguousarray(new_np.ravel()[diff])
        return self._scatter_counted(d_arr, diff.astype(np.int32), vals)

    def _sync_area(self, area: str, link_state: LinkState,
                   prefix_state: PrefixState, prefixes: list) -> _AreaDev:
        ad = self._area_dev.get(area)
        if ad is None:
            ad = self._area_dev[area] = _AreaDev()
        old_plan = ad.plan
        plan = sync_plan(link_state, old_plan)
        ad.plan = plan
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
                ad.deltas = self._diff_scatter(
                    ad.deltas, old_plan.deltas, plan.deltas
                )
                ad.shift_w = self._diff_scatter(
                    ad.shift_w, old_plan.shift_w, plan.shift_w, sd
                )
                if old_plan.dirty_res_nbr:
                    # residual slot layout changed without tracked
                    # indices: the residual mirror ships whole
                    ad.res_rows = self._upload(plan.res_rows)
                    ad.res_nbr = self._upload(plan.res_nbr)
                    ad.res_w = self._upload(plan.res_w)
                else:
                    ad.res_rows = self._diff_scatter(
                        ad.res_rows, old_plan.res_rows, plan.res_rows
                    )
                    ad.res_nbr = self._diff_scatter(
                        ad.res_nbr, old_plan.res_nbr, plan.res_nbr
                    )
                    ad.res_w = self._diff_scatter(
                        ad.res_w, old_plan.res_w, plan.res_w, rd
                    )
            else:
                ad.deltas = self._upload(plan.deltas)
                ad.shift_w = self._upload(plan.shift_w)
                ad.res_rows = self._upload(plan.res_rows)
                ad.res_nbr = self._upload(plan.res_nbr)
                ad.res_w = self._upload(plan.res_w)
            plan.dirty_shift = []
            plan.dirty_res = []
            plan.dirty_res_nbr = False
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
            if s_idx is not None:
                ad.shift_w = self._scatter_counted(ad.shift_w, s_idx, s_val)
            if r_idx is not None:
                ad.res_w = self._scatter_counted(ad.res_w, r_idx, r_val)
            ad.drain_epoch += 1
            if nbr_changed:
                ad.res_rows = self._upload(plan.res_rows)
                ad.res_nbr = self._upload(plan.res_nbr)
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
            ad.matrix = build_prefix_matrix(
                prefix_state, plan.node_index, area, prefixes
            )
            ad.matrix_key = mkey
            ad.matrix_version += 1
            ad.flags = None  # force re-pack
        if ad.flags is None or not np.array_equal(
            plan.node_overloaded, ad.pack_over
        ):
            flags, mbuf = _pack_matrix(ad.matrix, plan.node_overloaded)
            ad.pack_over = plan.node_overloaded.copy()
            if ad.flags is None or not np.array_equal(flags, ad.flags):
                ad.flags = flags
                ad.mbuf = self._upload(mbuf)
        return ad

    def _touch_foreign_vantage(self, vkey: tuple) -> None:
        lru = self._vantage_lru
        lru[vkey] = None
        lru.move_to_end(vkey)
        while len(lru) > self._MAX_FOREIGN_VANTAGES:
            old, _ = lru.popitem(last=False)
            self._vstates.pop(old, None)

    # -- the fast path -------------------------------------------------------

    def _dispatch_area(self, my_node_name: str, area: str,
                       link_state: LinkState, prefix_state: PrefixState,
                       prefixes: list) -> dict:
        t0 = time.perf_counter()
        ad = self._sync_area(area, link_state, prefix_state, prefixes)
        plan, matrix = ad.plan, ad.matrix
        if plan.n_cap > self.multichip_n_cap_threshold:
            raise NotImplementedError(
                f"area {area!r}: n_cap {plan.n_cap} exceeds the one-card "
                f"threshold {self.multichip_n_cap_threshold}; the multichip "
                "tier is not ported to the GPU solver yet"
            )
        root_idx = plan.node_index[my_node_name]
        root_nbr, root_w, links = plan.out_links(link_state, my_node_name)
        d_cap = root_nbr.shape[0]
        p_cap, a_cap = matrix.ann_node.shape
        r_cap, kr_cap = plan.res_nbr.shape
        has_res = plan.k_res > 0
        shape_key = (
            plan.n_cap, plan.s_cap, r_cap, kr_cap, has_res, d_cap, p_cap,
            a_cap,
        )
        # next-hop address renumbering invalidates materialized routes
        # without any shape change
        cache_key = shape_key + (link_state.nh_addr_version,)
        vkey = (area, my_node_name)
        if my_node_name != self.my_node_name:
            self._touch_foreign_vantage(vkey)
        vs = self._vstates.get(vkey)
        if vs is None:
            vs = self._vstates[vkey] = _VantageState()
        links_tuple = tuple(links)
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
            )
            vs.shape_key = cache_key
            vs.matrix_version = ad.matrix_version
            vs.crib = ColumnarRib(
                my_node_name, matrix, list(links), root_idx,
                block_v4, not self.cpu.v4_over_v6_nexthop, False,
            )
            vs.links_tuple = links_tuple
            vs.valid = False
            vs.prev_dist = None
            vs.dist_epoch = -1
            vs.root_sig = None
        root_sig = (root_nbr.tobytes(), (root_w < INF_E).tobytes())
        incr = self._incr_args(ad, vs, root_sig, d_cap)
        root_nbr_t = self._upload(root_nbr)
        root_w_t = self._upload(root_w)
        scatter_events, self._scatter_events = self._scatter_events, []
        t1 = time.perf_counter()
        out = pipeline(
            ad.deltas, ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w,
            ad.mbuf, root_idx, root_nbr_t, root_w_t, *vs.prev,
            has_res=has_res, block_v4=block_v4,
            sentinels=self.enable_sentinels, kernel=kernel,
            delta_exp=delta_exp, incr=None if incr is None else incr[0],
            emit_dist=self.incremental_spf,
        )
        if incr is not None:
            # the inputs of the last incremental solve, for device-only
            # probes (chip_smoke.py): the lane tensors, the previous
            # outputs and the six incremental inputs
            self._last_exec_incr = (
                (ad.deltas, ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w,
                 ad.mbuf, root_idx, root_nbr_t, root_w_t),
                vs.prev, incr[0],
            )
        if incr is None:
            counters.increment("decision.solver.full.solves")
            if self.incremental_spf:
                # a first or ineligible solve, or a host-gate fallback
                # (journal gap, root churn, zero-weight edges, oversized
                # dirty set)
                counters.increment("decision.solver.incr.full_fallbacks")
        return {
            "area": area, "vs": vs, "out": out, "kernel": kernel,
            "d_cap": d_cap, "p_cap": p_cap, "a_cap": a_cap,
            "incr_denom": None if incr is None else incr[1],
            "root_sig": root_sig, "dist_epoch": ad.drain_epoch,
            "scatter_events": scatter_events,
            "t0": t0, "t1": t1, "t2": time.perf_counter(),
        }

    def _incr_args(self, ad: _AreaDev, vs: _VantageState, root_sig: tuple,
                   d_cap: int):
        """The incremental gate: a resident distance plane whose epoch
        window the drain journal covers, an unchanged root out-link
        signature, no zero-weight edges and a dirty set that fits a
        bucket. -> ((prev_dist, s_dirty_idx, s_dirty_old, r_dirty_idx,
        r_dirty_old, cone_limit), cone denominator) or None (cold
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
        args = (vs.prev_dist, self._upload(sd_idx), self._upload(sd_old),
                self._upload(rd_idx), self._upload(rd_old), cone_limit)
        return args, denom

    def _collect_area(self, ctx: dict):
        """Pull the one buffer this solve consumes and patch the
        vantage's ColumnarRib. prev advances here, atomically with the
        patch, so an aborted solve is never treated as applied."""
        vs, out = ctx["vs"], ctx["out"]
        d_cap, p_cap, a_cap = ctx["d_cap"], ctx["p_cap"], ctx["a_cap"]
        wa, wd = -(-a_cap // 16), -(-d_cap // 16)
        b = DELTA_BUDGET
        t2 = ctx["t2"]
        was_valid = vs.valid
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
            nhw = fbuf[o:o + p_cap * wd].reshape(p_cap, wd)
            crib.set_full_packed(
                oidx[:okc], metric[:okc], s3w[:okc], nhw[:okc], None, None
            )
            vs.valid = True
        elif count:
            o = 2
            cidx = dbuf[o:o + b]; o += b
            metric = dbuf[o:o + b]; o += b
            s3w = dbuf[o:o + b * wa].reshape(b, wa); o += b * wa
            nhw = dbuf[o:o + b * wd].reshape(b, wd)
            live = cidx < p_cap
            crib.apply_rows(
                cidx[live][:count], metric[live][:count],
                s3w[live][:count], nhw[live][:count], None, None,
            )
        vs.prev = (out.metric, out.s3w, out.nhw)
        if out.dist is not None:
            # the next solve's warm seed, stamped with the drain epoch
            # and root signature it was computed under
            vs.prev_dist = out.dist
            vs.dist_epoch = ctx["dist_epoch"]
            vs.root_sig = ctx["root_sig"]
        sbuf = fbuf if full_pull else dbuf
        stats = {
            "trips": out.trips,
            "rounds": out.rounds,
            "spf_kernel": ctx["kernel"],
            "changed_rows": count,
            "full_pull": full_pull,
            "bytes_downloaded": (0 if dbuf is None else int(dbuf.nbytes))
            + (0 if fbuf is None else int(fbuf.nbytes)),
        }
        # the tail, back to front: [-1] rounds; after an incremental
        # solve [-3] cone and [-2] fell_back; the sentinels before those
        denom = ctx["incr_denom"]
        if denom is not None:
            cone, fell_back = int(sbuf[-3]), bool(sbuf[-2])
            stats.update(incremental=True, cone=cone, fell_back=fell_back,
                         cone_trips=out.cone_trips)
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
            "sync_ms": (ctx["t1"] - ctx["t0"]) * 1e3,
            # host wall of the launches, the flag reads of the round
            # loops included
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
                a.elapsed_time(b) for a, b in ctx["scatter_events"]
            )
        return crib.view(), timing, stats
