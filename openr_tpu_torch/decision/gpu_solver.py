"""GPU route-computation backend: the cold single-area Decision solve.

``GpuSpfSolver.build_route_db(my_node, {area: LinkState}, PrefixState)``
computes the same ``DecisionRouteDb`` as the CPU oracle
(``decision/spf_solver.py``), with the hot path on an NVIDIA GPU. Per
area whose prefixes are all single-area IP + SP_ECMP announcements
(``_fast_path_eligible``), one ``pipeline`` call runs:

  1. ``ops/relax.plan_sssp``: batched SSSP [D, n_cap] from the root's D
     out-neighbours in G-minus-root over the shift-decomposed mirror
     (ops/edgeplan.py) — K1s init, then bucketed Δ-stepping (K2 ladder
     + K1 handoff relaxation) or synchronous K1 rounds.
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
JAX solver. Not ported yet, and refused rather than approximated:
LFA backup next hops (``enable_lfa``) and areas above
``multichip_n_cap_threshold``. The incremental, fused-area and
streaming solves of the JAX solver are not ported either; every build
here is the cold solve.

``device`` defaults to "cuda" and raises without a CUDA device unless
the caller passes ``device="cpu"``, which runs each kernel's plain
PyTorch version (the tests do).
"""

from __future__ import annotations

import time
from collections import OrderedDict
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
from openr_tpu_torch.ops.edgeplan import drain_dirty, sync_plan
from openr_tpu_torch.ops.relax import plan_sssp
from openr_tpu_torch.ops.select import select_routes
from openr_tpu_torch.runtime.counters import counters
from openr_tpu_torch.types import PrefixForwardingAlgorithm, PrefixForwardingType

# rows shipped per delta pull; more changed rows fall back to the full
# pull (the host reads the count first)
DELTA_BUDGET = 4096


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
    # CUDA events at [start, SSSP done, selection done, compaction done]
    # on a CUDA device; None on the CPU
    events: Optional[list]


def pipeline(deltas, shift_w, res_rows, res_nbr, res_w, mbuf, root: int,
             root_nbr, root_w, prev_metric, prev_s3w, prev_nhw, *,
             has_res: bool, block_v4: bool = False, sentinels: bool = True,
             kernel: str = "sync", delta_exp: int = 0,
             budget: int = DELTA_BUDGET) -> PipelineOut:
    """The cold solve for one (area, vantage) on the device of its
    tensors. Inputs are the resident mirror (deltas [s_cap], shift_w
    [s_cap, n_cap], the residual ELL res_rows [r_cap] / res_nbr, res_w
    [r_cap, kr_cap]), the packed announcer matrix mbuf [6*P*A], the
    root's index and out-slot tables root_nbr / root_w [D], and the
    previous solve's outputs prev_metric [P], prev_s3w [P, ceil(A/16)],
    prev_nhw [P, ceil(D/16)] (zeros before the first). All int32."""
    p_cap = prev_metric.shape[0]
    a_cap = mbuf.numel() // (6 * p_cap)
    events = None
    if shift_w.is_cuda:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        events[0].record()
    dist_d, trips, rounds = plan_sssp(
        deltas, shift_w, res_rows, res_nbr, res_w, root, root_nbr, root_w,
        has_res, kernel, delta_exp,
    )
    if events:
        events[1].record()
    metric, s3w, nhw, ok = select_routes(
        dist_d, root_w, root, mbuf, p_cap, a_cap, block_v4
    )
    if events:
        events[2].record()
    flags = mbuf[p_cap * a_cap:2 * p_cap * a_cap].view(p_cap, a_cap)
    delta_buf, full_buf = compact_outputs(
        metric, s3w, nhw, ok, prev_metric, prev_s3w, prev_nhw, flags,
        trips, rounds, budget, sentinels,
    )
    if events:
        events[3].record()
    return PipelineOut(delta_buf, full_buf, metric, s3w, nhw, trips, rounds,
                       events)


class _AreaDev:
    """Per-area resident device state: plan tensors + announcer matrix."""

    __slots__ = (
        "plan", "deltas", "shift_w", "res_rows", "res_nbr", "res_w",
        "matrix_key", "matrix", "flags", "mbuf", "matrix_version",
        "pack_over",
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


class _VantageState:
    """Per-(area, vantage) output state: the previous solve's resident
    outputs + the columnar RIB the host patches from pulls."""

    __slots__ = ("shape_key", "matrix_version", "prev", "crib",
                 "links_tuple", "valid")

    def __init__(self):
        self.shape_key = None
        self.matrix_version = -1
        self.prev = None  # (metric, s3w, nhw) device tensors
        self.crib: Optional[ColumnarRib] = None
        self.links_tuple: tuple = ()
        self.valid = False


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
        # numerical-health sentinels of the last solve, summed over areas
        self.last_sentinels: dict = {}
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

    def _sync_area(self, area: str, link_state: LinkState,
                   prefix_state: PrefixState, prefixes: list) -> _AreaDev:
        ad = self._area_dev.get(area)
        if ad is None:
            ad = self._area_dev[area] = _AreaDev()
        old_plan = ad.plan
        plan = sync_plan(link_state, old_plan)
        ad.plan = plan
        if plan is not old_plan or ad.deltas is None:
            ad.deltas = self._upload(plan.deltas)
            ad.shift_w = self._upload(plan.shift_w)
            ad.res_rows = self._upload(plan.res_rows)
            ad.res_nbr = self._upload(plan.res_nbr)
            ad.res_w = self._upload(plan.res_w)
            plan.dirty_shift = []
            plan.dirty_res = []
            plan.dirty_res_nbr = False
        else:
            # changelog deltas were applied to the host plan in place:
            # re-upload the planes they touched (the cold slice has no
            # device scatter of dirty slots)
            (s_idx, _, _), (r_idx, _, _), nbr_changed = drain_dirty(plan)
            if s_idx is not None:
                ad.shift_w = self._upload(plan.shift_w)
            if r_idx is not None:
                ad.res_w = self._upload(plan.res_w)
            if nbr_changed:
                ad.res_rows = self._upload(plan.res_rows)
                ad.res_nbr = self._upload(plan.res_nbr)
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
        root_nbr_t = self._upload(root_nbr)
        root_w_t = self._upload(root_w)
        t1 = time.perf_counter()
        out = pipeline(
            ad.deltas, ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w,
            ad.mbuf, root_idx, root_nbr_t, root_w_t, *vs.prev,
            has_res=has_res, block_v4=block_v4,
            sentinels=self.enable_sentinels, kernel=kernel,
            delta_exp=delta_exp,
        )
        counters.increment("decision.solver.full.solves")
        return {
            "area": area, "vs": vs, "out": out, "kernel": kernel,
            "d_cap": d_cap, "p_cap": p_cap, "a_cap": a_cap,
            "t0": t0, "t1": t1, "t2": time.perf_counter(),
        }

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
        sbuf = fbuf if full_pull else dbuf
        stats = {
            "trips": out.trips,
            "rounds": out.rounds,
            "spf_kernel": ctx["kernel"],
            "bytes_downloaded": (0 if dbuf is None else int(dbuf.nbytes))
            + (0 if fbuf is None else int(fbuf.nbytes)),
        }
        if self.enable_sentinels:
            stats["sentinels"] = {
                "unreachable_rows": int(sbuf[-3]),
                "saturated_rows": int(sbuf[-2]),
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
            timing["sssp_ms"] = ev[0].elapsed_time(ev[1])
            timing["tail_ms"] = ev[1].elapsed_time(ev[2])
            timing["compact_ms"] = ev[2].elapsed_time(ev[3])
        return crib.view(), timing, stats
