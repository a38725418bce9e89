"""RIB value types + route-delta containers.

Role of the reference's openr/decision/RibEntry.h (RibUnicastEntry:43,
RibMplsEntry:112, filterNexthopsToUniqueAction:158) and RouteUpdate.h:29
(DecisionRouteUpdate), plus the delta computation DecisionRouteDb::
calculateUpdate (SpfSolver.h:57-98).

NextHop re-expresses thrift::NextHopThrift: in this framework a next hop is
identified structurally by (neighbor node, local interface, area) — the
address fields are carried for Fib programming but excluded from routing
equality only where the reference does the same (it compares full structs;
so do we).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace  # noqa: F401
from typing import Optional

from openr_tpu_torch.types import PerfEvents, PrefixEntry


class MplsActionCode(enum.IntEnum):
    """ref Network.thrift MplsActionCode."""

    PUSH = 0
    SWAP = 1
    PHP = 2  # Penultimate hop popping: POP and FORWARD
    POP_AND_LOOKUP = 3


@dataclass(frozen=True)
class MplsAction:
    action: MplsActionCode
    swap_label: Optional[int] = None
    push_labels: tuple[int, ...] = ()


@dataclass(frozen=True)
class NextHop:
    """ref Network.thrift NextHopThrift / createNextHop (LsdbUtil)."""

    address: str  # neighbor's link address (v4 or v6), "" if abstract
    if_name: str = ""
    metric: int = 0  # IGP cost to destination over this next hop
    mpls_action: Optional[MplsAction] = None
    area: str = ""
    neighbor_node_name: str = ""
    weight: int = 0  # 0 = ECMP; >0 = UCMP normalized weight


# MPLS label validity range (ref LsdbUtil isMplsLabelValid; RFC 3032:
# 16 reserved labels, 20-bit label space)
MAX_MPLS_LABEL = (1 << 20) - 1
MIN_MPLS_LABEL = 16


def is_mpls_label_valid(label: int) -> bool:
    return MIN_MPLS_LABEL <= label <= MAX_MPLS_LABEL


def filter_nexthops_to_unique_action(
    nexthops: frozenset[NextHop],
) -> frozenset[NextHop]:
    """Keep only next hops whose MPLS action matches the min-metric next
    hop's action (hardware can't mix SWAP/PHP in one ECMP group;
    ref RibEntry.h:158)."""
    if not nexthops:
        return nexthops
    best = min(
        nexthops,
        key=lambda nh: (
            nh.metric,
            nh.mpls_action.action if nh.mpls_action else -1,
        ),
    )
    best_action = best.mpls_action.action if best.mpls_action else None
    return frozenset(
        nh
        for nh in nexthops
        if (nh.mpls_action.action if nh.mpls_action else None) == best_action
    )


@dataclass(frozen=True)
class RibUnicastEntry:
    """One computed unicast route (ref RibEntry.h:43-110).

    lfa_nexthops carries the loop-free-alternate backup next hop(s)
    (rfc5286) when the solver runs with LFA enabled: a neighbor N is a
    valid alternate for this prefix iff dist_N(P) < dist_N(self) +
    dist_self(P), which guarantees N's own shortest path to P does not
    loop back through this node. Alternates are kept separate from the
    primary ECMP set — Fib programs them as backup next hops, never as
    load-balanced members (their metric is the alternate path cost,
    strictly greater than igp_cost). The reference has no LFA; this is
    the TPU build's fast-reroute extension (BASELINE config 3), derived
    on device from the same per-neighbor distance fields the ECMP
    next-hop predicate uses (ref next-hop machinery this extends:
    openr/decision/SpfSolver.cpp:1043-1285)."""

    prefix: str
    nexthops: frozenset[NextHop] = frozenset()
    best_prefix_entry: Optional[PrefixEntry] = None
    best_node_area: tuple[str, str] = ("", "")
    do_not_install: bool = False
    igp_cost: int = 0
    ucmp_weight: Optional[int] = None
    counter_id: Optional[str] = None  # set by RibPolicy (ref RibEntry.h:70)
    lfa_nexthops: frozenset[NextHop] = frozenset()


@dataclass(frozen=True)
class RibMplsEntry:
    """One computed MPLS label route (ref RibEntry.h:112-156)."""

    label: int
    nexthops: frozenset[NextHop] = frozenset()


@dataclass(frozen=True)
class RouteProvenance:
    """Originating-event tag for one RIB entry: which kv-store event
    last changed this route and which solve materialized it. Kept in a
    per-prefix side map beside DecisionRouteDb (RibUnicastEntry is
    frozen and flows through the columnar RIB's row compare — widening
    it would dirty every row on upgrade). Queryable per prefix via
    ctrl.decision.explain / `breeze decision explain`. The reference
    has no provenance; this is the TPU build's auditability extension
    for the incremental solver (a route produced by seed-from-previous
    must be attributable to its triggering event)."""

    kv_key: str = ""  # originating kvstore key ("" = static/unknown)
    originator: str = ""  # advertising node (Value.originator_id)
    area: str = ""
    solve_epoch: int = 0  # monotonic per-Decision build counter
    solver_kind: str = "full"  # full | incremental | failover-cpu
    ts_ms: int = 0  # wall clock at stamping


class ProvenanceLedger:
    """Drop-in for Decision's per-prefix provenance dict with a bulk
    column lane: a large build (cold rebuild, mass churn) stamps ONE
    layer recording (membership map, per-prefix event tags, topology
    fallback, ingest-tag snapshot, solve meta) instead of constructing
    one RouteProvenance per route — at 100k..1M routes that object loop
    was the last O(routes) allocation left on the columnar spine. The
    record object is built only when `breeze decision explain` actually
    asks for a prefix.

    get / pop / __setitem__ match dict semantics exactly (the only
    operations Decision performs); newest stamp wins via a global
    sequence, so an explicit re-stamp or delete always shadows an older
    layer and a newer layer shadows older explicit stamps. Layers are
    capped: the oldest folds into explicit records (preserving its
    original sequence) once more than _LAYER_MAX bulk builds coexist."""

    _LAYER_MAX = 4

    __slots__ = ("_explicit", "_layers", "_seq")

    def __init__(self):
        # prefix -> (seq, RouteProvenance | None); None = tombstone
        self._explicit: dict = {}
        # (seq, members, tags, topo, ingest, epoch, kind, ts_ms), seq
        # ascending; `members` is any Mapping with cheap iter/contains
        self._layers: list = []
        self._seq = 0

    def _next(self) -> int:
        self._seq += 1
        return self._seq

    @staticmethod
    def _build(layer, prefix: str) -> RouteProvenance:
        _, _, tags, topo, ingest, epoch, kind, ts_ms = layer
        tag = (
            tags.get(prefix)
            or topo
            or (ingest.get(prefix) if ingest else None)
            or ("", "", "")
        )
        return RouteProvenance(
            kv_key=tag[0], originator=tag[1], area=tag[2],
            solve_epoch=epoch, solver_kind=kind, ts_ms=ts_ms,
        )

    def __setitem__(self, prefix: str, prov: RouteProvenance) -> None:
        self._explicit[prefix] = (self._next(), prov)

    def pop(self, prefix: str, default=None):
        out = self.get(prefix, default)
        if self._layers:
            self._explicit[prefix] = (self._next(), None)
        else:
            self._explicit.pop(prefix, None)
        return out

    def get(self, prefix: str, default=None):
        seq, prov = self._explicit.get(prefix, (0, None))
        for layer in reversed(self._layers):
            if layer[0] <= seq:
                break
            if prefix in layer[1]:
                return self._build(layer, prefix)
        return prov if prov is not None else default

    def stamp_layer(self, members, tags, topo, ingest, epoch, kind,
                    ts_ms) -> None:
        self._layers.append(
            (self._next(), members, tags, topo, ingest, epoch, kind, ts_ms)
        )
        if len(self._layers) > self._LAYER_MAX:
            self._fold_oldest()

    def _fold_oldest(self) -> None:
        layer = self._layers.pop(0)
        seq = layer[0]
        for prefix in layer[1]:
            es, _ = self._explicit.get(prefix, (0, None))
            if es > seq:
                continue
            if any(prefix in nl[1] for nl in self._layers):
                continue  # a newer layer answers for it anyway
            self._explicit[prefix] = (seq, self._build(layer, prefix))


class RouteUpdateType(enum.IntEnum):
    """ref RouteUpdate.h:34."""

    FULL_SYNC = 1
    INCREMENTAL = 2


@dataclass
class DecisionRouteUpdate:
    """Delta container Decision -> Fib/PrefixManager (ref RouteUpdate.h:29)."""

    type: RouteUpdateType = RouteUpdateType.INCREMENTAL
    unicast_routes_to_update: dict[str, RibUnicastEntry] = field(default_factory=dict)
    unicast_routes_to_delete: list[str] = field(default_factory=list)
    mpls_routes_to_update: dict[int, RibMplsEntry] = field(default_factory=dict)
    mpls_routes_to_delete: list[int] = field(default_factory=list)
    perf_events: Optional[PerfEvents] = None
    prefix_type: Optional[int] = None  # set for static-route updates
    # columnar spine: when the diff stayed in packed-array land this is
    # the ColumnDelta behind unicast_routes_to_update (which is then a
    # lazy ColumnUpdateMap, not a dict) — Fib and the platform consume
    # the arrays, object consumers force the Mapping. None on the
    # legacy/object path; excluded from serde (dataclass field order
    # keeps wire compat because serde emits by name).
    columns: Optional[object] = None
    # epoch fence provenance: Decision's solve epoch that produced this
    # delta. Fib coalesces deltas, so its programmed/ack publications
    # carry the NEWEST epoch folded into the pass — with the streaming
    # pipeline overlapping epochs, this is what keeps FIB acks and
    # convergence traces attributed to the right solve. None on static
    # and synthetic updates.
    solve_epoch: Optional[int] = None

    def empty(self) -> bool:
        return not (
            self.unicast_routes_to_update
            or self.unicast_routes_to_delete
            or self.mpls_routes_to_update
            or self.mpls_routes_to_delete
        )


@dataclass
class DecisionRouteDb:
    """Full computed RIB (ref SpfSolver.h:57-98)."""

    unicast_routes: dict[str, RibUnicastEntry] = field(default_factory=dict)
    mpls_routes: dict[int, RibMplsEntry] = field(default_factory=dict)

    def add_unicast_route(self, entry: RibUnicastEntry) -> None:
        self.unicast_routes[entry.prefix] = entry

    def add_mpls_route(self, entry: RibMplsEntry) -> None:
        self.mpls_routes[entry.label] = entry

    def calculate_update(self, new_db: "DecisionRouteDb") -> DecisionRouteUpdate:
        """Delta from self -> new_db (ref DecisionRouteDb::calculateUpdate)."""
        upd = DecisionRouteUpdate()
        # columnar spine: when the new RIB is a live lazy view
        # over the column stores, the diff itself stays in packed-array
        # land — cold rebuilds ship every ok row with zero compares and
        # zero entry builds, warm rebuilds column-compare only the
        # journaled rows. unicast_routes_to_update becomes a lazy
        # ColumnUpdateMap; Fib/platform consume upd.columns directly.
        from openr_tpu_torch.decision.column_delta import fast_unicast_column_diff
        from openr_tpu_torch.decision.columnar_rib import fast_unicast_diff

        delta = fast_unicast_column_diff(
            self.unicast_routes, new_db.unicast_routes
        )
        if delta is not None:
            upd.columns = delta
            upd.unicast_routes_to_update = delta.lazy_map()
            upd.unicast_routes_to_delete = delta.deletes
            upd.fast_diff = not delta.full  # observability (not a field)
        else:
            # legacy entry-level journal diff (kept as the parity oracle
            # for the columnar path), then the full O(P) compare
            res = fast_unicast_diff(
                self.unicast_routes, new_db.unicast_routes
            )
            if res is not None:
                upd.unicast_routes_to_update, dels = res
                upd.unicast_routes_to_delete = dels
                upd.fast_diff = True  # observability (not a field)
            else:
                for prefix, entry in new_db.unicast_routes.items():
                    old = self.unicast_routes.get(prefix)
                    if old is None or old != entry:
                        upd.unicast_routes_to_update[prefix] = entry
                for prefix in self.unicast_routes:
                    if prefix not in new_db.unicast_routes:
                        upd.unicast_routes_to_delete.append(prefix)
        for label, entry in new_db.mpls_routes.items():
            old = self.mpls_routes.get(label)
            if old is None or old != entry:
                upd.mpls_routes_to_update[label] = entry
        for label in self.mpls_routes:
            if label not in new_db.mpls_routes:
                upd.mpls_routes_to_delete.append(label)
        return upd
