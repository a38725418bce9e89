"""CPU route-computation oracle.

Role of the reference's openr/decision/SpfSolver.{h,cpp}: per-prefix route
computation — reachability-filter announcers (SpfSolver.cpp:230-244) ->
select_best_routes (:648-769) -> drained-node filter (:709-731) -> per-area
forwarding-algorithm switch SP_ECMP / UCMP / KSP2_ED_ECMP (:356-443) ->
get_next_hops_with_metric (:1043-1089) -> get_next_hops (:1165-1285,
neighbor-link enumeration, shortest-only filter, MPLS PUSH/SWAP/PHP label
construction, UCMP weight attach) -> add_best_paths (:975-1041, min-nexthop
threshold, self-prepend-label next hops). build_route_db (:460-646) loops
every prefix + node-segment-label MPLS routes + adj-label routes + statics.

Scope notes vs the reference (documented deviations):
  - Best-route selection is always metric-based SHORTEST_DISTANCE (the
    reference's enableBestRouteSelection_ path); the legacy BGP
    MetricVector comparison path (:709-769) serves the closed-source BGP
    plugin and is not replicated.
  - SR policy rules default (getRouteComputationRules builds per-area
    forwarding type/algo as the min over best entries, LsdbUtil.cpp:379).

This is the correctness oracle for decision/tpu_solver.py; both are pure
functions of (areaLinkStates, prefixState) and are differentially tested.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from openr_tpu_torch.decision.link_state import LinkState, NodeUcmpResult, path_a_in_path_b
from openr_tpu_torch.decision.prefix_state import PrefixEntries, PrefixState
from openr_tpu_torch.decision.rib import (
    DecisionRouteDb,
    MplsAction,
    MplsActionCode,
    NextHop,
    RibMplsEntry,
    RibUnicastEntry,
    is_mpls_label_valid,
)
from openr_tpu_torch.types import (
    PrefixForwardingAlgorithm,
    PrefixForwardingType,
    parse_prefix,
)

INF = float("inf")

NodeAndArea = tuple  # (node, area)


@dataclass
class RouteSelectionResult:
    """ref SpfSolver.h:30-55."""

    all_node_areas: set = field(default_factory=set)
    best_node_area: NodeAndArea = ("", "")
    success: bool = False

    def has_node(self, node: str) -> bool:
        return any(n == node for n, _ in self.all_node_areas)


def select_routes(prefix_entries: PrefixEntries) -> set:
    """SHORTEST_DISTANCE selection (ref LsdbUtil.cpp selectRoutes:842):
    best (path_preference desc, source_preference desc), then min advertised
    distance."""
    best_tuple = None
    node_area_set: set = set()
    for key, entry in prefix_entries.items():
        t = (entry.metrics.path_preference, entry.metrics.source_preference)
        if best_tuple is not None and t < best_tuple:
            continue
        if best_tuple is None or t > best_tuple:
            best_tuple = t
            node_area_set.clear()
        node_area_set.add(key)
    # shortest advertised distance among preference winners
    best_dist = None
    out: set = set()
    for key in node_area_set:
        d = prefix_entries[key].metrics.distance
        if best_dist is not None and d > best_dist:
            continue
        if best_dist is None or d < best_dist:
            best_dist = d
            out.clear()
        out.add(key)
    return out


def select_best_node_area(all_node_areas: set, my_node: str) -> NodeAndArea:
    """ref LsdbUtil.cpp:758 — deterministic min, preferring self."""
    best = min(all_node_areas)
    for node_area in all_node_areas:
        if node_area[0] == my_node:
            return node_area
    return best


class SpfSolver:
    """ref SpfSolver.h:101."""

    def __init__(
        self,
        my_node_name: str,
        enable_v4: bool = True,
        enable_node_segment_label: bool = False,
        enable_adjacency_labels: bool = False,
        enable_ucmp: bool = False,
        enable_best_route_selection: bool = True,
        v4_over_v6_nexthop: bool = False,
        enable_lfa: bool = False,
    ):
        self.my_node_name = my_node_name
        self.enable_v4 = enable_v4
        self.enable_node_segment_label = enable_node_segment_label
        self.enable_adjacency_labels = enable_adjacency_labels
        self.enable_ucmp = enable_ucmp
        self.enable_lfa = enable_lfa
        self.enable_best_route_selection = enable_best_route_selection
        self.v4_over_v6_nexthop = v4_over_v6_nexthop
        self.static_unicast_routes: dict[str, RibUnicastEntry] = {}
        self.static_mpls_routes: dict[int, RibMplsEntry] = {}
        self.best_routes_cache: dict[str, RouteSelectionResult] = {}
        # optional accelerator hook for resolve_ucmp_weights (the TPU
        # solver installs a device-backed one): called with
        # (my_node_name, area, link_state, dst_weights,
        # use_prefix_weight) and returns the root's NodeUcmpResult (or
        # None when UCMP is inapplicable); NotImplemented falls back to
        # the host heap walk
        self.ucmp_resolver = None

    # -- static routes (ref SpfSolver.cpp:118-174) -------------------------

    def update_static_unicast_routes(
        self,
        to_update: dict[str, RibUnicastEntry],
        to_delete: list[str],
    ) -> None:
        for prefix, entry in to_update.items():
            self.static_unicast_routes[prefix] = entry
        for prefix in to_delete:
            self.static_unicast_routes.pop(prefix, None)

    def update_static_mpls_routes(
        self, to_update: dict[int, RibMplsEntry], to_delete: list[int]
    ) -> None:
        for label, entry in to_update.items():
            self.static_mpls_routes[label] = entry
        for label in to_delete:
            self.static_mpls_routes.pop(label, None)

    # -- full build (ref SpfSolver.cpp:460-646) ----------------------------

    def build_route_db(
        self,
        my_node_name: str,
        area_link_states: dict[str, LinkState],
        prefix_state: PrefixState,
    ) -> Optional[DecisionRouteDb]:
        if not any(ls.has_node(my_node_name) for ls in area_link_states.values()):
            return None
        route_db = DecisionRouteDb()
        self.best_routes_cache.clear()

        for prefix in prefix_state.prefixes():
            route = self.create_route_for_prefix(
                my_node_name, area_link_states, prefix_state, prefix
            )
            if route is not None:
                route_db.add_unicast_route(route)

        for prefix, entry in self.static_unicast_routes.items():
            if prefix not in route_db.unicast_routes:
                route_db.add_unicast_route(entry)

        if self.enable_node_segment_label:
            for label, entry in self._node_label_routes(
                my_node_name, area_link_states
            ).items():
                route_db.add_mpls_route(entry)

        if self.enable_adjacency_labels:
            for entry in self._adj_label_routes(my_node_name, area_link_states):
                route_db.add_mpls_route(entry)

        for entry in self.static_mpls_routes.values():
            route_db.add_mpls_route(entry)

        return route_db

    def create_route_for_prefix_or_get_static(
        self,
        my_node_name: str,
        area_link_states: dict[str, LinkState],
        prefix_state: PrefixState,
        prefix: str,
    ) -> Optional[RibUnicastEntry]:
        """Incremental-path entry (ref SpfSolver.cpp:175-195)."""
        route = self.create_route_for_prefix(
            my_node_name, area_link_states, prefix_state, prefix
        )
        if route is not None:
            return route
        return self.static_unicast_routes.get(prefix)

    def create_route_for_prefix(
        self,
        my_node_name: str,
        area_link_states: dict[str, LinkState],
        prefix_state: PrefixState,
        prefix: str,
    ) -> Optional[RibUnicastEntry]:
        """ref SpfSolver.cpp:196-455."""
        net = parse_prefix(prefix)
        is_v4 = net.version == 4
        if is_v4 and not self.enable_v4 and not self.v4_over_v6_nexthop:
            return None

        all_entries = prefix_state.entries_for(prefix)
        if not all_entries:
            return None
        self.best_routes_cache.pop(prefix, None)

        # reachability filter: drop announcers unreachable in their area
        # (ref SpfSolver.cpp:230-244)
        prefix_entries: PrefixEntries = dict(all_entries)
        for area, link_state in area_link_states.items():
            spf = link_state.get_spf_result(my_node_name)
            for node_area in list(prefix_entries):
                node, pfx_area = node_area
                if pfx_area == area and node not in spf:
                    del prefix_entries[node_area]
        if not prefix_entries:
            return None

        # self-prepend-label flag (ref SpfSolver.cpp:262-270)
        has_self_prepend_label = True
        for (node, _), entry in prefix_entries.items():
            if node == my_node_name:
                has_self_prepend_label &= entry.prepend_label is not None

        selection = self.select_best_routes(
            my_node_name, prefix_entries, area_link_states
        )
        if not selection.success or not selection.all_node_areas:
            return None
        self.best_routes_cache[prefix] = selection

        # skip route for a prefix advertised by self, unless it carries a
        # prepend label (ref SpfSolver.cpp:330-344)
        if selection.has_node(my_node_name) and not has_self_prepend_label:
            return None

        # per-area forwarding rules = min over best entries in area
        # (ref LsdbUtil.cpp:379-413)
        total_next_hops: set[NextHop] = set()
        ucmp_weight: Optional[int] = None
        shortest_metric = INF
        lfa_candidates: list = []
        for area, link_state in area_link_states.items():
            rules = self._area_forwarding_rules(area, prefix_entries, selection)
            if rules is None:
                continue
            fwd_type, fwd_algo = rules
            if fwd_algo in (
                PrefixForwardingAlgorithm.SP_ECMP,
                PrefixForwardingAlgorithm.SP_UCMP_ADJ_WEIGHT_PROPAGATION,
                PrefixForwardingAlgorithm.SP_UCMP_PREFIX_WEIGHT_PROPAGATION,
            ):
                best_metric, nhs, area_ucmp = self._select_best_paths_spf(
                    my_node_name,
                    prefix,
                    selection,
                    prefix_entries,
                    fwd_type,
                    area,
                    link_state,
                    fwd_algo,
                    is_v4,
                )
                if (
                    self.enable_lfa
                    and fwd_type == PrefixForwardingType.IP
                    and nhs
                    and best_metric < INF
                ):
                    lfa_candidates.extend(
                        self._lfa_candidates(
                            my_node_name,
                            selection,
                            area,
                            link_state,
                            int(best_metric),
                        )
                    )
                # only keep next hops from areas with the shortest IGP metric
                if shortest_metric >= best_metric:
                    if shortest_metric > best_metric:
                        shortest_metric = best_metric
                        total_next_hops.clear()
                        ucmp_weight = None
                    total_next_hops.update(nhs)
                    if ucmp_weight is None:
                        ucmp_weight = area_ucmp
                    elif area_ucmp is not None:
                        ucmp_weight += area_ucmp
            elif fwd_algo == PrefixForwardingAlgorithm.KSP2_ED_ECMP:
                total_next_hops.update(
                    self._select_best_paths_ksp2(
                        my_node_name,
                        prefix,
                        selection,
                        prefix_entries,
                        fwd_type,
                        area,
                        link_state,
                        is_v4,
                    )
                )

        route = self._add_best_paths(
            my_node_name,
            prefix,
            selection,
            prefix_entries,
            total_next_hops,
            0 if shortest_metric == INF else int(shortest_metric),
            ucmp_weight,
        )
        if route is not None and lfa_candidates:
            primary = {
                (nh.if_name, nh.neighbor_node_name) for nh in route.nexthops
            }
            cands = [
                c
                for c in lfa_candidates
                if (
                    c[3].iface_from_node(my_node_name),
                    c[3].other_node(my_node_name),
                )
                not in primary
            ]
            if cands:
                alt_metric, _, _, link = min(cands)
                lfa = NextHop(
                    address=link.nh_from_node(
                        my_node_name,
                        is_v4 and not self.v4_over_v6_nexthop,
                    ),
                    if_name=link.iface_from_node(my_node_name),
                    metric=alt_metric,
                    area=link.area,
                    neighbor_node_name=link.other_node(my_node_name),
                )
                route = replace(route, lfa_nexthops=frozenset({lfa}))
        return route

    # -- best-route selection (ref SpfSolver.cpp:648-707) ------------------

    def select_best_routes(
        self,
        my_node_name: str,
        prefix_entries: PrefixEntries,
        area_link_states: dict[str, LinkState],
    ) -> RouteSelectionResult:
        assert prefix_entries, "no prefixes for best route selection"
        ret = RouteSelectionResult()
        if self.enable_best_route_selection:
            ret.all_node_areas = select_routes(prefix_entries)
            ret.best_node_area = select_best_node_area(
                ret.all_node_areas, my_node_name
            )
            ret.success = True
        else:
            ret.all_node_areas = set(prefix_entries)
            ret.best_node_area = min(ret.all_node_areas)
            ret.success = True
        return self._maybe_filter_drained_nodes(ret, area_link_states)

    def _maybe_filter_drained_nodes(
        self,
        result: RouteSelectionResult,
        area_link_states: dict[str, LinkState],
    ) -> RouteSelectionResult:
        """Drop soft-drained announcers; if ALL are drained keep the
        unfiltered set (ref SpfSolver.cpp:709-731)."""
        filtered = {
            (node, area)
            for node, area in result.all_node_areas
            if not area_link_states[area].is_node_overloaded(node)
        }
        if not filtered:
            return result
        out = RouteSelectionResult(
            all_node_areas=filtered,
            best_node_area=result.best_node_area,
            success=result.success,
        )
        if result.best_node_area not in filtered:
            out.best_node_area = min(filtered)
        return out

    def _area_forwarding_rules(
        self,
        area: str,
        prefix_entries: PrefixEntries,
        selection: RouteSelectionResult,
    ) -> Optional[tuple[PrefixForwardingType, PrefixForwardingAlgorithm]]:
        rules = None
        for node_area, entry in prefix_entries.items():
            if node_area not in selection.all_node_areas or node_area[1] != area:
                continue
            if rules is None:
                rules = (entry.forwarding_type, entry.forwarding_algorithm)
            else:
                rules = (
                    min(rules[0], entry.forwarding_type),
                    min(rules[1], entry.forwarding_algorithm),
                )
        return rules

    # -- SPF path selection (ref SpfSolver.cpp:771-845) --------------------

    def _select_best_paths_spf(
        self,
        my_node_name: str,
        prefix: str,
        selection: RouteSelectionResult,
        prefix_entries: PrefixEntries,
        fwd_type: PrefixForwardingType,
        area: str,
        link_state: LinkState,
        fwd_algo: PrefixForwardingAlgorithm,
        is_v4: bool,
    ) -> tuple[float, set[NextHop], Optional[int]]:
        per_destination = fwd_type == PrefixForwardingType.SR_MPLS

        # self-originated SR_MPLS prefix with prepend label: don't route to
        # self (ref SpfSolver.cpp:796-808)
        dst_node_areas = set(selection.all_node_areas)
        if selection.has_node(my_node_name) and per_destination:
            for node_area, entry in prefix_entries.items():
                if node_area[0] == my_node_name and entry.prepend_label is not None:
                    dst_node_areas.discard(node_area)
                    break

        min_metric, next_hop_nodes = self.get_next_hops_with_metric(
            my_node_name, dst_node_areas, per_destination, link_state
        )
        if not next_hop_nodes:
            return min_metric, set(), None

        ucmp_result = self._get_node_ucmp_result(
            my_node_name,
            fwd_algo,
            area,
            link_state,
            prefix_entries,
            selection.all_node_areas,
            min_metric,
        )
        ucmp_weight = ucmp_result.weight if ucmp_result is not None else None

        nhs = self.get_next_hops(
            my_node_name,
            selection.all_node_areas,
            is_v4,
            per_destination,
            min_metric,
            next_hop_nodes,
            None,
            area,
            link_state,
            prefix_entries,
            ucmp_result,
        )
        return min_metric, nhs, ucmp_weight

    def get_next_hops_with_metric(
        self,
        my_node_name: str,
        dst_node_areas: set,
        per_destination: bool,
        link_state: LinkState,
    ) -> tuple[float, dict[tuple[str, str], int]]:
        """ref SpfSolver.cpp:1043-1089 — returns (min metric to the
        destination set, map (next-hop node, dst-or-'') -> distance from
        that next hop to the destination)."""
        spf = link_state.get_spf_result(my_node_name)
        shortest_metric = INF
        min_cost_nodes: set[str] = set()
        for dst_node, _ in dst_node_areas:
            node = spf.get(dst_node)
            if node is None:
                continue
            if shortest_metric >= node.metric:
                if shortest_metric > node.metric:
                    shortest_metric = node.metric
                    min_cost_nodes.clear()
                min_cost_nodes.add(dst_node)

        next_hop_nodes: dict[tuple[str, str], int] = {}
        for dst_node in min_cost_nodes:
            dst_ref = dst_node if per_destination else ""
            for nh_name in spf[dst_node].next_hops:
                next_hop_nodes[(nh_name, dst_ref)] = int(shortest_metric) - (
                    link_state.get_metric_from_a_to_b(my_node_name, nh_name) or 0
                )
        return shortest_metric, next_hop_nodes

    def get_next_hops(
        self,
        my_node_name: str,
        dst_node_areas: set,
        is_v4: bool,
        per_destination: bool,
        min_metric: float,
        next_hop_nodes: dict[tuple[str, str], int],
        swap_label: Optional[int],
        area: str,
        link_state: LinkState,
        prefix_entries: Optional[PrefixEntries] = None,
        ucmp_result: Optional[NodeUcmpResult] = None,
    ) -> set[NextHop]:
        """ref SpfSolver.cpp getNextHopsThrift:1165-1285."""
        assert next_hop_nodes
        next_hops: set[NextHop] = set()
        dst_iter = sorted(dst_node_areas) if per_destination else [("", "")]
        for link in link_state.links_from_node(my_node_name):
            for dst_node, dst_area in dst_iter:
                if dst_area and area != dst_area:
                    continue
                neighbor = link.other_node(my_node_name)
                dist_to_dst = next_hop_nodes.get((neighbor, dst_node))
                if dist_to_dst is None or not link.is_up():
                    continue
                # don't route via another destination that isn't this dst
                if (
                    dst_node
                    and (neighbor, area) in dst_node_areas
                    and neighbor != dst_node
                ):
                    continue
                dist_over_link = link.metric_from_node(my_node_name) + dist_to_dst
                if dist_over_link != min_metric:
                    continue  # not shortest

                mpls_action: Optional[MplsAction] = None
                if swap_label is not None:
                    nh_is_dst = (neighbor, area) in dst_node_areas
                    mpls_action = MplsAction(
                        MplsActionCode.PHP if nh_is_dst else MplsActionCode.SWAP,
                        None if nh_is_dst else swap_label,
                    )
                if dst_node:
                    push_labels: list[int] = []
                    entry = prefix_entries.get((dst_node, area)) if prefix_entries else None
                    if entry is not None and entry.prepend_label is not None:
                        if not is_mpls_label_valid(entry.prepend_label):
                            continue
                        push_labels.append(entry.prepend_label)
                    if dst_node != neighbor:
                        node_label = (
                            link_state.get_adjacency_databases()[dst_node].node_label
                        )
                        if not is_mpls_label_valid(node_label):
                            continue
                        push_labels.append(node_label)
                    if push_labels:
                        assert mpls_action is None
                        mpls_action = MplsAction(
                            MplsActionCode.PUSH, None, tuple(push_labels)
                        )

                weight = 0
                if ucmp_result is not None:
                    nh_link = ucmp_result.next_hop_links.get(
                        link.iface_from_node(my_node_name)
                    )
                    if nh_link is not None:
                        weight = nh_link.weight

                next_hops.add(
                    NextHop(
                        address=link.nh_from_node(
                            my_node_name,
                            is_v4 and not self.v4_over_v6_nexthop,
                        ),
                        if_name=link.iface_from_node(my_node_name),
                        metric=int(dist_over_link),
                        mpls_action=mpls_action,
                        area=link.area,
                        neighbor_node_name=neighbor,
                        weight=weight,
                    )
                )
        return next_hops

    # -- LFA fast-reroute alternates (rfc5286) -----------------------------

    def _lfa_candidates(
        self,
        my_node_name: str,
        selection: RouteSelectionResult,
        area: str,
        link_state: LinkState,
        area_metric: int,
    ) -> list:
        """Loop-free alternate candidates for one area: every up link to a
        neighbor N satisfying dist_N(P) < dist_N(self) + dist_self(P),
        where dist_N(P) = min over the selected announcers of N's own
        distance. Strict inequality guarantees every shortest N->P path
        avoids this node (a path through self costs at least the RHS), so
        pre-installing N as a backup cannot loop. Overloaded neighbors are
        skipped unless the neighbor is itself a selected destination
        (drained nodes must not pick up transit, but a direct link to the
        destination is fine) — mirroring the transit-drain rule runSpf
        applies (link_state.py run_spf; ref LinkState.cpp:870-876).

        Returns (alt_metric, area, link_order, link) tuples; the caller
        filters out primaries, keeps the global minimum and materializes
        that one winner as a NextHop. The TPU path (tpu_solver.py)
        computes the same predicate on device from its per-neighbor
        distance fields and is differentially tested against this oracle
        (tests/test_lfa.py)."""
        dsts = [n for n, a in selection.all_node_areas if a == area]
        if not dsts:
            return []
        out = []
        for order, link in enumerate(
            link_state.ordered_links_from_node(my_node_name)
        ):
            if not link.is_up():
                continue
            neighbor = link.other_node(my_node_name)
            n_is_dst = neighbor in dsts
            if link_state.is_node_overloaded(neighbor) and not n_is_dst:
                continue
            if n_is_dst:
                # the neighbor announces the prefix itself: trivially
                # loop-free, alternate cost = the link metric
                dist_np = 0
            else:
                spf_n = link_state.get_spf_result(neighbor)
                dist_np = min(
                    (spf_n[d].metric for d in dsts if d in spf_n),
                    default=None,
                )
                if dist_np is None:
                    continue
                root_res = spf_n.get(my_node_name)
                dist_nr = INF if root_res is None else root_res.metric
                if not dist_np < dist_nr + area_metric:
                    continue
            alt_metric = link.metric_from_node(my_node_name) + dist_np
            out.append((alt_metric, area, order, link))
        return out

    # -- KSP2 (ref SpfSolver.cpp:847-973) ----------------------------------

    def _select_best_paths_ksp2(
        self,
        my_node_name: str,
        prefix: str,
        selection: RouteSelectionResult,
        prefix_entries: PrefixEntries,
        fwd_type: PrefixForwardingType,
        area: str,
        link_state: LinkState,
        is_v4: bool,
    ) -> set[NextHop]:
        next_hops: set[NextHop] = set()
        if fwd_type != PrefixForwardingType.SR_MPLS:
            return next_hops  # incompatible forwarding type

        paths = []
        for node, best_area in sorted(selection.all_node_areas):
            if node == my_node_name and best_area == area:
                continue
            paths.extend(link_state.get_kth_paths(my_node_name, node, 1))
        first_count = len(paths)
        for node, best_area in sorted(selection.all_node_areas):
            if best_area != area:
                continue
            for sec_path in link_state.get_kth_paths(my_node_name, node, 2):
                # avoid double-spray: drop 2nd paths containing a 1st path
                if not any(
                    path_a_in_path_b(paths[i], sec_path) for i in range(first_count)
                ):
                    paths.append(sec_path)
        if not paths:
            return next_hops

        adj_dbs = link_state.get_adjacency_databases()
        for path in paths:
            cost = 0
            labels: list[int] = []  # stack, last = outermost
            invalid = False
            next_node = my_node_name
            for link in path:
                cost += link.metric_from_node(next_node)
                next_node = link.other_node(next_node)
                node_label = adj_dbs[next_node].node_label
                labels.insert(0, node_label)
                if not is_mpls_label_valid(node_label):
                    invalid = True
            if invalid:
                continue
            labels.pop()  # PHP: drop first-hop node's label... (see note)
            # NOTE ref SpfSolver.cpp:940 pops the *last* element of the
            # front-pushed list == the first node on the path (PHP).
            entry = prefix_entries.get((next_node, area))
            if entry is not None and entry.prepend_label is not None:
                labels.insert(0, entry.prepend_label)  # bottom of stack

            first_link = path[0]
            mpls_action = (
                MplsAction(MplsActionCode.PUSH, None, tuple(labels))
                if labels
                else None
            )
            next_hops.add(
                NextHop(
                    address=first_link.nh_v6_from_node(my_node_name),
                    if_name=first_link.iface_from_node(my_node_name),
                    metric=cost,
                    mpls_action=mpls_action,
                    area=first_link.area,
                    neighbor_node_name=first_link.other_node(my_node_name),
                )
            )
        return next_hops

    # -- final assembly (ref SpfSolver.cpp:975-1041) -----------------------

    def _add_best_paths(
        self,
        my_node_name: str,
        prefix: str,
        selection: RouteSelectionResult,
        prefix_entries: PrefixEntries,
        next_hops: set[NextHop],
        shortest_metric: int,
        ucmp_weight: Optional[int],
    ) -> Optional[RibUnicastEntry]:
        if not next_hops:
            return None

        # min-nexthop requirement: max over selected announcers' thresholds
        min_next_hop = None
        for node_area in selection.all_node_areas:
            entry = prefix_entries[node_area]
            if entry.min_nexthop is not None and (
                min_next_hop is None or entry.min_nexthop > min_next_hop
            ):
                min_next_hop = entry.min_nexthop
        if min_next_hop is not None and min_next_hop > len(next_hops):
            return None

        # self-advertised anycast: add static next hops of our prepend label
        if selection.has_node(my_node_name):
            prepend_label = None
            for (node, _), entry in prefix_entries.items():
                if node == my_node_name and entry.prepend_label is not None:
                    prepend_label = entry.prepend_label
                    break
            if prepend_label is not None:
                static = self.static_mpls_routes.get(prepend_label)
                if static is not None:
                    for nh in static.nexthops:
                        next_hops.add(
                            NextHop(address=nh.address, metric=0)
                        )

        best_entry = prefix_entries[selection.best_node_area]
        return RibUnicastEntry(
            prefix=prefix,
            nexthops=frozenset(next_hops),
            best_prefix_entry=best_entry,
            best_node_area=selection.best_node_area,
            igp_cost=shortest_metric,
            ucmp_weight=ucmp_weight,
        )

    # -- UCMP (ref SpfSolver.cpp:1092-1162) --------------------------------

    def _get_node_ucmp_result(
        self,
        my_node_name: str,
        fwd_algo: PrefixForwardingAlgorithm,
        area: str,
        link_state: LinkState,
        prefix_entries: PrefixEntries,
        best_keys: set,
        best_metric: float,
    ) -> Optional[NodeUcmpResult]:
        if not self.enable_ucmp:
            return None
        if fwd_algo not in (
            PrefixForwardingAlgorithm.SP_UCMP_ADJ_WEIGHT_PROPAGATION,
            PrefixForwardingAlgorithm.SP_UCMP_PREFIX_WEIGHT_PROPAGATION,
        ):
            return None
        spf = link_state.get_spf_result(my_node_name)
        dst_weights: dict[str, int] = {}
        for dst_node, dst_area in best_keys:
            if dst_area != area:
                continue
            node = spf.get(dst_node)
            if node is None or node.metric != best_metric:
                continue
            entry = prefix_entries[(dst_node, dst_area)]
            if not entry.weight:
                return None  # a best route without weight disables UCMP
            dst_weights[dst_node] = entry.weight
        use_prefix_weight = (
            fwd_algo
            == PrefixForwardingAlgorithm.SP_UCMP_PREFIX_WEIGHT_PROPAGATION
        )
        if self.ucmp_resolver is not None:
            res = self.ucmp_resolver(
                my_node_name, area, link_state, dst_weights,
                use_prefix_weight,
            )
            if res is not NotImplemented:
                return res
        results = link_state.resolve_ucmp_weights(
            spf, dst_weights, use_prefix_weight=use_prefix_weight
        )
        return results.get(my_node_name)

    # -- MPLS label routes (ref SpfSolver.cpp:501-638) ---------------------

    def _node_label_routes(
        self, my_node_name: str, area_link_states: dict[str, LinkState]
    ) -> dict[int, RibMplsEntry]:
        label_to_node: dict[int, tuple[str, RibMplsEntry]] = {}
        for area, link_state in area_link_states.items():
            for node, adj_db in link_state.get_adjacency_databases().items():
                top_label = adj_db.node_label
                if top_label == 0 or not is_mpls_label_valid(top_label):
                    continue
                prior = label_to_node.get(top_label)
                if prior is not None and prior[0] < node:
                    continue  # label conflict: respect smaller node name
                if node == my_node_name:
                    label_to_node[top_label] = (
                        my_node_name,
                        RibMplsEntry(
                            top_label,
                            frozenset(
                                {
                                    NextHop(
                                        address="::",
                                        area=area,
                                        mpls_action=MplsAction(
                                            MplsActionCode.POP_AND_LOOKUP
                                        ),
                                    )
                                }
                            ),
                        ),
                    )
                    continue
                min_metric, nh_nodes = self.get_next_hops_with_metric(
                    my_node_name, {(node, area)}, False, link_state
                )
                if not nh_nodes:
                    continue
                nhs = self.get_next_hops(
                    my_node_name,
                    {(node, area)},
                    False,
                    False,
                    min_metric,
                    nh_nodes,
                    top_label,
                    area,
                    link_state,
                )
                label_to_node[top_label] = (node, RibMplsEntry(top_label, frozenset(nhs)))
        return {label: entry for label, (_, entry) in label_to_node.items()}

    def _adj_label_routes(
        self, my_node_name: str, area_link_states: dict[str, LinkState]
    ) -> list[RibMplsEntry]:
        out = []
        for _, link_state in area_link_states.items():
            for link in link_state.links_from_node(my_node_name):
                top_label = link.adj_label_from_node(my_node_name)
                if top_label == 0 or not is_mpls_label_valid(top_label):
                    continue
                out.append(
                    RibMplsEntry(
                        top_label,
                        frozenset(
                            {
                                NextHop(
                                    address=link.nh_v6_from_node(my_node_name),
                                    if_name=link.iface_from_node(my_node_name),
                                    metric=link.metric_from_node(my_node_name),
                                    mpls_action=MplsAction(MplsActionCode.PHP),
                                    area=link.area,
                                    neighbor_node_name=link.other_node(my_node_name),
                                )
                            }
                        ),
                    )
                )
        return out
