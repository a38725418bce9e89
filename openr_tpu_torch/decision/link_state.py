"""Per-area link-state graph + shortest-path computation (CPU oracle).

Role of the reference's openr/decision/LinkState.{h,cpp}:
  - Link: bidirectionally-verified edge with per-direction attributes held
    as HoldableValue for rfc6976-style ordered programming (LinkState.h:38-60,
    LinkState.cpp:50-118).
  - LinkState.update_adjacency_database: sorted old/new link diff ->
    LinkStateChange (LinkState.cpp:584-756).
  - run_spf: Dijkstra with ECMP `>=` relaxation accumulating all equal-cost
    path links + root next hops, overloaded-node transit drain
    (LinkState.cpp:836-911).
  - get_spf_result: memoized per (root, use_link_metric), invalidated on
    topology change (LinkState.cpp:821-831, clears at :751-754).
  - get_kth_paths / trace_one_path: k edge-disjoint paths via iterative
    SPF-with-ignored-links + DFS (LinkState.cpp:790-819, 418-439).
  - resolve_ucmp_weights: reverse-Dijkstra weight propagation leaf->root
    (LinkState.cpp:913-1033).

This module is pure logic — no I/O, deterministic for a given set of
adjacency databases — which is exactly what makes the TPU mirror
(ops/csr.py + decision/tpu_solver.py) a legitimate drop-in: both are pure
functions of the same LSDB and are differentially tested against each other.
"""

from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass, field
from typing import Generic, Iterable, Optional, TypeVar

from openr_tpu_torch.types import Adjacency, AdjacencyDatabase

T = TypeVar("T")

# large-but-finite "infinite" hold ttl sentinel would be config; holds count
# in decrement ticks (ref LinkStateMetric holdUpTtl/holdDownTtl)


class HoldableValue(Generic[T]):
    """Value change smoothing for ordered route programming (rfc6976-ish,
    ref LinkState.h:38-60 / LinkState.cpp:50-118).

    An update with a hold ttl keeps reporting the old value for `ttl`
    decrement ticks before switching; "bringing up" changes use hold_up_ttl
    and "bringing down" changes use hold_down_ttl. is_change_bringing_up
    defines which direction counts as up for bool (false->true) and metric
    (higher->lower is "up"; ref LinkState.cpp:88-102).
    """

    def __init__(self, value: T):
        self._value: T = value
        self._pending: Optional[T] = None
        self._ttl = 0

    @property
    def value(self) -> T:
        return self._value

    def has_hold(self) -> bool:
        return self._ttl > 0

    @staticmethod
    def _is_bringing_up(old, new) -> bool:
        if isinstance(old, bool):
            # overload false->true is "down"; true->false is "up"
            return old and not new
        # metric: lowering the metric is "bringing up"
        return new < old

    def update_value(self, new: T, hold_up_ttl: int, hold_down_ttl: int) -> bool:
        """Returns True if the *reported* value changed now."""
        if self._pending is not None:
            if self._pending == new:
                return False  # same pending change, keep waiting
            # changed target while holding: flush previous pending first
            self._value = self._pending
            self._pending = None
            self._ttl = 0
            if self._value == new:
                return True
        if self._value == new:
            return False
        ttl = hold_up_ttl if self._is_bringing_up(self._value, new) else hold_down_ttl
        if ttl > 0:
            self._pending = new
            self._ttl = ttl
            return False
        self._value = new
        return True

    def decrement_ttl(self) -> bool:
        """One hold tick; returns True if the reported value changed."""
        if self._ttl > 0:
            self._ttl -= 1
            if self._ttl == 0 and self._pending is not None:
                self._value = self._pending
                self._pending = None
                return True
        return False


class Link:
    """Bidirectionally-verified link (ref LinkState.h Link). Node endpoints
    ordered so (n1,if1) < (n2,if2) lexicographically for stable sorting."""

    __slots__ = (
        "area",
        "n1",
        "if1",
        "n2",
        "if2",
        "_metric",
        "_overload",
        "_adj_label",
        "_weight",
        "_addr_v4",
        "_addr_v6",
        "_sort_key",
        "_hash",
    )

    def __init__(self, area: str, node1: str, adj1: Adjacency, node2: str, adj2: Adjacency):
        # adj1 is node1's adjacency toward node2 and vice versa
        if (node1, adj1.if_name) > (node2, adj2.if_name):
            node1, adj1, node2, adj2 = node2, adj2, node1, adj1
        self.area = area
        self.n1, self.if1 = node1, adj1.if_name
        self.n2, self.if2 = node2, adj2.if_name
        self._metric = {
            node1: HoldableValue(adj1.metric),
            node2: HoldableValue(adj2.metric),
        }
        self._overload = {
            node1: HoldableValue(adj1.is_overloaded),
            node2: HoldableValue(adj2.is_overloaded),
        }
        self._adj_label = {node1: adj1.adj_label, node2: adj2.adj_label}
        self._weight = {node1: adj1.weight, node2: adj2.weight}
        # next-hop addresses for Fib programming, from each node's
        # perspective = the OTHER end's advertised link address (ref
        # Types.thrift nextHopV6/nextHopV4); emulation adjacencies carry
        # none, so a structural placeholder keeps tests deterministic
        self._addr_v4 = {
            node1: adj1.next_hop_v4,
            node2: adj2.next_hop_v4,
        }
        self._addr_v6 = {
            node1: adj1.next_hop_v6 or f"fe80::{node2}%{adj2.if_name}",
            node2: adj2.next_hop_v6 or f"fe80::{node1}%{adj1.if_name}",
        }
        self._sort_key = (self.n1, self.if1, self.n2, self.if2)
        # cached: Link lives in sets/dicts everywhere (link maps, edge
        # locators, diff sets) — recomputing the tuple hash per lookup
        # cost ~330 ms per 150k operations at fabric scale
        self._hash = hash(self._sort_key)

    # -- identity / ordering ----------------------------------------------

    def __eq__(self, other) -> bool:
        return isinstance(other, Link) and self._sort_key == other._sort_key

    def __lt__(self, other: "Link") -> bool:
        return self._sort_key < other._sort_key

    def __hash__(self) -> int:
        return self._hash

    def __repr__(self) -> str:
        return f"Link({self.area}: {self.n1}%{self.if1} <-> {self.n2}%{self.if2})"

    # -- accessors (ref Link::getXFromNode) --------------------------------

    def other_node(self, node: str) -> str:
        return self.n2 if node == self.n1 else self.n1

    def iface_from_node(self, node: str) -> str:
        return self.if1 if node == self.n1 else self.if2

    def metric_from_node(self, node: str) -> int:
        return self._metric[node].value

    def overload_from_node(self, node: str) -> bool:
        return self._overload[node].value

    def adj_label_from_node(self, node: str) -> int:
        return self._adj_label[node]

    def weight_from_node(self, node: str) -> int:
        return self._weight[node]

    def nh_v6_from_node(self, node: str) -> str:
        """Next-hop address when forwarding *from* node over this link."""
        return self._addr_v6[node]

    def nh_v4_from_node(self, node: str) -> str:
        return self._addr_v4[node]

    def nh_from_node(self, node: str, is_v4: bool) -> str:
        """Family-aware next hop (ref createNextHop: v4 prefixes take
        the v4 address unless v4-over-v6 is configured; missing v4
        falls back to v6)."""
        if is_v4:
            a = self._addr_v4[node]
            if a:
                return a
        return self._addr_v6[node]

    def is_up(self) -> bool:
        """Usable iff neither direction is overloaded (drained)
        (ref Link::isUp)."""
        return not (self._overload[self.n1].value or self._overload[self.n2].value)

    def mirror_fields(self) -> tuple:
        """(metric n1->n2, metric n2->n1, is_up) in one call — the device
        mirror builders (ops/edgeplan.py, ops/csr.py) extract hundreds of
        thousands of directed edges per full build; one bound-method call
        per link instead of five."""
        ov = self._overload
        return (
            self._metric[self.n1].value,
            self._metric[self.n2].value,
            not (ov[self.n1].value or ov[self.n2].value),
        )

    # -- mutators returning topology-changed bool ---------------------------

    def set_metric_from_node(
        self, node: str, metric: int, hold_up: int = 0, hold_down: int = 0
    ) -> bool:
        return self._metric[node].update_value(metric, hold_up, hold_down)

    def set_overload_from_node(
        self, node: str, overloaded: bool, hold_up: int = 0, hold_down: int = 0
    ) -> bool:
        return self._overload[node].update_value(overloaded, hold_up, hold_down)

    def set_adj_label_from_node(self, node: str, label: int) -> None:
        self._adj_label[node] = label

    def set_weight_from_node(self, node: str, weight: int) -> None:
        self._weight[node] = weight

    def decrement_holds(self) -> bool:
        changed = False
        for hv in self._metric.values():
            changed |= hv.decrement_ttl()
        for hv in self._overload.values():
            changed |= hv.decrement_ttl()
        return changed

    def has_holds(self) -> bool:
        return any(hv.has_hold() for hv in self._metric.values()) or any(
            hv.has_hold() for hv in self._overload.values()
        )


@dataclass
class LinkStateChange:
    """ref LinkState.h LinkStateChange."""

    topology_changed: bool = False
    link_attributes_changed: bool = False
    node_label_changed: bool = False
    added_links: list[Link] = field(default_factory=list)

    def __bool__(self) -> bool:
        return (
            self.topology_changed
            or self.link_attributes_changed
            or self.node_label_changed
        )


@dataclass
class PathLink:
    """One reverse-SPF-tree edge: arrived at a node via `link` from
    `prev_node` (ref LinkState.h NodeSpfResult::PathLink)."""

    link: Link
    prev_node: str


class NodeSpfResult:
    """Per-destination SPF result (ref LinkState.h:211-268)."""

    __slots__ = ("_metric", "path_links", "next_hops")

    def __init__(self, metric: int):
        self._metric = metric
        self.path_links: list[PathLink] = []
        self.next_hops: set[str] = set()  # root's neighbors on shortest paths

    @property
    def metric(self) -> int:
        return self._metric

    def reset(self, metric: int) -> None:
        self._metric = metric
        self.path_links.clear()
        self.next_hops.clear()


# SpfResult: destination node name -> NodeSpfResult
SpfResult = dict


class _LazySpfNode:
    """Node view of a LazySpfResult: metric answers from the device
    field; structural fields (next_hops/path_links) force the real host
    Dijkstra once and delegate."""

    __slots__ = ("_owner", "_name")

    def __init__(self, owner: "LazySpfResult", name: str):
        self._owner = owner
        self._name = name

    @property
    def metric(self) -> int:
        return self._owner._metric(self._name)

    @property
    def next_hops(self):
        return self._owner._force()[self._name].next_hops

    @property
    def path_links(self):
        return self._owner._force()[self._name].path_links


class LazySpfResult:
    """SpfResult backed by a device-computed distance field.

    The TPU KSP2 path needs get_spf_result(root) only for membership
    (reachability filter, SpfSolver.cpp:230-244) and metrics (k-path
    traces) — both pure functions of distance values the device already
    computed. This satisfies those from the field with zero host
    Dijkstras, while any consumer needing SPF *structure* (ECMP
    next_hops, path_links, iteration) transparently forces the real
    run_spf and the memo entry replaces itself — correctness never
    depends on who asks."""

    def __init__(self, link_state: "LinkState", root: str,
                 use_link_metric: bool, metric_of):
        self._ls = link_state
        self._root = root
        self._use_link_metric = use_link_metric
        self._metric_of = metric_of  # name -> int | None (unreachable)
        self._real: Optional[SpfResult] = None

    def _metric(self, name: str) -> int:
        if self._real is not None:
            return self._real[name].metric
        m = self._metric_of(name)
        if m is None:
            raise KeyError(name)
        return m

    def _force(self) -> SpfResult:
        if self._real is None:
            self._real = self._ls.run_spf(self._root, self._use_link_metric)
            # replace the memo so later callers skip the lazy wrapper
            self._ls._spf_results[(self._root, self._use_link_metric)] = (
                self._real
            )
        return self._real

    # -- dict-protocol surface used by SpfSolver/LinkState ----------------

    def __contains__(self, name: str) -> bool:
        if self._real is not None:
            return name in self._real
        return self._metric_of(name) is not None

    def get(self, name: str, default=None):
        if self._real is not None:
            return self._real.get(name, default)
        if self._metric_of(name) is None:
            return default
        return _LazySpfNode(self, name)

    def __getitem__(self, name: str):
        node = self.get(name)
        if node is None:
            raise KeyError(name)
        return node

    # structural iteration: force
    def __iter__(self):
        return iter(self._force())

    def __len__(self):
        return len(self._force())

    def keys(self):
        return self._force().keys()

    def values(self):
        return self._force().values()

    def items(self):
        return self._force().items()

# Path: list of Links from src to dst
Path = list


def path_a_in_path_b(a: Path, b: Path) -> bool:
    """True if every link of a appears in b (ref LinkState::pathAInPathB)."""
    return all(any(la == lb for lb in b) for la in a)


class LinkState:
    """One area's link-state graph (ref LinkState.h:185)."""

    def __init__(self, area: str = "0"):
        self.area = area
        self._adj_dbs: dict[str, AdjacencyDatabase] = {}
        self._link_map: dict[str, set[Link]] = {}
        self._all_links: set[Link] = set()
        self._ordered_links: Optional[list[Link]] = None
        self._node_overloads: dict[str, HoldableValue] = {}
        self._node_metric_increments: dict[str, int] = {}
        # memo caches, invalidated on topology change
        self._spf_results: dict[tuple[str, bool], SpfResult] = {}
        self._kth_paths: dict[tuple[str, str, int], list[Path]] = {}
        # Monotonic change counter: bumps on any applied change so derived
        # mirrors (ops/ device arrays) know when to refresh.
        self.generation = 0
        # bumps when a link's next-hop ADDRESS changes in place (no
        # topology change): vantage route caches hold materialized
        # addresses and must rebuild (tpu_solver folds this into its
        # cache key)
        self.nh_addr_version = 0
        # Bounded changelog of (generation, event) consumed by device
        # mirrors to apply LinkStateChange as index writes instead of full
        # rebuilds (SURVEY §5 "delta scatter updates"). Events:
        #   ("links", [Link...])   metric/overload changed on existing links
        #   ("added", [Link...])   new bidirectional links
        #   ("removed", [Link...]) links torn down
        #   ("overload", node)     node-level transit drain toggled
        #   ("nodes",)             node set changed — mirrors must rebuild
        self._changelog: deque[tuple[int, tuple]] = deque(maxlen=4096)
        # history is complete for generations > _changelog_start_gen; a
        # consumer synced at gen <= start must full-rebuild
        self._changelog_start_gen = 0

    def _log_event(self, event: tuple) -> None:
        if len(self._changelog) == self._changelog.maxlen:
            self._changelog_start_gen = self._changelog[0][0]
        self._changelog.append((self.generation + 1, event))

    def events_since(self, generation: int) -> Optional[list[tuple]]:
        """Events after `generation`, or None when history is incomplete
        (consumer fell behind the bounded log — full rebuild required)."""
        if generation < self._changelog_start_gen:
            return None
        return [ev for gen, ev in self._changelog if gen > generation]

    # -- introspection ------------------------------------------------------

    def has_node(self, node: str) -> bool:
        return node in self._adj_dbs

    def node_count(self) -> int:
        return len(self._adj_dbs)

    def node_names(self) -> list[str]:
        return list(self._adj_dbs)

    def get_adjacency_databases(self) -> dict[str, AdjacencyDatabase]:
        return self._adj_dbs

    def links_from_node(self, node: str) -> set[Link]:
        return self._link_map.get(node, set())

    def ordered_links_from_node(self, node: str) -> list[Link]:
        return sorted(self._link_map.get(node, set()))

    def all_links(self) -> set[Link]:
        return self._all_links

    def ordered_all_links(self) -> list[Link]:
        """Deterministically sorted link list, cached until the link SET
        changes (metric churn keeps the order — _sort_key is endpoint
        names + ifaces only). The device mirror builders re-sort every
        full rebuild otherwise (~0.3s at 200k links)."""
        if self._ordered_links is None:
            self._ordered_links = sorted(
                self._all_links, key=lambda l: l._sort_key
            )
        return self._ordered_links

    def mirror_source(self, natural_key) -> tuple:
        """Everything a device-mirror full build extracts from Python
        objects, memoized per generation: (node names natural-sorted,
        name->index dict, n1 indices, n2 indices, [w12, w21, up] int64
        array, ordered links). A second full build at the same
        generation (fresh solver over a live LinkState — daemon
        restart-in-process, any-vantage, sharded fabric) then skips the
        ~1s of per-object attribute walks at 100k nodes; the memo drops
        on any applied change."""
        import numpy as _np

        cached = getattr(self, "_mirror_source", None)
        if cached is not None and cached[0] == self.generation:
            return cached[1]
        names = sorted(self._adj_dbs.keys(), key=natural_key)
        index = {n: i for i, n in enumerate(names)}
        links_sorted = self.ordered_all_links()
        m = len(links_sorted)
        n1i = _np.fromiter(
            (index[l.n1] for l in links_sorted), _np.int32, m
        )
        n2i = _np.fromiter(
            (index[l.n2] for l in links_sorted), _np.int32, m
        )
        trip = (
            _np.array([l.mirror_fields() for l in links_sorted], _np.int64)
            if m
            else _np.empty((0, 3), _np.int64)
        )
        out = (names, index, n1i, n2i, trip, links_sorted)
        self._mirror_source = (self.generation, out)
        return out

    def is_node_overloaded(self, node: str) -> bool:
        hv = self._node_overloads.get(node)
        return hv is not None and hv.value

    def overloaded_nodes(self) -> list[str]:
        """Names with transit drain set — the overload map is sparse, so
        mirror builders scan this instead of asking per node."""
        return [n for n, hv in self._node_overloads.items() if hv.value]

    def node_metric_increment(self, node: str) -> int:
        """Soft-drain metric penalty advertised by the node
        (ref AdjacencyDatabase.nodeMetricIncrementVal)."""
        return self._node_metric_increments.get(node, 0)

    # -- construction / diffing --------------------------------------------

    def _maybe_make_link(self, node: str, adj: Adjacency) -> Optional[Link]:
        """Only create Link if the reverse adjacency exists (bidirectional
        verification, ref LinkState.cpp maybeMakeLink:548)."""
        other_db = self._adj_dbs.get(adj.other_node_name)
        if other_db is None:
            return None
        for other_adj in other_db.adjacencies:
            if (
                other_adj.other_node_name == node
                and adj.other_if_name == other_adj.if_name
                and adj.if_name == other_adj.other_if_name
            ):
                return Link(self.area, node, adj, adj.other_node_name, other_adj)
        return None

    def _ordered_link_set(self, adj_db: AdjacencyDatabase) -> list[Link]:
        links = []
        for adj in adj_db.adjacencies:
            link = self._maybe_make_link(adj_db.this_node_name, adj)
            if link is not None:
                links.append(link)
        links.sort()
        return links

    def _add_link(self, link: Link) -> None:
        self._link_map.setdefault(link.n1, set()).add(link)
        self._link_map.setdefault(link.n2, set()).add(link)
        self._all_links.add(link)
        self._ordered_links = None

    def _remove_link(self, link: Link) -> None:
        self._link_map.get(link.n1, set()).discard(link)
        self._link_map.get(link.n2, set()).discard(link)
        self._all_links.discard(link)
        self._ordered_links = None

    def _remove_node(self, node: str) -> None:
        for link in list(self._link_map.get(node, set())):
            self._remove_link(link)
        self._link_map.pop(node, None)
        self._node_overloads.pop(node, None)
        self._node_metric_increments.pop(node, None)

    def _update_node_overloaded(
        self, node: str, overloaded: bool, hold_up: int, hold_down: int
    ) -> bool:
        if node in self._node_overloads:
            return self._node_overloads[node].update_value(
                overloaded, hold_up, hold_down
            )
        self._node_overloads[node] = HoldableValue(overloaded)
        return False  # new node: not a change (ref LinkState.cpp:503)

    def update_adjacency_database(
        self,
        new_db: AdjacencyDatabase,
        hold_up_ttl: int = 0,
        hold_down_ttl: int = 0,
    ) -> LinkStateChange:
        """Diff old vs new adjacency database of one node
        (ref LinkState.cpp:584-756)."""
        assert new_db.area == self.area, (new_db.area, self.area)
        change = LinkStateChange()
        node = new_db.this_node_name

        prior_db = self._adj_dbs.get(node)
        old_links = self.ordered_links_from_node(node)
        self._adj_dbs[node] = new_db
        new_links = self._ordered_link_set(new_db)
        ev_changed: list[Link] = []
        ev_removed: list[Link] = []

        overload_flip = self._update_node_overloaded(
            node, new_db.is_overloaded, hold_up_ttl, hold_down_ttl
        )
        if overload_flip:
            self._log_event(("overload", node))
        change.topology_changed |= overload_flip
        if prior_db is None:
            self._log_event(("nodes",))
        change.node_label_changed = (
            prior_db is None and new_db.node_label != 0
        ) or (prior_db is not None and prior_db.node_label != new_db.node_label)
        old_incr = self._node_metric_increments.get(node, 0)
        if old_incr != new_db.node_metric_increment:
            self._node_metric_increments[node] = new_db.node_metric_increment
            if prior_db is not None:
                change.topology_changed = True

        i = j = 0
        while i < len(new_links) or j < len(old_links):
            if i < len(new_links) and (
                j >= len(old_links) or new_links[i] < old_links[j]
            ):
                nl = new_links[i]
                # fresh link coming up; may be held down via hold_up_ttl —
                # modeled by marking overload holds is unnecessary: reference
                # applies setHoldUpTtl; here new links simply count as
                # topology change when up
                change.topology_changed |= nl.is_up()
                self._add_link(nl)
                change.added_links.append(nl)
                i += 1
                continue
            if j < len(old_links) and (
                i >= len(new_links) or old_links[j] < new_links[i]
            ):
                ol = old_links[j]
                change.topology_changed |= ol.is_up()
                self._remove_link(ol)
                ev_removed.append(ol)
                j += 1
                continue
            # same link: diff directional attributes from `node`'s side
            nl, ol = new_links[i], old_links[j]
            link_touched = False
            if nl.metric_from_node(node) != ol.metric_from_node(node):
                eff = ol.set_metric_from_node(
                    node, nl.metric_from_node(node), hold_up_ttl, hold_down_ttl
                )
                change.topology_changed |= eff
                link_touched |= eff
            if nl.overload_from_node(node) != ol.overload_from_node(node):
                eff = ol.set_overload_from_node(
                    node, nl.overload_from_node(node), hold_up_ttl, hold_down_ttl
                )
                change.topology_changed |= eff
                link_touched |= eff
            if nl.adj_label_from_node(node) != ol.adj_label_from_node(node):
                change.link_attributes_changed = True
                ol.set_adj_label_from_node(node, nl.adj_label_from_node(node))
            if nl.weight_from_node(node) != ol.weight_from_node(node):
                change.link_attributes_changed = True
                ol.set_weight_from_node(node, nl.weight_from_node(node))
            if (
                nl.nh_v4_from_node(node) != ol.nh_v4_from_node(node)
                or nl.nh_v6_from_node(node) != ol.nh_v6_from_node(node)
            ):
                # neighbor renumbered without the link flapping (e.g.
                # graceful restart): keep forwarding to the LIVE address
                change.link_attributes_changed = True
                ol._addr_v4[node] = nl.nh_v4_from_node(node)
                ol._addr_v6[node] = nl.nh_v6_from_node(node)
                self.nh_addr_version += 1
            if link_touched:
                ev_changed.append(ol)
            i += 1
            j += 1

        if change.added_links:
            self._log_event(("added", list(change.added_links)))
        if ev_removed:
            self._log_event(("removed", ev_removed))
        if ev_changed:
            self._log_event(("links", ev_changed))
        if change.topology_changed:
            self._spf_results.clear()
            self._kth_paths.clear()
        if change or prior_db is None:
            # a first-time adjacency db with no usable links still adds the
            # node (has_node becomes true) — mirrors must refresh for it
            self.generation += 1
        return change

    def delete_adjacency_database(self, node: str) -> LinkStateChange:
        """ref LinkState.cpp:758-775."""
        change = LinkStateChange()
        if node in self._adj_dbs:
            self._log_event(("nodes",))
            self._remove_node(node)
            del self._adj_dbs[node]
            self._spf_results.clear()
            self._kth_paths.clear()
            change.topology_changed = True
            self.generation += 1
        return change

    def decrement_holds(self) -> LinkStateChange:
        change = LinkStateChange()
        hold_changed: list[Link] = []
        for link in self._all_links:
            if link.decrement_holds():
                change.topology_changed = True
                hold_changed.append(link)
        for node, hv in self._node_overloads.items():
            if hv.decrement_ttl():
                change.topology_changed = True
                self._log_event(("overload", node))
        if hold_changed:
            self._log_event(("links", hold_changed))
        if change.topology_changed:
            self._spf_results.clear()
            self._kth_paths.clear()
            self.generation += 1
        return change

    def has_holds(self) -> bool:
        return any(l.has_holds() for l in self._all_links) or any(
            hv.has_hold() for hv in self._node_overloads.values()
        )

    # -- SPF ---------------------------------------------------------------

    def get_spf_result(self, root: str, use_link_metric: bool = True) -> SpfResult:
        """Memoized per (root, use_link_metric) (ref LinkState.cpp:821-831)."""
        key = (root, use_link_metric)
        res = self._spf_results.get(key)
        if res is None:
            res = self.run_spf(root, use_link_metric)
            self._spf_results[key] = res
        return res

    def prime_spf_metrics(
        self, root: str, metric_of, use_link_metric: bool = True
    ) -> None:
        """Install a device-field-backed lazy result into the SPF memo
        (TPU solver: the unmasked KSP2 base field). No-op when a result
        — real or lazy — is already memoized; cleared with the memo on
        any topology change."""
        key = (root, use_link_metric)
        if key not in self._spf_results:
            self._spf_results[key] = LazySpfResult(
                self, root, use_link_metric, metric_of
            )

    def run_spf(
        self,
        root: str,
        use_link_metric: bool = True,
        links_to_ignore: Iterable[Link] = (),
    ) -> SpfResult:
        """Dijkstra with ECMP `>=` relaxation (ref LinkState.cpp:836-911).

        Per-destination result: metric, reverse path links, and the set of
        the *root's* neighbors lying on some shortest path (the next hops).
        Overloaded nodes carry no transit: their adjacencies are not
        relaxed (except for the root itself).
        """
        ignore = set(links_to_ignore)
        result: SpfResult = {}
        pending: dict[str, NodeSpfResult] = {root: NodeSpfResult(0)}
        heap: list[tuple[int, str]] = [(0, root)]
        while heap:
            metric, name = heapq.heappop(heap)
            node_res = pending.get(name)
            if node_res is None or node_res.metric != metric:
                continue  # stale heap entry
            del pending[name]
            result[name] = node_res

            if name != root and self.is_node_overloaded(name):
                continue  # drained: record reachability, no transit
            for link in self._link_map.get(name, ()):
                other = link.other_node(name)
                if not link.is_up() or other in result or link in ignore:
                    continue
                w = link.metric_from_node(name) if use_link_metric else 1
                cand = metric + w
                other_res = pending.get(other)
                if other_res is None:
                    other_res = NodeSpfResult(cand)
                    pending[other] = other_res
                    heapq.heappush(heap, (cand, other))
                if other_res.metric >= cand:
                    if other_res.metric > cand:
                        other_res.reset(cand)
                        heapq.heappush(heap, (cand, other))
                    other_res.path_links.append(PathLink(link, name))
                    other_res.next_hops.update(node_res.next_hops)
                    if not other_res.next_hops:
                        other_res.next_hops.add(other)  # direct neighbor
        return result

    def get_metric_from_a_to_b(
        self, a: str, b: str, use_link_metric: bool = True
    ) -> Optional[int]:
        if a == b:
            return 0
        res = self.get_spf_result(a, use_link_metric)
        node = res.get(b)
        return None if node is None else node.metric

    # -- k edge-disjoint paths (ref LinkState.cpp:790-819) -----------------

    def _trace_one_on_dist(
        self,
        src: str,
        v: str,
        dist_of,
        excluded: set[Link],
        visited: set[Link],
    ) -> Optional[Path]:
        """DFS one src->v path backward over the shortest-path DAG implied
        by a distance field (ref traceOnePath, LinkState.cpp:418-439).

        A link (u, v) is a DAG edge iff dist(u) + w(u->v) == dist(v), the
        link is up and not excluded/consumed, and u may transit (src is
        exempt from its own overload, matching run_spf). Candidates are
        tried in CANONICAL order — (dist(u), u, link key) — so the traced
        paths depend only on the distance VALUES, not on which engine
        produced them: the CPU run_spf field and the TPU batched masked
        SSSP field (ops/ksp2.py) yield identical paths by construction.
        Tried links are consumed even when the branch dead-ends (same
        greedy semantics as the reference)."""
        if v == src:
            return []
        dv = dist_of(v)
        cands = []
        for link in self._link_map.get(v, ()):
            if link in excluded or link in visited or not link.is_up():
                continue
            u = link.other_node(v)
            if u != src and self.is_node_overloaded(u):
                continue
            du = dist_of(u)
            if du is None or du + link.metric_from_node(u) != dv:
                continue
            cands.append((du, u, link._sort_key, link))
        cands.sort()
        for du, u, _key, link in cands:
            visited.add(link)
            path = self._trace_one_on_dist(src, u, dist_of, excluded, visited)
            if path is not None:
                path.append(link)
                return path
        return None

    def trace_paths_on_dist(
        self, src: str, dest: str, dist_of, excluded: set[Link]
    ) -> list[Path]:
        """All greedily-consumable edge-disjoint shortest src->dest paths
        of the DAG implied by a distance field. dist_of(node) -> metric
        or None (unreachable). Shared by get_kth_paths (CPU field) and
        the device-assisted KSP2 second pass (TPU field)."""
        paths: list[Path] = []
        if dist_of(dest) is None:
            return paths
        visited: set[Link] = set()
        while True:
            path = self._trace_one_on_dist(src, dest, dist_of, excluded, visited)
            if not path:
                break
            paths.append(path)
        return paths

    def prime_kth_paths(self, src: str, dest: str, k: int, paths: list) -> None:
        """Install an externally-computed result into the k-paths cache
        (the TPU solver batches the k=2 masked SSSPs on device and primes
        here; SpfSolver then assembles KSP2 routes through the unchanged
        code path). The cache clears on any topology change, like the SPF
        memo."""
        self._kth_paths[(src, dest, k)] = paths

    def kth_paths_ignore_set(self, src: str, dest: str, k: int) -> set[Link]:
        """Union of links on all (k-1)th-and-below paths — what the kth
        SPF pass must exclude."""
        links_to_ignore: set[Link] = set()
        for i in range(1, k):
            for path in self.get_kth_paths(src, dest, i):
                links_to_ignore.update(path)
        return links_to_ignore

    def get_kth_paths(self, src: str, dest: str, k: int) -> list[Path]:
        assert k >= 1
        key = (src, dest, k)
        cached = self._kth_paths.get(key)
        if cached is not None:
            return cached
        links_to_ignore = self.kth_paths_ignore_set(src, dest, k)
        res = (
            self.get_spf_result(src, True)
            if not links_to_ignore
            else self.run_spf(src, True, links_to_ignore)
        )

        def dist_of(n, _res=res):
            node = _res.get(n)
            return None if node is None else node.metric

        paths = self.trace_paths_on_dist(src, dest, dist_of, links_to_ignore)
        self._kth_paths[key] = paths
        return paths

    # -- UCMP weight propagation (ref LinkState.cpp:913-1033) --------------

    def resolve_ucmp_weights(
        self,
        spf_graph: SpfResult,
        leaf_node_weights: dict[str, int],
        use_prefix_weight: bool,
        use_link_metric: bool = True,
    ) -> dict[str, "NodeUcmpResult"]:
        """Walk the SPF DAG leaf->root accumulating advertised weights.

        use_prefix_weight selects SP_UCMP_PREFIX_WEIGHT_PROPAGATION (sum of
        next-hop prefix weights) vs SP_UCMP_ADJ_WEIGHT_PROPAGATION (sum of
        next-hop link weights). All leaves must be equidistant from the SPF
        root or the resolution is skipped (returns {}).
        """
        result: dict[str, NodeUcmpResult] = {}
        pending: dict[str, NodeUcmpResult] = {}
        heap: list[tuple[int, str]] = []
        spf_metric: Optional[int] = None
        for leaf, weight in leaf_node_weights.items():
            node = spf_graph.get(leaf)
            if node is None:
                continue
            if spf_metric is None:
                spf_metric = node.metric
            elif spf_metric != node.metric:
                return {}  # leaves not equidistant: skip UCMP
            r = NodeUcmpResult(0)
            r.weight = weight
            pending[leaf] = r
            heapq.heappush(heap, (0, leaf))

        while heap:
            metric, name = heapq.heappop(heap)
            curr = pending.get(name)
            if curr is None or curr.metric != metric:
                continue
            del pending[name]

            if curr.weight is None:
                advertised = 0
                for iface, nh in curr.next_hop_links.items():
                    if use_prefix_weight:
                        advertised += nh.weight
                    else:
                        advertised += nh.link.weight_from_node(name)
                curr.weight = advertised

            for path_link in spf_graph[name].path_links:
                w = (
                    path_link.link.metric_from_node(path_link.prev_node)
                    if use_link_metric
                    else 1
                )
                prev = pending.get(path_link.prev_node)
                if prev is None:
                    prev = NodeUcmpResult(metric + w)
                    pending[path_link.prev_node] = prev
                    heapq.heappush(heap, (metric + w, path_link.prev_node))
                iface = path_link.link.iface_from_node(path_link.prev_node)
                prev.add_next_hop_link(iface, path_link.link, name, curr.weight)

            curr.normalize_next_hop_weights()
            result[name] = curr
        return result


@dataclass
class UcmpNextHopLink:
    link: Link
    next_node: str
    weight: int


class NodeUcmpResult:
    """ref LinkState.h:275-335 NodeUcmpResult."""

    __slots__ = ("metric", "weight", "next_hop_links")

    def __init__(self, metric: int):
        self.metric = metric
        self.weight: Optional[int] = None
        self.next_hop_links: dict[str, UcmpNextHopLink] = {}

    def add_next_hop_link(
        self, iface: str, link: Link, next_node: str, weight: int
    ) -> None:
        existing = self.next_hop_links.get(iface)
        if existing is None:
            self.next_hop_links[iface] = UcmpNextHopLink(link, next_node, weight)
        else:
            existing.weight += weight

    def normalize_next_hop_weights(self) -> None:
        """gcd-normalize weights (ref LinkState.cpp normalizeNextHopWeights)."""
        import math

        weights = [nh.weight for nh in self.next_hop_links.values() if nh.weight > 0]
        if not weights:
            return
        g = 0
        for w in weights:
            g = math.gcd(g, w)
        if g > 1:
            for nh in self.next_hop_links.values():
                nh.weight //= g
