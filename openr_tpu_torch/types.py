"""Link-state message types the Decision solve reads.

The subset of the OpenR schema the route computation touches:
adjacency / prefix link-state types (openr/if/Types.thrift Adjacency:98,
AdjacencyDatabase:175, PrefixEntry:380, PrefixDatabase:461) and perf
events (Types.thrift:53-75). decision/rib.py holds the RIB value types.
"""

from __future__ import annotations

import enum
import ipaddress
import time
from dataclasses import dataclass, field, replace  # noqa: F401  (replace re-exported)
from typing import Optional


# ---------------------------------------------------------------------------
# Network primitives
# ---------------------------------------------------------------------------

def parse_prefix(s: str) -> ipaddress._BaseNetwork:
    return ipaddress.ip_network(s, strict=False)


# ---------------------------------------------------------------------------
# Link-state types (ref Types.thrift)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Adjacency:
    """One directed adjacency advertisement (ref Types.thrift:98-173)."""

    other_node_name: str
    if_name: str
    other_if_name: str = ""
    metric: int = 1
    adj_label: int = 0
    is_overloaded: bool = False
    rtt_us: int = 0
    timestamp_s: int = 0
    # the NEIGHBOR's link addresses — the next hop when forwarding over
    # this adjacency (ref Types.thrift:104-110 nextHopV6/nextHopV4);
    # learned from the Spark handshake's kernel source address
    next_hop_v6: str = ""
    next_hop_v4: str = ""
    weight: int = 1  # UCMP weight of this adj (ref Types.thrift:158)
    # Two-stage cold-boot insertion: adjacency only usable by the *other*
    # node until the restarting node has programmed routes
    # (ref Types.thrift:166, Decision.cpp:567-644).
    adj_only_used_by_other_node: bool = False


@dataclass(frozen=True)
class AdjacencyDatabase:
    """All adjacencies of one node in one area (ref Types.thrift:175-221)."""

    this_node_name: str
    adjacencies: tuple[Adjacency, ...] = ()
    is_overloaded: bool = False  # node drained: no transit traffic
    node_label: int = 0  # segment-routing node label
    area: str = "0"
    # Distinguish a node that is up with no adjacencies from a withdrawal.
    node_metric_increment: int = 0  # soft-drain metric penalty (ref :216)


class PrefixForwardingType(enum.IntEnum):
    """ref Types.thrift:18-27 (OpenrConfig.thrift PrefixForwardingType)."""

    IP = 0
    SR_MPLS = 1


class PrefixForwardingAlgorithm(enum.IntEnum):
    """ref OpenrConfig.thrift:25 — per-prefix route computation algorithm."""

    SP_ECMP = 0
    KSP2_ED_ECMP = 1
    SP_UCMP_ADJ_WEIGHT_PROPAGATION = 3
    SP_UCMP_PREFIX_WEIGHT_PROPAGATION = 4


class PrefixType(enum.IntEnum):
    """Origin of a prefix advertisement (ref Network.thrift PrefixType)."""

    LOOPBACK = 1
    DEFAULT = 2
    BGP = 3
    PREFIX_ALLOCATOR = 4
    BREEZE = 5
    CONFIG = 6
    VIP = 7
    RIB = 8


@dataclass(frozen=True)
class PrefixMetrics:
    """Ranked route-selection metrics, higher wins except distance
    (ref Types.thrift:239-286, compared in SpfSolver.cpp:648-769)."""

    path_preference: int = 1000
    source_preference: int = 100
    # Advertised inter-area hop distance, bumped by PrefixManager on
    # cross-area redistribution; SHORTEST_DISTANCE selection minimizes it
    # (ref Types.thrift:364, LsdbUtil.cpp selectShortestDistance).
    distance: int = 0
    drain_metric: int = 0  # advertised by soft-drained nodes, lower wins


@dataclass(frozen=True)
class PrefixEntry:
    """One prefix advertisement by one node (ref Types.thrift:380-459)."""

    prefix: str  # canonical CIDR string
    type: PrefixType = PrefixType.LOOPBACK
    metrics: PrefixMetrics = field(default_factory=PrefixMetrics)
    forwarding_type: PrefixForwardingType = PrefixForwardingType.IP
    forwarding_algorithm: PrefixForwardingAlgorithm = (
        PrefixForwardingAlgorithm.SP_ECMP
    )
    min_nexthop: Optional[int] = None  # drop route if fewer NHs (ref :422)
    prepend_label: Optional[int] = None  # extra MPLS label to push (ref :432)
    weight: Optional[int] = None  # UCMP prefix weight (ref :457)
    tags: tuple[str, ...] = ()
    area_stack: tuple[str, ...] = ()

    def network(self):
        return parse_prefix(self.prefix)


@dataclass(frozen=True)
class PrefixDatabase:
    """All prefixes of one node in one area (ref Types.thrift:461-480).

    The reference advertises per-prefix keys (`prefix:<node>:<area>:<pfx>`,
    LsdbTypes.h:411 PrefixKey); each such key carries a PrefixDatabase with a
    single entry and the deletePrefix tombstone flag.
    """

    this_node_name: str
    prefix_entries: tuple[PrefixEntry, ...] = ()
    area: str = "0"
    delete_prefix: bool = False


# ---------------------------------------------------------------------------
# KvStore types (ref KvStore.thrift)
# ---------------------------------------------------------------------------


@dataclass
class PerfEvent:
    node_name: str
    event_descr: str
    unix_ts_ms: int


@dataclass
class PerfEvents:
    events: list[PerfEvent] = field(default_factory=list)


def add_perf_event(perf: PerfEvents, node: str, descr: str) -> None:
    perf.events.append(PerfEvent(node, descr, int(time.time() * 1000)))


def total_perf_duration_ms(perf: PerfEvents) -> int:
    if len(perf.events) < 2:
        return 0
    return perf.events[-1].unix_ts_ms - perf.events[0].unix_ts_ms
