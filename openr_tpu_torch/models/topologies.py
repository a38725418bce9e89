"""Topology generators shared by tests and benchmarks.

Role of the reference's openr/decision/tests/RoutingBenchmarkUtils.{h,cpp}:
grid (createGrid:308), fat-tree fabric (createFabric:361 with
kNumOfSswsPerPlane=36, kNumOfRswsPerPod=48 markers, :93-99), plus ring and
full-mesh used by the system tests (openr/tests/OpenrSystemTest.cpp).

Each generator returns (adj_dbs, prefix_dbs):
  adj_dbs:    list[AdjacencyDatabase] — one per node, bidirectional pairs
  prefix_dbs: list[PrefixDatabase]    — one per (node, prefix) key

These feed LinkState/PrefixState directly, the Decision actor via synthetic
KvStore publications, and the CSR mirror for the TPU solver — one source of
truth for every layer's test input.
"""

from __future__ import annotations

import random

from openr_tpu_torch.types import (
    Adjacency,
    AdjacencyDatabase,
    PrefixDatabase,
    PrefixEntry,
    PrefixForwardingAlgorithm,
    PrefixForwardingType,
    PrefixType,
)


def build_states(adj_dbs, prefix_dbs):
    """Materialize (area -> LinkState, PrefixState) from generator output —
    the direct-injection path used by solver tests and bench.py (the Decision
    actor builds the same states from KvStore publications)."""
    from openr_tpu_torch.decision.link_state import LinkState
    from openr_tpu_torch.decision.prefix_state import PrefixState

    link_states: dict[str, LinkState] = {}
    for db in adj_dbs:
        link_states.setdefault(db.area, LinkState(db.area)).update_adjacency_database(db)
    prefix_state = PrefixState()
    for db in prefix_dbs:
        prefix_state.update_prefix_database(db)
    return link_states, prefix_state


def _adj(me: str, other: str, metric: int = 1, weight: int = 1) -> Adjacency:
    return Adjacency(
        other_node_name=other,
        if_name=f"if-{me}-{other}",
        other_if_name=f"if-{other}-{me}",
        metric=metric,
        weight=weight,
    )


def _loopback_prefix(node_idx: int, v4: bool = False) -> str:
    if v4:
        return f"10.{(node_idx >> 16) & 0xFF}.{(node_idx >> 8) & 0xFF}.{node_idx & 0xFF}/32"
    hi, lo = node_idx >> 16, node_idx & 0xFFFF
    return f"fd00::{hi:x}:{lo:x}/128" if hi else f"fd00::{lo:x}/128"


def _mk_dbs(
    nodes: dict[str, list[Adjacency]],
    area: str,
    forwarding_algorithm: PrefixForwardingAlgorithm,
    node_labels: bool,
    prefixes_per_node: int = 1,
    ksp2_every: int = 0,
) -> tuple[list[AdjacencyDatabase], list[PrefixDatabase]]:
    """ksp2_every > 0 marks every Nth node's prefixes SR_MPLS +
    KSP2_ED_ECMP (a segment-routed subset over a plain-IP fabric —
    BASELINE config 4's shape); it implies node labels (label stacks
    need them)."""
    if ksp2_every:
        node_labels = True

    def algo_for(idx: int):
        if ksp2_every and idx % ksp2_every == 0:
            return (
                PrefixForwardingType.SR_MPLS,
                PrefixForwardingAlgorithm.KSP2_ED_ECMP,
            )
        if forwarding_algorithm == PrefixForwardingAlgorithm.KSP2_ED_ECMP:
            return (PrefixForwardingType.SR_MPLS, forwarding_algorithm)
        return (PrefixForwardingType.IP, forwarding_algorithm)

    adj_dbs = []
    prefix_dbs = []
    for idx, (name, adjs) in enumerate(nodes.items()):
        adj_dbs.append(
            AdjacencyDatabase(
                this_node_name=name,
                adjacencies=tuple(adjs),
                node_label=(101 + idx) if node_labels else 0,
                area=area,
            )
        )
        fwd_type, fwd_algo = algo_for(idx)
        for p in range(prefixes_per_node):
            prefix = _loopback_prefix(idx * prefixes_per_node + p + 1)
            prefix_dbs.append(
                PrefixDatabase(
                    this_node_name=name,
                    prefix_entries=(
                        PrefixEntry(
                            prefix=prefix,
                            type=PrefixType.LOOPBACK,
                            forwarding_type=fwd_type,
                            forwarding_algorithm=fwd_algo,
                        ),
                    ),
                    area=area,
                )
            )
    return adj_dbs, prefix_dbs


def grid(
    n: int,
    area: str = "0",
    forwarding_algorithm: PrefixForwardingAlgorithm = PrefixForwardingAlgorithm.SP_ECMP,
    node_labels: bool = True,
    prefixes_per_node: int = 1,
) -> tuple[list[AdjacencyDatabase], list[PrefixDatabase]]:
    """n x n grid (ref createGrid:308): node-(row,col) connects 4-ways."""
    nodes: dict[str, list[Adjacency]] = {}
    name = lambda r, c: f"node-{r}-{c}"  # noqa: E731
    for r in range(n):
        for c in range(n):
            adjs = []
            for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                rr, cc = r + dr, c + dc
                if 0 <= rr < n and 0 <= cc < n:
                    adjs.append(_adj(name(r, c), name(rr, cc)))
            nodes[name(r, c)] = adjs
    return _mk_dbs(nodes, area, forwarding_algorithm, node_labels, prefixes_per_node)


def ring(
    n: int,
    area: str = "0",
    forwarding_algorithm: PrefixForwardingAlgorithm = PrefixForwardingAlgorithm.SP_ECMP,
    node_labels: bool = True,
) -> tuple[list[AdjacencyDatabase], list[PrefixDatabase]]:
    """Ring of n nodes (ref OpenrSystemTest RingTopology)."""
    nodes: dict[str, list[Adjacency]] = {}
    name = lambda i: f"node-{i}"  # noqa: E731
    for i in range(n):
        nodes[name(i)] = [
            _adj(name(i), name((i - 1) % n)),
            _adj(name(i), name((i + 1) % n)),
        ]
    if n == 2:  # avoid duplicate parallel links in a 2-ring
        nodes[name(0)] = [_adj(name(0), name(1))]
        nodes[name(1)] = [_adj(name(1), name(0))]
    return _mk_dbs(nodes, area, forwarding_algorithm, node_labels)


def full_mesh(
    n: int,
    area: str = "0",
    forwarding_algorithm: PrefixForwardingAlgorithm = PrefixForwardingAlgorithm.SP_ECMP,
    node_labels: bool = True,
) -> tuple[list[AdjacencyDatabase], list[PrefixDatabase]]:
    """Every node adjacent to every other (BASELINE config 1's 4-node mesh)."""
    nodes: dict[str, list[Adjacency]] = {}
    name = lambda i: f"node-{i}"  # noqa: E731
    for i in range(n):
        nodes[name(i)] = [_adj(name(i), name(j)) for j in range(n) if j != i]
    return _mk_dbs(nodes, area, forwarding_algorithm, node_labels)


def fat_tree(
    pods: int = 2,
    planes: int = 2,
    ssws_per_plane: int = 4,
    fsws_per_pod: int = 2,
    rsws_per_pod: int = 4,
    area: str = "0",
    forwarding_algorithm: PrefixForwardingAlgorithm = PrefixForwardingAlgorithm.SP_ECMP,
    node_labels: bool = True,
) -> tuple[list[AdjacencyDatabase], list[PrefixDatabase]]:
    """3-tier fabric (ref createFabric:361): ssw (spine, per plane) <-> fsw
    (fabric, per pod; fsw #p in a pod belongs to plane p) <-> rsw (rack).
    Reference production markers: 36 ssw/plane, 48 rsw/pod
    (RoutingBenchmarkUtils.h:93-99) — pass those for the big benchmark.
    """
    assert fsws_per_pod == planes or planes == 1, (
        "each pod needs one fsw per plane (fsws_per_pod == planes)"
    )
    nodes: dict[str, list[Adjacency]] = {}
    ssw = lambda pl, i: f"ssw-{pl}-{i}"  # noqa: E731
    fsw = lambda pod, pl: f"fsw-{pod}-{pl}"  # noqa: E731
    rsw = lambda pod, i: f"rsw-{pod}-{i}"  # noqa: E731

    for pl in range(planes):
        for i in range(ssws_per_plane):
            nodes[ssw(pl, i)] = [_adj(ssw(pl, i), fsw(pod, pl)) for pod in range(pods)]
    for pod in range(pods):
        for pl in range(planes):
            adjs = [_adj(fsw(pod, pl), ssw(pl, i)) for i in range(ssws_per_plane)]
            adjs += [_adj(fsw(pod, pl), rsw(pod, i)) for i in range(rsws_per_pod)]
            nodes[fsw(pod, pl)] = adjs
        for i in range(rsws_per_pod):
            nodes[rsw(pod, i)] = [
                _adj(rsw(pod, i), fsw(pod, pl)) for pl in range(planes)
            ]
    return _mk_dbs(nodes, area, forwarding_algorithm, node_labels)


def fabric(
    pods: int = 96,
    planes: int = 8,
    ssws_per_plane: int = 36,
    rsws_per_pod: int = 64,
    area: str = "0",
    forwarding_algorithm: PrefixForwardingAlgorithm = PrefixForwardingAlgorithm.SP_ECMP,
    node_labels: bool = False,
    prefixes_per_node: int = 1,
) -> tuple[list[AdjacencyDatabase], list[PrefixDatabase]]:
    """Large 3-tier fabric for benchmarks (BASELINE config 3), pod-major
    node naming so natural-sort index order keeps pods contiguous: the
    rsw<->fsw tier decomposes into shift classes on the device mirror
    (ops/edgeplan.py), the pod-crossing spine tier lands in the compact
    residual. Structure follows the reference fabric markers
    (RoutingBenchmarkUtils.h:93-99: ssw/plane, rsw/pod); one fsw per
    plane per pod."""
    nodes: dict[str, list[Adjacency]] = {}
    fsw = lambda pod, pl: f"pod{pod:03d}-fsw{pl:02d}"  # noqa: E731
    rsw = lambda pod, i: f"pod{pod:03d}-rsw{i:02d}"  # noqa: E731
    ssw = lambda pl, s: f"zspine{pl:02d}-ssw{s:02d}"  # noqa: E731

    for pod in range(pods):
        for pl in range(planes):
            adjs = [_adj(fsw(pod, pl), ssw(pl, s)) for s in range(ssws_per_plane)]
            adjs += [_adj(fsw(pod, pl), rsw(pod, i)) for i in range(rsws_per_pod)]
            nodes[fsw(pod, pl)] = adjs
        for i in range(rsws_per_pod):
            nodes[rsw(pod, i)] = [
                _adj(rsw(pod, i), fsw(pod, pl)) for pl in range(planes)
            ]
    for pl in range(planes):
        for s in range(ssws_per_plane):
            nodes[ssw(pl, s)] = [
                _adj(ssw(pl, s), fsw(pod, pl)) for pod in range(pods)
            ]
    return _mk_dbs(
        nodes, area, forwarding_algorithm, node_labels, prefixes_per_node
    )


def wan(
    regions: int = 48,
    region_side: int = 32,
    hub_links: int = 3,
    seed: int = 7,
    area: str = "0",
    forwarding_algorithm: PrefixForwardingAlgorithm = PrefixForwardingAlgorithm.SP_ECMP,
    node_labels: bool = False,
    ksp2_every: int = 0,
) -> tuple[list[AdjacencyDatabase], list[PrefixDatabase]]:
    """Multi-region WAN for benchmarks (BASELINE config 4): each region is
    a metro grid (region-major naming keeps intra-region edges in shared
    shift classes); per-region hub routers interconnect over a region ring
    plus random chords with higher metrics (long-haul)."""
    rng = random.Random(seed)
    nodes: dict[str, list[Adjacency]] = {}
    name = lambda g, r, c: f"r{g:02d}-n{r:02d}-{c:02d}"  # noqa: E731
    for g in range(regions):
        for r in range(region_side):
            for c in range(region_side):
                adjs = []
                for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                    rr, cc = r + dr, c + dc
                    if 0 <= rr < region_side and 0 <= cc < region_side:
                        adjs.append(_adj(name(g, r, c), name(g, rr, cc)))
                nodes[name(g, r, c)] = adjs
    # inter-region: hubs at the region center; ring + chords
    mid = region_side // 2
    hub = lambda g: name(g, mid, mid)  # noqa: E731
    pairs = {
        (min(g, (g + 1) % regions), max(g, (g + 1) % regions))
        for g in range(regions)
    }
    # target bounded by the number of distinct hub pairs, else few-region
    # configs loop forever asking for more chords than exist
    target = min(regions * hub_links // 2, regions * (regions - 1) // 2)
    while len(pairs) < target:
        a, b = rng.randrange(regions), rng.randrange(regions)
        if a != b:
            pairs.add((min(a, b), max(a, b)))
    for a, b in pairs:
        metric = rng.randint(10, 100)
        nodes[hub(a)].append(_adj(hub(a), hub(b), metric=metric))
        nodes[hub(b)].append(_adj(hub(b), hub(a), metric=metric))
    return _mk_dbs(
        nodes, area, forwarding_algorithm, node_labels, ksp2_every=ksp2_every
    )


def random_mesh(
    n: int,
    avg_degree: int = 4,
    seed: int = 0,
    area: str = "0",
    forwarding_algorithm: PrefixForwardingAlgorithm = PrefixForwardingAlgorithm.SP_ECMP,
    node_labels: bool = False,
) -> tuple[list[AdjacencyDatabase], list[PrefixDatabase]]:
    """Connected random graph (Terragraph-style wireless mesh stand-in,
    BASELINE config 2): ring backbone + random chords to reach avg_degree."""
    rng = random.Random(seed)
    name = lambda i: f"node-{i}"  # noqa: E731
    edges: set[tuple[int, int]] = set()
    for i in range(n):
        edges.add((min(i, (i + 1) % n), max(i, (i + 1) % n)))
    target_edges = n * avg_degree // 2
    while len(edges) < target_edges:
        a, b = rng.randrange(n), rng.randrange(n)
        if a != b:
            edges.add((min(a, b), max(a, b)))
    adjacency: dict[int, list[int]] = {i: [] for i in range(n)}
    for a, b in edges:
        adjacency[a].append(b)
        adjacency[b].append(a)
    nodes = {
        name(i): [_adj(name(i), name(j), metric=1) for j in sorted(neighbors)]
        for i, neighbors in adjacency.items()
    }
    return _mk_dbs(nodes, area, forwarding_algorithm, node_labels)


def multi_area(
    regions: int = 3,
    side: int = 4,
    backbone_area: str = "bb",
    forwarding_algorithm: PrefixForwardingAlgorithm = PrefixForwardingAlgorithm.SP_ECMP,
) -> tuple[list[AdjacencyDatabase], list[PrefixDatabase]]:
    """Multi-area topology (ref openr/docs/Features/Area.md; per-area
    KvStoreDb/LinkState): each region is its own flooding domain (area
    "r<i>") of a side x side grid; the region hubs additionally belong
    to a backbone area ring. Hub nodes therefore carry TWO adjacency
    databases (one per area) — the shape Decision's per-area LinkState
    map models. Loopbacks announce in the node's region area; hubs also
    announce a backbone-scoped prefix in the backbone area."""
    adj_dbs: list[AdjacencyDatabase] = []
    prefix_dbs: list[PrefixDatabase] = []
    name = lambda g, r, c: f"r{g:02d}-n{r:02d}-{c:02d}"  # noqa: E731
    mid = side // 2
    hub = lambda g: name(g, mid, mid)  # noqa: E731

    idx = 0
    for g in range(regions):
        area = f"r{g}"
        for r in range(side):
            for c in range(side):
                adjs = []
                for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                    rr, cc = r + dr, c + dc
                    if 0 <= rr < side and 0 <= cc < side:
                        adjs.append(_adj(name(g, r, c), name(g, rr, cc)))
                idx += 1
                adj_dbs.append(
                    AdjacencyDatabase(
                        this_node_name=name(g, r, c),
                        adjacencies=tuple(adjs),
                        node_label=100 + idx,
                        area=area,
                    )
                )
                prefix_dbs.append(
                    PrefixDatabase(
                        this_node_name=name(g, r, c),
                        prefix_entries=(
                            PrefixEntry(
                                prefix=_loopback_prefix(idx),
                                type=PrefixType.LOOPBACK,
                                forwarding_type=PrefixForwardingType.IP,
                                forwarding_algorithm=forwarding_algorithm,
                            ),
                        ),
                        area=area,
                    )
                )
    # backbone: hub ring with long-haul metrics + hub backbone prefixes
    for g in range(regions):
        nbrs = []
        for other in ((g - 1) % regions, (g + 1) % regions):
            if other != g:
                nbrs.append(_adj(hub(g), hub(other), metric=10))
        adj_dbs.append(
            AdjacencyDatabase(
                this_node_name=hub(g),
                adjacencies=tuple(dict.fromkeys(nbrs)),
                node_label=5000 + g,
                area=backbone_area,
            )
        )
        prefix_dbs.append(
            PrefixDatabase(
                this_node_name=hub(g),
                prefix_entries=(
                    PrefixEntry(
                        prefix=f"fd00:bb::{g:x}/128",
                        type=PrefixType.LOOPBACK,
                        forwarding_type=PrefixForwardingType.IP,
                        forwarding_algorithm=forwarding_algorithm,
                    ),
                ),
                area=backbone_area,
            )
        )
    return adj_dbs, prefix_dbs
