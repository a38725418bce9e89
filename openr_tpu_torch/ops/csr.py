"""Device-resident mirror of a LinkState graph.

Role in the architecture (SURVEY §7 step 3): the TPU solver does not walk
the host Link/adjacency objects — it operates on a padded array mirror
rebuilt (or delta-updated) from LinkState whenever Decision applies a
publication. This module owns that mirror.

Format: padded in-neighbor lists (ELL), not classic CSR index arrays.
The SSSP relaxation step

    dist'[v] = min(dist[v], min_k dist[in_nbr[v, k]] + in_w[v, k])

is then a dense gather + min-reduce over a static [N_cap, K_cap] array —
no scatter — which is the shape XLA tiles well onto the TPU VPU. (A
scatter-based segment-min over true CSR arrays is the GPU-idiomatic
formulation; on TPU scatters serialize, so we trade padding memory for
vectorization. Classic CSR arrays are also kept for out-edge enumeration
on the host side.)

Capacity classes: N_cap/K_cap/E_cap round up to the next power of two so
topology churn reuses compiled kernels instead of recompiling per node
count (SURVEY §7 hard part 3: dynamic topology in static shapes).

Mirrors the graph semantics of openr/decision/LinkState.h:185:
per-direction metrics, link up = neither side overloaded, node overload
(transit drain), and the root's out-edge table used for first-hop ("next
hop") extraction matching runSpf's accumulation (LinkState.cpp:885-901).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from openr_tpu_torch.decision.link_state import Link, LinkState

INF32 = np.int32(2**30)  # effectively-infinite metric, addition-safe


def _next_pow2(n: int, floor: int = 8) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


@dataclass
class EllGraph:
    """Host (numpy) padded-in-neighbor mirror; ship to device as-is."""

    n_nodes: int  # real node count (<= n_cap)
    n_cap: int
    k_cap: int  # padded max in-degree
    # [n_cap, k_cap]; in_nbr -1 = padding slot
    in_nbr: np.ndarray  # int32
    in_w: np.ndarray  # int32 (metric of edge in_nbr[v,k] -> v)
    in_up: np.ndarray  # bool  (link is up)
    node_overloaded: np.ndarray  # bool [n_cap]
    node_valid: np.ndarray  # bool [n_cap]
    # node index <-> name
    node_names: list  # idx -> name
    node_index: dict  # name -> idx
    # directed edge arrays (srcs/dsts/ws/ups aligned with edge_links) for
    # on-demand out-edge table extraction
    edge_src: np.ndarray  # int32 [E]
    edge_dst: np.ndarray  # int32 [E]
    edge_w: np.ndarray  # int32 [E]
    edge_up: np.ndarray  # bool [E]
    edge_links: list  # [E] Link refs (host materialization)
    # bumped only when the node name -> index mapping changes; derived
    # structures keyed on node indices (the prefix announcer matrix) stay
    # valid across metric/link churn that preserves the node set
    index_version: int = 0

    def out_table(self, root_idx: int, d_cap: Optional[int] = None):
        """Root's out-edge slot arrays for next-hop extraction:
        (nbr[d_cap], w[d_cap], up[d_cap], links list). Slot order is the
        deterministic sorted-Link order (edge arrays are built sorted)."""
        eids = np.flatnonzero(self.edge_src == root_idx)
        d_cap = d_cap or _next_pow2(max(len(eids), 1), floor=4)
        nbr = np.full(d_cap, -1, np.int32)
        w = np.full(d_cap, INF32, np.int32)
        up = np.zeros(d_cap, bool)
        eids = eids[:d_cap]
        n_out = len(eids)
        nbr[:n_out] = self.edge_dst[eids]
        w[:n_out] = self.edge_w[eids]
        up[:n_out] = self.edge_up[eids]
        links = [self.edge_links[e] for e in eids]
        return nbr, w, up, links


def build_ell(
    link_state: LinkState,
    n_cap: int = 0,
    k_cap: int = 0,
    prev: Optional[EllGraph] = None,
) -> EllGraph:
    """Mirror a LinkState into padded arrays (full rebuild path).

    The per-edge extraction is one Python pass over sorted links; the
    padded-array fill is fully vectorized (stable sort by destination +
    per-group slot offsets) — no per-edge numpy scalar writes. `prev`
    carries capacity floors and the index_version continuity."""
    names = sorted(link_state.get_adjacency_databases().keys())
    index = {n: i for i, n in enumerate(names)}
    n = len(names)
    if prev is not None:
        n_cap = max(n_cap, prev.n_cap)
        k_cap = max(k_cap, prev.k_cap)
    n_cap = max(n_cap, _next_pow2(n))

    # directed edge lists (u -> v with metric from u's side); one tight pass
    srcs: list[int] = []
    dsts: list[int] = []
    ws: list[int] = []
    ups: list[bool] = []
    edge_links: list[Link] = []
    s_app, d_app, w_app, u_app, l_app = (
        srcs.append, dsts.append, ws.append, ups.append, edge_links.append
    )
    for link in link_state.ordered_all_links():
        w1, w2, up = link.mirror_fields()
        i1, i2 = index[link.n1], index[link.n2]
        s_app(i1); d_app(i2); w_app(w1); u_app(up); l_app(link)
        s_app(i2); d_app(i1); w_app(w2); u_app(up); l_app(link)

    e = len(srcs)
    src_a = np.asarray(srcs, np.int32)
    dst_a = np.asarray(dsts, np.int32)
    w_a = np.asarray(ws, np.int32)
    up_a = np.asarray(ups, bool)

    if e:
        in_deg = np.bincount(dst_a, minlength=n_cap)
        k = int(in_deg.max())
    else:
        k = 0
    k_cap = max(k_cap, _next_pow2(max(k, 1), floor=4))

    in_nbr = np.full((n_cap, k_cap), -1, np.int32)
    in_w = np.full((n_cap, k_cap), INF32, np.int32)
    in_up = np.zeros((n_cap, k_cap), bool)
    if e:
        order = np.argsort(dst_a, kind="stable")
        sd = dst_a[order]
        # slot index within each destination group
        first = np.r_[0, np.flatnonzero(np.diff(sd)) + 1]
        counts = np.diff(np.r_[first, e])
        slots = np.arange(e) - np.repeat(first, counts)
        in_nbr[sd, slots] = src_a[order]
        in_w[sd, slots] = w_a[order]
        in_up[sd, slots] = up_a[order]

    node_overloaded = np.zeros(n_cap, bool)
    node_valid = np.zeros(n_cap, bool)
    node_valid[:n] = True
    overload = link_state.is_node_overloaded
    for i, name in enumerate(names):
        node_overloaded[i] = overload(name)

    index_version = 0
    if prev is not None:
        index_version = (
            prev.index_version
            if prev.node_names == names
            else prev.index_version + 1
        )

    return EllGraph(
        n_nodes=n,
        n_cap=n_cap,
        k_cap=k_cap,
        in_nbr=in_nbr,
        in_w=in_w,
        in_up=in_up,
        node_overloaded=node_overloaded,
        node_valid=node_valid,
        node_names=names,
        node_index=index,
        edge_src=src_a,
        edge_dst=dst_a,
        edge_w=w_a,
        edge_up=up_a,
        edge_links=edge_links,
        index_version=index_version,
    )


@dataclass
class PrefixMatrix:
    """Per-prefix announcer table for vectorized best-route selection.

    Row p mirrors PrefixState.entries_for(prefix_list[p]); columns are
    announcer slots (padded to a_cap). Preferences are compared
    lexicographically on device in the reference's order
    (path_preference desc, source_preference desc, advertised distance
    asc — LsdbUtil.cpp selectRoutes:842).
    """

    prefix_list: list  # row -> prefix string
    node_areas: list  # [p][a] -> (node, area) or None
    ann_node: np.ndarray  # int32 [P_cap, A_cap], -1 pad
    ann_valid: np.ndarray  # bool
    path_pref: np.ndarray  # int32
    source_pref: np.ndarray  # int32
    dist_adv: np.ndarray  # int32
    # host-side columns for vectorized route materialization
    min_nexthop: np.ndarray = None  # int32 [P_cap, A_cap], -1 = unset
    is_v4: np.ndarray = None  # bool [P_cap]
    # [p][a] -> PrefixEntry, aligned with node_areas: route entries are
    # materialized straight from these refs (no PrefixState lookups on
    # the hot host path)
    entry_refs: list = None
    # packed device-upload buffer memo (decision/tpu_solver._pack_matrix):
    # 5 of the 6 planes are pure functions of this matrix, so repacking
    # under overload churn rewrites only the flags segment in place
    # instead of re-concatenating all 6*P*A words
    _mbuf: np.ndarray = None


def build_prefix_matrix(
    prefix_state,
    node_index: dict,
    area: str,
    prefixes: Optional[list] = None,
    p_cap: int = 0,
    a_cap: int = 0,
) -> PrefixMatrix:
    """Pack one area's announcer entries into arrays. Announcers outside
    `node_index` (not in this area's graph) are dropped — same effect as
    the solver's reachability filter for unknown nodes.

    `prefixes` entries (and prefix_state keys) are canonical strings, so
    rows read the state map directly; the common single-announcer row
    skips the announcer sort."""
    state_map = prefix_state.prefixes()
    all_prefixes = prefixes if prefixes is not None else sorted(state_map)
    rows = []
    a_max = 1
    for pfx in all_prefixes:
        entries = state_map.get(pfx) or {}
        if len(entries) == 1:
            na, e = next(iter(entries.items()))
            anns = (
                [(na, e)] if na[1] == area and na[0] in node_index else []
            )
        else:
            anns = [
                (na, e)
                for na, e in sorted(entries.items())
                if na[1] == area and na[0] in node_index
            ]
            if len(anns) > a_max:
                a_max = len(anns)
        rows.append((pfx, anns))
    p = len(rows)
    p_cap = max(p_cap, _next_pow2(max(p, 1)))
    a_cap = max(a_cap, _next_pow2(max(a_max, 1), floor=2))

    ann_node = np.full((p_cap, a_cap), -1, np.int32)
    ann_valid = np.zeros((p_cap, a_cap), bool)
    path_pref = np.full((p_cap, a_cap), np.int32(-(2**31)), np.int32)
    source_pref = np.full((p_cap, a_cap), np.int32(-(2**31)), np.int32)
    dist_adv = np.full((p_cap, a_cap), INF32, np.int32)
    min_nexthop = np.full((p_cap, a_cap), -1, np.int32)
    is_v4 = np.zeros(p_cap, bool)
    prefix_list = []
    node_areas = []
    entry_refs = []
    # cell values buffered as tuples, scattered into the padded arrays
    # in one shot (per-cell numpy scalar stores are ~10x slower at the
    # 100k-prefix scale)
    cells: list[tuple] = []
    cell_append = cells.append
    pl_append = prefix_list.append
    na_append = node_areas.append
    er_append = entry_refs.append
    for pi, (pfx, anns) in enumerate(rows):
        pl_append(pfx)
        if len(anns) == 1:
            na, entry = anns[0]
            m = entry.metrics
            cell_append((
                pi, 0, node_index[na[0]], m.path_preference,
                m.source_preference, m.distance,
                -1 if entry.min_nexthop is None else entry.min_nexthop,
            ))
            na_append([na])
            er_append([entry])
            continue
        row_nas = []
        row_entries = []
        for ai, (na, entry) in enumerate(anns[:a_cap]):
            m = entry.metrics
            cell_append((
                pi, ai, node_index[na[0]], m.path_preference,
                m.source_preference, m.distance,
                -1 if entry.min_nexthop is None else entry.min_nexthop,
            ))
            row_nas.append(na)
            row_entries.append(entry)
        na_append(row_nas)
        er_append(row_entries)
    if p:
        is_v4[:p] = np.fromiter(
            (":" not in pfx for pfx in prefix_list), bool, p
        )
    if cells:
        c_pi, c_ai, c_node, c_pp, c_sp, c_da, c_mn = zip(*cells)
        pi_a = np.asarray(c_pi, np.int64)
        ai_a = np.asarray(c_ai, np.int64)
        ann_node[pi_a, ai_a] = c_node
        ann_valid[pi_a, ai_a] = True
        path_pref[pi_a, ai_a] = c_pp
        source_pref[pi_a, ai_a] = c_sp
        dist_adv[pi_a, ai_a] = np.minimum(
            np.asarray(c_da, np.int64), int(INF32)
        )
        min_nexthop[pi_a, ai_a] = c_mn
    return PrefixMatrix(
        prefix_list=prefix_list,
        node_areas=node_areas,
        ann_node=ann_node,
        ann_valid=ann_valid,
        path_pref=path_pref,
        source_pref=source_pref,
        dist_adv=dist_adv,
        min_nexthop=min_nexthop,
        is_v4=is_v4,
        entry_refs=entry_refs,
    )
