"""Shift-decomposed device mirror of a LinkState graph — the TPU-native
relaxation structure.

Why not plain gather: XLA lowers per-element gathers on TPU to a scalar
loop (~300M elem/s measured on v5e — 3.6 ms per relaxation at 131k
nodes), which busts the <50 ms full-rebuild budget by itself. Rolls,
shifts and elementwise min/add are VPU-vectorized and ~1000x faster. So
the mirror decomposes the directed edge set into

  1. **shift classes**: all edges u -> u+delta for a fixed index delta
     form one class; the relaxation contribution of a class is
     `roll(dist + w_class, delta)` — two vector ops and a roll, no
     gather. Grids/tori decompose perfectly (4 classes); fat-trees and
     hierarchical fabrics mostly (pods/planes are index-affine under
     natural-sorted node numbering); arbitrary graphs partially.
  2. **residual ELL**: leftover edges in padded in-neighbor lists,
     relaxed with the (slow but correct) gather path. The decomposer
     keeps this small by construction.

Effective weights fold every vantage-INDEPENDENT usability rule on the
host: link down, source-node transit drain (overload). The root-as-
transit exclusion is vantage-specific and applied ON DEVICE (mask one
column), so a single resident graph serves every vantage — any-vantage
ctrl queries and the whole-fabric path reuse the same buffers.

INF discipline: INF32E = 2^29 and all real weights <= 2^28, so
`dist + w` never exceeds 2^30 and int32 relaxation needs NO overflow
masks: `new = min(dist, roll(dist + w, delta))` is exact because any sum
involving an INF stays >= INF and dist is pinned <= INF.

Delta maintenance: LinkState's bounded changelog (link_state.py
events_since) is applied as index writes into the class/residual arrays
(metric flap = one int32 store), with the dirty entries shipped to the
device as a scatter update instead of a full re-upload. Node-set changes
trigger a rebuild (rare).

Replaces the role of the reference's LinkState graph walk in runSpf
(openr/decision/LinkState.cpp:836-911) as the data structure the hot
loop runs on.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from openr_tpu_torch.decision.link_state import Link, LinkState

# effectively-infinite metric; 2^29 so dist+w <= 2^30 < int32 max with no
# saturation logic anywhere in the kernels
INF32E = np.int32(1 << 29)
MAX_METRIC = int(1 << 28)

_NAT_RE = re.compile(r"\d+")
_ZFILL = lambda m: m.group().zfill(12)  # noqa: E731


def natural_key(name: str) -> str:
    """Numeric-aware sort key: node-10-2 orders after node-2-3. Index
    locality under this ordering is what makes shift classes dense for
    generated and real-world (rsw001.p002-style) names alike.

    Digit runs are zero-padded to fixed width so the key is a plain
    string (C-speed compares, no per-token tuples, and no int-vs-str
    TypeError when one name has digits where another has letters)."""
    return _NAT_RE.sub(_ZFILL, name)


def _next_pow2(n: int, floor: int = 1) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


@dataclass
class EdgePlan:
    """Host arrays + bookkeeping; ships to device as-is."""

    n_nodes: int
    n_cap: int
    s_cap: int  # shift-class slots (padded; unused classes have delta 0, all-INF weights)
    deltas: np.ndarray  # int32 [s_cap]
    shift_w: np.ndarray  # int32 [s_cap, n_cap]; w of edge v -> v+deltas[k]
    # residual ELL is ROW-COMPACT: only destination nodes with irregular
    # in-edges occupy a row (hierarchical fabrics have few such nodes), so
    # the slow gather scales with real residual edges, not n_cap
    k_res: int  # real max residual in-degree (0 = no residual path)
    res_rows: np.ndarray  # int32 [r_cap]; destination node of each row, -1 pad
    res_nbr: np.ndarray  # int32 [r_cap, k_cap]; source node, -1 pad
    res_w: np.ndarray  # int32 [r_cap, k_cap]
    node_overloaded: np.ndarray  # bool [n_cap]
    node_names: list
    node_index: dict
    # link -> [loc_from_n1, loc_from_n2] with loc =
    # ("s", k, u_idx) | ("r", row, col) | None. Built LAZILY from the
    # compact location arrays below on the first delta application —
    # or by the solver's background prewarm thread right after a cold
    # build (guarded by _loc_lock), so the first churn doesn't pay the
    # E-entry dict on the convergence critical path
    edge_loc: Optional[dict] = None
    _loc_lock: object = field(default_factory=threading.Lock)
    # per-directed-edge slot locations, aligned with _links_sorted order
    # (edge 2i = links[i].n1 -> n2, edge 2i+1 the reverse)
    _links_sorted: list = field(default_factory=list)
    _loc_kind: Optional[np.ndarray] = None  # uint8: 0 = shift, 1 = residual
    _loc_a: Optional[np.ndarray] = None  # int32: k | row
    _loc_b: Optional[np.ndarray] = None  # int32: u | col
    # occupancy (a slot with INF weight may still be owned by a down link)
    _shift_occ: Optional[np.ndarray] = None  # bool [s_cap, n_cap]
    _res_row_of: dict = field(default_factory=dict)  # v_idx -> row
    _res_fill: Optional[np.ndarray] = None  # int32 [r_cap] cols used per row
    _res_nrows: int = 0
    # delta-update state
    synced_generation: int = -1
    needs_rebuild: bool = False
    # dirty entries since last device sync. Each entry carries the
    # PRE-WRITE value alongside the new one so consumers that need the
    # previous device plane (the incremental SSSP seed path) can
    # reconstruct it from the new plane + these old values, without a
    # second resident copy.
    dirty_shift: list = field(default_factory=list)  # (k, u, w, old_w)
    dirty_res: list = field(default_factory=list)  # (row, col, w, old_w)
    dirty_res_nbr: bool = False  # residual nbr indices changed (new slots)
    # sticky flag: a zero-weight live edge existed at build time or was
    # written since. Zero-weight edges allow equal-distance parent
    # cycles, which break the incremental solver's tree-descendant
    # invalidation — consumers fall back to the full solve while set.
    has_zero_w: bool = False
    # bumped when node index mapping changes (matrix cache key)
    index_version: int = 0
    # pow2 Δ-quantization exponent for the bucketed stepping kernel
    # (ops/relax.derive_delta_exp), computed once per mirror build and
    # STICKY across rebuilds of the same area so churn never flips the
    # (kernel, delta_exp) jit-cache class. 0 = no usable shift classes:
    # the solver's eligibility ladder falls back to the sync kernel.
    delta_exp: int = 0

    # -- host-side out-edge view (per-vantage, cheap) ----------------------

    def out_links(self, link_state: LinkState, root: str):
        """Root's out-edge slots: (nbr_idx[d], w_eff[d], links[d]) in
        deterministic sorted-Link order. Built per call — O(degree)."""
        links = link_state.ordered_links_from_node(root)
        nbr = np.full(max(_next_pow2(len(links), 4), 4), -1, np.int32)
        w = np.full(nbr.shape[0], INF32E, np.int32)
        out = []
        for d, link in enumerate(links[: nbr.shape[0]]):
            other = link.other_node(root)
            nbr[d] = self.node_index[other]
            w[d] = (
                min(link.metric_from_node(root), MAX_METRIC)
                if link.is_up()
                else INF32E
            )
            out.append(link)
        return nbr, w, out


def _effective_w(link: Link, src: str, overloaded_src: bool) -> int:
    if not link.is_up() or overloaded_src:
        return int(INF32E)
    return min(link.metric_from_node(src), MAX_METRIC)


def _ensure_edge_loc(plan: EdgePlan) -> dict:
    """Materialize the link -> [loc_n1, loc_n2] slot-location dict from
    the compact per-edge arrays. Deferred so cold full builds skip it;
    the first apply_events call — or the solver's post-build prewarm
    thread, whichever comes first — pays it once per rebuild (the lock
    keeps the two from interleaving a build with mutations)."""
    with plan._loc_lock:
        if plan.edge_loc is None:
            kinds = plan._loc_kind.tolist()
            las = plan._loc_a.tolist()
            lbs = plan._loc_b.tolist()
            kk = ("s", "r")
            d = {}
            for i, link in enumerate(plan._links_sorted):
                e = 2 * i
                d[link] = [
                    (kk[kinds[e]], las[e], lbs[e]),
                    (kk[kinds[e + 1]], las[e + 1], lbs[e + 1]),
                ]
            plan.edge_loc = d
    return plan.edge_loc


def prewarm_edge_loc(plan: EdgePlan) -> None:
    """Build the edge locator on a background thread so the first churn
    after a cold build doesn't pay the E-entry dict (~430 ms at 77k
    links) inside its convergence window. Safe against an early churn:
    _ensure_edge_loc's lock serializes the two builders, and whichever
    runs second finds the dict already present."""
    threading.Thread(
        target=_ensure_edge_loc, args=(plan,), daemon=True,
        name="edge-loc-prewarm",
    ).start()


def edge_loc_of(plan: EdgePlan, link: Link, src_name: str):
    """The directed edge (link, src_name)'s slot location, or None."""
    entry = plan.edge_loc.get(link)
    if entry is None:
        return None
    return entry[0 if src_name == link.n1 else 1]


def build_plan(
    link_state: LinkState,
    n_cap: int = 0,
    s_max: int = 64,
    min_class_frac: float = 1 / 128,
    prev: Optional[EdgePlan] = None,
) -> EdgePlan:
    """Full build: natural-order the nodes, histogram index deltas, keep
    the top classes, spill the rest to the residual ELL.

    Fully vectorized over directed-edge arrays — the only Python-level
    per-link work is one sort key, one index lookup per endpoint and one
    mirror_fields() call; slot assignment (first edge per (class, src)
    wins), residual grouping and the location tables are numpy. The
    (link, src) -> slot dict is deferred to the first delta application
    (_ensure_edge_loc), so a cold daemon start never builds it."""
    # per-object extraction memoized on the LinkState per generation —
    # a second full build at the same generation is numpy-only
    names, index, n1i, n2i, trip, links_sorted = link_state.mirror_source(
        natural_key
    )
    n = len(names)
    if prev is not None:
        n_cap = max(n_cap, prev.n_cap)
    n_cap = max(n_cap, _next_pow2(max(n, 1), 8))

    node_over = np.zeros(n_cap, bool)
    for nm in link_state.overloaded_nodes():
        i = index.get(nm)
        if i is not None:
            node_over[i] = True

    # directed edges: edge 2i = links[i].n1 -> n2, 2i+1 reverse
    m = len(links_sorted)
    e2 = m * 2
    if m:
        src = np.empty(e2, np.int32)
        dst = np.empty(e2, np.int32)
        wdir = np.empty(e2, np.int64)
        src[0::2] = n1i
        src[1::2] = n2i
        dst[0::2] = n2i
        dst[1::2] = n1i
        wdir[0::2] = trip[:, 0]
        wdir[1::2] = trip[:, 1]
        up2 = np.repeat(trip[:, 2].astype(bool), 2)
        w = np.where(
            up2 & ~node_over[src],
            np.minimum(wdir, MAX_METRIC),
            int(INF32E),
        ).astype(np.int32)
        delta = dst - src
        # class selection: most-populous deltas above a usefulness floor
        vals, counts = np.unique(delta, return_counts=True)
        order = np.argsort(-counts)
        floor = max(8, int(e2 * min_class_frac))
        chosen = [int(vals[o]) for o in order[:s_max] if counts[o] >= floor]
    else:
        src = dst = delta = np.empty(0, np.int32)
        w = np.empty(0, np.int32)
        chosen = []
    s_cap = _next_pow2(max(len(chosen), 1), 4)
    if prev is not None:
        s_cap = max(s_cap, prev.s_cap)
    deltas = np.zeros(s_cap, np.int32)
    deltas[: len(chosen)] = chosen

    shift_w = np.full((s_cap, n_cap), INF32E, np.int32)
    shift_occ = np.zeros((s_cap, n_cap), bool)
    loc_kind = np.zeros(e2, np.uint8)
    loc_a = np.zeros(e2, np.int32)
    loc_b = np.zeros(e2, np.int32)

    if chosen:
        # delta value -> class index, vectorized through a sorted view
        chosen_arr = np.array(chosen, np.int32)
        sort_ix = np.argsort(chosen_arr)
        sorted_vals = chosen_arr[sort_ix]
        pos = np.searchsorted(sorted_vals, delta)
        pos_c = np.clip(pos, 0, len(chosen) - 1)
        in_class = sorted_vals[pos_c] == delta
        k_of = sort_ix[pos_c].astype(np.int32)
        # first edge (in edge order) per (class, src) occupies the slot
        elig = np.flatnonzero(in_class)
        key = k_of[elig].astype(np.int64) * n_cap + src[elig]
        _, first = np.unique(key, return_index=True)
        shift_edges = elig[first]
        ks, us = k_of[shift_edges], src[shift_edges]
        shift_occ[ks, us] = True
        shift_w[ks, us] = w[shift_edges]
        is_shift = np.zeros(e2, bool)
        is_shift[shift_edges] = True
        loc_a[shift_edges] = ks
        loc_b[shift_edges] = us
        res_idx = np.flatnonzero(~is_shift)
    else:
        res_idx = np.arange(e2)

    # residual ELL: group leftover edges by destination (row-compact)
    rv = dst[res_idx]
    order2 = np.argsort(rv, kind="stable")  # edge order within a group
    res_sorted = res_idx[order2]
    sv = rv[order2]
    uniq_v, first_v = np.unique(sv, return_index=True)
    n_rows = len(uniq_v)
    group_counts = np.diff(np.r_[first_v, len(sv)]).astype(np.int32)
    k_res = int(group_counts.max()) if n_rows else 0
    k_cap = _next_pow2(max(k_res, 1), 2)
    r_cap = _next_pow2(max(n_rows, 1), 8)
    if prev is not None and prev.k_res:
        k_cap = max(k_cap, prev.res_nbr.shape[1])
        r_cap = max(r_cap, prev.res_rows.shape[0])
    res_rows = np.full(r_cap, -1, np.int32)
    res_nbr = np.full((r_cap, k_cap), -1, np.int32)
    res_w = np.full((r_cap, k_cap), INF32E, np.int32)
    fill = np.zeros(r_cap, np.int32)
    if n_rows:
        res_rows[:n_rows] = uniq_v
        rows_per_edge = np.repeat(
            np.arange(n_rows, dtype=np.int32), group_counts
        )
        cols_per_edge = (
            np.arange(len(sv), dtype=np.int32)
            - np.repeat(first_v.astype(np.int32), group_counts)
        )
        res_nbr[rows_per_edge, cols_per_edge] = src[res_sorted]
        res_w[rows_per_edge, cols_per_edge] = w[res_sorted]
        fill[:n_rows] = group_counts
        loc_kind[res_sorted] = 1
        loc_a[res_sorted] = rows_per_edge
        loc_b[res_sorted] = cols_per_edge
    row_of = {int(v): r for r, v in enumerate(uniq_v)}

    index_version = 0
    if prev is not None:
        index_version = (
            prev.index_version
            if prev.node_names == names
            else prev.index_version + 1
        )

    # sticky Δ: keep the previous build's exponent while it is usable so
    # metric churn can't thrash the (kernel, delta_exp) jit-cache class;
    # local import keeps ops/relax out of this module's import graph for
    # host-only consumers
    if prev is not None and prev.delta_exp > 0:
        delta_exp = prev.delta_exp
    else:
        from openr_tpu_torch.ops.relax import derive_delta_exp

        delta_exp = derive_delta_exp(deltas, shift_w)

    return EdgePlan(
        n_nodes=n,
        n_cap=n_cap,
        s_cap=s_cap,
        deltas=deltas,
        shift_w=shift_w,
        k_res=k_res,
        res_rows=res_rows,
        res_nbr=res_nbr,
        res_w=res_w,
        node_overloaded=node_over,
        node_names=names,
        node_index=index,
        has_zero_w=bool(m) and bool((w == 0).any()),
        edge_loc=None,
        _links_sorted=links_sorted,
        _loc_kind=loc_kind,
        _loc_a=loc_a,
        _loc_b=loc_b,
        _shift_occ=shift_occ,
        _res_row_of=row_of,
        _res_fill=fill,
        _res_nrows=n_rows,
        synced_generation=link_state.generation,
        index_version=index_version,
        delta_exp=delta_exp,
    )


def _set_edge_w(plan: EdgePlan, link: Link, src_name: str, w: int) -> None:
    loc = edge_loc_of(plan, link, src_name)
    if loc is None:
        plan.needs_rebuild = True
        return
    if w == 0:
        plan.has_zero_w = True
    if loc[0] == "s":
        _, k, u = loc
        old = int(plan.shift_w[k, u])
        if old != w:
            plan.shift_w[k, u] = w
            plan.dirty_shift.append((k, u, w, old))
    else:
        _, row, col = loc
        old = int(plan.res_w[row, col])
        if old != w:
            plan.res_w[row, col] = w
            plan.dirty_res.append((row, col, w, old))


def _refresh_link(plan: EdgePlan, link: Link) -> None:
    for src_name in (link.n1, link.n2):
        u = plan.node_index.get(src_name)
        if u is None:
            plan.needs_rebuild = True
            return
        _set_edge_w(
            plan, link, src_name, _effective_w(link, src_name, bool(plan.node_overloaded[u]))
        )


def _add_link(plan: EdgePlan, link: Link) -> None:
    for idx, (src_name, dst_name) in enumerate(
        ((link.n1, link.n2), (link.n2, link.n1))
    ):
        if edge_loc_of(plan, link, src_name) is not None:
            _refresh_link(plan, link)
            continue
        u = plan.node_index.get(src_name)
        v = plan.node_index.get(dst_name)
        if u is None or v is None:
            plan.needs_rebuild = True
            return
        w = _effective_w(link, src_name, bool(plan.node_overloaded[u]))
        # try a shift slot first
        d = v - u
        placed = False
        for k in range(plan.s_cap):
            if plan.deltas[k] == d and not plan._shift_occ[k, u]:
                # class 0 slot with delta 0 is a real class only if some
                # chosen delta was 0 — guard: delta-0 self-loops don't occur
                if d == 0:
                    break
                plan._shift_occ[k, u] = True
                plan.edge_loc.setdefault(link, [None, None])[idx] = (
                    "s", k, u,
                )
                _set_edge_w(plan, link, src_name, w)
                placed = True
                break
        if placed:
            continue
        row = plan._res_row_of.get(v)
        if row is None:
            if plan._res_nrows >= plan.res_rows.shape[0]:
                plan.needs_rebuild = True
                return
            row = plan._res_nrows
            plan._res_nrows = row + 1
            plan._res_row_of[v] = row
            plan.res_rows[row] = v
        col = int(plan._res_fill[row])
        if col >= plan.res_nbr.shape[1]:
            plan.needs_rebuild = True
            return
        plan._res_fill[row] = col + 1
        plan.res_nbr[row, col] = u
        plan.res_w[row, col] = w
        if w == 0:
            plan.has_zero_w = True
        plan.k_res = max(plan.k_res, col + 1)
        plan.edge_loc.setdefault(link, [None, None])[idx] = ("r", row, col)
        # a fresh slot's pre-write value is the INF pad
        plan.dirty_res.append((row, col, w, int(INF32E)))
        # res_nbr/res_rows changed too — consumer re-uploads those arrays
        plan.dirty_res_nbr = True


def _remove_link(plan: EdgePlan, link: Link) -> None:
    """Tombstone: weight INF, slot stays owned (a re-added link reuses
    it); residual slots are NOT compacted."""
    for src_name in (link.n1, link.n2):
        _set_edge_w(plan, link, src_name, int(INF32E))


def _node_overload_changed(
    plan: EdgePlan, link_state: LinkState, node: str
) -> None:
    u = plan.node_index.get(node)
    if u is None:
        plan.needs_rebuild = True
        return
    plan.node_overloaded[u] = link_state.is_node_overloaded(node)
    for link in link_state.links_from_node(node):
        _set_edge_w(
            plan, link, node, _effective_w(link, node, bool(plan.node_overloaded[u]))
        )


def apply_events(
    plan: EdgePlan, link_state: LinkState, events: list[tuple]
) -> bool:
    """Apply a changelog slice; returns False when a rebuild is needed."""
    _ensure_edge_loc(plan)
    for ev in events:
        kind = ev[0]
        if kind == "nodes":
            plan.needs_rebuild = True
        elif kind == "links":
            for link in ev[1]:
                _refresh_link(plan, link)
        elif kind == "added":
            for link in ev[1]:
                _add_link(plan, link)
        elif kind == "removed":
            for link in ev[1]:
                _remove_link(plan, link)
        elif kind == "overload":
            _node_overload_changed(plan, link_state, ev[1])
        if plan.needs_rebuild:
            return False
    plan.synced_generation = link_state.generation
    return True


def _consolidate(entries: list, stride: int):
    """(a, b, new, old) entries -> unique flat indices in first-seen
    order, keeping the FIRST old and the LAST new per slot. A slot
    dirtied twice between drains (flap down then up) must scatter its
    final value — duplicate indices in one XLA scatter have unspecified
    winner — and its old value must be the true pre-drain device value."""
    merged: dict[int, list] = {}
    for a, b, w, old in entries:
        f = a * stride + b
        hit = merged.get(f)
        if hit is None:
            merged[f] = [w, old]
        else:
            hit[0] = w
    idx = np.fromiter(merged.keys(), np.int32, len(merged))
    val = np.fromiter((v[0] for v in merged.values()), np.int32, len(merged))
    old = np.fromiter((v[1] for v in merged.values()), np.int32, len(merged))
    return idx, val, old


def drain_dirty(plan: EdgePlan):
    """Consume pending scatter updates: ((shift_flat_idx, shift_vals,
    shift_olds), (res_flat_idx, res_vals, res_olds), res_nbr_changed).
    Flat indices index the raveled [s_cap, n_cap] / [r_cap, k_res_cap]
    device arrays; indices are de-duplicated (last new value wins) and
    the old arrays carry each slot's pre-drain value so the incremental
    SSSP kernel can rebuild the previous weight plane on device."""
    if plan.dirty_shift:
        s_idx, s_val, s_old = _consolidate(plan.dirty_shift, plan.n_cap)
    else:
        s_idx = s_val = s_old = None
    if plan.dirty_res:
        r_idx, r_val, r_old = _consolidate(
            plan.dirty_res, plan.res_nbr.shape[1]
        )
    else:
        r_idx = r_val = r_old = None
    nbr_changed = plan.dirty_res_nbr
    plan.dirty_shift = []
    plan.dirty_res = []
    plan.dirty_res_nbr = False
    return (s_idx, s_val, s_old), (r_idx, r_val, r_old), nbr_changed


def sync_plan(
    link_state: LinkState, plan: Optional[EdgePlan], **build_kwargs
) -> EdgePlan:
    """Bring a plan up to date with a LinkState: apply changelog deltas
    when possible, full-rebuild otherwise."""
    if plan is None or plan.needs_rebuild:
        return build_plan(link_state, prev=plan, **build_kwargs)
    if plan.synced_generation == link_state.generation:
        return plan
    events = link_state.events_since(plan.synced_generation)
    if events is None or not apply_events(plan, link_state, events):
        return build_plan(link_state, prev=plan, **build_kwargs)
    return plan
