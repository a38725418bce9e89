"""Columnar, lazily-materialized RIB.

BENCH_r05 showed a cold 100k-prefix rebuild spends 70% of its wall time
constructing `RibUnicastEntry` Python objects in `_build_entries` — for
routes most consumers never look at individually. This module keeps the
solver's packed device outputs (metric, selected-announcer words,
next-hop words, LFA slots) as numpy COLUMNS keyed by prefix-matrix row,
and builds entry objects only at consumption boundaries:

  - the Fib unicast diff (`fast_unicast_diff`): a journal of changed
    row-sets turns the diff into compare-only-what-the-device-says-
    changed — O(changed) entry builds instead of O(P);
  - `RibPolicy.apply_policy` / RPC serialization / CLI dumps: these
    iterate the mapping, which materializes in one bulk pass.

Three cooperating pieces:

  `ColumnarRib`   one (area, vantage)'s live column store. Mutated in
                  place by the solver (full scatter on cold rebuild,
                  row patches on steady-state deltas). Copy-on-write:
                  before a mutation, the column bundle is copied iff a
                  live `RibView` still references it, so snapshots stay
                  valid at ~2 MB/flap cost.
  `RibView`       an immutable snapshot (cols bundle + epoch) of a
                  ColumnarRib. A CURRENT view delegates to the crib's
                  shared materialization cache; a STALE view rebuilds
                  rows on demand from its retained bundle.
  `LazyUnicastRoutes`
                  the MutableMapping that DecisionRouteDb carries:
                  host-built `base` routes shadowed by per-area views,
                  with `overrides`/`deleted` capturing post-build
                  mutations (statics, RibPolicy edits) without forcing.

Entry identity is preserved exactly: `build_entries` below is the
former `tpu_solver._build_entries` loop, moved verbatim so columnar and
eager materialization are byte-identical (asserted by the property test
in tests/test_columnar_rib.py).
"""

from __future__ import annotations

import weakref
from collections.abc import MutableMapping
from typing import Optional

import numpy as np

from openr_tpu_torch.decision.rib import NextHop, RibUnicastEntry
from openr_tpu_torch.decision.spf_solver import select_best_node_area
from openr_tpu_torch.ops.edgeplan import INF32E
from openr_tpu_torch.runtime.counters import counters

INF_E = int(INF32E)
_entry_new = object.__new__

# journal records retained per crib; an older snapshot falls back to the
# full per-entry compare (bounded memory, not bounded correctness)
_JOURNAL_MAX = 256


# fields the fast-construction loop in build_entries always sets itself
_ENTRY_SET_FIELDS = frozenset(
    {
        "prefix", "nexthops", "best_prefix_entry", "best_node_area",
        "igp_cost", "lfa_nexthops",
    }
)


def _entry_defaults() -> tuple[dict, list]:
    """(plain defaults, per-entry default factories) of RibUnicastEntry,
    derived from the dataclass itself so the fast constructor below
    cannot silently desynchronize when a defaulted field is added to the
    schema. Factory-defaulted fields the loop does not overwrite are
    CALLED PER ENTRY — sharing one factory product across all entries
    would alias a future mutable default."""
    import dataclasses

    plain = {}
    factories = []
    for f in dataclasses.fields(RibUnicastEntry):
        if f.default is not dataclasses.MISSING:
            plain[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            if f.name in _ENTRY_SET_FIELDS:
                plain[f.name] = None  # placeholder; always overwritten
            else:
                factories.append((f.name, f.default_factory))  # type: ignore[misc]
    return plain, factories


_ENTRY_DEFAULTS, _ENTRY_FACTORIES = _entry_defaults()


def unpack_words(words: np.ndarray, x: int) -> np.ndarray:
    """host inverse of the device's _pack_words: int32 [R, W] -> bool
    [R, x].

    Bit extraction runs through np.unpackbits over the low two bytes of
    each little-endian word (C speed) — the shift-and-mask formulation
    materialized a [R, W, 16] int32 temporary and cost ~0.3s per 100k-row
    full pull."""
    r, wn = words.shape
    if r == 0 or wn == 0:
        return np.zeros((r, x), bool)
    low2 = (
        np.ascontiguousarray(words.astype("<i4"))
        .view(np.uint8)
        .reshape(r, wn, 4)[:, :, :2]
    )
    bits = np.unpackbits(
        np.ascontiguousarray(low2).reshape(r, wn * 2),
        axis=1,
        bitorder="little",
    )
    return bits[:, :x].astype(bool)


def pack_words_host(bits: np.ndarray) -> np.ndarray:
    """host companion of the device's _pack_words: bool [R, x] -> int32
    [R, ceil(x/16)], 16 bits per little-endian word. Used by the sharded
    fabric path, whose kernel returns unpacked masks."""
    r, x = bits.shape
    w = -(-max(x, 1) // 16)
    pad = w * 16 - x
    if pad:
        bits = np.concatenate([bits, np.zeros((r, pad), bool)], axis=1)
    by = np.packbits(
        bits.astype(np.uint8), axis=1, bitorder="little"
    )  # [R, 2w]
    out = np.zeros((r, w, 4), np.uint8)
    out[:, :, :2] = by.reshape(r, w, 2)
    return np.ascontiguousarray(out).view("<i4").reshape(r, w).astype(np.int32)


def route_ok_rows(matrix, root_idx: int, rows, met, s3, nh,
                  block_v4: bool) -> np.ndarray:
    """Vectorized route-level filter (the host mirror of the device ok
    predicate in tpu_solver._plan_pipeline). met/s3/nh are indexed
    0..len(rows); `rows` (array or slice) indexes the matrix arrays."""
    ok = s3.any(axis=1) & (met < INF_E)
    if block_v4:
        ok &= ~matrix.is_v4[rows]
    ok &= ~(s3 & (matrix.ann_node[rows] == root_idx)).any(axis=1)
    eff_min = np.where(s3, matrix.min_nexthop[rows], -1).max(axis=1)
    nh_count = nh.sum(axis=1)
    ok &= (eff_min <= nh_count) & (nh_count > 0)
    return ok


def build_entries(
    routes: dict, nh_cache: dict, my_node_name: str, matrix, links, rows,
    met, s3, nh, lfa_slot=None, lfa_metric=None, value_rows=None,
    use_v4_allowed: bool = True,
) -> None:
    """Construct RibUnicastEntry for the given matrix rows into `routes`.
    met/s3/nh (and lfa arrays) are indexed by value_rows (delta path) or
    by matrix row (full)."""
    node_areas = matrix.node_areas
    entry_refs = matrix.entry_refs
    prefix_list = matrix.prefix_list
    # row data as Python lists / flat bytes: the loop below runs for
    # every changed route (all ~100k on a cold rebuild) and per-row
    # numpy scalar indexing costs ~10x a list index
    nh_bytes = np.packbits(nh, axis=1).tobytes()
    nh_stride = -(-nh.shape[1] // 8) if len(rows) else 1
    rows_l = rows.tolist()
    vi_l = value_rows.tolist() if value_rows is not None else rows_l
    met_l = met.tolist()
    s3_l = s3.tolist()
    nh_l = nh.tolist()
    lfa_slot_l = lfa_slot.tolist() if lfa_slot is not None else None
    lfa_metric_l = lfa_metric.tolist() if lfa_metric is not None else None
    no_lfa = frozenset()
    n_links = len(links)
    # family-aware next-hop addresses (ref createNextHop): v4
    # prefixes take the link's v4 address unless v4-over-v6 is on.
    # Sliced by row — the delta path calls this for a handful of
    # rows and must not pay an O(P) conversion.
    v4_rows_l = matrix.is_v4[rows].tolist()
    built = 0
    for i, p in enumerate(rows_l):
        vi = vi_l[i]
        row = s3_l[vi]
        nas = node_areas[p]
        sel = [(a, na) for a, na in enumerate(nas) if row[a]]
        if not sel:
            continue
        m = met_l[vi]
        use_v4 = use_v4_allowed and v4_rows_l[i]
        key = (nh_bytes[vi * nh_stride:(vi + 1) * nh_stride], m, use_v4)
        nexthops = nh_cache.get(key)
        if nexthops is None:
            nh_row = nh_l[vi]
            nexthops = frozenset(
                NextHop(
                    address=links[d].nh_from_node(my_node_name, use_v4),
                    if_name=links[d].iface_from_node(my_node_name),
                    metric=m,
                    area=links[d].area,
                    neighbor_node_name=links[d].other_node(my_node_name),
                )
                for d in range(n_links)
                if nh_row[d]
            )
            nh_cache[key] = nexthops
        lfa_nexthops = no_lfa
        if lfa_slot_l is not None:
            d = lfa_slot_l[vi]
            if 0 <= d < n_links:
                alt_m = lfa_metric_l[vi]
                lkey = ("lfa", d, alt_m, use_v4)
                lfa_nexthops = nh_cache.get(lkey)
                if lfa_nexthops is None:
                    lfa_nexthops = frozenset({
                        NextHop(
                            address=links[d].nh_from_node(
                                my_node_name, use_v4
                            ),
                            if_name=links[d].iface_from_node(my_node_name),
                            metric=alt_m,
                            area=links[d].area,
                            neighbor_node_name=links[d].other_node(
                                my_node_name
                            ),
                        )
                    })
                    nh_cache[lkey] = lfa_nexthops
        if len(sel) == 1:
            ba, best = sel[0]
        else:
            best = select_best_node_area(
                {na for _, na in sel}, my_node_name
            )
            ba = next(a for a, na in sel if na == best)
        prefix = prefix_list[p]
        # bypass the dataclass __init__ (per-field object.__setattr__
        # x9) — this loop constructs one entry per route on a cold
        # 100k rebuild; equality/hash read the same attributes either
        # way, and unset fields come from the schema-derived defaults
        entry = _entry_new(RibUnicastEntry)
        d = dict(_ENTRY_DEFAULTS)
        for fname, factory in _ENTRY_FACTORIES:
            d[fname] = factory()
        d["prefix"] = prefix
        d["nexthops"] = nexthops
        d["best_prefix_entry"] = entry_refs[p][ba]
        d["best_node_area"] = best
        d["igp_cost"] = m
        d["lfa_nexthops"] = lfa_nexthops
        entry.__dict__.update(d)
        routes[prefix] = entry
        built += 1
    if built:
        # the zero-objects gate for the columnar spine: any hot path
        # that claims to stay in packed-array land is asserted against
        # this counter standing still
        counters.increment("decision.rib.entries_built", built)


class _Cols:
    """One generation of the packed columns. Treated as immutable once a
    RibView references it (ColumnarRib copies-on-write before mutating a
    referenced bundle)."""

    __slots__ = (
        "met", "s3w", "nhw", "lfa_slot", "lfa_metric", "ok",
        "_key_rows", "_row_of",
    )

    def __init__(self):
        self.met = self.s3w = self.nhw = None
        self.lfa_slot = self.lfa_metric = None
        self.ok = None
        self._key_rows = None  # cached np.flatnonzero(ok)
        self._row_of = None  # cached prefix -> row for ok rows

    def copy(self) -> "_Cols":
        c = _Cols()
        c.met = self.met.copy()
        c.s3w = self.s3w.copy()
        c.nhw = self.nhw.copy()
        if self.lfa_slot is not None:
            c.lfa_slot = self.lfa_slot.copy()
            c.lfa_metric = self.lfa_metric.copy()
        c.ok = self.ok.copy()
        return c

    def key_rows(self) -> np.ndarray:
        if self._key_rows is None:
            self._key_rows = np.flatnonzero(self.ok)
        return self._key_rows


class ColumnarRib:
    """One (area, vantage)'s packed route columns + shared entry cache.

    The solver mutates this in place: `set_full_packed` on a cold
    rebuild (device-compacted ok rows scattered into fresh columns),
    `apply_rows` on steady-state deltas. Every mutation bumps `epoch`
    and journals the changed row set so two RibView snapshots of the
    same crib can diff in O(changed)."""

    def __init__(self, my_node_name: str, matrix, links, root_idx: int,
                 block_v4: bool, use_v4_allowed: bool, lfa: bool):
        self.my_node_name = my_node_name
        self.matrix = matrix
        self.links = links
        self.root_idx = int(root_idx)
        self.block_v4 = block_v4
        self.use_v4_allowed = use_v4_allowed
        self.lfa = lfa
        self.p_n = len(matrix.prefix_list)
        self.cols: Optional[_Cols] = None
        self.epoch = 0
        # oldest epoch the journal can still diff against; reset by
        # set_full_packed and by journal trimming
        self.journal_floor = 0
        # (epoch, rows, exact): `exact` marks a device-exact entry —
        # the row set IS the set of rows whose columns differ from the
        # previous epoch (the streaming pipeline's on-device diff), not
        # a superset a consumer must re-compare
        self.journal: list[tuple[int, np.ndarray, bool]] = []
        self.routes: dict[str, RibUnicastEntry] = {}
        # routes is COMPLETE iff materialized; otherwise it is a partial
        # per-row cache (invalidated row-wise by apply_rows)
        self.materialized = False
        self.nh_cache: dict = {}
        self._views: "weakref.WeakSet[RibView]" = weakref.WeakSet()

    # -- mutation (solver side) -------------------------------------------

    def _cow(self) -> None:
        """Copy the column bundle iff a live view still references it, so
        that view's snapshot survives the coming in-place mutation."""
        c = self.cols
        if c is None:
            return
        if any(v.cols is c for v in self._views):
            self.cols = c.copy()
        else:
            # in-place mutation: the derived caches go stale
            c._key_rows = None
            c._row_of = None

    def set_full_packed(self, rows: np.ndarray, met, s3w, nhw,
                        lfa_slot=None, lfa_metric=None) -> None:
        """Cold rebuild from the device-compacted full buffer: `rows` are
        the ok matrix rows (ascending), the value arrays their gathered
        packed outputs. Non-ok rows keep zero columns — nothing reads
        them (ok=False removes them from every view)."""
        p_n = self.p_n
        keep = rows < p_n
        rows = rows[keep]
        c = _Cols()
        c.met = np.zeros(p_n, np.int32)
        c.s3w = np.zeros((p_n, s3w.shape[1]), np.int32)
        c.nhw = np.zeros((p_n, nhw.shape[1]), np.int32)
        c.met[rows] = met[keep]
        c.s3w[rows] = s3w[keep]
        c.nhw[rows] = nhw[keep]
        if lfa_slot is not None:
            c.lfa_slot = np.full(p_n, -1, np.int32)
            c.lfa_metric = np.zeros(p_n, np.int32)
            c.lfa_slot[rows] = lfa_slot[keep]
            c.lfa_metric[rows] = lfa_metric[keep]
        c.ok = np.zeros(p_n, bool)
        c.ok[rows] = True
        self.cols = c  # old bundle stays with whatever views hold it
        self.epoch += 1
        self.journal_floor = self.epoch
        self.journal = []
        self.routes = {}
        self.materialized = False

    def set_full_arrays(self, met, s3, nh, lfa_slot=None, lfa_metric=None,
                        ok=None) -> None:
        """Cold rebuild from UNPACKED arrays (the sharded fabric path,
        whose kernel returns bool masks + a device-computed ok)."""
        if ok is None:
            ok = route_ok_rows(
                self.matrix, self.root_idx, slice(0, self.p_n),
                met, s3, nh, self.block_v4,
            )
        rows = np.flatnonzero(ok)
        self.set_full_packed(
            rows, met[rows].astype(np.int32),
            pack_words_host(s3[rows]), pack_words_host(nh[rows]),
            None if lfa_slot is None else lfa_slot[rows].astype(np.int32),
            None if lfa_metric is None else lfa_metric[rows].astype(np.int32),
        )

    def apply_rows(self, rows: np.ndarray, met, s3w, nhw,
                   lfa_slot=None, lfa_metric=None, ok=None,
                   exact: bool = False) -> None:
        """Steady-state delta: patch the changed rows in place (after
        copy-on-write if a snapshot is watching). When `ok` is None
        (classic delta payload) the route-level filter is recomputed
        host-side, which costs an unpack of both word planes; a caller
        holding the device route-ok bit (apply_rows_packed) passes it
        in and the unpack only happens if the eager route cache needs
        the masks."""
        rows = np.asarray(rows)
        live = rows < self.p_n
        if not live.all():
            rows = rows[live]
            met = met[live]
            s3w = s3w[live]
            nhw = nhw[live]
            if ok is not None:
                ok = ok[live]
            if lfa_slot is not None:
                lfa_slot = lfa_slot[live]
                lfa_metric = lfa_metric[live]
        if not len(rows):
            return
        self._cow()
        c = self.cols
        a_cap = self.matrix.ann_node.shape[1]
        d_n = len(self.links)
        s3 = nhm = None
        if ok is None:
            s3 = unpack_words(s3w, a_cap)
            nhm = unpack_words(nhw, max(d_n, 1))
            ok = route_ok_rows(
                self.matrix, self.root_idx, rows, met, s3, nhm,
                self.block_v4,
            )
        c.met[rows] = met
        c.s3w[rows] = s3w
        c.nhw[rows] = nhw
        if lfa_slot is not None and c.lfa_slot is not None:
            c.lfa_slot[rows] = lfa_slot
            c.lfa_metric[rows] = lfa_metric
        c.ok[rows] = ok
        c._key_rows = None
        c._row_of = None
        self.epoch += 1
        self.journal.append((self.epoch, np.asarray(rows), exact))
        if len(self.journal) > _JOURNAL_MAX:
            dropped_epoch, _, _ = self.journal.pop(0)
            self.journal_floor = dropped_epoch
        # keep the route cache coherent: eager patch when complete
        # (preserves the seed's O(changed) steady-state cost), row-wise
        # invalidation when partial
        plist = self.matrix.prefix_list
        if self.materialized:
            if s3 is None:
                s3 = unpack_words(s3w, a_cap)
                nhm = unpack_words(nhw, max(d_n, 1))
            for i, r in enumerate(rows.tolist()):
                if not ok[i]:
                    self.routes.pop(plist[r], None)
            keep = np.flatnonzero(ok)
            if len(keep):
                build_entries(
                    self.routes, self.nh_cache, self.my_node_name,
                    self.matrix, self.links, rows[keep], met, s3, nhm,
                    lfa_slot, lfa_metric, value_rows=keep,
                    use_v4_allowed=self.use_v4_allowed,
                )
        elif self.routes:
            for r in rows.tolist():
                self.routes.pop(plist[r], None)

    def apply_rows_packed(self, rows: np.ndarray, met, s3w, nhw, ok,
                          lfa_slot=None, lfa_metric=None) -> None:
        """Streaming-epoch delta (ops/stream.py payload): the device
        route-ok bit arrives with the rows, so the patch is pure column
        writes — no host word-unpack, no route_ok_rows recompute — and
        the journal entry is device-exact: the row set is EXACTLY the
        rows whose columns differ from the previous epoch, which lets
        fast_unicast_column_diff skip its re-compare (exact_since)."""
        self.apply_rows(
            rows, met, s3w, nhw, lfa_slot, lfa_metric,
            ok=np.asarray(ok, bool), exact=True,
        )

    # -- reads (view side) -------------------------------------------------

    def covers(self, epoch: int) -> bool:
        return epoch >= self.journal_floor

    def changed_rows_since(self, epoch: int) -> np.ndarray:
        parts = [r for e, r, _x in self.journal if e > epoch]
        if not parts:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate(parts))

    def exact_since(self, epoch: int) -> bool:
        """True iff the journal from `epoch` to the tip is ONE
        device-exact entry — the streaming steady state, one epoch per
        solve. The on-device diff is exact against the IMMEDIATELY
        preceding epoch only: across several epochs the union may hold
        rows that changed and changed back, which only a host
        re-compare filters out. When this holds,
        fast_unicast_column_diff consumes changed_rows_since verbatim
        instead of re-comparing the columns."""
        entries = [x for e, _r, x in self.journal if e > epoch]
        return len(entries) == 1 and entries[0]

    def _build_rows_into(self, cols: _Cols, rows: np.ndarray,
                         routes: dict) -> None:
        a_cap = self.matrix.ann_node.shape[1]
        d_n = len(self.links)
        build_entries(
            routes, self.nh_cache, self.my_node_name, self.matrix,
            self.links, rows,
            cols.met[rows],
            unpack_words(cols.s3w[rows], a_cap),
            unpack_words(cols.nhw[rows], max(d_n, 1)),
            None if cols.lfa_slot is None else cols.lfa_slot[rows],
            None if cols.lfa_metric is None else cols.lfa_metric[rows],
            value_rows=np.arange(len(rows)),
            use_v4_allowed=self.use_v4_allowed,
        )

    def materialize(self) -> dict:
        """Bulk-build every ok row (the consumption-boundary path)."""
        if self.materialized:
            return self.routes
        import time as _time

        t0 = _time.perf_counter()
        self.routes = {}
        rows = self.cols.key_rows()
        if len(rows):
            self._build_rows_into(self.cols, rows, self.routes)
        self.materialized = True
        counters.add_stat_value(
            "decision.crib.materialize_ms",
            (_time.perf_counter() - t0) * 1e3,
        )
        return self.routes

    def entry_for_row(self, r: int, bulk: bool = False):
        prefix = self.matrix.prefix_list[r]
        e = self.routes.get(prefix)
        if e is None and not self.materialized:
            if bulk:
                self.materialize()
            else:
                self._build_rows_into(
                    self.cols, np.asarray([r]), self.routes
                )
            e = self.routes.get(prefix)
        return e

    def view(self) -> "RibView":
        return RibView(self)


class RibView:
    """Immutable snapshot of a ColumnarRib. Current (bundle identity
    matches the crib's) -> delegates to the crib's shared cache; stale
    -> rebuilds rows on demand from its own retained bundle."""

    __slots__ = ("crib", "cols", "epoch", "_routes", "_forced",
                 "__weakref__")

    def __init__(self, crib: ColumnarRib):
        self.crib = crib
        self.cols = crib.cols
        self.epoch = crib.epoch
        self._routes: Optional[dict] = None  # own build when stale
        self._forced = False
        crib._views.add(self)

    @property
    def current(self) -> bool:
        return self.cols is self.crib.cols

    def key_rows(self) -> np.ndarray:
        return self.cols.key_rows()

    def prefixes(self) -> list[str]:
        plist = self.crib.matrix.prefix_list
        return [plist[r] for r in self.key_rows().tolist()]

    def _row_of(self, prefix: str):
        c = self.cols
        if c._row_of is None:
            plist = self.crib.matrix.prefix_list
            c._row_of = {plist[r]: r for r in self.key_rows().tolist()}
        return c._row_of.get(prefix)

    def has(self, prefix: str) -> bool:
        return self._row_of(prefix) is not None

    def get(self, prefix: str, bulk: bool = True):
        r = self._row_of(prefix)
        if r is None:
            return None
        if self.current:
            return self.crib.entry_for_row(r, bulk=bulk)
        if self._routes is None:
            self._routes = {}
        e = self._routes.get(prefix)
        if e is None:
            if bulk and not self._forced:
                return self.all_routes().get(prefix)
            self.crib._build_rows_into(
                self.cols, np.asarray([r]), self._routes
            )
            e = self._routes.get(prefix)
        return e

    def all_routes(self) -> dict:
        if self.current:
            return self.crib.materialize()
        if not self._forced:
            routes = {}
            rows = self.key_rows()
            if len(rows):
                self.crib._build_rows_into(self.cols, rows, routes)
            self._routes = routes
            self._forced = True
        return self._routes


class LazyUnicastRoutes(MutableMapping):
    """DecisionRouteDb.unicast_routes when the device path ran: host
    `base` routes shadowed by per-area RibViews, with post-build
    mutations captured in overrides/deleted (so RibPolicy edits and
    static insertions neither force materialization nor break the
    journal diff — mutated keys simply join the diff's candidate set).

    Iteration/len/contains are cheap (ok-mask key sets); values force.
    Equality materializes both sides (dict == LazyUnicastRoutes works
    through the reflected __eq__)."""

    __slots__ = ("base", "segments", "overrides", "deleted",
                 "_merged", "_keys")

    def __init__(self, base=None, segments=()):
        self.base: dict = dict(base) if base else {}
        self.segments: list[RibView] = list(segments)  # later wins
        self.overrides: dict = {}
        self.deleted: set = set()
        self._merged: Optional[dict] = None  # full snapshot once forced
        self._keys: Optional[dict] = None

    # -- reads -------------------------------------------------------------

    def __getitem__(self, k):
        if self._merged is not None:
            return self._merged[k]
        if k in self.deleted:
            raise KeyError(k)
        if k in self.overrides:
            return self.overrides[k]
        for seg in reversed(self.segments):
            e = seg.get(k)
            if e is not None:
                return e
        return self.base[k]

    def __contains__(self, k):
        if self._merged is not None:
            return k in self._merged
        if k in self.deleted:
            return False
        if k in self.overrides:
            return True
        return any(seg.has(k) for seg in self.segments) or k in self.base

    def _key_set(self) -> dict:
        if self._keys is None:
            ks = dict.fromkeys(self.base)
            for seg in self.segments:
                ks.update(dict.fromkeys(seg.prefixes()))
            ks.update(dict.fromkeys(self.overrides))
            for k in self.deleted:
                ks.pop(k, None)
            self._keys = ks
        return self._keys

    def __iter__(self):
        if self._merged is not None:
            return iter(self._merged)
        return iter(self._key_set())

    def __len__(self):
        if self._merged is not None:
            return len(self._merged)
        return len(self._key_set())

    def snapshot(self) -> "LazyUnicastRoutes":
        """Detached copy sharing the column bundles: fresh RibViews pin
        the current generation (copy-on-write protects them from future
        solver patches) while host layers are shallow-copied. O(1) in
        routes — this is how the Fib actor swaps a 100k-route desired
        state without re-keying a dict."""
        segs = []
        for s in self.segments:
            v = RibView(s.crib)
            if v.cols is not s.cols:  # pin s's generation, not the tip
                v.cols = s.cols
                v.epoch = s.epoch
            segs.append(v)
        lz = LazyUnicastRoutes(self.base, segs)
        lz.overrides = dict(self.overrides)
        lz.deleted = set(self.deleted)
        return lz

    def materialized(self) -> dict:
        """Force: one bulk build per segment, then a flat snapshot."""
        if self._merged is None:
            m = dict(self.base)
            for seg in self.segments:
                m.update(seg.all_routes())
            m.update(self.overrides)
            for k in self.deleted:
                m.pop(k, None)
            self._merged = m
        return self._merged

    # -- mutation ----------------------------------------------------------

    def __setitem__(self, k, v):
        self.deleted.discard(k)
        self.overrides[k] = v
        if self._merged is not None:
            self._merged[k] = v
        self._keys = None

    def __delitem__(self, k):
        if k not in self:
            raise KeyError(k)
        self.overrides.pop(k, None)
        self.deleted.add(k)
        if self._merged is not None:
            self._merged.pop(k, None)
        self._keys = None

    # -- comparison --------------------------------------------------------

    def __eq__(self, other):
        if isinstance(other, LazyUnicastRoutes):
            other = other.materialized()
        if isinstance(other, dict):
            return self.materialized() == other
        return NotImplemented

    __hash__ = None  # type: ignore[assignment]

    def __repr__(self):
        n_seg = len(self.segments)
        return (
            f"LazyUnicastRoutes(len={len(self)}, segments={n_seg}, "
            f"base={len(self.base)}, overrides={len(self.overrides)})"
        )


def _lookup(lz: LazyUnicastRoutes, k):
    """Per-key resolution WITHOUT bulk-forcing a segment (the diff only
    touches O(changed) keys; a bulk build would defeat it)."""
    if lz._merged is not None:
        return lz._merged.get(k)
    if k in lz.deleted:
        return None
    v = lz.overrides.get(k)
    if v is not None:
        return v
    for seg in reversed(lz.segments):
        e = seg.get(k, bulk=False)
        if e is not None:
            return e
    return lz.base.get(k)


def fast_unicast_diff(old, new):
    """Vectorized unicast diff between two LazyUnicastRoutes built from
    the SAME cribs: the device already compared every row (the delta
    journal), so only journaled rows + host-touched keys (bases,
    overrides, deletions) need entry-level comparison. Returns
    (to_update dict, to_delete list) or None when ineligible — caller
    falls back to the full per-entry compare."""
    if not (
        isinstance(old, LazyUnicastRoutes)
        and isinstance(new, LazyUnicastRoutes)
    ):
        return None
    if len(old.segments) != len(new.segments):
        return None
    pairs = []
    for so, sn in zip(old.segments, new.segments):
        crib = sn.crib
        if so.crib is not crib:
            return None
        # the new side must be the crib's live tip (so unjournaled rows
        # are provably identical) and the old side within journal reach
        if sn.cols is not crib.cols or sn.epoch != crib.epoch:
            return None
        if not crib.covers(so.epoch):
            return None
        pairs.append((so, crib))

    candidates = (
        set(old.base) | set(new.base)
        | set(old.overrides) | set(new.overrides)
        | old.deleted | new.deleted
    )
    for so, crib in pairs:
        plist = crib.matrix.prefix_list
        p_n = crib.p_n
        for r in crib.changed_rows_since(so.epoch).tolist():
            if r < p_n:
                candidates.add(plist[r])

    to_update: dict = {}
    to_delete: list = []
    for k in candidates:
        nv = _lookup(new, k)
        ov = _lookup(old, k)
        if nv is None:
            if ov is not None:
                to_delete.append(k)
        elif ov is None or ov != nv:
            to_update[k] = nv
    to_delete.sort()
    return to_update, to_delete
