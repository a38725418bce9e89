"""Packed column deltas: the zero-copy RIB -> FIB spine.

BENCH_r05 put the cold 100k bottleneck at host materialization: the
solver's packed device output was immediately re-expressed as ~100k
`RibUnicastEntry` objects so the diff, the Fib actor, and the platform
agent could each walk them one at a time. This module keeps that state
columnar end-to-end (the DeltaPath argument — routing state as columnar
dataflow deltas, PAPERS.md arXiv 1808.06893):

  `ColumnDelta`        what `DecisionRouteDb.calculate_update` now
                       produces on the device path: per-segment changed
                       row arrays over live `RibView`s + the small
                       host-touched remainder as real entries. Carries a
                       cheap `LazyUnicastRoutes` snapshot of the new
                       table so the Fib actor can swap desired state in
                       O(1) instead of re-keying 100k dict slots.
  `ColumnUpdateMap`    the Mapping face of a delta
                       (`DecisionRouteUpdate.unicast_routes_to_update`):
                       len/iter/contains are array-backed; values
                       materialize entries in one bulk pass only when a
                       consumer (ctrl/breeze/policy) actually asks.
  `RouteColumnBatch`   the wire/dataplane form: packed
                       (family, prefixlen, address, metric) arrays + a
                       shared next-hop group table, built without
                       constructing route objects. The platform bulk
                       programmer encodes native netlink records
                       straight from these arrays.

The diff (`fast_unicast_column_diff`) compares COLUMNS, not entries:
entry construction is a pure function of (columns, matrix, links), so
byte-equal rows are route-equal and only host-touched keys (bases,
overrides, deletions, cross-segment shadowing) need the object path.
That extends the PR-1 journal diff to the COLD case — an empty old side
is a full-table delta with zero compares and zero entry builds.
"""

from __future__ import annotations

import dataclasses
import enum
import socket as _socket
from collections.abc import Mapping
from typing import Optional

import numpy as np

from openr_tpu_torch.decision.columnar_rib import (
    LazyUnicastRoutes,
    RibView,
    _lookup,
    unpack_words,
)
from openr_tpu_torch.runtime.counters import counters


def prefix_codec(matrix) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(family u8[P], prefixlen u8[P], address u8[P,16]) for every row of
    a PrefixMatrix, parsed ONCE per matrix generation and cached on the
    matrix — every subsequent batch build indexes these arrays instead of
    re-parsing prefix strings per route."""
    codec = getattr(matrix, "_prefix_codec", None)
    if codec is not None:
        return codec
    plist = matrix.prefix_list
    p_n = len(plist)
    family = np.zeros(p_n, np.uint8)
    plen = np.zeros(p_n, np.uint8)
    addr = np.zeros((p_n, 16), np.uint8)
    v4 = _socket.AF_INET
    v6 = _socket.AF_INET6
    for i, pfx in enumerate(plist):
        ip, _, ln = pfx.partition("/")
        if ":" in ip:
            family[i] = v6
            plen[i] = int(ln) if ln else 128
            addr[i] = np.frombuffer(_socket.inet_pton(v6, ip), np.uint8)
        else:
            family[i] = v4
            plen[i] = int(ln) if ln else 32
            addr[i, :4] = np.frombuffer(_socket.inet_pton(v4, ip), np.uint8)
    # mask host bits so addr is the NETWORK address, matching what the
    # per-route pack derives via ip_network(prefix, strict=False)
    span = np.clip(
        plen.astype(np.int32)[:, None]
        - np.arange(16, dtype=np.int32) * 8,
        0, 8,
    )
    addr &= ((0xFF00 >> span) & 0xFF).astype(np.uint8)
    codec = (family, plen, addr)
    matrix._prefix_codec = codec
    return codec


def _to_plain(obj):
    """Dataclass tree -> JSON-able plain value (the wire codec's
    to_plain, kept here for the one entry type this module emits)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, enum.Enum):
        return int(obj.value)
    if isinstance(obj, bytes):
        return {"__bytes__": obj.hex()}
    if dataclasses.is_dataclass(obj):
        return {
            f.name: _to_plain(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [_to_plain(v) for v in obj]
    if isinstance(obj, Mapping):
        return {str(k): _to_plain(v) for k, v in obj.items()}
    raise TypeError(f"cannot serialize {type(obj)!r}")


def _plain_entry(entry) -> dict:
    return entry if isinstance(entry, dict) else _to_plain(entry)


class RouteColumnBatch:
    """Packed route table/delta at the platform seam. Row i programs
    prefixes[i] with metric[i] via next-hop group nh_gid[i]; `extra` is
    the small host-built remainder (statics, policy overrides) as plain
    route dicts — it rides the batch but takes the object path."""

    __slots__ = (
        "prefixes", "family", "plen", "addr", "metric", "nh_gid",
        "nh_groups", "extra",
    )

    def __init__(self, prefixes, family, plen, addr, metric, nh_gid,
                 nh_groups, extra=None):
        self.prefixes: list[str] = prefixes
        self.family = family
        self.plen = plen
        self.addr = addr
        self.metric = metric
        self.nh_gid = nh_gid
        # group -> list of next-hop descriptor dicts (address, if_name,
        # weight, area, neighbor_node_name); per-route metric is filled
        # at materialization, never stored per group
        self.nh_groups: list[list[dict]] = nh_groups
        self.extra: dict[str, dict] = {
            p: _plain_entry(e) for p, e in (extra or {}).items()
        }

    def __len__(self) -> int:
        return len(self.prefixes)

    def route_count(self) -> int:
        return len(self.prefixes) + len(self.extra)

    def prefix_set(self) -> set:
        s = set(self.prefixes)
        s.update(self.extra)
        return s

    # -- object-path views (dump / fallback / oracle) ----------------------

    def route_dict(self, i: int) -> dict:
        m = int(self.metric[i])
        nhs = [
            dict(nh, metric=m) for nh in self.nh_groups[int(self.nh_gid[i])]
        ]
        return {
            "prefix": self.prefixes[i],
            "nexthops": nhs,
            "igp_cost": m,
            "best_node_area": None,
            "best_prefix_entry": None,
            "do_not_install": False,
        }

    def iter_route_dicts(self):
        for i in range(len(self.prefixes)):
            yield self.prefixes[i], self.route_dict(i)
        yield from self.extra.items()

    def as_route_dicts(self) -> dict[str, dict]:
        return dict(self.iter_route_dicts())

    # -- wire form (runtime/rpc JSON frames) -------------------------------

    def to_wire(self) -> dict:
        import base64

        b64 = lambda a: base64.b64encode(  # noqa: E731
            np.ascontiguousarray(a).tobytes()
        ).decode()
        return {
            "n": len(self.prefixes),
            "prefixes": self.prefixes,
            "family": b64(self.family),
            "plen": b64(self.plen),
            "addr": b64(self.addr),
            "metric": b64(self.metric.astype(np.int32)),
            "nh_gid": b64(self.nh_gid.astype(np.int32)),
            "nh_groups": self.nh_groups,
            "extra": self.extra,
        }

    @classmethod
    def from_wire(cls, obj: dict) -> "RouteColumnBatch":
        import base64

        n = int(obj["n"])
        arr = lambda k, dt: np.frombuffer(  # noqa: E731
            base64.b64decode(obj[k]), dt
        )
        return cls(
            prefixes=list(obj["prefixes"]),
            family=arr("family", np.uint8),
            plen=arr("plen", np.uint8),
            addr=arr("addr", np.uint8).reshape(n, 16),
            metric=arr("metric", np.int32),
            nh_gid=arr("nh_gid", np.int32),
            nh_groups=[list(g) for g in obj["nh_groups"]],
            extra=dict(obj.get("extra") or {}),
        )


def _segment_batch_parts(view: RibView, rows: np.ndarray, gid_base: int):
    """Column arrays + next-hop group table for `rows` of one RibView —
    no per-route Python objects, only the per-GROUP descriptor decode."""
    crib = view.crib
    cols = view.cols
    matrix = crib.matrix
    family, plen, addr = prefix_codec(matrix)
    d_n = max(len(crib.links), 1)
    nhw = cols.nhw[rows]
    use_v4 = matrix.is_v4[rows] if crib.use_v4_allowed else np.zeros(
        len(rows), bool
    )
    aug = np.concatenate(
        [nhw, use_v4.astype(np.int32)[:, None]], axis=1
    )
    uniq, inv = np.unique(aug, axis=0, return_inverse=True)
    inv = inv.reshape(-1)  # numpy 2.0 returned [N,1] for axis-unique
    bits = unpack_words(uniq[:, :-1], d_n)
    me = crib.my_node_name
    groups = []
    for g in range(len(uniq)):
        v4 = bool(uniq[g, -1])
        groups.append([
            {
                "address": crib.links[d].nh_from_node(me, v4),
                "if_name": crib.links[d].iface_from_node(me),
                "area": crib.links[d].area,
                "neighbor_node_name": crib.links[d].other_node(me),
                "weight": 0,
                "mpls_action": None,
            }
            for d in np.flatnonzero(bits[g]).tolist()
        ])
    plist = matrix.prefix_list
    prefixes = [plist[r] for r in rows.tolist()]
    return (
        prefixes, family[rows], plen[rows], addr[rows],
        cols.met[rows].astype(np.int32),
        (inv + gid_base).astype(np.int32), groups,
    )


def _shadowed_rows(lazy: LazyUnicastRoutes, i: int, view: RibView,
                   rows: np.ndarray) -> np.ndarray:
    """Mask of `rows` whose prefix is NOT visible through segment i —
    overridden/deleted by the host, or shadowed by a later segment."""
    later = lazy.segments[i + 1:]
    if not later and not lazy.overrides and not lazy.deleted:
        return np.zeros(len(rows), bool)
    plist = view.crib.matrix.prefix_list
    mask = np.zeros(len(rows), bool)
    ov, dl = lazy.overrides, lazy.deleted
    for j, r in enumerate(rows.tolist()):
        p = plist[r]
        if p in ov or p in dl or any(s.has(p) for s in later):
            mask[j] = True
    return mask


def build_column_batch(lazy) -> Optional[RouteColumnBatch]:
    """Pack a LazyUnicastRoutes table into a RouteColumnBatch, or None
    when the table is not column-backed (plain dict fallback)."""
    if not isinstance(lazy, LazyUnicastRoutes):
        return None
    parts = []
    gid_base = 0
    for i, view in enumerate(lazy.segments):
        rows = view.key_rows()
        shadow = _shadowed_rows(lazy, i, view, rows)
        if shadow.any():
            rows = rows[~shadow]
        if not len(rows):
            continue
        part = _segment_batch_parts(view, rows, gid_base)
        gid_base += len(part[6])
        parts.append(part)
    # host remainder: base routes not shadowed by any view + overrides
    extra = {
        p: e
        for p, e in lazy.base.items()
        if p not in lazy.deleted
        and p not in lazy.overrides
        and not any(s.has(p) for s in lazy.segments)
    }
    extra.update(
        {p: e for p, e in lazy.overrides.items() if p not in lazy.deleted}
    )
    if not parts:
        return RouteColumnBatch(
            [], np.zeros(0, np.uint8), np.zeros(0, np.uint8),
            np.zeros((0, 16), np.uint8), np.zeros(0, np.int32),
            np.zeros(0, np.int32), [], extra,
        )
    return RouteColumnBatch(
        prefixes=[p for part in parts for p in part[0]],
        family=np.concatenate([part[1] for part in parts]),
        plen=np.concatenate([part[2] for part in parts]),
        addr=np.concatenate([part[3] for part in parts]),
        metric=np.concatenate([part[4] for part in parts]),
        nh_gid=np.concatenate([part[5] for part in parts]),
        nh_groups=[g for part in parts for g in part[6]],
        extra=extra,
    )


class ColumnUpdateMap(Mapping):
    """`unicast_routes_to_update` of a columnar build: iteration, len
    and membership run on the packed arrays; reading a VALUE builds the
    entries (bulk on full reads, single-row on point lookups) — the
    lazy object view ctrl/breeze/policy consumers get."""

    __slots__ = ("_delta", "_forced", "_row_sets")

    def __init__(self, delta: "ColumnDelta"):
        self._delta = delta
        self._forced: Optional[dict] = None
        self._row_sets: Optional[list] = None

    def __len__(self) -> int:
        if self._forced is not None:
            return len(self._forced)
        d = self._delta
        return sum(len(r) for _, r in d.segments) + len(d.extra_updates)

    def __iter__(self):
        if self._forced is not None:
            return iter(self._forced)
        return self._delta.update_prefixes()

    def _rows_of(self, i: int) -> set:
        if self._row_sets is None:
            self._row_sets = [None] * len(self._delta.segments)
        s = self._row_sets[i]
        if s is None:
            s = self._row_sets[i] = set(
                self._delta.segments[i][1].tolist()
            )
        return s

    def __contains__(self, k):
        if self._forced is not None:
            return k in self._forced
        d = self._delta
        if k in d.extra_updates:
            return True
        for i, (view, _rows) in enumerate(d.segments):
            r = view._row_of(k)
            if r is not None and r in self._rows_of(i):
                return True
        return False

    def __getitem__(self, k):
        if self._forced is not None:
            return self._forced[k]
        d = self._delta
        e = d.extra_updates.get(k)
        if e is not None:
            return e
        for i, (view, _rows) in enumerate(d.segments):
            r = view._row_of(k)
            if r is not None and r in self._rows_of(i):
                e = view.get(k, bulk=False)
                if e is not None:
                    return e
        raise KeyError(k)

    def items(self):
        return self.materialized().items()

    def values(self):
        return self.materialized().values()

    def materialized(self) -> dict:
        if self._forced is None:
            self._forced = self._delta.materialize_updates()
        return self._forced

    def __eq__(self, other):
        if isinstance(other, ColumnUpdateMap):
            other = other.materialized()
        if isinstance(other, Mapping):
            return self.materialized() == dict(other)
        return NotImplemented

    __hash__ = None  # type: ignore[assignment]

    def __repr__(self):
        return (
            f"ColumnUpdateMap(len={len(self)}, "
            f"segments={len(self._delta.segments)}, "
            f"extra={len(self._delta.extra_updates)})"
        )


class ColumnDelta:
    """One build's route delta in column form: per-segment changed-row
    arrays over the new table's views, host-touched updates as entries,
    deletes as prefix strings, and a cheap snapshot of the whole new
    table so consumers replacing state (Fib full sync) never re-key."""

    __slots__ = (
        "segments", "extra_updates", "deletes", "full", "new_mapping",
        "_batch",
    )

    def __init__(self, segments, extra_updates, deletes, full,
                 new_mapping):
        self.segments: list[tuple[RibView, np.ndarray]] = segments
        self.extra_updates: dict = extra_updates
        self.deletes: list[str] = deletes
        self.full: bool = full  # True = delta covers the whole table
        self.new_mapping: Optional[LazyUnicastRoutes] = new_mapping
        self._batch: Optional[RouteColumnBatch] = None

    def update_count(self) -> int:
        return sum(len(r) for _, r in self.segments) + len(
            self.extra_updates
        )

    def update_prefixes(self):
        for view, rows in self.segments:
            plist = view.crib.matrix.prefix_list
            for r in rows.tolist():
                yield plist[r]
        yield from self.extra_updates

    def lazy_map(self) -> ColumnUpdateMap:
        return ColumnUpdateMap(self)

    def materialize_updates(self) -> dict:
        out = {}
        for view, rows in self.segments:
            if len(rows):
                view.crib._build_rows_into(view.cols, rows, out)
        out.update(self.extra_updates)
        return out

    def to_batch(self) -> RouteColumnBatch:
        """Packed form of the UPDATE side (the delta's own rows, not the
        whole table — for a full/cold delta they coincide)."""
        if self._batch is None:
            parts = []
            gid_base = 0
            for view, rows in self.segments:
                if not len(rows):
                    continue
                part = _segment_batch_parts(view, rows, gid_base)
                gid_base += len(part[6])
                parts.append(part)
            if parts:
                self._batch = RouteColumnBatch(
                    prefixes=[p for pt in parts for p in pt[0]],
                    family=np.concatenate([pt[1] for pt in parts]),
                    plen=np.concatenate([pt[2] for pt in parts]),
                    addr=np.concatenate([pt[3] for pt in parts]),
                    metric=np.concatenate([pt[4] for pt in parts]),
                    nh_gid=np.concatenate([pt[5] for pt in parts]),
                    nh_groups=[g for pt in parts for g in pt[6]],
                    extra=self.extra_updates,
                )
            else:
                self._batch = RouteColumnBatch(
                    [], np.zeros(0, np.uint8), np.zeros(0, np.uint8),
                    np.zeros((0, 16), np.uint8), np.zeros(0, np.int32),
                    np.zeros(0, np.int32), [], self.extra_updates,
                )
        return self._batch


def _col_changed_mask(oc, nc, rows: np.ndarray) -> np.ndarray:
    """Row-wise column compare between two bundles: entry construction
    is a pure function of these columns (same matrix/links per crib), so
    byte-equal rows are route-equal."""
    m = (oc.met[rows] != nc.met[rows])
    m |= (oc.s3w[rows] != nc.s3w[rows]).any(axis=1)
    m |= (oc.nhw[rows] != nc.nhw[rows]).any(axis=1)
    m |= oc.ok[rows] != nc.ok[rows]
    if oc.lfa_slot is not None and nc.lfa_slot is not None:
        m |= oc.lfa_slot[rows] != nc.lfa_slot[rows]
        m |= oc.lfa_metric[rows] != nc.lfa_metric[rows]
    elif (oc.lfa_slot is None) != (nc.lfa_slot is None):
        m |= True
    return m


def fast_unicast_column_diff(old, new) -> Optional[ColumnDelta]:
    """Column-native unicast diff old -> new. Requires `new` to be a
    LazyUnicastRoutes whose segments are their cribs' live tips. Two
    modes:

      cold  — `old` is empty: the delta is every ok row + host routes,
              with zero compares and zero entry builds;
      warm  — `old` shares the same cribs within journal reach: the
              device's changed-row journal bounds a vectorized COLUMN
              compare; only host-touched keys take the entry path.

    Returns None when ineligible — the caller falls back to the legacy
    entry-level diff (kept as the parity oracle)."""
    if not isinstance(new, LazyUnicastRoutes):
        return None
    for sn in new.segments:
        crib = sn.crib
        if sn.cols is not crib.cols or sn.epoch != crib.epoch:
            return None

    new_mapping = new.snapshot()

    if len(old) == 0:
        segments = []
        for i, sn in enumerate(new.segments):
            rows = sn.key_rows()
            shadow = _shadowed_rows(new, i, sn, rows)
            if shadow.any():
                rows = rows[~shadow]
            segments.append((sn, rows))
        extra = {
            p: e
            for p, e in new.base.items()
            if p not in new.deleted
            and p not in new.overrides
            and not any(s.has(p) for s in new.segments)
        }
        extra.update(
            {p: e for p, e in new.overrides.items() if p not in new.deleted}
        )
        counters.increment("decision.column_diffs")
        return ColumnDelta(segments, extra, [], True, new_mapping)

    if not isinstance(old, LazyUnicastRoutes):
        return None
    if len(old.segments) != len(new.segments):
        return None
    pairs = []
    for so, sn in zip(old.segments, new.segments):
        crib = sn.crib
        if so.crib is not crib or not crib.covers(so.epoch):
            return None
        pairs.append((so, sn, crib))

    # host-touched keys resolve entry-wise, exactly like the legacy diff
    candidates = (
        set(old.base) | set(new.base)
        | set(old.overrides) | set(new.overrides)
        | old.deleted | new.deleted
    )
    multi = len(new.segments) > 1
    segments = []
    del_prefixes: list[str] = []
    for i, (so, sn, crib) in enumerate(pairs):
        jrows = crib.changed_rows_since(so.epoch)
        jrows = jrows[jrows < crib.p_n]
        oc, nc = so.cols, sn.cols
        if not len(jrows) or oc is nc:
            segments.append((sn, np.zeros(0, np.int64)))
            continue
        if crib.exact_since(so.epoch):
            # streaming steady state: the journal entry came from the
            # on-device column diff (apply_rows_packed), so its row set
            # is exactly the changed set — no host re-compare needed
            changed = jrows
        else:
            changed = jrows[_col_changed_mask(oc, nc, jrows)]
        plist = crib.matrix.prefix_list
        upd = changed[nc.ok[changed]]
        dels = changed[oc.ok[changed] & ~nc.ok[changed]]
        # rows the host also touched (or that another layer shadows)
        # leave the column path and join the entry-compare candidates
        keep = np.ones(len(upd), bool)
        for j, r in enumerate(upd.tolist()):
            p = plist[r]
            if (
                p in candidates
                or (multi and any(
                    s.has(p) for k, s in enumerate(new.segments) if k != i
                ))
            ):
                keep[j] = False
                candidates.add(p)
        segments.append((sn, upd[keep]))
        for r in dels.tolist():
            p = plist[r]
            if (
                p in candidates
                or p in old.base or p in new.base
                or (multi and any(
                    s.has(p)
                    for k, s in enumerate(new.segments) if k != i
                ) or (multi and any(
                    s.has(p)
                    for k, s in enumerate(old.segments) if k != i
                )))
            ):
                candidates.add(p)
            else:
                del_prefixes.append(p)

    extra: dict = {}
    for k in candidates:
        nv = _lookup(new, k)
        ov = _lookup(old, k)
        if nv is None:
            if ov is not None:
                del_prefixes.append(k)
        elif ov is None or ov != nv:
            extra[k] = nv
    del_prefixes.sort()
    counters.increment("decision.column_diffs")
    return ColumnDelta(segments, extra, del_prefixes, False, new_mapping)
