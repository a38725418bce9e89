"""Global prefix advertisement state.

Role of the reference's openr/decision/PrefixState.{h,cpp}: map
prefix -> PrefixEntries (= map (node, area) -> PrefixEntry), with
update/delete returning the set of changed prefixes so Decision can do
incremental recomputation, plus received-routes dump for the ctrl API.
"""

from __future__ import annotations

from typing import Optional

import functools

from openr_tpu_torch.types import PrefixDatabase, PrefixEntry, parse_prefix

# (node, area) -> advertised entry
PrefixEntries = dict


# unbounded: the LSDB-scale target is ~100k prefixes and an LRU bound
# below the working set thrashes (ip_network parsing is ~25us a miss —
# a 64k bound cost ~2s per 100k-prefix matrix rebuild); entries are
# small interned strings
@functools.lru_cache(maxsize=None)
def canonical_prefix(prefix: str) -> str:
    return str(parse_prefix(prefix))


class PrefixState:
    def __init__(self) -> None:
        self._prefixes: dict[str, PrefixEntries] = {}
        # bumped on every applied change; derived structures (the device
        # announcer matrix, ops/csr.py) key their caches on it
        self.generation = 0

    def prefixes(self) -> dict[str, PrefixEntries]:
        return self._prefixes

    def entries_for(self, prefix: str) -> Optional[PrefixEntries]:
        return self._prefixes.get(canonical_prefix(prefix))

    def update_prefix_database(self, db: PrefixDatabase) -> set[str]:
        """Apply one per-prefix-key database (single entry + tombstone flag,
        ref PrefixState::updatePrefix); returns changed prefixes."""
        node_area = (db.this_node_name, db.area)
        changed: set[str] = set()
        for entry in db.prefix_entries:
            pfx = canonical_prefix(entry.prefix)
            if db.delete_prefix:
                entries = self._prefixes.get(pfx)
                if entries is not None and node_area in entries:
                    del entries[node_area]
                    if not entries:
                        del self._prefixes[pfx]
                    changed.add(pfx)
            else:
                entries = self._prefixes.setdefault(pfx, {})
                if entries.get(node_area) != entry:
                    entries[node_area] = entry
                    changed.add(pfx)
        if changed:
            self.generation += 1
        return changed

    def delete_entries_of(self, node: str, area: str) -> set[str]:
        """Drop every advertisement by (node, area) — key expiry path."""
        node_area = (node, area)
        changed: set[str] = set()
        for pfx in list(self._prefixes):
            entries = self._prefixes[pfx]
            if node_area in entries:
                del entries[node_area]
                if not entries:
                    del self._prefixes[pfx]
                changed.add(pfx)
        if changed:
            self.generation += 1
        return changed

    def received_routes(
        self, prefix_filter: str = "", node_filter: str = ""
    ) -> list[tuple[str, tuple[str, str], PrefixEntry]]:
        """Filtered dump (ref PrefixState::getReceivedRoutesFiltered)."""
        out = []
        for pfx, entries in self._prefixes.items():
            if prefix_filter and pfx != canonical_prefix(prefix_filter):
                continue
            for node_area, entry in entries.items():
                if node_filter and node_area[0] != node_filter:
                    continue
                out.append((pfx, node_area, entry))
        return out
