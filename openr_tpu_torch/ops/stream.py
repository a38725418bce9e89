"""Column diff and fixed-size row compaction (plain versions).

``column_diff`` marks the prefix rows whose published columns differ
from the previous solve's resident planes; ``compact_rows`` gathers the
marked rows to the front of a fixed-size payload. Together they are the
plain version of the compaction kernel (``ops/compact.py``, K4), which
builds both pull buffers on the card without a host sync.
"""

from __future__ import annotations

import torch


def column_diff(metric, s3w, nhw, prev_metric, prev_s3w, prev_nhw,
                lfa=None):
    """bool [P]: rows whose (metric, s3 words, nh words) changed — and,
    with ``lfa`` = (lfa_slot, lfa_metric, prev_lfa_slot,
    prev_lfa_metric), whose backup slot or metric changed. The route-ok
    bit is a pure function of the (metric, s3, nh) columns for a fixed
    matrix and root, so comparing the columns alone is complete."""
    changed = (
        (metric != prev_metric)
        | (s3w != prev_s3w).any(dim=1)
        | (nhw != prev_nhw).any(dim=1)
    )
    if lfa is not None:
        slot, alt, prev_slot, prev_alt = lfa
        changed |= (slot != prev_slot) | (alt != prev_alt)
    return changed


def compact_rows(mask, trips: int, metric, s3w, nhw, size: int,
                 p_cap: int, lfa_cols=None) -> list:
    """Head of a pull payload: [count, trips, idx[size], metric[size],
    s3w[size*wa], nhw[size*wd]] for the rows where ``mask`` is set, in
    row order, then with ``lfa_cols`` = (lfa_slot, lfa_metric) their
    [size] gathers. Pad index slots carry ``p_cap``; their values are
    those of row ``p_cap - 1`` (the clipped gather)."""
    dev = metric.device
    hit = mask.nonzero().flatten()[:size].to(torch.int32)
    idx = torch.full((size,), p_cap, dtype=torch.int32, device=dev)
    idx[: hit.shape[0]] = hit
    safe = idx.clamp(0, p_cap - 1).long()
    head = torch.tensor(
        [int(mask.sum()), trips], dtype=torch.int32, device=dev
    )
    cols = [head, idx, metric[safe], s3w[safe].flatten(),
            nhw[safe].flatten()]
    if lfa_cols is not None:
        cols += [c[safe] for c in lfa_cols]
    return cols
