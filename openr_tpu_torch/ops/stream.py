"""Column diff and fixed-size row compaction (plain versions), and the
streaming epoch's budgets.

``column_diff`` marks the prefix rows whose published columns differ
from the previous solve's resident planes; ``compact_rows`` gathers the
marked rows to the front of a fixed-size payload. Together they are the
plain version of the compaction kernel (``ops/compact.py``, K4), which
builds both pull buffers on the card without a host sync.

The streaming epoch (``decision/gpu_solver.py``, ``streaming_pipeline``)
ships its changed rows in a small bucketed payload that also carries
the device route-ok bit per row, so the host applies the rows without
unpacking words. Its layout (int32, b = the stream budget):

    [0]          count   total changed rows (may exceed b: the host
                         then pulls the full buffer)
    [1]          trips
    [2 : 2+b]    changed row indices (pad slots carry p_cap)
    ... b        metric
    ... b*wa     s3 words
    ... b*wd     nh words
    ... b        route-ok bit (streaming only: the classic delta
                 payload has no ok column)
    ... 2b       lfa slot + metric        (with LFA)
    ... 2        unreachable, saturated   (sentinels on)
    ... 2        cone, fell_back          (a streaming epoch is always
                                           incremental)
    [-1]         rounds
"""

from __future__ import annotations

import torch

# changed-rows budgets of the streaming payload: each vantage takes the
# smallest bucket that held its last epoch's changed rows (growing past
# an overflow), so a quiet vantage pulls the 64-row floor
STREAM_BUDGETS = (64, 256, 1024, 4096)


def stream_budget(n: int):
    """Smallest budget bucket holding ``n`` changed rows, or None past
    the top bucket."""
    for b in STREAM_BUDGETS:
        if n <= b:
            return b
    return None


def stream_payload_len(budget: int, wa: int, wd: int, lfa: bool,
                       sentinels: bool) -> int:
    """int32 length of the streaming payload for ``budget``: a
    within-budget epoch downloads exactly 4x this many bytes, whatever
    p_cap is."""
    n = 2 + budget * (3 + wa + wd)  # count, trips, idx/metric/ok, words
    if lfa:
        n += 2 * budget
    if sentinels:
        n += 2
    n += 2  # cone, fell_back
    n += 1  # rounds
    return n


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
                 p_cap: int, lfa_cols=None, ok=None) -> list:
    """Head of a pull payload: [count, trips, idx[size], metric[size],
    s3w[size*wa], nhw[size*wd]] for the rows where ``mask`` is set, in
    row order, then with ``ok`` (the streaming payload) their route-ok
    bits [size], then with ``lfa_cols`` = (lfa_slot, lfa_metric) their
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
    if ok is not None:
        cols.append(ok[safe].to(torch.int32))
    if lfa_cols is not None:
        cols += [c[safe] for c in lfa_cols]
    return cols
