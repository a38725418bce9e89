"""Column diff and fixed-size row compaction (plain versions).

``column_diff`` marks the prefix rows whose published columns differ
from the previous solve's resident planes; ``compact_rows`` gathers the
marked rows to the front of a fixed-size payload. Together they are the
plain version of the compaction kernel (``ops/compact.py``, K4), which
builds both pull buffers on the card without a host sync.
"""

from __future__ import annotations

import torch


def column_diff(metric, s3w, nhw, prev_metric, prev_s3w, prev_nhw):
    """bool [P]: rows whose (metric, s3 words, nh words) changed. The
    route-ok bit is a pure function of those columns for a fixed matrix
    and root, so comparing them alone is complete."""
    return (
        (metric != prev_metric)
        | (s3w != prev_s3w).any(dim=1)
        | (nhw != prev_nhw).any(dim=1)
    )


def compact_rows(mask, trips: int, metric, s3w, nhw, size: int,
                 p_cap: int) -> list:
    """Head of a pull payload: [count, trips, idx[size], metric[size],
    s3w[size*wa], nhw[size*wd]] for the rows where ``mask`` is set, in
    row order. Pad index slots carry ``p_cap``; their values are those
    of row ``p_cap - 1`` (the clipped gather)."""
    dev = metric.device
    hit = mask.nonzero().flatten()[:size].to(torch.int32)
    idx = torch.full((size,), p_cap, dtype=torch.int32, device=dev)
    idx[: hit.shape[0]] = hit
    safe = idx.clamp(0, p_cap - 1).long()
    head = torch.tensor(
        [int(mask.sum()), trips], dtype=torch.int32, device=dev
    )
    return [head, idx, metric[safe], s3w[safe].flatten(),
            nhw[safe].flatten()]
