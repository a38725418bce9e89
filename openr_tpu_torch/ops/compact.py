"""Route filter and pull-buffer compaction: the end of the cold solve.

``route_ok`` is the plain version of the route-level filter (the port
of ``route_ok_device``): whether a prefix row's packed outputs describe
a programmable route from the root's vantage. The select kernel
(``ops/select.py``, K3) computes it on the card.

``compact_outputs`` (K4, ``csrc/compact.cu``) builds the two pull
buffers from the per-prefix outputs with a block-scan compaction: the
changed-rows delta payload (``ops/stream.py`` column diff against the
previous solve's planes) and the ok-rows full payload, with the
numerical-health sentinel counts and the trip / round scalars in their
tails. Layouts (int32; B = budget, P = p_cap):

    delta_buf  count, trips, idx[B], metric[B], s3w[B*wa], nhw[B*wd],
               (unreachable, saturated), (cone, fell_back), rounds
    full_buf   okc, trips, idx[P], metric[P], s3w[P*wa], nhw[P*wd],
               (unreachable, saturated), (cone, fell_back), rounds

The sentinel pair is there when sentinels are on, the cone pair when
the solve was incremental; the host parses the tail back to front.

Pad slots past the live count carry index P and the values of row
P - 1 (a fixed-size nonzero fills with P, the gather clips it to the
last row).
"""

from __future__ import annotations

import torch

from openr_tpu_torch.ops import cuda
from openr_tpu_torch.ops.relax import INF_E, _int32, _is_cpu
from openr_tpu_torch.ops.stream import column_diff, compact_rows

# finite metrics past 2^28 sit one metric-add from the 2^29 INF_E
# encoding: the saturation sentinel counts them
SENTINEL_SAT = 1 << 28

_BLOCK = 1024  # rows per block of the count / scatter kernels


def route_ok(metric, s3, nh_mask, ann_node, min_nh, v4_blocked, root: int):
    """bool [P]: row is a real route from ``root``'s vantage.

    metric int32 [P], s3 bool [P, A] selected announcers, nh_mask bool
    [P, D] next-hop slots, ann_node int32 [P, A], min_nh int32 [P, A]
    per-announcement minimum next-hop count, v4_blocked bool [P]."""
    ok = s3.any(dim=1) & (metric < INF_E)
    ok &= ~v4_blocked
    # drop self-announced prefixes (we originated them)
    ok &= ~(s3 & (ann_node == root)).any(dim=1)
    eff_min = torch.where(s3, min_nh, -1).amax(dim=1)
    nhc = nh_mask.sum(dim=1)
    return ok & (eff_min <= nhc) & (nhc > 0)


def buffer_lens(p_cap: int, wa: int, wd: int, budget: int,
                sentinels: bool, incr: bool = False) -> tuple[int, int]:
    """(delta_buf, full_buf) int32 lengths."""
    tail = 1 + (2 if sentinels else 0) + (2 if incr else 0)
    return (2 + budget * (2 + wa + wd) + tail,
            2 + p_cap * (2 + wa + wd) + tail)


def compact_outputs_plain(metric, s3w, nhw, ok, prev_metric, prev_s3w,
                          prev_nhw, flags, trips: int, rounds: int,
                          budget: int, sentinels: bool, incr_tail=None):
    p_cap = metric.shape[0]
    changed = column_diff(metric, s3w, nhw, prev_metric, prev_s3w, prev_nhw)
    delta = compact_rows(changed, trips, metric, s3w, nhw, budget, p_cap)
    full = compact_rows(ok, trips, metric, s3w, nhw, p_cap, p_cap)
    tail = []
    if sentinels:
        live = (flags & 1).bool().any(dim=1)
        unreach = (live & (metric >= INF_E)).sum()
        sat = ((metric < INF_E) & (metric > SENTINEL_SAT)).sum()
        tail = [unreach[None], sat[None]]
    if incr_tail is not None:
        tail += [t.reshape(1) for t in incr_tail]
    rounds_t = torch.tensor([rounds], dtype=torch.int32, device=metric.device)
    tail = [t.to(torch.int32) for t in tail] + [rounds_t]
    return torch.cat(delta + tail), torch.cat(full + tail)


def compact_outputs(metric, s3w, nhw, ok, prev_metric, prev_s3w, prev_nhw,
                    flags, trips: int, rounds: int, budget: int,
                    sentinels: bool, incr_tail=None):
    """-> (delta_buf, full_buf), laid out as the module docstring says.
    ``flags`` is the [P, A] announcer flag plane (bit 0 = valid).
    ``incr_tail`` is the incremental solve's (cone, fell_back), two
    int32 0-d tensors on the device, or None for a cold solve."""
    if _is_cpu(metric):
        return compact_outputs_plain(
            metric, s3w, nhw, ok, prev_metric, prev_s3w, prev_nhw, flags,
            trips, rounds, budget, sentinels, incr_tail,
        )
    _int32(metric, s3w, nhw, prev_metric, prev_s3w, prev_nhw, flags)
    if ok.dtype != torch.bool or not ok.is_contiguous():
        raise ValueError("ok must be a contiguous bool tensor")
    p_cap, wa = s3w.shape
    wd = nhw.shape[1]
    a_cap = flags.shape[1]
    dev = metric.device
    incr = incr_tail is not None
    n_delta, n_full = buffer_lens(p_cap, wa, wd, budget, sentinels, incr)
    delta_buf = torch.empty(n_delta, dtype=torch.int32, device=dev)
    full_buf = torch.empty(n_full, dtype=torch.int32, device=dev)
    nblk = -(-p_cap // _BLOCK)
    blk = torch.empty(4 * nblk, dtype=torch.int32, device=dev)
    p = cuda.ptr
    rows = (p(metric), p(s3w), p(nhw), p(ok), p(prev_metric), p(prev_s3w),
            p(prev_nhw), p(flags))
    cuda.launch("compact", "compact_count", "ppppppppp" + "iiii",
                *rows, p(blk), p_cap, a_cap, wa, wd)
    cone, fell = (p(t) for t in incr_tail) if incr else (0, 0)
    cuda.launch("compact", "compact_scan", "pipp" + "iiiii" + "pp",
                p(blk), nblk, p(delta_buf), p(full_buf), n_delta, n_full,
                int(trips), int(rounds), int(sentinels), cone, fell)
    cuda.launch("compact", "compact_scatter", "ppppppppppp" + "iiiii",
                *rows, p(blk), p(delta_buf), p(full_buf), p_cap, a_cap, wa,
                wd, budget)
    compact_outputs.launches += 3
    return delta_buf, full_buf


compact_outputs.launches = 0
