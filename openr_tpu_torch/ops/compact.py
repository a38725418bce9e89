"""Route filter and pull-buffer compaction: the end of the cold solve.

``route_ok`` is the plain version of the route-level filter (the port
of ``route_ok_device``): whether a prefix row's packed outputs describe
a programmable route from the root's vantage. The select kernel
(``ops/select.py``, K3) computes it on the card.

``compact_outputs`` (K4, ``csrc/compact.cu``) builds the two pull
buffers from the per-prefix outputs in one cooperative launch (tile
counts, one grid barrier, then each tile ranks and places its rows): the
changed-rows delta payload (``ops/stream.py`` column diff against the
previous solve's planes) and the ok-rows full payload, with the
numerical-health sentinel counts and the trip / round scalars in their
tails. Layouts (int32; B = budget, P = p_cap):

    delta_buf  count, trips, idx[B], metric[B], s3w[B*wa], nhw[B*wd],
               (ok[B]), (lfa_slot[B], lfa_metric[B]),
               (unreachable, saturated), (cone, fell_back), rounds
    full_buf   okc, trips, idx[P], metric[P], s3w[P*wa], nhw[P*wd],
               (lfa_slot[P], lfa_metric[P]), (unreachable, saturated),
               (cone, fell_back), rounds

The LFA columns are there with LFA (they join the column diff too), the
sentinel pair when sentinels are on, the cone pair when the solve was
incremental; the host parses the tail back to front. The delta
payload's ok column is there only on the streaming epoch (``stream``,
B a ``STREAM_BUDGETS`` bucket; ``ops/stream.py`` has its layout): the
classic delta payload stays byte-stable without it.

With a lane axis (a fused solve of ``g`` same-shape areas) every input
is stacked [g, ...], both buffers come out [g, len], and each lane's
trips and rounds are read on the device from the [g, 2] counters of its
own loop (``ops/relax.Lanes``).

Pad slots past the live count carry index P and the values of row
P - 1 (a fixed-size nonzero fills with P, the gather clips it to the
last row).
"""

from __future__ import annotations

import torch

from openr_tpu_torch.ops import cuda
from openr_tpu_torch.ops.relax import INF_E, _is_cpu
from openr_tpu_torch.ops.stream import column_diff, compact_rows

# finite metrics past 2^28 sit one metric-add from the 2^29 INF_E
# encoding: the saturation sentinel counts them
SENTINEL_SAT = 1 << 28

_BLOCK = 1024  # rows a tile of the kernel (its THREADS)


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
                sentinels: bool, incr: bool = False,
                lfa: bool = False, stream: bool = False) -> tuple[int, int]:
    """(delta_buf, full_buf) int32 lengths; ``stream`` adds the delta
    payload's ok column."""
    tail = 1 + (2 if sentinels else 0) + (2 if incr else 0)
    row = 2 + wa + wd + (2 if lfa else 0)
    return (2 + budget * (row + int(stream)) + tail,
            2 + p_cap * row + tail)


def compact_outputs_plain(metric, s3w, nhw, ok, prev_metric, prev_s3w,
                          prev_nhw, flags, trips, rounds, budget: int,
                          sentinels: bool, incr_tail=None, lfa=None,
                          stream: bool = False):
    if metric.dim() == 2:
        counts = trips.tolist()
        outs = [compact_outputs_plain(
            metric[i], s3w[i], nhw[i], ok[i], prev_metric[i], prev_s3w[i],
            prev_nhw[i], flags[i], *counts[i], budget, sentinels, None,
            None if lfa is None else tuple(c[i] for c in lfa),
        ) for i in range(metric.shape[0])]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    p_cap = metric.shape[0]
    changed = column_diff(metric, s3w, nhw, prev_metric, prev_s3w, prev_nhw,
                          lfa)
    cols = None if lfa is None else lfa[:2]
    delta = compact_rows(changed, trips, metric, s3w, nhw, budget, p_cap,
                         cols, ok if stream else None)
    full = compact_rows(ok, trips, metric, s3w, nhw, p_cap, p_cap, cols)
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
                    flags, trips, rounds, budget: int, sentinels: bool,
                    incr_tail=None, lfa=None, stream: bool = False):
    """-> (delta_buf, full_buf), laid out as the module docstring says.
    ``flags`` is the [P, A] announcer flag plane (bit 0 = valid).
    ``incr_tail`` is the incremental solve's (cone, fell_back), two
    int32 0-d tensors on the device, or None for a cold solve. ``lfa``
    is (lfa_slot, lfa_metric, prev_lfa_slot, prev_lfa_metric), int32
    [P] each, or None without LFA.

    With a lane axis (metric [g, P], the rest stacked alike; ``flags``
    may be a strided [g, P, A] view of the lanes' announcer buffers)
    ``trips`` is the int32 [g, 2] tensor of each lane's (trips, rounds)
    and ``rounds`` is unused; a fused solve is never incremental.

    ``stream`` (a streaming epoch, always incremental and single-lane)
    adds the route-ok bit of each changed row to the delta payload."""
    if _is_cpu(metric):
        return compact_outputs_plain(
            metric, s3w, nhw, ok, prev_metric, prev_s3w, prev_nhw, flags,
            trips, rounds, budget, sentinels, incr_tail, lfa, stream,
        )
    lanes = metric.dim() == 2
    g = metric.size(0) if lanes else 1
    p_cap, wa, wd = metric.size(-1), s3w.size(-1), nhw.size(-1)
    a_cap = flags.size(-1)
    fs = flags.stride()
    if (flags.dtype is not torch.int32 or fs[-1] != 1 or fs[-2] != a_cap
            or flags.get_device() != metric.get_device()):
        raise ValueError("flags must be int32 [P, A] planes on the card")
    if lanes and (incr_tail is not None or trips.shape != (g, 2)):
        raise ValueError("lanes take their [g, 2] (trips, rounds) and no "
                         "incremental tail")
    incr = incr_tail is not None
    n_delta, n_full = buffer_lens(p_cap, wa, wd, budget, sentinels, incr,
                                  lfa is not None, stream)
    # int32 on metric's card (sizes as ints where one lane: fewer
    # arguments to parse on the host)
    if lanes:
        delta_buf = metric.new_empty((g, n_delta))
        full_buf = metric.new_empty((g, n_full))
    else:
        delta_buf = metric.new_empty(n_delta)
        full_buf = metric.new_empty(n_full)
    part = metric.new_empty(4 * g * -(-max(p_cap, budget) // _BLOCK))
    cone, fell = incr_tail if incr else (None, None)
    if lanes:
        trips_i = rounds_i = 0
        tr = trips
    else:
        trips_i, rounds_i, tr = int(trips), int(rounds), None
    # flags may be a strided view of per-lane planes: a raw address (the
    # other tensors fix the card)
    cuda.launch("compact", "compact_tail",
                "tttbtttp" + "tttt" + "ttt" + "i" * 10 + "ttt" + "iiL",
                metric, s3w, nhw, ok, prev_metric, prev_s3w, prev_nhw,
                flags.data_ptr(), *(lfa if lfa is not None else (None,) * 4),
                part, delta_buf, full_buf, p_cap, a_cap, wa, wd, budget,
                n_delta, n_full, trips_i, rounds_i, int(sentinels), cone,
                fell, tr, int(stream), g, fs[0] if lanes else 0)
    compact_outputs.launches += 1
    return delta_buf, full_buf


compact_outputs.launches = 0
