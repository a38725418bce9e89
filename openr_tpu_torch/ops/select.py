"""Best-route selection (K3, ``csrc/select.cu``) and its plain version.

From the [D, n_cap] per-slot distance planes of the root's
out-neighbours: via[d, v] = root_w[d] + dist_d[d, v] gives the true
distance dist[v] = min(min_d via, INF_E) (dist[root] = 0) and the ECMP
predicate — slot d is on a shortest path to v iff via[d, v] == dist[v].
Then, per prefix row over its announcer slots, in the reference's order
(path_preference desc, source_preference desc, advertised distance
asc), the drained-announcer filter with all-drained fallback, the
min-IGP announcer set and the union of their next-hop slots, packed 16
bits per int32 word, and the route-level ok filter. With ``lfa``, the
RFC 5286 loop-free alternate per row: slot d backs the row up iff its
link is up, it carries no primary next hop, and its neighbour's own
distance to the selected announcers (the min over s3 of dist_d[d, a])
beats the detour back through the root (dist_d[d, root] + metric);
the lowest alternate cost root_w[d] + that distance wins, the first
slot on ties (-1 and 0 when the row has none).

With a lane axis (a fused solve of ``g`` same-shape areas) every plane
and output is stacked [g, ...] and ``root`` is an int32 tensor [g];
one launch covers every lane. The announcer matrix is then
stacked too, or one [6*P*A] matrix that every lane shares (the
whole-fabric step, a lane per root).

The announcer matrix arrives packed as ``mbuf`` = six [P, A] int32
planes: ann_node, flags (bit 0 valid, bit 1 drained, bit 2 of slot 0
v4), path_pref, source_pref, dist_adv, min_nh.
"""

from __future__ import annotations

import numpy as np
import torch

from openr_tpu_torch.ops import cuda
from openr_tpu_torch.ops.compact import route_ok
from openr_tpu_torch.ops.relax import INF_E, _is_cpu

# unreachable preference value
_NEG = -(2**31)


def pack_matrix(matrix, node_over: np.ndarray) -> tuple:
    """(flags [P,A], mbuf int32 [6*P*A]) of an ``ops/csr.PrefixMatrix``
    — validity, per-announcer drain and the per-prefix v4 bit (flag bit
    2, announcer slot 0) fold into flag bits host-side; min_nexthop
    ships so the device can run the route-level ok filter. The buffer is
    memoised on the matrix; only its flags plane is rewritten later."""
    idx = np.clip(matrix.ann_node, 0, None)
    flags = matrix.ann_valid.astype(np.int32) | (
        node_over[idx].astype(np.int32) << 1
    )
    if flags.shape[1]:
        flags[:, 0] |= matrix.is_v4.astype(np.int32) << 2
    mbuf = matrix._mbuf
    if mbuf is None:
        mbuf = matrix._mbuf = np.concatenate([
            matrix.ann_node.ravel(),
            flags.ravel(),
            matrix.path_pref.ravel(),
            matrix.source_pref.ravel(),
            matrix.dist_adv.ravel(),
            matrix.min_nexthop.ravel(),
        ]).astype(np.int32, copy=False)
    else:
        # only the flags plane depends on node_over; the upload copies,
        # so patching the host buffer in place is safe
        pa = flags.size
        mbuf[pa:2 * pa] = flags.ravel()
    return flags, mbuf


def pack_words(bits):
    """bool [P, X] -> int32 [P, ceil(X/16)], 16 bits per word."""
    p, x = bits.shape
    w = -(-x // 16)
    padded = torch.zeros((p, w * 16), dtype=torch.int32, device=bits.device)
    padded[:, :x] = bits.to(torch.int32)
    weights = 1 << torch.arange(16, dtype=torch.int32, device=bits.device)
    return (padded.view(p, w, 16) * weights).sum(dim=2, dtype=torch.int32)


def select_routes_plain(dist_d, root_w, root, mbuf, p_cap: int,
                        a_cap: int, block_v4: bool, lfa: bool = False,
                        dist_out=None):
    if dist_d.dim() == 3:
        roots = root.tolist()
        outs = [select_routes_plain(
                    dist_d[lane], root_w[lane], roots[lane],
                    mbuf if mbuf.dim() == 1 else mbuf[lane], p_cap, a_cap,
                    block_v4, lfa,
                    None if dist_out is None else dist_out[lane])
                for lane in range(dist_d.shape[0])]
        return tuple(torch.stack(col) for col in zip(*outs))
    n_cap = dist_d.shape[1]
    via = root_w[:, None] + dist_d
    dist = torch.clamp_max(via.amin(dim=0), INF_E)
    dist[root] = 0
    if dist_out is not None:
        dist_out.copy_(dist)
    planes = mbuf.view(6, p_cap, a_cap)
    ann_node, ann_flags, path_pref, source_pref, dist_adv, min_nh = planes
    ann_valid = (ann_flags & 1).bool()
    ann_over = (ann_flags & 2).bool()
    if block_v4:
        v4_blocked = (ann_flags[:, 0] & 4).bool()
    else:
        v4_blocked = torch.zeros(p_cap, dtype=torch.bool, device=mbuf.device)
    idx = ann_node.clamp(0, n_cap - 1).long()
    ann_dist = dist[idx]
    reach = ann_valid & (ann_dist < INF_E)
    pp = torch.where(reach, path_pref, _NEG)
    s = reach & (pp == pp.amax(dim=1, keepdim=True))
    sp = torch.where(s, source_pref, _NEG)
    s = s & (sp == sp.amax(dim=1, keepdim=True))
    da = torch.where(s, dist_adv, INF_E)
    s2 = s & (da == da.amin(dim=1, keepdim=True))
    nd = s2 & ~ann_over
    s3 = torch.where(nd.any(dim=1, keepdim=True), nd, s2)
    igp = torch.where(s3, ann_dist, INF_E)
    metric = igp.amin(dim=1)
    s4 = s3 & (igp == metric[:, None])
    on_sp = (via == dist[None, :]).T  # [N, D]
    nh_mask = (s4[:, :, None] & on_sp[idx]).any(dim=1)  # [P, D]
    ok = route_ok(metric, s3, nh_mask, ann_node, min_nh, v4_blocked, root)
    out = (metric, pack_words(s3), pack_words(nh_mask), ok)
    if not lfa:
        return out
    d_root = dist_d[:, root]
    ann_nd = dist_d.T[idx]  # [P, A, D]
    nbr_pd = torch.where(s3[:, :, None], ann_nd, INF_E).amin(dim=1)
    ok_lfa = (
        (root_w < INF_E)[None, :]
        & ~nh_mask
        & (nbr_pd < INF_E)
        & (nbr_pd < d_root[None, :] + metric[:, None])
    )
    alt = torch.where(ok_lfa, root_w[None, :] + nbr_pd, 1 << 30)
    has = ok_lfa.any(dim=1)
    # argmin returns the first minimum: the lowest slot breaks ties
    slot = torch.where(has, alt.argmin(dim=1).to(torch.int32), -1)
    alt_metric = torch.where(has, alt.amin(dim=1), 0)
    return out + (slot.to(torch.int32), alt_metric.to(torch.int32))


def _into(got: tuple, out) -> tuple:
    """The plain outputs copied into ``out`` (metric, s3w, nhw and, with
    LFA, the two LFA columns), or as they are without ``out``."""
    if out is None:
        return got
    for o, g in zip(out, got[:3] + got[4:]):
        o.copy_(g)
    return tuple(out[:3]) + (got[3],) + tuple(out[3:])


def select_routes(dist_d, root_w, root, mbuf, p_cap: int, a_cap: int,
                  block_v4: bool, lfa: bool = False, out=None,
                  dist_out=None):
    """-> (metric int32 [P], s3w int32 [P, ceil(A/16)], nhw int32
    [P, ceil(D/16)], ok bool [P]), and with ``lfa`` also (lfa_slot
    int32 [P], lfa_metric int32 [P]). Stacked inputs ([g, D, n_cap]
    planes, ``root`` an int32 tensor [g]) give stacked outputs.

    ``out``, when given, is (metric, s3w, nhw) — and with ``lfa`` the
    two LFA columns — of those shapes: the published planes are written
    there instead of into new tensors (the streaming epoch's second
    plane set). ``dist_out``, when given, an int32 tensor [.., n_cap],
    receives the node distances (dist[root] = 0)."""
    if _is_cpu(dist_d):
        return _into(select_routes_plain(dist_d, root_w, root, mbuf, p_cap,
                                         a_cap, block_v4, lfa, dist_out),
                     out)
    stacked = dist_d.dim() == 3
    g = dist_d.size(0) if stacked else 1
    d_cap, n_cap = dist_d.size(-2), dist_d.size(-1)
    pa6 = 6 * p_cap * a_cap
    shared = stacked and mbuf.dim() == 1
    if isinstance(root, torch.Tensor):
        root_i, roots = 0, root
    else:
        root_i, roots = int(root), None
    # sizes only: the launch checks each tensor's dtype, layout and card
    if (mbuf.numel() != (1 if shared else g) * pa6
            or root_w.numel() != g * d_cap
            or stacked != (roots is not None)
            or (stacked and roots.numel() != g)
            or (dist_out is not None and dist_out.numel() != g * n_cap)):
        raise ValueError("mbuf, root_w, the roots or dist_out do not match "
                         "the [g, D, n] planes")
    wa, wd = -(-a_cap // 16), -(-d_cap // 16)
    # int32 (bool for ok) on the planes' card; one lane's sizes as ints
    n = g * p_cap
    lead = (g,) if stacked else ()
    if out is None:
        metric = dist_d.new_empty((g, p_cap) if stacked else p_cap)
        s3w = dist_d.new_empty((*lead, p_cap, wa))
        nhw = dist_d.new_empty((*lead, p_cap, wd))
        lfa_out = (dist_d.new_empty(metric.shape),
                   dist_d.new_empty(metric.shape)) if lfa else (None, None)
    else:
        metric, s3w, nhw = out[:3]
        lfa_out = tuple(out[3:5]) if lfa else (None, None)
        if (metric.numel() != n or s3w.numel() != n * wa
                or nhw.numel() != n * wd
                or (lfa and {t.numel() for t in lfa_out} != {n})):
            raise ValueError("out planes do not match the outputs' shapes")
    ok = dist_d.new_empty(metric.shape, dtype=torch.bool)
    cuda.launch("select", "select_tail", "ttttttbttt" + "iiiiiti" + "Li",
                dist_d, root_w, mbuf, metric, s3w, nhw, ok, *lfa_out,
                dist_out, p_cap, a_cap, n_cap, d_cap, root_i, roots, g,
                0 if shared else pa6, int(block_v4))
    select_routes.launches += 1
    out = (metric, s3w, nhw, ok)
    return out + lfa_out if lfa else out


select_routes.launches = 0
