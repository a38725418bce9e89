"""Best-route selection (K3, ``csrc/select.cu``) and its plain version.

From the [D, n_cap] per-slot distance planes of the root's
out-neighbours: via[d, v] = root_w[d] + dist_d[d, v] gives the true
distance dist[v] = min(min_d via, INF_E) (dist[root] = 0) and the ECMP
predicate — slot d is on a shortest path to v iff via[d, v] == dist[v].
Then, per prefix row over its announcer slots, in the reference's order
(path_preference desc, source_preference desc, advertised distance
asc), the drained-announcer filter with all-drained fallback, the
min-IGP announcer set and the union of their next-hop slots, packed 16
bits per int32 word, and the route-level ok filter.

The announcer matrix arrives packed as ``mbuf`` = six [P, A] int32
planes: ann_node, flags (bit 0 valid, bit 1 drained, bit 2 of slot 0
v4), path_pref, source_pref, dist_adv, min_nh.
"""

from __future__ import annotations

import torch

from openr_tpu_torch.ops import cuda
from openr_tpu_torch.ops.compact import route_ok
from openr_tpu_torch.ops.relax import INF_E, _int32, _is_cpu

# unreachable preference value
_NEG = -(2**31)


def pack_words(bits):
    """bool [P, X] -> int32 [P, ceil(X/16)], 16 bits per word."""
    p, x = bits.shape
    w = -(-x // 16)
    padded = torch.zeros((p, w * 16), dtype=torch.int32, device=bits.device)
    padded[:, :x] = bits.to(torch.int32)
    weights = 1 << torch.arange(16, dtype=torch.int32, device=bits.device)
    return (padded.view(p, w, 16) * weights).sum(dim=2, dtype=torch.int32)


def select_routes_plain(dist_d, root_w, root: int, mbuf, p_cap: int,
                        a_cap: int, block_v4: bool):
    n_cap = dist_d.shape[1]
    via = root_w[:, None] + dist_d
    dist = torch.clamp_max(via.amin(dim=0), INF_E)
    dist[root] = 0
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
    return metric, pack_words(s3), pack_words(nh_mask), ok


def select_routes(dist_d, root_w, root: int, mbuf, p_cap: int, a_cap: int,
                  block_v4: bool):
    """-> (metric int32 [P], s3w int32 [P, ceil(A/16)], nhw int32
    [P, ceil(D/16)], ok bool [P])."""
    if _is_cpu(dist_d):
        return select_routes_plain(dist_d, root_w, root, mbuf, p_cap, a_cap,
                                   block_v4)
    _int32(dist_d, root_w, mbuf)
    d_cap, n_cap = dist_d.shape
    if mbuf.numel() != 6 * p_cap * a_cap or root_w.shape[0] != d_cap:
        raise ValueError("mbuf / root_w do not match the plane shapes")
    dev = dist_d.device
    dist = torch.empty(n_cap, dtype=torch.int32, device=dev)
    onsp = torch.empty((n_cap, -(-d_cap // 32)), dtype=torch.int32,
                       device=dev)
    metric = torch.empty(p_cap, dtype=torch.int32, device=dev)
    s3w = torch.empty((p_cap, -(-a_cap // 16)), dtype=torch.int32,
                      device=dev)
    nhw = torch.empty((p_cap, -(-d_cap // 16)), dtype=torch.int32,
                      device=dev)
    ok = torch.empty(p_cap, dtype=torch.bool, device=dev)
    p = cuda.ptr
    cuda.launch("select", "select_nodes", "ppppiii",
                p(dist_d), p(root_w), p(dist), p(onsp), d_cap, n_cap,
                int(root))
    cuda.launch("select", "select_prefixes", "ppppppp" + "iiiiii",
                p(mbuf), p(dist), p(onsp), p(metric), p(s3w), p(nhw), p(ok),
                p_cap, a_cap, n_cap, d_cap, int(root), int(block_v4))
    select_routes.launches += 2
    return metric, s3w, nhw, ok


select_routes.launches = 0
