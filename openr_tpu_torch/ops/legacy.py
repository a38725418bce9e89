"""The legacy single-graph kernels (``csrc/legacy.cu``) over the padded
in-neighbour mirror of ``ops/csr.py``, their plain PyTorch versions and
their fixpoint loops: the graft entry's pipeline and the all-roots
batched SSSP (the port of ``decision/tpu_solver.py:177-300``).

- K18 ``ell_relax``: one Jacobi gather round of the distance fixpoint
  over [R, n_cap] planes, one row a root (``_sssp_kernel``, vmapped over
  roots by ``_jitted_sssp_batch``).
- K19 ``ell_next_hop``: one round of the first-hop slot-mask fixpoint
  nh [n_cap, D] over the shortest-path DAG of one root
  (``_next_hop_kernel``).
- K20 ``ell_select``: per-prefix best-route selection and the next-hop
  union (``_select_metric_kernel`` + ``_select_kernel``).

The mirror is ``in_nbr`` / ``in_w`` int32 [n_cap, k_cap] (-1 = pad
slot), ``in_up`` bool [n_cap, k_cap] and ``node_over`` bool [n_cap].
Unreachable is ``INF = 2^30`` (``ops/csr.INF32``), not the shift
mirror's 2^29; a distance plus a metric wraps modulo 2^32 as the
reference's int32 add does. A pad slot is never read: the reference
gathers row n - 1 there and masks the value, and so the plain versions
clip before they mask.

``ell_sssp`` and ``ell_next_hops`` run the loops through ``run_rounds``
as ``ops/relax.run_sync`` does (``UNROLL`` rounds a trip, one device
flag read a trip, at most ``max_trips(n_cap)`` trips), so their trip
counts are the reference's. The first round of each relaxes the seed
plane without reading a buffer.

Wrappers launch their CUDA kernel on a CUDA tensor and run the plain
version (``*_plain``) only on a CPU tensor. Each counts its kernel
launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from openr_tpu_torch.ops import cuda
from openr_tpu_torch.ops.relax import (
    UNROLL,
    _is_cpu,
    max_trips,
    read_flag,
)

# effectively-infinite metric of the ELL mirror (ops/csr.INF32)
INF = 1 << 30
# unreachable preference value
_NEG = -(2**31)


def to_device(device, *arrays) -> tuple:
    """numpy arrays -> tensors on ``device``: bool arrays as bool, the
    rest as int32."""
    return tuple(
        torch.tensor(np.ascontiguousarray(a), device=device,
                     dtype=torch.bool if a.dtype == np.bool_
                     else torch.int32)
        for a in arrays)


def ell_tensors(graph, device) -> tuple:
    """(in_nbr, in_w, in_up, node_over) of an ``ops/csr.EllGraph`` (or
    any object with its numpy fields) on ``device``, in the kernels'
    argument order."""
    return to_device(device, graph.in_nbr, graph.in_w, graph.in_up,
                     graph.node_overloaded)


# -- K18: one gather round of the distance fixpoint ---------------------------

def _seed_dist(roots, n_cap: int):
    dist = torch.full((roots.shape[0], n_cap), INF, dtype=torch.int32,
                      device=roots.device)
    dist[torch.arange(roots.shape[0], device=roots.device),
         roots.long()] = 0
    return dist


def ell_relax_plain(dist, out, flag, in_nbr, in_w, in_up, node_over, roots,
                    seed: bool = False) -> None:
    n_cap = in_nbr.shape[0]
    if seed:
        dist = _seed_dist(roots, n_cap)
    nbr = in_nbr.clamp(0, n_cap - 1).long()
    own = in_nbr[None] == roots[:, None, None]
    usable = (in_up & (in_nbr >= 0))[None] & (own | ~node_over[nbr][None])
    nd = dist[:, nbr]
    cand = torch.where(usable & (nd < INF), nd + in_w[None], INF).amin(dim=2)
    new = torch.minimum(dist, cand)
    flag |= (new != dist).any().to(torch.int32)
    out.copy_(new)


def ell_relax(dist, out, flag, in_nbr, in_w, in_up, node_over, roots,
              seed: bool = False) -> None:
    """out[r] = one Jacobi round of row r's distance fixpoint from
    ``dist[r]`` (root ``roots[r]``): the minimum of the row and, over
    the usable in-slots of each node — real, up, and from the row's root
    or a node not overloaded — the neighbour's finite distance plus the
    slot's metric. ORs 1 into ``flag`` when a word changed. With
    ``seed`` the round starts from the seed plane (0 at each row's
    root, INF elsewhere) and ``dist`` is not read."""
    if _is_cpu(in_nbr):
        ell_relax_plain(dist, out, flag, in_nbr, in_w, in_up, node_over,
                        roots, seed)
        return
    n_cap, k_cap = in_nbr.shape
    cuda.launch("legacy", "ell_relax", "ttttbbt" + "iiiit",
                dist, out, in_nbr, in_w, in_up, node_over, roots, n_cap,
                k_cap, roots.shape[0], int(seed), flag)
    ell_relax.launches += 1


ell_relax.launches = 0


# -- K19: one round of the first-hop slot-mask fixpoint -----------------------

def _seed_nh(dist, root_nbr, root_w, root_up):
    n_cap, d_cap = dist.shape[0], root_nbr.shape[0]
    slot_ok = (root_nbr >= 0) & root_up & (
        dist[root_nbr.clamp(0, n_cap - 1).long()] == root_w)
    seed = torch.zeros((n_cap + 1, d_cap), dtype=torch.bool,
                       device=dist.device)
    rows = torch.where(root_nbr >= 0, root_nbr, n_cap).long()
    seed[rows, torch.arange(d_cap, device=dist.device)] = slot_ok
    return seed[:n_cap]


def ell_next_hop_plain(nh, out, flag, dist, in_nbr, in_w, in_up, node_over,
                       root: int, root_nbr, root_w, root_up,
                       seed: bool = False) -> None:
    n_cap = in_nbr.shape[0]
    seed_plane = _seed_nh(dist, root_nbr, root_w, root_up)
    cur = seed_plane if seed else nh
    nbr = in_nbr.clamp(0, n_cap - 1).long()
    nd = dist[nbr]
    ok_parent = (in_up & (in_nbr >= 0) & (in_nbr != root) & ~node_over[nbr]
                 & (nd < INF) & (nd + in_w == dist[:, None]))
    new = seed_plane | (ok_parent[:, :, None] & cur[nbr]).any(dim=1)
    flag |= (new != cur).any().to(torch.int32)
    out.copy_(new)


def ell_next_hop(nh, out, flag, dist, in_nbr, in_w, in_up, node_over,
                 root: int, root_nbr, root_w, root_up,
                 seed: bool = False) -> None:
    """out = one Jacobi round of the slot-mask fixpoint of ``root``:
    out[v, d] = seed[v, d] | OR over v's parent slots of nh[u, d]. The
    seed sets slot d at its neighbour root_nbr[d] when the slot is real,
    up and its metric root_w[d] is that neighbour's distance; a parent
    slot is real, up, from a node u that is not the root, not
    overloaded, reachable, with dist[u] + metric == dist[v]. ``nh`` /
    ``out`` are bool [n_cap, D]; ``dist`` the root's int32 [n_cap]. ORs
    1 into ``flag`` when a slot changed. With ``seed`` the round starts
    from the seed plane and ``nh`` is not read."""
    if _is_cpu(in_nbr):
        ell_next_hop_plain(nh, out, flag, dist, in_nbr, in_w, in_up,
                           node_over, root, root_nbr, root_w, root_up, seed)
        return
    n_cap, k_cap = in_nbr.shape
    d_cap = root_nbr.shape[0]
    cuda.launch("legacy", "ell_next_hop", "bbtttbbttb" + "iiiiit",
                nh, out, dist, in_nbr, in_w, in_up, node_over, root_nbr,
                root_w, root_up, int(root), n_cap, k_cap, d_cap, int(seed),
                flag)
    ell_next_hop.launches += 1


ell_next_hop.launches = 0


# -- K20: selection and the next-hop union ------------------------------------

def ell_select_plain(dist, nh, node_over, ann_node, ann_valid, path_pref,
                     source_pref, dist_adv):
    n_cap = dist.shape[0]
    idx = ann_node.clamp(0, n_cap - 1).long()
    ann_dist = dist[idx]
    reach = ann_valid & (ann_dist < INF)
    pp = torch.where(reach, path_pref, _NEG)
    s = reach & (pp == pp.amax(dim=1, keepdim=True))
    sp = torch.where(s, source_pref, _NEG)
    s = s & (sp == sp.amax(dim=1, keepdim=True))
    da = torch.where(s, dist_adv, INF)
    s2 = s & (da == da.amin(dim=1, keepdim=True))
    nd = s2 & ~node_over[idx]
    s3 = torch.where(nd.any(dim=1, keepdim=True), nd, s2)
    igp = torch.where(s3, ann_dist, INF)
    metric = igp.amin(dim=1)
    s4 = s3 & (igp == metric[:, None])
    nh_mask = (s4[:, :, None] & nh[idx]).any(dim=1)
    has_route = s3.any(dim=1) & (metric < INF)
    return metric, s3, nh_mask, has_route


def ell_select(dist, nh, node_over, ann_node, ann_valid, path_pref,
               source_pref, dist_adv):
    """-> (metric int32 [P], s3 bool [P, A], nh_mask bool [P, D],
    has_route bool [P]) from one root's distances ``dist`` [n_cap] and
    slot masks ``nh`` [n_cap, D]: per prefix row, over its announcers in
    the reference's order (path preference desc, source preference
    desc, advertised distance asc) among the reachable ones, the
    not-drained subset unless all are drained (s3), the lowest IGP
    distance among s3 (metric), the union of the slot masks of the s3
    announcers at that distance, and whether a route exists."""
    if _is_cpu(dist):
        return ell_select_plain(dist, nh, node_over, ann_node, ann_valid,
                                path_pref, source_pref, dist_adv)
    n_cap, d_cap = nh.shape
    p_cap, a_cap = ann_node.shape
    dev = dist.device
    metric = torch.empty(p_cap, dtype=torch.int32, device=dev)
    s3 = torch.empty((p_cap, a_cap), dtype=torch.bool, device=dev)
    nh_mask = torch.empty((p_cap, d_cap), dtype=torch.bool, device=dev)
    has_route = torch.empty(p_cap, dtype=torch.bool, device=dev)
    cuda.launch("legacy", "ell_select", "tbbtbttt" + "tbbb" + "iiii",
                dist, nh, node_over, ann_node, ann_valid, path_pref,
                source_pref, dist_adv, metric, s3, nh_mask, has_route, p_cap,
                a_cap, n_cap, d_cap)
    ell_select.launches += 1
    return metric, s3, nh_mask, has_route


ell_select.launches = 0


# -- the fixpoint loops -------------------------------------------------------

def run_rounds(step, plane, bound: int):
    """``UNROLL`` applications of ``step(src, dst, flag, seed)`` a trip,
    the first with ``seed`` set, exiting on the first trip that changed
    nothing or at ``bound`` trips; ``plane`` is scratch. Returns
    ``(plane, trips)``."""
    cur, spare = plane, torch.empty_like(plane)
    flag = torch.zeros(1, dtype=torch.int32, device=plane.device)
    trips = 0
    while True:
        for i in range(UNROLL):
            step(cur, spare, flag, trips == 0 and i == 0)
            cur, spare = spare, cur
        trips += 1
        if not read_flag(flag) or trips >= bound:
            return cur, trips


def ell_sssp(in_nbr, in_w, in_up, node_over, roots):
    """-> (dist int32 [R, n_cap], trips): the distance fixpoint from
    each root of the int32 tensor ``roots`` [R] (INF where unreachable),
    rounds of K18."""
    n_cap = in_nbr.shape[0]
    plane = torch.empty((roots.shape[0], n_cap), dtype=torch.int32,
                        device=in_nbr.device)

    def step(src, dst, flag, seed):
        ell_relax(src, dst, flag, in_nbr, in_w, in_up, node_over, roots,
                  seed)

    return run_rounds(step, plane, max_trips(n_cap))


def ell_next_hops(dist, in_nbr, in_w, in_up, node_over, root: int,
                  root_nbr, root_w, root_up):
    """-> (nh bool [n_cap, D], trips): the first-hop slot masks of
    ``root`` over its shortest-path DAG, rounds of K19."""
    n_cap = in_nbr.shape[0]
    plane = torch.empty((n_cap, root_nbr.shape[0]), dtype=torch.bool,
                        device=in_nbr.device)

    def step(src, dst, flag, seed):
        ell_next_hop(src, dst, flag, dist, in_nbr, in_w, in_up, node_over,
                     root, root_nbr, root_w, root_up, seed)

    return run_rounds(step, plane, max_trips(n_cap))
