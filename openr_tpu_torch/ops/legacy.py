"""The legacy single-graph kernels (``csrc/legacy.cu``), their plain
PyTorch versions and their fixpoint loops: the graft entry's pipeline
and the all-roots batched SSSP (the port of
``decision/tpu_solver.py:177-300``).

- K18 ``ell_trip``: one trip (``UNROLL`` Jacobi gather rounds) of the
  distance fixpoint from R roots (``_sssp_kernel``, vmapped over roots
  by ``_jitted_sssp_batch``), over the packed mirror (``pack_ell``), on
  one of two tilings chosen by R (``batched``); ``ell_transpose`` takes
  the batched tiling's root-minor plane to the [R, n_cap] result.
  ``ell_relax_plain`` is one round over the padded mirror: the spec a
  trip's rounds are held to.
- K19 ``ell_next_hop``: one round of the first-hop slot-mask fixpoint
  nh [n_cap, D] over the shortest-path DAG of one root
  (``_next_hop_kernel``).
- K20 ``ell_select``: per-prefix best-route selection and the next-hop
  union (``_select_metric_kernel`` + ``_select_kernel``).

The padded mirror is ``in_nbr`` / ``in_w`` int32 [n_cap, k_cap] (-1 =
pad slot), ``in_up`` bool [n_cap, k_cap] and ``node_over`` bool
[n_cap]. Its packed form (``Packed``) keeps the live slots only (real,
link up), as CSR by destination node: ``row_ptr`` int32 [n_cap + 1] and
``slots`` int32 [n_live, 2] of (key, metric), the key the source node
with bit 31 set when the source is overloaded (it transits only as its
own row's root, so the bit cannot be folded away).
``packed_tensors`` packs it on the host from a graph; ``ell_tensors``
packs it with the tensors it makes, and ``packed_mirror`` finds it for
the four tensors (or packs them once).
Unreachable is ``INF = 2^30`` (``ops/csr.INF32``), not the shift
mirror's 2^29; a distance plus a metric wraps modulo 2^32 as the
reference's int32 add does. A pad slot is never read: the reference
gathers row n - 1 there and masks the value, and so the plain versions
clip before they mask.

``ell_sssp`` runs K18 through ``run_trips`` (one launch and one device
flag read a trip, at most ``max_trips(n_cap)`` trips) and
``ell_next_hops`` K19 through ``run_rounds`` (``UNROLL`` launches a
trip), as ``ops/relax.run_sync`` runs its rounds, so their trip counts
are the reference's. The first round of each relaxes the seed plane
without reading a buffer.

Wrappers launch their CUDA kernel on a CUDA tensor and run the plain
version (``*_plain``) only on a CPU tensor. Each counts its kernel
launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

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
# K18's batched tiling: a warp's lanes (its plane's width is a multiple)
WARP = 32
# a packed slot's key: the source node, bit 31 when it is overloaded
SLOT_SRC = 0x7FFFFFFF


def to_device(device, *arrays) -> tuple:
    """numpy arrays -> tensors on ``device``: bool arrays as bool, the
    rest as int32."""
    return tuple(
        torch.tensor(np.ascontiguousarray(a), device=device,
                     dtype=torch.bool if a.dtype == np.bool_
                     else torch.int32)
        for a in arrays)


# -- the packed mirror of K18 -------------------------------------------------

class Packed(NamedTuple):
    """K18's mirror: ``row_ptr`` int32 [n_cap + 1], ``slots`` int32
    [n_live, 2] (key, metric), CSR by destination node."""

    row_ptr: torch.Tensor
    slots: torch.Tensor


def pack_ell(in_nbr, in_w, in_up, node_over) -> tuple:
    """numpy (row_ptr [n_cap + 1], slots [n_live, 2]) of a padded mirror
    (numpy arrays): the real, up slots of each node in slot order, each
    as (source | overloaded << 31, metric)."""
    in_nbr = np.asarray(in_nbr, np.int32)
    live = (in_nbr >= 0) & np.asarray(in_up, bool)
    row_ptr = np.zeros(in_nbr.shape[0] + 1, np.int32)
    np.cumsum(live.sum(axis=1), out=row_ptr[1:])
    src = in_nbr[live]
    over = np.asarray(node_over, bool)[src].astype(np.uint32) << 31
    slots = np.empty((src.size, 2), np.int32)
    slots[:, 0] = (src.astype(np.uint32) | over).view(np.int32)
    slots[:, 1] = np.asarray(in_w, np.int32)[live]
    return row_ptr, slots


# the packed mirrors of live padded ones: id(in_nbr) -> (weak references
# to the four tensors, their (address, version) stamps, the Packed); an
# entry is used only while the same four tensors, unmodified, are alive,
# and goes with its in_nbr
_mirrors: dict = {}


def _stamp(ts) -> tuple:
    return tuple((t.data_ptr(), t._version) for t in ts)


def _remember(ts, packed: Packed) -> None:
    key = id(ts[0])
    _mirrors[key] = ([weakref.ref(t) for t in ts], _stamp(ts), packed)
    weakref.finalize(ts[0], _mirrors.pop, key, None)


def packed_mirror(in_nbr, in_w, in_up, node_over) -> Packed:
    """The packed mirror of the four padded-mirror tensors, on their
    device: the one ``ell_tensors`` made with them, else packed on the
    host from their values (one copy down, once for those tensors)."""
    ts = (in_nbr, in_w, in_up, node_over)
    hit = _mirrors.get(id(in_nbr))
    if hit is not None and all(r() is t for r, t in zip(hit[0], ts)) \
            and hit[1] == _stamp(ts):
        return hit[2]
    packed = Packed(*to_device(in_nbr.device, *pack_ell(
        *(t.cpu().numpy() for t in ts))))
    _remember(ts, packed)
    return packed


def _padded(graph) -> tuple:
    return graph.in_nbr, graph.in_w, graph.in_up, graph.node_overloaded


def packed_tensors(graph, device) -> Packed:
    """K18's packed mirror of an ``ops/csr.EllGraph`` (or any object
    with its numpy fields), packed on the host, on ``device``."""
    return Packed(*to_device(device, *pack_ell(*_padded(graph))))


def ell_tensors(graph, device) -> tuple:
    """(in_nbr, in_w, in_up, node_over) of an ``ops/csr.EllGraph`` (or
    any object with its numpy fields) on ``device``, in the kernels'
    argument order; K18's packed mirror of them is made on the host
    beside them (``packed_mirror`` finds it)."""
    ts = to_device(device, *_padded(graph))
    _remember(ts, packed_tensors(graph, device))
    return ts


# -- K18: a trip of the distance fixpoint -------------------------------------

def batched(r: int) -> bool:
    """True when K18 runs ``r`` roots on its batched tiling (a warp on
    a node and 256 roots, 8 a lane); below 32 roots, the single-root
    tiling (a thread a word)."""
    return r >= WARP


def plane_shape(r: int, n_cap: int) -> tuple:
    """K18's work plane for ``r`` roots: root-minor [n_cap, R_pad] (R
    rounded up to 32) on the batched tiling, else the result's
    [r, n_cap]."""
    return (n_cap, -(-r // WARP) * WARP) if batched(r) else (r, n_cap)


def _seed_dist(roots, n_cap: int):
    dist = torch.full((roots.shape[0], n_cap), INF, dtype=torch.int32,
                      device=roots.device)
    dist[torch.arange(roots.shape[0], device=roots.device),
         roots.long()] = 0
    return dist


def ell_relax_plain(dist, out, flag, in_nbr, in_w, in_up, node_over, roots,
                    seed: bool = False) -> None:
    """One Jacobi round over the padded mirror: out[r] = the minimum of
    ``dist[r]`` and, over the usable in-slots of each node — real, up,
    and from the row's root (``roots[r]``) or a node not overloaded —
    the neighbour's finite distance plus the slot's metric. ORs 1 into
    ``flag`` when a word changed. With ``seed`` the round starts from
    the seed plane (0 at each row's root, INF elsewhere) and ``dist`` is
    not read. The spec of a K18 round."""
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


def plane_words(plane, r: int):
    """The [n_cap, r] view of a K18 work plane's real words."""
    return plane[:, :r] if batched(r) else plane.t()


def _check_trip(cur, spare, flags, packed, roots) -> tuple:
    n_cap = packed.row_ptr.shape[0] - 1
    r = roots.shape[0]
    want = plane_shape(r, n_cap)
    ok_shape = (cur.shape[0] == n_cap and cur.shape[1] >= r
                and cur.shape[1] % WARP == 0) if batched(r) \
        else tuple(cur.shape) == want
    if not ok_shape or cur.shape != spare.shape or flags.numel() != 2:
        raise ValueError(
            f"ell_trip: planes {tuple(cur.shape)} / {tuple(spare.shape)} "
            f"and {flags.numel()} flag words for {r} roots (want {want} "
            f"and 2)")
    return n_cap, r


def ell_trip_plain(cur, spare, flags, packed: Packed, roots, trip: int,
                   rounds: int = UNROLL):
    n_cap, r = _check_trip(cur, spare, flags, packed, roots)
    if trip == 0:
        flags[0] = 0
    flags[(trip + 1) & 1] = 0
    dev = cur.device
    key, w = packed.slots[:, 0], packed.slots[:, 1]
    src = (key & SLOT_SRC).long()
    dst = torch.repeat_interleave(
        torch.arange(n_cap, device=dev),
        (packed.row_ptr[1:] - packed.row_ptr[:-1]).long())[:, None]
    usable = (key >= 0)[:, None] | (src[:, None] == roots[None].long())
    changed = torch.zeros((), dtype=torch.bool, device=dev)
    planes = (spare, cur)
    for k in range(rounds):
        old = (_seed_dist(roots, n_cap).t() if trip == 0 and k == 0
               else plane_words(planes[(k + 1) % 2], r))
        du = old[src]
        cand = torch.where(usable & (du < INF), du + w[:, None], INF)
        new = old.clone().scatter_reduce_(0, dst.expand(-1, r), cand, "amin")
        changed |= (new != old).any()
        plane_words(planes[k % 2], r).copy_(new)
    flags[trip & 1] |= changed.to(torch.int32)
    return planes[(rounds - 1) % 2]


def ell_trip(cur, spare, flags, packed: Packed, roots, trip: int,
             rounds: int = UNROLL):
    """One trip of the distance fixpoint from each root of the int32
    tensor ``roots`` [R]: ``rounds`` Jacobi rounds over the packed
    mirror, round k reading ``cur`` (k even) or ``spare`` (k odd) and
    writing the other; returns the plane holding the result (``cur``
    after an even count). A round is ``ell_relax_plain``'s. At trip 0
    the first round reads the seed plane, not ``cur``. The planes are
    ``plane_shape(R, n_cap)``: root-minor [n_cap, R_pad] when
    ``batched(R)`` (the pad columns are never written), else
    [R, n_cap]. ``flags`` int32 [2]: the trip ORs 1 into
    ``flags[trip & 1]`` when a word changed and clears the other word
    (at trip 0 both first), so a loop reads one word a trip and clears
    none. On the card: one cooperative launch."""
    if _is_cpu(cur):
        return ell_trip_plain(cur, spare, flags, packed, roots, trip, rounds)
    n_cap, r = _check_trip(cur, spare, flags, packed, roots)
    if batched(r):
        cuda.launch("legacy", "ell_trip_batch", "ttttt" + "iiiiit", cur,
                    spare, packed.row_ptr, packed.slots, roots, n_cap, r,
                    cur.shape[1], rounds, trip, flags)
    else:
        cuda.launch("legacy", "ell_trip_single", "ttttt" + "iiiit", cur,
                    spare, packed.row_ptr, packed.slots, roots, n_cap, r,
                    rounds, trip, flags)
    ell_trip.launches += 1
    return cur if rounds % 2 == 0 else spare


ell_trip.launches = 0


def ell_transpose_plain(plane, scratch, r: int):
    n_cap = plane.shape[0]
    out = scratch.view(-1)[:r * n_cap].view(r, n_cap)
    out.copy_(plane[:, :r].t())
    return out


def ell_transpose(plane, scratch, r: int):
    """The [r, n_cap] result of a batched K18 plane ``plane``
    [n_cap, R_pad]: out[c, v] = plane[v, c], written into the storage of
    ``scratch`` (a plane of the same size the loop no longer needs) and
    returned as a view of it."""
    if _is_cpu(plane):
        return ell_transpose_plain(plane, scratch, r)
    n_cap, r_pad = plane.shape
    if scratch.numel() < r * n_cap or r > r_pad:
        raise ValueError(f"ell_transpose: {r} rows of {n_cap} into "
                         f"{scratch.numel()} words")
    out = scratch.view(-1)[:r * n_cap].view(r, n_cap)
    cuda.launch("legacy", "ell_transpose", "tt" + "iii", plane, out, n_cap,
                r, r_pad)
    ell_transpose.launches += 1
    return out


ell_transpose.launches = 0


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


def run_trips(trip, plane, bound: int):
    """``trip(cur, spare, flags, t)`` (``ell_trip``'s signature: one
    launch, the result plane returned, ``flags[t & 1]`` set on a change)
    for t = 0, 1, ..., reading one flag word a trip and exiting on the
    first trip that changed nothing or at ``bound`` trips; ``plane`` is
    scratch. Returns ``(result plane, the other plane, trips)``."""
    cur, spare = plane, torch.empty_like(plane)
    flags = torch.empty(2, dtype=torch.int32, device=plane.device)
    trips = 0
    while True:
        out = trip(cur, spare, flags, trips)
        if out is spare:
            cur, spare = spare, cur
        trips += 1
        if not read_flag(flags[(trips - 1) & 1], clear=False) \
                or trips >= bound:
            return cur, spare, trips


def ell_sssp(in_nbr, in_w, in_up, node_over, roots):
    """-> (dist int32 [R, n_cap], trips): the distance fixpoint from
    each root of the int32 tensor ``roots`` [R] (INF where unreachable)
    over the padded mirror, through its packed form (``sssp_packed``)."""
    return sssp_packed(packed_mirror(in_nbr, in_w, in_up, node_over), roots)


def sssp_packed(packed: Packed, roots):
    """``ell_sssp`` over a packed mirror: trips of K18, then on the
    batched tiling the transpose into the plane the loop no longer
    needs (so the call holds two planes at most)."""
    n_cap = packed.row_ptr.shape[0] - 1
    r = roots.shape[0]
    plane = torch.empty(plane_shape(r, n_cap), dtype=torch.int32,
                        device=roots.device)
    cur, spare, trips = run_trips(
        lambda c, s, f, t: ell_trip(c, s, f, packed, roots, t), plane,
        max_trips(n_cap))
    if batched(r):
        return ell_transpose(cur, spare, r), trips
    return cur, trips


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
