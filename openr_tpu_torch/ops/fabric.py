"""The whole-fabric step on one card: every requested root's
batched-seed SSSP over one shared copy of the shift-decomposed mirror,
then best-route selection per root — the port of
``parallel/sharding.py::_sharded_fabric_fn`` with a graph axis of 1
(where its per-relaxation ``pmin`` is the identity).

Per root r (a lane): the [D, n_cap] seed plane of its out-neighbours
(K1s with a root axis, seed rows only), then exactly ``n_trips``
trips of ``UNROLL`` Jacobi relaxations with the root masked as a
transit node (K21 ``fabric_relax``, ``csrc/fabric.cu``, reading each
residual row up to its live extent, K21e ``fabric_extent``), then the
convergence vote — one more relaxation must change nothing, else the
root did not converge — and the reference's tail (K3
``select_routes`` with a root axis and one shared announcer matrix:
distances, selection, next-hop words, LFA, route-ok).

The reference runs every trip; here a root whose planes stopped
changing is gated off (its later relaxations are no-ops) and the loop
exits once no root changed in a trip, so the outputs are the same
fixpoint, and a root that had not settled by the last trip runs the
vote exactly as the reference does. ``converged`` is therefore the
reference's vector.

K21 skips the lane's root as a source instead of masking private
copies of the class and residual weights: a masked candidate is
``dist + INF_E >= INF_E`` and never lowers a word. ``fabric_relax_plain``
builds the masked copies, as the reference does.

Wrappers launch their CUDA kernel on a CUDA tensor and run the plain
version only on a CPU tensor; ``fabric_step_plain`` runs the whole step
through the plain versions on any device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from openr_tpu_torch.ops import cuda
from openr_tpu_torch.ops.relax import (
    _GATE_SIG,
    ALWAYS,
    INF_E,
    KEEP,
    UNROLL,
    Gate,
    Lanes,
    _each_lane,
    _gate_args,
    _int32,
    _is_cpu,
    read_flag,
    relax_step_plain,
    sssp_init,
    sssp_init_plain,
)
from openr_tpu_torch.ops.select import select_routes, select_routes_plain


# -- K21: one relaxation of every root's planes -------------------------------

# -- K21e: each residual row's live extent ------------------------------------

def fabric_extent_plain(res_w):
    col = torch.arange(1, res_w.shape[1] + 1, dtype=torch.int32,
                       device=res_w.device)
    return torch.where(res_w < INF_E, col, 0).amax(dim=1).to(torch.int32)


def fabric_extent(res_w):
    """int32 [r_cap]: 1 + the last column of each residual row whose
    weight is finite (< INF_E), 0 for a row with none; K21 reads a row
    up to there (an INF_E weight cannot lower a word)."""
    if _is_cpu(res_w):
        return fabric_extent_plain(res_w)
    _int32(res_w)
    ext = torch.empty(res_w.shape[0], dtype=torch.int32, device=res_w.device)
    p = cuda.ptr
    cuda.launch("fabric", "fabric_extent", "ppii", p(res_w), p(ext),
                res_w.shape[0], res_w.shape[1])
    fabric_extent.launches += 1
    return ext


fabric_extent.launches = 0


def fabric_relax_plain(dist, out, flag, deltas, shift_w, residual, roots,
                       gate: Optional[Gate] = None) -> None:
    n_cap = shift_w.shape[1]
    root_of = roots.tolist()

    def one(lane, f):
        root = root_of[lane]
        sw = shift_w.clone()
        sw[:, root] = INF_E
        res = None
        if residual is not None:
            rows, nbr, rw = residual[:3]
            res = (rows.clamp(0, n_cap - 1), nbr.clamp(0, n_cap - 1),
                   torch.where(nbr == root, INF_E, rw))
        relax_step_plain(dist[lane], out[lane], f, deltas, sw, res)

    _each_lane(gate, flag, dist.shape[0], one)


def fabric_relax(dist, out, flag, deltas, shift_w, residual, roots,
                 gate: Optional[Gate] = None) -> None:
    """out[r] = one Jacobi relaxation of root r's [D, n_cap] plane
    ``dist[r]`` over the shared class weights ``shift_w`` [s_cap, n_cap]
    and the shared residual ELL ``residual`` = (res_rows [r_cap],
    res_nbr, res_w [r_cap, kr_cap], ext [r_cap]: ``fabric_extent`` of
    res_w) (None without residual edges), with ``roots[r]`` never a
    transit node; ORs 1 into ``flag`` when any word decreased. The
    ``gate`` (``ops/relax.Lanes``, a lane per root) opens the roots
    that run and records which changed."""
    if _is_cpu(dist):
        fabric_relax_plain(dist, out, flag, deltas, shift_w, residual,
                           roots, gate)
        return
    _int32(dist, out, flag, deltas, shift_w, roots)
    g, d_cap, n_cap = dist.shape
    p = cuda.ptr
    ga = _gate_args(gate)
    cuda.launch("fabric", "fabric_shift", "pppppiiipi" + _GATE_SIG,
                p(dist), p(out), p(deltas), p(shift_w), p(roots), d_cap,
                n_cap, shift_w.shape[0], p(flag), g, *ga)
    fabric_relax.launches += 1
    if residual is None:
        return
    rows, nbr, rw, ext = residual
    _int32(rows, nbr, rw, ext)
    if gate is not None:
        # the shift launch counted this step for every open root
        ga = _gate_args(gate._replace(inc=(0, 0)))
    cuda.launch("fabric", "fabric_residual", "ppppppp" + "iiiipi" + _GATE_SIG,
                p(dist), p(out), p(rows), p(nbr), p(rw), p(ext), p(roots),
                d_cap, n_cap, nbr.shape[0], nbr.shape[1], p(flag), g, *ga)
    fabric_relax.launches += 1


fabric_relax.launches = 0


# -- K22: the selection's bit words as bool masks -----------------------------

def unpack_bits_plain(words, x: int):
    col = torch.arange(x, device=words.device)
    return ((words[..., col // 16] >> (col % 16)) & 1).bool()


def unpack_bits(words, x: int):
    """int32 [..., ceil(x/16)] words, 16 bits each (``select.pack_words``)
    -> bool [..., x]."""
    if _is_cpu(words):
        return unpack_bits_plain(words, x)
    _int32(words)
    bits = torch.empty(words.shape[:-1] + (x,), dtype=torch.bool,
                       device=words.device)
    w = words.shape[-1]
    p = cuda.ptr
    cuda.launch("fabric", "unpack_bits", "ppLii", p(words), p(bits),
                words.numel() // max(w, 1), w, x)
    unpack_bits.launches += 1
    return bits


unpack_bits.launches = 0


# -- the step -----------------------------------------------------------------

def fabric_sssp(deltas, shift_w, residual, roots, seeds_nbr, seeds_w,
                n_trips: int, relax=fabric_relax, init=sssp_init,
                extent=fabric_extent):
    """Every root's [D, n_cap] distance plane after ``n_trips`` trips of
    ``UNROLL`` relaxations (``relax``, the ``fabric_relax`` signature,
    over ``residual`` = (res_rows, res_nbr, res_w) or None and its
    ``extent``) from its seed plane (``init``, K1s with a root axis: 0 at
    each live out-neighbour ``seeds_nbr[r, d]``, INF_E elsewhere), and
    the convergence vote. Returns ``(dist [Rt, D, n_cap], converged bool
    numpy [Rt], trips run)``."""
    rt, _ = seeds_nbr.shape
    n_cap = shift_w.shape[1]
    dev = shift_w.device
    if residual is not None:
        residual = (*residual, extent(residual[2]))

    def none(*shape):
        return torch.empty((rt,) + shape, dtype=torch.int32, device=dev)

    _, _, cur = init(none(0, n_cap), none(0), none(0, 0), none(0, 0), roots,
                     seeds_nbr, seeds_w)
    spare = torch.empty_like(cur)
    lanes = Lanes(rt, dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    trips = 0
    while trips < n_trips:
        for i in range(UNROLL):
            relax(cur, spare, flag, deltas, shift_w, residual, roots,
                  lanes.gate((trips - 1, ALWAYS), (trips, KEEP),
                             (int(i == 0), 1)))
            cur, spare = spare, cur
        trips += 1
        if not read_flag(flag):
            return cur, np.ones(rt, bool), trips
    # the vote: the roots that changed in the last trip relax once more
    # (into the spare plane); a root that changes there did not converge
    relax(cur, spare, flag, deltas, shift_w, residual, roots,
          lanes.gate((trips - 1, ALWAYS), (trips, KEEP)))
    read_flag(flag)
    return cur, lanes.st[:, 0].cpu().numpy() < trips, trips


def root_tables(plan, link_state, names) -> tuple:
    """-> (roots int32 [Rt], out_nbr, out_w int32 [Rt, D], links): the
    roots ``names`` of an ``EdgePlan`` and their out-slot tables
    (``plan.out_links``) padded to the widest, pad slots -1 / INF_E, as
    the whole-fabric step takes them; ``links`` holds each root's Link
    list."""
    outs = [plan.out_links(link_state, nm) for nm in names]
    d_cap = max(o[0].shape[0] for o in outs)
    out_nbr = np.full((len(names), d_cap), -1, np.int32)
    out_w = np.full((len(names), d_cap), INF_E, np.int32)
    for i, (nbr, w, _links) in enumerate(outs):
        out_nbr[i, : nbr.shape[0]] = nbr
        out_w[i, : w.shape[0]] = w
    roots = np.array([plan.node_index[nm] for nm in names], np.int32)
    return roots, out_nbr, out_w, [o[2] for o in outs]


def _nothing() -> None:
    pass


class FabricOut(NamedTuple):
    dist: torch.Tensor         # int32 [Rt, n_cap]
    metric: torch.Tensor       # int32 [Rt, P]
    s3w: torch.Tensor          # int32 [Rt, P, ceil(A/16)]
    nhw: torch.Tensor          # int32 [Rt, P, ceil(D/16)]
    ok: torch.Tensor           # bool [Rt, P]
    lfa_slot: torch.Tensor     # int32 [Rt, P]; -1 without LFA
    lfa_metric: torch.Tensor   # int32 [Rt, P]; 0 without LFA
    converged: np.ndarray      # bool [Rt]
    trips: int


def _step(deltas, shift_w, res_rows, res_nbr, res_w, mbuf, roots, out_nbr,
          out_w, n_trips, has_res, p_cap, a_cap, lfa, block_v4, relax, init,
          extent, select, mark) -> FabricOut:
    residual = (res_rows, res_nbr, res_w) if has_res else None
    mark()
    dist_d, converged, trips = fabric_sssp(
        deltas, shift_w, residual, roots, out_nbr, out_w, n_trips, relax,
        init, extent)
    mark()
    rt, n_cap = roots.shape[0], shift_w.shape[1]
    dist = torch.empty((rt, n_cap), dtype=torch.int32, device=dist_d.device)
    sel = select(dist_d, out_w, roots, mbuf, p_cap, a_cap, block_v4, lfa,
                 dist_out=dist)
    if lfa:
        lfa_slot, lfa_metric = sel[4:]
    else:
        lfa_slot = torch.full((rt, p_cap), -1, dtype=torch.int32,
                              device=dist.device)
        lfa_metric = torch.zeros((rt, p_cap), dtype=torch.int32,
                                 device=dist.device)
    mark()
    return FabricOut(dist, *sel[:4], lfa_slot, lfa_metric, converged, trips)


def fabric_step(deltas, shift_w, res_rows, res_nbr, res_w, mbuf, roots,
                out_nbr, out_w, *, n_trips: int, has_res: bool, p_cap: int,
                a_cap: int, lfa: bool = False, block_v4: bool = False,
                mark=_nothing) -> FabricOut:
    """The whole-fabric step for the int32 tensor ``roots`` [Rt] on the
    device of its tensors: the resident mirror (deltas [s_cap], shift_w
    [s_cap, n_cap], res_rows [r_cap], res_nbr / res_w [r_cap, kr_cap];
    the residual relaxes only with ``has_res``), the packed announcer
    matrix ``mbuf`` [6*P*A] (``select.pack_matrix``: drain flags,
    the v4 bit, min_nh) and each root's out-slot table ``out_nbr`` /
    ``out_w`` [Rt, D] (pad slots -1 / INF_E). K1s seeds, K21 trips and
    vote, K3 per root; ``lfa`` adds the backup columns, ``block_v4``
    drops v4 rows from ``ok``. ``mark`` is called at the start, after
    the SSSP and after the tail (the solver records CUDA events)."""
    return _step(deltas, shift_w, res_rows, res_nbr, res_w, mbuf, roots,
                 out_nbr, out_w, n_trips, has_res, p_cap, a_cap, lfa,
                 block_v4, fabric_relax, sssp_init, fabric_extent,
                 select_routes, mark)


def fabric_step_plain(deltas, shift_w, res_rows, res_nbr, res_w, mbuf,
                      roots, out_nbr, out_w, *, n_trips: int, has_res: bool,
                      p_cap: int, a_cap: int, lfa: bool = False,
                      block_v4: bool = False) -> FabricOut:
    """``fabric_step`` through the plain versions only (any device)."""
    return _step(deltas, shift_w, res_rows, res_nbr, res_w, mbuf, roots,
                 out_nbr, out_w, n_trips, has_res, p_cap, a_cap, lfa,
                 block_v4, fabric_relax_plain, sssp_init_plain,
                 fabric_extent_plain, select_routes_plain, _nothing)
