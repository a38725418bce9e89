"""The whole-fabric step: every requested root's batched-seed SSSP over
one shared copy of the shift-decomposed mirror, then best-route
selection per root — the port of ``parallel/sharding.py::
_sharded_fabric_fn``. One loop (``fabric_step_grid``) serves every
('batch', 'graph') grid of shards: roots split over 'batch', class
columns and residual rows over 'graph', with the group's min after
each relaxation (K23, the reference's ``pmin``); one card is a 1 x 1
grid (``fabric_step``), where that min is the identity.

Per root r (a lane): the [D, n_cap] seed plane of its out-neighbours
(K1s with a root axis, seed rows only), then exactly ``n_trips``
trips of ``UNROLL`` Jacobi relaxations with the root masked as a
transit node (K21 ``fabric_relax``, ``csrc/fabric.cu``: one launch a
relaxation that writes each word once; it finds a node's residual row
through the node -> row table ``row_table``, reads it up to its live
extent and runs only the class rows that hold a finite weight, both
from K21e ``fabric_extent`` once a step), then the
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
from openr_tpu_torch.ops.combine import (
    shard_combine_groups,
    shard_combine_groups_plain,
)
from openr_tpu_torch.ops.relax import (
    _GATE_SIG,
    ALWAYS,
    INF_E,
    KEEP,
    UNROLL,
    FlagBank,
    Gate,
    Lanes,
    _each_lane,
    _gate_args,
    _is_cpu,
    relax_step_mc_plain,
    sssp_init,
    sssp_init_plain,
)
from openr_tpu_torch.ops.select import select_routes, select_routes_plain


# -- K21e: each residual row's live extent, each class row's liveness ----

def fabric_extent_plain(res_w, shift_w=None):
    ext = None
    if res_w is not None:
        col = torch.arange(1, res_w.shape[1] + 1, dtype=torch.int32,
                           device=res_w.device)
        ext = torch.where(res_w < INF_E, col, 0).amax(dim=1).to(torch.int32)
    if shift_w is None:
        return ext
    return ext, (shift_w < INF_E).any(dim=1).to(torch.int32)


def fabric_extent(res_w, shift_w=None):
    """int32 [r_cap]: 1 + the last column of each residual row whose
    weight is finite (< INF_E), 0 for a row with none; K21 reads a row
    up to there (an INF_E weight cannot lower a word). With ``shift_w``
    (a member's class rows [s_cap, w]) returns ``(ext, live)``, ``live``
    int32 [s_cap] 1 where the class row holds a finite weight (K21 runs
    only those); ``res_w`` may then be None (no residual: ext None).
    One launch."""
    lead = res_w if res_w is not None else shift_w
    if _is_cpu(lead):
        return fabric_extent_plain(res_w, shift_w)
    dev = lead.device
    r_cap, kr_cap = res_w.shape if res_w is not None else (0, 0)
    s_cap, w_cols = shift_w.shape if shift_w is not None else (0, 0)
    ext = None if res_w is None else torch.empty(
        r_cap, dtype=torch.int32, device=dev)
    live = None if shift_w is None else torch.empty(
        s_cap, dtype=torch.int32, device=dev)
    cuda.launch("fabric", "fabric_extent", "ttiittii", res_w, ext, r_cap,
                kr_cap, shift_w, live, s_cap, w_cols)
    fabric_extent.launches += 1
    return ext if shift_w is None else (ext, live)


fabric_extent.launches = 0


def row_table(res_rows, n_cap: int):
    """int32 [n_cap]: the residual row of each node, -1 where the node has
    none — the inverse of ``res_rows`` (pad rows, -1, dropped). Raises
    when a node has two rows: K21 writes each word once, from its node's
    one row (``ops/edgeplan.py`` builds one row a destination). Built on
    the host once a plan or placement; a tensor's table lies on its
    device, an array's is an array."""
    arr = (res_rows.cpu().numpy() if isinstance(res_rows, torch.Tensor)
           else np.asarray(res_rows))
    rows = np.flatnonzero(arr >= 0)
    nodes = arr[rows]
    if nodes.size and int(nodes.max()) >= n_cap:
        raise ValueError(f"residual row of node {int(nodes.max())} past "
                         f"n_cap {n_cap}")
    if np.unique(nodes).size != nodes.size:
        raise ValueError("K21: residual rows must be unique per node")
    table = np.full(n_cap, -1, np.int32)
    table[nodes] = rows
    if isinstance(res_rows, torch.Tensor):
        return torch.from_numpy(table).to(res_rows.device)
    return table


# -- K21: one relaxation of every root's planes -------------------------------

def fabric_relax_plain(dist, out, flag, deltas, shift_w, residual, roots,
                       gate: Optional[Gate] = None, live=None) -> None:
    # the whole width is one window
    fabric_relax_mc_plain(dist, out, flag, deltas, shift_w, residual, roots,
                          gate, 0)


def fabric_relax(dist, out, flag, deltas, shift_w, residual, roots,
                 gate: Optional[Gate] = None, live=None) -> None:
    """out[r] = one Jacobi relaxation of root r's [D, n_cap] plane
    ``dist[r]`` over the shared class weights ``shift_w`` [s_cap, n_cap]
    and the shared residual ELL ``residual`` = (res_rows [r_cap],
    res_nbr, res_w [r_cap, kr_cap], ext [r_cap]: ``fabric_extent`` of
    res_w, and optionally row_of [n_cap]: ``row_table`` of res_rows,
    else built here on the host) (None without residual edges), with
    ``roots[r]`` never a transit node; ORs 1 into ``flag`` when any word
    decreased. The ``gate`` (``ops/relax.Lanes``, a lane per root) opens
    the roots that run and records which changed; ``live`` (K21e's class
    mask) names the classes that can lower a word (None: all). On the
    card: one launch."""
    if _is_cpu(dist):
        fabric_relax_plain(dist, out, flag, deltas, shift_w, residual,
                           roots, gate)
        return
    _launch_fabric(dist, out, flag, deltas, shift_w, residual, roots, gate,
                   0, live)
    fabric_relax.launches += 1


fabric_relax.launches = 0


def _launch_fabric(dist, out, flag, deltas, shift_w, residual, roots, gate,
                   col0: int, live) -> None:
    """Launch K21 over the class columns [col0, col0 + shift_w width)
    (and the residual rows given): one launch. ``flag`` may be None."""
    g, d_cap, n_cap = dist.shape
    s_cap, w_cols = shift_w.shape
    nbr = rw = ext = row_of = None
    kr_cap = 0
    if residual is not None:
        rows, nbr, rw, ext = residual[:4]
        row_of = residual[4] if len(residual) > 4 else row_table(rows, n_cap)
        kr_cap = nbr.shape[1]
    cuda.launch("fabric", "fabric_relax",
                "tttttttttt" + "iiiiii" + "ti" + _GATE_SIG,
                dist, out, deltas, shift_w, live, roots, nbr, rw, ext,
                row_of, d_cap, n_cap, s_cap, col0, w_cols, kr_cap, flag, g,
                *_gate_args(gate))


# -- K21 [mc]: one shard's relaxation of every root's planes ------------------

def fabric_relax_mc_plain(dist, out, flag, deltas, shift_w, residual, roots,
                          gate: Optional[Gate] = None,
                          col0: int = 0, live=None) -> None:
    n_cap = dist.shape[-1]
    w_cols = shift_w.shape[1]
    root_of = roots.tolist()

    def one(lane, f):
        root = root_of[lane]
        sw = shift_w.clone()
        if 0 <= root - col0 < w_cols:
            sw[:, root - col0] = INF_E
        res = None
        if residual is not None:
            rows, nbr, rw = residual[:3]
            res = (rows.clamp(0, n_cap - 1), nbr.clamp(0, n_cap - 1),
                   torch.where(nbr == root, INF_E, rw))
        relax_step_mc_plain(dist[lane], out[lane], f, deltas, sw, res, col0)

    _each_lane(gate, flag, dist.shape[0], one)


def fabric_relax_mc(dist, out, flag, deltas, shift_w, residual, roots,
                    gate: Optional[Gate] = None, col0: int = 0,
                    live=None) -> None:
    """K21 [mc]: ``fabric_relax`` for one shard of a ('batch', 'graph')
    mesh, which holds the class columns [col0, col0 + w) of ``shift_w``
    ([s_cap, w]) and its own residual rows (``residual``, its rows,
    their extent and its node -> row table: a node without a row in this
    shard has none here): each root's planes relaxed over the shard's
    own sources only, the root masked only where it lies in the window
    (``parallel/sharding.py``, :104-148). The group's min over its
    members' planes (``ops/combine.shard_combine_groups``) is the
    reference's ``pmin``. ``flag`` may be None. On the card: one
    launch."""
    if _is_cpu(dist):
        fabric_relax_mc_plain(dist, out, flag, deltas, shift_w, residual,
                              roots, gate, col0)
        return
    _launch_fabric(dist, out, flag, deltas, shift_w, residual, roots, gate,
                   col0, live)
    fabric_relax_mc.launches += 1


fabric_relax_mc.launches = 0


# -- K22: the selection's bit words as bool masks -----------------------------

def unpack_bits_plain(words, x: int):
    col = torch.arange(x, device=words.device)
    return ((words[..., col // 16] >> (col % 16)) & 1).bool()


def unpack_bits(words, x: int):
    """int32 [..., ceil(x/16)] words, 16 bits each (``select.pack_words``)
    -> bool [..., x]."""
    if _is_cpu(words):
        return unpack_bits_plain(words, x)
    bits = torch.empty(words.shape[:-1] + (x,), dtype=torch.bool,
                       device=words.device)
    w = words.shape[-1]
    cuda.launch("fabric", "unpack_bits", "tbLii", words, bits,
                words.numel() // max(w, 1), w, x)
    unpack_bits.launches += 1
    return bits


unpack_bits.launches = 0


# -- the step ----------------------------------------------------------------

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


class FabricKernels(NamedTuple):
    """The functions one step runs: K21 over a one-member group's whole
    width (``relax``) and over a member's column window (``relax_mc``),
    K1s, K21e (extents and live classes), K3 and the groups' combine
    (K23, every active group of a card at once)."""
    relax: object
    relax_mc: object
    init: object
    extent: object
    select: object
    combine: object


def fabric_sssp_grid(deltas, shift_w, residual, roots, seeds_nbr, seeds_w,
                     n_trips: int, kernels: FabricKernels):
    """The SSSP of the whole-fabric step on a ('batch', 'graph') grid of
    shards (the reference's ``_sharded_fabric_fn``, :70-148; a 1 x 1
    grid is one card). Every input is a grid ``x[b][j]`` of shard
    (b, j)'s tensors: ``deltas`` whole, ``shift_w`` the shard's class
    columns [j * w, (j + 1) * w) of the ``graph * w``-node plan,
    ``residual`` its own residual rows (res_rows, res_nbr, res_w[,
    row_of]: its node -> row table, built here when missing), or None,
    ``roots`` / ``seeds_nbr`` / ``seeds_w`` its batch group's roots and
    their out-slot tables.

    Per group: K1s seeds on every member, up to ``n_trips`` trips of
    ``UNROLL`` relaxations (K21 on every member over its own sources and
    rows; with more than one member, the groups' min of the planes and
    max of the per-root change stamps, one K23 launch a relaxation for
    every active group of a card), each root gated off once its
    planes stop changing, and the group's exit on a trip that changed
    nothing, so the outputs are the reference's fixpoint. A group still
    changing after the last trip runs the vote: one more relaxation of
    the roots that changed in it; a root that changes there (on any
    member) did not converge. Returns (planes grid, converged bool numpy
    [Rt] in batch order, the most trips a group ran)."""
    nb, ng = len(shift_w), len(shift_w[0])
    col = shift_w[0][0].shape[1]
    n_cap = col * ng
    k = kernels
    # once a step: each member's live classes and residual extents (K21e)
    # and its node -> row table (given, or built on the host here)
    live = [[None] * ng for _ in range(nb)]
    res = [[None] * ng for _ in range(nb)]
    for b in range(nb):
        for j in range(ng):
            mine = None if residual is None else residual[b][j]
            ext, live[b][j] = k.extent(None if mine is None else mine[2],
                                       shift_w[b][j])
            if mine is not None:
                res[b][j] = (*mine[:3], ext, mine[3] if len(mine) > 3
                             else row_table(mine[0], n_cap))
    cur, lanes = [], []
    for b in range(nb):
        row, lrow = [], []
        for j in range(ng):
            dev = shift_w[b][j].device
            rt = roots[b][j].shape[0]

            def none(*shape, _rt=rt, _dev=dev):
                return torch.empty((_rt,) + shape, dtype=torch.int32,
                                   device=_dev)

            _, _, d0 = k.init(none(0, n_cap), none(0), none(0, 0),
                              none(0, 0), roots[b][j], seeds_nbr[b][j],
                              seeds_w[b][j])
            row.append(d0)
            lrow.append(Lanes(rt, dev))
        cur.append(row)
        lanes.append(lrow)
    spare = [[torch.empty_like(t) for t in row] for row in cur]
    flags = FlagBank([shift_w[b][0].device for b in range(nb)])
    trips = [0] * nb
    converged = [None] * nb

    def relax_groups(active, inc, vote=False):
        for b in active:
            gate = ((trips[b] - 1, ALWAYS), (trips[b], KEEP), inc)
            for j in range(ng):
                step = (cur[b][j], spare[b][j], flags[b] if ng == 1 else None,
                        deltas[b][j], shift_w[b][j], res[b][j], roots[b][j],
                        lanes[b][j].gate(*gate))
                if ng == 1:
                    k.relax(*step, live=live[b][j])
                else:
                    k.relax_mc(*step, j * col, live=live[b][j])
        if ng > 1:
            # a root changed in a group iff it changed on a member: the
            # stamps' max, with the planes' min in the same launch
            stamps = [[ln.st for ln in lanes[b]] for b in active]
            if vote:
                k.combine(stamps, "max")
            else:
                k.combine([spare[b] for b in active], "min",
                          refs=[cur[b][0] for b in active],
                          flags=[flags[b] for b in active], also=stamps)
        if not vote:
            for b in active:
                cur[b], spare[b] = spare[b], cur[b]

    active = list(range(nb))
    while active and max(trips[b] for b in active) < n_trips:
        for i in range(UNROLL):
            relax_groups(active, (int(i == 0), 1))
        for b in active:
            trips[b] += 1
        changed = flags.read()
        still = []
        for b in active:
            if changed[b]:
                still.append(b)
            else:
                converged[b] = np.ones(roots[b][0].shape[0], bool)
        active = still
    if active:
        # the vote (into the spare planes)
        relax_groups(active, (0, 0), vote=True)
        if ng == 1:
            flags.read()
        for b in active:
            converged[b] = lanes[b][0].st[:, 0].cpu().numpy() < trips[b]
    return cur, np.concatenate(converged), max(trips)


def fabric_step_grid(deltas, shift_w, res_rows, res_nbr, res_w, mbuf, roots,
                     out_nbr, out_w, *, n_trips: int, has_res: bool,
                     p_cap: int, a_cap: int, lfa: bool = False,
                     block_v4: bool = False, mark=None,
                     kernels: Optional[FabricKernels] = None,
                     row_of=None) -> FabricOut:
    """The whole-fabric step on a grid of shards: ``fabric_sssp_grid``
    (``res_*`` grids of each shard's residual rows, relaxed only with
    ``has_res``; ``row_of`` a grid of their node -> row tables, built
    from ``res_rows`` when None), then per batch group K3 with a root axis on its first
    member over the packed announcer matrix ``mbuf`` (a grid of whole
    copies; ``select.pack_matrix``: drain flags, the v4 bit, min_nh):
    distances, selection, next-hop words, ``lfa``'s backup columns, and
    route-ok (``block_v4`` drops v4 rows). The outputs lie on shard
    (0, 0)'s device, roots in batch order. ``kernels`` defaults to the
    CUDA wrappers. ``mark`` is called at the start, after the SSSP and
    after the tail (the solver records CUDA events)."""
    k = kernels or KERNELS
    mark = mark or _nothing
    nb, ng = len(shift_w), len(shift_w[0])
    residual = [[(res_rows[b][j], res_nbr[b][j], res_w[b][j])
                 + (() if row_of is None else (row_of[b][j],))
                 for j in range(ng)] for b in range(nb)] if has_res else None
    mark()
    cur, converged, trips = fabric_sssp_grid(
        deltas, shift_w, residual, roots, out_nbr, out_w, n_trips, k)
    mark()
    outs = []
    for b in range(nb):
        dist_d = cur[b][0]
        rt, n_cap = dist_d.shape[0], dist_d.shape[2]
        dist = torch.empty((rt, n_cap), dtype=torch.int32,
                           device=dist_d.device)
        sel = k.select(dist_d, out_w[b][0], roots[b][0], mbuf[b][0], p_cap,
                       a_cap, block_v4, lfa, dist_out=dist)
        if lfa:
            lfa_slot, lfa_metric = sel[4:]
        else:
            lfa_slot = torch.full((rt, p_cap), -1, dtype=torch.int32,
                                  device=dist.device)
            lfa_metric = torch.zeros((rt, p_cap), dtype=torch.int32,
                                     device=dist.device)
        outs.append((dist, *sel[:4], lfa_slot, lfa_metric))
    first = shift_w[0][0].device
    cols = [outs[0][i] if nb == 1 else
            torch.cat([o[i].to(first) for o in outs]) for i in range(7)]
    mark()
    return FabricOut(*cols, converged, trips)


def _nothing() -> None:
    pass


def _one(*tensors) -> list:
    """Each tensor as a 1 x 1 grid."""
    return [[[t]] for t in tensors]


def fabric_sssp(deltas, shift_w, residual, roots, seeds_nbr, seeds_w,
                n_trips: int, kernels: Optional[FabricKernels] = None):
    """Every root's [D, n_cap] distance plane on one card: the grid SSSP
    over a 1 x 1 grid (K1s seeds, K21 trips over ``residual`` =
    (res_rows, res_nbr, res_w) or None, the vote). Returns ``(dist [Rt,
    D, n_cap], converged bool numpy [Rt], trips run)``."""
    res = None if residual is None else [[tuple(residual)]]
    cur, converged, trips = fabric_sssp_grid(
        *_one(deltas, shift_w), res, *_one(roots, seeds_nbr, seeds_w),
        n_trips, kernels or KERNELS)
    return cur[0][0], converged, trips


def fabric_step(deltas, shift_w, res_rows, res_nbr, res_w, mbuf, roots,
                out_nbr, out_w, *, n_trips: int, has_res: bool, p_cap: int,
                a_cap: int, lfa: bool = False, block_v4: bool = False,
                mark=None) -> FabricOut:
    """The whole-fabric step for the int32 tensor ``roots`` [Rt] on the
    device of its tensors: ``fabric_step_grid`` over a 1 x 1 grid of the
    resident mirror (deltas [s_cap], shift_w [s_cap, n_cap], res_rows
    [r_cap], res_nbr / res_w [r_cap, kr_cap]), the packed announcer
    matrix ``mbuf`` [6*P*A] and each root's out-slot table ``out_nbr``
    / ``out_w`` [Rt, D] (pad slots -1 / INF_E)."""
    return fabric_step_grid(
        *_one(deltas, shift_w, res_rows, res_nbr, res_w, mbuf, roots,
              out_nbr, out_w),
        n_trips=n_trips, has_res=has_res, p_cap=p_cap, a_cap=a_cap, lfa=lfa,
        block_v4=block_v4, mark=mark)


def fabric_step_plain(deltas, shift_w, res_rows, res_nbr, res_w, mbuf,
                      roots, out_nbr, out_w, *, n_trips: int, has_res: bool,
                      p_cap: int, a_cap: int, lfa: bool = False,
                      block_v4: bool = False) -> FabricOut:
    """``fabric_step`` through the plain versions only (any device)."""
    return fabric_step_grid(
        *_one(deltas, shift_w, res_rows, res_nbr, res_w, mbuf, roots,
              out_nbr, out_w),
        n_trips=n_trips, has_res=has_res, p_cap=p_cap, a_cap=a_cap, lfa=lfa,
        block_v4=block_v4, kernels=PLAIN)


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


KERNELS = FabricKernels(fabric_relax, fabric_relax_mc, sssp_init,
                        fabric_extent, select_routes, shard_combine_groups)
PLAIN = FabricKernels(fabric_relax_plain, fabric_relax_mc_plain,
                      sssp_init_plain, fabric_extent_plain,
                      select_routes_plain, shard_combine_groups_plain)
