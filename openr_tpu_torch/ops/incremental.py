"""Incremental SSSP for the churn solve: seed from the vantage's previous
distance plane and re-anchor only the affected cone behind metric
increases (counterpart of the JAX package's ``ops/incremental.py``).

Relaxation over non-negative int32 weights with the root-neighbour
seeds pinned to 0 has a unique fixpoint, reached from ANY pointwise
over-estimate of the true distances. After a decrease the previous
plane already is one; after an increase it under-estimates exactly on
the nodes whose old shortest-path chain crosses an increased edge. So:

  1. ``old_planes`` rebuilds the pre-churn, root-masked weight planes
     from the new resident planes and the dirty slots' pre-drain values,
     one ``old_plane`` launch a plane (copy, patch and root mask in one
     pass);
  2. ``parent_plane`` (K6) picks one old shortest-path parent per
     (lane, node) — the parent forest;
  3. ``cone_seed`` (K7) marks the head of every increased dirty edge
     that is a forest edge;
  4. ``cone_resolve`` (K8 + K9, one cooperative launch) spreads the
     marks down the forest to the closure (at most ``max_trips(n_cap) *
     UNROLL`` sweeps, no host read), counts the cone, decides
     ``fell_back = cone > cone_limit`` on the device, and writes the
     seed plane: the previous plane with the cone set to INF_E, or K1s's
     cold seed when it fell back, with the root out-neighbour pins
     min-ed in;
  5. the shared relaxation loops of ``ops/relax.py`` run to the
     fixpoint from that seed, so the result is bit-identical to the
     cold solve and trips / rounds equal the JAX loops' from the same
     seed.

Zero-weight edges would let equal-distance parent cycles hide from the
cone; the solver gates the incremental path off on any plan with
``has_zero_w``, so every parent chain strictly decreases the previous
distance and the parent plane is a forest.

Wrappers (``scatter_set``, ``old_plane``, ``parent_plane``, ``cone_seed``,
``cone_resolve``, and the multichip tier's ``scatter_window``,
``scatter_parts``, ``parent_shift_mc``, ``parent_fill``,
``owned_weights``, ``cone_seed_mc``, ``cone_finish``, composed per shard
by ``parallel/sharding.mc_incremental_sssp``) launch their CUDA kernel
(``csrc/incremental.cu``) on a CUDA tensor and run the plain version
(``*_plain``) only on a CPU tensor; each counts its kernel launches in
``<wrapper>.launches``. ``old_planes`` and ``incremental_sssp`` compose
the wrappers, so on CPU tensors they are the plain versions of the JAX
functions of the same names, with the same arguments and returns.

Dirty pads are out-of-range flat indices and drop everywhere.
"""

from __future__ import annotations

import torch

from openr_tpu_torch.ops import cuda
from openr_tpu_torch.ops.relax import (
    INF_E,
    UNROLL,
    _is_cpu,
    solve_from,
    sssp_init,
    window_row,
)


def _check_len(n: int) -> None:
    if n >= 1 << 31:
        raise ValueError("kernel index space exceeds int32")


# -- K5: flat scatter into a resident plane ----------------------------------

def scatter_set_plain(plane, idx, vals, plane_b=None, idx_b=None,
                      vals_b=None) -> None:
    for pl, ix, vl in ((plane, idx, vals), (plane_b, idx_b, vals_b)):
        if pl is None:
            continue
        flat = pl.view(-1)
        ok = (ix >= 0) & (ix < flat.numel())
        live = ix[ok].long()
        if torch.unique(live).numel() != live.numel():
            raise ValueError("scatter_set: in-range indices must be unique")
        flat[live] = vl[ok]


def scatter_set(plane, idx, vals, plane_b=None, idx_b=None,
                vals_b=None) -> None:
    """In place: ``plane.ravel()[idx[i]] = vals[i]`` for every ``i`` with
    ``idx[i]`` in ``[0, plane.numel())``; other entries are pads and
    drop. With ``plane_b`` the second segment (``idx_b``, ``vals_b``)
    goes into it the same way, in the same launch: a sync's shift and
    residual entries, staged in one buffer by the caller
    (``decision/gpu_solver.GpuSpfSolver._scatter_counted``). The
    in-range indices of a segment must be unique (the dirty lists are
    consolidated, ``ops/edgeplan._consolidate``): the plain version
    raises on a duplicate, the kernel cannot order one. One launch, no
    torch op."""
    if _is_cpu(plane):
        scatter_set_plain(plane, idx, vals, plane_b, idx_b, vals_b)
        return
    n = idx.numel()
    n_b = 0 if plane_b is None else idx_b.numel()
    if n != vals.numel() or (plane_b is not None and n_b != vals_b.numel()):
        raise ValueError("scatter_set: idx and vals differ in length")
    if n + n_b == 0:
        return
    numel = plane.numel()
    numel_b = 0 if plane_b is None else plane_b.numel()
    _check_len(max(numel, numel_b, n + n_b))
    cuda.launch("incremental", "scatter_set", "tttiitttii", plane, idx, vals,
                n, numel, plane_b, idx_b, vals_b, n_b, numel_b)
    scatter_set.launches += 1


scatter_set.launches = 0


def scatter_window_plain(plane, idx, vals, shape: tuple, row0: int = 0,
                         col0: int = 0) -> None:
    rows, cols = shape
    w_rows, w_cols = plane.shape
    f = idx.long()
    r = torch.div(f, cols, rounding_mode="floor") - row0
    c = torch.remainder(f, cols) - col0
    ok = ((f >= 0) & (f < rows * cols) & (r >= 0) & (r < w_rows) & (c >= 0)
          & (c < w_cols))
    scatter_set_plain(plane, torch.where(ok, r * w_cols + c, -1).to(
        torch.int32), vals)


def scatter_window(plane, idx, vals, shape: tuple, row0: int = 0,
                   col0: int = 0) -> None:
    """K5 [mc]: ``scatter_set`` of flat indices into a global ``shape``
    = (rows, cols) plane, applied to the shard ``plane`` [w_rows, w_cols]
    that holds its window [row0, row0 + w_rows) x [col0, col0 + w_cols):
    each index inside the window lands at its local position, every
    other one (another shard's, or a pad) drops. A shift plane is split
    by columns, the residual ELL by rows (``parallel/sharding.py::
    make_mc_incremental_sssp``, :494-516; ``tpu_solver._mc_scatter_jit``,
    the in-place sharded update). ``scatter_parts`` does every part of
    a resident array on one card in one launch."""
    if _is_cpu(plane):
        scatter_window_plain(plane, idx, vals, shape, row0, col0)
        return
    n = idx.numel()
    if n != vals.numel():
        raise ValueError("scatter_window: idx and vals differ in length")
    if n == 0:
        return
    rows, cols = shape
    _check_len(rows * cols)
    cuda.launch("incremental", "scatter_window", "tttiiiiiii",
                plane, idx, vals, n, rows, cols, row0, plane.shape[0], col0,
                plane.shape[1])
    scatter_window.launches += 1


scatter_window.launches = 0


def part_table(parts, windows):
    """The device table of ``scatter_parts``: int64 [len(parts), 5], a
    row (address, row0, col0, w_rows, w_cols) a part, on the parts'
    card. Build it once for a placed array (the parts' addresses do
    not move) and pass it to every scatter into it."""
    rows = [[t.data_ptr(), r0, c0, *t.shape] for t, (r0, c0) in
            zip(parts, windows)]
    return torch.tensor(rows, dtype=torch.int64, device=parts[0].device)


def scatter_parts_plain(parts, windows, idx, vals, shape: tuple) -> None:
    for t, (row0, col0) in zip(parts, windows):
        scatter_window_plain(t, idx, vals, shape, row0, col0)


def scatter_parts(parts, windows, idx, vals, shape: tuple,
                  table=None) -> None:
    """K5 [mc] on one card: ``scatter_window`` into each of ``parts`` (2-D
    planes on one card, the distinct parts of a resident sharded array
    there) at its window ``windows[i]`` = (row0, col0) of the global
    ``shape``, all in one launch. ``table`` is ``part_table(parts,
    windows)``, held by the caller for the placed array (built here
    when None)."""
    if _is_cpu(idx):
        scatter_parts_plain(parts, windows, idx, vals, shape)
        return
    n = idx.numel()
    if n != vals.numel():
        raise ValueError("scatter_parts: idx and vals differ in length")
    if n == 0 or not parts:
        return
    rows, cols = shape
    _check_len(rows * cols)
    if table is None:
        table = part_table(parts, windows)
    if table.shape != (len(parts), 5):
        raise ValueError("scatter_parts: the table does not match the parts")
    cuda.launch("incremental", "scatter_parts", "littiii", table,
                len(parts), idx, vals, n, rows, cols)
    scatter_parts.launches += 1


scatter_parts.launches = 0


def old_plane_plain(plane, idx, vals, root: int = -1, nbr=None):
    out = plane.clone()
    scatter_set_plain(out, idx, vals)
    if root < 0:
        return out
    if nbr is not None:
        return torch.where(nbr == root, INF_E, out)
    if root < out.shape[1]:
        out[:, root] = INF_E
    return out


def old_plane(plane, idx, vals, root: int = -1, nbr=None):
    """-> a new [rows, cols] plane: ``plane`` with ``vals[i]`` put back
    at flat ``idx[i]`` (pads drop; in-range indices unique, as for
    ``scatter_set``), then INF_E at every slot whose key is ``root``:
    the key is the slot's column, or ``nbr`` at the slot where given (a
    residual slot's source node); ``root < 0`` masks nothing. One
    launch reads ``plane`` once and writes the result once."""
    if _is_cpu(plane):
        return old_plane_plain(plane, idx, vals, root, nbr)
    n = idx.numel()
    if n != vals.numel():
        raise ValueError("old_plane: idx and vals differ in length")
    if nbr is not None and nbr.shape != plane.shape:
        raise ValueError("old_plane: nbr and plane differ in shape")
    rows, cols = plane.shape
    _check_len(rows * cols)
    out = torch.empty_like(plane)
    cuda.launch("incremental", "old_plane", "ttttitiii", plane, nbr, idx,
                vals, n, out, rows, cols, int(root))
    old_plane.launches += 1
    return out


old_plane.launches = 0


def old_planes(shift_w, res_w, s_dirty_idx, s_dirty_old, r_dirty_idx,
               r_dirty_old, has_res, root: int = -1, res_nbr=None):
    """The pre-churn weight planes: the new resident planes with each
    dirty slot's pre-drain value put back, one ``old_plane`` each. Pads
    drop. Without a residual the residual plane passes through. With
    ``root`` >= 0 they come root-masked as K1s masks the new ones (the
    root's shift column, and residual slots whose source ``res_nbr`` is
    the root, at INF_E): the reference's ``_old_planes`` followed by
    ``incremental_sssp``'s mask (``ops/incremental.py``, :150-157)."""
    old_shift = old_plane(shift_w, s_dirty_idx, s_dirty_old, root)
    if not has_res:
        return old_shift, res_w
    if root >= 0 and res_nbr is None:
        raise ValueError("old_planes: a root mask needs res_nbr")
    return old_shift, old_plane(res_w, r_dirty_idx, r_dirty_old, root,
                                res_nbr)


# -- K6: the parent forest under the old weights -----------------------------

def _check_unique_rows(res_rows) -> None:
    rows = res_rows[res_rows >= 0]
    if torch.unique(rows).numel() != rows.numel():
        raise ValueError("parent_plane: residual rows must be unique per node")


def _held(out, like):
    """``out`` checked to be an int32 plane of ``like``'s shape, or a new
    one."""
    if out is None:
        return torch.empty(like.shape, dtype=torch.int32, device=like.device)
    if out.shape != like.shape or out.dtype != torch.int32:
        raise ValueError("parent plane: out must be int32 of prev's shape")
    return out


def parent_plane_plain(deltas, swm_old, res_rows, res_nbr, rwm_old,
                       prev_dist, s_cap, has_res, n_cap, d_cap, out=None):
    # the whole width is one window
    par = parent_shift_mc_plain(deltas, swm_old, prev_dist, s_cap, 0, out)
    if has_res:
        parent_fill_plain(par, res_rows, res_nbr, rwm_old, prev_dist)
    return par


def parent_plane(deltas, swm_old, res_rows, res_nbr, rwm_old, prev_dist,
                 s_cap, has_res, n_cap, d_cap, out=None):
    """-> par int32 [D, N]: ``par[d, v] = u`` for an edge u -> v with
    ``prev[d, u] + w_old(u -> v) == prev[d, v]`` (both finite), else -1.
    The lowest tight shift class wins; the residual fills only nodes
    still at -1, the first tight slot of the node's row winning.
    ``swm_old`` / ``rwm_old`` are the root-masked old weights. Residual
    rows must be unique per node.

    ``out``, when given, is a plane held by the caller (the vantage's
    ``_VantageState.par``), every word written: the call then makes one
    launch, no torch op and no allocation. The incremental solve reads
    the plane only inside the solve (K7 and the cone) and never returns
    it, so a held plane is never the caller's ``prev_dist``. On the card:
    one ``parent_plane`` launch with or without a residual (cooperative
    with one, ``csrc/incremental.cu``)."""
    if _is_cpu(prev_dist):
        return parent_plane_plain(deltas, swm_old, res_rows, res_nbr,
                                  rwm_old, prev_dist, s_cap, has_res,
                                  n_cap, d_cap, out)
    _check_len(d_cap * n_cap)
    par = _held(out, prev_dist)
    r_cap, kr_cap = res_nbr.shape if has_res else (0, 0)
    if not has_res:
        res_rows = res_nbr = rwm_old = None
    cuda.launch("incremental", "parent_plane", "tttttttiiiiiii", deltas,
                swm_old, prev_dist, par, res_rows, res_nbr, rwm_old, s_cap,
                n_cap, d_cap, 0, n_cap, r_cap, kr_cap)
    parent_plane.launches += 1
    return par


parent_plane.launches = 0


def parent_shift_mc_plain(deltas, swm_old, prev_dist, s_cap: int,
                          col0: int, out=None):
    d_cap, n_cap = prev_dist.shape
    dev = prev_dist.device
    par = torch.full((d_cap, n_cap), -1, dtype=torch.int32, device=dev)
    src = torch.arange(n_cap, dtype=torch.int32, device=dev)
    live = prev_dist < INF_E
    for k, dk in enumerate(deltas.tolist()[:s_cap]):
        wk = window_row(swm_old, k, col0, n_cap)
        hit = (live & (wk < INF_E)[None, :]
               & (prev_dist + wk[None, :] == torch.roll(prev_dist, -dk, 1)))
        par = torch.where((par < 0) & torch.roll(hit, dk, dims=1),
                          torch.roll(src, dk)[None, :], par)
    if out is None:
        return par
    _held(out, prev_dist).copy_(par)
    return out


def parent_shift_mc(deltas, swm_old, prev_dist, s_cap: int, col0: int,
                    out=None):
    """K6 [mc]: the shift part of ``parent_plane`` for one shard, whose
    ``swm_old`` [s_cap, w] holds the root-masked old weights of the
    source columns [col0, col0 + w): ``par[d, v]`` is the source of the
    lowest class whose old edge into v is tight among the shard's own
    sources, else -1 (into ``out`` when given). The group's max over
    its members (``ops/combine.shard_combine``) is the reference's
    ``pmax`` (``parallel/sharding.py``, :527-551); ``parent_fill`` then
    adds the residual parents. One ``parent_plane`` launch without a
    residual."""
    if _is_cpu(prev_dist):
        return parent_shift_mc_plain(deltas, swm_old, prev_dist, s_cap,
                                     col0, out)
    d_cap, n_cap = prev_dist.shape
    _check_len(d_cap * n_cap)
    par = _held(out, prev_dist)
    cuda.launch("incremental", "parent_plane", "tttttttiiiiiii", deltas,
                swm_old, prev_dist, par, None, None, None, s_cap, n_cap,
                d_cap, col0, swm_old.shape[1], 0, 0)
    parent_shift_mc.launches += 1
    return par


parent_shift_mc.launches = 0


def parent_fill_plain(par, res_rows, res_nbr, rwm_old, prev_dist) -> None:
    d_cap, n_cap = prev_dist.shape
    _check_unique_rows(res_rows)
    nbr_c = res_nbr.clamp(0, n_cap - 1).long()
    rows_c = res_rows.clamp(0, n_cap - 1).long()
    row_valid = res_rows >= 0
    prev_n = prev_dist[:, nbr_c]
    hit = ((prev_n < INF_E) & (rwm_old < INF_E)[None]
           & (prev_n + rwm_old[None] == prev_dist[:, rows_c][:, :, None])
           & (res_nbr >= 0)[None])
    first = hit.to(torch.int32).argmax(dim=2)
    pick = torch.gather(res_nbr[None].expand(d_cap, -1, -1), 2,
                        first[:, :, None])[:, :, 0]
    cur = par[:, rows_c]
    new = torch.where((cur < 0) & hit.any(dim=2) & row_valid[None], pick, cur)
    par[:, res_rows[row_valid].long()] = new[:, row_valid]


def parent_fill(par, res_rows, res_nbr, rwm_old, prev_dist) -> None:
    """K6's residual part on its own, in place: each node still without
    a parent in ``par`` takes the first tight slot of its residual row
    (after the multichip tier's max over the shift parts,
    ``parallel/sharding.py``, :552-573). Residual rows must be unique.
    One ``parent_plane`` launch with the shift phase off."""
    if _is_cpu(prev_dist):
        parent_fill_plain(par, res_rows, res_nbr, rwm_old, prev_dist)
        return
    d_cap, n_cap = prev_dist.shape
    r_cap, kr_cap = res_nbr.shape
    cuda.launch("incremental", "parent_plane", "tttttttiiiiiii", None, None,
                prev_dist, par, res_rows, res_nbr, rwm_old, 0, n_cap, d_cap,
                0, 0, r_cap, kr_cap)
    parent_fill.launches += 1


parent_fill.launches = 0


# -- K7: seed the affected cone ----------------------------------------------

def cone_seed_heads(n_cap: int, swm_new, rwm_new, deltas, res_rows,
                    res_nbr, root, s_dirty_idx, s_dirty_old, r_dirty_idx,
                    r_dirty_old, has_res):
    """Each dirty entry's (head int64 [M], source int64 [M], increased
    bool [M]), the shift entries then the residual ones: the head node
    of its edge, or n_cap for a pad (dropped); the edge's source; and
    whether its root-masked weight increased. K7 computes them once per
    entry, and every lane shares them."""
    s_cap = swm_new.shape[0]
    ok_s = (s_dirty_idx >= 0) & (s_dirty_idx < s_cap * n_cap)
    sic = s_dirty_idx.clamp(0, s_cap * n_cap - 1).long()
    k_j = sic // n_cap
    u_j = sic % n_cap
    # root-masked values: root-column churn is invisible to both solves
    new_m = swm_new.reshape(-1)[sic]
    old_m = torch.where(u_j == root, INF_E, s_dirty_old)
    inc_s = ok_s & (new_m > old_m)
    v_j = (u_j + deltas.long()[k_j]) % n_cap  # class edge u -> u + δ_k
    heads, srcs, inc = [torch.where(ok_s, v_j, n_cap)], [u_j], [inc_s]
    if has_res:
        kr = res_nbr.shape[1]
        lim = res_rows.shape[0] * kr
        ok_r = (r_dirty_idx >= 0) & (r_dirty_idx < lim)
        ric = r_dirty_idx.clamp(0, lim - 1).long()
        row_j = ric // kr
        c_j = ric % kr
        ru = res_nbr[row_j, c_j]
        rv = res_rows[row_j]
        new_mr = rwm_new[row_j, c_j]
        old_mr = torch.where(ru == root, INF_E, r_dirty_old)
        inc_r = ok_r & (new_mr > old_mr) & (ru >= 0) & (rv >= 0)
        heads.append(torch.where(ok_r & (rv >= 0), rv.long(), n_cap))
        srcs.append(ru.long())
        inc.append(inc_r)
    return torch.cat(heads), torch.cat(srcs), torch.cat(inc)


def cone_seed_entries(par, swm_new, rwm_new, deltas, res_rows, res_nbr,
                      root, s_dirty_idx, s_dirty_old, r_dirty_idx,
                      r_dirty_old, has_res):
    """The scatter that seeds the cone, as (heads int64 [D, M], seeds
    int32 [D, M]) over the M dirty entries: each entry's head node, or
    n_cap for a pad (dropped), and 1 in the lanes where the increased
    edge is the head's forest edge (``par[d, head] == source``)."""
    d_cap, n_cap = par.shape
    heads, srcs, inc = cone_seed_heads(
        n_cap, swm_new, rwm_new, deltas, res_rows, res_nbr, root,
        s_dirty_idx, s_dirty_old, r_dirty_idx, r_dirty_old, has_res,
    )
    forest = par[:, heads.clamp(max=n_cap - 1)] == srcs[None, :]
    seeds = (inc[None, :] & forest).to(torch.int32)
    return heads[None].expand(d_cap, -1), seeds


def cone_seed_plain(par, swm_new, rwm_new, deltas, res_rows, res_nbr, root,
                    s_dirty_idx, s_dirty_old, r_dirty_idx, r_dirty_old,
                    has_res):
    heads, seeds = cone_seed_entries(
        par, swm_new, rwm_new, deltas, res_rows, res_nbr, root,
        s_dirty_idx, s_dirty_old, r_dirty_idx, r_dirty_old, has_res,
    )
    d_cap, n_cap = par.shape
    # the whole plane written: zeros, then the seeds max-ed in; one
    # spare column takes the dropped pads
    aff = torch.zeros((d_cap, n_cap + 1), dtype=torch.int32,
                      device=par.device)
    aff.scatter_reduce_(1, heads, seeds, "amax")
    return aff[:, :n_cap].contiguous()


def cone_seed(par, swm_new, rwm_new, deltas, res_rows, res_nbr, root,
              s_dirty_idx, s_dirty_old, r_dirty_idx, r_dirty_old, has_res):
    """-> aff int32 [D, N]: 1 at the head v of every dirty edge u -> v
    whose root-masked weight increased and that is a forest edge
    (``par[d, v] == u``), else 0. ``swm_new`` / ``rwm_new`` are the
    root-masked new weights; a dirty slot's old value counts as INF_E
    when its source is the root. Residual slots map flat -> (row,
    col); their source is ``res_nbr[row, col]``, their head
    ``res_rows[row]``. One launch writes the whole plane (no separate
    fill)."""
    if _is_cpu(par):
        return cone_seed_plain(par, swm_new, rwm_new, deltas, res_rows,
                               res_nbr, root, s_dirty_idx, s_dirty_old,
                               r_dirty_idx, r_dirty_old, has_res)
    aff = _launch_seed(par, swm_new, None, rwm_new, deltas, res_rows,
                       res_nbr, root, s_dirty_idx, s_dirty_old, r_dirty_idx,
                       r_dirty_old, has_res, swm_new.shape[0])
    cone_seed.launches += 1
    return aff


cone_seed.launches = 0


def _launch_seed(par, swm_new, new_m, rwm_new, deltas, res_rows, res_nbr,
                 root, s_dirty_idx, s_dirty_old, r_dirty_idx, r_dirty_old,
                 has_res, s_cap: int):
    """Launch K7 into a fresh plane that the kernel writes whole; the
    shift slots' new weights from ``swm_new`` or, when it is None, from
    ``new_m`` (K7 [mc])."""
    d_cap, n_cap = par.shape
    r_cap, kr_cap = res_nbr.shape
    _check_len(d_cap * n_cap)
    aff = torch.empty_like(par)
    if not has_res:
        rwm_new = res_rows = res_nbr = r_dirty_idx = r_dirty_old = None
    cuda.launch("incremental", "cone_seed", "ttttttttttttiiiiiiii",
                par, swm_new, new_m, deltas, s_dirty_idx, s_dirty_old,
                rwm_new, res_rows, res_nbr, r_dirty_idx, r_dirty_old, aff,
                int(root), s_cap, n_cap, d_cap, s_dirty_idx.numel(), r_cap,
                kr_cap, 0 if r_dirty_idx is None else r_dirty_idx.numel())
    return aff


# -- K7 [mc]: the owning shard's new weights, then the seeds ------------------

def owned_weights_plain(swm_new, s_dirty_idx, n_cap: int, col0: int):
    s_cap, w_cols = swm_new.shape
    f = s_dirty_idx.long()
    c = torch.remainder(f, n_cap) - col0
    ok = (f >= 0) & (f < s_cap * n_cap) & (c >= 0) & (c < w_cols)
    k = torch.div(f, n_cap, rounding_mode="floor")
    flat = torch.where(ok, k * w_cols + c, 0)
    return torch.where(ok, swm_new.reshape(-1)[flat], INF_E).to(torch.int32)


def owned_weights(swm_new, s_dirty_idx, n_cap: int, col0: int):
    """K7 [mc], gather: int32 [n_s], the root-masked new weight of each
    dirty shift slot (a flat index into the global [s_cap, n_cap] plane)
    whose source column the shard owns (``swm_new`` [s_cap, w] holds the
    columns [col0, col0 + w)), INF_E for the others and for pads. The
    group's min over its members is the owning shard's value
    (``parallel/sharding.py``, :575-580)."""
    if _is_cpu(swm_new):
        return owned_weights_plain(swm_new, s_dirty_idx, n_cap, col0)
    n_s = s_dirty_idx.numel()
    out = torch.empty(n_s, dtype=torch.int32, device=swm_new.device)
    if n_s == 0:
        return out
    s_cap, w_cols = swm_new.shape
    cuda.launch("incremental", "owned_weights", "tttiiiii", swm_new,
                s_dirty_idx, out, n_s, s_cap, n_cap, col0, w_cols)
    owned_weights.launches += 1
    return out


owned_weights.launches = 0


def cone_seed_mc_plain(par, new_m, rwm_new, deltas, res_rows, res_nbr,
                       root, s_dirty_idx, s_dirty_old, r_dirty_idx,
                       r_dirty_old, has_res, s_cap: int):
    d_cap, n_cap = par.shape
    # the seeds read the shift slots' new weights from new_m: a plane
    # holding them at their flat indices stands in for the whole one
    f = s_dirty_idx.long()
    ok = (f >= 0) & (f < s_cap * n_cap)
    whole = torch.full((s_cap * n_cap,), INF_E, dtype=torch.int32,
                       device=par.device)
    whole[f[ok]] = new_m[ok]
    return cone_seed_plain(par, whole.view(s_cap, n_cap), rwm_new, deltas,
                           res_rows, res_nbr, root, s_dirty_idx, s_dirty_old,
                           r_dirty_idx, r_dirty_old, has_res)


def cone_seed_mc(par, new_m, rwm_new, deltas, res_rows, res_nbr, root,
                 s_dirty_idx, s_dirty_old, r_dirty_idx, r_dirty_old,
                 has_res, s_cap: int):
    """K7 [mc]: ``cone_seed`` with the dirty shift slots' root-masked new
    weights given as ``new_m`` [n_s] (the group's min of its members'
    ``owned_weights``) instead of read from a whole plane; the residual
    slots as ``cone_seed`` (the residual is whole on every shard)."""
    if _is_cpu(par):
        return cone_seed_mc_plain(par, new_m, rwm_new, deltas, res_rows,
                                  res_nbr, root, s_dirty_idx, s_dirty_old,
                                  r_dirty_idx, r_dirty_old, has_res, s_cap)
    aff = _launch_seed(par, None, new_m, rwm_new, deltas, res_rows, res_nbr,
                       root, s_dirty_idx, s_dirty_old, r_dirty_idx,
                       r_dirty_old, has_res, s_cap)
    cone_seed_mc.launches += 1
    return aff


cone_seed_mc.launches = 0


# -- K8 + K9: the cone's closure, its size, the fallback and the seed -----------

def cone_step_plain(par, src, dst, flag) -> None:
    """One Jacobi step of the spread: dst[d, v] = max(src[d, v],
    src[d, par[d, v]]) (src alone where par is -1); ORs 1 into ``flag``
    when a word changed. One step moves the cone one forest level down."""
    up = torch.gather(src, 1, par.clamp(min=0).long())
    new = torch.where(par >= 0, torch.maximum(src, up), src)
    flag |= (new != src).any().to(torch.int32)
    dst.copy_(new)


def cone_finish_plain(aff, prev_dist, dist0, seeds_nbr, seeds_w,
                      cone_limit: int, cone=None):
    d_cap, n_cap = aff.shape
    if cone is None:
        cone = aff.sum(dtype=torch.int32)
    fell_back = cone > cone_limit
    warm = torch.where(aff > 0, INF_E, prev_dist)
    lanes = torch.arange(d_cap, device=aff.device)
    seed = seeds_nbr.clamp(0, n_cap - 1).long()
    pin = torch.where(seeds_w < INF_E, 0, INF_E).to(torch.int32)
    warm[lanes, seed] = torch.minimum(warm[lanes, seed], pin)
    plane = torch.where(fell_back, dist0, warm)
    tail = torch.stack([cone, fell_back.to(torch.int32)])
    return plane, tail


def cone_resolve_plain(par, aff, prev_dist=None, dist0=None, seeds_nbr=None,
                       seeds_w=None, cone_limit: int = 0,
                       max_trips: int = 0):
    # the spec: Jacobi steps to the first one that changes nothing, at
    # most max_trips * UNROLL of them, then K9
    spare = torch.empty_like(aff)
    flag = torch.zeros(1, dtype=torch.int32, device=aff.device)
    src, dst = aff, spare
    sweeps = 0
    while sweeps < max_trips * UNROLL:
        flag.zero_()
        cone_step_plain(par, src, dst, flag)
        src, dst = dst, src
        sweeps += 1
        if not int(flag):
            break
    if src is not aff:
        aff.copy_(src)
    cone = aff.sum(dtype=torch.int32)
    count = torch.tensor(sweeps, dtype=torch.int32, device=aff.device)
    if prev_dist is None:
        return None, torch.stack([cone, torch.zeros_like(cone), count])
    plane, tail = cone_finish_plain(aff, prev_dist, dist0, seeds_nbr,
                                    seeds_w, cone_limit, cone)
    return plane, torch.cat([tail, count[None]])


def cone_resolve(par, aff, prev_dist=None, dist0=None, seeds_nbr=None,
                 seeds_w=None, cone_limit: int = 0, max_trips: int = 0):
    """The seeded cone ``aff`` int32 [D, N] (0/1, K7) spread in place down
    the parent forest ``par`` to its closure (every forest descendant of
    a seed), in at most ``max_trips * UNROLL`` sweeps; then the
    reference's count, fallback decision and seed plane (``cone_finish``)
    from it. -> (seed plane int32 [D, N], tail int32 [3] = [cone,
    fell_back, sweeps]), all decided on the device.

    With ``prev_dist`` None (the tier's members) there is no plane: ->
    (None, [cone, 0, sweeps]). The closure and the tail's first two
    words are the reference's; ``sweeps`` (stats only, not in the
    payload) counts the passes to the first that changed nothing: the
    plain version's Jacobi steps, the kernel's in-place sweeps (sweep s
    follows up to min(2^s, 16) ancestors of a word it finds unmarked:
    ``CONE_HOPS`` in ``csrc/incremental.cu``).
    On the card: one cooperative launch of ``cone_fix``, no host read
    and no fill."""
    if _is_cpu(par):
        return cone_resolve_plain(par, aff, prev_dist, dist0, seeds_nbr,
                                  seeds_w, cone_limit, max_trips)
    d_cap, n_cap = par.shape
    _check_len(d_cap * n_cap)
    if aff.shape != par.shape or n_cap & (n_cap - 1):
        raise ValueError("cone_resolve: aff must match par, n_cap a power "
                         "of two")
    tail = torch.empty(6, dtype=torch.int32, device=par.device)
    plane = None if prev_dist is None else torch.empty_like(prev_dist)
    cuda.launch("incremental", "cone_fix", "ttttttttiiii", par, aff,
                prev_dist, dist0, seeds_nbr, seeds_w, tail, plane,
                int(cone_limit), d_cap, n_cap, int(max_trips) * UNROLL)
    cone_resolve.launches += 1
    return plane, tail[:3]


cone_resolve.launches = 0


def cone_finish(aff, prev_dist, dist0, seeds_nbr, seeds_w, cone_limit: int,
                tail=None):
    """-> (seed plane int32 [D, N], tail int32 [2] = [cone, fell_back]).
    cone = sum(aff) in node-lanes; fell_back = cone > cone_limit,
    decided on the device. The seed is ``prev_dist`` with the cone set
    to INF_E and the root out-neighbour pins min-ed in, or — when it
    fell back — K1s's cold seed ``dist0`` itself, byte for byte.

    ``tail``, when given, is an int32 [2] tensor whose ``tail[0]``
    already holds the cone (the multichip tier sums its batch groups'
    counts, ``parallel/sharding.py``, :652-655): only the seed plane is
    written then, and ``tail[1]``. On the card the tail must be given
    (one ``cone_plane`` launch); ``cone_resolve`` counts and writes the
    plane of the one-card solve in its own launch."""
    if _is_cpu(aff):
        plane, t = cone_finish_plain(aff, prev_dist, dist0, seeds_nbr,
                                     seeds_w, cone_limit,
                                     None if tail is None else tail[0])
        if tail is None:
            return plane, t
        tail.copy_(t)
        return plane, tail
    if tail is None:
        raise ValueError("cone_finish: give the counted tail on the card "
                         "(cone_resolve counts)")
    d_cap, n_cap = aff.shape
    plane = torch.empty_like(prev_dist)
    cuda.launch("incremental", "cone_plane", "tttttttiii", aff, prev_dist,
                dist0, seeds_nbr, seeds_w, tail, plane, int(cone_limit),
                d_cap, n_cap)
    cone_finish.launches += 1
    return plane, tail


cone_finish.launches = 0


# -- the incremental solve ----------------------------------------------------

def incremental_sssp(deltas, shift_w, res_rows, res_nbr, res_w, root,
                     seeds_nbr, seeds_w, prev_dist,
                     s_dirty_idx, s_dirty_old,
                     r_dirty_idx, r_dirty_old, cone_limit,
                     s_cap: int, has_res: bool, n_cap: int, d_cap: int,
                     max_trips: int, kernel: str = "sync",
                     delta_exp: int = 0, *, mark=None, stats=None,
                     init_out=None, par_out=None):
    """Incremental counterpart of ``relax.plan_sssp``: the same resident
    inputs plus ``prev_dist`` [D, N] (the vantage's last distance
    plane), the consolidated dirty tuples (flat index into the raveled
    shift / residual weight plane and each slot's pre-drain value; pads
    are out-of-range indices) and ``cone_limit`` (the cone budget in
    node-lanes). ``kernel`` picks the relaxation loop. Returns ``(dist
    [D, N], trips, cone, fell_back, rounds)``; cone and fell_back are
    int32 0-d tensors on the device (they ride the pull buffers).

    ``mark``, when given, is called after the old planes, the parent
    plane and the seed plane are queued (phase boundaries for CUDA
    events); ``stats``, when a dict, receives ``cone_trips``: the sweeps
    of the cone's closure (``cone_resolve``), an int32 0-d tensor on
    the device, to be read once the solve's results are pulled.

    ``init_out``, when given, is K1s's outputs held by the caller
    (``relax.init_outputs``), written in place: none of them is the
    returned plane, which is the cone's fresh seed plane or the loop's
    spare, so the caller may hold them across solves beside its
    ``prev_dist``; ``par_out``, when given, is the parent plane held by
    the caller (``parent_plane(out=)``), read only inside this solve."""
    mark = mark or (lambda: None)
    swm_new, residual, dist0 = sssp_init(
        shift_w, res_rows, res_nbr, res_w, root, seeds_nbr, seeds_w,
        init_out,
    )
    swm_old, rwm_old = old_planes(
        shift_w, res_w, s_dirty_idx, s_dirty_old, r_dirty_idx,
        r_dirty_old, has_res, int(root), res_nbr,
    )
    mark()
    par = parent_plane(deltas, swm_old, res_rows, res_nbr, rwm_old,
                       prev_dist, s_cap, has_res, n_cap, d_cap, par_out)
    mark()
    aff = cone_seed(par, swm_new, residual[2], deltas, res_rows, res_nbr,
                    root, s_dirty_idx, s_dirty_old, r_dirty_idx,
                    r_dirty_old, has_res)
    seed, tail = cone_resolve(par, aff, prev_dist, dist0, seeds_nbr,
                              seeds_w, int(cone_limit), max_trips)
    mark()
    if stats is not None:
        stats["cone_trips"] = tail[2]
    dist, trips, rounds = solve_from(
        deltas, swm_new, residual if has_res else None, seed, kernel,
        delta_exp, max_trips,
    )
    return dist, trips, tail[0], tail[1], rounds
