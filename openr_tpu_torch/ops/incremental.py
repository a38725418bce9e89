"""Incremental SSSP for the churn solve: seed from the vantage's previous
distance plane and re-anchor only the affected cone behind metric
increases (counterpart of the JAX package's ``ops/incremental.py``).

Relaxation over non-negative int32 weights with the root-neighbour
seeds pinned to 0 has a unique fixpoint, reached from ANY pointwise
over-estimate of the true distances. After a decrease the previous
plane already is one; after an increase it under-estimates exactly on
the nodes whose old shortest-path chain crosses an increased edge. So:

  1. ``old_planes`` rebuilds the pre-churn weight planes from the new
     resident planes and the dirty slots' pre-drain values (K5 into a
     copy), and K1s's root mask is applied to both;
  2. ``parent_plane`` (K6) picks one old shortest-path parent per
     (lane, node) — the parent forest;
  3. ``cone_seed`` (K7) marks the head of every increased dirty edge
     that is a forest edge, and ``cone_step`` (K8) spreads the marks
     down the forest to the fixpoint in a host loop (one flag read per
     trip of ``UNROLL`` steps, at most ``max_trips(n_cap)`` trips);
  4. ``cone_finish`` (K9) counts the cone, decides ``fell_back = cone >
     cone_limit`` on the device, and writes the seed plane: the previous
     plane with the cone set to INF_E, or K1s's cold seed when it fell
     back, with the root out-neighbour pins min-ed in;
  5. the shared relaxation loops of ``ops/relax.py`` run to the
     fixpoint from that seed, so the result is bit-identical to the
     cold solve and trips / rounds equal the JAX loops' from the same
     seed.

Zero-weight edges would let equal-distance parent cycles hide from the
cone; the solver gates the incremental path off on any plan with
``has_zero_w``, so every parent chain strictly decreases the previous
distance and the parent plane is a forest.

Wrappers (``scatter_set``, ``parent_plane``, ``cone_seed``,
``cone_step``, ``cone_finish``) launch their CUDA kernel
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
    _int32,
    _is_cpu,
    run_sync,
    solve_from,
    sssp_init,
)


def _check_len(n: int) -> None:
    if n >= 1 << 31:
        raise ValueError("kernel index space exceeds int32")


# -- K5: flat scatter into a resident plane ----------------------------------

def scatter_set_plain(plane, idx, vals) -> None:
    flat = plane.view(-1)
    ok = (idx >= 0) & (idx < flat.numel())
    live = idx[ok].long()
    if torch.unique(live).numel() != live.numel():
        raise ValueError("scatter_set: in-range indices must be unique")
    flat[live] = vals[ok]


def scatter_set(plane, idx, vals) -> None:
    """In place: ``plane.ravel()[idx[i]] = vals[i]`` for every ``i`` with
    ``idx[i]`` in ``[0, plane.numel())``; other entries are pads and
    drop. The in-range indices must be unique (the dirty lists are
    consolidated, ``ops/edgeplan._consolidate``): the plain version
    raises on a duplicate, the kernel cannot order one."""
    if _is_cpu(plane):
        scatter_set_plain(plane, idx, vals)
        return
    _int32(plane, idx, vals)
    n = idx.numel()
    if n != vals.numel():
        raise ValueError("scatter_set: idx and vals differ in length")
    if n == 0:
        return
    _check_len(plane.numel())
    p = cuda.ptr
    cuda.launch("incremental", "scatter_set", "pppii",
                p(plane), p(idx), p(vals), n, plane.numel())
    scatter_set.launches += 1


scatter_set.launches = 0


def old_planes(shift_w, res_w, s_dirty_idx, s_dirty_old, r_dirty_idx,
               r_dirty_old, has_res):
    """The pre-churn weight planes: copies of the new resident planes
    with each dirty slot's pre-drain value scattered back (K5). Pads
    drop. Without a residual the residual plane passes through."""
    old_shift = shift_w.clone()
    scatter_set(old_shift, s_dirty_idx, s_dirty_old)
    if not has_res:
        return old_shift, res_w
    old_res = res_w.clone()
    scatter_set(old_res, r_dirty_idx, r_dirty_old)
    return old_shift, old_res


# -- K6: the parent forest under the old weights -----------------------------

def _check_unique_rows(res_rows) -> None:
    rows = res_rows[res_rows >= 0]
    if torch.unique(rows).numel() != rows.numel():
        raise ValueError("parent_plane: residual rows must be unique per node")


def parent_plane_plain(deltas, swm_old, res_rows, res_nbr, rwm_old,
                       prev_dist, s_cap, has_res, n_cap, d_cap):
    dev = prev_dist.device
    par = torch.full((d_cap, n_cap), -1, dtype=torch.int32, device=dev)
    src = torch.arange(n_cap, dtype=torch.int32, device=dev)
    live = prev_dist < INF_E
    for k, dk in enumerate(deltas.tolist()[:s_cap]):
        wk = swm_old[k]
        cand = prev_dist + wk[None, :]
        tgt = torch.roll(prev_dist, -dk, dims=1)  # tgt[:, u] = prev[:, v]
        hit = live & (wk < INF_E)[None, :] & (cand == tgt)
        hit_v = torch.roll(hit, dk, dims=1)  # hit at the child v
        src_v = torch.roll(src, dk)[None, :]  # src_v[v] = u
        par = torch.where((par < 0) & hit_v, src_v, par)
    if has_res:
        _check_unique_rows(res_rows)
        nbr_c = res_nbr.clamp(0, n_cap - 1).long()
        rows_c = res_rows.clamp(0, n_cap - 1).long()
        row_valid = res_rows >= 0
        prev_n = prev_dist[:, nbr_c]  # [D, R, K]
        cand = prev_n + rwm_old[None]
        tgt = prev_dist[:, rows_c][:, :, None]
        hit = (
            (prev_n < INF_E)
            & (rwm_old < INF_E)[None]
            & (cand == tgt)
            & (res_nbr >= 0)[None]
        )
        has = hit.any(dim=2)
        first = hit.to(torch.int32).argmax(dim=2)  # first tight slot
        pick = torch.gather(
            res_nbr[None].expand(d_cap, -1, -1), 2, first[:, :, None]
        )[:, :, 0]
        cur = par[:, rows_c]
        new = torch.where((cur < 0) & has & row_valid[None], pick, cur)
        # pad rows drop: they are never clipped onto node 0's row
        par[:, res_rows[row_valid].long()] = new[:, row_valid]
    return par


def parent_plane(deltas, swm_old, res_rows, res_nbr, rwm_old, prev_dist,
                 s_cap, has_res, n_cap, d_cap):
    """-> par int32 [D, N]: ``par[d, v] = u`` for an edge u -> v with
    ``prev[d, u] + w_old(u -> v) == prev[d, v]`` (both finite), else -1.
    Shift classes are tried in order and the lowest class wins; the
    residual fills only nodes still at -1, the first tight slot of the
    node's row winning. ``swm_old`` / ``rwm_old`` are the root-masked
    old weights. Residual rows must be unique per node."""
    if _is_cpu(prev_dist):
        return parent_plane_plain(deltas, swm_old, res_rows, res_nbr,
                                  rwm_old, prev_dist, s_cap, has_res,
                                  n_cap, d_cap)
    _int32(deltas, swm_old, prev_dist)
    _check_len(d_cap * n_cap)
    par = torch.empty((d_cap, n_cap), dtype=torch.int32,
                      device=prev_dist.device)
    p = cuda.ptr
    cuda.launch("incremental", "parent_shift", "ppppiii",
                p(deltas), p(swm_old), p(prev_dist), p(par), s_cap, n_cap,
                d_cap)
    parent_plane.launches += 1
    if has_res:
        _int32(res_rows, res_nbr, rwm_old)
        r_cap, kr_cap = res_nbr.shape
        cuda.launch("incremental", "parent_residual", "pppppiiii",
                    p(res_rows), p(res_nbr), p(rwm_old), p(prev_dist),
                    p(par), r_cap, kr_cap, n_cap, d_cap)
        parent_plane.launches += 1
    return par


parent_plane.launches = 0


# -- K7: seed the affected cone ----------------------------------------------

def cone_seed_entries(par, swm_new, rwm_new, deltas, res_rows, res_nbr,
                      root, s_dirty_idx, s_dirty_old, r_dirty_idx,
                      r_dirty_old, has_res):
    """The scatter that seeds the cone, as (heads int64 [D, M], seeds
    int32 [D, M]) over the M dirty entries: each entry's head node, or
    n_cap for a pad (dropped), and 1 where it seeds. ``cone_seed_plain``
    scatter-maxes them into a zero plane."""
    d_cap, n_cap = par.shape
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
    seeds = [(inc_s[None, :] & (par[:, v_j] == u_j[None, :]))]
    heads = [torch.where(ok_s, v_j, n_cap)]
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
        pv_r = par[:, rv.clamp(0, n_cap - 1).long()]
        seeds.append(inc_r[None, :] & (pv_r == ru[None, :]))
        heads.append(torch.where(ok_r & (rv >= 0), rv.long(), n_cap))
    seeds = torch.cat(seeds, dim=1).to(torch.int32)
    heads = torch.cat(heads)[None].expand(d_cap, -1)
    return heads, seeds


def cone_seed_plain(par, swm_new, rwm_new, deltas, res_rows, res_nbr, root,
                    s_dirty_idx, s_dirty_old, r_dirty_idx, r_dirty_old,
                    has_res):
    heads, seeds = cone_seed_entries(
        par, swm_new, rwm_new, deltas, res_rows, res_nbr, root,
        s_dirty_idx, s_dirty_old, r_dirty_idx, r_dirty_old, has_res,
    )
    d_cap, n_cap = par.shape
    # one spare column takes the dropped pads
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
    ``res_rows[row]``."""
    if _is_cpu(par):
        return cone_seed_plain(par, swm_new, rwm_new, deltas, res_rows,
                               res_nbr, root, s_dirty_idx, s_dirty_old,
                               r_dirty_idx, r_dirty_old, has_res)
    _int32(par, swm_new, deltas, s_dirty_idx, s_dirty_old)
    d_cap, n_cap = par.shape
    s_cap = swm_new.shape[0]
    r_cap, kr_cap = res_nbr.shape
    n_r = 0
    if has_res:
        _int32(rwm_new, res_rows, res_nbr, r_dirty_idx, r_dirty_old)
        n_r = r_dirty_idx.numel()
    n_s = s_dirty_idx.numel()
    _check_len(d_cap * (n_s + n_r))
    # allocation: the seed kernel only ever writes ones
    aff = torch.zeros((d_cap, n_cap), dtype=torch.int32, device=par.device)
    p = cuda.ptr
    r_args = (p(rwm_new), p(res_rows), p(res_nbr), p(r_dirty_idx),
              p(r_dirty_old)) if has_res else (0, 0, 0, 0, 0)
    cuda.launch("incremental", "cone_seed", "pppppppppppiiiiiiii",
                p(par), p(swm_new), p(deltas), p(s_dirty_idx),
                p(s_dirty_old), *r_args, p(aff), int(root), s_cap, n_cap,
                d_cap, n_s, r_cap, kr_cap, n_r)
    cone_seed.launches += 1
    return aff


cone_seed.launches = 0


# -- K8: one step of the cone spread -----------------------------------------

def cone_step_plain(par, src, dst, flag) -> None:
    up = torch.gather(src, 1, par.clamp(min=0).long())
    new = torch.where(par >= 0, torch.maximum(src, up), src)
    flag |= (new != src).any().to(torch.int32)
    dst.copy_(new)


def cone_step(par, src, dst, flag) -> None:
    """dst[d, v] = max(src[d, v], src[d, par[d, v]]) (src alone where
    par is -1), read from ``src`` only (Jacobi — ``dst`` is another
    buffer); ORs 1 into ``flag`` when a word changed. One step moves the
    cone one forest level down; the closure it reaches is the JAX
    loop's, whose Gauss-Seidel order reaches it in fewer steps (the step
    count is not in the payload)."""
    if _is_cpu(par):
        cone_step_plain(par, src, dst, flag)
        return
    _int32(par, src, dst, flag)
    d_cap, n_cap = par.shape
    p = cuda.ptr
    cuda.launch("incremental", "cone_step", "ppppii",
                p(par), p(src), p(dst), p(flag), d_cap, n_cap)
    cone_step.launches += 1


cone_step.launches = 0


def cone_spread(par, aff, max_trips: int):
    """Spread the seeded cone ``aff`` down the forest to the fixpoint:
    ``UNROLL`` K8 steps per trip, one flag read per trip, at most
    ``max_trips`` trips (a forest is at most n_cap levels deep, so the
    bound never cuts a spread short). ``aff`` is consumed as scratch.
    Returns ``(aff, trips)``."""

    def step(src, dst, flag):
        cone_step(par, src, dst, flag)

    aff, trips, _ = run_sync(step, aff, max_trips)
    return aff, trips


# -- K9: cone size, fallback decision, seed plane ----------------------------

def cone_finish_plain(aff, prev_dist, dist0, seeds_nbr, seeds_w,
                      cone_limit: int):
    d_cap, n_cap = aff.shape
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


def cone_finish(aff, prev_dist, dist0, seeds_nbr, seeds_w, cone_limit: int):
    """-> (seed plane int32 [D, N], tail int32 [2] = [cone, fell_back]).
    cone = sum(aff) in node-lanes; fell_back = cone > cone_limit,
    decided on the device. The seed is ``prev_dist`` with the cone set
    to INF_E and the root out-neighbour pins min-ed in, or — when it
    fell back — K1s's cold seed ``dist0`` itself, byte for byte."""
    if _is_cpu(aff):
        return cone_finish_plain(aff, prev_dist, dist0, seeds_nbr, seeds_w,
                                 cone_limit)
    _int32(aff, prev_dist, dist0, seeds_nbr, seeds_w)
    d_cap, n_cap = aff.shape
    dev = aff.device
    # allocation: the count kernel accumulates into tail[0]
    tail = torch.zeros(2, dtype=torch.int32, device=dev)
    plane = torch.empty_like(prev_dist)
    p = cuda.ptr
    cuda.launch("incremental", "cone_count", "ppi",
                p(aff), p(tail), d_cap * n_cap)
    cuda.launch("incremental", "cone_plane", "pppppppiii",
                p(aff), p(prev_dist), p(dist0), p(seeds_nbr), p(seeds_w),
                p(tail), p(plane), int(cone_limit), d_cap, n_cap)
    cone_finish.launches += 2
    return plane, tail


cone_finish.launches = 0


# -- the incremental solve ----------------------------------------------------

def incremental_sssp(deltas, shift_w, res_rows, res_nbr, res_w, root,
                     seeds_nbr, seeds_w, prev_dist,
                     s_dirty_idx, s_dirty_old,
                     r_dirty_idx, r_dirty_old, cone_limit,
                     s_cap: int, has_res: bool, n_cap: int, d_cap: int,
                     max_trips: int, kernel: str = "sync",
                     delta_exp: int = 0, *, mark=None, stats=None):
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
    events); ``stats``, when a dict, receives ``cone_trips``, the trips
    of the cone spread."""
    mark = mark or (lambda: None)
    swm_new, residual, dist0 = sssp_init(
        shift_w, res_rows, res_nbr, res_w, root, seeds_nbr, seeds_w
    )
    old_shift, old_res = old_planes(
        shift_w, res_w, s_dirty_idx, s_dirty_old, r_dirty_idx,
        r_dirty_old, has_res,
    )
    # K1s's root mask on the old planes (its seed plane goes unused)
    swm_old, (_, _, rwm_old), _ = sssp_init(
        old_shift, res_rows, res_nbr, old_res, root, seeds_nbr, seeds_w
    )
    mark()
    par = parent_plane(deltas, swm_old, res_rows, res_nbr, rwm_old,
                       prev_dist, s_cap, has_res, n_cap, d_cap)
    mark()
    aff = cone_seed(par, swm_new, residual[2], deltas, res_rows, res_nbr,
                    root, s_dirty_idx, s_dirty_old, r_dirty_idx,
                    r_dirty_old, has_res)
    aff, cone_trips = cone_spread(par, aff, max_trips)
    seed, tail = cone_finish(aff, prev_dist, dist0, seeds_nbr, seeds_w,
                             int(cone_limit))
    mark()
    if stats is not None:
        stats["cone_trips"] = cone_trips
    dist, trips, rounds = solve_from(
        deltas, swm_new, residual if has_res else None, seed, kernel,
        delta_exp, max_trips,
    )
    return dist, trips, tail[0], tail[1], rounds
