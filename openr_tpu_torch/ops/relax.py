"""SSSP relaxation for the cold Decision solve: the round loops, their
kernels (``csrc/relax.cu``) and each kernel's plain PyTorch version.

Two loops reach the same exact int32 fixpoint:

- ``run_sync``: synchronous Jacobi rounds, ``UNROLL`` relaxations per
  trip, exit on the first trip that changes nothing.
- ``run_bucketed``: bucketed Δ-stepping. Each epoch settles the light
  frontier with a rung-doubling ladder over the ``LADDER_WIDTH`` most
  populous light shift classes, then hands off across buckets with one
  full relaxation; the loop exits on an epoch that changes nothing.

Relaxation over non-negative int32 weights is a monotone min-plus
fixpoint, so a step changed something iff some word decreased: every
kernel ORs a device change flag, and the host reads it once per trip /
ladder pass / epoch. The trip and round counts match the JAX loops
exactly (they ride the pull buffers' tails).

Wrappers (``sssp_init``, ``relax_step``, ``ladder_classes``,
``ladder_apply``, ``ladder_rung``) launch their CUDA kernel on a CUDA
tensor and run the plain version (``*_plain``) only on a CPU tensor.
Each counts its kernel launches in ``<wrapper>.launches``.

INF discipline (ops/edgeplan.py): weights <= 2^28, INF_E = 2^29, so
``dist + w <= 2^30`` and a rung composition ``w + w`` peaks at 2^30
before its clip back to INF_E — int32-exact everywhere.
"""

from __future__ import annotations

import numpy as np
import torch

from openr_tpu_torch.ops import cuda

# effectively-infinite metric, same discipline as ops/edgeplan.INF32E
INF_E = 1 << 29

# relaxations per trip of the synchronous loop (trip counts stay
# comparable with the JAX package's, which fuses this many per trip)
UNROLL = 8

# at most this many light shift classes ride the ladder; the rung
# doubles at most ladder_depth(n_cap) times per epoch
LADDER_WIDTH = 8
_LADDER_DEPTH_MAX = 16


def max_trips(n_cap: int) -> int:
    """Worst-case trips for a synchronous solve: the longest shortest
    path visits <= n_cap nodes, +2 trips of slack for the no-change
    exit."""
    return max(2, -(-n_cap // UNROLL) + 2)


def ladder_depth(n_cap: int) -> int:
    """Rung-doubling bound: 2^depth >= n_cap covers the longest light
    chain; capped so the rung planes stay small."""
    d = 1
    while (1 << d) < max(n_cap, 2):
        d += 1
    return max(4, min(d + 1, _LADDER_DEPTH_MAX))


def derive_delta_exp(deltas, shift_w) -> int:
    """Δ = 2^exp, the pow2 ceiling of the ~p75 finite shift-class
    weight, so ~3/4 of the shift edges classify light. 0 when the plan
    has no usable shift classes: the caller then runs the sync loop."""
    d = np.asarray(deltas)
    if d.size == 0 or not bool(np.any(d != 0)):
        return 0
    w = np.asarray(shift_w)
    finite = w[w < INF_E]
    if finite.size == 0:
        return 0
    p75 = max(int(np.percentile(finite, 75)), 1)
    e = 1
    while (1 << e) < p75:
        e += 1
    return min(e, 28)


def _is_cpu(t: torch.Tensor) -> bool:
    """True on a CPU tensor (plain version), False on a CUDA tensor
    (kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _int32(*ts) -> None:
    for t in ts:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("expected contiguous int32 tensors")


# -- K1s: root masking + seed plane ----------------------------------------

def sssp_init_plain(shift_w, res_rows, res_nbr, res_w, root: int,
                    seeds_nbr, seeds_w):
    n_cap = shift_w.shape[1]
    sw = shift_w.clone()
    sw[:, root] = INF_E
    rw = torch.where(res_nbr == root, INF_E, res_w)
    nbr_c = res_nbr.clamp(0, n_cap - 1)
    rows_c = res_rows.clamp(0, n_cap - 1)
    d_cap = seeds_nbr.shape[0]
    dist0 = torch.full((d_cap, n_cap), INF_E, dtype=torch.int32,
                       device=shift_w.device)
    seed = seeds_nbr.clamp(0, n_cap - 1).long()
    lanes = torch.arange(d_cap, device=shift_w.device)
    dist0[lanes, seed] = torch.minimum(
        dist0[lanes, seed],
        torch.where(seeds_w < INF_E, 0, INF_E).to(torch.int32),
    )
    return sw, (rows_c, nbr_c, rw), dist0


def sssp_init(shift_w, res_rows, res_nbr, res_w, root: int, seeds_nbr,
              seeds_w):
    """-> (sw, (rows_c, nbr_c, rw), dist0): the root-masked class
    weights (the root is never a transit node), the clipped and
    root-masked residual ELL, and the [D, n_cap] seed plane (0 at each
    live out-neighbour, INF_E elsewhere)."""
    if _is_cpu(shift_w):
        return sssp_init_plain(shift_w, res_rows, res_nbr, res_w, root,
                               seeds_nbr, seeds_w)
    _int32(shift_w, res_rows, res_nbr, res_w, seeds_nbr, seeds_w)
    s_cap, n_cap = shift_w.shape
    r_cap, kr_cap = res_nbr.shape
    d_cap = seeds_nbr.shape[0]
    sw = torch.empty_like(shift_w)
    rows_c = torch.empty_like(res_rows)
    nbr_c = torch.empty_like(res_nbr)
    rw = torch.empty_like(res_w)
    dist0 = torch.empty((d_cap, n_cap), dtype=torch.int32,
                        device=shift_w.device)
    p = cuda.ptr
    cuda.launch(
        "relax", "sssp_init", "pppppppppppiiiiii",
        p(shift_w), p(sw), p(res_rows), p(res_nbr), p(res_w), p(rows_c),
        p(nbr_c), p(rw), p(seeds_nbr), p(seeds_w), p(dist0),
        s_cap, n_cap, r_cap, kr_cap, d_cap, int(root),
    )
    sssp_init.launches += 1
    return sw, (rows_c, nbr_c, rw), dist0


sssp_init.launches = 0


# -- K1: one Jacobi relaxation ---------------------------------------------

def _roll(x, shift: int):
    return torch.roll(x, shift, dims=-1)


def relax_step_plain(dist, out, flag, deltas, sw, residual) -> None:
    acc = torch.full_like(dist, INF_E)
    for k, dk in enumerate(deltas.tolist()):
        acc = torch.minimum(acc, _roll(dist + sw[k], dk))
    if residual is not None:
        rows_c, nbr_c, rw = residual
        cand = (dist[:, nbr_c.long()] + rw[None]).amin(dim=2)
        acc.scatter_reduce_(
            1, rows_c.long()[None].expand(dist.shape[0], -1), cand,
            reduce="amin",
        )
    new = torch.minimum(acc, dist)
    flag |= (new < dist).any().to(torch.int32)
    out.copy_(new)


def relax_step(dist, out, flag, deltas, sw, residual) -> None:
    """out = min(dist, min_k roll(dist + sw[k], deltas[k]), residual
    scatter-min) computed from ``dist`` alone (Jacobi — ``out`` is a
    different buffer); ORs 1 into ``flag`` when any word decreased.
    ``residual`` is None when the plan has no residual edges."""
    if _is_cpu(dist):
        relax_step_plain(dist, out, flag, deltas, sw, residual)
        return
    _int32(dist, out, flag, deltas, sw)
    d_cap, n_cap = dist.shape
    p = cuda.ptr
    cuda.launch(
        "relax", "relax_shift", "ppppiiip",
        p(dist), p(out), p(deltas), p(sw), d_cap, n_cap, sw.shape[0],
        p(flag),
    )
    relax_step.launches += 1
    if residual is not None:
        rows_c, nbr_c, rw = residual
        _int32(rows_c, nbr_c, rw)
        cuda.launch(
            "relax", "relax_residual", "pppppiiiip",
            p(dist), p(out), p(rows_c), p(nbr_c), p(rw), d_cap, n_cap,
            nbr_c.shape[0], nbr_c.shape[1], p(flag),
        )
        relax_step.launches += 1


relax_step.launches = 0


# -- K2: the Δ-stepping ladder ---------------------------------------------

def ladder_classes_plain(sw, deltas, dq: int, s_lad: int):
    n_cap = sw.shape[1]
    score = (sw <= dq).sum(dim=1, dtype=torch.int32)
    lad = torch.sort(score, descending=True, stable=True).indices[:s_lad]
    w = sw[lad]
    w_base = torch.where(w <= dq, w, INF_E).contiguous()
    d_base = torch.remainder(deltas[lad], n_cap).contiguous()
    return w_base, d_base


def ladder_classes(sw, deltas, dq: int, s_lad: int):
    """-> (w_base [s_lad, n_cap], d_base [s_lad]): the ``s_lad`` shift
    classes with the most light edges (weight <= dq; ties to the lower
    class, as ``lax.top_k``), their weights with heavy edges masked to
    INF_E, and their shifts reduced mod n_cap."""
    if _is_cpu(sw):
        return ladder_classes_plain(sw, deltas, dq, s_lad)
    _int32(sw, deltas)
    s_cap, n_cap = sw.shape
    score = torch.empty(s_cap, dtype=torch.int32, device=sw.device)
    p = cuda.ptr
    cuda.launch("relax", "ladder_score", "ppiii",
                p(sw), p(score), s_cap, n_cap, int(dq))
    ladder_classes.launches += 1
    # the only torch op on the queued path: picking <= 8 of s_cap scores
    lad = torch.sort(score, descending=True, stable=True).indices[:s_lad]
    lad = lad.contiguous()
    w_base = torch.empty((s_lad, n_cap), dtype=torch.int32, device=sw.device)
    d_base = torch.empty(s_lad, dtype=torch.int32, device=sw.device)
    cuda.launch("relax", "ladder_gather", "pppppiii",
                p(sw), p(deltas), p(lad), p(w_base), p(d_base), s_lad,
                n_cap, int(dq))
    ladder_classes.launches += 1
    return w_base, d_base


ladder_classes.launches = 0


def ladder_apply_plain(src, dst, w, d, k: int, flag) -> None:
    new = torch.minimum(src, _roll(src + w[k], int(d[k])))
    flag |= (new < src).any().to(torch.int32)
    dst.copy_(new)


def ladder_apply(src, dst, w, d, k: int, flag) -> None:
    """One class application of a ladder pass: dst = min(src,
    roll(src + w[k], d[k])); ORs ``flag`` on any decrease."""
    if _is_cpu(src):
        ladder_apply_plain(src, dst, w, d, k, flag)
        return
    _int32(src, dst, w, d, flag)
    d_cap, n_cap = src.shape
    p = cuda.ptr
    cuda.launch("relax", "ladder_apply", "ppppiiip",
                p(src), p(dst), p(w), p(d), int(k), d_cap, n_cap, p(flag))
    ladder_apply.launches += 1


ladder_apply.launches = 0


def ladder_rung_plain(w, d, w2, d2) -> None:
    n_cap = w.shape[1]
    for k, dk in enumerate(d.tolist()):
        w2[k] = torch.clamp_max(w[k] + _roll(w[k], -dk), INF_E)
    d2.copy_(torch.remainder(d * 2, n_cap))


def ladder_rung(w, d, w2, d2) -> None:
    """Rung doubling into separate buffers: w2[k] = min(w[k] +
    roll(w[k], -d[k]), INF_E), d2 = 2 d mod n_cap."""
    if _is_cpu(w):
        ladder_rung_plain(w, d, w2, d2)
        return
    _int32(w, d, w2, d2)
    s_lad, n_cap = w.shape
    p = cuda.ptr
    cuda.launch("relax", "ladder_rung", "ppppii",
                p(w), p(d), p(w2), p(d2), s_lad, n_cap)
    ladder_rung.launches += 1


ladder_rung.launches = 0


# -- the loops ---------------------------------------------------------------

def read_flag(flag) -> bool:
    """Read the change flag on the host (one sync) and clear it; counts
    the reads in ``read_flag.reads``."""
    read_flag.reads += 1
    hit = bool(flag.item())
    flag.zero_()
    return hit


read_flag.reads = 0


def run_sync(step, dist0, bound: int):
    """Synchronous rounds to fixpoint: ``UNROLL`` applications of
    ``step`` (the ``relax_step`` signature) per trip, exiting on the
    first no-change trip or at ``bound`` trips. ``dist0`` is consumed
    as scratch. Returns ``(dist, trips, rounds)``, rounds = trips *
    UNROLL."""
    cur, spare = dist0, torch.empty_like(dist0)
    flag = torch.zeros(1, dtype=torch.int32, device=dist0.device)
    trips = 0
    while True:
        for _ in range(UNROLL):
            step(cur, spare, flag)
            cur, spare = spare, cur
        trips += 1
        if not read_flag(flag) or trips >= bound:
            return cur, trips, trips * UNROLL


def run_bucketed(step, dist0, deltas, sw, n_cap: int, s_cap: int,
                 delta_exp: int, classes=ladder_classes,
                 apply=ladder_apply, rung=ladder_rung):
    """Bucketed Δ-stepping to the exact fixpoint. Per epoch: ladder
    passes (each applies every laddered class's current rung in order,
    then doubles the rungs) until a pass changes nothing or
    ``ladder_depth(n_cap)`` passes ran, then ONE full relaxation
    ``step``. Exits on an epoch that changes nothing. ``classes``,
    ``apply`` and ``rung`` default to the kernel wrappers; the plain
    versions slot in to run the whole loop as the reference. Returns
    ``(dist, epochs, rounds)`` with rounds = ladder passes + one
    handoff per epoch."""
    s_lad = min(s_cap, LADDER_WIDTH)
    j_cap = ladder_depth(n_cap)
    epoch_bound = max_trips(n_cap) * UNROLL
    dq = 1 << max(delta_exp, 1)
    w_base, d_base = classes(sw, deltas, dq, s_lad)
    w_bufs = (torch.empty_like(w_base), torch.empty_like(w_base))
    d_bufs = (torch.empty_like(d_base), torch.empty_like(d_base))
    cur, spare = dist0, torch.empty_like(dist0)
    flag = torch.zeros(1, dtype=torch.int32, device=dist0.device)
    epochs = rounds = 0
    while True:
        epoch_changed = False
        w, d = w_base, d_base
        j = 0
        while True:
            for k in range(s_lad):
                apply(cur, spare, w, d, k, flag)
                cur, spare = spare, cur
            rung(w, d, w_bufs[j % 2], d_bufs[j % 2])
            w, d = w_bufs[j % 2], d_bufs[j % 2]
            j += 1
            changed = read_flag(flag)
            epoch_changed |= changed
            if not changed or j >= j_cap:
                break
        step(cur, spare, flag)
        cur, spare = spare, cur
        epoch_changed |= read_flag(flag)
        epochs += 1
        rounds += j + 1
        if not epoch_changed or epochs >= epoch_bound:
            return cur, epochs, rounds


def solve_from(deltas, sw, residual, dist0, kernel: str = "sync",
               delta_exp: int = 0, bound: int | None = None):
    """Relax the seed plane ``dist0`` [D, n_cap] to the fixpoint under
    the root-masked class weights ``sw`` and ``residual`` (K1s's
    outputs; None without residual edges), by the sync rounds (at most
    ``bound`` trips, ``max_trips(n_cap)`` by default) or the bucketed
    Δ-stepping epochs. ``dist0`` is consumed as scratch. Returns
    ``(dist, trips, rounds)``; trips counts epochs under bucketed."""

    def step(dist, out, flag):
        relax_step(dist, out, flag, deltas, sw, residual)

    s_cap, n_cap = sw.shape
    if kernel == "bucketed":
        return run_bucketed(step, dist0, deltas, sw, n_cap, s_cap, delta_exp)
    return run_sync(step, dist0, bound or max_trips(n_cap))


def plan_sssp(deltas, shift_w, res_rows, res_nbr, res_w, root: int,
              seeds_nbr, seeds_w, has_res: bool, kernel: str = "sync",
              delta_exp: int = 0):
    """Batched SSSP [D, n_cap] from the root's out-neighbours in
    G-minus-root over the shift-decomposed mirror, from the cold seed.
    ``kernel`` selects the sync rounds or the bucketed Δ-stepping
    epochs. Returns ``(dist, trips, rounds)``; trips counts epochs under
    bucketed."""
    sw, residual, dist0 = sssp_init(
        shift_w, res_rows, res_nbr, res_w, root, seeds_nbr, seeds_w
    )
    return solve_from(deltas, sw, residual if has_res else None, dist0,
                      kernel, delta_exp)
