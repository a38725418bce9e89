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
``ladder_pass``, and the multichip tier's ``[mc]`` variants
``sssp_init_mc``, ``relax_step_mc``, ``ladder_classes_mc``, which work
on one shard's window of class columns) launch their CUDA kernel on a
CUDA tensor and run the plain version (``*_plain``) only on a CPU
tensor. Each counts its kernel launches in ``<wrapper>.launches``. K2's
class pick and each of its ladder passes are one cooperative launch
(``ladder_pick``, ``ladder_pass``: a grid-wide barrier between their
phases), so a pass costs the host one launch and one flag read. K1 is
one launch a step, with or without a residual (a cooperative one with
it: the shift phase, a grid barrier, the residual scatter-min), and K1s
one launch that writes into outputs the caller may hold across solves
(``out=``, ``init_outputs``).

Fused solves (the port of ``tpu_solver._fused_pipeline``, a vmap of the
cold pipeline over ``g`` same-shape areas) pass every plane with a
leading lane axis — [g, D, n_cap] distances, [g, s_cap, n_cap] weights —
and one launch covers every lane. Under vmap each lane's loop carry
advances only while its own predicate holds, so a lane's trips and
rounds equal its unfused run's; ``Lanes`` keeps that per lane on the
device (change stamps and counters, ``Gate``) and the host still reads
one flag word per trip: the OR over lanes. The plain versions loop over
the lanes with the same gates.

INF discipline (ops/edgeplan.py): weights <= 2^28, INF_E = 2^29, so
``dist + w <= 2^30`` and a rung composition ``w + w`` peaks at 2^30
before its clip back to INF_E — int32-exact everywhere.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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
    if t.is_cuda:
        return False
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return True


# -- lane gates of a fused solve ---------------------------------------------

# a threshold every stamp passes, and a put stamp that is not stored
ALWAYS = -(2**31)
KEEP = -(2**31)


class Gate(NamedTuple):
    """Which lanes one launch of a fused solve runs, and what it records.
    Lane l is open iff ``st[l, 0] >= thr[0]`` and ``st[l, 1] >= thr[1]``;
    an open lane that changed stores ``put`` (``KEEP`` stores nothing)
    and every open lane adds ``inc`` to ``cnt[l]``. ``st`` [g, 2] holds
    the stamps of each lane's last change, ``cnt`` [g, 2] its (trips or
    epochs, rounds)."""

    st: torch.Tensor
    cnt: torch.Tensor
    thr: tuple = (ALWAYS, ALWAYS)
    put: tuple = (KEEP, KEEP)
    inc: tuple = (0, 0)

    def is_open(self, lane: int) -> bool:
        return bool(self.st[lane, 0] >= self.thr[0]
                    and self.st[lane, 1] >= self.thr[1])

    def close(self, lane: int, changed: bool) -> None:
        if changed:
            for j in (0, 1):
                if self.put[j] != KEEP:
                    self.st[lane, j] = self.put[j]
        self.cnt[lane, 0] += self.inc[0]
        self.cnt[lane, 1] += self.inc[1]


class Lanes:
    """Per-lane loop state of a fused solve of ``g`` areas, on the
    device: change stamps (-1: every lane runs the first step) and the
    (trips or epochs, rounds) counters K4 writes into each lane's
    payload."""

    def __init__(self, g: int, device):
        self.st = torch.full((g, 2), -1, dtype=torch.int32, device=device)
        self.cnt = torch.zeros((g, 2), dtype=torch.int32, device=device)

    def gate(self, thr=(ALWAYS, ALWAYS), put=(KEEP, KEEP),
             inc=(0, 0)) -> Gate:
        return Gate(self.st, self.cnt, thr, put, inc)


def _gate_args(gate: Optional[Gate]) -> tuple:
    """The kernels' trailing gate arguments (null ``st``: no gating)."""
    if gate is None:
        return (None, None, 0, 0, 0, 0, 0, 0)
    return (gate.st, gate.cnt, *gate.thr, *gate.put, *gate.inc)


def _lanes_of(t: torch.Tensor, plane_dims: int) -> int:
    """Number of stacked lanes of ``t`` (1 without a lane axis)."""
    return t.shape[0] if t.dim() > plane_dims else 1


def _each_lane(gate: Optional[Gate], flag, g: int, body) -> None:
    """Plain lane loop: ``body(l, f)`` for each lane the gate opens, with
    a fresh lane flag ``f`` that is ORed into ``flag`` and commits the
    lane's gate."""
    for lane in range(g):
        if gate is not None and not gate.is_open(lane):
            continue
        f = torch.zeros(1, dtype=torch.int32,
                        device=None if flag is None else flag.device)
        body(lane, f)
        if gate is not None:
            gate.close(lane, bool(f))
        if flag is not None:
            flag |= f


def _lane(x, lane: int):
    """Lane ``lane`` of a stacked tensor, or of each tensor of a tuple
    (None stays None)."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(t[lane] for t in x)
    return x[lane]


def _shared_residual(dist, residual) -> bool:
    """Whether a stacked solve's residual ELL shares one index table
    (rows_c [r_cap], nbr_c [r_cap, kr_cap]) across its lanes, with only
    the weights rw [g, r_cap, kr_cap] per lane."""
    return residual is not None and dist.dim() == 3 and residual[1].dim() == 2


def _lane_residual(dist, residual, lane: int):
    """Lane ``lane``'s residual tuple (shared index tables stay whole)."""
    if _shared_residual(dist, residual):
        rows_c, nbr_c, rw = residual
        return rows_c, nbr_c, rw[lane]
    return _lane(residual, lane)


# -- K1s: root masking + seed plane ----------------------------------------

def init_outputs(shift_w, res_rows, res_nbr, res_w, seeds_nbr, n_cap: int):
    """Uninitialised K1s outputs for these inputs: ``(sw, (rows_c, nbr_c,
    rw), dist0)``, each shaped as ``sssp_init`` returns it. A caller that
    solves the same plan again holds them and passes them as ``out=``."""
    return (torch.empty_like(shift_w),
            (torch.empty_like(res_rows), torch.empty_like(res_nbr),
             torch.empty_like(res_w)),
            torch.empty(seeds_nbr.shape + (n_cap,), dtype=torch.int32,
                        device=shift_w.device))


def _into(got, out):
    """Copy the K1s outputs ``got`` into the held ``out`` and return
    ``out`` (or ``got`` when ``out`` is None)."""
    if out is None:
        return got
    sw, res, dist0 = out
    sw.copy_(got[0])
    for held, t in zip(res, got[1]):
        held.copy_(t)
    dist0.copy_(got[2])
    return out


def _check_out(out, shift_w, res_rows, res_nbr, res_w, seeds_nbr,
               n_cap: int) -> None:
    """Raise unless ``out`` holds K1s's outputs at these inputs' shapes."""
    sw, (rows_c, nbr_c, rw), dist0 = out
    want = (shift_w.shape, res_rows.shape, res_nbr.shape, res_w.shape,
            seeds_nbr.shape + (n_cap,))
    got = (sw.shape, rows_c.shape, nbr_c.shape, rw.shape, dist0.shape)
    if got != want:
        raise ValueError(f"sssp_init: out= shapes {got} != {want}")


def sssp_init_plain(shift_w, res_rows, res_nbr, res_w, root, seeds_nbr,
                    seeds_w, out=None):
    if shift_w.dim() == 3:
        roots = root.tolist()
        outs = [sssp_init_plain(shift_w[lane], res_rows[lane],
                                res_nbr[lane], res_w[lane], roots[lane],
                                seeds_nbr[lane], seeds_w[lane])
                for lane in range(shift_w.shape[0])]
        return _into((torch.stack([o[0] for o in outs]),
                      tuple(torch.stack([o[1][j] for o in outs])
                            for j in range(3)),
                      torch.stack([o[2] for o in outs])), out)
    # the whole width is one window
    return sssp_init_mc_plain(shift_w, res_rows, res_nbr, res_w, root,
                              seeds_nbr, seeds_w, 0, shift_w.shape[1], out)


def sssp_init(shift_w, res_rows, res_nbr, res_w, root, seeds_nbr,
              seeds_w, out=None):
    """-> (sw, (rows_c, nbr_c, rw), dist0): the root-masked class
    weights (the root is never a transit node), the clipped and
    root-masked residual ELL, and the [D, n_cap] seed plane (0 at each
    live out-neighbour, INF_E elsewhere). With a lane axis every input
    and output is stacked over ``g`` areas and ``root`` is an int32
    tensor [g] of their roots.

    ``out``, when given, is a set of outputs held by the caller
    (``init_outputs``), every word of which is written: the call returns
    it, and on the card makes one launch and no torch op. A held seed
    plane must not be a plane that the caller still reads as a solve's
    result (``solve_from`` consumes ``dist0`` as scratch)."""
    if _is_cpu(shift_w):
        return sssp_init_plain(shift_w, res_rows, res_nbr, res_w, root,
                               seeds_nbr, seeds_w, out)
    g = _lanes_of(shift_w, 2)
    s_cap, n_cap = shift_w.shape[-2:]
    if isinstance(root, torch.Tensor):
        if shift_w.dim() != 3 or root.shape != (g,):
            raise ValueError("per-lane roots need stacked [g, ...] planes")
        root_i, roots = 0, root
    else:
        root_i, roots = int(root), None
    out = _launch_init(shift_w, res_rows, res_nbr, res_w, root_i, roots,
                       seeds_nbr, seeds_w, g, s_cap, n_cap, 0, out)
    sssp_init.launches += 1
    return out


sssp_init.launches = 0


def _launch_init(shift_w, res_rows, res_nbr, res_w, root_i: int, roots,
                 seeds_nbr, seeds_w, g: int, s_cap: int, n_cap: int,
                 col0: int, out=None):
    """Launch K1s over the class columns [col0, col0 + shift_w width) of
    an n_cap-node plan, into ``out`` (allocated when None)."""
    if out is None:
        out = init_outputs(shift_w, res_rows, res_nbr, res_w, seeds_nbr,
                           n_cap)
    else:
        _check_out(out, shift_w, res_rows, res_nbr, res_w, seeds_nbr, n_cap)
    sw, (rows_c, nbr_c, rw), dist0 = out
    r_cap, kr_cap = res_nbr.shape[-2:]
    cuda.launch(
        "relax", "sssp_init", "tttttttttttiiiiiitiii",
        shift_w, sw, res_rows, res_nbr, res_w, rows_c, nbr_c, rw, seeds_nbr,
        seeds_w, dist0, s_cap, n_cap, r_cap, kr_cap, seeds_nbr.shape[-1],
        root_i, roots, g, col0, shift_w.shape[-1],
    )
    return out


# -- K1s [mc]: one shard's window of class columns ---------------------------

def sssp_init_mc_plain(shift_w, res_rows, res_nbr, res_w, root: int,
                       seeds_nbr, seeds_w, col0: int, n_cap: int, out=None):
    w_cols = shift_w.shape[1]
    sw = shift_w.clone()
    if 0 <= root - col0 < w_cols:
        sw[:, root - col0] = INF_E
    rw = torch.where(res_nbr == root, INF_E, res_w)
    d_cap = seeds_nbr.shape[0]
    dist0 = torch.full((d_cap, n_cap), INF_E, dtype=torch.int32,
                       device=shift_w.device)
    seed = seeds_nbr.clamp(0, n_cap - 1).long()
    lanes = torch.arange(d_cap, device=shift_w.device)
    dist0[lanes, seed] = torch.minimum(
        dist0[lanes, seed],
        torch.where(seeds_w < INF_E, 0, INF_E).to(torch.int32),
    )
    return _into((sw, (res_rows.clamp(0, n_cap - 1),
                       res_nbr.clamp(0, n_cap - 1), rw), dist0), out)


def sssp_init_mc(shift_w, res_rows, res_nbr, res_w, root: int, seeds_nbr,
                 seeds_w, col0: int, n_cap: int, out=None):
    """K1s [mc]: ``sssp_init`` for one shard of the multichip tier, whose
    ``shift_w`` [s_cap, w] holds the class columns [col0, col0 + w) of an
    ``n_cap``-node plan: the root's column is masked only where it lies
    in the window (``parallel/sharding.py::make_mc_sssp``, :378-383);
    the residual ELL (whole) and the [D, n_cap] seed plane as
    ``sssp_init``, ``out`` too."""
    if _is_cpu(shift_w):
        return sssp_init_mc_plain(shift_w, res_rows, res_nbr, res_w, root,
                                  seeds_nbr, seeds_w, col0, n_cap, out)
    out = _launch_init(shift_w, res_rows, res_nbr, res_w, int(root), None,
                       seeds_nbr, seeds_w, 1, shift_w.shape[0], n_cap, col0,
                       out)
    sssp_init_mc.launches += 1
    return out


sssp_init_mc.launches = 0


# -- K1: one Jacobi relaxation ---------------------------------------------

_GATE_SIG = "ttiiiiii"


def _roll(x, shift: int):
    return torch.roll(x, shift, dims=-1)


def relax_step_plain(dist, out, flag, deltas, sw, residual,
                     gate: Optional[Gate] = None) -> None:
    if dist.dim() == 3:
        _each_lane(gate, flag, dist.shape[0], lambda lane, f: relax_step_plain(
            dist[lane], out[lane], f, deltas[lane], sw[lane],
            _lane_residual(dist, residual, lane)))
        return
    relax_step_mc_plain(dist, out, flag, deltas, sw, residual, 0)


def relax_step(dist, out, flag, deltas, sw, residual,
               gate: Optional[Gate] = None) -> None:
    """out = min(dist, min_k roll(dist + sw[k], deltas[k]), residual
    scatter-min) computed from ``dist`` alone (Jacobi — ``out`` is a
    different buffer); ORs 1 into ``flag`` when any word decreased.
    ``residual`` is None when the plan has no residual edges. Stacked
    [g, ...] inputs relax every lane the ``gate`` opens; their residual
    index tables may be one shared pair ([r_cap], [r_cap, kr_cap]) beside
    per-lane weights. On the card: one launch, with or without a
    residual."""
    if _is_cpu(dist):
        relax_step_plain(dist, out, flag, deltas, sw, residual, gate)
        return
    _launch_relax(dist, out, flag, deltas, sw, residual, gate)
    relax_step.launches += 1


def _launch_relax(dist, out, flag, deltas, sw, residual,
                  gate: Optional[Gate] = None, col0: int = 0) -> None:
    """Launch K1 over the class columns [col0, col0 + sw width), and the
    residual ELL when there is one: one kernel launch (a cooperative one
    with a residual). ``flag`` may be None."""
    rows_c = nbr_c = rw = None
    r_cap = kr_cap = 0
    if residual is not None:
        rows_c, nbr_c, rw = residual
        r_cap, kr_cap = nbr_c.shape[-2:]
    cuda.launch(
        "relax", "relax_step", "ttttttt" + "iiiiiiii" + "ti" + _GATE_SIG,
        dist, out, deltas, sw, rows_c, nbr_c, rw, dist.shape[-2],
        dist.shape[-1], sw.shape[-2], col0, sw.shape[-1], r_cap, kr_cap,
        int(_shared_residual(dist, residual)), flag, _lanes_of(dist, 2),
        *_gate_args(gate),
    )


relax_step.launches = 0


# -- K1 [mc]: one shard's relaxation over its own source columns -------------

def window_row(sw_local, k: int, col0: int, n_cap: int):
    """Class ``k``'s full-width weight row [n_cap] of a shard holding the
    columns [col0, col0 + w): its own weights there, INF_E elsewhere
    (the reference's ``w_of``, ``parallel/sharding.py:396-400``)."""
    if sw_local.shape[1] == n_cap:
        return sw_local[k]
    row = torch.full((n_cap,), INF_E, dtype=torch.int32,
                     device=sw_local.device)
    row[col0:col0 + sw_local.shape[1]] = sw_local[k]
    return row


def relax_step_mc_plain(dist, out, flag, deltas, sw_local, residual,
                        col0: int) -> None:
    n_cap = dist.shape[1]
    acc = torch.full_like(dist, INF_E)
    for k, dk in enumerate(deltas.tolist()):
        acc = torch.minimum(
            acc, _roll(dist + window_row(sw_local, k, col0, n_cap), dk))
    if residual is not None:
        rows_c, nbr_c, rw = residual
        cand = (dist[:, nbr_c.long()] + rw[None]).amin(dim=2)
        acc.scatter_reduce_(
            1, rows_c.long()[None].expand(dist.shape[0], -1), cand,
            reduce="amin",
        )
    new = torch.minimum(acc, dist)
    if flag is not None:
        flag |= (new < dist).any().to(torch.int32)
    out.copy_(new)


def relax_step_mc(dist, out, flag, deltas, sw_local, residual,
                  col0: int) -> None:
    """K1 [mc]: one shard's partial relaxation of the full-width plane
    ``dist`` [D, n_cap] into ``out``: the shift candidates of its own
    source columns [col0, col0 + w) only (``sw_local`` [s_cap, w], root
    masked by K1s [mc]), the residual ELL whole, min-ed with ``dist``.
    The group's combine (``ops/combine.shard_combine``, min) of its
    members' planes is the reference's relaxation with its ``pmin``
    (``ops/relax.py::make_relax(combine=)``). ORs ``flag`` (may be None)
    on a decrease."""
    if _is_cpu(dist):
        relax_step_mc_plain(dist, out, flag, deltas, sw_local, residual,
                            col0)
        return
    _launch_relax(dist, out, flag, deltas, sw_local, residual, None, col0)
    relax_step_mc.launches += 1


relax_step_mc.launches = 0


# -- K2: the Δ-stepping ladder ---------------------------------------------

def ladder_classes_plain(sw, deltas, dq: int, s_lad: int):
    if sw.dim() == 3:
        outs = [ladder_classes_plain(sw[lane], deltas[lane], dq, s_lad)
                for lane in range(sw.shape[0])]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    return ladder_classes_mc_plain(sw, deltas, dq, s_lad, 0, sw.shape[1])


def ladder_classes(sw, deltas, dq: int, s_lad: int):
    """-> (w_base [s_lad, n_cap], d_base [s_lad]): the ``s_lad`` shift
    classes with the most light edges (weight <= dq; ties to the lower
    class, as ``lax.top_k``), their weights with heavy edges masked to
    INF_E, and their shifts reduced mod n_cap. Stacked inputs pick per
    lane ([g, s_lad, n_cap], [g, s_lad]). On the card: one launch of
    ``ladder_pick``, and no torch op but the outputs' allocation."""
    if _is_cpu(sw):
        return ladder_classes_plain(sw, deltas, dq, s_lad)
    out = _launch_pick(sw, deltas, dq, s_lad, 0, sw.shape[-1])
    ladder_classes.launches += 1
    return out


ladder_classes.launches = 0

# the most blocks of the class pick kernel (csrc/relax.cu PICK_BLOCKS):
# its scratch holds a partial light-edge count per (lane, class, block)
PICK_BLOCKS = 1024


def _launch_pick(sw, deltas, dq: int, s_lad: int, col0: int, n_cap: int):
    """Launch K2's class pick over the class columns [col0, col0 + sw
    width) of an n_cap-node plan: full-width ladder rows, INF_E outside
    the window."""
    g = _lanes_of(sw, 2)
    s_cap, w_cols = sw.shape[-2:]
    lead, dev = sw.shape[:-2], sw.device
    part = torch.empty(g * s_cap * PICK_BLOCKS, dtype=torch.int32,
                       device=dev)
    w_base = torch.empty(lead + (s_lad, n_cap), dtype=torch.int32,
                         device=dev)
    d_base = torch.empty(lead + (s_lad,), dtype=torch.int32, device=dev)
    cuda.launch("relax", "ladder_pick", "tttttiiiiiii",
                sw, deltas, part, w_base, d_base, s_cap, s_lad, n_cap,
                int(dq), g, col0, w_cols)
    return w_base, d_base


def ladder_classes_mc_plain(sw_local, deltas, dq: int, s_lad: int,
                            col0: int, n_cap: int):
    score = (sw_local <= dq).sum(dim=1, dtype=torch.int32)
    lad = torch.sort(score, descending=True, stable=True).indices[:s_lad]
    w = torch.stack([window_row(sw_local, int(k), col0, n_cap)
                     for k in lad.tolist()])
    w_base = torch.where(w <= dq, w, INF_E).contiguous()
    d_base = torch.remainder(deltas[lad], n_cap).contiguous()
    return w_base, d_base


def ladder_classes_mc(sw_local, deltas, dq: int, s_lad: int, col0: int,
                      n_cap: int):
    """K2 [mc]: ``ladder_classes`` for one shard holding the class
    columns [col0, col0 + w) (``sw_local`` [s_cap, w], root masked): the
    classes are scored on its own columns (``ops/relax.py:227-232``,
    shards may pick different ones) and the ladder rows are full width
    [s_lad, n_cap], INF_E outside the window. One ``ladder_pick`` launch
    on the card."""
    if _is_cpu(sw_local):
        return ladder_classes_mc_plain(sw_local, deltas, dq, s_lad, col0,
                                       n_cap)
    out = _launch_pick(sw_local, deltas, dq, s_lad, col0, n_cap)
    ladder_classes_mc.launches += 1
    return out


ladder_classes_mc.launches = 0


def ladder_apply_plain(src, dst, w, d, k: int, flag,
                       gate: Optional[Gate] = None) -> None:
    """One class application of a ladder pass: dst = min(src,
    roll(src + w[k], d[k])); ORs ``flag`` on any decrease. Stacked
    inputs apply every lane the ``gate`` opens."""
    if src.dim() == 3:
        _each_lane(gate, flag, src.shape[0], lambda lane, f: (
            ladder_apply_plain(src[lane], dst[lane], w[lane], d[lane], k, f)))
        return
    new = torch.minimum(src, _roll(src + w[k], int(d[k])))
    flag |= (new < src).any().to(torch.int32)
    dst.copy_(new)


def ladder_rung_plain(w, d, w2, d2, gate: Optional[Gate] = None) -> None:
    """Rung doubling into separate buffers: w2[k] = min(w[k] +
    roll(w[k], -d[k]), INF_E), d2 = 2 d mod n_cap. Stacked inputs double
    the rungs of every lane the ``gate`` opens."""
    if w.dim() == 3:
        _each_lane(gate, None, w.shape[0], lambda lane, f: (
            ladder_rung_plain(w[lane], d[lane], w2[lane], d2[lane])))
        return
    n_cap = w.shape[1]
    for k, dk in enumerate(d.tolist()):
        w2[k] = torch.clamp_max(w[k] + _roll(w[k], -dk), INF_E)
    d2.copy_(torch.remainder(d * 2, n_cap))


def ladder_pass_plain(src, dst, w, d, w2, d2, flag,
                      gate: Optional[Gate] = None):
    n_cls = w.shape[-2]
    bufs = (src, dst)
    for k in range(n_cls):
        ladder_apply_plain(bufs[k % 2], bufs[1 - k % 2], w, d, k, flag,
                           gate if gate is None or k == 0
                           else gate._replace(inc=(0, 0)))
    ladder_rung_plain(w, d, w2, d2, None if gate is None else gate._replace(
        thr=(gate.thr[0], gate.put[1]), put=(KEEP, KEEP), inc=(0, 0)))
    return bufs[n_cls % 2], bufs[1 - n_cls % 2]


def ladder_pass(src, dst, w, d, w2, d2, flag, gate: Optional[Gate] = None):
    """One ladder pass: the ``s_lad`` classes of the rung (w, d) applied
    in order (``ladder_apply_plain``), ping-ponging between ``src`` and
    ``dst``, then the rung doubled into (w2, d2) (``ladder_rung_plain``);
    ORs ``flag`` on any decrease. Returns ``(plane, spare)``: the buffer
    holding the result (``src`` for even ``s_lad``, as the class-by-class
    swaps left it) and the other one.

    Stacked inputs run every lane the pass's ``gate`` opens: a lane that
    changed in any class stores ``gate.put``, every open lane adds
    ``gate.inc`` once, and the rung doubles only the lanes whose stamps
    then pass ``(gate.thr[0], gate.put[1])`` — those that changed in this
    pass. On the card: one cooperative launch of ``ladder_pass``."""
    if _is_cpu(src):
        return ladder_pass_plain(src, dst, w, d, w2, d2, flag, gate)
    n_cls, n_cap = w.shape[-2:]
    cuda.launch("relax", "ladder_pass", "ttttttiiiti" + _GATE_SIG,
                src, dst, w, d, w2, d2, n_cls, src.shape[-2], n_cap, flag,
                _lanes_of(src, 2), *_gate_args(gate))
    ladder_pass.launches += 1
    return (dst, src) if n_cls % 2 else (src, dst)


ladder_pass.launches = 0


# -- the loops ---------------------------------------------------------------

def read_flag(flag, clear: bool = True) -> bool:
    """Read the change flag on the host (one sync) and, with ``clear``,
    clear it (a kernel that clears its own flag words passes False);
    counts the reads in ``read_flag.reads``."""
    read_flag.reads += 1
    hit = bool(flag.item())
    if clear:
        flag.zero_()
    return hit


read_flag.reads = 0


class FlagBank:
    """One int32 change flag for each of ``n`` slots on the devices
    given, the flags of one device held in one tensor, so that reading
    every slot costs one sync per device."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self._banks = {}
        self._slot = []
        for dev in self.devices:
            self._slot.append((dev, self._banks.get(dev, 0)))
            self._banks[dev] = self._banks.get(dev, 0) + 1
        self._banks = {dev: torch.zeros(n, dtype=torch.int32, device=dev)
                       for dev, n in self._banks.items()}
        # one view a slot, made once: a kernel given the same flags again
        # finds its packed pointers (ops/cuda.launch's "a" sequences)
        self._views = [self._banks[dev][j:j + 1] for dev, j in self._slot]

    def __getitem__(self, i: int) -> torch.Tensor:
        return self._views[i]

    def read(self) -> list:
        """Every slot's flag (one host read a device), then clear them."""
        vals = {}
        for dev, bank in self._banks.items():
            read_flag.reads += 1
            vals[dev] = bank.tolist()
            bank.zero_()
        return [bool(vals[dev][j]) for dev, j in self._slot]


def run_sync(step, dist0, bound: int, lanes: Optional[Lanes] = None):
    """Synchronous rounds to fixpoint: ``UNROLL`` applications of
    ``step`` (the ``relax_step`` signature) per trip, exiting on the
    first no-change trip or at ``bound`` trips. ``dist0`` is consumed
    as scratch. Returns ``(dist, trips, rounds)``, rounds = trips *
    UNROLL.

    With ``lanes`` (a fused solve, ``dist0`` [g, D, n_cap]) ``step``
    also takes a gate: lane l runs trip t iff it changed in trip t - 1,
    and ``lanes.cnt[l]`` counts its own (trips, rounds); the returned
    counts are the host loop's, the largest lane's."""
    cur, spare = dist0, torch.empty_like(dist0)
    flag = torch.zeros(1, dtype=torch.int32, device=dist0.device)
    trips = 0
    while True:
        for i in range(UNROLL):
            if lanes is None:
                step(cur, spare, flag)
            else:
                step(cur, spare, flag, lanes.gate(
                    (trips - 1, ALWAYS), (trips, KEEP), (int(i == 0), 1)))
            cur, spare = spare, cur
        trips += 1
        if not read_flag(flag) or trips >= bound:
            return cur, trips, trips * UNROLL


def run_bucketed(step, dist0, deltas, sw, n_cap: int, s_cap: int,
                 delta_exp: int, classes=ladder_classes,
                 ladder=ladder_pass, lanes: Optional[Lanes] = None):
    """Bucketed Δ-stepping to the exact fixpoint. Per epoch: ladder
    passes (each applies every laddered class's current rung in order,
    then doubles the rungs) until a pass changes nothing or
    ``ladder_depth(n_cap)`` passes ran, then ONE full relaxation
    ``step``. Exits on an epoch that changes nothing. ``classes`` and
    ``ladder`` (one pass) default to the kernel wrappers; the plain
    versions slot in to run the whole loop as the reference. Returns
    ``(dist, epochs, rounds)`` with rounds = ladder passes + one
    handoff per epoch.

    With ``lanes`` (a fused solve) every launch takes a gate: lane l runs
    epoch e iff it changed in epoch e - 1, and ladder pass j > 0 of it
    iff it changed in pass j - 1 (stamps: the epoch, and a serial number
    over all passes); ``lanes.cnt[l]`` counts its own (epochs, rounds).
    The returned counts are the host loop's."""
    s_lad = min(s_cap, LADDER_WIDTH)
    j_cap = ladder_depth(n_cap)
    epoch_bound = max_trips(n_cap) * UNROLL
    dq = 1 << max(delta_exp, 1)
    w_base, d_base = classes(sw, deltas, dq, s_lad)
    w_bufs = (torch.empty_like(w_base), torch.empty_like(w_base))
    d_bufs = (torch.empty_like(d_base), torch.empty_like(d_base))
    cur, spare = dist0, torch.empty_like(dist0)
    flag = torch.zeros(1, dtype=torch.int32, device=dist0.device)

    def gate(*args):
        return None if lanes is None else lanes.gate(*args)

    epochs = rounds = 0
    q = 0  # ladder passes so far, over all epochs (the pass stamp)
    while True:
        epoch_changed = False
        w, d = w_base, d_base
        j = 0
        while True:
            # only lanes that changed in this pass double their rungs and
            # run the next one
            cur, spare = ladder(cur, spare, w, d, w_bufs[j % 2],
                                d_bufs[j % 2], flag, gate(
                                    (epochs - 1, q - 1 if j else ALWAYS),
                                    (epochs, q), (0, 1)))
            w, d = w_bufs[j % 2], d_bufs[j % 2]
            j += 1
            q += 1
            changed = read_flag(flag)
            epoch_changed |= changed
            if not changed or j >= j_cap:
                break
        if lanes is None:
            step(cur, spare, flag)
        else:
            step(cur, spare, flag,
                 gate((epochs - 1, ALWAYS), (epochs, KEEP), (1, 1)))
        cur, spare = spare, cur
        epoch_changed |= read_flag(flag)
        epochs += 1
        rounds += j + 1
        if not epoch_changed or epochs >= epoch_bound:
            return cur, epochs, rounds


def solve_from(deltas, sw, residual, dist0, kernel: str = "sync",
               delta_exp: int = 0, bound: int | None = None,
               lanes: Optional[Lanes] = None):
    """Relax the seed plane ``dist0`` [D, n_cap] to the fixpoint under
    the root-masked class weights ``sw`` and ``residual`` (K1s's
    outputs; None without residual edges), by the sync rounds (at most
    ``bound`` trips, ``max_trips(n_cap)`` by default) or the bucketed
    Δ-stepping epochs. ``dist0`` is consumed as scratch. Returns
    ``(dist, trips, rounds)``; trips counts epochs under bucketed. With
    ``lanes`` the inputs are stacked [g, ...] and each lane's own counts
    land in ``lanes.cnt``."""

    def step(dist, out, flag, gate=None):
        relax_step(dist, out, flag, deltas, sw, residual, gate)

    s_cap, n_cap = sw.shape[-2:]
    if kernel == "bucketed":
        return run_bucketed(step, dist0, deltas, sw, n_cap, s_cap, delta_exp,
                            lanes=lanes)
    return run_sync(step, dist0, bound or max_trips(n_cap), lanes)


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


def plan_sssp_lanes(deltas, shift_w, res_rows, res_nbr, res_w, roots,
                    seeds_nbr, seeds_w, has_res: bool, kernel: str = "sync",
                    delta_exp: int = 0):
    """``plan_sssp`` over ``g`` stacked same-shape areas in one launch a
    step (the port of ``_fused_pipeline``'s vmapped SSSP): inputs with a
    leading lane axis, ``roots`` an int32 tensor [g]. Returns ``(dist
    [g, D, n_cap], counts)``: ``counts`` is the int32 [g, 2] tensor of
    each lane's own (trips, rounds), on the device — equal to the lane's
    unfused run."""
    lanes = Lanes(shift_w.shape[0], shift_w.device)
    sw, residual, dist0 = sssp_init(
        shift_w, res_rows, res_nbr, res_w, roots, seeds_nbr, seeds_w
    )
    dist, _, _ = solve_from(deltas, sw, residual if has_res else None, dist0,
                            kernel, delta_exp, lanes=lanes)
    return dist, lanes.cnt
