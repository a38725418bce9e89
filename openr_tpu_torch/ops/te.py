"""Differentiable traffic engineering: one gradient-descent step of the
softmin surrogate (the port of ``ops/sweep.py::_make_te`` / ``te_step``
of the JAX package, after "Fast Traffic Engineering by Gradient
Descent", arXiv:2209.10380).

Per demand source, a fixed-length float32 relaxation over the resident
mirror, with the per-link weight vector theta scattered onto the shift
slots ``sh_idx`` and the residual slots ``rs_idx`` (``BIG_F`` on every
other slot and on pad rows). A trip, for every node::

    acc = d
    for each shift class k, in deltas order:
        acc = softmin2(acc, roll(d + w_k, delta_k))
    acc = acc.at[rows].min(-tau * logsumexp(-(d[nbr] + rw) / tau, K))
    d   = min(acc, d)

with ``softmin2(a, b) = -tau * logaddexp(-a / tau, -b / tau)`` and
logaddexp computed as ``amax + log1p(exp(-|delta|))``, as
``jnp.logaddexp`` computes it. Then ``cost = sum(vol * d[row, dst])``,
``util = d cost / d theta``, ``loss = tau_u * logsumexp(util / tau_u)``
and ``grad = d loss / d theta``. The derivatives follow JAX's rules, not
those of the formulas above: logaddexp's custom JVP
``t_i * exp(x_i - out)`` (``jax/_src/lax/other.py``), half the tangent
to each side of a tie in ``minimum`` (``lax._balanced_eq``), and the
tangents of all tied contenders averaged in the scatter-min
(``lax/slicing.py::_scatter_extremal_jvp``). Where the other class terms
underflow, ``acc == d`` exactly in float32, so ties are the common case,
not an edge case.

``grad`` is a Hessian-vector product, ``H v`` with ``v =
softmax(util / tau_u)`` and ``H`` the Hessian of the cost. JAX computes
it as a VJP of the VJP; the port computes it forward-over-reverse, as
the tangent of the adjoint sweep along ``v`` — the same vector, because
the rules above are the exact derivatives of the cost with every tied
minimum replaced by the mean of its tied sides, a smooth function whose
Hessian is symmetric.

Kernels (``csrc/te.cu``), one launch each a step looping over the trips:
one block per source (K13, K15), one cluster of blocks per source (K14,
K16: ``adjoint_layout``):

  K13  ``te_relax``          the forward trips, every trip's field kept
  K14  ``te_relax_vjp``      the adjoint sweep backwards over the trips:
                             the cotangent of every theta slot
  K14s ``te_link_sum``       slot cotangents -> per-link sums, in one
                             fixed order (util, and later grad)
  K17  ``te_loss``           cost, loss and v = softmax(util / tau_u)
  K15  ``te_relax_jvp``      the forward trips' tangent along v
  K16  ``te_relax_vjp_jvp``  the adjoint sweep and its tangent along v:
                             the second-order slot cotangents

Each wrapper launches its kernel on CUDA tensors, or runs its plain
PyTorch version (``*_plain``, the executable spec, faithful to the JAX
function including its pad rows and pad columns) on CPU tensors; it
counts its launches in ``<wrapper>.launches``. ``te_step`` composes the
wrappers, ``te_step_plain`` the plain versions, which compute in the
dtype of theta (float32 as the reference; float64 to check the
derivatives against finite differences).

The kernels leave out the residual pad rows (``res_rows < 0``) and, in
the adjoint, the pad columns (``res_nbr < 0``), which the reference
clips onto node 0. That is exact for ``tau <= MAX_TAU``: a pad row's
candidate, ``d[0] + BIG_F - tau * log(K)``, never undercuts node 0's
``acc <= d[0]``, so the scatter-min never takes it and its tangent
coefficient is 0; a pad column's weight ``exp(y - max y)`` is 0 in
float32 wherever its row's cotangent is not — every cotangent is
exactly 0 on a node whose distance is still ``BIG_F`` (it reaches real
costs only through exp(-BIG_F / tau) = 0 factors).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from openr_tpu_torch.ops import cuda
from openr_tpu_torch.ops.relax import _is_cpu

# "unreachable" in the float surrogate: finite, so logsumexp gradients
# never see inf - inf, and exp(-BIG_F / tau) is exactly 0
BIG_F = 1.0e9

# the kernels' domain (module docstring): above it a pad row could win
# node 0's scatter-min
MAX_TAU = 1.0e6

# the kernels keep a node's per-class chain in registers (the adjoint's
# up to 8 classes) or local memory
MAX_CLASSES = 64

# the adjoint's cluster launch (``adjoint_layout``): at most 8 blocks a
# source (the portable cluster size; a block's span is a multiple of an
# eighth of the nodes), threads a block (CUDA's most, the kernel's
# ``__launch_bounds__``: te.cu's THREADS), and the dynamic shared memory
# a block can opt into on Hopper (227 KB) less the kernel's static tables
MAX_CLUSTER = 8
ADJ_THREADS = 1024
SMEM_BLOCK = 232448 - 256

_F32 = torch.float32


class TePlan(NamedTuple):
    """One TE problem's index tables, on one device.

    From the JAX job's arrays: ``deltas`` [C], ``res_rows`` [R] (pad
    -1), ``res_nbr`` [R, K] (pad -1), ``sh_flat`` / ``sh_link`` the live
    shift slots (flat into [C * n_cap]) and their links, ``rs_flat`` /
    ``rs_link`` the live residual slots (flat into [R * K]), ``srcs``
    [S], ``dem_row`` / ``dem_dst`` [D] int32, ``dem_vol`` [D] float32.
    Derived for the kernels: ``sh_slot`` [C * n_cap], the live shift
    slot at each plane word (or -1), ``sh_lnk`` / ``rs_lnk`` [R * K] a
    plane word's link (or -1); ``row_of`` [n_cap], a node's residual row
    (or -1); ``inv_ptr`` [n_cap + 1], where each node's received live
    residual entries start (CSR by receiver); ``link_ptr`` [l_cap + 1] /
    ``link_slot`` each link's slots (shift slots, then residual slots
    offset by the shift count); ``row_fill`` [R] each row's live entries
    (0 on pad rows); ``dem_ptr`` [S + 1] / ``dem_ids`` [D] each source's
    demands in demand order (CSR). ``held``: the adjoint's host tables
    (``host``, numpy: ``rs_slot`` [R * K] the live residual slot at each
    plane word (or -1); the live entries row-major, ``ent_row`` /
    ``ent_col`` / ``ent_nbr`` / ``ent_lnk`` / ``ent_slot``, with
    ``row_start`` [R] a row's first; ``inv_ent`` the entries by receiver
    (``inv_ptr``'s runs) and ``rc_pos`` each entry's position there;
    ``node_fill`` a node's row fill) and, from its first launch on the
    plan, that launch layout's tables and scratch, reused by every later
    launch (two streams must not run one plan's adjoint at once)."""

    n_cap: int
    l_cap: int
    trips: int
    has_res: bool
    deltas: torch.Tensor
    res_rows: torch.Tensor
    res_nbr: torch.Tensor
    sh_flat: torch.Tensor
    sh_link: torch.Tensor
    rs_flat: torch.Tensor
    rs_link: torch.Tensor
    srcs: torch.Tensor
    dem_row: torch.Tensor
    dem_dst: torch.Tensor
    dem_vol: torch.Tensor
    sh_slot: torch.Tensor
    sh_lnk: torch.Tensor
    rs_lnk: torch.Tensor
    row_of: torch.Tensor
    inv_ptr: torch.Tensor
    link_ptr: torch.Tensor
    link_slot: torch.Tensor
    row_fill: torch.Tensor
    dem_ptr: torch.Tensor
    dem_ids: torch.Tensor
    held: dict


def te_plan(deltas, res_rows, res_nbr, sh_idx, sh_link, rs_idx, rs_link,
            srcs, dem_row, dem_dst, dem_vol, *, n_cap: int, l_cap: int,
            trips: int, has_res: bool, device) -> TePlan:
    """The ``TePlan`` of the JAX job's padded host arrays (numpy, as
    ``OptimizeJob.run`` builds them). Pad slots (index past the raveled
    plane) drop, as ``mode="drop"`` drops them."""
    i32 = np.int32
    deltas = np.asarray(deltas, i32)
    res_rows = np.asarray(res_rows, i32)
    res_nbr = np.asarray(res_nbr, i32)
    c, (r, k) = len(deltas), res_nbr.shape
    sh_idx, sh_link = np.asarray(sh_idx, i32), np.asarray(sh_link, i32)
    rs_idx, rs_link = np.asarray(rs_idx, i32), np.asarray(rs_link, i32)
    live = sh_idx < c * n_cap
    sh_flat, sh_link = sh_idx[live], sh_link[live]
    live = rs_idx < r * k
    rs_flat, rs_link = rs_idx[live], rs_link[live]
    if not has_res:
        rs_flat, rs_link = rs_flat[:0], rs_link[:0]
    for flat in (sh_flat, rs_flat):
        if len(np.unique(flat)) != len(flat):
            raise ValueError("theta slots must be distinct plane words")
    srcs, dem_row = np.asarray(srcs, i32), np.asarray(dem_row, i32)
    dem_dst = np.asarray(dem_dst, i32)
    # the kernels index with these unclipped (the reference clips or
    # drops): out of range they would read past a buffer
    for name, a, hi in (("sh_idx", sh_flat, c * n_cap),
                        ("sh_link", sh_link, l_cap),
                        ("rs_link", rs_link, l_cap),
                        ("res_rows", res_rows, n_cap),
                        ("res_nbr", res_nbr, n_cap),
                        ("dem_row", dem_row, len(srcs)),
                        ("dem_dst", dem_dst, n_cap)):
        if a.size and (a.min() < (-1 if name.startswith("res") else 0)
                       or a.max() >= hi):
            raise ValueError(f"{name} out of range [0, {hi})")
    sh_slot = np.full(c * n_cap, -1, i32)
    sh_slot[sh_flat] = np.arange(len(sh_flat), dtype=i32)
    rs_slot = np.full(r * k, -1, i32)
    pad_row = np.repeat(res_rows < 0, k)
    keep = ~pad_row[rs_flat]
    rs_slot[rs_flat[keep]] = np.flatnonzero(keep).astype(i32)
    sh_lnk = np.full(c * n_cap, -1, i32)
    sh_lnk[sh_flat] = sh_link
    rs_lnk = np.full(r * k, -1, i32)
    rs_lnk[rs_flat[keep]] = rs_link[keep]
    row_of = np.full(n_cap, -1, i32)
    real = np.flatnonzero(res_rows >= 0) if has_res else np.zeros(0, i32)
    if len(np.unique(res_rows[real])) != len(real):
        raise ValueError("residual rows must target distinct nodes")
    row_of[res_rows[real]] = real
    # live residual entries (a prefix of every row), row-major
    fill = (res_nbr >= 0).sum(axis=1).astype(i32) if has_res else \
        np.zeros(r, i32)
    if has_res and not ((res_nbr >= 0) == (np.arange(k) < fill[:, None])
                        ).all():
        raise ValueError("live residual entries must lead their rows")
    fill[res_rows < 0] = 0
    row_start = np.zeros(r, i32)
    row_start[1:] = np.cumsum(fill)[:-1]
    ent_row = np.repeat(np.arange(r, dtype=i32), fill)
    ent_col = np.arange(int(fill.sum()), dtype=i32) - np.repeat(row_start,
                                                                fill)
    ent_nbr = res_nbr[ent_row, ent_col]
    inv_ent = np.argsort(ent_nbr, kind="stable").astype(i32)
    inv_ptr = np.zeros(n_cap + 1, i32)
    inv_ptr[1:] = np.cumsum(np.bincount(ent_nbr, minlength=n_cap)[:n_cap])
    rc_pos = np.empty(len(inv_ent), i32)
    rc_pos[inv_ent] = np.arange(len(inv_ent), dtype=i32)
    flat = ent_row.astype(np.int64) * k + ent_col
    # each source's demands, in demand order
    n_src = len(srcs)
    dem_ids = np.argsort(dem_row, kind="stable").astype(i32)
    dem_ptr = np.zeros(n_src + 1, i32)
    dem_ptr[1:] = np.cumsum(np.bincount(dem_row, minlength=n_src)[:n_src])
    node_fill = np.zeros(n_cap, i32)
    node_fill[res_rows[real]] = fill[real]
    host = {"node_fill": node_fill, "res_rows": res_rows,
            "inv_ptr": inv_ptr, "inv_ent": inv_ent, "rc_pos": rc_pos,
            "rs_slot": rs_slot, "row_start": row_start, "ent_row": ent_row,
            "ent_col": ent_col, "ent_nbr": ent_nbr, "ent_lnk": rs_lnk[flat],
            "ent_slot": rs_slot[flat]}
    # each link's slots: shift slots, then residual slots after them
    links = np.concatenate([sh_link, rs_link])
    slot_ids = np.arange(len(links), dtype=i32)
    by_link = np.argsort(links, kind="stable")
    link_ptr = np.zeros(l_cap + 1, i32)
    link_ptr[1:] = np.cumsum(np.bincount(links, minlength=l_cap)[:l_cap])

    def up(a, dtype=torch.int32):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device)

    return TePlan(
        n_cap=int(n_cap), l_cap=int(l_cap), trips=int(trips),
        has_res=bool(has_res), deltas=up(deltas), res_rows=up(res_rows),
        res_nbr=up(res_nbr), sh_flat=up(sh_flat), sh_link=up(sh_link),
        rs_flat=up(rs_flat), rs_link=up(rs_link), srcs=up(srcs),
        dem_row=up(dem_row), dem_dst=up(dem_dst),
        dem_vol=up(np.asarray(dem_vol, np.float32), _F32),
        sh_slot=up(sh_slot), sh_lnk=up(sh_lnk), rs_lnk=up(rs_lnk),
        row_of=up(row_of), inv_ptr=up(inv_ptr), link_ptr=up(link_ptr),
        link_slot=up(slot_ids[by_link]), row_fill=up(fill),
        dem_ptr=up(dem_ptr),
        dem_ids=up(dem_ids), held={"host": host},
    )


def _dims(plan: TePlan) -> tuple[int, int, int, int]:
    """(C classes, S sources, R residual rows, K residual columns)."""
    r, k = plan.res_nbr.shape
    return plan.deltas.numel(), plan.srcs.numel(), r, k


# -- the plain versions -------------------------------------------------------

def _planes(plan: TePlan, theta, fill: float):
    """The reference's float planes: ``fill`` everywhere, theta[link] at
    every live slot; the residual plane ``fill`` on pad rows."""
    c, _, r, k = _dims(plan)
    n = plan.n_cap
    sw = torch.full((c * n,), fill, dtype=theta.dtype, device=theta.device)
    sw[plan.sh_flat.long()] = theta[plan.sh_link.long()]
    sw = sw.view(c, n)
    rw = None
    if plan.has_res:
        rw = torch.full((r * k,), fill, dtype=theta.dtype,
                        device=theta.device)
        rw[plan.rs_flat.long()] = theta[plan.rs_link.long()]
        rw = torch.where((plan.res_rows < 0)[:, None], fill, rw.view(r, k))
    return sw, rw


def _balanced(x, z, y):
    """``lax._balanced_eq(x, z, y)``: x's share of the gradient of
    ``z = min(x, y)`` — 1, or 1/2 at a tie, or 0."""
    one = (x == z).to(x.dtype)
    return one / torch.where(y == z, 2.0, 1.0)


class _Trip:
    """One trip of the relaxation for every source, recomputed from its
    input field ``d`` [S, N] (and, with ``dd``, its tangent along v).
    With ``grads`` it keeps what the adjoint needs: each class's weights
    ``exp(p - L)`` / ``exp(q - L)`` on its two sides (logaddexp's custom
    JVP) and their tangents, the residual softmax and the tie
    coefficients.

    ``torch.logaddexp`` computes ``amax + log1p(exp(-|x1 - x2|))`` for
    finite inputs, as ``jnp.logaddexp`` does, and ``a / -tau`` is the
    reference's ``-a / tau`` to the bit."""

    def __init__(self, plan: TePlan, sw, rw, d, tau, swd=None, rwd=None,
                 dd=None, grads=True):
        tan = dd is not None
        self.cls = []
        acc, acc_t = d, dd
        for k, delta in enumerate(plan.deltas.tolist()):
            x = torch.roll(d + sw[k], delta, dims=-1)
            p, q = acc / -tau, x / -tau
            lse = torch.logaddexp(p, q)
            if grads:
                al, be = torch.exp(p - lse), torch.exp(q - lse)
                saved = [delta, al, be]
                if tan:
                    x_t = torch.roll(dd + swd[k], delta, dims=-1)
                    p_t, q_t = acc_t / -tau, x_t / -tau
                    lse_t = p_t * al + q_t * be
                    acc_t = -tau * lse_t
                    saved += [al * (p_t - lse_t), be * (q_t - lse_t)]
                self.cls.append(saved)
            acc = -tau * lse
        if plan.has_res:
            n = plan.n_cap
            nbr = plan.res_nbr.clamp(0, n - 1).long()
            self.rows = plan.res_rows.clamp(0, n - 1).long()
            y = (d[:, nbr] + rw) / -tau
            m = y.amax(dim=2, keepdim=True)
            m = torch.where(torch.isfinite(m), m, 0.0)
            self.e = torch.exp(y - m)
            self.ssum = self.e.sum(dim=2)
            cand = -tau * (torch.log(self.ssum) + m[..., 0])
            rows = self.rows.expand(cand.shape[0], -1)
            acc2 = acc.scatter_reduce(1, rows, cand, "amin",
                                      include_self=True)
            if grads:
                # _scatter_extremal_jvp's coefficients
                target = acc2.gather(1, rows)
                won = cand == target
                kept = acc.gather(1, rows) == target

                def per_node(vals):
                    return torch.zeros_like(acc).scatter_add(
                        1, rows, vals).gather(1, rows)

                n_upd = per_node(won.to(acc.dtype))
                n_ref = per_node(torch.ones_like(cand))
                self.upd_coef = torch.where(
                    won, torch.where(kept, 1.0 / (n_upd + 1),
                                     1.0 / n_upd), 0.0)
                self.op_coef = (-1.0 + torch.where(
                    kept, 1.0 / (n_upd + 1), 0.0)) / n_ref
                self.nbr = nbr
                if tan:
                    self.y_t = (dd[:, nbr] + rwd) / -tau
                    cand_t = -tau * ((self.e * self.y_t).sum(dim=2)
                                     / self.ssum)
                    acc_t = self._scatter_lin(acc_t, cand_t)
            acc = acc2
        self.out = torch.minimum(acc, d)
        if grads:
            self.c_acc = _balanced(acc, self.out, d)
            self.c_d = _balanced(d, self.out, acc)
            if tan:
                self.out_t = acc_t * self.c_acc + dd * self.c_d

    def _scatter_lin(self, g_op, g_upd):
        """The scatter-min's linearization: operand tangent ``g_op`` [S,
        N], update tangents ``g_upd`` [S, R]."""
        rows = self.rows.expand(g_op.shape[0], -1)
        upd = g_op.gather(1, rows) * self.op_coef + g_upd * self.upd_coef
        return g_op.scatter_add(1, rows, upd)

    def _scatter_lin_t(self, ct):
        """Its transpose: -> (operand cotangent, update cotangents)."""
        rows = self.rows.expand(ct.shape[0], -1)
        at = ct.gather(1, rows)
        return ct.scatter_add(1, rows, at * self.op_coef), at * self.upd_coef

    def adjoint(self, plan: TePlan, lam, lam_t=None):
        """The trip's VJP of ``lam`` (the cotangent of ``out``) — and,
        with ``lam_t``, its tangent along v. -> (lam_in, ct_w [S, C, N],
        ct_r [S, R, K] or None[, lam_in_t, ct_w_t, ct_r_t]): the
        cotangents of the input field and of the planes."""
        tan = lam_t is not None
        g = lam * self.c_acc
        new = lam * self.c_d
        if tan:
            g_t = lam_t * self.c_acc
            new_t = lam_t * self.c_d
        ct_r = ct_r_t = None
        if plan.has_res:
            g, g_c = self._scatter_lin_t(g)
            sg = g_c / self.ssum
            g_z = sg[..., None] * self.e
            new = new.index_add(1, self.nbr.flatten(), g_z.flatten(1))
            ct_r = g_z
            if tan:
                g_t, g_c_t = self._scatter_lin_t(g_t)
                p = self.e / self.ssum[..., None]
                ybar = (p * self.y_t).sum(dim=2, keepdim=True)
                g_z_t = (g_c_t[..., None] * p
                         + g_c[..., None] * (p * (self.y_t - ybar)))
                new_t = new_t.index_add(1, self.nbr.flatten(),
                                        g_z_t.flatten(1))
                ct_r_t = g_z_t
        ct_w = torch.zeros((lam.shape[0], len(self.cls), plan.n_cap),
                           dtype=lam.dtype, device=lam.device)
        ct_w_t = torch.zeros_like(ct_w) if tan else None
        for k in range(len(self.cls) - 1, -1, -1):
            delta, al, be = self.cls[k][:3]
            g_x = g * be
            if tan:
                alt, bet = self.cls[k][3:]
                g_x_t = g_t * be + g * bet
                g_t = g_t * al + g * alt
                back_t = torch.roll(g_x_t, -delta, dims=-1)
                new_t = new_t + back_t
                ct_w_t[:, k] = back_t
            g = g * al
            back = torch.roll(g_x, -delta, dims=-1)
            new = new + back
            ct_w[:, k] = back
        new = new + g
        if not tan:
            return new, ct_w, ct_r
        return new, ct_w, ct_r, new_t + g_t, ct_w_t, ct_r_t


def _seed_fields(plan: TePlan, fields) -> None:
    n = plan.n_cap
    src = plan.srcs.clamp(0, n - 1).long()
    fields[0].fill_(BIG_F)
    fields[0].scatter_(1, src[:, None], 0.0)


def _seed_lam(plan: TePlan, lam) -> None:
    """The cost's cotangent: vol at every demand's (row, dst)."""
    lam.zero_()
    flat = plan.dem_row.long() * plan.n_cap + plan.dem_dst.long()
    lam.view(-1).index_add_(0, flat, plan.dem_vol.to(lam.dtype))


def _slot_ct(plan: TePlan, ct_w, ct_r, ct_sh, ct_rs) -> None:
    """Accumulate a trip's plane cotangents at the theta slots."""
    s = ct_w.shape[0]
    ct_sh += ct_w.reshape(s, -1)[:, plan.sh_flat.long()]
    if ct_r is not None:
        pad = (plan.res_rows < 0).repeat_interleave(ct_r.shape[2])
        ct_r = torch.where(pad, 0.0, ct_r.reshape(s, -1))
        ct_rs += ct_r[:, plan.rs_flat.long()]


def te_relax_plain(plan, theta, fields, tau, seed=True):
    """Plain K13: fields [T + 1, S, N] — trip t + 1 from trip t, for every
    t; with ``seed`` trip 0 first (0 at each source, BIG_F elsewhere)."""
    sw, rw = _planes(plan, theta, BIG_F)
    if seed:
        _seed_fields(plan, fields)
    for t in range(fields.shape[0] - 1):
        fields[t + 1] = _Trip(plan, sw, rw, fields[t], tau,
                              grads=False).out


def te_relax_jvp_plain(plan, theta, v, fields, tfields, tau, seed=True):
    """Plain K15: tfields [T + 1, S, N], the tangent of ``fields`` along
    theta-dot = v; with ``seed`` trip 0's tangent is 0 first."""
    sw, rw = _planes(plan, theta, BIG_F)
    swd, rwd = _planes(plan, v, 0.0)
    if seed:
        tfields[0].zero_()
    for t in range(fields.shape[0] - 1):
        tfields[t + 1] = _Trip(plan, sw, rw, fields[t], tau, swd, rwd,
                               tfields[t]).out_t


def te_relax_vjp_plain(plan, theta, fields, lam, ct_sh, ct_rs, tau,
                       seed=True):
    """Plain K14: back from trip T to trip 0. ``lam`` [S, N] holds the
    cotangent of ``fields[T]`` (with ``seed``: the demands' volumes) and
    leaves with that of ``fields[0]``; ``ct_sh`` [S, n_sh] / ``ct_rs``
    [S, n_rs] gain every trip's cotangent of each theta slot (with
    ``seed`` they start at 0)."""
    sw, rw = _planes(plan, theta, BIG_F)
    if seed:
        _seed_lam(plan, lam)
        ct_sh.zero_()
        ct_rs.zero_()
    for t in range(fields.shape[0] - 2, -1, -1):
        new, ct_w, ct_r = _Trip(plan, sw, rw, fields[t], tau).adjoint(
            plan, lam)
        lam.copy_(new)
        _slot_ct(plan, ct_w, ct_r, ct_sh, ct_rs)


def te_relax_vjp_jvp_plain(plan, theta, v, fields, tfields, lam, lam_t,
                           ct_sh, ct_rs, tau, seed=True):
    """Plain K16: the adjoint sweep of K14 (``lam``) and its tangent
    along v (``lam_t``; 0 at trip T with ``seed``); ``ct_sh`` /
    ``ct_rs`` gain the tangents of the slot cotangents — the gradient of
    ``v . util``."""
    sw, rw = _planes(plan, theta, BIG_F)
    swd, rwd = _planes(plan, v, 0.0)
    if seed:
        _seed_lam(plan, lam)
        lam_t.zero_()
        ct_sh.zero_()
        ct_rs.zero_()
    for t in range(fields.shape[0] - 2, -1, -1):
        trip = _Trip(plan, sw, rw, fields[t], tau, swd, rwd, tfields[t])
        new, _, _, new_t, ct_w_t, ct_r_t = trip.adjoint(plan, lam, lam_t)
        lam.copy_(new)
        lam_t.copy_(new_t)
        _slot_ct(plan, ct_w_t, ct_r_t, ct_sh, ct_rs)


def te_link_sum_plain(plan, ct_sh, ct_rs):
    """Plain K14s: -> [l_cap], each link's slot cotangents summed over
    the sources."""
    out = torch.zeros(plan.l_cap, dtype=ct_sh.dtype, device=ct_sh.device)
    out.index_add_(0, plan.sh_link.long(), ct_sh.sum(dim=0))
    out.index_add_(0, plan.rs_link.long(), ct_rs.sum(dim=0))
    return out


def te_loss_plain(plan, util, last, tau_u):
    """Plain K17: -> ([loss, cost] float32 [2], v [l_cap]) from util
    and the last trip's field ``last`` [S, N]."""
    cost = (plan.dem_vol.to(last.dtype)
            * last[plan.dem_row.long(), plan.dem_dst.long()]).sum()
    u = util / tau_u
    m = u.max()
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(u - m)
    z = e.sum()
    loss = tau_u * (torch.log(z) + m)
    return torch.stack([loss, cost]), e / z


# -- the kernels --------------------------------------------------------------

def _check_tau(tau: float) -> None:
    if not 0.0 < tau <= MAX_TAU:
        raise ValueError(
            f"tau {tau} is outside the kernels' domain (0, {MAX_TAU}]")


# the letters of csrc/te.cu's PLAN_PARAMS, LAYOUT_PARAMS and BUF_PARAMS
_PLAN_SIG = "ti" + "t" * 7 + "i" + "ttTtt" + "i" * 5
_LAYOUT_SIG = "t" * 8 + "i" * 9 + "TTT"
_BUF_SIG = "T" * 10 + "fii"


class AdjLayout(NamedTuple):
    """The adjoint's cluster launch: ``cluster`` blocks a source, each
    owning ``span`` consecutive nodes (the last fewer), ``threads`` a
    block, ``smem`` dynamic shared bytes a block; whether shared memory
    holds a block's own nodes' cotangents and row scalars
    (``own_smem``), the trip's field and tangent (``field_smem``) and the
    class cotangents a block receives (``gx_smem``), each else in device
    memory (the cotangents' own rows, the fields, the plan's held
    scratch)."""

    cluster: int
    span: int
    own_smem: bool
    field_smem: bool
    gx_smem: bool
    smem: int
    threads: int


def adjoint_layout(n_src: int, n_cap: int, n_cls: int, tan: bool,
                   n_sm: int) -> AdjLayout:
    """K14's (``tan`` False) or K16's launch for ``n_src`` sources of
    ``n_cap`` nodes and ``n_cls`` classes on a card of ``n_sm`` SMs: the
    largest cluster (a power of two up to ``MAX_CLUSTER``) whose
    ``n_src * cluster`` blocks fit on the SMs; shared memory holds, each
    where it still fits, a block's own nodes' cotangents and row scalars
    (24 bytes a node, K16 28), the field, then the received class
    cotangents."""
    cs = 1
    while cs < MAX_CLUSTER and 2 * cs * n_src <= n_sm:
        cs *= 2
    span = -(-n_cap // MAX_CLUSTER) * (MAX_CLUSTER // cs)
    f = 4 * (2 if tan else 1)
    smem, fits = 0, []
    for size in ((f + (20 if tan else 16)) * span, f * n_cap,
                 f * n_cls * span):
        fits.append(smem + size <= SMEM_BLOCK)
        smem += size if fits[-1] else 0
    return AdjLayout(cs, span, *fits, smem,
                     min(ADJ_THREADS, -(-span // 32) * 32))


def adjoint_order(node_fill, n_cls: int, lay: AdjLayout) -> np.ndarray:
    """The node at each position of the adjoint's launch ``lay``: a
    block of rank q visits the nodes of its span, position p = i *
    threads + tid in its i-th pass. Its nodes, by row fill (fullest
    first, ties by index), are cut into groups of 32, one warp's rows in
    one pass, and each group goes to the warp with the least work so far
    (longest first; a node's work 3 x fill + 2 x classes: the row's three
    walks and its class chain) that has a pass free. Every warp then
    walks about as many entries, and its 32 lanes rows of one fill. With
    one fill everywhere it is the index order."""
    import heapq

    node_fill = np.asarray(node_fill)
    n = len(node_fill)
    order = np.arange(n, dtype=np.int32)
    tpb, warps = lay.threads, -(-lay.threads // 32)
    for q in range(lay.cluster):
        lo = q * lay.span
        m = min(n, lo + lay.span) - lo
        fills = node_fill[lo:lo + m]
        if m <= 0 or fills.min() == fills.max():
            continue
        nodes = lo + np.argsort(-node_fill[lo:lo + m], kind="stable")
        cost = 3 * node_fill[nodes].astype(np.int64) + 2 * n_cls
        # each warp's passes, with the lanes each takes
        slots = [[] for _ in range(warps)]
        for i in range(-(-m // tpb)):
            for w in range(warps):
                at = i * tpb + w * 32
                if at < m:
                    slots[w].append((at, min(32, m - at, tpb - w * 32)))
        load = [(0, w) for w in range(warps)]
        free = [list(reversed(s)) for s in slots]
        full = [g for g in range(0, m, 32)]
        # the last, partial group takes the partial pass where there is one
        part = [(w, s) for w in range(warps) for s in free[w] if s[1] < 32]
        if part:
            w, s = part[0]
            free[w].remove(s)
            g = m - s[1]
            order[lo + s[0]:lo + s[0] + s[1]] = nodes[g:g + s[1]]
            load[w] = (int(cost[g]), w)
            full = [g for g in full if g < m - s[1]]
        heapq.heapify(load)
        for g in full:
            while True:
                work, w = heapq.heappop(load)
                if free[w]:
                    break
            at, k = free[w].pop()
            order[lo + at:lo + at + k] = nodes[g:g + k]
            heapq.heappush(load, (work + int(cost[g]), w))
    return order


def adjoint_tables(host: dict, n_cls: int, lay: AdjLayout) -> dict:
    """The host tables of the adjoint's launch ``lay`` (``host``: a
    plan's ``held["host"]``): ``order`` (``adjoint_order``); a warp's 32
    positions interleave their entries (each warp's padded to its
    longest): entry c of position P's row at sender index ``e0[P] + 32
    c``, with its neighbour ``snbr`` and link ``slnk`` (-1: none); the
    c-th entry the node at P receives, in ``inv_ent``'s order (by
    receiver, then row-major), at receiver index ``r0[P] + 32 c``, with
    its sender's block rank and index there (``rsrc``: rank << 24 |
    index), link ``rlnk`` and residual theta slot ``rslot`` (-1: none).
    ``es`` / ``er`` are the two index ranges."""
    order = adjoint_order(host["node_fill"], n_cls, lay)
    n = len(order)
    if lay.span >= 1 << 24:
        raise ValueError(f"a span of {lay.span} nodes: rsrc packs 24 bits")
    pos_of = np.empty(n, np.int64)
    pos_of[order] = np.arange(n)
    at = np.arange(n)
    lane = (at - (at // lay.span) * lay.span) % 32
    group = np.unique(at - lane, return_inverse=True)[1]

    def bases(width):
        wide = np.zeros(group.max() + 1, np.int64)
        np.maximum.at(wide, group, width)
        start = np.concatenate([[0], np.cumsum(32 * wide)])
        return start[group] + lane, int(start[-1])

    e0, es = bases(host["node_fill"][order])
    r0, er = bases(np.diff(host["inv_ptr"])[order])
    i32 = np.int32
    snbr = np.zeros(max(es, 1), i32)
    slnk = np.full(max(es, 1), -1, i32)
    rsrc = np.zeros(max(er, 1), i32)
    rlnk = np.full(max(er, 1), -1, i32)
    rslot = np.full(max(er, 1), -1, i32)
    if len(host["ent_row"]):
        sender = host["res_rows"][host["ent_row"]]
        nbr = host["ent_nbr"]
        idx = e0[pos_of[sender]] + 32 * host["ent_col"]
        snbr[idx], slnk[idx] = nbr, host["ent_lnk"]
        rank = host["rc_pos"] - host["inv_ptr"][nbr]
        idx = r0[pos_of[nbr]] + 32 * rank
        owner = sender // lay.span
        rsrc[idx] = (owner << 24) | (sender - owner * lay.span)
        rlnk[idx], rslot[idx] = host["ent_lnk"], host["ent_slot"]
    return {"order": order, "e0": e0.astype(i32), "r0": r0.astype(i32),
            "snbr": snbr, "slnk": slnk, "rsrc": rsrc, "rlnk": rlnk,
            "rslot": rslot, "es": es, "er": er}


@lru_cache(maxsize=None)
def _sm_count(card: int) -> int:
    return torch.cuda.get_device_properties(card).multi_processor_count


def _held(plan: TePlan, key, shape, device) -> torch.Tensor:
    """The plan's scratch ``key`` of ``shape`` on ``device``, allocated
    once."""
    t = plan.held.get(key)
    if t is None or tuple(t.shape) != shape or t.device != device:
        t = plan.held[key] = torch.empty(shape, dtype=_F32, device=device)
    return t


def _check(plan, tau, theta, v, fields, tfields, lam, lam_t, ct_sh, ct_rs):
    c, s, _, _ = _dims(plan)
    if c > MAX_CLASSES:
        raise ValueError(f"{c} shift classes: the kernels take at most "
                         f"{MAX_CLASSES}")
    _check_tau(tau)
    n = plan.n_cap
    want = {"theta": (plan.l_cap,), "v": (plan.l_cap,),
            "fields": (fields.shape[0], s, n),
            "tfields": tuple(fields.shape), "lam": (s, n), "lam_t": (s, n),
            "ct_sh": (s, plan.sh_link.numel()),
            "ct_rs": (s, plan.rs_link.numel())}
    for key, t in zip(want, (theta, v, fields, tfields, lam, lam_t, ct_sh,
                              ct_rs)):
        if t is not None and tuple(t.shape) != want[key]:
            raise ValueError(f"{key} has shape {tuple(t.shape)}, not "
                             f"{want[key]}")


def _plan_args(plan: TePlan) -> tuple:
    c, s, _, k = _dims(plan)
    return (plan.deltas, c, plan.sh_slot, plan.sh_lnk, plan.row_of,
            plan.res_nbr, plan.rs_lnk, plan.row_fill, plan.inv_ptr, k,
            plan.srcs, plan.dem_dst, plan.dem_vol, plan.dem_ptr,
            plan.dem_ids, s, plan.n_cap, int(plan.has_res),
            plan.sh_link.numel(), plan.rs_link.numel())


def _launch(name, plan, tau, seed, theta, v, fields, tfields=None) -> None:
    """Launch K13 or K15: the plan's tables, then the kernel's buffers (an
    absent one passes a null pointer), ``tau``, the trip count and
    ``seed``."""
    _check(plan, tau, theta, v, fields, tfields, None, None, None, None)
    cuda.launch("te", name, _PLAN_SIG + _BUF_SIG, *_plan_args(plan), theta,
                v, fields, tfields, *[None] * 6, float(tau),
                fields.shape[0] - 1, int(seed))


def _launch_adjoint(name, plan, tau, seed, theta, v, fields, tfields, lam,
                    lam_t, ct_sh, ct_rs) -> None:
    """Launch K14 (``lam_t`` None) or K16 as one cluster launch
    (``adjoint_layout`` on the card of ``lam``) with that layout's
    tables (``adjoint_tables``) and scratch, held by the plan and shared
    by K14 and K16: the class and entry weights (one table for every
    source, 2 (es + er + C n_cap) float32), each source's slot
    cotangents by receiver index and class word ([S, er + C n_cap]) and,
    where shared memory does not hold them, the class cotangents
    received and the row scalars."""
    _check(plan, tau, theta, v, fields, tfields, lam, lam_t, ct_sh, ct_rs)
    c, s, _, _ = _dims(plan)
    dev = lam.device
    lay = adjoint_layout(s, plan.n_cap, c, lam_t is not None,
                         _sm_count(dev.index or 0))
    tabs = plan.held.get((lay.cluster, lay.span, lay.threads))
    if tabs is None or tabs["order"].device != dev:
        host = adjoint_tables(plan.held["host"], c, lay)
        tabs = {k: torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray)
                else a for k, a in host.items()}
        n = plan.n_cap
        tabs["tab"] = torch.empty(2 * (tabs["es"] + tabs["er"] + c * n),
                                  dtype=_F32, device=dev)
        tabs["scr"] = torch.empty((s, tabs["er"] + c * n), dtype=_F32,
                                  device=dev)
        plan.held[lay.cluster, lay.span, lay.threads] = tabs
    gx = own = None
    if not lay.gx_smem:
        gx = _held(plan, ("gx", lay.cluster),
                   (2, s * lay.cluster * c * lay.span), dev)
    if not lay.own_smem:
        own = _held(plan, ("own", lay.cluster),
                    (s * lay.cluster * -(-5 * lay.span // 4) * 4,), dev)
    cuda.launch(
        "te", name, _PLAN_SIG + _LAYOUT_SIG + _BUF_SIG, *_plan_args(plan),
        *(tabs[k] for k in ("order", "e0", "r0", "snbr", "slnk", "rsrc",
                            "rlnk", "rslot")),
        tabs["es"], tabs["er"], lay.cluster, lay.span, int(lay.own_smem),
        int(lay.field_smem), int(lay.gx_smem), lay.smem, lay.threads,
        tabs["tab"], tabs["scr"], own, theta, v, fields, tfields, lam,
        lam_t, None if gx is None else gx[0],
        None if gx is None or lam_t is None else gx[1], ct_sh, ct_rs,
        float(tau), fields.shape[0] - 1, int(seed))


def te_relax(plan, theta, fields, tau, seed=True):
    """K13 (see ``te_relax_plain``)."""
    if _is_cpu(theta):
        return te_relax_plain(plan, theta, fields, tau, seed)
    _launch("te_relax", plan, tau, seed, theta, None, fields)
    te_relax.launches += 1


def te_relax_jvp(plan, theta, v, fields, tfields, tau, seed=True):
    """K15 (see ``te_relax_jvp_plain``)."""
    if _is_cpu(theta):
        return te_relax_jvp_plain(plan, theta, v, fields, tfields, tau, seed)
    _launch("te_relax_jvp", plan, tau, seed, theta, v, fields, tfields)
    te_relax_jvp.launches += 1


def te_relax_vjp(plan, theta, fields, lam, ct_sh, ct_rs, tau, seed=True):
    """K14 (see ``te_relax_vjp_plain``): one cluster launch."""
    if _is_cpu(theta):
        return te_relax_vjp_plain(plan, theta, fields, lam, ct_sh, ct_rs,
                                  tau, seed)
    _launch_adjoint("te_relax_vjp", plan, tau, seed, theta, None, fields,
                    None, lam, None, ct_sh, ct_rs)
    te_relax_vjp.launches += 1


def te_relax_vjp_jvp(plan, theta, v, fields, tfields, lam, lam_t, ct_sh,
                     ct_rs, tau, seed=True):
    """K16 (see ``te_relax_vjp_jvp_plain``): one cluster launch."""
    if _is_cpu(theta):
        return te_relax_vjp_jvp_plain(plan, theta, v, fields, tfields, lam,
                                      lam_t, ct_sh, ct_rs, tau, seed)
    _launch_adjoint("te_relax_vjp_jvp", plan, tau, seed, theta, v, fields,
                    tfields, lam, lam_t, ct_sh, ct_rs)
    te_relax_vjp_jvp.launches += 1


def te_link_sum(plan, ct_sh, ct_rs):
    """K14s (see ``te_link_sum_plain``): one thread a link sums its
    slots, each over the sources in order — no atomics, the same bits
    every run."""
    if _is_cpu(ct_sh):
        return te_link_sum_plain(plan, ct_sh, ct_rs)
    s = plan.srcs.numel()
    if (tuple(ct_sh.shape) != (s, plan.sh_link.numel())
            or tuple(ct_rs.shape) != (s, plan.rs_link.numel())):
        raise ValueError("slot cotangents must be [sources, slots]")
    out = torch.empty(plan.l_cap, dtype=_F32, device=ct_sh.device)
    cuda.launch("te", "te_link_sum", "TTttTiiii", ct_sh, ct_rs,
                plan.link_ptr, plan.link_slot, out, ct_sh.shape[1],
                ct_rs.shape[1], plan.srcs.numel(), plan.l_cap)
    te_link_sum.launches += 1
    return out


def te_loss(plan, util, last, tau_u):
    """K17 (see ``te_loss_plain``): one block, fixed-order tree sums."""
    if _is_cpu(util):
        return te_loss_plain(plan, util, last, tau_u)
    if (tuple(util.shape) != (plan.l_cap,)
            or tuple(last.shape) != (plan.srcs.numel(), plan.n_cap)):
        raise ValueError("util must be [l_cap], the field [sources, n_cap]")
    out = torch.empty(2, dtype=_F32, device=util.device)
    v = torch.empty_like(util)
    cuda.launch("te", "te_loss", "TiTttTiifTT",
                util, util.numel(), last, plan.dem_row, plan.dem_dst,
                plan.dem_vol, plan.dem_row.numel(), plan.n_cap, float(tau_u),
                out, v)
    te_loss.launches += 1
    return out, v


for _fn in (te_relax, te_relax_jvp, te_relax_vjp, te_relax_vjp_jvp,
            te_link_sum, te_loss):
    _fn.launches = 0


# -- the step -----------------------------------------------------------------

def _step(plan, theta, tau, tau_u, relax, vjp, link_sum, loss_fn, jvp,
          vjp_jvp):
    c, s, _, _ = _dims(plan)
    n, dev = plan.n_cap, theta.device

    def empty(*shape):
        return torch.empty(shape, dtype=theta.dtype, device=dev)

    fields = empty(plan.trips + 1, s, n)
    relax(plan, theta, fields, tau)
    lam = empty(s, n)
    ct_sh, ct_rs = empty(s, plan.sh_link.numel()), empty(
        s, plan.rs_link.numel())
    vjp(plan, theta, fields, lam, ct_sh, ct_rs, tau)
    util = link_sum(plan, ct_sh, ct_rs)
    lc, v = loss_fn(plan, util, fields[-1], tau_u)
    tfields = torch.empty_like(fields)
    jvp(plan, theta, v, fields, tfields, tau)
    lam_t = empty(s, n)
    vjp_jvp(plan, theta, v, fields, tfields, lam, lam_t, ct_sh, ct_rs, tau)
    grad = link_sum(plan, ct_sh, ct_rs)
    return lc[0], grad, util, lc[1]


def te_step(plan: TePlan, theta, tau: float, tau_util: float):
    """One TE step, as the JAX ``te_step`` executable: -> (loss, grad
    [l_cap], util [l_cap], cost), float32 (loss and cost 0-d). On CUDA
    tensors every stage is one of the kernels above; on CPU tensors
    their plain versions."""
    return _step(plan, theta, float(tau), float(tau_util), te_relax,
                 te_relax_vjp, te_link_sum, te_loss, te_relax_jvp,
                 te_relax_vjp_jvp)


def te_step_plain(plan: TePlan, theta, tau: float, tau_util: float):
    """``te_step`` through the plain versions only (any device)."""
    return _step(plan, theta, float(tau), float(tau_util), te_relax_plain,
                 te_relax_vjp_plain, te_link_sum_plain, te_loss_plain,
                 te_relax_jvp_plain, te_relax_vjp_jvp_plain)
