"""What-if engine: batched N-k failure sweeps, drain previews and
gradient-descent link-weight optimization on the solver's resident graph
(the port of the JAX package's ``decision/whatif.py``).

The engine is a read-only consumer of ``GpuSpfSolver``'s device state:
it syncs the area through the solver's own ``_sync_area`` (a sweep never
re-uploads a graph the card holds), expresses each scenario as a handful
of flat slot overrides (shift slot ``k * n_cap + u``, residual slot
``row * kr_cap + col``, the addressing of ``edgeplan.drain_dirty``), and
ships a whole batch through ONE ``ops/sweep.sweep`` dispatch: K10
overlays, K1s seeds, K1 rounds with a lane axis, K12 verdicts. The host
pulls O(scenarios) ints.

Isolation contract: everything here may fail — an armed
``solver.whatif`` fault, an out-of-memory on an oversized batch, a stale
snapshot — and none of it may touch the live solver's health.

Scenario kinds:
  fail        one or more links down (both directed slots -> INF)
  drain_node  every out-edge of a node -> INF (its in-edges stand, as a
              transit drain; drain previews look AT it, not FROM it)
  drain_link  alias of fail for a single link

``optimize`` (``plan_optimize`` + ``OptimizeJob.run``) runs the softmin
TE surrogate of ``ops/te.py``: one ``te_step`` a gradient step, its trip
count bounded by a baseline sweep of the demand sources.
"""

from __future__ import annotations

import itertools
import time
from typing import Optional

import numpy as np
import torch

from openr_tpu_torch.ops.edgeplan import (
    MAX_METRIC,
    _ensure_edge_loc,
    _next_pow2,
    edge_loc_of,
)
from openr_tpu_torch.ops.relax import INF_E, UNROLL
from openr_tpu_torch.ops.sweep import sweep, sweep_max_trips
from openr_tpu_torch.ops.te import te_plan, te_step
from openr_tpu_torch.runtime.counters import counters
from openr_tpu_torch.runtime.faults import maybe_fail
from openr_tpu_torch.runtime.tracing import tracer

# sweep batch sizing rides the fused live dispatch's knob
# (GpuSpfSolver.fuse_n_cap): here it bounds the sweep's distance planes
# to fuse_n_cap * _LANE_ROWS int32 words a dispatch (32 MB at the 4096
# default). A grid-1k N-1 sweep (~2k scenarios) fits one dispatch.
_LANE_ROWS = 2048

# traces close with this status, so what-if round trips never enter the
# convergence statistics (only "ok" closes count there)
_TRACE_STATUS = "whatif"


def _link_name(link) -> str:
    return f"{link.n1}|{link.n2}"


class Scenario:
    """One hypothetical topology: a named set of directed-edge weight
    overrides derived from failed links or a drained node."""

    __slots__ = ("name", "kind", "links", "node")

    def __init__(self, name: str, kind: str, links=(), node: str = ""):
        self.name = name
        self.kind = kind
        self.links = tuple(links)
        self.node = node


class _Chunk:
    """One batched device dispatch: lane 0 is the identity overlay (the
    baseline), lanes 1..n carry scenarios."""

    def __init__(self, job: "SweepJob", scenarios: list[Scenario],
                 overlays: list[tuple[list, list]]):
        self.job = job
        self.scenarios = scenarios
        self._overlays = overlays
        self._out = None

    def dispatch(self) -> None:
        maybe_fail("solver.whatif")
        job = self.job
        plan = job.plan
        n_cap, s_cap = plan.n_cap, plan.s_cap
        r_cap, kr_cap = plan.res_nbr.shape
        has_res = plan.k_res > 0
        # fixed-size overlays: lanes and slots pad to pow2 buckets, as
        # the reference's executable cache keys them
        b_pad = _next_pow2(1 + len(self.scenarios), 2)
        es = _next_pow2(max([4] + [len(s) for s, _ in self._overlays]), 4)
        er = _next_pow2(max([4] + [len(r) for _, r in self._overlays]), 4)
        # pad slots point one past the raveled plane and drop
        sh_idx = np.full((b_pad, es), s_cap * n_cap, np.int32)
        sh_val = np.zeros((b_pad, es), np.int32)
        rs_idx = np.full((b_pad, er), r_cap * kr_cap, np.int32)
        rs_val = np.zeros((b_pad, er), np.int32)
        for i, (s_pairs, r_pairs) in enumerate(self._overlays):
            for j, (flat, val) in enumerate(s_pairs):
                sh_idx[i + 1, j] = flat
                sh_val[i + 1, j] = val
            for j, (flat, val) in enumerate(r_pairs):
                rs_idx[i + 1, j] = flat
                rs_val[i + 1, j] = val
        # synchronous rounds whatever the solver's kernel: the reference's
        # bucketed sweep branch never runs (ROADMAP C8)
        name = (
            f"sweep[b={b_pad},r={len(job.roots)},n={n_cap},s={s_cap}"
            + (",res" if has_res else "")
            + (",dist" if job.return_dist else "")
            + "]"
        )
        ad = job.ad
        mirror = ad.single()
        dev = mirror[1].device

        def up(a):
            return torch.from_numpy(a).to(dev)

        with tracer.span(
            job.ctx, "whatif.dispatch", kernel=name,
            scenarios=len(self.scenarios),
        ):
            self._out = sweep(
                *mirror, job.roots_dev, up(sh_idx), up(sh_val), up(rs_idx),
                up(rs_val), has_res=has_res,
                max_trips=sweep_max_trips(n_cap),
                return_dist=job.return_dist,
            )
        counters.increment("whatif.device.batched_dispatches")
        counters.increment(
            "whatif.device.batched_scenarios", len(self.scenarios)
        )

    def collect(self) -> list[dict]:
        unreachable, stretch, changed = (
            x.cpu().numpy() for x in self._out[:3]
        )
        if self.job.return_dist:
            self.job.dist_planes.append(self._out[4].cpu().numpy())
        self.job.trips = max(self.job.trips, int(self._out[3]))
        self.job.rounds = max(self.job.rounds, int(self._out[-1]))
        self._out = None
        rows = []
        for i, scen in enumerate(self.scenarios, start=1):
            u = int(unreachable[i])
            rows.append({
                "scenario": scen.name,
                "kind": scen.kind,
                "unreachable_pairs": u,
                "max_stretch": int(stretch[i]),
                "changed_nodes": int(changed[i]),
                "partitioned": u > 0,
            })
        return rows


class SweepJob:
    """A planned sweep: scenarios enumerated, snapshot taken, chunks
    ready to dispatch. ``run()`` drives them inline."""

    def __init__(self, engine, area, ad, roots, root_names,
                 return_dist, ctx, meta):
        self.engine = engine
        self.area = area
        self.ad = ad
        self.plan = ad.plan
        self.roots = roots
        self.root_names = root_names
        self.roots_dev = None
        self.return_dist = return_dist
        self.ctx = ctx
        self.meta = meta
        self.chunks: list[_Chunk] = []
        self.dist_planes: list[np.ndarray] = []
        self.trips = 0
        self.rounds = 0
        self._t0 = time.perf_counter()

    def result(self, rows: list[dict]) -> dict:
        rows.sort(
            key=lambda r: (
                r["partitioned"], r["unreachable_pairs"], r["max_stretch"]
            ),
            reverse=True,
        )
        ms = (time.perf_counter() - self._t0) * 1e3
        counters.add_stat_value("whatif.sweep_ms", ms)
        counters.increment("whatif.scenarios", len(rows))
        out = {
            **self.meta,
            "area": self.area,
            "roots": self.root_names,
            "scenarios": len(rows),
            "dispatches": len(self.chunks),
            "partitioned": sum(r["partitioned"] for r in rows),
            "trips": self.trips,
            "sweep_ms": round(ms, 2),
            "rows": rows,
        }
        tracer.end_trace(
            self.ctx, status=_TRACE_STATUS,
            scenarios=len(rows), dispatches=len(self.chunks),
        )
        self.ctx = None
        return out

    def fail(self) -> None:
        tracer.end_trace(self.ctx, status="error")
        self.ctx = None

    def run(self) -> dict:
        try:
            rows = []
            for ch in self.chunks:
                ch.dispatch()
                rows.extend(ch.collect())
            return self.result(rows)
        except Exception:
            self.fail()
            raise


class WhatIfEngine:
    """Scenario planner over a GpuSpfSolver's resident per-area mirrors.
    Stateless between calls apart from the solver it reads."""

    def __init__(self, solver, my_node_name: Optional[str] = None):
        self.solver = solver
        self.my_node_name = my_node_name or solver.my_node_name

    # -- snapshot ----------------------------------------------------------

    def _pick_area(self, area, area_link_states) -> str:
        if area:
            if area not in area_link_states:
                raise ValueError(f"unknown area {area!r}")
            return area
        cands = sorted(
            a for a, ls in area_link_states.items()
            if ls.has_node(self.my_node_name)
        ) or sorted(area_link_states)
        if not cands:
            raise ValueError("no areas in the LSDB")
        return cands[0]

    def _snapshot(self, area, area_link_states, prefix_state):
        """Sync the area through the solver's own path (the dirty-slot
        scatter when the mirror is current — no graph re-upload) and
        hand back its _AreaDev."""
        solver = self.solver
        fast_by_area, *_ = solver._partition_prefixes(
            prefix_state, area_link_states
        )
        ad = solver._sync_area(
            area, area_link_states[area], prefix_state,
            fast_by_area.get(area, []),
        )
        _ensure_edge_loc(ad.plan)
        return ad

    def _resolve_roots(self, plan, roots) -> tuple[np.ndarray, list[str]]:
        names = list(roots) if roots else [self.my_node_name]
        idx = []
        for n in names:
            i = plan.node_index.get(n)
            if i is None:
                raise ValueError(f"vantage {n!r} not in this area")
            idx.append(i)
        return np.asarray(idx, np.int32), names

    def _batch_cap(self, n_cap: int, r: int) -> int:
        fuse = int(getattr(self.solver, "fuse_n_cap", 4096))
        return max(2, (fuse * _LANE_ROWS) // max(1, n_cap * r))

    def _roots_dev(self, root_idx: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(root_idx).to(self.solver.device)

    # -- overlay construction ---------------------------------------------

    def _fail_directed(self, plan, pairs, link, src) -> bool:
        loc = edge_loc_of(plan, link, src)
        if loc is None:
            return False
        kind, a, b = loc
        if kind == "s":
            pairs[0].append((a * plan.n_cap + b, INF_E))
        else:
            pairs[1].append((a * plan.res_nbr.shape[1] + b, INF_E))
        return True

    def _overlay(self, plan, link_state, scen: Scenario):
        """-> ([(shift_flat, val)], [(res_flat, val)]) or None when a
        touched edge has no slot (mid-rebuild) — the scenario is skipped
        and counted, never guessed at."""
        pairs: tuple[list, list] = ([], [])
        ok = True
        if scen.kind in ("fail", "drain_link"):
            for link in scen.links:
                ok &= self._fail_directed(plan, pairs, link, link.n1)
                ok &= self._fail_directed(plan, pairs, link, link.n2)
        elif scen.kind == "drain_node":
            for link in link_state.ordered_links_from_node(scen.node):
                if link.is_up():
                    ok &= self._fail_directed(plan, pairs, link, scen.node)
        else:
            raise ValueError(f"unknown scenario kind {scen.kind!r}")
        return pairs if ok else None

    # -- sweeps ------------------------------------------------------------

    def plan_sweep(self, area_link_states, prefix_state, order: int = 1,
                   area: Optional[str] = None, roots=None,
                   max_scenarios: int = 0,
                   return_dist: bool = False) -> SweepJob:
        """Enumerate N-``order`` link-failure scenarios and stage them
        into batched dispatches. order=1 sweeps every up link; order=2
        every unordered pair as well (quadratic: cap it with
        max_scenarios)."""
        maybe_fail("solver.whatif")
        if order not in (1, 2):
            raise ValueError("sweep order must be 1 or 2")
        area = self._pick_area(area, area_link_states)
        link_state = area_link_states[area]
        ctx = tracer.start_trace(
            "whatif.sweep", node=self.my_node_name, area=area, order=order,
        )
        try:
            with tracer.span(ctx, "whatif.snapshot"):
                ad = self._snapshot(area, area_link_states, prefix_state)
            plan = ad.plan
            root_idx, root_names = self._resolve_roots(plan, roots)

            links = [
                ln for ln in link_state.ordered_all_links() if ln.is_up()
            ]
            scens = [
                Scenario(_link_name(ln), "fail", (ln,)) for ln in links
            ]
            if order == 2:
                scens += [
                    Scenario(
                        f"{_link_name(a_)}+{_link_name(b_)}", "fail",
                        (a_, b_),
                    )
                    for a_, b_ in itertools.combinations(links, 2)
                ]
            truncated = 0
            if max_scenarios and len(scens) > max_scenarios:
                truncated = len(scens) - max_scenarios
                scens = scens[:max_scenarios]
                counters.increment("whatif.truncated_scenarios", truncated)

            job = SweepJob(
                self, area, ad, root_idx, root_names, return_dist, ctx,
                meta={"order": order, "truncated": truncated},
            )
            job.roots_dev = self._roots_dev(root_idx)
            kept: list[Scenario] = []
            overlays: list[tuple[list, list]] = []
            skipped = 0
            for scen in scens:
                ov = self._overlay(plan, link_state, scen)
                if ov is None:
                    skipped += 1
                    continue
                kept.append(scen)
                overlays.append(ov)
            if skipped:
                counters.increment("whatif.skipped_scenarios", skipped)
                job.meta["skipped"] = skipped
            cap = self._batch_cap(plan.n_cap, len(root_idx))
            for i in range(0, max(1, len(kept)), cap):
                job.chunks.append(
                    _Chunk(job, kept[i:i + cap], overlays[i:i + cap])
                )
            counters.increment("whatif.sweeps")
            return job
        except Exception:
            tracer.end_trace(ctx, status="error")
            raise

    def sweep(self, area_link_states, prefix_state, **kw) -> dict:
        return self.plan_sweep(area_link_states, prefix_state, **kw).run()

    # -- drain preview -----------------------------------------------------

    def drain(self, area_link_states, prefix_state,
              node: Optional[str] = None, link: Optional[str] = None,
              area: Optional[str] = None, roots=None,
              top: int = 10) -> dict:
        """Impact preview for draining a node or a link ("n1|n2"), seen
        from the vantage roots: the verdicts plus the ``top`` most
        affected destinations with their metrics before and after."""
        maybe_fail("solver.whatif")
        if bool(node) == bool(link):
            raise ValueError("specify exactly one of node= or link=")
        t0 = time.perf_counter()
        area = self._pick_area(area, area_link_states)
        link_state = area_link_states[area]
        ctx = tracer.start_trace(
            "whatif.drain", node=self.my_node_name, area=area,
            target=node or link,
        )
        try:
            with tracer.span(ctx, "whatif.snapshot"):
                ad = self._snapshot(area, area_link_states, prefix_state)
            plan = ad.plan
            root_idx, root_names = self._resolve_roots(plan, roots)
            if node:
                if not link_state.has_node(node):
                    raise ValueError(f"unknown node {node!r}")
                scen = Scenario(f"drain:{node}", "drain_node", node=node)
            else:
                want = set(link.split("|", 1))
                match = next(
                    (
                        ln for ln in link_state.ordered_all_links()
                        if {ln.n1, ln.n2} == want
                    ),
                    None,
                )
                if match is None:
                    raise ValueError(f"no link {link!r} (want 'n1|n2')")
                scen = Scenario(
                    f"drain:{_link_name(match)}", "drain_link", (match,)
                )
            ov = self._overlay(plan, link_state, scen)
            if ov is None:
                raise RuntimeError(
                    "edge slots not mapped yet (plan mid-rebuild); retry"
                )
            job = SweepJob(
                self, area, ad, root_idx, root_names, True, ctx, meta={},
            )
            job.roots_dev = self._roots_dev(root_idx)
            chunk = _Chunk(job, [scen], [ov])
            job.chunks.append(chunk)
            chunk.dispatch()
            rows = chunk.collect()
            dist = job.dist_planes[0]  # [B, R, N]
            base, after = dist[0], dist[1]
            impact = []
            n = plan.n_nodes
            for ri, rname in enumerate(root_names):
                b_, a_ = base[ri, :n], after[ri, :n]
                delta = np.where(
                    (b_ < INF_E) & (a_ < INF_E), a_ - b_, 0
                )
                lost = (b_ < INF_E) & (a_ >= INF_E)
                order_ = np.argsort(-(delta + lost * INF_E))[:top]
                for i in order_:
                    if not lost[i] and delta[i] <= 0:
                        break
                    impact.append({
                        "root": rname,
                        "node": plan.node_names[i],
                        "before": int(b_[i]),
                        "after": None if lost[i] else int(a_[i]),
                        "stretch": None if lost[i] else int(delta[i]),
                        "unreachable": bool(lost[i]),
                    })
            ms = (time.perf_counter() - t0) * 1e3
            counters.increment("whatif.drains")
            counters.add_stat_value("whatif.drain_ms", ms)
            out = {
                "area": area,
                "target": node or link,
                "roots": root_names,
                "drain_ms": round(ms, 2),
                **rows[0],
                "impacted": impact,
            }
            tracer.end_trace(ctx, status=_TRACE_STATUS)
            return out
        except Exception:
            tracer.end_trace(ctx, status="error")
            raise

    # -- differentiable TE -------------------------------------------------

    def plan_optimize(self, area_link_states, prefix_state, demands,
                      area: Optional[str] = None, iters: int = 40,
                      lr: float = 2.0, tau: float = 1.0,
                      tau_util: Optional[float] = None) -> "OptimizeJob":
        """Stage a gradient-descent link-weight optimization against an
        operator demand matrix ([{src, dst, volume}]). Planning reads
        the LSDB; the returned job's run() touches only device/host
        arrays."""
        maybe_fail("solver.whatif")
        if not demands:
            raise ValueError("empty demand matrix")
        area = self._pick_area(area, area_link_states)
        ctx = tracer.start_trace(
            "whatif.optimize", node=self.my_node_name, area=area,
            demands=len(demands), iters=iters,
        )
        try:
            with tracer.span(ctx, "whatif.snapshot"):
                ad = self._snapshot(area, area_link_states, prefix_state)
            plan = ad.plan
            n_cap = plan.n_cap
            kr_cap = plan.res_nbr.shape[1]

            links = [ln for ln in plan._links_sorted if ln.is_up()]
            if not links:
                raise ValueError("no up links to optimize")
            theta0, sh_idx, sh_link, rs_idx, rs_link = [], [], [], [], []
            link_names = []
            for li, ln in enumerate(links):
                link_names.append(_link_name(ln))
                theta0.append(
                    float(min(ln.metric_from_node(ln.n1), MAX_METRIC))
                )
                for src in (ln.n1, ln.n2):
                    loc = edge_loc_of(plan, ln, src)
                    if loc is None:
                        continue
                    kind, a, b = loc
                    # skip slots the mirror holds at INF (drained src):
                    # the optimizer must not resurrect them
                    if kind == "s":
                        if plan.shift_w[a, b] >= INF_E:
                            continue
                        sh_idx.append(a * n_cap + b)
                        sh_link.append(li)
                    else:
                        if plan.res_w[a, b] >= INF_E:
                            continue
                        rs_idx.append(a * kr_cap + b)
                        rs_link.append(li)

            dem, bad = [], []
            for d in demands:
                si = plan.node_index.get(d["src"])
                di = plan.node_index.get(d["dst"])
                if si is None or di is None or si == di:
                    bad.append(d)
                    continue
                dem.append((si, di, float(d.get("volume", 1.0))))
            if not dem:
                raise ValueError("no resolvable demands in this area")

            # baseline int sweep (identity overlay) for the measured trip
            # bound: the float surrogate's scan length rides the real
            # diameter instead of a blind n_cap (the port's sweep always
            # runs synchronous rounds, as the reference's forced one)
            base_job = SweepJob(
                self, area, ad,
                np.asarray(sorted({s for s, _, _ in dem}), np.int32),
                [], True, ctx, meta={},
            )
            base_job.roots_dev = self._roots_dev(base_job.roots)
            base_chunk = _Chunk(base_job, [], [])
            base_job.chunks.append(base_chunk)
            base_chunk.dispatch()
            base_chunk.collect()
            base = base_job.dist_planes[0][0]  # [S, N]
            src_row = {
                int(s): i for i, s in enumerate(base_job.roots)
            }
            reachable = []
            for si, di, vol in dem:
                if base[src_row[si], di] >= INF_E:
                    bad.append({"src_idx": si, "dst_idx": di})
                    continue
                reachable.append((si, di, vol))
            if not reachable:
                raise ValueError("no demand pair is reachable")
            trips = min(256, max(8, base_job.trips * UNROLL + 2))

            return OptimizeJob(
                self, area, ad, ctx, link_names,
                np.asarray(theta0, np.float32),
                np.asarray(sh_idx, np.int32), np.asarray(sh_link, np.int32),
                np.asarray(rs_idx, np.int32), np.asarray(rs_link, np.int32),
                reachable, src_row, bad, trips,
                iters=int(iters), lr=float(lr), tau=float(tau),
                tau_util=float(tau_util or tau),
            )
        except Exception:
            tracer.end_trace(ctx, status="error")
            raise

    def optimize(self, area_link_states, prefix_state, demands,
                 **kw) -> dict:
        return self.plan_optimize(
            area_link_states, prefix_state, demands, **kw
        ).run()


class OptimizeJob:
    """Gradient-descent loop over the softmin TE surrogate. No LSDB
    access after planning: run() is executor-safe."""

    def __init__(self, engine, area, ad, ctx, link_names, theta0,
                 sh_idx, sh_link, rs_idx, rs_link, demands, src_row,
                 rejected, trips, iters, lr, tau, tau_util):
        self.engine = engine
        self.area = area
        self.ad = ad
        self.ctx = ctx
        self.link_names = link_names
        self.theta0 = theta0
        self.sh = (sh_idx, sh_link)
        self.rs = (rs_idx, rs_link)
        self.demands = demands
        self.src_row = src_row
        self.rejected = rejected
        self.trips = trips
        self.iters = iters
        self.lr = lr
        self.tau = tau
        self.tau_util = tau_util

    def arrays(self) -> tuple:
        """The reference job's padded step inputs: -> (theta [l_cap],
        sh_idx, sh_link [es], rs_idx, rs_link [er], srcs [s_cap], dem_row,
        dem_dst [d_cap] int32, dem_vol [d_cap] float32), numpy."""
        plan = self.ad.plan
        n_cap, s_cap = plan.n_cap, plan.s_cap
        r_cap, kr_cap = plan.res_nbr.shape
        L = len(self.theta0)
        l_cap = _next_pow2(L, 4)
        es = _next_pow2(max(1, len(self.sh[0])), 4)
        er = _next_pow2(max(1, len(self.rs[0])), 4)
        srcs = np.asarray(
            sorted({s for s, _, _ in self.demands}), np.int32
        )
        row_of = {int(s): i for i, s in enumerate(srcs)}
        s_cap_d = _next_pow2(len(srcs), 2)
        d_cap = _next_pow2(len(self.demands), 2)

        theta = np.ones(l_cap, np.float32)
        theta[:L] = self.theta0
        sh_idx = np.full(es, s_cap * n_cap, np.int32)
        sh_idx[: len(self.sh[0])] = self.sh[0]
        sh_link = np.zeros(es, np.int32)
        sh_link[: len(self.sh[1])] = self.sh[1]
        rs_idx = np.full(er, r_cap * kr_cap, np.int32)
        rs_idx[: len(self.rs[0])] = self.rs[0]
        rs_link = np.zeros(er, np.int32)
        rs_link[: len(self.rs[1])] = self.rs[1]
        srcs_p = np.zeros(s_cap_d, np.int32)
        srcs_p[: len(srcs)] = srcs
        dem_row = np.zeros(d_cap, np.int32)
        dem_dst = np.zeros(d_cap, np.int32)
        dem_vol = np.zeros(d_cap, np.float32)
        for i, (si, di, vol) in enumerate(self.demands):
            dem_row[i] = row_of[si]
            dem_dst[i] = di
            dem_vol[i] = vol
        return (theta, sh_idx, sh_link, rs_idx, rs_link, srcs_p, dem_row,
                dem_dst, dem_vol)

    def te_plan(self):
        """-> (the step's ``TePlan`` on the area's device, theta0 padded
        to l_cap, numpy)."""
        plan = self.ad.plan
        (theta, sh_idx, sh_link, rs_idx, rs_link, srcs_p, dem_row,
         dem_dst, dem_vol) = self.arrays()
        tp = te_plan(
            plan.deltas, plan.res_rows, plan.res_nbr, sh_idx, sh_link,
            rs_idx, rs_link, srcs_p, dem_row, dem_dst, dem_vol,
            n_cap=plan.n_cap, l_cap=len(theta), trips=self.trips,
            has_res=plan.k_res > 0, device=self.ad.single()[1].device,
        )
        return tp, theta

    def run(self) -> dict:
        t0 = time.perf_counter()
        try:
            L = len(self.theta0)
            tp, theta = self.te_plan()
            dev = tp.srcs.device
            name = (
                f"te_step[l={tp.l_cap},s={tp.srcs.numel()},"
                f"d={tp.dem_row.numel()},n={tp.n_cap},t={self.trips}"
                + (",res" if tp.has_res else "") + "]"
            )

            def step(th):
                loss, grad, util, cost = te_step(
                    tp, torch.from_numpy(th).to(dev), self.tau,
                    self.tau_util,
                )
                return (float(loss), grad.cpu().numpy(), util.cpu().numpy(),
                        float(cost))

            util0 = None
            loss_curve = []
            with tracer.span(
                self.ctx, "whatif.gd", kernel=name, iters=self.iters,
            ):
                for it in range(self.iters):
                    loss, grad, util, _ = step(theta)
                    if util0 is None:
                        util0 = util
                    loss_curve.append(round(loss, 4))
                    theta = np.clip(
                        theta - self.lr * grad, 1.0, float(MAX_METRIC),
                    ).astype(np.float32)
            # final utilization under the proposed weights
            _, _, util1, _ = step(theta)
            before = float(util0[:L].max()) if L else 0.0
            after = float(util1[:L].max()) if L else 0.0
            proposed = np.clip(
                np.rint(theta[:L]), 1, MAX_METRIC
            ).astype(int)
            changes = [
                {
                    "link": self.link_names[i],
                    "metric": int(round(self.theta0[i])),
                    "proposed": int(proposed[i]),
                    "utilization": round(float(util1[i]), 3),
                }
                for i in range(L)
                if int(proposed[i]) != int(round(self.theta0[i]))
            ]
            ms = (time.perf_counter() - t0) * 1e3
            counters.increment("whatif.optimizes")
            counters.add_stat_value("whatif.optimize_ms", ms)
            out = {
                "area": self.area,
                "iters": self.iters,
                "trips": self.trips,
                "tau": self.tau,
                "demands": len(self.demands),
                "rejected_demands": len(self.rejected),
                "max_util_before": round(before, 3),
                "max_util_after": round(after, 3),
                "predicted_max_util_delta": round(after - before, 3),
                "loss_curve": loss_curve,
                "changes": changes,
                "optimize_ms": round(ms, 2),
            }
            tracer.end_trace(self.ctx, status=_TRACE_STATUS)
            self.ctx = None
            return out
        except Exception:
            tracer.end_trace(self.ctx, status="error")
            self.ctx = None
            raise
