"""What-if engine: batched N-k failure sweeps and drain previews on the
solver's resident graph (the port of the JAX package's
``decision/whatif.py``, without its differentiable TE half).

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
"""

from __future__ import annotations

import itertools
import time
from typing import Optional

import numpy as np
import torch

from openr_tpu_torch.ops.edgeplan import (
    _ensure_edge_loc,
    _next_pow2,
    edge_loc_of,
)
from openr_tpu_torch.ops.relax import INF_E
from openr_tpu_torch.ops.sweep import sweep, sweep_max_trips
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
        dev = ad.shift_w.device

        def up(a):
            return torch.from_numpy(a).to(dev)

        with tracer.span(
            job.ctx, "whatif.dispatch", kernel=name,
            scenarios=len(self.scenarios),
        ):
            self._out = sweep(
                ad.deltas, ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w,
                job.roots_dev, up(sh_idx), up(sh_val), up(rs_idx),
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
