#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (openr_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, nvcc (for the kernels in openr_tpu_torch/csrc)
and nvidia-smi; without a card it exits non-zero before printing any
result. Phases — every failure raises, so the run exits non-zero and
prints no result line:

  1. build every CUDA kernel of the port (one nvcc per source, started
     together, for sm_90a);
  2. RIB parity against the oracle on tg1k (grid 32 x 32) and fabric10k
     (96 pods x 8 planes x 64 rsws, 36 spines a plane; LFA off), and the
     residual relaxation kernel against its plain version on fabric10k,
     whose pod-crossing spine tier lands in the residual ELL;
  3. the main path: the lsdb100k cell (grid 316 x 316 = 99,856 nodes,
     ~400k directed adjacencies, one loopback prefix per node, root
     node-158-158, default settings: bucketed kernel, sentinels on, no
     LFA) through ``GpuSpfSolver.build_route_db`` three times — the
     first a cold build, the others reading the delta payload — with
     every kernel's launch count zeroed just before and read just after;
     each kernel must have launched;
  4. the lsdb100k RIB against the CPU oracle (``SpfSolver``);
  5. every kernel wrapper against its plain PyTorch version on the card,
     on the main path's own tensors (exact int32 equality, tolerance 0),
     timed with CUDA events beside its plain version and its bound.

Output: phase lines, then one ``{"kernels": [...]}`` JSON line, the card's
name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# device peaks of one H100 SXM (NVIDIA data sheet) used for the bounds:
# HBM3 bytes/s, and the non-tensor-core 32-bit rate (the data sheet's
# float32 figure, taken for the int32 add/min/compare these kernels do)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

LSDB100K_SIDE = 316
LSDB100K_ROOT = "node-158-158"
DEVICE = "cuda"


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events),
    after two warm-up calls. The main path's planes fit the 50 MB L2,
    as they do inside its round loops, so the cache is left warm."""
    fn()
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """Least time for the work on the card: the larger of bytes over the
    memory rate and operations over the 32-bit ALU rate (ms)."""
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_o = ops / PEAK_OPS_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def max_abs_err(torch, got, want) -> int:
    """Largest |got - want| over tensors of equal shape (int64 math)."""
    if isinstance(got, torch.Tensor):
        check(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
        if got.numel() == 0:
            return 0
        return int((got.long() - want.long()).abs().max())
    return max(max_abs_err(torch, g, w) for g, w in zip(got, want))


def build_cell(topologies, gen):
    adj_dbs, prefix_dbs = gen()
    return topologies.build_states(adj_dbs, prefix_dbs)


def rib_equal(want_db, got_db) -> bool:
    return (
        dict(want_db.unicast_routes.items())
        == dict(got_db.unicast_routes.items())
        and want_db.mpls_routes == got_db.mpls_routes
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from openr_tpu_torch.decision import gpu_solver
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.ops import compact, cuda, relax, select

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    paths = cuda.build_all()
    log(f"build: {len(paths)} libraries in "
        f"{(time.perf_counter() - t0):.1f} s")
    for name in cuda.SOURCES:
        text = (cuda.BUILD_DIR / f"{name}.log").read_text(errors="replace")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    wrappers = {
        "K1s:sssp_init": (relax.sssp_init, "relax.cu",
                      "openr_tpu/decision/tpu_solver.py:326"),
        "K1:relax_step": (relax.relax_step, "relax.cu",
                       "openr_tpu/ops/relax.py:119"),
        "K2:ladder_classes": (relax.ladder_classes, "relax.cu",
                           "openr_tpu/ops/relax.py:185"),
        "K2:ladder_apply": (relax.ladder_apply, "relax.cu",
                         "openr_tpu/ops/relax.py:185"),
        "K2:ladder_rung": (relax.ladder_rung, "relax.cu",
                        "openr_tpu/ops/relax.py:185"),
        "K3:select_routes": (select.select_routes, "select.cu",
                          "openr_tpu/decision/tpu_solver.py:511"),
        "K4:compact_outputs": (compact.compact_outputs, "compact.cu",
                            "openr_tpu/ops/stream.py:79"),
    }

    # -- 2. small cells: RIB parity, residual relaxation; also loads every
    # kernel's module, so the main path's first build times the solve ---------------------
    cells = [
        ("tg1k", lambda: topologies.grid(32, node_labels=False),
         "node-16-16"),
        ("fabric10k", lambda: topologies.fabric(
            pods=96, planes=8, ssws_per_plane=36, rsws_per_pod=64),
         "pod000-rsw00"),
    ]
    for name, gen, me in cells:
        c_states, c_ps = build_cell(topologies, gen)
        c_solver = gpu_solver.GpuSpfSolver(me, device=dev)
        got_db = c_solver.build_route_db(me, c_states, c_ps)
        t0 = time.perf_counter()
        want_db = SpfSolver(me).build_route_db(me, c_states, c_ps)
        t_oracle = (time.perf_counter() - t0) * 1e3
        check(rib_equal(want_db, got_db), f"{name}: RIB != oracle")
        tm = c_solver.last_timing
        c_ad = c_solver._area_dev["0"]
        log(f"{name}: RIB == oracle ({len(want_db.unicast_routes)} routes, "
            f"oracle {t_oracle:.0f} ms): " + json.dumps({
                "k_res": c_ad.plan.k_res,
                **{k: tm.get(k) for k in (
                    "spf_kernel", "trips", "rounds", "sssp_ms", "tail_ms",
                    "compact_ms", "pipeline_wall_ms")},
            }))
        if c_ad.plan.k_res > 0:
            c_plan = c_ad.plan
            c_nbr, c_w, _ = c_plan.out_links(c_states["0"], me)
            c_sw, c_res, c_d0 = relax.sssp_init(
                c_ad.shift_w, c_ad.res_rows, c_ad.res_nbr, c_ad.res_w,
                c_plan.node_index[me], torch.tensor(c_nbr, device=dev),
                torch.tensor(c_w, device=dev),
            )
            plane = c_d0
            for _ in range(3):
                o_k, o_p = torch.empty_like(plane), torch.empty_like(plane)
                fk = torch.zeros(1, dtype=torch.int32, device=dev)
                fp = torch.zeros_like(fk)
                relax.relax_step(plane, o_k, fk, c_ad.deltas, c_sw, c_res)
                relax.relax_step_plain(plane, o_p, fp, c_ad.deltas, c_sw,
                                       c_res)
                check(max_abs_err(torch, (o_k, fk), (o_p, fp)) == 0,
                      f"{name}: residual relax_step != plain")
                plane = o_k
            log(f"{name}: relax_step with the residual ELL equal to plain")

    # -- 3. main path: lsdb100k cold solve x3 -------------------------------
    t0 = time.perf_counter()
    states, ps = build_cell(
        topologies, lambda: topologies.grid(LSDB100K_SIDE, node_labels=False)
    )
    ls = states["0"]
    log(f"lsdb100k: {ls.node_count()} nodes, "
        f"{len(ps.prefixes())} prefixes, host build "
        f"{(time.perf_counter() - t0):.1f} s")
    solver = gpu_solver.GpuSpfSolver(LSDB100K_ROOT, device=dev)
    for fn, _, _ in wrappers.values():
        fn.launches = 0
    dbs = []
    for i in range(3):
        t0 = time.perf_counter()
        db = solver.build_route_db(LSDB100K_ROOT, states, ps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        check(db is not None, "lsdb100k build returned no RIB")
        dbs.append(db)
        tm = solver.last_timing
        log("lsdb100k build %d: %s" % (i, json.dumps({
            "build_ms": wall,
            **{k: tm.get(k) for k in (
                "sync_ms", "exec_ms", "pull_ms", "unpack_ms", "sssp_ms",
                "tail_ms", "compact_ms", "pipeline_wall_ms", "trips",
                "rounds", "spf_kernel", "bytes_uploaded",
                "bytes_downloaded")},
            "sentinels": solver.last_sentinels,
        })))
    launches = {name: fn.launches for name, (fn, _, _) in wrappers.items()}
    log(f"lsdb100k launches over 3 builds: {json.dumps(launches)}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    check(solver.last_timing["spf_kernel"] == "bucketed",
          "lsdb100k must run the bucketed kernel")

    # -- 4. the lsdb100k RIB against the oracle ---------------------------
    t0 = time.perf_counter()
    oracle = SpfSolver(LSDB100K_ROOT).build_route_db(LSDB100K_ROOT, states, ps)
    t_oracle = (time.perf_counter() - t0) * 1e3
    n_routes = len(oracle.unicast_routes)
    check(n_routes == ls.node_count() - 1,
          f"oracle has {n_routes} routes for {ls.node_count()} nodes")
    for i, db in enumerate(dbs):
        check(rib_equal(oracle, db), f"lsdb100k build {i} RIB != oracle")
    log(f"lsdb100k RIB == oracle for all 3 builds ({n_routes} routes; "
        f"oracle host solve {t_oracle:.0f} ms)")

    # -- 5. every kernel against its plain version at lsdb100k shapes -------
    ad = solver._area_dev["0"]
    plan = ad.plan
    root = plan.node_index[LSDB100K_ROOT]
    root_nbr_np, root_w_np, _ = plan.out_links(ls, LSDB100K_ROOT)
    root_nbr = torch.tensor(root_nbr_np, device=dev)
    root_w = torch.tensor(root_w_np, device=dev)
    p_cap, a_cap = ad.matrix.ann_node.shape
    n_cap, s_cap = plan.n_cap, plan.s_cap
    d_cap = root_nbr.shape[0]
    has_res = plan.k_res > 0
    results = {}

    def record(name, err, fn, plain, nbytes, ops, reps=50, plain_reps=5):
        check(err == 0, f"{name}: kernel != plain (max abs err {err})")
        b_ms, b_by = bound(nbytes, ops)
        results[name] = {
            "max_abs_err": err,
            "ms": time_ms(torch, fn, reps),
            "plain_ms": time_ms(torch, plain, plain_reps),
            "bound_ms": b_ms,
            "bound_by": b_by,
        }
        log(f"{name}: equal; {json.dumps(results[name])}")

    args = (ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w, root, root_nbr,
            root_w)
    got = relax.sssp_init(*args)
    want = relax.sssp_init_plain(*args)
    res_bytes = 4 * (ad.res_rows.numel() + 2 * ad.res_nbr.numel())
    record(
        "K1s:sssp_init", max_abs_err(torch, (got[0], *got[1], got[2]),
                                 (want[0], *want[1], want[2])),
        lambda: relax.sssp_init(*args), lambda: relax.sssp_init_plain(*args),
        nbytes=4 * (2 * s_cap * n_cap + 2 * d_cap + d_cap * n_cap)
        + 2 * res_bytes,
        ops=s_cap * n_cap + d_cap * n_cap,
    )
    sw, residual, dist0 = got
    residual = residual if has_res else None

    def step(dist, out, flag):
        relax.relax_step(dist, out, flag, ad.deltas, sw, residual)

    # a mid-solve wavefront plane: 16 Jacobi rounds from the seeds
    mid = dist0.clone()
    spare = torch.empty_like(mid)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    for _ in range(16):
        step(mid, spare, flag)
        mid, spare = spare, mid
    out_k, out_p = torch.empty_like(mid), torch.empty_like(mid)
    f_k = torch.zeros(1, dtype=torch.int32, device=dev)
    f_p = torch.zeros_like(f_k)
    relax.relax_step(mid, out_k, f_k, ad.deltas, sw, residual)
    relax.relax_step_plain(mid, out_p, f_p, ad.deltas, sw, residual)
    check(int(f_k) == 1, "relax_step on a wavefront must change the plane")
    record(
        "K1:relax_step", max_abs_err(torch, (out_k, f_k), (out_p, f_p)),
        lambda: relax.relax_step(mid, out_k, f_k, ad.deltas, sw, residual),
        lambda: relax.relax_step_plain(mid, out_p, f_p, ad.deltas, sw,
                                       residual),
        nbytes=4 * (2 * d_cap * n_cap + s_cap * n_cap + s_cap)
        + (res_bytes if has_res else 0),
        ops=2 * d_cap * n_cap * s_cap
        + (2 * d_cap * ad.res_nbr.numel() if has_res else 0),
    )

    s_lad = min(s_cap, relax.LADDER_WIDTH)
    dq = 1 << max(plan.delta_exp, 1)
    w_k, dd_k = relax.ladder_classes(sw, ad.deltas, dq, s_lad)
    w_p, dd_p = relax.ladder_classes_plain(sw, ad.deltas, dq, s_lad)
    record(
        "K2:ladder_classes", max_abs_err(torch, (w_k, dd_k), (w_p, dd_p)),
        lambda: relax.ladder_classes(sw, ad.deltas, dq, s_lad),
        lambda: relax.ladder_classes_plain(sw, ad.deltas, dq, s_lad),
        nbytes=4 * (s_cap * n_cap + s_cap + s_lad * n_cap + s_lad),
        ops=s_cap * n_cap + s_lad * n_cap,
    )
    errs = []
    for k in range(s_lad):
        f_k.zero_()
        f_p.zero_()
        relax.ladder_apply(mid, out_k, w_k, dd_k, k, f_k)
        relax.ladder_apply_plain(mid, out_p, w_k, dd_k, k, f_p)
        errs.append(max_abs_err(torch, (out_k, f_k), (out_p, f_p)))
    record(
        "K2:ladder_apply", max(errs),
        lambda: relax.ladder_apply(mid, out_k, w_k, dd_k, 0, f_k),
        lambda: relax.ladder_apply_plain(mid, out_p, w_k, dd_k, 0, f_p),
        nbytes=4 * (2 * d_cap * n_cap + n_cap + 1),
        ops=2 * d_cap * n_cap,
    )
    w2_k, d2_k = torch.empty_like(w_k), torch.empty_like(dd_k)
    w2_p, d2_p = torch.empty_like(w_k), torch.empty_like(dd_k)
    errs = []
    w_in, d_in = w_k, dd_k
    for _ in range(3):  # three rungs: shifts double past the first wrap
        relax.ladder_rung(w_in, d_in, w2_k, d2_k)
        relax.ladder_rung_plain(w_in, d_in, w2_p, d2_p)
        errs.append(max_abs_err(torch, (w2_k, d2_k), (w2_p, d2_p)))
        w_in, d_in = w2_k.clone(), d2_k.clone()
    record(
        "K2:ladder_rung", max(errs),
        lambda: relax.ladder_rung(w_k, dd_k, w2_k, d2_k),
        lambda: relax.ladder_rung_plain(w_k, dd_k, w2_p, d2_p),
        nbytes=4 * (2 * s_lad * n_cap + 2 * s_lad),
        ops=2 * s_lad * n_cap,
    )

    # whole SSSP: kernel loops vs the same loops over the plain versions
    def plain_step(dist, out, flag):
        relax.relax_step_plain(dist, out, flag, ad.deltas, sw, residual)

    t0 = time.perf_counter()
    dist_k, ep_k, rd_k = relax.plan_sssp(
        ad.deltas, ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w, root,
        root_nbr, root_w, has_res, "bucketed", plan.delta_exp,
    )
    torch.cuda.synchronize()
    t_b = (time.perf_counter() - t0) * 1e3
    dist_p, ep_p, rd_p = relax.run_bucketed(
        plain_step, dist0.clone(), ad.deltas, sw, n_cap, s_cap,
        plan.delta_exp, relax.ladder_classes_plain, relax.ladder_apply_plain,
        relax.ladder_rung_plain,
    )
    check(max_abs_err(torch, dist_k, dist_p) == 0 and (ep_k, rd_k)
          == (ep_p, rd_p), "bucketed SSSP: kernels != plain")
    t0 = time.perf_counter()
    dist_s, tr_s, rd_s = relax.plan_sssp(
        ad.deltas, ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w, root,
        root_nbr, root_w, has_res, "sync",
    )
    torch.cuda.synchronize()
    t_s = (time.perf_counter() - t0) * 1e3
    dist_sp, tr_sp, rd_sp = relax.run_sync(
        plain_step, dist0.clone(), relax.max_trips(n_cap)
    )
    check(max_abs_err(torch, dist_s, dist_sp) == 0 and (tr_s, rd_s)
          == (tr_sp, rd_sp), "sync SSSP: kernels != plain")
    check(max_abs_err(torch, dist_s, dist_k) == 0,
          "sync and bucketed SSSP reach different fixpoints")
    log(f"lsdb100k SSSP equal to plain: bucketed {ep_k} epochs / {rd_k} "
        f"rounds in {t_b:.2f} ms host wall; sync {tr_s} trips / {rd_s} "
        f"rounds in {t_s:.2f} ms host wall")

    sel = (dist_k, root_w, root, ad.mbuf, p_cap, a_cap, False)
    got = select.select_routes(*sel)
    want = select.select_routes_plain(*sel)
    wa, wd = got[1].shape[1], got[2].shape[1]
    record(
        "K3:select_routes", max_abs_err(torch, got, want),
        lambda: select.select_routes(*sel),
        lambda: select.select_routes_plain(*sel),
        nbytes=4 * (d_cap * n_cap + d_cap + 6 * p_cap * a_cap
                    + 2 * p_cap * a_cap + p_cap * (1 + wa + wd)) + p_cap,
        ops=3 * d_cap * n_cap + 12 * p_cap * a_cap,
    )
    metric, s3w, nhw, ok = got
    flags = ad.mbuf[p_cap * a_cap:2 * p_cap * a_cap].view(p_cap, a_cap)
    # previous outputs: the first solve's zeros (every row changed, the
    # delta payload overflows) and a copy with every 97th row perturbed
    zero_prev = (torch.zeros_like(metric), torch.zeros_like(s3w),
                 torch.zeros_like(nhw))
    near_prev = (metric.clone(), s3w.clone(), nhw.clone())
    near_prev[0][::97] += 1
    errs = []
    for prev in (zero_prev, near_prev):
        cargs = (metric, s3w, nhw, ok, *prev, flags, 7, 11,
                 gpu_solver.DELTA_BUDGET, True)
        errs.append(max_abs_err(torch, compact.compact_outputs(*cargs),
                                compact.compact_outputs_plain(*cargs)))
    n_delta, n_full = compact.buffer_lens(p_cap, wa, wd,
                                          gpu_solver.DELTA_BUDGET, True)
    record(
        "K4:compact_outputs", max(errs),
        lambda: compact.compact_outputs(*cargs),
        lambda: compact.compact_outputs_plain(*cargs),
        nbytes=4 * (2 * p_cap * (1 + wa + wd) + p_cap * a_cap
                    + n_delta + n_full) + p_cap,
        ops=p_cap * (4 + 2 * (wa + wd) + a_cap),
    )

    # -- result ----------------------------------------------------------
    kernels = []
    for name, (fn, src, replaces) in wrappers.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"openr_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": launches[name],
            **results[name],
            "library_ms": None,
        })
    log(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    log(smi.stdout.strip().splitlines()[0])
    log(f"elapsed {(time.perf_counter() - t_start):.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
