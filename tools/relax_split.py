"""Time split of K1s ``sssp_init``, K1 ``relax_step``, K6 ``parent_plane``
and K5's scatter at the shapes of the paths that run them, for the
``openr_tpu_torch`` package found under ``--root`` (default: this
checkout), so that two trees can be compared in one run on the same
card:

    python -m tools.relax_split [--root DIR] [--cases CASE,...]

Needs a CUDA card. The cases (all by default):

- ``k1s``: K1s on the lsdb100k cold build's inputs (``chip_smoke.py``'s
  main path, root node-158-158): allocating its outputs, and, where the
  tree's ``sssp_init`` takes ``out=``, into held outputs (``k1s_held``:
  the incremental solve's call);
- ``k1``: K1 on lsdb100k (no residual), from a wavefront 16 Jacobi steps
  past the seed plane;
- ``k1_res``: K1 with the residual ELL on fabric10k (root pod000-rsw00),
  from a wavefront 3 steps past the seed plane;
- ``k1_ksp2``: K1 over wan50k's masked KSP2 rows (lane planes, the shared
  residual index tables; ``chip_smoke.py`` phase 10), from a wavefront 4
  steps past the seed rows;
- ``k6``: K6 on lsdb100k's converged planes (4 x 131072, no residual),
  the root-masked weights as old weights; where the tree's
  ``parent_plane`` takes ``out=``, also into a held plane (``k6_held``:
  the incremental solve's call);
- ``k6_res``: the same on fabric10k (8 x 8192, the residual ELL of 8192
  x 128), held where the tree allows (``k6_res_held``);
- ``k5``: a sync's K5 step as the solver runs it (``GpuSpfSolver.
  _scatter_counted``: the index and value buffers sent to the card, then
  the scatter) on lsdb100k's shift plane, 16 dirty slots and 48 pads (a
  dirty bucket of 64); ``k5_pair``: the same with a second plane of
  fabric10k's residual shape (8192 x 128) and as many slots, both planes
  of one sync; ``k5_mc``: the same into lsdb100k_mc's shift plane placed
  on 8 logical shards of the card (batch 4 x graph 2: two distinct
  column parts). A step may wait on the stream (a copy from pageable
  memory synchronises it), so these rows are ``chip_smoke.step_ms``'s:
  host, wall and device ms from an idle stream, and the host ms of a
  call queued behind a 1 ms device sleep.

With ``--define NAME=VALUE`` (repeatable) the tree's ``csrc/incremental.cu``
is built again with ``-DNAME=VALUE`` into a library of its own under
the tree's ``_build/`` (a variant of K5-K9, e.g. ``PARENT_EXIT_EVERY=4``
for K6's class loop with a warp-uniform exit), and the cases run on it;
``--build-only`` builds it and stops (several variants can then be
built at once, one process each).

Each case is first held to the plain version on the same card tensors
(tolerance 0). Then: ``ms`` (``chip_smoke.time_ms``: calls back to
back), ``device_ms`` and ``host_ms`` (``chip_smoke.device_ms``: the
kernels alone on the device, and the host's enqueue), the host ms of the
bare ``cuda.launch`` of the same entry points on raw addresses
(``launch_floor_host_ms``: for a tree whose K1 takes two launches with a
residual, both), and one call's device work (``chip_smoke.counted``:
kernel launches, torch ops, CUDA allocations). Prints one JSON line, the
card's name and power limit beside it.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

CASES = ("k1s", "k1", "k1_res", "k1_ksp2", "k6", "k6_res", "k5", "k5_pair",
         "k5_mc")


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _bare_relax(cs, cuda, dist, out, flag, deltas, sw, residual,
                shared: int):
    """The bare K1 launches of one ``relax_step`` call: the tree's one
    ``relax_step`` entry (``chip_smoke.k1_floor``), or its
    ``relax_shift`` and, with a residual, ``relax_residual``."""
    if hasattr(cuda._lib("relax"), "relax_step"):
        return cs.k1_floor(cuda, dist, out, flag, deltas, sw, residual,
                           shared)
    g = dist.shape[0] if dist.dim() == 3 else 1
    d_cap, n_cap = dist.shape[-2:]
    s_cap, w_cols = sw.shape[-2:]
    rows, nbr, rw = residual or (None, None, None)
    r_cap, kr_cap = nbr.shape[-2:] if residual else (0, 0)
    gate = (0,) * 8
    shift = [_ptr(t) for t in (dist, out, deltas, sw)]
    res = [_ptr(t) for t in (dist, out, rows, nbr, rw)]

    def launches():
        cuda.launch("relax", "relax_shift", "ppppiiiiipi" + "ppiiiiii",
                    *shift, d_cap, n_cap, s_cap, 0, w_cols, _ptr(flag), g,
                    *gate)
        if residual:
            cuda.launch("relax", "relax_residual", "pppppiiiiipi"
                        + "ppiiiiii", *res, d_cap, n_cap, r_cap, kr_cap,
                        shared, _ptr(flag), g, *gate)

    return launches


def _variant(cuda, name: str, defines: list) -> Path:
    """Build ``csrc/<name>.cu`` with ``-D`` each of ``defines`` (once: the
    library is named by the hash of the source and flags) and load it in
    place of the tree's own library of that name. -> its path."""
    flags = [f"-D{d}" for d in defines]
    key = cuda._lib_path(name).name + " ".join(flags)
    path = cuda.BUILD_DIR / (
        f"{name}-variant-{hashlib.sha256(key.encode()).hexdigest()[:16]}.so")
    if not path.exists():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, *flags, "-o", str(tmp),
             str(cuda.CSRC / f"{name}.cu")], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc {' '.join(flags)}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, path)
    cuda._lib(name)  # every other library of the tree, loaded first
    with cuda._lock:
        cuda._libs[name] = ctypes.CDLL(str(path))
        cuda._fns.clear()
    return path


def _bare_parent(cuda, inc, pargs, out):
    """The bare K6 launches of one ``parent_plane`` call into ``out``: the
    tree's one ``parent_plane`` entry, or its ``parent_shift`` and, with a
    residual, ``parent_residual``."""
    deltas, swm, rows, nbr, rwm, prev, s_cap, has_res, n_cap, d_cap = pargs
    r_cap, kr_cap = nbr.shape if has_res else (0, 0)
    res = [_ptr(t) if has_res else 0 for t in (rows, nbr, rwm)]
    shift = [_ptr(t) for t in (deltas, swm, prev, out)]
    if hasattr(cuda._lib("incremental"), "parent_plane"):
        return lambda: cuda.launch(
            "incremental", "parent_plane", "p" * 7 + "i" * 7, *shift, *res,
            s_cap, n_cap, d_cap, 0, n_cap, r_cap, kr_cap)

    def launches():
        cuda.launch("incremental", "parent_shift", "ppppiiiii", *shift,
                    s_cap, n_cap, d_cap, 0, n_cap)
        if has_res:
            cuda.launch("incremental", "parent_residual", "pppppiiii",
                        *res[:2], res[2], _ptr(prev), _ptr(out), r_cap,
                        kr_cap, n_cap, d_cap)

    return launches


def _bare_scatter(cuda, planes):
    """The bare K5 launches of one sync's scatter: ``planes`` is a list of
    (plane, idx, vals) device tensors; the tree's one two-segment
    ``scatter_set`` launch, or one launch a plane."""
    ptrs = [[_ptr(t) for t in seg] + [seg[1].numel(), seg[0].numel()]
            for seg in planes]
    lib = cuda._lib("incremental")
    if hasattr(lib, "scatter_parts"):
        a = ptrs[0]
        b = ptrs[1] if len(ptrs) > 1 else [0, 0, 0, 0, 0]
        return lambda: cuda.launch("incremental", "scatter_set", "pppii" * 2,
                                   *a[:3], a[3], a[4], *b[:3], b[3], b[4])

    def launches():
        for a in ptrs:
            cuda.launch("incremental", "scatter_set", "pppii", *a[:3], a[3],
                        a[4])

    return launches


def _sync_scatter(solver, segments):
    """The tree's K5 step of a sync: ``_scatter_counted`` over (array,
    host idx, host vals) segments, in one call where the tree takes
    several segments, else one call a segment."""
    fn = solver._scatter_counted
    if any(p.kind is p.VAR_POSITIONAL
           for p in inspect.signature(fn).parameters.values()):
        return lambda: fn(*segments)
    return lambda: [fn(*seg) for seg in segments]


def _wavefront(torch, relax, dist0, deltas, sw, residual, steps: int):
    mid, spare = dist0.clone(), torch.empty_like(dist0)
    flag = torch.zeros(1, dtype=torch.int32, device=dist0.device)
    for _ in range(steps):
        relax.relax_step(mid, spare, flag, deltas, sw, residual)
        mid, spare = spare, mid
    return mid


def _step_row(cs, torch, wrappers, fn, floor, solver,
              extra=None) -> dict:
    """``_row`` for a step that may wait on the stream (a parent's
    uploads from pageable memory synchronise it): ``chip_smoke.step_ms``
    in place of the calls queued behind a device sleep; with the
    solver's staged copies a call where the tree stages its uploads."""
    row = {**cs.step_ms(torch, fn),
           "launch_floor_host_ms": cs.device_ms(torch, floor)[1]}
    counts = getattr(solver, "staging_counts", None)
    st0 = counts() if counts else None
    n = cs.counted(torch, wrappers, fn)
    row["per_call"] = {k: n[k] for k in ("kernel_launches", "torch_ops",
                                         "allocations")}
    if counts:
        row["per_call"]["staged_copies"] = counts()["copies"] - st0["copies"]
    return {**row, **(extra or {})}


def _row(cs, torch, wrappers, fn, floor, extra=None) -> dict:
    dev_ms, host_ms = cs.device_ms(torch, fn)
    return {"ms": cs.time_ms(torch, fn, 50), "device_ms": dev_ms,
            "host_ms": host_ms,
            "launch_floor_host_ms": cs.device_ms(torch, floor)[1],
            "per_call": {k: v for k, v in cs.counted(
                torch, wrappers, fn).items()
                if k in ("kernel_launches", "torch_ops", "allocations")},
            **(extra or {})}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="tree holding openr_tpu_torch/")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--define", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="run on csrc/incremental.cu built with -DNAME=VALUE")
    ap.add_argument("--build-only", action="store_true",
                    help="with --define: build the variant and stop")
    a = ap.parse_args()
    cases = a.cases.split(",")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    if a.root:
        sys.path.insert(0, str(Path(a.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("relax_split: no CUDA device available", file=sys.stderr)
        return 2
    from openr_tpu_torch.decision import gpu_solver
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.ops import cuda, ksp2, relax

    from openr_tpu_torch.ops import incremental as inc

    out = {"root": a.root or "."}
    if a.define:
        out["variant"] = {"defines": a.define,
                          "library": _variant(cuda, "incremental",
                                              a.define).name}
        if a.build_only:
            print(json.dumps(out), flush=True)
            return 0
    dev = torch.device(cs.DEVICE)
    wrappers = {n: (w, None, None) for n, w in (
        ("sssp_init", relax.sssp_init), ("relax_step", relax.relax_step),
        *((k, getattr(inc, k)) for k in (
            "scatter_set", "scatter_window", "scatter_parts",
            "parent_plane", "parent_shift_mc", "parent_fill")
          if hasattr(inc, k)))}

    def solved(gen, me, **kw):
        _, states, ps = cs.build_cell(topologies, gen)
        solver = gpu_solver.GpuSpfSolver(me, device=dev, **kw)
        solver.build_route_db(me, states, ps)
        ad = solver._area_dev["0"]
        nbr, w, _ = ad.plan.out_links(states["0"], me)
        args = (ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w,
                ad.plan.node_index[me], torch.tensor(nbr, device=dev),
                torch.tensor(w, device=dev))
        return solver, ad, args

    def equal(got, want, label):
        cs.check(cs.max_abs_err(torch, got, want) == 0,
                 f"{label}: kernel != plain")

    def k1_case(label, dist, deltas, sw, residual, res_plain, shared=0):
        o_k, o_p = torch.empty_like(dist), torch.empty_like(dist)
        f_k = torch.zeros(1, dtype=torch.int32, device=dev)
        f_p = torch.zeros_like(f_k)
        relax.relax_step(dist, o_k, f_k, deltas, sw, residual)
        relax.relax_step_plain(dist, o_p, f_p, deltas, sw, res_plain)
        cs.check(int(f_k) == 1, f"{label}: a wavefront step must change")
        equal((o_k, f_k), (o_p, f_p), label)
        out[label] = _row(
            cs, torch, wrappers,
            lambda: relax.relax_step(dist, o_k, f_k, deltas, sw, residual),
            _bare_relax(cs, cuda, dist, o_k, f_k, deltas, sw, residual,
                        shared),
            {"shape": list(dist.shape)})

    if "k1s" in cases or "k1" in cases:
        lsdb = lambda: topologies.grid(cs.LSDB100K_SIDE,  # noqa: E731
                                       node_labels=False)
        _, ad, args = solved(lsdb, cs.LSDB100K_ROOT)
        n_cap = ad.plan.n_cap
        got, want = relax.sssp_init(*args), relax.sssp_init_plain(*args)
        equal((got[0], *got[1], got[2]), (want[0], *want[1], want[2]),
              "k1s")
        if "k1s" in cases:
            out["k1s"] = _row(cs, torch, wrappers,
                              lambda: relax.sssp_init(*args),
                              cs.k1s_floor(cuda, args, got, n_cap))
            if "out" in inspect.signature(relax.sssp_init).parameters:
                held = relax.init_outputs(*args[:4], args[5], n_cap)
                relax.sssp_init(*args, out=held)
                equal((held[0], *held[1], held[2]),
                      (want[0], *want[1], want[2]), "k1s_held")
                out["k1s_held"] = _row(
                    cs, torch, wrappers,
                    lambda: relax.sssp_init(*args, out=held),
                    cs.k1s_floor(cuda, args, held, n_cap))
        if "k1" in cases:
            residual = got[1] if ad.plan.k_res > 0 else None
            mid = _wavefront(torch, relax, got[2], ad.deltas, got[0],
                             residual, 16)
            k1_case("k1", mid, ad.deltas, got[0], residual, residual)

    if "k1_res" in cases:
        fab = lambda: topologies.fabric(**cs.FABRIC)  # noqa: E731
        _, ad, args = solved(fab, "pod000-rsw00")
        cs.check(ad.plan.k_res > 0, "fabric10k must have a residual")
        sw, residual, dist0 = relax.sssp_init(*args)
        mid = _wavefront(torch, relax, dist0, ad.deltas, sw, residual, 3)
        k1_case("k1_res", mid, ad.deltas, sw, residual, residual)

    if "k1_ksp2" in cases:
        wan = lambda: topologies.wan(**cs.WAN50K)  # noqa: E731
        solver, ad, _ = solved(wan, cs.WAN50K_ROOT)
        plan = ad.plan
        rstate = solver._ksp2_rows[("0", cs.WAN50K_ROOT)]
        ms_t = torch.from_numpy(rstate.mask_s).to(dev)
        mr_t = torch.from_numpy(rstate.mask_r).to(dev)
        has_res = plan.k_res > 0
        deltas_b, sw, res_k = ksp2.lane_inputs(
            ad.deltas, ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w, ms_t,
            None, mr_t, None, has_res)
        roots = torch.tensor([plan.node_index[cs.WAN50K_ROOT]],
                             dtype=torch.int32, device=dev)
        seed = ksp2.seed_rows(roots, ms_t.shape[0], plan.n_cap)
        mid = _wavefront(torch, relax, seed, deltas_b, sw, res_k, 4)
        k1_case("k1_ksp2", mid, deltas_b, sw, res_k,
                cs.plain_residual(res_k, plan.n_cap), int(has_res))

    def k6_case(label, gen, me):
        _, ad, args = solved(gen, me)
        plan = ad.plan
        has_res = plan.k_res > 0
        sw, res, dist0 = relax.sssp_init(*args)
        prev, _, _ = relax.plan_sssp(ad.deltas, ad.shift_w, ad.res_rows,
                                     ad.res_nbr, ad.res_w, args[4], args[5],
                                     args[6], has_res, "sync")
        pargs = (ad.deltas, sw, ad.res_rows, ad.res_nbr, res[2], prev,
                 plan.s_cap, has_res, plan.n_cap, prev.shape[0])
        want = inc.parent_plane_plain(*pargs)
        got = inc.parent_plane(*pargs)
        equal(got, want, label)
        out[label] = _row(cs, torch, wrappers,
                          lambda: inc.parent_plane(*pargs),
                          _bare_parent(cuda, inc, pargs, got),
                          {"shape": list(prev.shape),
                           "residual": list(ad.res_nbr.shape)
                           if has_res else None})
        if "out" in inspect.signature(inc.parent_plane).parameters:
            held = torch.full_like(prev, -7)
            inc.parent_plane(*pargs, out=held)
            equal(held, want, f"{label}_held")
            out[f"{label}_held"] = _row(
                cs, torch, wrappers,
                lambda: inc.parent_plane(*pargs, out=held),
                _bare_parent(cuda, inc, pargs, held))

    if "k6" in cases:
        k6_case("k6", lambda: topologies.grid(cs.LSDB100K_SIDE,
                                              node_labels=False),
                cs.LSDB100K_ROOT)
    if "k6_res" in cases:
        k6_case("k6_res", lambda: topologies.fabric(**cs.FABRIC),
                "pod000-rsw00")

    if {"k5", "k5_pair", "k5_mc"} & set(cases):
        import numpy as np

        from openr_tpu_torch.parallel import sharding

        solver, ad, _ = solved(lambda: topologies.grid(
            cs.LSDB100K_SIDE, node_labels=False), cs.LSDB100K_ROOT)
        rng = np.random.default_rng(21)

        def dirty(numel):
            idx = np.full(64, numel, np.int32)
            idx[:16] = rng.choice(numel, 16, replace=False)
            return idx, rng.integers(1, 99, 64, dtype=np.int32)

        a = ad.shift_w.clone()
        seg_a = (a, *dirty(a.numel()))
        b = torch.randint(0, 99, (8192, 128), dtype=torch.int32, device=dev)
        seg_b = (b, *dirty(b.numel()))

        def k5_case(label, segments, bare):
            fn = _sync_scatter(solver, segments)
            fn()
            for arr, idx, vals in segments:
                live = idx < arr.numel()
                got = arr.view(-1)[torch.tensor(idx[live], device=dev)
                                   .long()].cpu().numpy()
                cs.check(bool((got == vals[live]).all()),
                         f"{label}: a slot was not set")
            out[label] = _step_row(cs, torch, wrappers, fn, bare, solver,
                                   {"planes": len(segments)})

        def on_dev(seg):
            return [(seg[0], torch.tensor(seg[1], device=dev),
                     torch.tensor(seg[2], device=dev))]

        if "k5" in cases:
            k5_case("k5", [seg_a], _bare_scatter(cuda, on_dev(seg_a)))
        if "k5_pair" in cases:
            k5_case("k5_pair", [seg_a, seg_b],
                    _bare_scatter(cuda, on_dev(seg_a) + on_dev(seg_b)))
        if "k5_mc" in cases:
            mesh = sharding.make_mesh(8, devices=[dev] * 8)
            plan = ad.plan
            lay = sharding.plan_shardings(mesh, plan.n_cap,
                                          plan.res_rows.shape[0], 0)
            sh = sharding.place(mesh, plan.shift_w, lay["shift_w"])
            idx, vals = dirty(plan.shift_w.size)
            fn = _sync_scatter(solver, [(sh, idx, vals)])
            fn()
            for b_, g_, t in sh.distinct():
                lo, hi = sh.window(b_, g_)
                want = plan.shift_w[:, lo:hi].copy()
                live = idx < plan.shift_w.size
                k_, u_ = idx[live] // plan.n_cap, idx[live] % plan.n_cap
                own = (u_ >= lo) & (u_ < hi)
                want[k_[own], u_[own] - lo] = vals[live][own]
                cs.check(bool((t.cpu().numpy() == want).all()),
                         f"k5_mc: part {b_}.{g_} != the scatter")
            i_d = torch.tensor(idx, device=dev)
            v_d = torch.tensor(vals, device=dev)
            shape = tuple(plan.shift_w.shape)
            if hasattr(sharding, "_scatter_targets"):
                (_, _, table), = sharding._scatter_targets(sh).values()

                def bare():
                    cuda.launch("incremental", "scatter_parts", "pippiii",
                                table.data_ptr(), table.shape[0], i_d.data_ptr(),
                                v_d.data_ptr(), i_d.numel(), *shape)
            else:
                parts = [(t, sh.window(b_, g_)[0])
                         for b_, g_, t in sh.distinct()]

                def bare():
                    for t, lo in parts:
                        cuda.launch("incremental", "scatter_window",
                                    "pppiiiiiii", t.data_ptr(), i_d.data_ptr(),
                                    v_d.data_ptr(), i_d.numel(), *shape, 0,
                                    t.shape[0], lo, t.shape[1])
            out["k5_mc"] = _step_row(cs, torch, wrappers, fn, bare, solver,
                                     {"parts": sum(1 for _ in sh.distinct())})

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    out["card"] = smi.stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
