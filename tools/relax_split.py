"""Time split of K1s ``sssp_init``, K1 ``relax_step``, K6 ``parent_plane``,
K5's scatter, K21 ``fabric_relax``, K23 ``shard_combine``, a K18
trip and the TE adjoint (K14, K16) at the shapes of the paths that run
them, for the
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
  call queued behind a 1 ms device sleep;
- ``k21``: K21 on the whole-fabric step's shape (``chip_smoke.py``
  phase 13: fabric10k, its 4,096 rack-switch roots, D 8), from a
  wavefront 2 relaxations past the seed planes, held to plain on the
  first ``PLAIN_ROOTS`` roots; ``k21_mc``: K21 [mc] on shard 1 of a
  graph-2 split of the same step (phase 14);
- ``k23``: K23 over the two members' planes of an lsdb100k_mc group
  ([1, 131072] each, min, with ref and flag); ``k23_groups``: every
  group of lsdb100k_mc's mesh at once (4 groups of 2), one grouped call
  where the tree has one (``shard_combine_groups``), else one call a
  group, beside ``torch.minimum`` once a group;
- ``k18``: one K18 trip (``UNROLL`` Jacobi rounds of the legacy ELL
  SSSP) over all 7,200 fabric10k roots (``sssp_all_pairs``'s shape),
  from 2 rounds past the seed; ``k18_single``: the same on lsdb100k's
  one root (the legacy pipeline's shape), from 40 rounds past the
  seed. A tree with ``legacy.ell_trip`` runs the trip as one launch
  (and, as ``k18_by_round`` / ``k18_single_by_round``, as ``UNROLL``
  launches of one round each); a parent's trip is ``UNROLL``
  ``legacy.ell_relax`` launches. Each is held on its first 64 roots to
  ``UNROLL`` rounds of the padded ``ell_relax_plain``;
- ``allpairs``: the whole ``gpu_solver.sssp_all_pairs`` call on
  fabric10k (every root), its first 64 rows held to the padded plain
  loop, as host walls ending in a synchronise (5 after a warm-up), with
  its launches by wrapper and the peak device bytes above what was
  resident;
- ``fabric_sssp``: the whole-fabric step's SSSP on fabric10k's 4,096
  roots at 2 trips (the bound the cold build takes: K1s seeds, 16 K21
  relaxations, the vote), one card, and the array-level step on 8
  logical shards (batch 4 x graph 2: K21 ``[mc]`` and K23 a
  relaxation), each as a host wall ending in a synchronise (the best
  of 3 after a warm-up), with its launches by wrapper;
- ``te14`` / ``te16``: K14 ``te_relax_vjp`` / K16 ``te_relax_vjp_jvp``
  over a whole TE step's trips at ``chip_smoke.py`` phase 12's plans
  (whatif1k: 32 sources, fabric10k: 64, ``TE_SEED``'s demands; the
  step's inputs from K13, K14, K14s, K17 and K15 on the card), each
  held to its plain version on the card (rel ``TE_KERNEL_TOL``; K16's
  ``lam_t`` reported), run twice (``deterministic``: the same bits),
  with ``device_ms`` / ``host_ms``, ``ms``, the bound
  (``chip_smoke.te_work``), launches, the peak device bytes a warm call
  allocates above what was resident and the scratch the plan holds,
  and a hash of the outputs (``sha``; ``te13_15`` hashes K13's fields
  and K15's tangent fields), to compare two trees' bits.

With ``--define NAME=VALUE`` (repeatable) the tree's ``csrc/<lib>.cu``
(``--lib``, default ``incremental``) is built again with
``-DNAME=VALUE`` into a library of its own under the tree's ``_build/``
(a variant, e.g. ``PARENT_EXIT_EVERY=4`` for K6's class loop with a
warp-uniform exit, or ``--lib fabric --define FAB_RS=4`` for K21's
roots a slab), and the cases run on it; ``--build-only`` builds it and
stops (several variants can then be built at once, one process each).

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
         "k5_mc", "k21", "k21_mc", "k23", "k23_groups", "k18", "k18_single",
         "allpairs", "fabric_sssp", "te14", "te16")
# roots of the k21 cases held to the plain version (the plain relaxation
# runs cs.PLAIN_CHUNK roots a call)
PLAIN_ROOTS = 256


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


def _row(cs, torch, wrappers, fn, floor, extra=None, reps=50) -> dict:
    dev_ms, host_ms = cs.device_ms(torch, fn, reps)
    return {"ms": cs.time_ms(torch, fn, reps), "device_ms": dev_ms,
            "host_ms": host_ms,
            "launch_floor_host_ms": cs.device_ms(torch, floor)[1],
            "per_call": {k: v for k, v in cs.counted(
                torch, wrappers, fn).items()
                if k in ("kernel_launches", "torch_ops", "allocations")},
            **(extra or {})}


def _bare_fabric(cs, cuda, mid, o, f, deltas, sw, live, roots, residual,
                 col0: int):
    """The bare K21 launches of one call: the tree's one ``fabric_relax``
    entry (``chip_smoke.k21_floor``), or its ``fabric_shift`` and
    ``fabric_residual``."""
    if hasattr(cuda._lib("fabric"), "fabric_relax"):
        return cs.k21_floor(cuda, mid, o, f, deltas, sw, live, roots,
                            residual, col0)
    g, d_cap, n_cap = mid.shape
    rows, nbr, rw, ext = residual[:4]
    shift = [_ptr(t) for t in (mid, o, deltas, sw, roots)]
    res = [_ptr(t) for t in (mid, o, rows, nbr, rw, ext, roots)]
    gate = (0,) * 8

    def launches():
        cuda.launch("fabric", "fabric_shift", "ppppp" + "iiiii" + "pi"
                    + "ppiiiiii", *shift, d_cap, n_cap, sw.shape[0], col0,
                    sw.shape[1], _ptr(f), g, *gate)
        cuda.launch("fabric", "fabric_residual", "ppppppp" + "iiii" + "pi"
                    + "ppiiiiii", *res, d_cap, n_cap, *nbr.shape, _ptr(f), g,
                    *gate)

    return launches


def _k21_cases(cs, torch, cuda, fabric, relax, wrappers, solved, topologies,
               dev, cases, out) -> None:
    """The ``k21`` and ``k21_mc`` rows (module docstring)."""
    from openr_tpu_torch.parallel import sharding

    keep: dict = {}
    _, ad, _ = solved(lambda: topologies.fabric(**cs.FABRIC), "pod000-rsw00",
                      keep, enable_lfa=True)
    plan = ad.plan
    names = [f"pod{p:03d}-rsw{i:02d}" for p in range(cs.FABRIC_POD_VANTAGES)
             for i in range(cs.FABRIC["rsws_per_pod"])]
    roots, nbr, w, _ = fabric.root_tables(plan, keep["states"]["0"], names)
    # this tree: K21e gives the live classes, the plan the node -> row
    # table; a parent's K21 takes the extent alone
    new = hasattr(fabric, "row_table")

    def member(shift, rows, rnbr, rw, row_of, n_cap):
        if not new:
            return None, (rows, rnbr, rw, fabric.fabric_extent(rw))
        ext, live = fabric.fabric_extent(rw, shift)
        return live, (rows, rnbr, rw, ext,
                      row_of if row_of is not None
                      else fabric.row_table(rows, n_cap))

    def seeds(roots_t, nbr_t, w_t, n_cap):
        rt = roots_t.shape[0]
        none = [torch.empty((rt,) + sh, dtype=torch.int32, device=dev)
                for sh in ((0, n_cap), (0,), (0, 0), (0, 0))]
        return relax.sssp_init(*none, roots_t, nbr_t, w_t)[2]

    def row(label, call, plain, mid, o_k, f_k, bare, extra):
        call()
        o_p, f_p = torch.empty_like(o_k[:n_plain]), torch.zeros_like(f_k)
        plain(o_p, f_p)
        cs.check(int(f_k) == 1, f"{label}: a wavefront step must change")
        cs.check(cs.max_abs_err(torch, o_k[:n_plain], o_p) == 0,
                 f"{label}: kernel != plain")
        dev_ms, host_ms = cs.device_ms(torch, call, reps=10)
        out[label] = {
            "ms": cs.time_ms(torch, call, 10), "device_ms": dev_ms,
            "host_ms": host_ms,
            "launch_floor_host_ms": cs.device_ms(torch, bare, reps=10)[1],
            "per_call": {k: v for k, v in cs.counted(
                torch, wrappers, call).items()
                if k in ("kernel_launches", "torch_ops", "allocations")},
            "shape": list(mid.shape), "plain_roots": n_plain, **extra}

    roots_t, nbr_t, w_t = (torch.tensor(a, device=dev)
                           for a in (roots, nbr, w))
    whole_live, whole = member(ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w,
                               None, plan.n_cap)
    kw_live = {} if whole_live is None else {"live": whole_live}
    mid = seeds(roots_t, nbr_t, w_t, plan.n_cap)
    spare = torch.empty_like(mid)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    for _ in range(2):
        fabric.fabric_relax(mid, spare, flag, ad.deltas, ad.shift_w, whole,
                            roots_t, **kw_live)
        mid, spare = spare, mid
    o_k, f_k = spare, torch.zeros(1, dtype=torch.int32, device=dev)
    n_plain = min(PLAIN_ROOTS, roots_t.shape[0])
    s = slice(0, n_plain)
    if "k21" in cases:
        row("k21",
            lambda: fabric.fabric_relax(mid, o_k, f_k, ad.deltas, ad.shift_w,
                                        whole, roots_t, **kw_live),
            lambda o, f: cs.by_roots(torch, n_plain,
                                     lambda q: fabric.fabric_relax_plain(
                                         mid[s][q], o[q], f, ad.deltas,
                                         ad.shift_w, whole, roots_t[s][q])),
            mid, o_k, f_k,
            _bare_fabric(cs, cuda, mid, o_k, f_k, ad.deltas, ad.shift_w,
                         whole_live, roots_t, whole, 0),
            {"live_classes": None if whole_live is None
             else int(whole_live.sum())})
    if "k21_mc" in cases:
        mesh = sharding.make_mesh(2, batch=1, devices=[dev] * 2)
        kw = sharding.fabric_mesh_inputs(mesh, plan, ad.matrix, roots, nbr, w)
        shift, rows, rnbr, rw = (kw[k][0][1] for k in (
            "shift_w", "res_rows", "res_nbr", "res_w"))
        n_cap = 2 * shift.shape[1]
        col0 = n_cap // 2
        deltas, mroots = kw["deltas"][0][1], kw["roots"][0][1]
        live, res = member(shift, rows, rnbr, rw,
                           kw["row_of"][0][1] if "row_of" in kw else None,
                           n_cap)
        kwm = {} if live is None else {"live": live}
        row("k21_mc",
            lambda: fabric.fabric_relax_mc(mid, o_k, f_k, deltas, shift, res,
                                           mroots, col0=col0, **kwm),
            lambda o, f: cs.by_roots(torch, n_plain,
                                     lambda q: fabric.fabric_relax_mc_plain(
                                         mid[s][q], o[q], f, deltas, shift,
                                         res, mroots[s][q], col0=col0)),
            mid, o_k, f_k,
            _bare_fabric(cs, cuda, mid, o_k, f_k, deltas, shift, live,
                         mroots, res, col0),
            {"col0": col0})

    if "fabric_sssp" in cases:
        del mid, spare, o_k
        torch.cuda.empty_cache()
        import time

        def wall(fn):
            fn()
            best = None
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                best = ms if best is None else min(best, ms)
            return best

        mesh8 = sharding.make_mesh(8, devices=[dev] * 8)
        residual3 = (ad.res_rows, ad.res_nbr, ad.res_w)
        runs = {
            "one_card": lambda: fabric.fabric_sssp(
                ad.deltas, ad.shift_w, residual3, roots_t, nbr_t, w_t, 2),
            "mesh_8": lambda: sharding.sharded_fabric_step(
                mesh8, plan, ad.matrix, roots, nbr, w, 2, lfa=True),
        }
        out["fabric_sssp"] = {
            label: {"host_wall_ms": wall(fn),
                    "per_call": cs.counted(torch, wrappers, fn)[
                        "kernels_by_wrapper"]}
            for label, fn in runs.items()}
        out["fabric_sssp"]["roots"] = len(names)


def _k18_cases(cs, torch, cuda, wrappers, topologies, dev, cases,
               out) -> None:
    """The ``k18`` and ``k18_single`` rows (module docstring)."""
    import types

    from openr_tpu_torch.ops import csr, legacy, relax

    c = types.SimpleNamespace(torch=torch, dev=dev, legacy=legacy,
                              relax=relax)
    trip_api = hasattr(legacy, "ell_trip")
    unroll = relax.UNROLL
    shapes = {"k18": (lambda: topologies.fabric(**cs.FABRIC), None, 2, 10),
              "k18_single": (lambda: topologies.grid(
                  cs.LSDB100K_SIDE, node_labels=False), cs.LSDB100K_ROOT,
                  40, 50)}
    for label, (gen, root, wave, reps) in shapes.items():
        if label not in cases:
            continue
        _, states, _ = cs.build_cell(topologies, gen)
        graph = csr.build_ell(states["0"])
        mirror = legacy.ell_tensors(graph, dev)
        n_cap, k_cap = graph.in_nbr.shape
        roots = (torch.arange(graph.n_nodes, dtype=torch.int32, device=dev)
                 if root is None else torch.tensor(
                     [graph.node_index[root]], dtype=torch.int32, device=dev))
        r = roots.shape[0]
        sub = min(r, cs.ALLPAIRS_PLAIN_ROOTS)
        if trip_api:
            packed = legacy.packed_mirror(*mirror)
            mid = cs.k18_wavefront(c, packed, roots, n_cap, wave)
            rows = lambda p: legacy.plane_words(p, r)[:, :sub].t()  # noqa: E731
            entry = "ell_trip_batch" if legacy.batched(r) else \
                "ell_trip_single"
            sig = "ppppp" + ("iiiii" if legacy.batched(r) else "iiii") + "p"
        else:
            mid = torch.empty((r, n_cap), dtype=torch.int32, device=dev)
            spare = torch.empty_like(mid)
            f = torch.zeros(1, dtype=torch.int32, device=dev)
            for i in range(wave):
                legacy.ell_relax(mid, spare, f, *mirror, roots, i == 0)
                mid, spare = spare, mid
            rows = lambda p: p[:sub]  # noqa: E731
        want, _ = cs.padded_rounds(c, mirror, roots[:sub],
                                   rows(mid).contiguous(), unroll)
        a, b = mid.clone(), torch.empty_like(mid)
        flags = torch.zeros(2, dtype=torch.int32, device=dev)
        p = [t.data_ptr() for t in (a, b)]
        if trip_api:
            pk = [t.data_ptr() for t in (packed.row_ptr, packed.slots, roots)]
            dims = (n_cap, r, a.shape[1]) if legacy.batched(r) else (n_cap, r)

            def trip():
                legacy.ell_trip(a, b, flags, packed, roots, 1)

            def by_round():
                for k in range(unroll):
                    legacy.ell_trip(*((a, b) if k % 2 == 0 else (b, a)),
                                    flags, packed, roots, 1, 1)

            def bare():
                cuda.launch("legacy", entry, sig, *p, *pk, *dims, unroll, 1,
                            flags.data_ptr())

            def bare_by_round():
                for k in range(unroll):
                    cuda.launch("legacy", entry, sig, *(p if k % 2 == 0
                                                        else p[::-1]),
                                *pk, *dims, 1, 1, flags.data_ptr())
        else:
            pm = [t.data_ptr() for t in (*mirror, roots)]

            def trip():
                for k in range(unroll):
                    legacy.ell_relax(*((a, b) if k % 2 == 0 else (b, a)),
                                     flags[:1], *mirror, roots)

            def bare():
                for k in range(unroll):
                    cuda.launch("legacy", "ell_relax", "ppppppp" + "iiii" + "p",
                                *(p if k % 2 == 0 else p[::-1]), *pm, n_cap,
                                k_cap, r, 0, flags.data_ptr())
        trip()
        cs.check(cs.max_abs_err(torch, rows(a), want) == 0,
                 f"{label}: a trip != {unroll} padded plain rounds")
        extra = {"roots": r, "n_cap": n_cap, "k_cap": k_cap,
                 "rounds": unroll,
                 "plane": list(a.shape), "trip_api": trip_api}
        out[label] = _row(cs, torch, wrappers, trip, bare, extra, reps)
        if trip_api:
            a.copy_(mid)
            by_round()
            cs.check(cs.max_abs_err(torch, rows(a), want) == 0,
                     f"{label}: {unroll} one-round launches != plain")
            out[f"{label}_by_round"] = _row(cs, torch, wrappers, by_round,
                                            bare_by_round, extra, reps)


def _allpairs_case(cs, torch, gpu_solver, wrappers, topologies, dev,
                   out) -> None:
    """The ``allpairs`` row (module docstring)."""
    import time
    import types

    from openr_tpu_torch.ops import csr, legacy, relax

    _, states, _ = cs.build_cell(topologies,
                                 lambda: topologies.fabric(**cs.FABRIC))
    graph = csr.build_ell(states["0"])

    def call():
        return gpu_solver.sssp_all_pairs(graph, device=dev)

    c = types.SimpleNamespace(torch=torch, dev=dev, legacy=legacy,
                              relax=relax)
    sub = torch.arange(cs.ALLPAIRS_PLAIN_ROOTS, dtype=torch.int32,
                       device=dev)
    want, _ = cs.plain_ell_sssp(c, legacy.ell_tensors(graph, dev), sub)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    got = call()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - mem0
    cs.check(cs.max_abs_err(torch, got[:cs.ALLPAIRS_PLAIN_ROOTS], want) == 0,
             "allpairs: the first rows != the padded plain loop")
    del got, want
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["allpairs"] = {
        "roots": graph.n_nodes, "n_cap": graph.n_cap, "k_cap": graph.k_cap,
        "first_ms": first_ms, "host_wall_ms": walls,
        "best_ms": min(walls), "peak_bytes": peak,
        "per_call": cs.counted(torch, wrappers, call)["kernels_by_wrapper"]}


def _k23_cases(cs, torch, cuda, combine, wrappers, dev, cases, out) -> None:
    """The ``k23`` and ``k23_groups`` rows (module docstring)."""
    gen = torch.Generator().manual_seed(23)
    n, nb = 131072, 4

    def plane():
        return torch.randint(0, 1 << 20, (1, n), generator=gen,
                             dtype=torch.int32).to(dev)

    groups = [[plane(), plane()] for _ in range(nb)]
    refs = [plane() for _ in range(nb)]
    flags = torch.zeros(nb, dtype=torch.int32, device=dev)
    # one view a group's flag, made once, as the relaxation loops hold them
    flag_views = [flags[q:q + 1] for q in range(nb)]
    grouped = hasattr(combine, "shard_combine_groups")
    ptrs = [(ctypes.c_longlong * 2)(*(t.data_ptr() for t in grp))
            for grp in groups]

    def bare_group(q):
        """A parent's bare K23 launch of group q."""
        return lambda: cuda.launch(
            "combine", "shard_combine", "piLipp", ctypes.addressof(ptrs[q]),
            2, n, 0, refs[q].data_ptr(), flag_views[q].data_ptr())

    def bare_first(k):
        """This tree's bare K23 launch of the first k groups: one array of
        the members, the refs and the flags."""
        arr = (ctypes.c_longlong * (4 * k))(
            *(t.data_ptr() for grp in groups[:k] for t in grp),
            *(t.data_ptr() for t in refs[:k]),
            *(f.data_ptr() for f in flag_views[:k]))
        return lambda: cuda.launch(
            "combine", "shard_combine", "piiLiiiLi", ctypes.addressof(arr),
            k, 2, n, 0, 1, 0, 0, 1)

    def library(k):
        def fn():
            for grp in groups[:k]:
                torch.minimum(grp[0], grp[1])
        return fn

    def k23_row(label, call, floor, k):
        want = [[t.clone() for t in grp] for grp in groups[:k]]
        w_flags = [torch.zeros(1, dtype=torch.int32, device=dev)
                   for _ in range(k)]
        for grp, ref, f in zip(want, refs, w_flags):
            combine.shard_combine_plain(grp, "min", ref=ref, flag=f)
        flags.zero_()
        call()
        cs.check(cs.max_abs_err(torch, (groups[:k], flag_views[:k]),
                                (want, w_flags)) == 0,
                 f"{label}: kernel != plain")
        r = _row(cs, torch, wrappers, call, floor,
                 {"groups": k, "shape": [1, n], "grouped_entry": grouped})
        r["library_device_ms"], r["library_host_ms"] = cs.device_ms(
            torch, library(k))
        out[label] = r

    if "k23" in cases:
        k23_row("k23", lambda: combine.shard_combine(
            groups[0], "min", ref=refs[0], flag=flag_views[0]),
            bare_first(1) if grouped else bare_group(0), 1)
    if "k23_groups" in cases:
        if grouped:
            def call():
                combine.shard_combine_groups(groups, "min", refs=refs,
                                             flags=flag_views)
            floor = bare_first(nb)
        else:
            def call():
                for q in range(nb):
                    combine.shard_combine(groups[q], "min", ref=refs[q],
                                          flag=flag_views[q])
            floors = [bare_group(q) for q in range(nb)]

            def floor():
                for f in floors:
                    f()
        k23_row("k23_groups", call, floor, nb)


def _held_bytes(torch, held) -> int:
    """The device bytes of the tensors a TE plan holds (its ``held``)."""
    return sum(_held_bytes(torch, v) if isinstance(v, dict)
               else v.numel() * v.element_size()
               for v in held.values() if isinstance(v, (dict, torch.Tensor))
               and (isinstance(v, dict) or v.is_cuda))


def _te_cases(cs, torch, gpu_solver, topologies, dev, cases, out) -> None:
    """The ``te14`` / ``te16`` rows (module docstring), by cell."""
    import types

    from openr_tpu_torch.decision import whatif
    from openr_tpu_torch.ops import te

    names = ("te_relax", "te_relax_jvp", "te_relax_vjp", "te_relax_vjp_jvp",
             "te_link_sum", "te_loss")
    wrappers = {n: (getattr(te, n), None, None) for n in names}
    c = types.SimpleNamespace(torch=torch, te=te, dev=dev)
    cells = (
        ("whatif1k", lambda: topologies.grid(cs.WHATIF1K_SIDE,
                                             node_labels=False),
         cs.WHATIF1K_ROOT, cs.TE_SOURCES[0], cs.TE_SEED),
        ("fabric10k", lambda: topologies.fabric(**cs.FABRIC),
         "pod000-rsw00", cs.TE_SOURCES[1], cs.TE_SEED + 1))

    def sha(ts) -> str:
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    for label, gen, me, n_src, seed in cells:
        _, states, ps = cs.build_cell(topologies, gen)
        solver = gpu_solver.GpuSpfSolver(me, device=dev)
        solver.build_route_db(me, states, ps)
        demands = cs.te_demands(sorted(states["0"].node_names()), n_src,
                                cs.TE_DEMANDS, seed)
        tp, theta0 = whatif.WhatIfEngine(solver).plan_optimize(
            states, ps, demands).te_plan()
        theta = torch.from_numpy(theta0).to(dev)
        b = cs.te_buffers(c, tp, theta)
        out.setdefault("te13_15", {})[label] = {
            "fields_sha": sha([b.fields]), "tfields_sha": sha([b.tfields])}
        work = cs.te_work(tp)
        s, n = tp.srcs.numel(), tp.n_cap
        for case, tan, name in (("te14", False, "K14:te_relax_vjp"),
                                ("te16", True, "K16:te_relax_vjp_jvp")):
            if case not in cases:
                continue
            err, lam_t = cs.te_adjoint_err(c, tp, theta, b, tan)
            cs.check(err[1] <= cs.TE_KERNEL_TOL,
                     f"{case} {label}: rel err {err[1]}")
            kern = te.te_relax_vjp_jvp if tan else te.te_relax_vjp

            def bufs():
                return [torch.empty((s, n), device=dev)
                        for _ in range(2 if tan else 1)] + [
                    torch.empty((s, tp.sh_link.numel()), device=dev),
                    torch.empty((s, tp.rs_link.numel()), device=dev)]

            def call(o, kern=kern, tan=tan):
                if tan:
                    kern(tp, theta, b.v, b.fields, b.tfields, *o, 1.0)
                else:
                    kern(tp, theta, b.fields, *o, 1.0)

            runs = [bufs(), bufs()]
            for o in runs:
                call(o)
            reps = 10 if label == "fabric10k" else 50
            o = bufs()
            dev_ms, host_ms = cs.device_ms(torch, lambda: call(o), reps)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
            call(o)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - mem0
            b_ms, b_by = cs.bound(*work[name])
            out.setdefault(case, {})[label] = {
                "ms": cs.time_ms(torch, lambda: call(o), reps),
                "device_ms": dev_ms, "host_ms": host_ms, "bound_ms": b_ms,
                "bound_by": b_by, "max_abs_err": err[0],
                "max_rel_err": err[1], "lam_t_err": lam_t,
                "sha": sha(runs[0]),
                "deterministic": sha(runs[0]) == sha(runs[1]),
                "peak_bytes": peak,
                "held_bytes": _held_bytes(torch, getattr(tp, "held", {})),
                "per_call": cs.counted(torch, wrappers, lambda: call(o))[
                    "kernels_by_wrapper"],
                "sources": s, "n_cap": n, "trips": tp.trips,
                "live_res_entries": int(tp.inv_ptr[-1])}
            if hasattr(te, "adjoint_layout"):
                out[case][label]["layout"] = cs.te_layouts(c, tp)[name]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="tree holding openr_tpu_torch/")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--define", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="run on csrc/<lib>.cu built with -DNAME=VALUE")
    ap.add_argument("--lib", default="incremental",
                    help="the source --define rebuilds")
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
    from openr_tpu_torch.ops import combine, cuda, fabric, ksp2, legacy, relax

    from openr_tpu_torch.ops import incremental as inc

    out = {"root": a.root or "."}
    if a.define:
        out["variant"] = {"defines": a.define,
                          "library": _variant(cuda, a.lib, a.define).name}
        if a.build_only:
            print(json.dumps(out), flush=True)
            return 0
    dev = torch.device(cs.DEVICE)
    wrappers = {n: (w, None, None) for n, w in (
        ("sssp_init", relax.sssp_init), ("relax_step", relax.relax_step),
        *((k, getattr(inc, k)) for k in (
            "scatter_set", "scatter_window", "scatter_parts",
            "parent_plane", "parent_shift_mc", "parent_fill")
          if hasattr(inc, k)),
        ("fabric_relax", fabric.fabric_relax),
        ("fabric_relax_mc", fabric.fabric_relax_mc),
        ("fabric_extent", fabric.fabric_extent),
        ("shard_combine", combine.shard_combine),
        *((k, getattr(legacy, k)) for k in ("ell_trip", "ell_relax",
                                            "ell_transpose")
          if hasattr(legacy, k)))}

    def solved(gen, me, keep=None, **kw):
        _, states, ps = cs.build_cell(topologies, gen)
        solver = gpu_solver.GpuSpfSolver(me, device=dev, **kw)
        solver.build_route_db(me, states, ps)
        ad = solver._area_dev["0"]
        nbr, w, _ = ad.plan.out_links(states["0"], me)
        args = (ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w,
                ad.plan.node_index[me], torch.tensor(nbr, device=dev),
                torch.tensor(w, device=dev))
        if keep is not None:
            keep["states"] = states
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

    if {"k21", "k21_mc", "fabric_sssp"} & set(cases):
        _k21_cases(cs, torch, cuda, fabric, relax, wrappers, solved,
                   topologies, dev, cases, out)
    if {"k18", "k18_single"} & set(cases):
        _k18_cases(cs, torch, cuda, wrappers, topologies, dev, cases, out)
    if "allpairs" in cases:
        _allpairs_case(cs, torch, gpu_solver, wrappers, topologies, dev, out)
    if {"k23", "k23_groups"} & set(cases):
        _k23_cases(cs, torch, cuda, combine, wrappers, dev, cases, out)
    if {"te14", "te16"} & set(cases):
        _te_cases(cs, torch, gpu_solver, topologies, dev, cases, out)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    out["card"] = smi.stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
