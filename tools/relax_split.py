"""Time split of K1s ``sssp_init`` and K1 ``relax_step`` at the shapes of
the paths that run them, for the ``openr_tpu_torch`` package found under
``--root`` (default: this checkout), so that two trees can be compared
in one run on the same card:

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
  steps past the seed rows.

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
import inspect
import json
import subprocess
import sys
from pathlib import Path

CASES = ("k1s", "k1", "k1_res", "k1_ksp2")


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


def _wavefront(torch, relax, dist0, deltas, sw, residual, steps: int):
    mid, spare = dist0.clone(), torch.empty_like(dist0)
    flag = torch.zeros(1, dtype=torch.int32, device=dist0.device)
    for _ in range(steps):
        relax.relax_step(mid, spare, flag, deltas, sw, residual)
        mid, spare = spare, mid
    return mid


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

    dev = torch.device(cs.DEVICE)
    wrappers = {n: (w, None, None) for n, w in (
        ("sssp_init", relax.sssp_init), ("relax_step", relax.relax_step))}
    out = {"root": a.root or "."}

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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    out["card"] = smi.stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
