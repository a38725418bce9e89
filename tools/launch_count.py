"""Device work of one lsdb100k incremental build, of one flapstorm100k
streaming epoch and of one cold fused build (``chip_smoke.py``'s fused
cell: vantage ``hub`` in 4 grid(56) areas), for the ``openr_tpu_torch``
package found under ``--root`` (default: this checkout), so that two
trees can be compared in one run on the same card:

    python -m tools.launch_count [--root DIR] [--builds N]

Needs a CUDA card. Each counted build or epoch follows a flap of
``adj_dbs[1]`` (chip_smoke.py's ``flap``, a metric increase) and is
held to a fresh cold solve's RIB; the fused build must solve its areas
in one fused dispatch, its RIB equal to an earlier solver's. Counts are
``chip_smoke.counted``'s:
kernel launches by wrapper (every ``ops`` function with a ``launches``
count), torch ops on the card by name (clones, fills, copies, reads),
and their sum; beside them the CUDA tensors allocated, the host flag
reads (``relax.read_flag``) and, for the incremental build and the storm
epoch, the allocations of each K1s and K6 call
(``chip_smoke.churn_allocations``) and, where the tree's solver stages
its uploads, its staged copies (``staging``).
``cone`` splits the tree's cone work of one incremental solve (the
spread to the closure, the count, the fallback and the seed plane, one
``cone_resolve`` launch: a tree without that wrapper stops there) on
the last build's own inputs: device ms alone and host ms to enqueue
(``chip_smoke.device_ms``) and the synced host wall, each less the
seeded cone's copy. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pkgutil
import sys
import time
from pathlib import Path


def _wrappers(ops_pkg) -> dict:
    """name -> (wrapper, None, None) for every counted kernel wrapper."""
    out = {}
    for m in pkgutil.iter_modules(ops_pkg.__path__):
        mod = importlib.import_module(f"{ops_pkg.__name__}.{m.name}")
        for name, fn in vars(mod).items():
            if (callable(fn) and getattr(fn, "__module__", None)
                    == mod.__name__
                    and isinstance(getattr(fn, "launches", None), int)):
                out[f"{m.name}.{name}"] = (fn, None, None)
    return out


def _counted(cs, torch, relax, wrappers, fn, inc=None, solver=None) -> dict:
    """``chip_smoke.counted`` and the flag reads; with ``inc`` (the
    tree's incremental module) also the CUDA tensors each K1s and K6
    call of the solve allocated (``chip_smoke.churn_allocations``), and
    ``solver``'s staged copies where it counts them."""
    reads0 = relax.read_flag.reads
    counts = getattr(solver, "staging_counts", None)
    st0 = counts() if counts else None
    if inc is None:
        n = cs.counted(torch, wrappers, fn)
    else:
        n, allocs = cs.churn_allocations(
            torch, inc, lambda: cs.counted(torch, wrappers, fn))
        n.update(allocs)
    n["flag_reads"] = relax.read_flag.reads - reads0
    if counts:
        n["staging"] = cs.staging_delta(st0, counts())
    return n


def _wall_ms(torch, fn, reps: int = 20) -> float:
    """Host wall of ``fn`` run to its end on the card, a call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _cone_split(cs, torch, inc, relax, ci) -> dict:
    """The cone part of an incremental solve: one ``cone_resolve``
    launch on the last build's own inputs."""
    par, lane = ci["par"], ci["lane"]
    seeded = inc.cone_seed(*ci["cargs"])
    aff = seeded.clone()

    def copy():
        aff.copy_(seeded)

    def whole():
        copy()
        inc.cone_resolve(par, aff, ci["prev_dist"], ci["dist0"], lane[7],
                         lane[8], ci["cone_limit"],
                         relax.max_trips(par.shape[1]))

    copy_dev, copy_host = cs.device_ms(torch, copy)
    dev_ms, host_ms = cs.device_ms(torch, whole)
    copy_wall = _wall_ms(torch, copy)
    return {"device_ms": dev_ms - copy_dev, "host_ms": host_ms - copy_host,
            "wall_ms": _wall_ms(torch, whole) - copy_wall,
            "seed_copy_device_ms": copy_dev, "seed_copy_host_ms": copy_host,
            "seed_copy_wall_ms": copy_wall}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="tree holding openr_tpu_torch/")
    ap.add_argument("--builds", type=int, default=2)
    a = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    if a.root:
        sys.path.insert(0, str(Path(a.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("launch_count: no CUDA device available", file=sys.stderr)
        return 2
    import openr_tpu_torch.ops as ops_pkg
    from openr_tpu_torch.decision import gpu_solver
    from openr_tpu_torch.ops import incremental, relax
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.types import (
        AdjacencyDatabase,
        PrefixDatabase,
        PrefixEntry,
    )

    wrappers = _wrappers(ops_pkg)
    root = cs.LSDB100K_ROOT
    adj_dbs, states, ps = cs.build_cell(
        topologies, lambda: topologies.grid(cs.LSDB100K_SIDE,
                                            node_labels=False))
    by_name = {db.this_node_name: db for db in adj_dbs}

    def flap(i: int) -> None:
        cs.flap(AdjacencyDatabase, states, adj_dbs, by_name, 1, i)

    def held(db, label: str) -> None:
        fresh = gpu_solver.GpuSpfSolver(root, device=cs.DEVICE)
        cs.check(cs.rib_equal(fresh.build_route_db(root, states, ps), db),
                 f"{label}: RIB != a fresh cold solve")

    inc = gpu_solver.GpuSpfSolver(root, device=cs.DEVICE,
                                  incremental_spf=True)
    stream = gpu_solver.GpuSpfSolver(root, device=cs.DEVICE,
                                     streaming_pipeline=True,
                                     small_graph_nodes=0)
    for s in (inc, stream):
        s.build_route_db(root, states, ps)
    out = {"root": a.root or ".", "incremental_build": [],
           "storm_epoch": []}
    for i in range(a.builds):
        flap(2 * i)
        box = {}
        out["incremental_build"].append(_counted(
            cs, torch, relax, wrappers,
            lambda: box.update(db=inc.build_route_db(root, states, ps)),
            incremental, inc))
        cs.check(inc.last_device_stats.get("incremental") is True,
                 "the counted build must be incremental")
        held(box["db"], "incremental build")
        box = {}
        out["storm_epoch"].append(_counted(
            cs, torch, relax, wrappers,
            lambda: box.update(db=stream.collect_route_db(
                stream.dispatch_route_db(root, states, ps))), incremental,
            stream))
        cs.check(bool(stream.last_timing.get("stream")),
                 "the counted epoch must stream")
        held(box["db"], "storm epoch")
        flap(2 * i + 1)
        inc.build_route_db(root, states, ps)
        stream.collect_route_db(stream.dispatch_route_db(root, states, ps))
    cs.check(inc.last_device_stats.get("incremental") is True,
             "the cone's inputs must be an incremental build's")
    out["cone"] = _cone_split(cs, torch, incremental, relax,
                              cs.churn_inputs(relax, incremental, inc))
    fstates, fps = topologies.build_states(*cs.fused_cell(
        AdjacencyDatabase, PrefixDatabase, PrefixEntry, topologies,
        cs.FUSED_SIDE, cs.FUSED_AREAS))

    def fused_solver():
        return gpu_solver.GpuSpfSolver(
            "hub", device=cs.DEVICE,
            small_graph_nodes=cs.AUTO_SMALL_GRAPH_NODES)

    first = fused_solver().build_route_db("hub", fstates, fps)
    fsolver, box = fused_solver(), {}
    out["fused_build"] = _counted(cs, torch, relax, wrappers,
                                 lambda: box.update(
        db=fsolver.build_route_db("hub", fstates, fps)))
    cs.check(fsolver.last_device_stats.get("fused") == cs.FUSED_AREAS
             and cs.rib_equal(first, box["db"]),
             "the fused build must fuse its areas and equal the first one")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
