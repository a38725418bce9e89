"""Host time of the cold builds, and what ``chip_smoke.py``'s own op
counter does to it: the fused build (``chip_smoke.py``'s fused cell:
vantage ``hub`` in 4 grid(56) areas) and lsdb100k's first build, each
on a fresh solver, for the ``openr_tpu_torch`` package found under
``--root`` (default: this checkout), first as the process starts and
then after one ``chip_smoke.counted`` call (a ``TorchDispatchMode``,
whose first use imports torch's tracing stack), so that two trees can
be compared in one run on the same card:

    python -m tools.host_sync [--root DIR] [--builds N]

Needs a CUDA card. Beside each build's wall and its ``sync_ms`` (the
solver's host preparation) it gives ``chip_smoke.HostMeter``'s reading:
the collector's time and collections by generation, the main thread's
and the process's CPU time, and the objects the collector tracks. Each
build's RIB is held to the first fused build's, or to the first
lsdb100k build's. Prints one JSON line a build.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


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
        print("host_sync: no CUDA device available", file=sys.stderr)
        return 2
    from openr_tpu_torch.decision import gpu_solver
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch.ops import cuda
    from openr_tpu_torch.types import (
        AdjacencyDatabase,
        PrefixDatabase,
        PrefixEntry,
    )

    cuda.build_all()
    # cell -> (root, states, prefixes, solver options), as chip_smoke.py
    # builds them (phases 2b and 3)
    cells = {
        "fused": ("hub", *topologies.build_states(*cs.fused_cell(
            AdjacencyDatabase, PrefixDatabase, PrefixEntry, topologies,
            cs.FUSED_SIDE, cs.FUSED_AREAS)),
            {"small_graph_nodes": cs.AUTO_SMALL_GRAPH_NODES}),
        "lsdb100k": (cs.LSDB100K_ROOT, *cs.build_cell(
            topologies, lambda: topologies.grid(
                cs.LSDB100K_SIDE, node_labels=False))[1:], {}),
    }
    first = {}
    for stage in ("fresh", "after counter"):
        if stage == "after counter":
            cs.counted(torch, {}, lambda: torch.ones(
                1, device=cs.DEVICE) + 1)
        for i in range(a.builds):
            for cell, (root, states, ps, kw) in cells.items():
                solver = gpu_solver.GpuSpfSolver(root, device=cs.DEVICE,
                                                 **kw)
                torch.cuda.synchronize()
                with cs.HostMeter() as meter:
                    t0 = time.perf_counter()
                    db = solver.build_route_db(root, states, ps)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                cs.check(cs.rib_equal(first.setdefault(cell, db), db),
                         f"{cell}: RIB != the first build's")
                areas = solver.last_timing.get("areas")
                tm = (next(iter(areas.values())) if areas
                      else solver.last_timing)
                print(json.dumps({
                    "root": a.root or ".", "stage": stage, "cell": cell,
                    "build": i, "wall_ms": wall,
                    "sync_ms": tm.get("sync_ms"),
                    "exec_ms": tm.get("exec_ms"), **meter.result}),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
