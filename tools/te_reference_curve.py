"""The JAX package's TE loss curve and gradient on whatif1k's inputs, on
the CPU.

    JAX_PLATFORMS=cpu python -m tools.te_reference_curve [--iters N]
        [--lr X] [--grad-check]

Builds whatif1k as ``chip_smoke.py``'s TE phase does (a 32 x 32 grid,
vantage ``node-16-16``, 1,024 demands from 32 seeded sources, the same
``te_demands``), solves it with ``TpuSpfSolver`` and runs the reference
``WhatIfEngine.plan_optimize(...).run()`` for ``--iters`` iterations
(5 by default) at ``--lr`` (the engine's default 2.0). Prints one JSON
line: the loss curve, the trip count, the max utilization before and
after, the number of proposed changes and the wall time. The port's
curve on the same inputs is the ``loss_curve_head`` of the
``whatif1k TE`` line that ``chip_smoke.py`` prints.

``--grad-check`` also takes the first step's inputs and prints a second
line: along three seeded directions u, the central difference of the
loss in float64 (a float64 copy of ``ops/sweep.py::_make_te``), the
reference's ``grad . u`` in float64 and float32, and the port's
(``openr_tpu_torch.ops.te.te_step_plain``, forward-over-reverse) in
float64; and the largest difference of the float32 grads of the two
packages over the largest reference grad. This option imports the port
beside the JAX package.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import time

# a run of the reference leaves no compilation cache behind
os.environ.setdefault("OPENR_TPU_XLA_CACHE", "off")
os.environ.setdefault("OPENR_TPU_AOT_CACHE", "off")


def _grad_check(args, static) -> dict:
    """The derivative check of the module docstring on one step's
    inputs ``args`` (numpy, the reference's order) and static
    arguments."""
    import jax
    import numpy as np

    jax.config.update("jax_enable_x64", True)
    import torch

    from openr_tpu.ops import sweep as jsweep
    from openr_tpu_torch import weights
    from openr_tpu_torch.ops import te

    src = inspect.getsource(jsweep._make_te).replace(
        "jnp.float32", "jnp.float64").replace("_BIG_F", "np.float64(1e9)")
    ns = {"np": np}
    exec(src, ns)  # noqa: S102 - a float64 copy of the reference function
    a64 = [a.astype(np.float64) if a.dtype == np.float32 else a
           for a in args]
    f64 = jax.jit(ns["_make_te"](*static))
    f32 = jax.jit(jsweep._make_te(*static))
    r64 = [np.asarray(x) for x in f64(*a64)]
    r32 = [np.asarray(x) for x in f32(*args)]
    plan, theta, tau, tau_u = weights.te_inputs_from_jax(
        args, n_cap=static[5], trips=static[10], has_res=static[9],
        device="cpu")
    p32 = te.te_step_plain(plan, theta, tau, tau_u)[1].numpy()
    p64 = te.te_step_plain(plan, theta.double(), tau, tau_u)[1].numpy()
    rng = np.random.default_rng(0)
    eps = 1e-5
    rows = []
    for _ in range(3):
        u = rng.standard_normal(len(a64[0]))
        lp = float(f64(a64[0] + eps * u, *a64[1:])[0])
        lm = float(f64(a64[0] - eps * u, *a64[1:])[0])
        rows.append({
            "fd64": (lp - lm) / (2 * eps),
            "jax64": float(r64[1] @ u), "jax32": float(r32[1] @ u),
            "port64": float(p64 @ u),
        })
    return {
        "directions": rows,
        "grad_rel_diff_port32_jax32": float(
            np.abs(p32 - r32[1]).max() / np.abs(r32[1]).max()),
        "torch_threads": torch.get_num_threads(),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--lr", type=float, default=2.0)
    ap.add_argument("--grad-check", action="store_true")
    args = ap.parse_args()

    import numpy as np

    import chip_smoke
    from openr_tpu.decision import whatif
    from openr_tpu.decision.tpu_solver import TpuSpfSolver
    from openr_tpu.models import topologies

    side, root = chip_smoke.WHATIF1K_SIDE, chip_smoke.WHATIF1K_ROOT
    adj_dbs, prefix_dbs = topologies.grid(side, node_labels=False)
    states, ps = topologies.build_states(adj_dbs, prefix_dbs)
    solver = TpuSpfSolver(root)
    solver.build_route_db(root, states, ps)
    demands = chip_smoke.te_demands(
        sorted(states["0"].node_names()), chip_smoke.TE_SOURCES[0],
        chip_smoke.TE_DEMANDS, chip_smoke.TE_SEED)
    first = {}
    factory = whatif.te_step

    def spy(*static):
        name, step = factory(*static)

        def run(*a):
            first.setdefault("step", ([np.asarray(x) for x in a], static))
            return step(*a)

        return name, run

    whatif.te_step = spy
    t0 = time.perf_counter()
    try:
        out = whatif.WhatIfEngine(solver).plan_optimize(
            states, ps, demands, iters=args.iters, lr=args.lr).run()
    finally:
        whatif.te_step = factory
    print(json.dumps({
        "cell": "whatif1k", "iters": args.iters, "lr": args.lr,
        "trips": out["trips"], "demands": out["demands"],
        "loss_curve": out["loss_curve"],
        "max_util_before": out["max_util_before"],
        "max_util_after": out["max_util_after"],
        "changes": len(out["changes"]),
        "wall_s": time.perf_counter() - t0,
    }), flush=True)
    if args.grad_check:
        print(json.dumps(_grad_check(*first["step"])), flush=True)


if __name__ == "__main__":
    main()
