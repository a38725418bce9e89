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
     (96 pods x 8 planes x 64 rsws, 36 spines a plane; LFA on, as the
     bench's config 3 runs it: the oracle runs with LFA too), the
     residual relaxation kernel against its plain version on fabric10k,
     whose pod-crossing spine tier lands in the residual ELL (the row
     ``K1:relax_step[residual]``: one cooperative launch, split into
     device time, host enqueue and the bare launch), and K3 and
     K4 with their LFA columns against their plain versions on
     fabric10k's own inputs (K3 ``[lfa]`` also split into device time,
     host enqueue and the bare launch; each call one launch), and both
     on tg1k's own inputs cut to 1,000 prefix rows (P below one K4
     tile); the fabric10k LFA build is a path of its
     own (counts zeroed before it, read after); then one flap of a
     root neighbour through the incremental solve with LFA, equal to
     the cold solve and the oracle;
  2b. the fused path: vantage ``hub`` in 4 areas, each a grid 56 x 56
     with the hub at its centre (3,136 nodes, n_cap 4096, one loopback
     per node but the hub's, seeded link metrics 1-9) — one fused
     dispatch of the 4 areas, RIB equal to the oracle, each area's pull
     buffer equal to its unfused solve's, the fused build's launches
     and flag reads beside each unfused area's and their sum, and the
     fused K1s-K4 (a leading area axis) against their plain versions
     (K2's ladder pass over 3 passes of run_bucketed's stamps with every
     other lane shut: stamps and counters too); the timed fused build
     follows a full garbage collection and carries ``HostMeter``'s
     reading (collector time, CPU times), and three more cold builds on
     fresh solvers (collector on, off, on) show its share of the host;
     then a wide group: the hub in 10 grids of 16 x 16, one fused
     dispatch, RIB equal to the oracle and to the unfused solve;
  3. the main path: the lsdb100k cell (grid 316 x 316 = 99,856 nodes,
     ~400k directed adjacencies, one loopback prefix per node, root
     node-158-158, default settings: bucketed kernel, sentinels on, no
     LFA) through ``GpuSpfSolver.build_route_db`` three times — the
     first a cold build (after a full garbage collection, each build
     with ``HostMeter``'s reading), the others reading the delta
     payload — with every kernel's launch count zeroed just before and
     read just after;
     each kernel must have launched;
  4. the lsdb100k RIB against the CPU oracle (``SpfSolver``);
  5. every kernel wrapper of the cold path against its plain PyTorch
     version on the card, on the main path's own tensors (exact int32
     equality, tolerance 0), timed with CUDA events beside its plain
     version and its bound; K2's ladder pass over 3 passes from a
     wavefront, each on the rung the last doubled (both plane buffers,
     rungs, flag); K2's class pick and ladder pass, K3, K4 and K4
     ``[stream]`` also split into device time alone, host enqueue and
     the bare launch's host cost, and each counted as one kernel launch
     and no torch op; K1s (timed into held outputs, as the churn and
     storm solves call it; the allocating call beside) and K1 split the
     same way, one launch each, and both at seeded edge cases
     (``relax_cases``: held outputs over two calls, lanes with an odd
     ELL, an ``[mc]`` window of odd width, 256 ``[fabric]`` roots, the
     KSP2 seed rows; no residual, repeated and pad rows, D past the
     register chunk, a residual shared by 64 lanes, a closed gate, an
     ``[mc]`` window), each equal to plain and one launch; K3 and K4
     also at the ``TAIL_SHAPES`` edge shapes
     on seeded synthetic inputs (A and D past 16, A past the register
     cache, P below a tile, lanes, a shared matrix, more K4 tiles than
     the co-resident grid), with and without LFA, the budgets below the
     changed rows and past P, the incremental tail and the ok column;
     K4 also on 8 x SMs + 64 lanes, where every block of its grid takes
     more tiles than it caches and reads the later tiles' rows again;
  6. the churn path: a second lsdb100k solver with ``incremental_spf``
     takes a cold first build, then 4 flap steps (the victim
     ``adj_dbs[1]``'s links, both directions, metric 50 + i % 5, through
     the changelog path: K5 scatter, then the incremental solve), and a
     fresh solver with ``incremental_cone_frac=0.0`` one more step, so
     the cone fallback runs on the card. Every step's RIB equals a cold
     solve of the same state, two equal the oracle; the 4 flap steps
     are incremental and do not fall back, the last one does. Each
     step prints its time split, cone, trips, rounds, launches, flag
     reads and bytes moved; the counts are zeroed before each
     incremental build and read after it;
  7. the churn kernels (K5 in place, the old planes, K6, K7, K4 with
     the incremental tail) and the whole incremental solve against
     their plain versions on the last flap step's own inputs (and the
     K1s outputs the churn solver holds: the last step's, apart from its
     ``prev_dist``), timed
     beside their bounds and, for K5 and K7, the one PyTorch call that
     computes the same scatter; K5, the old planes, K6 (into the held
     plane, the main path's call) and K7 also split into device time
     alone, host enqueue and (K5, K6, K7) the bare launch's host cost;
     K5 with both planes in one launch, and a sync's whole K5 step (the
     staged copy and the launch, one plane and both: one launch, at
     most one copy); K6 and K5 on seeded edge cases (``parent_cases``,
     ``scatter_cases``), each call one launch; the cone (K8 + K9, ``cone_resolve``: one
     cooperative launch) against its plain composition, tolerance 0,
     each call one launch and no torch op, on the last flap step, the
     fallback step, a subtree below the root and a deep chain (lane 0
     one chain through all n_cap nodes), each case's sweeps and device
     ms printed, its row split like K7's; then the device work (kernel
     launches and
     torch ops) of K7 alone (one launch, no fill), of the old planes
     alone (one launch a plane), of one incremental SSSP and of one
     incremental build, whose RIB equals a cold solve's and whose K1s
     and K6 allocate nothing (``churn_allocations``), with its staged
     copies; ``staging_cases``: 12 staged uploads queued behind a device
     sleep, each equal to its plain upload;
  8. flapstorm100k (BASELINE config 5, bench.py's flapstorm lane): a
     ``GpuSpfSolver(streaming_pipeline=True, small_graph_nodes=0)`` on
     the lsdb100k cell takes a cold build and a warm-up flap of
     ``adj_dbs[1]`` (round 7919), then 200 flaps asked at 100 Hz over
     ``adj_dbs[1..8]``, each epoch ``dispatch_route_db``,
     ``collect_route_db`` and ``calculate_update`` against the previous
     RIB, with the counts zeroed before each epoch and read after it;
     then a flap of the root's own links (over the 64-row budget: the
     full pull, the budget grows), three quiet flaps (it settles back to
     64) and an idle epoch (0 rows, exactly 1,308 B). The RIB at storm
     epochs 0, 100 and 199 and at the idle epoch equals a fresh
     solver's cold solve, the last also the oracle's; one more flap
     epoch is counted (kernel launches and torch ops; its K1s allocates
     nothing) and held to a cold solve; the cone of one more epoch is held to plain (one launch). It
     prints every
     epoch (changed rows, budget, overflow, bytes, launches, flag reads,
     time split) and a summary: the p50 / p99 of flap-apply to RIB
     delta, bytes per epoch, streamed epochs, overflows and the rate
     achieved against the 100 Hz asked (the cold checks are not timed
     as storm). K4
     ``[stream]`` is held against its plain version on the main path's
     selection outputs;
  9. UCMP on fabric10k: 13 anycast VIPs announced by 4 remote rsws each
     (weights 1-9, prefix-weight and adjacency-weight modes; one VIP
     with weights past 2^24 whose path counts overflow), solved by
     ``GpuSpfSolver(enable_ucmp=True)``: the RIB equals
     ``SpfSolver(enable_ucmp=True)``'s, 12 VIPs resolve on the card and
     the overflow one on the host walk; ``base_sssp`` and
     ``ucmp_propagate`` against their plain versions on fabric10k and
     on the lsdb100k grid (the deep DAG), timed on fabric10k;
  10. KSP2 (BASELINE config 4): first a small WAN (8 regions of 16 x
     16, 64 KSP2 destinations) whose whole RIB equals the oracle's; then
     wan50k (bench.py:1138-1145: 48 regions of 32 x 32, 49,152 nodes,
     64 SR_MPLS + KSP2_ED_ECMP prefixes, root ``r00-n08-08``) through
     ``GpuSpfSolver.build_route_db``: a cold build and 3 churn rounds
     (every link of a root neighbour to 90, of a far region's hub to
     40, of a node beside the root to 3), each on the delta path, with
     ``LinkState.run_spf`` wrapped to count calls (0), every fast-path
     route and every 16th KSP2 route (sorted) equal to the oracle's on a
     separate copy of the LSDB, and each round's ``ksp2_*`` timings and
     delta stats printed; the counts are zeroed before the cold build
     and read after the last round. Then K10 ``overlay_planes``, K11
     ``masked_delta`` (also at k_cap 4, where rows overflow) and K1
     over the lane planes against their plain versions (K1 ``[ksp2]``
     split and one launch), the whole
     masked batch (8 rows) against its plain run on CPU copies, and
     ``masked_rows_update`` through its chunked
     stateless path (a lowered ``_MAX_RESIDENT_ROWS``) equal to the
     resident rows;
  11. what-if sweeps: whatif1k (``grid(32, node_labels=False)``, root
     ``node-16-16``) ``WhatIfEngine.sweep(order=1)``: 1,984 scenarios in
     one dispatch of 2,048 lanes, with the solver's bucketed and then
     sync kernel (the same rows), 16 sampled verdicts equal to a host
     ``run_spf`` without the link; K10, K12 ``sweep_verdicts`` and K1
     over the lanes on the dispatch's own inputs against their plain
     versions, and the whole sweep on its first 64 lanes against its
     plain run on CPU copies; fabric10k
     (root ``pod000-rsw00``): ``max_scenarios=2048`` in two dispatches
     of 1,024 scenarios over the residual ELL (2,048 lanes each: the
     baseline lane makes 1,025, padded to a power of two as the
     reference pads), the sweep's peak device memory, 4 sampled
     verdicts and a spine and a link drain against the host; on the
     first dispatch's own inputs, sliced to 64 lanes, K10 (shift and
     residual planes), one K1 step over the per-lane residual weights
     with the shared index tables, K12 and the whole sweep against their
     plain versions.
  12. differentiable TE, on phase 11's solvers: whatif1k (1,024 demands
     from 32 seeded sources, volumes 1-9) and fabric10k (1,024 demands
     from 64 sources; residual rows) through ``WhatIfEngine.optimize``
     at its defaults (40 iterations, lr 2.0, tau 1.0), the counts zeroed
     before each and read after: each TE kernel (K13-K17, ``csrc/te.cu``)
     launched once a step (K14s twice), the loss curve finite; each
     prints ``optimize_ms``, ``te_step_ms`` with its split by kernel,
     launches, flag reads, peak device bytes and the head of its loss
     curve. ``te_step`` on the card is held against ``te_step_plain`` on
     CPU copies (fabric10k: its first 2 sources) within rel 1e-4 of each
     output's largest magnitude (loss, cost, util) and 1e-3 (grad); each
     TE kernel against its plain version on the card tensors within rel
     1e-4 (K13 / K15 on 4 mid-run trips, K14 / K16 over the whole run,
     K14s / K17 on the step's buffers), timed on whatif1k; K14 and K16
     (the adjoint, one cluster launch each) also over all 64 fabric10k
     sources, the cluster layout the step runs, K14 twice with the same
     bits, and every TE kernel timed at fabric10k's whole plan beside
     its bound (``fabric10k_ms``, ``fabric10k_bound_ms`` in the kernels
     line); K14's and K16's cluster size and shared bytes at both cells
     are printed; K14 and K16 with shared memory holding nothing (the
     layout of a graph too large for it) against plain and the same
     bits as at the card's layout (whatif1k, fabric10k's 2 sources).
     Then the diamond of tests/test_whatif.py:353 (lr 0.05, 30
     iterations): its loss falls and a metric moves.
  13. the all-roots paths. (a) The legacy ELL pipeline
     (``gpu_solver.legacy_pipeline``: K18 ``ell_trip``, K19
     ``ell_next_hop``, K20 ``ell_select``, ``csrc/legacy.cu``) on
     ``build_ell`` of the lsdb100k LSDB as phase 8 left it, root
     node-158-158, the counts zeroed before it and read after: every
     prefix's metric and route equal a fresh oracle RIB's, the distances
     equal the main path's (phase 8's solver's resident mirror); the
     whole K18 loop (one launch and one flag read a trip, counted) and
     K19 loop against the plain loops over the padded mirror
     (``legacy.run_rounds`` with the plain round), one K18 trip (the
     single-root tiling), one K19 round and K20 against their plain
     versions, K18 also on seeded edge cases (R = 1, 31, 33, an
     overloaded root, links down). Then ``sssp_all_pairs`` from all
     7,200 fabric10k roots ([7200, 8192] int32), its own counts: the
     first 64 roots' rows equal the plain loop's, 8 seeded rows a host
     ``run_spf``; it prints ``allpairs_ms``, roots/s, trips, K18
     launches, flag reads and peak device bytes, and holds and times a
     K18 trip over every root (``[allpairs]``, the batched tiling; plain
     256 roots a call; ms a round) and the transpose (K18t).
     (b) Whole-fabric RIBs (``GpuSpfSolver.build_fabric_route_dbs``;
     ``ops/fabric.py``: K1s seeds and K3 selection with a root axis, K21
     ``fabric_relax``, K21e ``fabric_extent``, ``csrc/fabric.cu``) on
     tg1k (all 1,024 vantages of ``grid(32)``), tg1k-lfa (the same grid
     with seeded link metrics 1-16, LFA on) and fabric10k (the 4,096 rsws
     of pods 0-63, LFA on), cold solvers (trip bound 2, retries by the
     vote) and warm ones (a single-vantage build first), each build in
     its own count window; the path read is fabric10k's cold build. Then
     the array-level ``parallel/sharding.sharded_fabric_step`` on
     fabric10k, its own counts (it also unpacks the masks, K22
     ``unpack_bits``). Every 64th tg1k vantage's RIB equals the
     oracle's, the warm RIBs the cold ones, every 128th tg1k-lfa RIB the
     LFA oracle's (with backups), fabric10k's ``pod063-rsw63`` RIB the
     oracle's (LFA) and every 2048th the single-vantage device solve's;
     the step's arrays equal the plain step's on the first 64 roots
     (tg1k, tg1k-lfa, which must hold backups) and on all 4,096
     (fabric10k, 256 roots a call), and ``sharded_fabric_step``'s the
     solver's step, and tg1k's step at 2 trips (unconverged) equal to
     the plain step's, ``converged`` included; each fabric kernel
     against its plain version over all 4,096 fabric10k roots, timed
     there (K3 also with skewed uplink costs, which must leave backups;
     K21e with the class liveness; K21 one launch, split into device,
     host and bare launch, and on ``K21_CASES``: seeded planes and
     tables with root slabs' tails, a column window holding some roots,
     rows past the shared copy, D of 1, 2, 5 and 12, no residual, gated
     roots, pad rows, INF_E entries inside a row's extent and a void
     class, each one launch). Each build prints ``fabric_ms``
     and its split (sync, exec, the CUDA-event SSSP and tail, pull, RIBs,
     host routes), trips, the bound and its retries, bytes moved, peak
     device bytes, its launches and the wall of full garbage collections
     inside it.
  14. the multichip tier on logical shards of the card (``make_mesh(8)``
     over 8 copies of it: batch 4 x graph 2). lsdb100k_mc
     (bench.py:1171-1183: the lsdb100k LSDB as phase 13 left it, the
     tier's threshold 65536, so n_cap 131072 engages it; bucketed,
     incremental): a cold build, 4 flaps of ``adj_dbs[1]``, a forced cone
     fallback (``incremental_cone_frac=0.0``), a cold build with
     ``spf_kernel="sync"`` and 4 more flaps under sync, each in its
     path's count window (``mc`` for the cold builds, ``mc_incr`` for
     the churn), each build's published columns (metric, s3 / nh words,
     LFA columns) equal to a single-device solver's byte for byte and
     its RIB too, the cold build's RIB and the last bucketed flap's
     equal to a fresh oracle's; each prints trips, rounds, cone,
     fell_back and halo exchanges beside the single
     build's, build_ms, its split and per-shard ms. K1s, K1, K2, K5, K6,
     K7 ``[mc]`` (K5 ``[mc]`` as a sync runs it: every part of the
     card's resident shift plane in one ``scatter_parts`` launch, split
     like K7), K2's ladder pass on the member's own classes and K23
     (min, max, sum) against their plain versions at those shapes (the
     class pick counted as one launch and no torch op); K23 over all 4
     groups of the mesh in one launch (``[groups]``, beside
     ``torch.minimum`` once a group) and on ``COMBINE_CASES`` (1 to 9
     groups of 1 to 16 members, widths 0 and not a multiple of 4,
     unaligned planes, min / max / sum, with and without ref and flag,
     ``also`` groups); K3 and K4 on the
     tier's tail (the arguments ``mc_pipeline`` passes them in one more
     flap build) against plain, each call one launch, and in that build
     every member's cone (``cone_resolve`` without a plane) and K9 seed
     plane against plain, each one launch. fabric10k's
     4,096 vantages through
     ``build_fabric_route_dbs(mesh=...)`` (window ``fabric_mesh``;
     ``pod063-rsw63``'s RIB equal to the LFA oracle) and the array-level
     step on the mesh equal to the one-card step (all seven arrays); K21
     ``[mc]`` over every root (plain 256 a call; roots in and out of the
     member's window, its pad rows; one launch, split), K6's residual fill
     and the whole K6 with the residual (one cooperative launch into a
     held plane, its times in K6's row as ``residual_*``) against
     plain. tg1k-lfa on batch 2 x graph 3 (the node axis padded
     1024 -> 1026): the step equal to the one-card step, LFA backups, its
     sampled RIBs equal to the LFA oracle. ``dryrun_multichip(8)`` on the
     card. With two or more cards, lsdb100k_mc on a mesh of the real
     cards, equal to the logical shards (else a line says so).

Output: phase lines, then one ``{"kernels": [...]}`` JSON line (every
kernel and its LFA, fused, stream, ksp2, sweep, all-pairs and fabric
variants, each with the launches of the path that runs it, the ``[mc]``
kernels and K23 with those of the mc paths; the TE
kernels with their
largest relative error beside the absolute one), the card's
name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import random
import subprocess
import sys
import time
import types

# device peaks of one H100 SXM (NVIDIA data sheet) used for the bounds:
# HBM3 bytes/s, and the non-tensor-core 32-bit rate (the data sheet's
# float32 figure, taken for the int32 add/min/compare these kernels do)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

LSDB100K_SIDE = 316
LSDB100K_ROOT = "node-158-158"
# fabric10k (bench.py:1131): 96 pods x 8 planes, 36 spines a plane, 64 rsws
# a pod
FABRIC = dict(pods=96, planes=8, ssws_per_plane=36, rsws_per_pod=64)
# the fused cell: vantage "hub" in FUSED_AREAS grids of FUSED_SIDE^2
# nodes (n_cap 4096, at the fuse_n_cap bound), each above Decision's
# auto backend's small-graph cut of 2816 nodes (config.py:130)
FUSED_SIDE = 56
FUSED_AREAS = 4
# the wide fused group (phase 2b): ten areas, all of whose root tables
# are staged before the group's one launch
WIDE_FUSED_AREAS = 10
AUTO_SMALL_GRAPH_NODES = 2816
DEVICE = "cuda"
# the flapstorm100k lane (bench.py:553-760, :1163): 200 flaps asked at 100 Hz
STORM_FLAPS = 200
STORM_HZ = 100.0
# the kernels of each path (the wrappers' names)
COLD_PATH = ("K1s:sssp_init", "K1:relax_step", "K2:ladder_classes",
             "K2:ladder_pass", "K3:select_routes", "K4:compact_outputs")
CHURN_PATH = COLD_PATH + ("K5:scatter_set", "K5:old_plane",
                          "K6:parent_plane", "K7:cone_seed",
                          "K8+K9:cone_resolve")
UCMP_PATH = ("base_sssp", "ucmp_propagate")
# incremental flap steps of the churn phase (each held to a cold solve of
# the same state, ~3 s of host RIB build at lsdb100k; 8 until the TE
# phase joined the script)
CHURN_STEPS = 4


class SmokeError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events),
    after ``warmup`` warm-up calls. The main path's planes fit the 50 MB
    L2, as they do inside its round loops, so the cache is left warm."""
    for _ in range(warmup):
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


def device_ms(torch, fn, reps: int = 50) -> tuple[float, float]:
    """-> (device ms a call of ``fn`` alone, host ms a call to enqueue
    it). The ``reps`` calls are queued behind a device sleep that
    outlasts their enqueue, so the two events bracket the kernels run
    back to back with no host time between them; it raises if the
    sleep ended before the last call was queued."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    for cycles in (40_000_000, 400_000_000):
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / reps
        covered = not a.query()
        b.record()
        torch.cuda.synchronize()
        if covered:
            return a.elapsed_time(b) / reps, host
    raise SmokeError("device_ms: the enqueue outlasted the device sleep")


def step_ms(torch, fn, reps: int = 20) -> dict:
    """Host-side timing of ``fn``, a step that may wait on the stream (a
    copy from pageable memory synchronises it): from an idle stream,
    the host ms of the call (``host_ms``), to the end of its device work
    (``wall_ms``) and its device span between two events
    (``device_ms``), each the mean of ``reps`` calls; and the host ms of
    one call queued behind a 1 ms device sleep (``behind_sleep_host_ms``:
    about 1 when the call waits on the stream, a few hundredths when it
    does not)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    fn()
    host = wall = dev = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        a.record()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        b.record()
        torch.cuda.synchronize()
        host += (t1 - t0) * 1e3
        wall += (time.perf_counter() - t0) * 1e3
        dev += a.elapsed_time(b)
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000)
    t0 = time.perf_counter()
    fn()
    behind = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return {"host_ms": host / reps, "wall_ms": wall / reps,
            "device_ms": dev / reps, "behind_sleep_host_ms": behind}


def device_op_counter(torch):
    """A dispatch mode that counts, by name, the aten ops that run on a
    CUDA tensor and do device work (views, allocations and aliases
    excluded): the clones, fills, copies and reads around the kernels,
    whose own launches the wrappers count. The allocations of CUDA
    tensors (``empty``, ``empty_like`` and kin) are counted apart, in
    ``allocs``."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    allocs = {"aten::empty", "aten::empty_like", "aten::empty_strided",
              "aten::new_empty", "aten::new_empty_strided"}
    no_work = allocs | {"aten::detach", "aten::lift_fresh", "aten::alias",
                        "aten::set_", "aten::resize_", "aten::_reshape_alias",
                        "aten::view", "aten::as_strided", "aten::_unsafe_view"}

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}
            self.allocs = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func._schema.name
            if name in no_work and name not in allocs or getattr(
                    func, "is_view", False):
                return out
            leaves, _ = tree_flatten((args, kwargs, out))
            if any(isinstance(x, torch.Tensor) and x.is_cuda
                   for x in leaves):
                into = self.allocs if name in allocs else self.ops
                into[name] = into.get(name, 0) + 1
            return out

    return Count()



class HostMeter:
    """The host's side of a block: the collector's time and collections
    by generation (``gc.callbacks``), the calling thread's CPU time, the
    process's CPU time (every thread), and the objects the collector
    tracked as the block began. ``result`` after the block."""

    def __enter__(self):
        self.objects = len(gc.get_objects())
        self.gc_ms, self._t = 0.0, 0.0
        self._c0 = [st["collections"] for st in gc.get_stats()]
        gc.callbacks.append(self._cb)
        self._thread, self._proc = time.thread_time(), time.process_time()
        return self

    def _cb(self, phase, info) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_ms += (time.perf_counter() - self._t) * 1e3

    def __exit__(self, *exc) -> None:
        thread = (time.thread_time() - self._thread) * 1e3
        proc = (time.process_time() - self._proc) * 1e3
        gc.callbacks.remove(self._cb)
        self.result = {
            "gc_ms": self.gc_ms,
            "gc_collections": [st["collections"] - c for st, c in zip(
                gc.get_stats(), self._c0)],
            "thread_cpu_ms": thread, "process_cpu_ms": proc,
            "gc_objects": self.objects}

def counted(torch, wrappers, fn) -> dict:
    """Run ``fn`` once with the launch counts at 0 and the torch ops
    counted: -> its device work, as kernel launches by wrapper and
    torch ops by name, and their sum ``launches``; beside them the CUDA
    tensors it allocated, by op."""
    for w, _, _ in wrappers.values():
        w.launches = 0
    with device_op_counter(torch) as mode:
        fn()
    kern = {n: w.launches for n, (w, _, _) in wrappers.items()
            if w.launches}
    return {"launches": sum(kern.values()) + sum(mode.ops.values()),
            "kernel_launches": sum(kern.values()),
            "torch_ops": sum(mode.ops.values()),
            "kernels_by_wrapper": kern, "torch_ops_by_name": mode.ops,
            "allocations": sum(mode.allocs.values()),
            "allocations_by_name": mode.allocs}


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
    return max((max_abs_err(torch, g, w) for g, w in zip(got, want)),
               default=0)


def tensors_mapped(fn, args) -> tuple:
    """``args`` with ``fn`` applied to each tensor among them and inside
    their tuples (a wrapper's ``incr_tail`` and ``lfa`` arguments)."""
    return tuple(tensors_mapped(fn, a) if isinstance(a, tuple) else
                 fn(a) if hasattr(a, "data_ptr") else a for a in args)


def on_cpu(args) -> tuple:
    """CPU copies of the tensors among ``args``: a wrapper given them runs
    its plain version."""
    return tensors_mapped(lambda t: t.cpu(), args)


def plain_residual(residual, n_cap: int):
    """The residual tuple the plain K1 takes (index tables clipped, as
    the kernel clips them as it reads) from the one the kernel takes."""
    if residual is None:
        return None
    rows, nbr, w = residual
    return rows.clamp(0, n_cap - 1), nbr.clamp(0, n_cap - 1), w


def pass_check(torch, relax, mid, w, d, lanes=None, passes: int = 3) -> int:
    """K2's ladder pass (one launch) against its plain version over
    ``passes`` passes from the plane ``mid``, each on the rung the last
    doubled (shifts double past the first wrap), with run_bucketed's
    stamps when ``lanes`` (-> a fresh ``Lanes``, called once a side) is
    given: -> the largest difference over both plane buffers, the rungs,
    the flags and the stamps and counters. Untouched rungs (gated lanes)
    start as -7 on both sides."""
    sides = {}
    for side in ("kernel", "plain"):
        sides[side] = [mid.clone(), torch.full_like(mid, -3), w, d,
                       None if lanes is None else lanes()]
    errs = []
    for q in range(passes):
        got = {}
        for side, fn in (("kernel", relax.ladder_pass),
                         ("plain", relax.ladder_pass_plain)):
            cur, spare, w_, d_, ln = sides[side]
            w2, d2 = torch.full_like(w_, -7), torch.full_like(d_, -7)
            flag = torch.zeros(1, dtype=torch.int32, device=mid.device)
            gate = None if ln is None else ln.gate(
                (-1, q - 1 if q else relax.ALWAYS), (0, q), (0, 1))
            cur, spare = fn(cur, spare, w_, d_, w2, d2, flag, gate)
            sides[side] = [cur, spare, w2, d2, ln]
            got[side] = [cur, spare, w2, d2, flag] + (
                [] if ln is None else [ln.st, ln.cnt])
        if q == 0:
            check(int(got["kernel"][4]) == 1,
                  "a ladder pass on a wavefront must change the plane")
        errs.append(max_abs_err(torch, got["kernel"], got["plain"]))
    return max(errs)


def k3_floor(torch, cuda, sel):
    """-> a bare ``cuda.launch`` of K3's entry point on the inputs of the
    single-lane call ``sel`` into outputs of its own (raw addresses, no
    checks): the host floor of a ``select_routes`` call."""
    dist_d, root_w, root, mbuf, p_cap, a_cap, block_v4 = sel[:7]
    lfa = len(sel) > 7 and sel[7]
    d_cap, n_cap = dist_d.shape
    outs = [torch.empty(n, dtype=torch.int32, device=dist_d.device)
            for n in (p_cap, p_cap * -(-a_cap // 16),
                      p_cap * -(-d_cap // 16), p_cap, p_cap, p_cap)]
    ptrs = [t.data_ptr() for t in (dist_d, root_w, mbuf, *outs[:4])] + [
        t.data_ptr() if lfa else 0 for t in outs[4:]] + [0]
    return lambda: cuda.launch(
        "select", "select_tail", "p" * 10 + "iiiiipiLi", *ptrs, p_cap,
        a_cap, n_cap, d_cap, int(root), 0, 1, 0, int(block_v4))


def k4_floor(torch, cuda, cargs):
    """-> a bare ``cuda.launch`` of K4's entry point on the inputs of the
    single-lane call ``cargs`` into buffers of its own (raw addresses,
    no checks): the host floor of a ``compact_outputs`` call."""
    (metric, s3w, nhw, ok, pm, ps, pn, flags, trips, rounds, budget,
     sentinels) = cargs[:12]
    incr = cargs[12] if len(cargs) > 12 else None
    lfa = (cargs[13] if len(cargs) > 13 else None) or (None,) * 4
    stream = bool(cargs[14]) if len(cargs) > 14 else False
    from openr_tpu_torch.ops.compact import buffer_lens

    p_cap, wa = s3w.shape
    wd = nhw.shape[-1]
    n_delta, n_full = buffer_lens(p_cap, wa, wd, budget, sentinels,
                                  incr is not None, lfa[0] is not None,
                                  stream)
    bufs = [torch.empty(n, dtype=torch.int32, device=metric.device)
            for n in (4 * -(-max(p_cap, budget) // 1024), n_delta, n_full)]
    ptrs = [0 if t is None else t.data_ptr()
            for t in (metric, s3w, nhw, ok, pm, ps, pn, flags, *lfa, *bufs)]
    tail = [0 if t is None else t.data_ptr() for t in (incr or (None, None))]
    return lambda: cuda.launch(
        "compact", "compact_tail", "p" * 15 + "i" * 10 + "ppp" + "iiL",
        *ptrs, p_cap, flags.shape[-1], wa, wd, budget, n_delta, n_full,
        int(trips), int(rounds), int(sentinels), *tail, 0, int(stream), 1,
        0)


def one_launch(torch, wrappers, label: str, fn) -> dict:
    """``fn``, one wrapper call, counted (``counted``): it must make one
    kernel launch and no torch op on the card."""
    n = counted(torch, wrappers, fn)
    check(n["launches"] == n["kernel_launches"] == 1,
          f"{label} must be one launch and no torch op: {n}")
    return n


def synthetic_select(torch, dev, seed: int, g: int, d_cap: int, n_cap: int,
                     p_cap: int, a_cap: int, shared: bool = False) -> tuple:
    """Seeded K3 inputs that reach every branch of the selection: small
    preferences, advertised distances and link costs (ties at every
    stage and ECMP ties), invalid, drained and v4 announcers, announcer
    indices past both ends of the node axis (clipped), self-announced
    slots, links down (INF_E costs) and unreachable nodes. -> (dist_d,
    root_w, root, mbuf): one lane with ``g`` 0 (``root`` an int), else
    ``g`` lanes ([g, D, n] planes, int32 [g] roots) with a matrix each
    or, ``shared``, one matrix for all."""
    gen = torch.Generator().manual_seed(seed)

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    lanes = max(g, 1)
    dist = ri(0, 12, lanes, d_cap, n_cap)
    dist[ri(0, 6, lanes, d_cap, n_cap) == 0] = 1 << 29
    root_w = ri(1, 4, lanes, d_cap)
    root_w[ri(0, 5, lanes, d_cap) == 0] = 1 << 29
    roots = ri(0, n_cap, lanes)
    nm = 1 if shared else lanes
    ann = ri(-1, n_cap + 2, nm, p_cap, a_cap)
    ann[ri(0, 40, nm, p_cap, a_cap) == 0] = int(roots[0])
    planes = [ann, ri(0, 8, nm, p_cap, a_cap)] + [
        ri(0, hi, nm, p_cap, a_cap) for hi in (3, 2, 3, 3)]
    mbuf = torch.stack(planes, dim=1).reshape(nm, -1)
    if g == 0:
        return (dist[0].to(dev), root_w[0].to(dev), int(roots[0]),
                mbuf[0].to(dev))
    return (dist.to(dev), root_w.to(dev), roots.to(dev),
            (mbuf[0] if shared else mbuf).to(dev))


# the edge shapes of K3 and K4: (lanes, d_cap, n_cap, p_cap, a_cap,
# shared matrix). A > 16 and D > 16 (two words each), A 64 (a warp a
# row) and 256 (slots past the register cache), A 3 and 5 (groups of 2
# and 4 whose lanes hold unequal slots), P below and past a K4 tile,
# 300 lanes (more K4 tiles than the co-resident grid), a shared matrix
TAIL_SHAPES = (
    (0, 20, 300, 1000, 32, False),
    (0, 40, 200, 777, 64, False),
    (0, 17, 100, 64, 256, False),
    (0, 5, 50, 3000, 3, False),
    (0, 33, 80, 1025, 5, False),
    (3, 18, 120, 1500, 8, False),
    (5, 9, 90, 300, 2, True),
    (300, 3, 40, 100, 2, False),
)


def k1s_floor(cuda, args, out, n_cap: int):
    """-> a bare ``cuda.launch`` of K1s's entry point for the one-lane
    call ``sssp_init(*args)`` into ``out`` (raw addresses, no checks):
    the host floor of an ``sssp_init`` call."""
    shift_w, res_rows, res_nbr, res_w, root, seeds_nbr, seeds_w = args
    sw, (rows_c, nbr_c, rw), dist0 = out
    ptrs = [t.data_ptr() for t in (shift_w, sw, res_rows, res_nbr, res_w,
                                   rows_c, nbr_c, rw, seeds_nbr, seeds_w,
                                   dist0)]
    ints = (shift_w.shape[0], n_cap, *res_nbr.shape, seeds_nbr.shape[0],
            int(root))
    return lambda: cuda.launch("relax", "sssp_init", "p" * 11 + "i" * 6
                               + "piii", *ptrs, *ints, 0, 1, 0,
                               shift_w.shape[1])


def k1_floor(cuda, dist, out, flag, deltas, sw, residual, shared: int = 0):
    """-> a bare ``cuda.launch`` of K1's entry point for the ungated call
    ``relax_step(dist, out, flag, deltas, sw, residual)`` (raw addresses,
    no checks): the host floor of a ``relax_step`` call."""
    rows, nbr, rw = residual or (None, None, None)
    ptrs = [0 if t is None else t.data_ptr()
            for t in (dist, out, deltas, sw, rows, nbr, rw, flag)]
    r_cap, kr_cap = nbr.shape[-2:] if residual else (0, 0)
    g = dist.shape[0] if dist.dim() == 3 else 1
    return lambda: cuda.launch(
        "relax", "relax_step", "p" * 7 + "i" * 8 + "pi" + "ppiiiiii",
        *ptrs[:7], *dist.shape[-2:], sw.shape[-2], 0, sw.shape[-1], r_cap,
        kr_cap, shared, ptrs[7], g, *(0,) * 8)


def call_allocations(torch, module, names, fn) -> tuple:
    """Run ``fn`` with each of ``module``'s functions ``names`` (the
    names a solve calls them by) spied on: -> (``fn``'s result, name ->
    the CUDA tensors each call inside it allocated). The launch counts
    and any outer op counter still see every call."""
    real = {n: getattr(module, n) for n in names}
    seen = {n: [] for n in names}

    class Spy:
        """Counts each call's allocations; ``launches`` reads and writes
        go to the real wrapper (which bumps its count by its module
        global, now this spy)."""

        def __init__(self, n):
            object.__setattr__(self, "name", n)

        def __call__(self, *a, **k):
            with device_op_counter(torch) as mode:
                out = real[self.name](*a, **k)
            seen[self.name].append(sum(mode.allocs.values()))
            return out

        def __getattr__(self, k):
            return getattr(real[self.name], k)

        def __setattr__(self, k, v):
            setattr(real[self.name], k, v)

    for n in names:
        setattr(module, n, Spy(n))
    try:
        return fn(), seen
    finally:
        for n in names:
            setattr(module, n, real[n])


def staging_delta(before: dict, after: dict) -> dict:
    """A solver's staging counts (``GpuSpfSolver.staging_counts``: its
    staged copies) between two readings."""
    return {k: after[k] - before[k] for k in after}


def churn_allocations(torch, incremental, fn) -> tuple:
    """``fn`` (a counted churn build or storm epoch) with K1s's and K6's
    calls spied on: -> (``fn``'s result, {"k1s_allocations": [...],
    "k6_allocations": [...]}); both must be [0] (held outputs)."""
    out, seen = call_allocations(torch, incremental,
                                 ("sssp_init", "parent_plane"), fn)
    return out, {"k1s_allocations": seen["sssp_init"],
                 "k6_allocations": seen["parent_plane"]}


def held_launch(torch, wrappers, label: str, fn) -> dict:
    """``one_launch`` that also allocates nothing on the card."""
    n = one_launch(torch, wrappers, label, fn)
    check(n["allocations"] == 0, f"{label} must allocate nothing: {n}")
    return n


# K6's seeded edge cases (phase 7): (lanes, n_cap, s_cap, r_cap, kr_cap)
PARENT_SHAPES = ((3, 4096, 4, 512, 8), (19, 1024, 6, 256, 16))


def parent_inputs(torch, dev, seed: int, d_cap: int, n_cap: int,
                  s_cap: int, r_cap: int, kr_cap: int) -> tuple:
    """Seeded K6 inputs with frequent tight edges (distances 0-15,
    weights 1-3, ~1/6 of them INF_E): signed class shifts, lane 1
    unreachable (all INF_E), unique residual rows with ~1/5 pad rows
    (-1), pad slots (-1) and neighbours past the plane's end. -> (deltas,
    swm, rows, nbr, rwm, prev) on ``dev``."""
    gen = torch.Generator().manual_seed(seed)

    def ri(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int32)

    inf = 1 << 29
    deltas = ri(-n_cap // 2, n_cap // 2, s_cap)
    swm = ri(1, 4, s_cap, n_cap)
    swm[ri(0, 6, s_cap, n_cap) == 0] = inf
    prev = ri(0, 16, d_cap, n_cap)
    prev[ri(0, 8, d_cap, n_cap) == 0] = inf
    prev[1] = inf
    rows = torch.randperm(n_cap, generator=gen)[:r_cap].to(torch.int32)
    rows[ri(0, 5, r_cap) == 0] = -1
    nbr = ri(-1, n_cap + 3, r_cap, kr_cap)
    rwm = ri(1, 4, r_cap, kr_cap)
    rwm[ri(0, 6, r_cap, kr_cap) == 0] = inf
    return tuple(t.to(dev) for t in (deltas, swm, rows, nbr, rwm, prev))


def parent_cases(c) -> dict:
    """K6 on seeded edge cases (``PARENT_SHAPES``: 3 and 19 lanes, an
    unreachable lane, pad rows, pad slots, neighbours past the plane),
    each call into a held plane pre-filled with -7 and equal to its plain
    version, one launch and no allocation: with the residual (nodes
    whose shift parent exists beside a tight residual slot, and nodes
    with only a residual parent, both present), without it, and as the
    tier's ``[mc]`` window (a half of the columns) and its fill. ->
    {case: its shift-and-residual / residual-only node counts}."""
    torch, inc = c.torch, c.incremental
    out = {}
    for seed, (d_cap, n_cap, s_cap, r_cap, kr_cap) in enumerate(
            PARENT_SHAPES):
        deltas, swm, rows, nbr, rwm, prev = parent_inputs(
            torch, c.dev, 40 + seed, d_cap, n_cap, s_cap, r_cap, kr_cap)
        label = f"K6 D={d_cap} n={n_cap}"
        shift = inc.parent_shift_mc_plain(deltas, swm, prev, s_cap, 0)
        alone = torch.full_like(prev, -1)
        inc.parent_fill_plain(alone, rows, nbr, rwm, prev)
        both = inc.parent_plane_plain(deltas, swm, rows, nbr, rwm, prev,
                                      s_cap, True, n_cap, d_cap)
        kinds = {"shift_beside_residual": int(((shift >= 0)
                                               & (alone >= 0)).sum()),
                 "residual_only": int(((shift < 0) & (both >= 0)).sum())}
        check(min(kinds.values()) > 0, f"{label}: the seeded planes must "
              f"hold both kinds of node: {kinds}")
        check(bool((both[1] == -1).all()),
              f"{label}: the unreachable lane must have no parent")
        held = torch.full_like(prev, -7)
        for res in (True, False):
            want = both if res else shift
            held.fill_(-7)
            held_launch(torch, c.wrappers, f"{label} residual={res}",
                        lambda: inc.parent_plane(
                            deltas, swm, rows, nbr, rwm, prev, s_cap, res,
                            n_cap, d_cap, out=held))
            check(max_abs_err(torch, held, want) == 0,
                  f"{label} residual={res}: kernel != plain")
        # the tier: the second half of the columns, then the fill
        col0, w = n_cap // 2, n_cap // 2
        win = swm[:, col0:].contiguous()
        want = inc.parent_shift_mc_plain(deltas, win, prev, s_cap, col0)
        held.fill_(-7)
        held_launch(torch, c.wrappers, f"{label} [mc]",
                    lambda: inc.parent_shift_mc(deltas, win, prev, s_cap,
                                                col0, out=held))
        check(max_abs_err(torch, held, want) == 0,
              f"{label} [mc] window of {w}: kernel != plain")
        inc.parent_fill_plain(want, rows, nbr, rwm, prev)
        held_launch(torch, c.wrappers, f"{label} [mc] fill",
                    lambda: inc.parent_fill(held, rows, nbr, rwm, prev))
        check(max_abs_err(torch, held, want) == 0,
              f"{label} [mc] fill: kernel != plain")
        out[label] = kinds
    log("K6 edge cases equal to plain, one launch each: " + json.dumps(out))
    return out


def scatter_cases(c) -> None:
    """K5 on seeded edge cases: two planes (lsdb100k's shift plane shape
    and fabric10k's residual ELL shape), each segment with live slots,
    pads at the plane's end and indices past it; both segments, then
    each with the other empty. Each call equal to its plain version on
    copies, one launch."""
    torch, inc = c.torch, c.incremental
    gen = torch.Generator().manual_seed(51)
    a0 = torch.randint(0, 1 << 20, (4, 131072), generator=gen,
                       dtype=torch.int32)
    b0 = torch.randint(0, 1 << 20, (8192, 128), generator=gen,
                       dtype=torch.int32)

    def segment(numel, n):
        live = torch.randperm(numel, generator=gen)[:n].to(torch.int32)
        idx = torch.cat([live, torch.tensor([numel, numel + 7, 1 << 30],
                                            dtype=torch.int32)])
        return idx, torch.randint(1, 99, idx.shape, generator=gen,
                                  dtype=torch.int32)

    sa, sb = segment(a0.numel(), 40), segment(b0.numel(), 25)
    empty = (torch.empty(0, dtype=torch.int32),) * 2
    for label, ea, eb in (("both", sa, sb), ("a alone", sa, empty),
                          ("b alone", empty, sb)):
        buf = torch.cat([*ea, *eb]).to(c.dev)
        views = torch.split(buf, [t.numel() for t in (*ea, *eb)])
        got = [a0.to(c.dev), b0.to(c.dev)]
        want = [a0.to(c.dev), b0.to(c.dev)]
        one_launch(torch, c.wrappers, f"K5 {label}",
                   lambda: inc.scatter_set(got[0], *views[:2], got[1],
                                           *views[2:]))
        inc.scatter_set_plain(want[0], *views[:2], want[1], *views[2:])
        check(max_abs_err(torch, got, want) == 0,
              f"K5 {label}: kernel != plain")
    log("K5 edge cases (both segments, each alone, pads, past the plane) "
        "equal to plain, one launch each")


def staging_cases(c, n_puts: int = 12) -> None:
    """``GpuSpfSolver._stage`` with its copies still pending: ``n_puts``
    stages of 1-6 seeded arrays (0-5000 words each) queued behind a
    ~50 ms device sleep, the host arrays overwritten right after each
    stage. The stream must still be busy after the last stage (no stage
    waited for it), and each view must equal its array's plain upload
    (``torch.tensor``) once the stream drains."""
    import numpy as np

    torch, dev = c.torch, c.dev
    solver = c.gpu_solver.GpuSpfSolver(LSDB100K_ROOT, device=dev)
    rng = np.random.default_rng(53)
    stream = torch.cuda.current_stream(dev)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    staged, kept = [], []
    for _ in range(n_puts):
        arrs = [rng.integers(-1 << 30, 1 << 30, rng.integers(0, 5001),
                             dtype=np.int32)
                for _ in range(rng.integers(1, 7))]
        staged.append(solver._stage(arrs))
        kept.append([a.copy() for a in arrs])
        for a in arrs:
            a[:] = -5
    host_ms = (time.perf_counter() - t0) * 1e3
    check(not stream.query(), "staging: the stream drained during the "
          f"stages ({host_ms:.3f} ms): a stage waited for it")
    torch.cuda.synchronize()
    for k, (views, arrs) in enumerate(zip(staged, kept)):
        for v, a in zip(views, arrs):
            check(torch.equal(v, torch.tensor(a, device=dev)),
                  f"staging: stage {k} != its plain upload")
    check(solver.staging_counts()["copies"] == n_puts,
          f"staging: {solver.staging_counts()} copies for {n_puts} stages")
    log(f"staging: {n_puts} stages behind a device sleep, host "
        f"{host_ms:.3f} ms, each equal to its plain upload")


def relax_plane(torch, dev, seed: int, g: int, n_cap: int, s_cap: int,
                d_cap: int, r_cap: int, kr_cap: int) -> dict:
    """Seeded stacked K1s inputs of ``g`` lanes: signed class shifts (a
    pad class of shift 0 and INF_E weights), ~1/8 INF_E edges, a
    residual ELL with repeated rows, a pad row (-1, INF_E weights) and
    neighbour indices past both ends of the plane, and per-lane roots
    and seeds (lane 0's first seed dead)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    inf = 1 << 29
    deltas = rng.integers(-n_cap + 1, n_cap, (g, s_cap))
    deltas[:, -1] = 0
    shift_w = rng.integers(0, 9, (g, s_cap, n_cap))
    shift_w[rng.random((g, s_cap, n_cap)) < 0.125] = inf
    shift_w[:, -1] = inf
    rows = rng.integers(0, n_cap, (g, r_cap))
    rows[:, :2] = rows[:, 2:3]
    rows[:, -1] = -1
    nbr = rng.integers(-2, n_cap + 2, (g, r_cap, kr_cap))
    rw = rng.integers(0, 40, (g, r_cap, kr_cap))
    rw[:, -1] = inf
    roots = rng.integers(0, n_cap, g)
    nbr[:, 1, 0] = roots  # a residual slot out of the root
    seeds = rng.integers(-1, n_cap + 1, (g, d_cap))
    seeds_w = rng.integers(1, 9, (g, d_cap))
    seeds_w[0, 0] = inf
    t = {k: torch.tensor(v.astype(np.int32), device=dev) for k, v in dict(
        deltas=deltas, shift_w=shift_w, rows=rows, nbr=nbr, rw=rw,
        roots=roots, seeds=seeds, seeds_w=seeds_w).items()}
    t["args"] = (t["shift_w"], t["rows"], t["nbr"], t["rw"], t["roots"],
                 t["seeds"], t["seeds_w"])
    return t


def lane0(args) -> tuple:
    """Lane 0 of stacked K1s arguments (its root an int)."""
    return tuple(int(a[0]) if a.dim() == 1 and i == 4 else a[0]
                 for i, a in enumerate(args))


def relax_cases(c) -> dict:
    """K1s and K1 against their plain versions at tolerance 0 on seeded
    synthetic inputs at the edges of their designs, each call one launch
    and no torch op (``one_launch``; K1s into held outputs also no
    allocation). K1s: held outputs reused over two calls with other
    roots and seeds, stacked lanes with an odd ELL (scalar path), an
    ``[mc]`` window of odd width and offset (held too), a root axis of
    256 roots with no class and no ELL (the ``[fabric]`` seeds), and the
    KSP2 seed rows (one K1s launch). K1: no residual, a residual with repeated and
    pad rows and indices past the plane, D past the register chunk, a
    residual shared by 64 lanes (more tiles than the cooperative grid),
    gated lanes with one closed (its plane untouched; stamps and
    counters too) and an ``[mc]`` window. -> case -> largest error."""
    torch, dev, relax, ksp2, w = c.torch, c.dev, c.relax, c.ksp2, c.wrappers
    errs = {}

    def init_case(label, args, fn, plain, held=None):
        if held is not None:
            for t in (held[0], *held[1], held[2]):
                t.fill_(-7)
        got = fn(*args)
        want = plain(*args)
        errs[label] = max_abs_err(torch, (got[0], *got[1], got[2]),
                                  (want[0], *want[1], want[2]))
        (held_launch if held is not None else one_launch)(
            torch, w, label, lambda: fn(*args))

    def held_fn(out):
        return lambda *a: relax.sssp_init(*a, out=out)

    # K1s
    n_cap = 4096
    p1 = relax_plane(torch, dev, 5, 2, n_cap, 6, 5, 64, 3)
    a1, a2 = lane0(p1["args"]), lane0(tuple(t[1:] for t in p1["args"]))
    held = relax.init_outputs(*a1[:4], a1[5], n_cap)
    for i, a in enumerate((a1, a2)):
        init_case(f"K1s held, call {i}", a, held_fn(held),
                  relax.sssp_init_plain, held)
    p3 = relax_plane(torch, dev, 6, 3, n_cap, 6, 5, 37, 3)
    held3 = relax.init_outputs(*p3["args"][:4], p3["args"][5], n_cap)
    init_case("K1s lanes, odd ELL", p3["args"], held_fn(held3),
              relax.sssp_init_plain, held3)
    col0, wc = 77, 1001
    sw_win = a1[0][:, col0:col0 + wc].contiguous()
    root_in = col0 + 500
    mc_args = (sw_win, *a1[1:4], root_in, *a1[5:], col0, n_cap)
    held_mc = relax.init_outputs(sw_win, *a1[1:4], a1[5], n_cap)
    init_case("K1s [mc] window of width 1001", mc_args,
              lambda *a: relax.sssp_init_mc(*a, out=held_mc),
              relax.sssp_init_mc_plain, held_mc)
    g_f, n_f = 256, 8192
    pf = relax_plane(torch, dev, 7, g_f, n_f, 1, 8, 3, 1)
    none = [torch.empty((g_f,) + sh, dtype=torch.int32, device=dev)
            for sh in ((0, n_f), (0,), (0, 0), (0, 0))]
    init_case("K1s [fabric] root axis, 256 roots",
              (*none, pf["roots"], pf["seeds"], pf["seeds_w"]),
              relax.sssp_init, relax.sssp_init_plain)
    roots = p1["roots"][:1].contiguous()
    seed_rows = ksp2.seed_rows(roots, 64, n_cap)
    errs["K1s KSP2 seed rows, 64 lanes"] = max_abs_err(
        torch, seed_rows, ksp2.seed_rows_plain(roots, 64, n_cap))
    n = counted(torch, w, lambda: ksp2.seed_rows(roots, 64, n_cap))
    check(n["kernel_launches"] == 1, f"the KSP2 seed rows: one K1s launch {n}")

    # K1: one step from a wavefront 3 steps past the seed plane
    def k1_case(label, dist, deltas, sw, res, res_plain=None, gate=None,
                mc=None):
        # the plain version takes clipped indices (``res_plain``); the
        # kernel clips as it reads, on the card
        clipped = res_plain or res
        mid, spare = dist.clone(), torch.empty_like(dist)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        for _ in range(3):
            if mc is None:
                relax.relax_step(mid, spare, flag, deltas, sw, clipped)
            else:
                relax.relax_step_mc(mid, spare, flag, deltas, sw, clipped,
                                    mc)
            mid, spare = spare, mid

        def side(kernel: bool):
            """-> (the call, its outputs) on fresh outputs and lanes."""
            o = torch.full_like(mid, -3)
            f = torch.zeros(1, dtype=torch.int32, device=dev)
            lanes = None
            if gate is not None:
                lanes = relax.Lanes(mid.shape[0], dev)
                lanes.st[:, 0] = 0
                lanes.st[gate, 0] = -5  # lane `gate` reached its fixpoint
            g = None if lanes is None else lanes.gate(
                (0, relax.ALWAYS), (1, relax.KEEP), (1, 1))
            r = res if kernel and mid.is_cuda else clipped
            if mc is None:
                fn = relax.relax_step if kernel else relax.relax_step_plain
                call = lambda: fn(mid, o, f, deltas, sw, r, g)  # noqa: E731
            else:
                fn = relax.relax_step_mc if kernel \
                    else relax.relax_step_mc_plain
                call = lambda: fn(mid, o, f, deltas, sw, r, mc)  # noqa: E731
            return call, [o, f] + ([] if lanes is None
                                   else [lanes.st, lanes.cnt])

        (k_call, k_out), (p_call, p_out) = side(True), side(False)
        k_call()
        p_call()
        check(int(k_out[1]) == 1, f"{label}: a wavefront step must change")
        errs[label] = max_abs_err(torch, k_out, p_out)
        if gate is not None:
            check(bool((k_out[0][gate] == -3).all()),
                  f"{label}: the closed lane's plane was written")
        one_launch(torch, w, label, side(True)[0])

    def residual_of(p, lane=None):
        sw, res, dist0 = relax.sssp_init(*p["args"])
        if lane is not None:
            sw, res, dist0 = sw[lane], tuple(t[lane] for t in res), \
                dist0[lane]
        return sw, res, dist0

    sw0, res0, d00 = residual_of(p1, 0)
    dl0 = p1["deltas"][0]
    k1_case("K1 no residual, D 5", d00, dl0, sw0, None)
    raw = (p1["rows"][0], p1["nbr"][0], res0[2])
    k1_case("K1 residual, repeated and pad rows", d00, dl0, sw0, raw,
            plain_residual(raw, n_cap))
    pd = relax_plane(torch, dev, 8, 1, n_cap, 5, 19, 64, 4)
    swd, resd, dd = residual_of(pd, 0)
    k1_case("K1 residual, D 19", dd, pd["deltas"][0], swd, resd)
    ps = relax_plane(torch, dev, 9, 64, n_cap, 4, 1, n_cap, 2)
    sws, ress, ds = residual_of(ps)
    shared = (ress[0][0].contiguous(), ress[1][0].contiguous(), ress[2])
    k1_case("K1 residual shared by 64 lanes", ds, ps["deltas"], sws,
            shared)
    sw3, res3, d3 = residual_of(p3)
    k1_case("K1 gated lanes, lane 1 closed", d3, p3["deltas"], sw3, res3,
            gate=1)
    # the window's own sources: from two full-width steps past the seeds
    wave, spare = d00.clone(), torch.empty_like(d00)
    for _ in range(2):
        relax.relax_step(wave, spare, None, dl0, sw0, res0)
        wave, spare = spare, wave
    k1_case("K1 [mc] window of width 1001", wave, dl0,
            sw0[:, col0:col0 + wc].contiguous(), res0, mc=col0)
    return errs


def tail_edge_shapes(c) -> dict:
    """K3 and K4 against their plain versions (tolerance 0) on
    ``synthetic_select``'s inputs at every ``TAIL_SHAPES`` shape: K3
    with and without LFA (v4 blocking on, the node distances asked for);
    K4 on K3's outputs with zeroed and perturbed previous planes, a
    budget below the changed rows and one past P, with the sentinels,
    and on one lane also the incremental tail and the streaming ok
    column. Each call counted as one launch and no torch op. -> the
    number of calls checked by kernel."""
    torch, dev, select, compact = c.torch, c.dev, c.select, c.compact
    checked = {"K3": 0, "K4": 0}
    for k, (g, d_cap, n_cap, p_cap, a_cap, shared) in enumerate(
            TAIL_SHAPES):
        dist_d, root_w, root, mbuf = synthetic_select(
            torch, dev, 100 + k, g, d_cap, n_cap, p_cap, a_cap, shared)
        lead = (g,) if g else ()
        for lfa in (False, True):
            sel = (dist_d, root_w, root, mbuf, p_cap, a_cap, True, lfa)
            d_k = torch.full(lead + (n_cap,), -7, dtype=torch.int32,
                             device=dev)
            d_p = d_k.cpu()
            got = select.select_routes(*sel, dist_out=d_k)
            want = select.select_routes_plain(*on_cpu(sel), dist_out=d_p)
            err = max_abs_err(torch, [t.cpu() for t in got + (d_k,)],
                              want + (d_p,))
            check(err == 0, f"K3 at {TAIL_SHAPES[k]} lfa={lfa}: kernel != "
                  f"plain (max abs err {err})")
            one_launch(torch, c.wrappers, "K3", lambda: select.select_routes(
                *sel, dist_out=d_k))
            checked["K3"] += 1
        metric, s3w, nhw, ok, slot, alt = got
        flags = (mbuf.view(6, p_cap, a_cap)[1] if not g
                 else mbuf.view(6, p_cap, a_cap)[1].expand(g, p_cap, a_cap)
                 if shared else mbuf.view(g, 6, p_cap, a_cap)[:, 1])
        zero = tuple(torch.zeros_like(t) for t in (metric, s3w, nhw, slot,
                                                   alt))
        near = tuple(t.clone() for t in (metric, s3w, nhw, slot, alt))
        near[0][..., ::7] += 1
        near[4][..., 3::11] += 1
        if g:
            tr = torch.stack([torch.arange(g, dtype=torch.int32) + 3,
                              torch.arange(g, dtype=torch.int32) * 2 + 5],
                             dim=1).to(dev)
            counts = (tr, None)
        else:
            counts = (9, 13)
        runs = []
        for prev in (zero, near):
            for budget in (64, 4096):
                for lfa in (False, True):
                    cols = (slot, alt, prev[3], prev[4]) if lfa else None
                    runs.append((metric, s3w, nhw, ok, *prev[:3], flags,
                                 *counts, budget, True, None, cols))
        if not g:
            tail = (torch.tensor(41, dtype=torch.int32, device=dev),
                    torch.tensor(1, dtype=torch.int32, device=dev))
            for budget in (64, 4096):
                runs.append((metric, s3w, nhw, ok, *near[:3], flags,
                             *counts, budget, False, tail,
                             (slot, alt, near[3], near[4]), True))
        for cargs in runs:
            got = compact.compact_outputs(*cargs)
            want = compact.compact_outputs_plain(*on_cpu(cargs))
            err = max_abs_err(torch, [t.cpu() for t in got], want)
            check(err == 0, f"K4 at {TAIL_SHAPES[k]} budget {cargs[10]}: "
                  f"kernel != plain (max abs err {err})")
            one_launch(torch, c.wrappers, "K4",
                       lambda: compact.compact_outputs(*cargs))
            checked["K4"] += 1
    return checked



def k4_past_cache(c) -> int:
    """K4 where every block of its cooperative grid takes more tiles than
    it keeps bits of in registers (``CACHE_TILES``, 16, in
    ``csrc/compact.cu``): the rows of a block's 17th and later tiles are
    read again after the grid barrier. The grid is at most 2 blocks an
    SM, so 8 x SMs + 64 lanes of 4 tiles (P 1,000, budget 4,096) give
    every block more than 16 tiles and put each tile of the last 64
    lanes past the cache. Held to the plain version (tolerance 0), with
    and without LFA, on the first 4 lanes and the last 64, each lane's
    plain run alone (the plain version runs lanes one by one); each call
    one launch. -> the lanes compared a call."""
    torch, dev, compact = c.torch, c.dev, c.compact
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g, p_cap, a_cap, budget = 8 * sms + 64, 1000, 2, 4096
    dist_d, root_w, roots, mbuf = synthetic_select(
        torch, dev, 99, g, 3, 40, p_cap, a_cap)
    metric, s3w, nhw, ok, slot, alt = c.select.select_routes(
        dist_d, root_w, roots, mbuf, p_cap, a_cap, True, True)
    flags = mbuf.view(g, 6, p_cap, a_cap)[:, 1]
    near = tuple(t.clone() for t in (metric, s3w, nhw, slot, alt))
    near[0][..., ::7] += 1
    near[4][..., 3::11] += 1
    tr = torch.stack([torch.arange(g, dtype=torch.int32) + 3,
                      torch.arange(g, dtype=torch.int32) * 2 + 5], dim=1)
    lanes = [*range(4), *range(g - 64, g)]
    for lfa in (False, True):
        cols = (slot, alt, *near[3:]) if lfa else None
        cargs = (metric, s3w, nhw, ok, *near[:3], flags, tr.to(dev), None,
                 budget, True, None, cols)
        got = [t.cpu() for t in compact.compact_outputs(*cargs)]
        for lane in lanes:
            one = tensors_mapped(lambda t: t[lane].cpu(), cargs)
            want = compact.compact_outputs_plain(
                *one[:8], *tr[lane].tolist(), *one[10:])
            err = max_abs_err(torch, [t[lane] for t in got], want)
            check(err == 0, f"K4 past the tile cache, lane {lane} of {g}, "
                  f"lfa={lfa}: kernel != plain (max abs err {err})")
        one_launch(torch, c.wrappers, "K4 past the tile cache",
                   lambda: compact.compact_outputs(*cargs))
    return len(lanes)

def build_cell(topologies, gen):
    adj_dbs, prefix_dbs = gen()
    return adj_dbs, *topologies.build_states(adj_dbs, prefix_dbs)


def churn_inputs(relax, incremental, solver):
    """The last incremental solve of ``solver`` (one area "0"): its own
    inputs, and the planes the incremental kernels derive from them
    (masked new and old weights, the cold seed, the parent forest) as
    each kernel's argument tuple (``oargs``: the old planes', shift then
    residual)."""
    lane, prev_out, incr_in = solver._last_exec_incr
    (deltas, shift_w, res_rows, res_nbr, res_w, mbuf, root, root_nbr,
     root_w) = lane
    prev_dist, sdi, sdo, rdi, rdo, cone_limit = incr_in
    plan = solver._area_dev["0"].plan
    has_res = plan.k_res > 0
    n_cap, s_cap, d_cap = plan.n_cap, plan.s_cap, root_nbr.shape[0]
    sw_n, res_n, dist0 = relax.sssp_init(
        shift_w, res_rows, res_nbr, res_w, root, root_nbr, root_w)
    swm_old, rwm_old = incremental.old_planes(
        shift_w, res_w, sdi, sdo, rdi, rdo, has_res, int(root), res_nbr)
    oargs = [(shift_w, sdi, sdo, int(root))]
    if has_res:
        oargs.append((res_w, rdi, rdo, int(root), res_nbr))
    pargs = (deltas, swm_old, res_rows, res_nbr, rwm_old, prev_dist, s_cap,
             has_res, n_cap, d_cap)
    par = incremental.parent_plane(*pargs)
    cargs = (par, sw_n, res_n[2], deltas, res_rows, res_nbr, root, sdi, sdo,
             rdi, rdo, has_res)
    kernel = "bucketed" if plan.delta_exp > 0 else "sync"
    whole = (
        (deltas, shift_w, res_rows, res_nbr, res_w, root, root_nbr, root_w,
         prev_dist, sdi, sdo, rdi, rdo, int(cone_limit)),
        dict(s_cap=s_cap, has_res=has_res, n_cap=n_cap, d_cap=d_cap,
             max_trips=relax.max_trips(n_cap), kernel=kernel,
             delta_exp=plan.delta_exp if kernel == "bucketed" else 0),
    )
    return dict(
        lane=lane, prev_out=prev_out, prev_dist=prev_dist, sdi=sdi, sdo=sdo,
        rdi=rdi, rdo=rdo, cone_limit=int(cone_limit), plan=plan,
        has_res=has_res, sw_n=sw_n, res_n=res_n, dist0=dist0, oargs=oargs,
        pargs=pargs, par=par, cargs=cargs, whole=whole,
    )


def whole_incremental(torch, incremental, ci) -> tuple:
    """The whole incremental SSSP on the card, checked against the plain
    versions on CPU copies of the same inputs. -> (card result, host
    wall ms of the card run)."""
    args, static = ci["whole"]
    t0 = time.perf_counter()
    got = incremental.incremental_sssp(*args, **static)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    want = incremental.incremental_sssp(
        *[a.cpu() if isinstance(a, torch.Tensor) else a for a in args],
        **static)
    check(max_abs_err(torch, got[0].cpu(), want[0]) == 0
          and [int(x) for x in got[1:]] == [int(x) for x in want[1:]],
          "incremental SSSP: kernels != plain")
    return got, wall


# the deep chain's node order is seeded (phase 7)
CHAIN_SEED = 19


def cone_args(ci, incremental) -> tuple:
    """``cone_resolve``'s arguments on a churn step's own inputs
    (``churn_inputs``): (par, the seeded cone from K7, the rest)."""
    lane = ci["lane"]
    return (ci["par"], incremental.cone_seed(*ci["cargs"]),
            (ci["prev_dist"], ci["dist0"], lane[7], lane[8],
             ci["cone_limit"], ci["whole"][1]["max_trips"]))


def deep_chain(torch, par, seeded) -> tuple:
    """``par`` and ``seeded`` with lane 0 replaced by one chain through
    every node (a seeded order) and its head seeded: a cone n_cap - 1
    levels deep, as deep as n_cap allows."""
    n_cap = par.shape[1]
    gen = torch.Generator().manual_seed(CHAIN_SEED)
    order = torch.randperm(n_cap, generator=gen).to(par.device)
    chain, aff = par.clone(), seeded.clone()
    chain[0, order[1:]] = order[:-1].to(torch.int32)
    chain[0, order[0]] = -1
    aff[0] = 0
    aff[0, order[0]] = 1
    return chain, aff


def subtree_cone(torch, par, seeds_nbr):
    """A deep cone of the main path's own forest: in each lane, the first
    child of the lane's seed node (a root out-neighbour) seeded, so the
    cone is that child's whole subtree."""
    aff = torch.zeros_like(par)
    for d, s in enumerate(seeds_nbr.tolist()):
        kids = (par[d] == s).nonzero() if s >= 0 else []
        if len(kids):
            aff[d, kids[0, 0]] = 1
    return aff


def cone_case(c, label: str, par, seeded, rest, reps: int = 20) -> tuple:
    """``cone_resolve`` on the card against its plain composition on the
    same tensors, at tolerance 0 on the closure, the seed plane (where
    there is one), cone and fell_back; the call must be one launch and
    no torch op. -> (its numbers, the plain result, the kernel's seed
    plane): cone, fell_back, the kernel's sweeps, the plain version's
    Jacobi steps, the largest difference from plain, and the call's
    device ms alone (``device_ms`` of a copy of the seeded cone and the
    call, less the copy's)."""
    torch, inc = c.torch, c.incremental
    aff_p = seeded.clone()
    want = (aff_p, *inc.cone_resolve_plain(par, aff_p, *rest))
    aff_k, box = seeded.clone(), {}
    one_launch(torch, c.wrappers, f"cone_resolve ({label})",
               lambda: box.update(out=inc.cone_resolve(par, aff_k, *rest)))
    plane, tail = box["out"]
    err = max_abs_err(torch, (aff_k, tail[:2]), (want[0], want[2][:2]))
    if plane is not None:
        err = max(err, max_abs_err(torch, plane, want[1]))
    check(err == 0, f"cone_resolve ({label}) != plain (err {err})")
    scratch = seeded.clone()

    def run():
        scratch.copy_(seeded)
        inc.cone_resolve(par, scratch, *rest)

    ms = (device_ms(torch, run, reps)[0]
          - device_ms(torch, lambda: scratch.copy_(seeded), reps)[0])
    row = {"case": label, "cone": int(tail[0]), "fell_back": int(tail[1]),
           "sweeps": int(tail[2]), "jacobi_steps": int(want[2][2]),
           "max_abs_err": err, "ms": ms}
    log(f"cone_resolve {label}: equal to plain, one launch; "
        + json.dumps(row))
    return row, want, plane


def flap(adb_cls, states, adj_dbs, by_name, victim: int, i: int) -> int:
    """bench.py's flap: metric 50 + i % 5 on every adjacency of
    ``adj_dbs[victim]`` and on its neighbours' adjacencies back to it
    (both link directions), applied through LinkState's changelog.
    Returns the metric."""
    metric = 50 + (i % 5)
    vdb = adj_dbs[victim]
    name = vdb.this_node_name
    touched = {name: tuple(dataclasses.replace(a, metric=metric)
                           for a in vdb.adjacencies)}
    for a in vdb.adjacencies:
        ndb = by_name[a.other_node_name]
        touched[ndb.this_node_name] = tuple(
            dataclasses.replace(x, metric=metric)
            if x.other_node_name == name else x
            for x in ndb.adjacencies
        )
    for node, adjs in touched.items():
        states["0"].update_adjacency_database(adb_cls(
            this_node_name=node, adjacencies=adjs,
            node_label=by_name[node].node_label, area="0",
        ))
    return metric


def rib_equal(want_db, got_db) -> bool:
    return (
        dict(want_db.unicast_routes.items())
        == dict(got_db.unicast_routes.items())
        and want_db.mpls_routes == got_db.mpls_routes
    )


def lfa_kernels(torch, relax, select, compact, gpu_solver, record, split,
                wrappers, solver, states, me) -> None:
    """K3 and K4 with their LFA columns against their plain versions on
    the inputs of ``solver``'s last build (one area "0", LFA on)."""
    from openr_tpu_torch.ops import cuda

    ad = solver._area_dev["0"]
    plan = ad.plan
    dev = ad.shift_w.device
    root = plan.node_index[me]
    nbr_np, w_np, _ = plan.out_links(states["0"], me)
    root_nbr = torch.tensor(nbr_np, device=dev)
    root_w = torch.tensor(w_np, device=dev)
    kernel = "bucketed" if plan.delta_exp > 0 else "sync"
    dist, _, _ = relax.plan_sssp(
        ad.deltas, ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w, root,
        root_nbr, root_w, plan.k_res > 0, kernel, plan.delta_exp)
    p_cap, a_cap = ad.matrix.ann_node.shape
    d_cap, n_cap = dist.shape
    # on the unit-metric fabric every detour ties its primary, so no row
    # has a backup (as in the oracle); uplink costs 1, 2, 3, ... narrow
    # the primaries to the first uplink and make the others backups
    skew_w = root_w + torch.arange(d_cap, dtype=torch.int32, device=dev)
    skew_w = torch.where(root_w < relax.INF_E, skew_w, root_w)
    errs, backups = [], []
    for rw in (skew_w, root_w):
        sel = (dist, rw, root, ad.mbuf, p_cap, a_cap, False, True)
        got = select.select_routes(*sel)
        errs.append(max_abs_err(torch, got, select.select_routes_plain(*sel)))
        backups.append(int((got[4] >= 0).sum()))
    check(backups[0] > 0, "fabric10k: no row has an LFA backup with skewed "
          "uplink costs")
    wa, wd = got[1].shape[1], got[2].shape[1]
    record(
        "K3:select_routes[lfa]", max(errs),
        lambda: select.select_routes(*sel),
        lambda: select.select_routes_plain(*sel),
        nbytes=4 * (d_cap * n_cap + d_cap + 6 * p_cap * a_cap
                    + p_cap * (3 + wa + wd)) + p_cap,
        ops=3 * d_cap * n_cap + 12 * p_cap * a_cap
        + 4 * p_cap * a_cap * d_cap + 3 * p_cap * d_cap,
    )
    split("K3:select_routes[lfa]", lambda: select.select_routes(*sel),
          floor=k3_floor(torch, cuda, sel))
    one_launch(torch, wrappers, "K3[lfa]", lambda: select.select_routes(*sel))
    metric, s3w, nhw, ok, slot, alt = got
    flags = ad.mbuf[p_cap * a_cap:2 * p_cap * a_cap].view(p_cap, a_cap)
    zero = tuple(torch.zeros_like(t) for t in (metric, s3w, nhw, slot, alt))
    near = tuple(t.clone() for t in (metric, s3w, nhw, slot, alt))
    near[3][::89] += 1  # only the LFA column moves on these rows
    errs = []
    for prev in (zero, near):
        cargs = (metric, s3w, nhw, ok, *prev[:3], flags, 7, 11,
                 gpu_solver.DELTA_BUDGET, True, None,
                 (slot, alt, prev[3], prev[4]))
        k_out = compact.compact_outputs(*cargs)
        errs.append(max_abs_err(torch, k_out,
                                compact.compact_outputs_plain(*cargs)))
    check(int(k_out[0][0]) == len(range(0, p_cap, 89)),
          "K4[lfa]: the LFA column diff missed rows")
    one_launch(torch, wrappers, "K4[lfa]",
               lambda: compact.compact_outputs(*cargs))
    n_delta, n_full = compact.buffer_lens(
        p_cap, wa, wd, gpu_solver.DELTA_BUDGET, True, False, True)
    record(
        "K4:compact_outputs[lfa]", max(errs),
        lambda: compact.compact_outputs(*cargs),
        lambda: compact.compact_outputs_plain(*cargs),
        nbytes=4 * (2 * p_cap * (3 + wa + wd) + p_cap * a_cap
                    + n_delta + n_full) + p_cap,
        ops=p_cap * (8 + 2 * (wa + wd) + a_cap),
    )
    # the same calls without the LFA branch / columns, beside them
    sel0 = sel[:-1] + (False,)
    c0 = cargs[:-1] + (None,)
    log(f"fabric10k: K3 and K4 with the LFA columns equal to plain "
        f"({backups[1]} of {p_cap} rows with a backup on the path's inputs, "
        f"{backups[0]} with skewed uplink costs); without LFA on the same "
        f"inputs: " + json.dumps({
            "K3_ms": time_ms(torch, lambda: select.select_routes(*sel0), 50),
            "K4_ms": time_ms(torch, lambda: compact.compact_outputs(*c0), 50),
        }))


def tg1k_tail(c, solver, states, me, rows: int = 1000) -> None:
    """K3 and K4 on tg1k's own inputs (``solver``'s last build, one area
    "0") cut to the first ``rows`` prefix rows, P below one K4 tile of
    1,024 rows: equal to plain (tolerance 0), each call one launch."""
    torch, relax, select, compact = c.torch, c.relax, c.select, c.compact
    ad = solver._area_dev["0"]
    plan = ad.plan
    dev = ad.shift_w.device
    root = plan.node_index[me]
    nbr_np, w_np, _ = plan.out_links(states["0"], me)
    root_w = torch.tensor(w_np, device=dev)
    kernel = "bucketed" if plan.delta_exp > 0 else "sync"
    dist, _, _ = relax.plan_sssp(
        ad.deltas, ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w, root,
        torch.tensor(nbr_np, device=dev), root_w, plan.k_res > 0, kernel,
        plan.delta_exp)
    p_cap, a_cap = ad.matrix.ann_node.shape
    check(rows < 1024 <= p_cap, "tg1k: the cut must fall below one tile")
    mbuf = ad.mbuf.view(6, p_cap, a_cap)[:, :rows].contiguous().view(-1)
    sel = (dist, root_w, root, mbuf, rows, a_cap, False)
    got = select.select_routes(*sel)
    err = max_abs_err(torch, got, select.select_routes_plain(*sel))
    check(err == 0, f"K3 on tg1k's first {rows} rows != plain (err {err})")
    one_launch(torch, c.wrappers, "K3 on tg1k",
               lambda: select.select_routes(*sel))
    metric, s3w, nhw, ok = got
    flags = mbuf.view(6, rows, a_cap)[1]
    near = (metric.clone(), s3w.clone(), nhw.clone())
    near[0][::13] += 1
    zero = tuple(torch.zeros_like(t) for t in near)
    for prev in (zero, near):
        for budget in (64, c.gpu_solver.DELTA_BUDGET):
            cargs = (metric, s3w, nhw, ok, *prev, flags, 5, 8, budget, True)
            err = max_abs_err(torch, compact.compact_outputs(*cargs),
                              compact.compact_outputs_plain(*cargs))
            check(err == 0, f"K4 on tg1k's first {rows} rows, budget "
                  f"{budget} != plain (err {err})")
            one_launch(torch, c.wrappers, "K4 on tg1k",
                       lambda: compact.compact_outputs(*cargs))
    log(f"tg1k: K3 and K4 on the first {rows} of {p_cap} rows equal to "
        f"plain, each call one launch")


def fused_cell(adb, pdb, pentry, topologies, side: int, n_areas: int,
               seed: int = 0):
    """Vantage ``hub`` in ``n_areas`` grids of side x side nodes: in each
    area the centre node is the hub, the others are area-prefixed and
    announce one loopback of their area; link metrics 1-9 from ``seed``,
    different in each area, so the areas share a shape (and fuse) but
    not their shortest paths. -> (adj_dbs, prefix_dbs)."""
    rng = random.Random(seed)
    hub = "node-%d-%d" % (side // 2, side // 2)
    adj_dbs, prefix_dbs = [], []
    for a in range(n_areas):
        area = f"g{a}"

        def rename(n, area=area):
            return "hub" if n == hub else f"{area}-{n}"

        base, _ = topologies.grid(side, area=area, node_labels=False)
        metric: dict = {}
        for i, db in enumerate(base):
            me = db.this_node_name
            adjs = []
            for x in db.adjacencies:
                other = x.other_node_name
                m = metric.setdefault(tuple(sorted((me, other))),
                                      rng.randint(1, 9))
                adjs.append(dataclasses.replace(
                    x, other_node_name=rename(other), metric=m,
                    if_name=f"if-{rename(me)}-{rename(other)}",
                    other_if_name=f"if-{rename(other)}-{rename(me)}"))
            adj_dbs.append(adb(this_node_name=rename(me),
                               adjacencies=tuple(adjs), area=area))
            if me != hub:
                prefix_dbs.append(pdb(
                    this_node_name=rename(me), area=area,
                    prefix_entries=(pentry(prefix=f"fd{a:02x}::{i:x}/128"),)))
    return adj_dbs, prefix_dbs


def fused_phase(torch, gpu_solver, relax, select, compact, SpfSolver,
                topologies, counters, types3, dev, wrappers, variants,
                variant_launches, record, zero_counts,
                read_counts) -> None:
    """The fused path (see the module docstring, phase 2b)."""
    t0 = time.perf_counter()
    states, ps = topologies.build_states(
        *fused_cell(*types3, topologies, FUSED_SIDE, FUSED_AREAS))
    log(f"fused cell: {FUSED_AREAS} areas of {states['g0'].node_count()} "
        f"nodes, {len(ps.prefixes())} prefixes, host build "
        f"{(time.perf_counter() - t0):.1f} s")
    captured: dict = {}
    singles: list = []
    real_fused, real_pipe = gpu_solver.fused_pipeline, gpu_solver.pipeline

    def total():
        return sum(fn.launches for fn, _, _ in wrappers.values())

    def spy_fused(lanes, **kw):
        captured.update(lanes=lanes, kw=kw, outs=real_fused(lanes, **kw))
        return captured["outs"]

    def spy_pipe(*a, **k):
        n0, r0 = total(), relax.read_flag.reads
        out = real_pipe(*a, **k)
        singles.append({"launches": total() - n0,
                        "flag_reads": relax.read_flag.reads - r0,
                        "trips": out.trips, "rounds": out.rounds,
                        "full_buf": out.full_buf})
        return out

    gpu_solver.fused_pipeline, gpu_solver.pipeline = spy_fused, spy_pipe
    try:
        f_solver = gpu_solver.GpuSpfSolver(
            "hub", device=dev, small_graph_nodes=AUTO_SMALL_GRAPH_NODES)
        d0 = counters.get_counter("decision.device.fused_dispatches") or 0
        torch.cuda.synchronize()
        reads0 = zero_counts()
        # the earlier phases' garbage collected before the timed cold
        # build: a full collection of this process's millions of objects
        # landing inside a build is 1.4-2 s of its host time
        gc.collect()
        with HostMeter() as meter:
            t0 = time.perf_counter()
            got_db = f_solver.build_route_db("hub", states, ps)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        f_launches, f_reads = read_counts(reads0)
        st = f_solver.last_device_stats
        check(st.get("fused") == FUSED_AREAS and not singles
              and counters.get_counter("decision.device.fused_dispatches")
              == d0 + 1, "fused phase: the areas must solve in ONE fused "
              f"dispatch (stats {st}, {len(singles)} single solves)")
        for name, (base, _) in variants.items():
            if name.endswith("[fused]"):
                variant_launches[name] = f_launches[base]
                check(f_launches[base] > 0,
                      f"{name} never launched on the fused path")
        u_solver = gpu_solver.GpuSpfSolver(
            "hub", device=dev, small_graph_nodes=AUTO_SMALL_GRAPH_NODES,
            fuse_small_areas=False)
        db_u = u_solver.build_route_db("hub", states, ps)
        torch.cuda.synchronize()
    finally:
        gpu_solver.fused_pipeline, gpu_solver.pipeline = real_fused, real_pipe
    t0 = time.perf_counter()
    oracle = SpfSolver("hub").build_route_db("hub", states, ps)
    t_oracle = (time.perf_counter() - t0) * 1e3
    check(rib_equal(oracle, got_db), "fused phase: fused RIB != oracle")
    check(rib_equal(oracle, db_u), "fused phase: unfused RIB != oracle")
    outs = captured["outs"]
    check(len(singles) == FUSED_AREAS, "fused phase: unfused solve count")
    for i, (out, one) in enumerate(zip(outs, singles)):
        check(torch.equal(out.full_buf, one["full_buf"]),
              f"fused phase: area {i}'s payload != its unfused solve's")
        check((int(out.trips), int(out.rounds))
              == (one["trips"], one["rounds"]),
              f"fused phase: area {i}'s trips / rounds != unfused")
    u_timing = list(u_solver.last_timing["areas"].values())
    areas = [{**{k: one[k] for k in ("launches", "flag_reads", "trips",
                                     "rounds")},
              **{k: tm_u.get(k) for k in ("exec_ms", "sssp_ms")}}
             for one, tm_u in zip(singles, u_timing)]
    n_fused = sum(f_launches.values())
    n_sum = sum(a["launches"] for a in areas)
    check(n_fused < n_sum, "fused phase: the fused build launched as often "
          "as the unfused areas together")
    tm = f_solver.last_timing
    log("fused build: " + json.dumps({
        "build_ms": wall, "oracle_ms": t_oracle,
        "routes": len(oracle.unicast_routes),
        "launches": n_fused, "flag_reads": f_reads,
        "launches_by_kernel": {k: v for k, v in f_launches.items() if v},
        "unfused_areas": areas,
        "unfused_launches_sum": n_sum,
        "unfused_flag_reads_sum": sum(a["flag_reads"] for a in areas),
        "largest_area_launches": max(a["launches"] for a in areas),
        "largest_area_flag_reads": max(a["flag_reads"] for a in areas),
        "unfused_sssp_ms_sum": None if None in [a["sssp_ms"] for a in areas]
        else sum(a["sssp_ms"] for a in areas),
        "spf_kernel": tm.get("spf_kernel"),
        **{k: next(iter(tm["areas"].values())).get(k) for k in (
            "sync_ms", "exec_ms", "sssp_ms", "tail_ms", "compact_ms")},
        "bytes_uploaded": tm.get("bytes_uploaded"),
        "bytes_downloaded": tm.get("bytes_downloaded"),
        "host": meter.result,
    }))
    # the same cold build on fresh solvers, the collector on, off, on:
    # how much of the host's sync_ms is garbage collection
    fresh = []
    for on in (True, False, True):
        fs = gpu_solver.GpuSpfSolver(
            "hub", device=dev, small_graph_nodes=AUTO_SMALL_GRAPH_NODES)
        torch.cuda.synchronize()
        if not on:
            gc.disable()
        try:
            with HostMeter() as meter:
                fs.build_route_db("hub", states, ps)
                torch.cuda.synchronize()
        finally:
            gc.enable()
        fresh.append({"gc": on, "sync_ms": next(iter(
            fs.last_timing["areas"].values()))["sync_ms"], **meter.result})
    log("fused build on fresh solvers: " + json.dumps(fresh))
    wide_fused(gpu_solver, SpfSolver, topologies, counters, types3, dev)
    fused_kernels(torch, gpu_solver, relax, select, compact, record,
                  wrappers, captured, real_fused, dev)


def wide_fused(gpu_solver, SpfSolver, topologies, counters, types3, dev,
               n_areas: int = WIDE_FUSED_AREAS) -> None:
    """A wide fused group: vantage ``hub`` in
    ``n_areas`` seeded grids of 16 x 16, every area on the card
    (``small_graph_nodes=0``), one fused dispatch whose root tables are
    staged area by area before its launch; its RIB must equal the
    oracle's and the unfused solve's."""
    states, ps = topologies.build_states(
        *fused_cell(*types3, topologies, 16, n_areas, seed=7))
    d0 = counters.get_counter("decision.device.fused_dispatches") or 0
    solver = gpu_solver.GpuSpfSolver("hub", device=dev, small_graph_nodes=0)
    got = solver.build_route_db("hub", states, ps)
    check(solver.last_device_stats.get("fused") == n_areas
          and counters.get_counter("decision.device.fused_dispatches")
          == d0 + 1, f"wide fused: the {n_areas} areas must solve in one "
          f"fused dispatch: {solver.last_device_stats}")
    unfused = gpu_solver.GpuSpfSolver(
        "hub", device=dev, small_graph_nodes=0, fuse_small_areas=False
    ).build_route_db("hub", states, ps)
    oracle = SpfSolver("hub").build_route_db("hub", states, ps)
    check(rib_equal(oracle, got), "wide fused: fused RIB != oracle")
    check(rib_equal(oracle, unfused), "wide fused: unfused RIB != oracle")
    log(f"wide fused: {n_areas} areas in one fused dispatch, RIB equal to "
        f"the oracle ({len(oracle.unicast_routes)} routes)")


def fused_kernels(torch, gpu_solver, relax, select, compact, record,
                  wrappers, captured, real_fused, dev) -> None:
    """The fused K1s-K4 against their plain versions on the fused path's
    own stacked inputs, the gated kernels with a gate that closes half
    the lanes; then the whole fused pipeline against its plain run on
    CPU copies."""
    lanes, kw = captured["lanes"], captured["kw"]
    g = len(lanes)

    def stack(i):
        return torch.stack([lane[i] for lane in lanes])

    deltas, shift_w, res_rows, res_nbr, res_w, mbuf = map(stack, range(6))
    roots = torch.tensor([lane[6] for lane in lanes], dtype=torch.int32,
                         device=dev)
    root_nbr, root_w = stack(7), stack(8)
    has_res, kernel, dexp = kw["has_res"], kw["kernel"], kw["delta_exp"]
    s_cap, n_cap = shift_w.shape[1:]
    d_cap = root_nbr.shape[1]
    p_cap = lanes[0][9].shape[0]
    a_cap = mbuf.shape[1] // (6 * p_cap)
    res_bytes = 4 * (res_rows.numel() + 2 * res_nbr.numel())

    ia = (shift_w, res_rows, res_nbr, res_w, roots, root_nbr, root_w)
    got = relax.sssp_init(*ia)
    want = relax.sssp_init_plain(*ia)
    record(
        "K1s:sssp_init[fused]", max_abs_err(torch, (got[0], *got[1], got[2]),
                                            (want[0], *want[1], want[2])),
        lambda: relax.sssp_init(*ia), lambda: relax.sssp_init_plain(*ia),
        nbytes=4 * g * (2 * s_cap * n_cap + 2 * d_cap + d_cap * n_cap)
        + 2 * res_bytes,
        ops=g * (s_cap * n_cap + d_cap * n_cap),
    )
    sw, residual, dist0 = got
    residual = residual if has_res else None

    def gated_pair():
        """(kernel gate, plain gate): lanes 0, 2, ... open, the others
        closed, on equal copies of the stamps and counters."""
        pair = []
        for _ in range(2):
            lanes_st = relax.Lanes(g, dev)
            lanes_st.st[1::2, 0] = -5
            pair.append(lanes_st.gate((-1, relax.ALWAYS), (0, relax.KEEP),
                                      (1, 1)))
        return pair

    mid = dist0.clone()
    spare = torch.empty_like(mid)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    for _ in range(16):
        relax.relax_step(mid, spare, flag, deltas, sw, residual)
        mid, spare = spare, mid
    gk, gp = gated_pair()
    out_k, out_p = mid.clone(), mid.clone()
    f_k = torch.zeros(1, dtype=torch.int32, device=dev)
    f_p = torch.zeros_like(f_k)
    relax.relax_step(mid, out_k, f_k, deltas, sw, residual, gk)
    relax.relax_step_plain(mid, out_p, f_p, deltas, sw, residual, gp)
    check(int(f_k) == 1, "fused relax_step on a wavefront must change it")
    err = max_abs_err(torch, (out_k, f_k, gk.st, gk.cnt),
                      (out_p, f_p, gp.st, gp.cnt))
    check(torch.equal(out_k[1::2], mid[1::2]),
          "fused relax_step wrote a closed lane")
    record(
        "K1:relax_step[fused]", err,
        lambda: relax.relax_step(mid, out_k, f_k, deltas, sw, residual),
        lambda: relax.relax_step_plain(mid, out_p, f_p, deltas, sw,
                                       residual),
        nbytes=4 * g * (2 * d_cap * n_cap + s_cap * n_cap + s_cap)
        + (res_bytes if has_res else 0),
        ops=2 * g * d_cap * n_cap * s_cap
        + (2 * d_cap * res_nbr.numel() if has_res else 0),
    )

    s_lad = min(s_cap, relax.LADDER_WIDTH)
    dq = 1 << max(dexp, 1)
    w_k, dd_k = relax.ladder_classes(sw, deltas, dq, s_lad)
    w_p, dd_p = relax.ladder_classes_plain(sw, deltas, dq, s_lad)
    record(
        "K2:ladder_classes[fused]",
        max_abs_err(torch, (w_k, dd_k), (w_p, dd_p)),
        lambda: relax.ladder_classes(sw, deltas, dq, s_lad),
        lambda: relax.ladder_classes_plain(sw, deltas, dq, s_lad),
        nbytes=4 * g * (s_cap * n_cap + s_cap + s_lad * n_cap + s_lad),
        ops=g * (s_cap * n_cap + s_lad * n_cap),
    )
    def half_shut():
        """Lanes with lanes 1, 3, ... shut from the start."""
        lanes_st = relax.Lanes(g, dev)
        lanes_st.st[1::2, 0] = -5
        return lanes_st

    pa, pb = mid.clone(), torch.empty_like(mid)
    w2_k, d2_k = torch.empty_like(w_k), torch.empty_like(dd_k)
    record(
        "K2:ladder_pass[fused]",
        pass_check(torch, relax, mid, w_k, dd_k, half_shut),
        lambda: relax.ladder_pass(pa, pb, w_k, dd_k, w2_k, d2_k, f_k),
        lambda: relax.ladder_pass_plain(pa, pb, w_k, dd_k, w2_k, d2_k, f_p),
        nbytes=4 * g * (2 * d_cap * n_cap + 2 * s_lad * n_cap + 2 * s_lad),
        ops=2 * g * (s_lad * d_cap * n_cap + s_lad * n_cap),
    )

    # the whole fused SSSP: kernel loops vs plain loops on CPU copies
    sa = (deltas, shift_w, res_rows, res_nbr, res_w, roots, root_nbr,
          root_w)
    t0 = time.perf_counter()
    dist_k, cnt_k = relax.plan_sssp_lanes(*sa, has_res, kernel, dexp)
    torch.cuda.synchronize()
    t_k = (time.perf_counter() - t0) * 1e3
    dist_p, cnt_p = relax.plan_sssp_lanes(*(t.cpu() for t in sa), has_res,
                                          kernel, dexp)
    check(max_abs_err(torch, (dist_k.cpu(), cnt_k.cpu()), (dist_p, cnt_p))
          == 0, "fused SSSP: kernels != plain")
    log(f"fused SSSP equal to plain: per-area (trips, rounds) "
        f"{cnt_k.tolist()} in {t_k:.2f} ms host wall")

    block_v4 = kw["block_v4"]
    errs = []
    for lfa in (True, False):
        sel = (dist_k, root_w, roots, mbuf, p_cap, a_cap, block_v4, lfa)
        got = select.select_routes(*sel)
        errs.append(max_abs_err(torch, got, select.select_routes_plain(*sel)))
        one_launch(torch, wrappers, "K3[fused]",
                   lambda: select.select_routes(*sel))
    wa, wd = got[1].shape[-1], got[2].shape[-1]
    record(
        "K3:select_routes[fused]", max(errs),
        lambda: select.select_routes(*sel),
        lambda: select.select_routes_plain(*sel),
        nbytes=4 * g * (d_cap * n_cap + d_cap + 6 * p_cap * a_cap
                        + p_cap * (1 + wa + wd)) + g * p_cap,
        ops=g * (3 * d_cap * n_cap + 12 * p_cap * a_cap),
    )
    metric, s3w, nhw, ok = got
    flags = mbuf.view(g, 6, p_cap, a_cap)[:, 1]
    zero = (torch.zeros_like(metric), torch.zeros_like(s3w),
            torch.zeros_like(nhw))
    near = tuple(t.clone() for t in (metric, s3w, nhw))
    near[0][:, ::97] += 1
    errs = []
    for prev in (zero, near):
        cargs = (metric, s3w, nhw, ok, *prev, flags, cnt_k, None,
                 gpu_solver.DELTA_BUDGET, True)
        errs.append(max_abs_err(torch, compact.compact_outputs(*cargs),
                                compact.compact_outputs_plain(*cargs)))
        one_launch(torch, wrappers, "K4[fused]",
                   lambda: compact.compact_outputs(*cargs))
    n_delta, n_full = compact.buffer_lens(p_cap, wa, wd,
                                          gpu_solver.DELTA_BUDGET, True)
    record(
        "K4:compact_outputs[fused]", max(errs),
        lambda: compact.compact_outputs(*cargs),
        lambda: compact.compact_outputs_plain(*cargs),
        nbytes=4 * g * (2 * p_cap * (1 + wa + wd) + p_cap * a_cap
                        + n_delta + n_full + 2) + g * p_cap,
        ops=g * p_cap * (4 + 2 * (wa + wd) + a_cap),
    )

    # the whole fused pipeline against its plain run on CPU copies
    cpu_lanes = [tuple(x.cpu() if isinstance(x, torch.Tensor) else x
                       for x in lane) for lane in lanes]
    plain = real_fused(cpu_lanes, **kw)
    fields = ("delta_buf", "full_buf", "metric", "s3w", "nhw", "lfa_slot",
              "lfa_metric", "trips", "rounds")
    for i, (out, ref) in enumerate(zip(captured["outs"], plain)):
        err = max_abs_err(torch, [getattr(out, f).cpu() for f in fields],
                          [getattr(ref, f) for f in fields])
        check(err == 0, f"fused pipeline area {i}: kernels != plain")
    log("fused pipeline equal to its plain run for every area")


def quantile(xs, q: float) -> float:
    """The q-quantile of ``xs`` (nearest rank, no interpolation)."""
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]


def stream_kernel(c, metric, s3w, nhw, ok, flags, wa, wd, a_cap) -> None:
    """K4 [stream] (the bucketed delta with the ok column and the
    incremental tail) against its plain version on the main path's
    selection outputs: 41 changed rows (within budget 64, the case
    timed), and 1,352 (over budget 64; within 4096)."""
    torch, compact = c.torch, c.compact
    p_cap = metric.shape[0]
    tail = (torch.tensor(57, dtype=torch.int32, device=c.dev),
            torch.tensor(0, dtype=torch.int32, device=c.dev))
    errs, timed = [], None
    for stride, budget in ((p_cap // 40, 64), (97, 64), (97, 4096)):
        prev = (metric.clone(), s3w.clone(), nhw.clone())
        prev[0][::stride] += 1
        cargs = (metric, s3w, nhw, ok, *prev, flags, 3, 17, budget, True,
                 tail, None, True)
        timed = timed or cargs
        got = compact.compact_outputs(*cargs)
        errs.append(max_abs_err(torch, got,
                                compact.compact_outputs_plain(*cargs)))
        check(int(got[0][0]) == len(range(0, p_cap, stride)),
              "K4[stream]: wrong changed-row count")
        one_launch(torch, c.wrappers, f"K4[stream] budget {budget}",
                   lambda: compact.compact_outputs(*cargs))
        n_delta, _ = compact.buffer_lens(p_cap, wa, wd, budget, True, True,
                                         False, True)
        check(got[0].numel() == n_delta == c.stream.stream_payload_len(
            budget, wa, wd, False, True), "K4[stream]: payload length")
    n_delta, n_full = compact.buffer_lens(p_cap, wa, wd, 64, True, True,
                                          False, True)
    c.record(
        "K4:compact_outputs[stream]", max(errs),
        lambda: compact.compact_outputs(*timed),
        lambda: compact.compact_outputs_plain(*timed),
        nbytes=4 * (2 * p_cap * (1 + wa + wd) + p_cap * a_cap
                    + n_delta + n_full) + 2 * p_cap,
        ops=p_cap * (4 + 2 * (wa + wd) + a_cap),
    )
    c.split("K4:compact_outputs[stream]",
            lambda: compact.compact_outputs(*timed),
            floor=k4_floor(torch, c.cuda, timed))


def flapstorm_phase(c, adj_dbs, states, ps) -> tuple:
    """The flapstorm100k lane (module docstring, phase 8). Returns the
    stream path's launches by kernel, and the streaming solver."""
    torch, gs, relax = c.torch, c.gpu_solver, c.relax
    by_name = {db.this_node_name: db for db in adj_dbs}
    root_victim = next(i for i, db in enumerate(adj_dbs)
                       if db.this_node_name == LSDB100K_ROOT)
    solver = gs.GpuSpfSolver(LSDB100K_ROOT, device=c.dev,
                             streaming_pipeline=True, small_graph_nodes=0)
    solver.build_route_db(LSDB100K_ROOT, states, ps)
    check(not solver.last_timing.get("stream"),
          "flapstorm: a vantage's first build is cold")
    flap(c.AdjacencyDatabase, states, adj_dbs, by_name, 1, 7919)
    prev_db = solver.build_route_db(LSDB100K_ROOT, states, ps)
    check(solver.last_timing.get("stream", {}).get("epochs") == 1,
          "flapstorm: the warm-up flap must stream")
    vs = solver._vstates[("0", LSDB100K_ROOT)]
    wa = -(-vs.crib.matrix.ann_node.shape[1] // 16)
    wd = -(-len(vs.links_tuple) // 16)
    idle_bytes = 4 * c.stream.stream_payload_len(64, wa, wd, False, True)
    launches = dict.fromkeys(c.wrappers, 0)
    recs = []

    def cold_check(label: str, with_oracle: bool) -> None:
        """The last epoch's RIB against a fresh solver's cold solve."""
        db = prev_db
        fresh = gs.GpuSpfSolver(LSDB100K_ROOT, device=c.dev)
        check(rib_equal(fresh.build_route_db(LSDB100K_ROOT, states, ps), db),
              f"flapstorm {label}: RIB != a fresh cold solve")
        if with_oracle:
            ref = c.SpfSolver(LSDB100K_ROOT).build_route_db(
                LSDB100K_ROOT, states, ps)
            check(rib_equal(ref, db), f"flapstorm {label}: RIB != oracle")

    def epoch(victim, i: int, label: str) -> dict:
        nonlocal prev_db
        for fn, _, _ in c.wrappers.values():
            fn.launches = 0
        reads0 = relax.read_flag.reads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metric = None
        if victim is not None:
            metric = flap(c.AdjacencyDatabase, states, adj_dbs, by_name,
                          victim, i)
        t1 = time.perf_counter()
        db = solver.collect_route_db(
            solver.dispatch_route_db(LSDB100K_ROOT, states, ps))
        upd = prev_db.calculate_update(db)
        t2 = time.perf_counter()
        for name, (fn, _, _) in c.wrappers.items():
            launches[name] += fn.launches
        tm, st = solver.last_timing, solver.last_device_stats
        s = st.get("stream") or {}
        rec = {
            "epoch": label, "victim": victim, "metric": metric,
            "flap_apply_ms": (t1 - t0) * 1e3,
            "flap_to_delta_ms": (t2 - t1) * 1e3,
            "streamed": bool(tm.get("stream")),
            "changed_rows": st.get("changed_rows"),
            "budget": s.get("budget"), "overflow": s.get("overflow"),
            "next_budget": vs.stream_budget,
            "bytes_down": tm["bytes_downloaded"],
            "bytes_up": tm["bytes_uploaded"],
            "update_rows": len(upd.unicast_routes_to_update)
            + len(upd.unicast_routes_to_delete),
            "launches": sum(fn.launches for fn, _, _ in c.wrappers.values()),
            "flag_reads": relax.read_flag.reads - reads0,
            **{k: tm.get(k) for k in ("sync_ms", "exec_ms", "pull_ms",
                                      "unpack_ms")},
            **{k: st.get(k) for k in ("cone", "fell_back", "trips",
                                      "rounds")},
        }
        recs.append(rec)
        prev_db = db
        return rec

    # the storm: 200 flaps asked at 100 Hz over adj_dbs[1..8]; the
    # storm's clock (pacing and its own seconds) stops during the cold
    # checks, so the achieved rate is the storm's alone
    t_start = time.perf_counter()
    checks_s = 0.0
    storm = []
    for i in range(STORM_FLAPS):
        wait = t_start + checks_s + i / STORM_HZ - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        storm.append(epoch(1 + i % 8, i, f"storm {i}"))
        if i in (0, STORM_FLAPS // 2, STORM_FLAPS - 1):
            t_check = time.perf_counter()
            cold_check(f"epoch {i}", False)
            checks_s += time.perf_counter() - t_check
    storm_s = time.perf_counter() - t_start - checks_s
    storm_launches = dict(launches)
    check(all(r["streamed"] for r in storm),
          "flapstorm: every storm epoch must stream")
    # a flap of the root's own links moves every route: over budget
    over = epoch(root_victim, STORM_FLAPS, "root links")
    grown = (c.stream.stream_budget(over["changed_rows"])
             or c.stream.STREAM_BUDGETS[-1])
    check(over["overflow"] and over["changed_rows"] > over["budget"]
          and over["next_budget"] == grown > 64,
          f"flapstorm: the root-link flap must overflow: {over}")
    settle = [epoch(1 + j, STORM_FLAPS + 1 + j, f"settle {j}")
              for j in range(3)]
    check(settle[0]["budget"] == grown
          and not any(r["overflow"] for r in settle)
          and settle[-1]["next_budget"] == 64
          and settle[-1]["budget"] == 64,
          f"flapstorm: the budget must settle back to 64: {settle}")
    idle = epoch(None, 0, "idle")
    check(idle["streamed"] and idle["changed_rows"] == 0
          and idle["budget"] == 64 and idle["bytes_down"] == idle_bytes,
          f"flapstorm: the idle epoch must pull {idle_bytes} B: {idle}")
    cold_check("idle epoch", True)
    # one storm epoch's device work, torch ops included (not timed)
    st0 = solver.staging_counts()
    per_epoch, allocs = churn_allocations(
        torch, c.incremental, lambda: counted(torch, c.wrappers, lambda: (
            epoch(2, STORM_FLAPS + 4, "counted"))))
    per_epoch.update(allocs)
    per_epoch["staging"] = staging_delta(st0, solver.staging_counts())
    check(per_epoch["staging"]["copies"] == 2,
          f"flapstorm: the counted epoch's uploads must be two staged "
          f"copies (the sync's, the solve's): {per_epoch['staging']}")
    check(allocs["k1s_allocations"] == [0]
          and allocs["k6_allocations"] == [0],
          f"flapstorm: the counted epoch's K1s / K6 allocated: {allocs}")
    check(recs[-1]["streamed"]
          and per_epoch["kernels_by_wrapper"].get("K5:old_plane"),
          f"flapstorm: the counted epoch must stream incrementally: "
          f"{recs[-1]}")
    cold_check("counted epoch", False)
    log("flapstorm100k epoch launches: " + json.dumps(per_epoch))
    for r in recs:
        log("flapstorm100k epoch: " + json.dumps(r))
    lat = [r["flap_to_delta_ms"] for r in storm]
    byts = [r["bytes_down"] for r in storm]
    log("flapstorm100k storm: " + json.dumps({
        "epochs": len(storm), "seconds": storm_s,
        "asked_rate_hz": STORM_HZ, "achieved_rate_hz": len(storm) / storm_s,
        "cold_check_seconds": checks_s,
        "streamed_epochs": sum(r["streamed"] for r in storm),
        "overflows": sum(bool(r["overflow"]) for r in storm),
        "flap_to_delta_ms_p50": quantile(lat, 0.5),
        "flap_to_delta_ms_p99": quantile(lat, 0.99),
        "flap_apply_ms_p50": quantile([r["flap_apply_ms"] for r in storm],
                                      0.5),
        "bytes_down_p50": quantile(byts, 0.5), "bytes_down_max": max(byts),
        "changed_rows_p50": quantile([r["changed_rows"] for r in storm],
                                     0.5),
        "changed_rows_max": max(r["changed_rows"] for r in storm),
        "launches_per_epoch_p50": quantile([r["launches"] for r in storm],
                                           0.5),
        "flag_reads_per_epoch_p50": quantile(
            [r["flag_reads"] for r in storm], 0.5),
        "launches_by_kernel": {k: v for k, v in storm_launches.items() if v},
        "overflow_epoch_bytes_down": over["bytes_down"],
        "idle_epoch_bytes_down": idle["bytes_down"],
    }))
    return storm_launches, solver


UCMP_VIPS = 12


def ucmp_cell(c):
    """fabric10k with anycast VIPs over remote rsws (module docstring,
    phase 9): -> (states, prefix state, VIP -> leaves, VIP -> mode)."""
    adj_dbs, pdbs = c.topologies.fabric(**FABRIC)
    states, ps = c.topologies.build_states(adj_dbs, pdbs)
    pfa = c.PrefixForwardingAlgorithm
    rng = random.Random(5)
    vips, modes = {}, {}
    for v in range(UCMP_VIPS + 1):
        prefix = f"fd10::{v + 1:x}/128"
        pods = rng.sample(range(1, FABRIC["pods"]), 4)
        leaves = {
            f"pod{p:03d}-rsw{rng.randrange(FABRIC['rsws_per_pod']):02d}":
            rng.randint(1, 9) for p in pods}
        mode = (pfa.SP_UCMP_PREFIX_WEIGHT_PROPAGATION if v % 2 == 0
                else pfa.SP_UCMP_ADJ_WEIGHT_PROPAGATION)
        if v == UCMP_VIPS:
            # weighted path counts past 2^30: the device overflows and
            # the host walk answers
            leaves = {n: (1 << 24) + w for n, w in leaves.items()}
            mode = pfa.SP_UCMP_PREFIX_WEIGHT_PROPAGATION
        vips[prefix], modes[prefix] = leaves, mode
        for node, w in leaves.items():
            ps.update_prefix_database(c.PrefixDatabase(
                this_node_name=node, area="0", prefix_entries=(
                    c.PrefixEntry(prefix=prefix, forwarding_algorithm=mode,
                                  weight=w),)))
    return states, ps, vips, modes


def ucmp_phase(c, lsdb) -> dict:
    """UCMP on fabric10k and the kernels on lsdb100k (module docstring,
    phase 9). ``lsdb`` is lsdb100k's (solver, states), the solver synced
    to the states. Returns the ucmp path's launches by kernel."""
    torch, gs, ksp2, ucmp, relax = (c.torch, c.gpu_solver, c.ksp2, c.ucmp,
                                    c.relax)
    t0 = time.perf_counter()
    states, ps, vips, modes = ucmp_cell(c)
    me = "pod000-rsw00"
    log(f"ucmp cell: fabric10k, {len(vips)} anycast VIPs of 4 remote rsws, "
        f"host build {(time.perf_counter() - t0):.1f} s")
    solver = gs.GpuSpfSolver(me, device=c.dev, enable_ucmp=True)
    reads0 = c.zero_counts()
    t0 = time.perf_counter()
    db = solver.build_route_db(me, states, ps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches, reads = c.read_counts(reads0)
    t0 = time.perf_counter()
    want = c.SpfSolver(me, enable_ucmp=True).build_route_db(me, states, ps)
    t_oracle = (time.perf_counter() - t0) * 1e3
    check(rib_equal(want, db), "ucmp: RIB != SpfSolver(enable_ucmp=True)")
    results = solver._ucmp_accel.results
    engaged = [v for v in results.values()
               if v is not None and v is not NotImplemented]
    fell = [k for k, v in results.items() if v is NotImplemented]
    check(len(engaged) >= 2, "ucmp: the device resolver did not answer")
    check(len(fell) == 1 and solver.last_sentinels.get("ucmp_overflow") == 1,
          "ucmp: the overflow VIP must fall back to the host walk")
    for name in UCMP_PATH:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              "ucmp path")
    log("fabric10k UCMP: RIB == oracle, " + json.dumps({
        "build_ms": wall, "oracle_ms": t_oracle,
        "resolved_on_card": len(engaged), "host_walk": len(fell),
        "launches": {k: v for k, v in launches.items() if v},
        "flag_reads": reads,
        "ucmp_weights": [db.unicast_routes[p].ucmp_weight for p in vips],
        "sentinels": solver.last_sentinels,
    }))
    ad = solver._area_dev["0"]
    plan = ad.plan
    ridx = plan.node_index[me]
    edges = solver._ucmp_accel.edges["0"][2]
    base = (ad.deltas, ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w, ridx,
            plan.k_res > 0)
    d_k, trips = ksp2.base_sssp(*base)
    d_p, trips_p = ksp2.base_sssp_plain(*base)
    err_b = max_abs_err(torch, d_k, d_p)
    check(trips == trips_p, "base_sssp: kernel and plain trips differ")

    def leaves_of(prefix):
        leaf = torch.zeros(plan.n_cap, dtype=torch.bool, device=c.dev)
        leaf_w = torch.zeros(plan.n_cap, dtype=torch.int32, device=c.dev)
        for n, w in vips[prefix].items():
            leaf[plan.node_index[n]] = True
            leaf_w[plan.node_index[n]] = w
        return leaf, leaf_w

    def fixpoint_pair(etens, dist, leaf, leaf_w, prefix, max_deg, what):
        got = ucmp.ucmp_propagate(etens, dist, leaf, leaf_w, prefix, max_deg)
        ref = ucmp.ucmp_propagate_plain(etens, dist, leaf, leaf_w, prefix,
                                        max_deg)
        err = max_abs_err(torch, (got[0].int(), got[1]),
                          (ref[0].int(), ref[1]))
        check(got[2:] == ref[2:], f"ucmp {what}: overflow / rounds differ")
        return err, got

    errs, info = [err_b], {}
    for prefix in list(vips)[:2] + [list(vips)[-1]]:
        pmode = modes[prefix].name.startswith("SP_UCMP_PREFIX")
        err, got = fixpoint_pair(edges.tensors(), d_k, *leaves_of(prefix),
                                 pmode, edges.max_deg, prefix)
        errs.append(err)
        info[prefix] = {"prefix_mode": pmode, "overflow": got[2],
                        "rounds": got[3]}
    # the deep DAG: lsdb100k's grid, leaves equidistant from the root
    l_solver, l_states = lsdb
    l_ad = l_solver._area_dev["0"]
    l_plan = l_ad.plan
    l_root = l_plan.node_index[LSDB100K_ROOT]
    l_base = (l_ad.deltas, l_ad.shift_w, l_ad.res_rows, l_ad.res_nbr,
              l_ad.res_w, l_root, l_plan.k_res > 0)
    t0 = time.perf_counter()
    l_dk, l_trips = ksp2.base_sssp(*l_base)
    torch.cuda.synchronize()
    t_base = (time.perf_counter() - t0) * 1e3
    l_dp, l_trips_p = ksp2.base_sssp_plain(*l_base)
    errs.append(max_abs_err(torch, l_dk, l_dp))
    check(l_trips == l_trips_p, "base_sssp on lsdb100k: trips differ")
    l_edges = ucmp.UcmpEdges(l_states["0"], l_plan.node_overloaded,
                             l_plan.n_cap, device=c.dev)
    leaf = torch.zeros(l_plan.n_cap, dtype=torch.bool, device=c.dev)
    leaf_w = torch.zeros(l_plan.n_cap, dtype=torch.int32, device=c.dev)
    mid = LSDB100K_SIDE // 2
    for k, n in enumerate((f"node-0-{mid}", f"node-{mid}-0",
                           f"node-{mid // 2}-{mid - mid // 2}")):
        leaf[l_plan.node_index[n]] = True
        leaf_w[l_plan.node_index[n]] = 3 + k
    for pmode in (True, False):
        t0 = time.perf_counter()
        err, got = fixpoint_pair(l_edges.tensors(), l_dk, leaf, leaf_w, pmode,
                                 l_edges.max_deg, f"lsdb100k {pmode}")
        errs.append(err)
        info[f"lsdb100k {'prefix' if pmode else 'adj'}"] = {
            "overflow": got[2], "rounds": got[3]}
    check(max(errs) == 0, f"ucmp kernels != plain (max abs err {max(errs)})")
    log("ucmp kernels equal to plain on fabric10k and lsdb100k: " + json.dumps(
        {"base_trips": {"fabric10k": trips, "lsdb100k": l_trips},
         "lsdb100k_base_host_wall_ms": t_base, "fixpoints": info}))
    # timed on the ucmp path's own inputs: fabric10k, the first VIP
    n_cap, s_cap = plan.n_cap, plan.s_cap
    res_words = ad.res_rows.numel() + 2 * ad.res_nbr.numel()
    steps = 8 * trips
    step_bytes = 4 * (2 * n_cap + s_cap * n_cap + s_cap) + 4 * res_words
    c.record(
        "base_sssp", err_b, lambda: ksp2.base_sssp(*base),
        lambda: ksp2.base_sssp_plain(*base),
        nbytes=4 * n_cap + steps * step_bytes,
        ops=steps * (2 * n_cap * s_cap + 2 * ad.res_nbr.numel()),
        reps=5, plain_reps=2,
    )
    first = list(vips)[0]
    leaf, leaf_w = leaves_of(first)
    e_cap = edges.e_cap
    e2 = edges.order.numel()
    rounds = info[first]["rounds"]
    init_bytes = 4 * 3 * e_cap + 4 * 2 * e_cap + e_cap + 5 * n_cap + 9 * n_cap
    round_bytes = (4 * (n_cap + 1) + 4 * 2 * e2 + e2 + 9 * e2 + 5 * n_cap
                   + 18 * n_cap)
    et = edges.tensors()
    c.record(
        "ucmp_propagate", max(errs[1:]),
        lambda: ucmp.ucmp_propagate(et, d_k, leaf, leaf_w, True,
                                    edges.max_deg),
        lambda: ucmp.ucmp_propagate_plain(et, d_k, leaf, leaf_w, True,
                                          edges.max_deg),
        nbytes=init_bytes + rounds * round_bytes,
        ops=4 * e_cap + rounds * 4 * e2, reps=5, plain_reps=2,
    )
    # one round beside the nearest library call: the segment sum of one
    # round as index_add_ (it computes the sum only, not reach or the
    # float shadow, so it is no library_ms of the fixpoint)
    dag, state = ucmp.ucmp_init_plain(et[0], et[1], et[2], d_k, leaf, leaf_w)
    per_edge = torch.where(dag, state[1][et[1].long()], 0)
    acc = torch.zeros(n_cap, dtype=torch.int32, device=c.dev)
    src_l = et[0].long()
    log("ucmp one round vs index_add_ (fabric10k): " + json.dumps({
        "fixpoint_ms": c.results["ucmp_propagate"]["ms"],
        "rounds": rounds,
        "index_add_ms": time_ms(torch, lambda: acc.index_add_(0, src_l,
                                                              per_edge), 50),
    }))
    return launches


# -- 10. wan50k KSP2 (BASELINE config 4) --------------------------------------

# bench.py:1138-1145: 48 metro regions of 32 x 32, 64 KSP2 destinations
WAN50K = dict(regions=48, region_side=32, ksp2_every=768)
WAN50K_ROOT = "r00-n08-08"
# every KSP2 destination against the oracle on a smaller WAN
WAN_SMALL = dict(regions=8, region_side=16, ksp2_every=32)
WAN_SMALL_ROOT = "r00-n04-04"
# churn: (victim, metric of all its links) — a root neighbour, a far
# region's hub, a node beside the root
WAN_CHURN = (("r00-n08-07", 90), ("r05-n16-16", 40), ("r00-n07-08", 3))
# every WAN_KSP2_SAMPLE-th KSP2 route (sorted) of each wan50k generation is
# held to the oracle's (~1 s of host Dijkstra a route; the small WAN holds
# every one)
WAN_KSP2_SAMPLE = 16
KSP2_PATH = ("K10:overlay_planes", "K11:masked_delta", "K1s:sssp_init",
             "K1:relax_step", "base_sssp")


def set_metric(adb_cls, states_list, adj_dbs, victim: str, metric: int):
    """Every link of ``victim`` to ``metric`` in each of ``states_list``."""
    db = next(d for d in adj_dbs if d.this_node_name == victim)
    new = adb_cls(this_node_name=victim, adjacencies=tuple(
        dataclasses.replace(a, metric=metric) for a in db.adjacencies),
        node_label=db.node_label, area="0")
    for states in states_list:
        states["0"].update_adjacency_database(new)


def count_spf(link_state) -> dict:
    """Wrap ``run_spf`` of a LinkState to count its calls."""
    calls = {"spf": 0}
    orig = link_state.run_spf

    def counting(*a, **k):
        calls["spf"] += 1
        return orig(*a, **k)

    link_state.run_spf = counting
    return calls


def ksp2_phase(c) -> dict:
    """wan50k KSP2 (module docstring, phase 10). Returns the ksp2 path's
    launches by kernel."""
    import numpy as np

    torch, gs, ksp2, relax = c.torch, c.gpu_solver, c.ksp2, c.relax
    t_phase = time.perf_counter()
    # the small WAN first: every KSP2 destination against the oracle
    gen = lambda: c.topologies.wan(**WAN_SMALL)  # noqa: E731
    _, s_states, s_ps = build_cell(c.topologies, gen)
    _, o_states, o_ps = build_cell(c.topologies, gen)
    calls = count_spf(s_states["0"])
    got = gs.GpuSpfSolver(WAN_SMALL_ROOT, device=c.dev).build_route_db(
        WAN_SMALL_ROOT, s_states, s_ps)
    want = c.SpfSolver(WAN_SMALL_ROOT).build_route_db(WAN_SMALL_ROOT,
                                                      o_states, o_ps)
    check(calls["spf"] == 0, "small WAN: the KSP2 build ran a host Dijkstra")
    check(rib_equal(want, got), "small WAN: KSP2 RIB != oracle")
    log(f"small WAN (2,048 nodes, 64 KSP2 destinations): RIB == oracle, "
        f"0 host Dijkstras, {time.perf_counter() - t_phase:.1f} s")

    t0 = time.perf_counter()
    gen = lambda: c.topologies.wan(**WAN50K)  # noqa: E731
    adj_dbs, states, ps = build_cell(c.topologies, gen)
    _, o_states, o_ps = build_cell(c.topologies, gen)
    log(f"wan50k: {states['0'].node_count()} nodes, {len(ps.prefixes())} "
        f"prefixes, host build of two copies {time.perf_counter() - t0:.1f} s")
    calls = count_spf(states["0"])
    solver = gs.GpuSpfSolver(WAN50K_ROOT, device=c.dev)
    oracle = c.SpfSolver(WAN50K_ROOT)
    reads0 = c.zero_counts()

    def build(label):
        t0 = time.perf_counter()
        db = solver.build_route_db(WAN50K_ROOT, states, ps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        tm = solver.last_timing
        log(f"wan50k {label}: " + json.dumps({
            "build_ms": wall,
            **{k: v for k, v in tm.items() if k.startswith("ksp2_")},
            **{k: tm.get(k) for k in ("sssp_ms", "pipeline_wall_ms",
                                      "spf_kernel")},
            "host_run_spf": calls["spf"],
            "launches_so_far": {k: c.wrappers[k][0].launches for k in (
                "K10:overlay_planes", "K11:masked_delta", "base_sssp")}}))
        check(calls["spf"] == 0, f"wan50k {label}: a host Dijkstra ran")
        return db

    def sampled_ksp2(db, label):
        t0 = time.perf_counter()
        oracle.best_routes_cache.clear()
        for prefix in ksp2_sample:
            want = oracle.create_route_for_prefix(WAN50K_ROOT, o_states, o_ps,
                                                  prefix)
            check(want == db.unicast_routes.get(prefix),
                  f"wan50k {label}: KSP2 route {prefix} != oracle")
        return (time.perf_counter() - t0) * 1e3

    db = build("cold build")
    _, fast, _, ksp2_all, _ = solver._partition
    ksp2_sample = sorted(ksp2_all)[::WAN_KSP2_SAMPLE]
    ad = solver._area_dev["0"]
    plan = ad.plan
    n_nodes = states["0"].node_count()
    check(len(ksp2_all) == -(-n_nodes // WAN50K["ksp2_every"]),
          "wan50k: one KSP2 prefix every ksp2_every nodes")
    log("wan50k plan: " + json.dumps({
        "n_cap": plan.n_cap, "s_cap": plan.s_cap,
        "res": list(plan.res_nbr.shape), "k_res": plan.k_res}))
    t0 = time.perf_counter()
    oracle.best_routes_cache.clear()
    for prefix in fast["0"]:
        want = oracle.create_route_for_prefix(WAN50K_ROOT, o_states, o_ps,
                                              prefix)
        check(want == db.unicast_routes.get(prefix),
              f"wan50k: fast-path route {prefix} != oracle")
    t_fast = (time.perf_counter() - t0) * 1e3
    t_k = sampled_ksp2(db, "cold build")
    log(f"wan50k cold build: {len(fast['0'])} fast-path routes and "
        f"{len(ksp2_sample)} of {len(ksp2_all)} KSP2 routes == oracle "
        f"(oracle host {t_fast:.0f} ms and "
        f"{t_k:.0f} ms)")
    rstate = solver._ksp2_rows[("0", WAN50K_ROOT)]
    prev_rows = None
    for rnd, (victim, metric) in enumerate(WAN_CHURN, start=1):
        set_metric(c.AdjacencyDatabase, (states, o_states), adj_dbs, victim,
                   metric)
        prev_rows = rstate.d_prev
        db = build(f"churn round {rnd} ({victim} to {metric})")
        check("ksp2_init" not in solver.last_timing,
              f"wan50k churn round {rnd} must take the delta path")
        t_k = sampled_ksp2(db, f"churn round {rnd}")
        log(f"wan50k churn round {rnd}: {len(ksp2_sample)} KSP2 routes == "
            f"oracle (oracle host {t_k:.0f} ms)")
    torch.cuda.synchronize()
    launches, reads = c.read_counts(reads0)
    log(f"wan50k launches over the cold build and 3 churn rounds: "
        f"{json.dumps({k: v for k, v in launches.items() if v})}, "
        f"flag reads {reads}")
    for name in KSP2_PATH:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              "ksp2 path")
    c.variant_launches["K1:relax_step[ksp2]"] = launches["K1:relax_step"]

    # the kernels against their plain versions at wan50k's shapes
    n_cap, s_cap = plan.n_cap, plan.s_cap
    r_cap, kr_cap = plan.res_nbr.shape
    b, ms_cap = rstate.mask_s.shape
    mr_cap = rstate.mask_r.shape[1]
    ms_t = torch.from_numpy(rstate.mask_s).to(c.dev)
    mr_t = torch.from_numpy(rstate.mask_r).to(c.dev)
    has_res = plan.k_res > 0
    over = (ad.shift_w, ad.res_w, ms_t, None, mr_t, None)
    words = s_cap * n_cap + r_cap * kr_cap
    c.record(
        "K10:overlay_planes",
        max_abs_err(torch, ksp2.overlay_planes(*over),
                    ksp2.overlay_planes_plain(*over)),
        lambda: ksp2.overlay_planes(*over),
        lambda: ksp2.overlay_planes_plain(*over),
        nbytes=4 * (words + b * words + b * (ms_cap + mr_cap)),
        ops=b * (ms_cap + mr_cap), reps=20, plain_reps=3,
    )
    lanes = torch.arange(b, device=c.dev)[:, None].expand(b, ms_cap)
    keep = ms_t < s_cap * n_cap
    li, fi = lanes[keep], ms_t[keep].long()

    def repeat_index_put():
        flat = ad.shift_w.reshape(1, -1).repeat(b, 1)
        flat.index_put_((li, fi), torch.tensor(relax.INF_E, dtype=torch.int32,
                                               device=c.dev))
        return flat

    log("K10 beside its nearest PyTorch pair, repeat then index_put_ "
        "(shift planes only; not one call, so no library_ms): " + json.dumps({
            "K10_ms": c.results["K10:overlay_planes"]["ms"],
            "repeat_index_put_ms": time_ms(torch, repeat_index_put, 20)}))
    errs = []
    for k_cap in (4, min(ksp2._DELTA_K, n_cap)):
        errs.append(max_abs_err(
            torch, ksp2.masked_delta(rstate.d_prev, prev_rows, k_cap),
            ksp2.masked_delta_plain(rstate.d_prev, prev_rows, k_cap)))
    cnt = ksp2.masked_delta(rstate.d_prev, prev_rows, 4)[:, 0]
    check(int((cnt > 4).sum()) > 0, "K11 check: k_cap 4 must overflow a row")
    k_cap = min(ksp2._DELTA_K, n_cap)
    c.record(
        "K11:masked_delta", max(errs),
        lambda: ksp2.masked_delta(rstate.d_prev, prev_rows, k_cap),
        lambda: ksp2.masked_delta_plain(rstate.d_prev, prev_rows, k_cap),
        nbytes=4 * (2 * b * n_cap + b * (1 + 2 * k_cap)),
        ops=3 * b * n_cap, reps=20, plain_reps=3,
    )
    # K1 over the lane planes: one step from a mid-solve wavefront
    deltas_b, sw, res_k = ksp2.lane_inputs(
        ad.deltas, ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w, ms_t, None,
        mr_t, None, has_res)
    res_p = plain_residual(res_k, n_cap)
    root = plan.node_index[WAN50K_ROOT]
    roots = torch.tensor([root], dtype=torch.int32, device=c.dev)
    mid = ksp2.seed_rows(roots, b, n_cap)
    check(max_abs_err(torch, mid, ksp2.seed_rows_plain(roots, b, n_cap)) == 0,
          "K1s seed rows != plain")
    spare = torch.empty_like(mid)
    flag = torch.zeros(1, dtype=torch.int32, device=c.dev)
    for _ in range(4):
        relax.relax_step(mid, spare, flag, deltas_b, sw, res_k)
        mid, spare = spare, mid
    o_k, o_p = torch.empty_like(mid), torch.empty_like(mid)
    f_k, f_p = torch.zeros_like(flag), torch.zeros_like(flag)
    relax.relax_step(mid, o_k, f_k, deltas_b, sw, res_k)
    relax.relax_step_plain(mid, o_p, f_p, deltas_b, sw, res_p)
    check(int(f_k) == 1, "K1 lanes: a wavefront step must change the rows")
    c.record(
        "K1:relax_step[ksp2]", max_abs_err(torch, (o_k, f_k), (o_p, f_p)),
        lambda: relax.relax_step(mid, o_k, f_k, deltas_b, sw, res_k),
        lambda: relax.relax_step_plain(mid, o_p, f_p, deltas_b, sw, res_p),
        nbytes=4 * (2 * b * n_cap + b * words + b * s_cap
                    + (2 * r_cap * kr_cap + r_cap if has_res else 0)),
        ops=2 * b * (n_cap * s_cap + (r_cap * kr_cap if has_res else 0)),
        reps=20, plain_reps=2,
    )
    c.split("K1:relax_step[ksp2]",
            lambda: relax.relax_step(mid, o_k, f_k, deltas_b, sw, res_k),
            floor=k1_floor(c.cuda, mid, o_k, f_k, deltas_b, sw, res_k,
                           int(has_res)))
    one_launch(torch, c.wrappers, "K1 [ksp2]", lambda: relax.relax_step(
        mid, o_k, f_k, deltas_b, sw, res_k))
    # the whole masked batch, kernels vs plain, on 8 rows
    sub = (ad.deltas, ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w, root,
           ms_t[:8].contiguous(), mr_t[:8].contiguous(), has_res)
    t0 = time.perf_counter()
    rows_k = ksp2.masked_rows(*sub)
    torch.cuda.synchronize()
    t_rows = (time.perf_counter() - t0) * 1e3
    check(max_abs_err(torch, rows_k.cpu(), ksp2.masked_rows(*on_cpu(sub)))
          == 0, "masked_rows: kernels != plain (CPU copies)")
    check(max_abs_err(torch, rows_k, rstate.d_prev[:8]) == 0,
          "masked_rows != the solver's resident rows")
    # the chunked stateless path: b_cap past a lowered resident-row bound
    locs = _mask_locs(rstate, plan)
    saved = ksp2._MAX_RESIDENT_ROWS
    chunk = max(4, rstate.b_cap // 4)
    ksp2._MAX_RESIDENT_ROWS = chunk
    try:
        chunked = ksp2.MaskedRowsState()
        ch = ksp2.masked_rows_update(
            chunked, plan, ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w,
            ad.deltas, root, rstate.dest_key, locs)
    finally:
        ksp2._MAX_RESIDENT_ROWS = saved
    n_rows = len(rstate.dest_key)
    check(ch == [True] * n_rows and chunked.d_prev is None,
          "the chunked path must run stateless")
    check(np.array_equal(chunked.host_rows, rstate.host_rows[:n_rows]),
          "chunked masked rows != the resident rows")
    log(f"masked rows equal to plain (8 rows, {t_rows:.1f} ms host wall) and, "
        f"through the chunked path ({-(-n_rows // chunk)} chunks of {chunk}), "
        f"to the "
        f"resident rows; phase 10 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def _mask_locs(rstate, plan) -> list:
    """The edge locations of a MaskedRowsState's last masks, row by row
    (pads dropped): what masked_rows_update rebuilds them from."""
    n_cap = plan.n_cap
    r_cap, kr_cap = plan.res_nbr.shape
    rows = []
    for i in range(len(rstate.dest_key)):
        row = [("s", int(f) // n_cap, int(f) % n_cap)
               for f in rstate.mask_s[i] if f < plan.s_cap * n_cap]
        row += [("r", int(f) // kr_cap, int(f) % kr_cap)
                for f in rstate.mask_r[i] if f < r_cap * kr_cap]
        rows.append(row)
    return rows


# -- 11. what-if sweeps: whatif1k and fabric10k -------------------------------

WHATIF1K_SIDE = 32
WHATIF1K_ROOT = "node-16-16"
# scenarios checked against the host: whatif1k, fabric10k
WHATIF_SAMPLES = (16, 4)


def host_verdict(link_state, root, links, base, keep=None) -> dict:
    """A scenario's verdicts from the host: run_spf without ``links``
    against the unperturbed field ``base`` ({node: metric}); node
    ``keep`` keeps its base metric (a drained node is still reached)."""
    spf = link_state.run_spf(root, True, set(links))
    after = {n: spf[n].metric for n in spf}
    if keep is not None:
        after[keep] = base[keep]
    lost = [n for n in base if n not in after]
    return {
        "unreachable_pairs": len(lost),
        "max_stretch": max([0] + [after[n] - base[n] for n in base
                                  if n in after]),
        "changed_nodes": sum(after.get(n) != m for n, m in base.items()),
    }


def check_verdicts(ls, root, out, n: int, seed: int, label: str) -> None:
    spf = ls.run_spf(root)
    base = {name: spf[name].metric for name in spf}
    links = {f"{ln.n1}|{ln.n2}": ln for ln in ls.ordered_all_links()
             if ln.is_up()}
    rows = sorted(out["rows"], key=lambda r: r["scenario"])
    for row in random.Random(seed).sample(rows, n):
        want = host_verdict(ls, root, {links[row["scenario"]]}, base)
        got = {k: row[k] for k in want}
        check(got == want, f"{label}: {row['scenario']} verdicts {got} != "
              f"host {want}")


def sweep_kernels(c, a, k, timed: bool) -> None:
    """The sweep's kernels against their plain versions (tolerance 0) on
    one dispatch's own inputs ``a`` / ``k``: K10 (the shift planes and,
    with a residual, the residual planes), one K1 step from a mid-solve
    wavefront over the lane planes, K12 on the dispatch's distances, and
    the whole sweep on the first 64 lanes against its plain run on CPU
    copies. ``timed`` records the kernels under their ``[sweep]`` names
    (whatif1k's dispatch); else they are only checked (fabric10k's
    residual dispatch, sliced to 64 lanes by the caller)."""
    torch, ksp2, relax, sweep = c.torch, c.ksp2, c.relax, c.sweep
    (deltas, shift_w, res_rows, res_nbr, res_w, roots, sh_idx, sh_val,
     rs_idx, rs_val) = a
    has_res = k["has_res"]
    b, es = sh_idx.shape
    s_cap, n_cap = shift_w.shape
    over = (shift_w, res_w if has_res else None, sh_idx, sh_val,
            rs_idx if has_res else None, rs_val)
    got, want = ksp2.overlay_planes(*over), ksp2.overlay_planes_plain(*over)
    err = max_abs_err(torch, got[0], want[0])
    if has_res:
        err = max(err, max_abs_err(torch, got[1], want[1]))
    del got, want
    deltas_b, sw, res_k = ksp2.lane_inputs(
        deltas, shift_w, res_rows, res_nbr, res_w, sh_idx, sh_val, rs_idx,
        rs_val, has_res)
    res_p = plain_residual(res_k, n_cap)
    mid = ksp2.seed_rows(roots, b, n_cap)
    spare = torch.empty_like(mid)
    flag = torch.zeros(1, dtype=torch.int32, device=c.dev)
    for _ in range(4):
        relax.relax_step(mid, spare, flag, deltas_b, sw, res_k)
        mid, spare = spare, mid
    o_k, o_p = torch.empty_like(mid), torch.empty_like(mid)
    f_k, f_p = torch.zeros_like(flag), torch.zeros_like(flag)
    relax.relax_step(mid, o_k, f_k, deltas_b, sw, res_k)
    relax.relax_step_plain(mid, o_p, f_p, deltas_b, sw, res_p)
    check(int(f_k) == 1, "K1 sweep lanes: a wavefront step must change")
    step_err = max_abs_err(torch, (o_k, f_k), (o_p, f_p))
    full = sweep.sweep(*a, **{**k, "return_dist": True})
    dist = full[4]
    v_err = max_abs_err(torch, sweep.sweep_verdicts(dist),
                        sweep.sweep_verdicts_plain(dist))
    res_words = res_w.numel() if has_res else 0
    if timed:
        c.record(
            "K10:overlay_planes[sweep]", err,
            lambda: ksp2.overlay_planes(*over),
            lambda: ksp2.overlay_planes_plain(*over),
            nbytes=4 * ((s_cap * n_cap + res_words) * (1 + b) + 2 * b * es),
            ops=b * es,
        )
        c.record(
            "K12:sweep_verdicts", v_err,
            lambda: sweep.sweep_verdicts(dist),
            lambda: sweep.sweep_verdicts_plain(dist),
            nbytes=4 * (dist.numel() + dist[0].numel() + 3 * b),
            ops=6 * dist.numel(),
        )
        c.record(
            "K1:relax_step[sweep]", step_err,
            lambda: relax.relax_step(mid, o_k, f_k, deltas_b, sw, res_k),
            lambda: relax.relax_step_plain(mid, o_p, f_p, deltas_b, sw,
                                           res_p),
            nbytes=4 * (2 * mid.numel() + b * s_cap * n_cap + b * s_cap),
            ops=2 * mid.numel() * s_cap, reps=20, plain_reps=2,
        )
    else:
        check(err == 0 and step_err == 0 and v_err == 0,
              f"sweep kernels != plain (K10 {err}, K1 {step_err}, "
              f"K12 {v_err})")
    del deltas_b, sw, res_k, res_p, mid, spare, o_k, o_p
    # the whole sweep on the first 64 lanes: kernels vs CPU copies
    sub = (*a[:6], *(t[:64].contiguous() for t in a[6:]))
    t0 = time.perf_counter()
    got = sweep.sweep(*sub, **{**k, "return_dist": True})
    want = sweep.sweep(*on_cpu(sub), **{**k, "return_dist": True})
    plain_s = time.perf_counter() - t0
    check(max_abs_err(torch, [t.cpu() for t in got[:3] + (got[4],)],
                      want[:3] + (want[4],)) == 0
          and (got[3], got[5]) == (want[3], want[5]),
          "sweep: kernels != plain on 64 lanes")
    check(max_abs_err(torch, got[4], dist[:64]) == 0,
          "sweep: 64 lanes != the same lanes of the dispatch")
    log(f"sweep kernels equal to plain ({b} lanes, residual {has_res}: K10, "
        f"K1, K12; the whole sweep on 64 lanes, {plain_s:.1f} s with its "
        f"CPU run)")


def whatif_phase(c) -> tuple[dict, dict]:
    """The what-if sweeps (module docstring, phase 11). Returns the sweep
    path's launches by kernel and the cells' (solver, states, prefix
    state), which the TE phase goes on with."""
    torch, gs, ksp2, relax, sweep, whatif = (c.torch, c.gpu_solver, c.ksp2,
                                             c.relax, c.sweep, c.whatif)
    t_phase = time.perf_counter()
    _, states, ps = build_cell(c.topologies, lambda: c.topologies.grid(
        WHATIF1K_SIDE, node_labels=False))
    solver = gs.GpuSpfSolver(WHATIF1K_ROOT, device=c.dev)
    solver.build_route_db(WHATIF1K_ROOT, states, ps)
    eng = whatif.WhatIfEngine(solver)
    n_links = 2 * WHATIF1K_SIDE * (WHATIF1K_SIDE - 1)
    lanes = 2
    while lanes < n_links + 1:
        lanes *= 2
    captured = []
    real = whatif.sweep

    def spy(*a, **k):
        captured.append((a, k))
        return real(*a, **k)

    whatif.sweep = spy
    reads0 = c.zero_counts()
    out = {}
    try:
        for kernel in ("bucketed", "sync"):
            solver.spf_kernel = kernel
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            job = eng.plan_sweep(states, ps, order=1)
            out[kernel] = job.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            o = out[kernel]
            log(f"whatif1k sweep ({kernel} solver): " + json.dumps({
                "scenarios": o["scenarios"], "dispatches": o["dispatches"],
                "lanes": captured[-1][0][6].shape[0], "trips": o["trips"],
                "rounds": job.rounds, "sweep_ms": o["sweep_ms"],
                "scenarios_per_s": o["scenarios"] / wall,
                "partitioned": o["partitioned"]}))
            check(o["scenarios"] == n_links and o["dispatches"] == 1
                  and captured[-1][0][6].shape[0] == lanes,
                  f"whatif1k: {n_links} scenarios in one dispatch of "
                  f"{lanes} lanes")
    finally:
        whatif.sweep = real
        solver.spf_kernel = "bucketed"
    torch.cuda.synchronize()
    launches, reads = c.read_counts(reads0)
    check(out["sync"]["rows"] == out["bucketed"]["rows"],
          "whatif1k: the sync and bucketed solvers' sweeps differ")
    check_verdicts(states["0"], WHATIF1K_ROOT, out["sync"],
                   WHATIF_SAMPLES[0], 1, "whatif1k")
    log(f"whatif1k: {WHATIF_SAMPLES[0]} sampled verdicts == host run_spf; "
        f"launches {json.dumps({k: v for k, v in launches.items() if v})}, "
        f"flag reads {reads}")
    for name in ("K10:overlay_planes", "K1s:sssp_init", "K1:relax_step",
                 "K12:sweep_verdicts"):
        check(launches[name] > 0, f"kernel {name} never launched on the "
              "sweep path")
    c.variant_launches["K1:relax_step[sweep]"] = launches["K1:relax_step"]
    c.variant_launches["K10:overlay_planes[sweep]"] = launches[
        "K10:overlay_planes"]

    sweep_kernels(c, *captured[-1], timed=True)
    log(f"whatif1k sweep kernels equal to plain; phase 11a took "
        f"{time.perf_counter() - t_phase:.1f} s")

    # fabric10k: the residual ELL, two dispatches, drains
    t0 = time.perf_counter()
    me = "pod000-rsw00"
    _, f_states, f_ps = build_cell(c.topologies,
                                   lambda: c.topologies.fabric(**FABRIC))
    f_solver = gs.GpuSpfSolver(me, device=c.dev)
    f_solver.build_route_db(me, f_states, f_ps)
    f_eng = whatif.WhatIfEngine(f_solver)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    captured.clear()
    whatif.sweep = spy
    try:
        t1 = time.perf_counter()
        f_out = f_eng.sweep(f_states, f_ps, order=1, max_scenarios=2048)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    finally:
        whatif.sweep = real
    plan = f_solver._area_dev["0"].plan
    log("fabric10k sweep: " + json.dumps({
        "scenarios": f_out["scenarios"], "dispatches": f_out["dispatches"],
        "truncated": f_out["truncated"], "trips": f_out["trips"],
        "sweep_ms": f_out["sweep_ms"],
        "scenarios_per_s": f_out["scenarios"] / wall,
        "k_res": plan.k_res, "res": list(plan.res_nbr.shape),
        "live_bytes_before": live,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "sweep_peak_bytes": torch.cuda.max_memory_allocated() - live}))
    cap = f_eng._batch_cap(plan.n_cap, 1)
    check(f_out["scenarios"] == min(2048, f_out["scenarios"]
                                    + f_out["truncated"])
          and f_out["dispatches"] == -(-f_out["scenarios"] // cap)
          and plan.k_res > 0,
          f"fabric10k: the scenarios in dispatches of {cap} scenarios "
          "over the residual")
    check_verdicts(f_states["0"], me, f_out, WHATIF_SAMPLES[1], 2,
                   "fabric10k")
    fa, fk = captured[0]
    check(fk["has_res"], "fabric10k: the sweep must carry the residual")
    sweep_kernels(c, (*fa[:6], *(t[:64].contiguous() for t in fa[6:])), fk,
                  timed=False)
    del captured[:], fa
    f_ls = f_states["0"]
    spf = f_ls.run_spf(me)
    base = {n: spf[n].metric for n in spf}
    spine = "zspine00-ssw00"
    links = {f"{ln.n1}|{ln.n2}": ln for ln in f_ls.ordered_all_links()}
    link_name = sorted(n for n in links if me in n.split("|"))[0]
    for kw in ({"node": spine}, {"link": link_name}):
        d = f_eng.drain(f_states, f_ps, top=8, **kw)
        if "link" in kw:
            want = host_verdict(f_ls, me, {links[link_name]}, base)
        else:
            # a drained node keeps its in-edges: every other node sees
            # the graph without the node's links, the node itself is
            # reached as before
            want = host_verdict(f_ls, me, f_ls.links_from_node(spine), base,
                                keep=spine)
        got = {k: d[k] for k in want}
        check(got == want, f"fabric10k drain {kw}: {got} != host {want}")
        log(f"fabric10k drain {kw}: " + json.dumps({
            k: d[k] for k in ("unreachable_pairs", "max_stretch",
                              "changed_nodes", "drain_ms")}
            | {"impacted": len(d["impacted"])}))
    log(f"fabric10k sweep verdicts ({WHATIF_SAMPLES[1]} sampled) == host "
        f"run_spf; 11b took {time.perf_counter() - t0:.1f} s")
    return launches, {"whatif1k": (solver, states, ps),
                      "fabric10k": (f_solver, f_states, f_ps)}


# -- 12. differentiable TE: whatif1k, fabric10k, the diamond -----------------

# demand sources and demands of the TE cells (whatif1k, fabric10k); the
# volumes are seeded integers 1-9
TE_SOURCES = (32, 64)
TE_DEMANDS = 1024
TE_SEED = 11
# fabric10k's te_step against its plain run on CPU copies: its first
# sources only (the plain residual softmin is [S, 8192, 128] a trip)
TE_CPU_SOURCES = 2
# float32 tolerance, relative to each output's largest magnitude; grad is
# second order, summed over the trips
TE_TOL = {"loss": 1e-4, "cost": 1e-4, "util": 1e-4, "grad": 1e-3}
# trips in each kernel's slice check, and each kernel's tolerance there
# (relative to its outputs' largest magnitude)
TE_SLICE = 4
TE_KERNEL_TOL = 1e-4
TE_PATH = ("K13:te_relax", "K14:te_relax_vjp", "K14s:te_link_sum",
           "K17:te_loss", "K15:te_relax_jvp", "K16:te_relax_vjp_jvp")


def te_demands(names: list, n_src: int, n_dem: int, seed: int) -> list:
    """``n_dem`` demands from ``n_src`` seeded sources (round robin) to
    seeded destinations over the sorted node names, volumes 1-9."""
    import numpy as np

    rng = np.random.default_rng(seed)
    srcs = sorted(int(i) for i in rng.choice(len(names), n_src,
                                             replace=False))
    out = []
    for i in range(n_dem):
        s, d = srcs[i % n_src], int(rng.integers(len(names)))
        out.append({"src": names[s], "dst": names[d if d != s else
                                                   (d + 1) % len(names)],
                    "volume": float(rng.integers(1, 10))})
    return out


def te_err(torch, got, want) -> tuple[float, float]:
    """-> (max |got - want|, that over want's largest magnitude), in
    float64."""
    got, want = got.double().cpu(), want.double().cpu()
    check(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
    if want.numel() == 0:
        return 0.0, 0.0
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def te_check(torch, got, want, names, label) -> dict:
    errs = {}
    for name, g, w in zip(names, got, want):
        errs[name] = te_err(torch, g, w)[1]
        check(errs[name] <= TE_TOL[name], f"{label}: {name} rel err "
              f"{errs[name]} > {TE_TOL[name]}")
    return errs


def te_plan_copy(c, tp, device, n_src: int):
    """``tp`` on ``device``, restricted to its first ``n_src`` sources and
    their demands (the others' volumes 0)."""
    torch = c.torch
    keep = tp.dem_row < n_src
    arrays = [t.cpu().numpy() for t in (
        tp.deltas, tp.res_rows, tp.res_nbr, tp.sh_flat, tp.sh_link,
        tp.rs_flat, tp.rs_link, tp.srcs[:n_src],
        torch.where(keep, tp.dem_row, 0), tp.dem_dst,
        torch.where(keep, tp.dem_vol, 0.0))]
    return c.te.te_plan(*arrays, n_cap=tp.n_cap, l_cap=tp.l_cap,
                        trips=tp.trips, has_res=tp.has_res, device=device)


def te_step_split(c, tp, theta, tau: float, tau_u: float) -> dict:
    """One te_step on the card with CUDA events between its stages: ->
    {kernel: ms}."""
    torch, te = c.torch, c.te
    s, n = tp.srcs.numel(), tp.n_cap
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=c.dev)

    fields = empty(tp.trips + 1, s, n)
    lam, lam_t = empty(s, n), empty(s, n)
    ct = (empty(s, tp.sh_link.numel()), empty(s, tp.rs_link.numel()))
    tfields = torch.empty_like(fields)
    torch.cuda.synchronize()
    ev[0].record()
    te.te_relax(tp, theta, fields, tau)
    ev[1].record()
    te.te_relax_vjp(tp, theta, fields, lam, *ct, tau)
    ev[2].record()
    util = te.te_link_sum(tp, *ct)
    ev[3].record()
    _, v = te.te_loss(tp, util, fields[-1], tau_u)
    ev[4].record()
    te.te_relax_jvp(tp, theta, v, fields, tfields, tau)
    ev[5].record()
    te.te_relax_vjp_jvp(tp, theta, v, fields, tfields, lam, lam_t, *ct, tau)
    ev[6].record()
    te.te_link_sum(tp, *ct)
    ev[7].record()
    torch.cuda.synchronize()
    t = [ev[i].elapsed_time(ev[i + 1]) for i in range(7)]
    return {"K13:te_relax": t[0], "K14:te_relax_vjp": t[1],
            "K14s:te_link_sum": t[2] + t[6], "K17:te_loss": t[3],
            "K15:te_relax_jvp": t[4], "K16:te_relax_vjp_jvp": t[5]}


def te_buffers(c, tp, theta, tau: float = 1.0, tau_u: float = 1.0):
    """One step's buffers on the card: the trips' fields (K13), K14's
    cotangents, util (K14s), the loss and v (K17), the tangent fields
    (K15)."""
    torch, te = c.torch, c.te
    s, n, T = tp.srcs.numel(), tp.n_cap, tp.trips

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=c.dev)

    fields = empty(T + 1, s, n)
    te.te_relax(tp, theta, fields, tau)
    lam = empty(s, n)
    ct = (empty(s, tp.sh_link.numel()), empty(s, tp.rs_link.numel()))
    te.te_relax_vjp(tp, theta, fields, lam, *ct, tau)
    util = te.te_link_sum(tp, *ct)
    lc, v = te.te_loss(tp, util, fields[-1], tau_u)
    tfields = torch.empty_like(fields)
    te.te_relax_jvp(tp, theta, v, fields, tfields, tau)
    return types.SimpleNamespace(fields=fields, lam=lam, ct=ct, util=util,
                                 lc=lc, v=v, tfields=tfields)


def te_adjoint_err(c, tp, theta, b, tan: bool, tau: float = 1.0):
    """K14 (``tan`` False) or K16 over the whole run against its plain
    version on the same card tensors, its cotangents seeded from the
    demands as in a step: -> ((abs, rel) error, the largest of its
    outputs'; K16's lam_t apart, or None). K16's tangent of the
    cotangent on trip 0's field is 0 but for rounding (that cotangent is
    each source's total volume, whatever theta is): it is reported, not
    held to a relative tolerance."""
    torch, te = c.torch, c.te
    s, n = tp.srcs.numel(), tp.n_cap
    outs = []
    fn = te.te_relax_vjp_jvp if tan else te.te_relax_vjp
    for f in (fn, getattr(te, fn.__name__ + "_plain")):
        bufs = [torch.empty((s, n), device=c.dev)
                for _ in range(2 if tan else 1)] + [
            torch.empty((s, tp.sh_link.numel()), device=c.dev),
            torch.empty((s, tp.rs_link.numel()), device=c.dev)]
        if tan:
            f(tp, theta, b.v, b.fields, b.tfields, *bufs, tau)
        else:
            f(tp, theta, b.fields, *bufs, tau)
        outs.append(bufs)
    es = [te_err(torch, x, y) for x, y in zip(*outs)]
    lam_t = es.pop(1) if tan else None
    return max(es, key=lambda e: e[1]), lam_t


def te_work(tp) -> dict:
    """Each TE kernel's least work at ``tp``'s shapes: -> {kernel:
    (bytes, operations)}. Every input read once, every output written
    once; the operations each (trip, source, node) does (exp / log1p
    counted as one operation each, as the float32 rate counts an
    add)."""
    s, n, T = tp.srcs.numel(), tp.n_cap, tp.trips
    n_sh, n_rs = tp.sh_link.numel(), tp.rs_link.numel()
    C, (R, K) = tp.deltas.numel(), tp.res_nbr.shape
    rows = int((tp.row_of >= 0).sum())
    live, L, D = int(tp.inv_ptr[-1]), tp.l_cap, tp.dem_row.numel()
    field = (T + 1) * s * n * 4
    tables = 4 * (2 * C * n + n + 3 * R * K + R + n + 1 + live + s
                  + 3 * D + L)
    fwd_ops = T * s * (n * C * 12 + live * 8 + rows * 6 + n * 4)
    adj_ops = T * s * (n * C * 20 + live * 14 + rows * 10 + n * 8)
    ct_bytes = 4 * s * (n_sh + n_rs)
    lam_bytes = 4 * s * n
    return {
        "K13:te_relax": (tables + field, fwd_ops),
        "K14:te_relax_vjp": (tables + field + lam_bytes + ct_bytes,
                             adj_ops),
        "K14s:te_link_sum": (ct_bytes + 4 * (L + 1 + n_sh + n_rs) + 4 * L,
                             s * (n_sh + n_rs)),
        "K17:te_loss": (4 * (2 * L + 4 * D + 2), 6 * L + 2 * D),
        "K15:te_relax_jvp": (tables + 2 * field + 4 * L, 2 * fwd_ops),
        "K16:te_relax_vjp_jvp": (
            tables + 2 * field + 2 * lam_bytes + ct_bytes + 4 * L,
            2 * adj_ops),
    }


def te_calls(c, tp, theta, b, tau: float = 1.0, tau_u: float = 1.0) -> dict:
    """Each TE kernel's call at the step's own shapes (the whole trip
    count), on fresh outputs, and its plain version's: -> {kernel:
    (call, plain call)}."""
    torch, te = c.torch, c.te
    s, n, T = tp.srcs.numel(), tp.n_cap, tp.trips

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=c.dev)

    ff, tt = empty(T + 1, s, n), empty(T + 1, s, n)
    bl = [empty(s, n), empty(s, n), empty(s, tp.sh_link.numel()),
          empty(s, tp.rs_link.numel())]
    f, tf, v, ct = b.fields, b.tfields, b.v, b.ct
    return {
        "K13:te_relax": (
            lambda: te.te_relax(tp, theta, ff, tau),
            lambda: te.te_relax_plain(tp, theta, ff, tau)),
        "K14:te_relax_vjp": (
            lambda: te.te_relax_vjp(tp, theta, f, bl[0], *bl[2:], tau),
            lambda: te.te_relax_vjp_plain(tp, theta, f, bl[0], *bl[2:],
                                          tau)),
        "K14s:te_link_sum": (
            lambda: te.te_link_sum(tp, *ct),
            lambda: te.te_link_sum_plain(tp, *ct)),
        "K17:te_loss": (
            lambda: te.te_loss(tp, b.util, f[-1], tau_u),
            lambda: te.te_loss_plain(tp, b.util, f[-1], tau_u)),
        "K15:te_relax_jvp": (
            lambda: te.te_relax_jvp(tp, theta, v, f, tt, tau),
            lambda: te.te_relax_jvp_plain(tp, theta, v, f, tt, tau)),
        "K16:te_relax_vjp_jvp": (
            lambda: te.te_relax_vjp_jvp(tp, theta, v, f, tf, *bl, tau),
            lambda: te.te_relax_vjp_jvp_plain(tp, theta, v, f, tf, *bl,
                                              tau)),
    }


def te_kernels(c, tp, theta, timed: bool, label: str) -> None:
    """Each TE kernel against its plain version (run on the same card
    tensors) within TE_KERNEL_TOL: K13 and K15 over TE_SLICE trips from
    the middle of the run, K14 and K16 over the whole run (their
    cotangents seeded from the demands, as in a step), K14s and K17 on
    the whole run's buffers. ``timed`` records them at the step's own
    shapes (the whole trip count) beside their bounds."""
    torch, te = c.torch, c.te
    tau = tau_u = 1.0
    T = tp.trips
    b = te_buffers(c, tp, theta, tau, tau_u)
    fields, tfields, v, util, lc = b.fields, b.tfields, b.v, b.util, b.lc
    errs = {}
    # K13 / K15 on a mid-run slice
    t0 = T // 2
    sl = slice(t0, t0 + TE_SLICE + 1)
    f_k, f_p = fields[sl].clone(), fields[sl].clone()
    te.te_relax(tp, theta, f_k, tau, seed=False)
    te.te_relax_plain(tp, theta, f_p, tau, seed=False)
    errs["K13:te_relax"] = te_err(torch, f_k, f_p)
    g_k, g_p = tfields[sl].clone(), tfields[sl].clone()
    te.te_relax_jvp(tp, theta, v, fields[sl], g_k, tau, seed=False)
    te.te_relax_jvp_plain(tp, theta, v, fields[sl], g_p, tau, seed=False)
    errs["K15:te_relax_jvp"] = te_err(torch, g_k, g_p)
    # K14 / K16 over the whole run: a tie between a node's residual
    # candidate and its own distance (the common case at convergence)
    # splits its cotangent 1:3 under the reference's rules and sends all
    # of it to the candidate one ulp away, so which of the two a
    # recomputed trip takes moves cotangent between a slice's first field
    # and its theta slots — the sums over every trip do not move
    errs["K14:te_relax_vjp"] = te_adjoint_err(c, tp, theta, b, False)[0]
    errs["K16:te_relax_vjp_jvp"], errs["K16 lam_t (abs, rel)"] = (
        te_adjoint_err(c, tp, theta, b, True))
    errs["K14s:te_link_sum"] = te_err(torch, util,
                                      te.te_link_sum_plain(tp, *b.ct))
    lc_p, v_p = te.te_loss_plain(tp, util, fields[-1], tau_u)
    errs["K17:te_loss"] = max(te_err(torch, lc, lc_p), te_err(torch, v, v_p),
                              key=lambda e: e[1])
    for name, (_, rel) in errs.items():
        check(rel <= TE_KERNEL_TOL or name.startswith("K16 lam_t"),
              f"{label} {name}: rel err {rel} > {TE_KERNEL_TOL}")
    log(f"{label}: TE kernels == plain ([abs, rel] err; K13 / K15 on "
        f"{TE_SLICE} trips): " + json.dumps(errs))
    if not timed:
        return
    work = te_work(tp)
    for name, (fn, plain) in te_calls(c, tp, theta, b, tau, tau_u).items():
        c.record_float(name, *errs[name], fn, plain, *work[name])


def te_device_memory(c, tp, theta, label: str) -> None:
    """K14 and K16 at the layouts a graph too large for shared memory
    takes (``te.SMEM_BLOCK`` cut, and for the field alone one block a
    source, ``te._sm_count`` 1): a block's own nodes in shared memory and
    the field in device memory; the field in shared memory and the own
    nodes in device memory; nothing in shared memory. Each within
    TE_KERNEL_TOL of plain, and the same bits as the launch at the
    card's own layout."""
    torch, te = c.torch, c.te
    b = te_buffers(c, tp, theta)
    s, n, n_cls = tp.srcs.numel(), tp.n_cap, tp.deltas.numel()
    n_sm = torch.cuda.get_device_properties(c.dev).multi_processor_count
    errs = {}
    for name, tan in (("K14:te_relax_vjp", False),
                      ("K16:te_relax_vjp_jvp", True)):
        fn = te.te_relax_vjp_jvp if tan else te.te_relax_vjp
        card = te.adjoint_layout(s, n, n_cls, tan, n_sm)
        f = 4 * (2 if tan else 1)
        # (label, SMs, budget, (own_smem, field_smem, gx_smem) wanted)
        cases = (("card", n_sm, te.SMEM_BLOCK, None),
                 ("own", n_sm, (f + (20 if tan else 16)) * card.span,
                  (True, False, False)),
                 ("field", 1, f * n, (False, True, False)),
                 ("none", n_sm, 0, (False, False, False)))
        outs = []
        for case, sms, budget, want in cases:
            bufs = [torch.empty((s, n), device=c.dev)
                    for _ in range(2 if tan else 1)] + [
                torch.empty((s, tp.sh_link.numel()), device=c.dev),
                torch.empty((s, tp.rs_link.numel()), device=c.dev)]
            saved = te.SMEM_BLOCK, te._sm_count
            te.SMEM_BLOCK, te._sm_count = budget, lambda card, k=sms: k
            try:
                lay = te.adjoint_layout(s, n, n_cls, tan, sms)
                check(want is None or (lay.own_smem, lay.field_smem,
                                       lay.gx_smem) == want,
                      f"{label} {name} {case}: layout {lay}")
                if tan:
                    fn(tp, theta, b.v, b.fields, b.tfields, *bufs, 1.0)
                else:
                    fn(tp, theta, b.fields, *bufs, 1.0)
                if want is not None:
                    errs[f"{name} {case} {lay.cluster}x{lay.smem}"], _ = \
                        te_adjoint_err(c, tp, theta, b, tan)
            finally:
                te.SMEM_BLOCK, te._sm_count = saved
            outs.append(torch.cat([t.flatten() for t in bufs]))
            check(torch.equal(outs[0], outs[-1]), f"{label} {name} {case}: "
                  f"the bits differ from the card's layout's")
    for key, err in errs.items():
        check(err[1] <= TE_KERNEL_TOL, f"{label} {key}: rel err {err[1]} > "
              f"{TE_KERNEL_TOL}")
    log(f"{label}: K14 / K16 with own nodes only, the field only and "
        f"nothing in shared memory (name case cluster x bytes) == plain "
        f"([abs, rel] err), the same bits as the card's layout: "
        + json.dumps(errs))


def te_layouts(c, tp) -> dict:
    """K14's and K16's cluster launch at ``tp`` on this card."""
    props = c.torch.cuda.get_device_properties(c.dev)
    return {name: c.te.adjoint_layout(
        tp.srcs.numel(), tp.n_cap, tp.deltas.numel(), tan,
        props.multi_processor_count)._asdict()
        for name, tan in (("K14:te_relax_vjp", False),
                          ("K16:te_relax_vjp_jvp", True))}


def te_full_cell(c, tp, theta, label: str) -> None:
    """The TE kernels at a cell's whole plan (every source): K14 and K16
    held to their plain versions on the card within TE_KERNEL_TOL (the
    cluster layout the step runs), K14 twice with the same bits; every
    kernel timed beside its bound, into its row of the kernels line as
    ``<label>_ms`` / ``<label>_bound_ms``."""
    torch = c.torch
    b = te_buffers(c, tp, theta)
    errs = {}
    for name, tan in (("K14:te_relax_vjp", False),
                      ("K16:te_relax_vjp_jvp", True)):
        errs[name], lam_t = te_adjoint_err(c, tp, theta, b, tan)
        check(errs[name][1] <= TE_KERNEL_TOL, f"{label} {name} (every "
              f"source): rel err {errs[name][1]} > {TE_KERNEL_TOL}")
        if lam_t is not None:
            errs["K16 lam_t (abs, rel)"] = lam_t
    outs = []
    for _ in range(2):
        lam = torch.empty_like(b.lam)
        ct = [torch.empty_like(t) for t in b.ct]
        c.te.te_relax_vjp(tp, theta, b.fields, lam, *ct, 1.0)
        outs.append(torch.cat([lam.flatten(), *(t.flatten() for t in ct)]))
    check(torch.equal(*outs), f"{label} K14: two runs differ")
    work = te_work(tp)
    timed = {}
    for name, (fn, _) in te_calls(c, tp, theta, b).items():
        ms = time_ms(torch, fn, 5)
        b_ms, b_by = bound(*work[name])
        c.results[name].update({f"{label}_ms": ms,
                                f"{label}_bound_ms": b_ms,
                                f"{label}_bound_by": b_by})
        timed[name] = [ms, b_ms]
    log(f"{label}: K14 / K16 over every source == plain ([abs, rel] err), "
        f"K14 deterministic: " + json.dumps(errs))
    log(f"{label}: TE kernels [ms, bound ms] at the whole plan: "
        + json.dumps(timed))


def te_cell(c, label: str, cell, n_src: int, seed: int,
            cpu_sources: int) -> dict:
    """One TE cell — ``cell``, a solved (solver, states, prefix state) —
    through ``WhatIfEngine.optimize`` (defaults: 40 iterations, lr 2.0,
    tau 1.0) with the counts zeroed before it and read after, then
    ``te_step`` on the card against ``te_step_plain`` on CPU copies
    (``cpu_sources`` sources). Returns the cell's launches, plans and
    result."""
    torch, te = c.torch, c.te
    t_cell = time.perf_counter()
    solver, states, ps = cell
    eng = c.whatif.WhatIfEngine(solver)
    demands = te_demands(sorted(states["0"].node_names()), n_src,
                         TE_DEMANDS, seed)
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reads0 = c.zero_counts()
    t0 = time.perf_counter()
    job = eng.plan_optimize(states, ps, demands)
    out = job.run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches, reads = c.read_counts(reads0)
    peak = torch.cuda.max_memory_allocated() - live
    tp, theta0 = job.te_plan()
    theta = torch.from_numpy(theta0).to(c.dev)
    step_ms = time_ms(torch, lambda: te.te_step(tp, theta, 1.0, 1.0), 5)
    split = te_step_split(c, tp, theta, 1.0, 1.0)
    curve = out["loss_curve"]
    log(f"{label} TE: " + json.dumps({
        "nodes": len(job.ad.plan.node_names), "n_cap": tp.n_cap,
        "classes": tp.deltas.numel(), "sources": tp.srcs.numel(),
        "demands": out["demands"], "links": len(job.link_names),
        "res": list(tp.res_nbr.shape) if tp.has_res else [0, 0],
        "live_res_entries": int(tp.inv_ptr[-1]), "trips": out["trips"],
        "iters": out["iters"], "optimize_ms": out["optimize_ms"],
        "wall_ms": wall, "te_step_ms": step_ms, "te_step_split_ms": split,
        "launches": {k: v for k, v in launches.items() if v},
        "flag_reads": reads, "peak_bytes": peak,
        "loss_first": curve[0], "loss_last": curve[-1],
        "loss_curve_head": curve[:5],
        "max_util_before": out["max_util_before"],
        "max_util_after": out["max_util_after"],
        "changes": len(out["changes"])}))
    check(len(curve) == out["iters"] and all(
        x == x and abs(x) < float("inf") for x in curve),
        f"{label}: the loss curve must be finite, one value an iteration")
    steps = out["iters"] + 1
    for name in TE_PATH:
        want = 2 * steps if name == "K14s:te_link_sum" else steps
        check(launches[name] == want, f"{label}: {name} launched "
              f"{launches[name]} times, not {want}")
    check(launches["K1:relax_step"] > 0,
          f"{label}: the baseline sweep never launched K1")
    # the whole step on the card against its plain run on CPU copies
    k = min(cpu_sources, tp.srcs.numel())
    cpu_tp, dev_tp = (te_plan_copy(c, tp, d, k) for d in ("cpu", c.dev))
    t0 = time.perf_counter()
    got = te.te_step(dev_tp, theta, 1.0, 1.0)
    torch.cuda.synchronize()
    t_card = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = te.te_step_plain(cpu_tp, theta.cpu(), 1.0, 1.0)
    t_cpu = time.perf_counter() - t0
    errs = te_check(torch, got, want, ("loss", "grad", "util", "cost"),
                    f"{label} te_step")
    log(f"{label}: te_step on the card == plain on CPU copies "
        f"({cpu_tp.srcs.numel()} sources, {t_card:.1f} ms card / "
        f"{t_cpu:.1f} s CPU), rel err: " + json.dumps(errs))
    return types.SimpleNamespace(launches=launches, tp=tp, theta=theta,
                                 sub=dev_tp, out=out,
                                 seconds=time.perf_counter() - t_cell)


def te_diamond(c) -> None:
    """tests/test_whatif.py:353's diamond on the card: lr 0.05, 30
    iterations; the loss must fall and a metric must move."""
    t = c.topologies
    nodes = {"s": ["a", "b"], "a": ["s", "t"], "b": ["s", "t"],
             "t": ["a", "b"]}
    metric = {("s", "b"): 4, ("b", "s"): 4, ("b", "t"): 4, ("t", "b"): 4}
    adj_dbs, prefix_dbs = t._mk_dbs(
        {n: [t._adj(n, o, metric=metric.get((n, o), 1)) for o in p]
         for n, p in nodes.items()},
        "0", c.PrefixForwardingAlgorithm.SP_ECMP, True)
    states, ps = t.build_states(adj_dbs, prefix_dbs)
    solver = c.gpu_solver.GpuSpfSolver("s", device=c.dev)
    solver.build_route_db("s", states, ps)
    out = c.whatif.WhatIfEngine(solver).optimize(
        states, ps, [{"src": "s", "dst": "t", "volume": 10.0}], iters=30,
        lr=0.05, tau=1.0)
    log("diamond TE: " + json.dumps({k: out[k] for k in (
        "trips", "max_util_before", "max_util_after", "changes")}
        | {"loss_first": out["loss_curve"][0],
           "loss_last": out["loss_curve"][-1]}))
    check(out["loss_curve"][-1] < out["loss_curve"][0] and out["changes"],
          "diamond: the loss must fall and a metric must move")


def te_phase(c, cells: dict) -> dict:
    """Differentiable TE (module docstring, phase 12) on the solvers of
    phase 11 (``cells``). Returns the TE path's launches by kernel (both
    cells)."""
    t_phase = time.perf_counter()
    w = te_cell(c, "whatif1k", cells["whatif1k"], TE_SOURCES[0], TE_SEED,
                TE_SOURCES[0])
    te_kernels(c, w.tp, w.theta, True, "whatif1k")
    te_device_memory(c, w.tp, w.theta, "whatif1k")
    f = te_cell(c, "fabric10k", cells["fabric10k"], TE_SOURCES[1],
                TE_SEED + 1, TE_CPU_SOURCES)
    te_kernels(c, f.sub, f.theta, False, "fabric10k")
    te_device_memory(c, f.sub, f.theta, "fabric10k")
    te_full_cell(c, f.tp, f.theta, "fabric10k")
    log("TE adjoint launches (cluster, span, shared memory): " + json.dumps(
        {"whatif1k": te_layouts(c, w.tp), "fabric10k": te_layouts(c, f.tp)}))
    te_diamond(c)
    log(f"TE phase took {time.perf_counter() - t_phase:.1f} s (whatif1k "
        f"{w.seconds:.1f} s, fabric10k {f.seconds:.1f} s)")
    return {k: w.launches[k] + f.launches[k] for k in w.launches}


# -- phase 13: the all-roots paths -------------------------------------------

# fabric10k all-pairs rows held to a host run_spf (seeded), and the roots
# whose whole loop is held to the plain loop on the card
ALLPAIRS_SPF_ROOTS = 8
ALLPAIRS_PLAIN_ROOTS = 64
# whole-fabric cells: tg1k every vantage, fabric10k the rsws of the first
# FABRIC_POD_VANTAGES pods (4,096, get_fabric_route_dbs' cap)
FABRIC_POD_VANTAGES = 64
# RIB samples: tg1k every TG1K_ORACLE_EVERY-th vantage against the
# oracle; fabric10k the FABRIC_ORACLE vantages against the oracle (LFA,
# ~5 s of host Dijkstras each) and every FABRIC_SINGLE_EVERY-th against
# the single-vantage device solve (which phase 2 holds to the oracle;
# ~0.9 s each with its RIB comparison)
TG1K_ORACLE_EVERY = 64
TG1K_SIDE = 32
FABRIC_ORACLE = ("pod063-rsw63",)
FABRIC_SINGLE_EVERY = 2048
# tg1k-lfa: grid(TG1K_SIDE) with seeded symmetric link metrics in
# 1..LFA_METRIC_MAX and LFA on (fabric10k's unit metrics tie every
# detour with its primary, so its RIBs hold no backup); every
# LFA_ORACLE_EVERY-th vantage against the LFA oracle
LFA_METRIC_MAX = 16
LFA_SEED = 17
LFA_ORACLE_EVERY = 128
# roots of the tg1k and tg1k-lfa steps held to the plain step (fabric10k's
# step and kernels are held over every root)
FABRIC_PLAIN_ROOTS = 64
# roots per call of a plain version run over many roots (rows are
# independent; one gather over every root would not fit)
PLAIN_CHUNK = 256
# the trip bound of the tg1k step held to plain while unconverged
UNCONVERGED_TRIPS = 2
LEGACY_PATH = ("K18:ell_relax", "K19:ell_next_hop", "K20:ell_select")
ALLPAIRS_PATH = ("K18:ell_relax", "K18t:ell_transpose")
FABRIC_PATH = ("K1s:sssp_init", "K21e:fabric_extent", "K21:fabric_relax",
               "K3:select_routes")
# the array-level entry also unpacks the masks on the card
STEP_PATH = FABRIC_PATH + ("K22:unpack_bits",)


def by_roots(torch, n: int, fn):
    """``fn(s)`` over consecutive slices ``s`` of PLAIN_CHUNK of ``n``
    roots; tensor results are joined along the root axis."""
    outs = [fn(slice(i, min(i + PLAIN_CHUNK, n)))
            for i in range(0, n, PLAIN_CHUNK)]
    if outs[0] is None:
        return None
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def plain_ell_sssp(c, mirror, roots):
    """The K18 loop of ``legacy.ell_sssp`` as the reference runs it: the
    plain round over the padded mirror (``legacy.ell_relax_plain``,
    ``UNROLL`` a trip through ``legacy.run_rounds``) on the card's
    tensors -> (dist, trips)."""
    n_cap = mirror[0].shape[0]
    plane = c.torch.empty((roots.shape[0], n_cap), dtype=c.torch.int32,
                          device=c.dev)
    return c.legacy.run_rounds(
        lambda s, d, f, seed: c.legacy.ell_relax_plain(s, d, f, *mirror,
                                                       roots, seed),
        plane, c.relax.max_trips(n_cap))


def padded_rounds(c, mirror, roots, dist, rounds: int):
    """``rounds`` plain rounds over the padded mirror from ``dist``
    [R, n_cap] (not the seed) -> (plane, flag word)."""
    torch = c.torch
    flag = torch.zeros(1, dtype=torch.int32, device=c.dev)
    dist, out = dist.clone(), torch.empty_like(dist)
    for _ in range(rounds):
        c.legacy.ell_relax_plain(dist, out, flag, *mirror, roots)
        dist, out = out, dist
    return dist, flag


def k18_wavefront(c, packed, roots, n_cap: int, rounds: int):
    """K18's plane ``rounds`` rounds past the seed, on R's tiling (one
    trip launch of ``rounds`` rounds)."""
    torch, legacy = c.torch, c.legacy
    shape = legacy.plane_shape(roots.shape[0], n_cap)
    a = torch.empty(shape, dtype=torch.int32, device=c.dev)
    b = torch.empty_like(a)
    flags = torch.empty(2, dtype=torch.int32, device=c.dev)
    return legacy.ell_trip(a, b, flags, packed, roots, 0, rounds)


def k18_trip_check(c, label, mirror, packed, roots, mid, chunk=None):
    """One K18 trip (trip 1, ``UNROLL`` rounds) from the wavefront plane
    ``mid`` on the card against ``legacy.ell_trip_plain`` on copies of
    the same planes (``chunk``: that many roots a plain call; the rows
    are independent) and, on the first ``ALLPAIRS_PLAIN_ROOTS`` roots,
    against ``UNROLL`` rounds of the padded ``ell_relax_plain``.
    Returns (max abs err, the kernel's trip callable, the plain trip's
    callable); a trip from a wavefront must set the flag."""
    torch, legacy = c.torch, c.legacy
    r = roots.shape[0]
    words = legacy.plane_words
    k_a, k_b = mid.clone(), torch.empty_like(mid)
    p_a, p_b = mid.clone(), torch.empty_like(mid)
    k_f = torch.zeros(2, dtype=torch.int32, device=c.dev)
    p_f = torch.zeros_like(k_f)

    # the plain calls' roots: ``chunk`` a call, rounded up to a multiple
    # of 32, the last call taking the pad columns and at least 32 roots
    if chunk is not None:
        chunk = -(-chunk // legacy.WARP) * legacy.WARP
    edges = [0, r] if chunk is None else list(range(0, r, chunk)) + [r]
    if len(edges) > 2 and edges[-1] - edges[-2] < legacy.WARP:
        del edges[-2]

    def plain_trip(a=p_a, b=p_b):
        for lo, hi in zip(edges, edges[1:]):
            cols = slice(lo, hi if hi < r else a.shape[1])
            legacy.ell_trip_plain(a[:, cols], b[:, cols], p_f, packed,
                                  roots[lo:hi], 1)
        return a

    check(legacy.ell_trip(k_a, k_b, k_f, packed, roots, 1) is k_a,
          f"{label}: an even trip ends in its first plane")
    plain_trip()
    check(int(k_f[1]) == 1 and int(k_f[0]) == 0,
          f"{label}: a trip from a wavefront must set its flag word")
    err = max_abs_err(torch, (words(k_a, r), k_f), (words(p_a, r), p_f))
    sub = min(r, ALLPAIRS_PLAIN_ROOTS)
    want, _ = padded_rounds(c, mirror, roots[:sub],
                            words(mid, r)[:, :sub].t().contiguous(),
                            c.relax.UNROLL)
    check(max_abs_err(torch, words(k_a, r)[:, :sub].t(), want) == 0,
          f"{label}: a trip != {c.relax.UNROLL} padded plain rounds")
    t_a, t_b = mid.clone(), torch.empty_like(mid)
    t_f = torch.zeros_like(k_f)
    q_a, q_b = mid.clone(), torch.empty_like(mid)
    return (err, lambda: legacy.ell_trip(t_a, t_b, t_f, packed, roots, 1),
            lambda: plain_trip(q_a, q_b))


def k18_live(packed) -> int:
    """The live slots of a packed K18 mirror."""
    return packed.slots.shape[0]


def k18_round_bytes(packed, r: int) -> int:
    """The bytes a K18 round must move for ``r`` roots: the packed
    mirror read once (8 B a live slot and ``row_ptr``), each root's row
    read and written once."""
    n_cap = packed.row_ptr.shape[0] - 1
    return 8 * k18_live(packed) + 4 * (n_cap + 1) + 8 * r * n_cap


def k18_edge_mirror(np, r: int, seed: int):
    """A seeded padded mirror (numpy, n_cap 45: not a multiple of 32) of
    40 nodes in two components with no link between them, a share of
    links down, 6 overloaded nodes, and ``r`` roots, the first of them
    overloaded -> (in_nbr, in_w, in_up, node_over, roots)."""
    n, n_cap, k_cap = 40, 45, 6
    rng = np.random.default_rng(seed)
    in_nbr = np.full((n_cap, k_cap), -1, np.int32)
    in_w = np.full((n_cap, k_cap), 1 << 30, np.int32)
    in_up = np.zeros((n_cap, k_cap), bool)
    for v in range(n):
        lo, hi = (0, 30) if v < 30 else (30, n)
        deg = int(rng.integers(1, k_cap + 1))
        slots = np.sort(rng.choice(k_cap, deg, replace=False))
        in_nbr[v, slots] = rng.choice([u for u in range(lo, hi) if u != v],
                                      deg)
        in_w[v, slots] = rng.integers(1, 1 << 28, deg)
        in_up[v, slots] = rng.random(deg) >= 0.2
    node_over = np.zeros(n_cap, bool)
    over = rng.choice(n, 6, replace=False)
    node_over[over] = True
    roots = rng.choice(n, r).astype(np.int32)
    roots[0] = over[0]
    return in_nbr, in_w, in_up, node_over, roots


def k18_edge_cases(c) -> dict:
    """K18 on seeded edge cases (``k18_edge_mirror``: R = 1, 31, 33 on
    both tilings, an overloaded root, down links, an unreachable
    component): ``ell_sssp`` on the card equals the padded plain loop,
    trips included, and a trip from a wavefront equals its plain
    version. -> the largest error."""
    import numpy as np

    torch, legacy = c.torch, c.legacy
    worst = 0
    for r in (1, 31, 33):
        arrays = k18_edge_mirror(np, r, 18 + r)
        mirror = legacy.to_device(c.dev, *arrays[:4])
        (roots,) = legacy.to_device(c.dev, arrays[4])
        d_k, tr_k = legacy.ell_sssp(*mirror, roots)
        d_p, tr_p = plain_ell_sssp(c, mirror, roots)
        check(max_abs_err(torch, d_k, d_p) == 0 and tr_k == tr_p,
              f"K18 edge case R={r}: ell_sssp != the plain loop")
        check(bool((d_k == legacy.INF).any()),
              f"K18 edge case R={r}: the second component must be "
              "unreachable")
        packed = legacy.packed_mirror(*mirror)
        mid = k18_wavefront(c, packed, roots, arrays[0].shape[0], 2)
        err, _, _ = k18_trip_check(c, f"K18 edge case R={r}", mirror,
                                   packed, roots, mid)
        check(err == 0, f"K18 edge case R={r}: a trip != plain ({err})")
        worst = max(worst, err)
    log("K18 edge cases (R = 1, 31, 33; an overloaded root, links down, "
        "an unreachable component, metrics < 2^28, n_cap 45): == plain")
    return worst


def plain_ell_next_hops(c, dist, mirror, root, rtab):
    """The K19 loop of ``legacy.ell_next_hops`` through the plain
    version on the card's tensors -> (nh, trips)."""
    n_cap = mirror[0].shape[0]
    plane = c.torch.empty((n_cap, rtab[0].shape[0]), dtype=c.torch.bool,
                          device=c.dev)
    return c.legacy.run_rounds(
        lambda s, d, f, seed: c.legacy.ell_next_hop_plain(
            s, d, f, dist, *mirror, root, *rtab, seed),
        plane, c.relax.max_trips(n_cap))


def seeded_metrics(adj_dbs, seed: int, top: int) -> list:
    """``adj_dbs`` with each link's metric drawn from 1..``top`` (seeded,
    the same both ways)."""
    rng = random.Random(seed)
    cost: dict = {}
    out = []
    for db in adj_dbs:
        adjs = []
        for a in db.adjacencies:
            key = tuple(sorted((db.this_node_name, a.other_node_name)))
            adjs.append(dataclasses.replace(
                a, metric=cost.setdefault(key, rng.randint(1, top))))
        out.append(dataclasses.replace(db, adjacencies=tuple(adjs)))
    return out


def legacy_phase(c, lsdb, fcell) -> tuple:
    """The legacy pipeline at lsdb100k and the fabric10k all-pairs SSSP
    (module docstring, phase 13a). ``lsdb`` is lsdb100k's (solver synced
    to the states, states, prefix state) as phase 8 left them, ``fcell``
    fabric10k's (states, prefix state). Returns the legacy and all-pairs
    launches by kernel."""
    import numpy as np

    torch, dev, legacy, gpu_solver = c.torch, c.dev, c.legacy, c.gpu_solver
    solver, states, ps = lsdb
    ls = states["0"]
    t0 = time.perf_counter()
    graph = c.csr.build_ell(ls)
    matrix = c.csr.build_prefix_matrix(ps, graph.node_index, "0")
    root = graph.node_index[LSDB100K_ROOT]
    r_nbr, r_w, r_up, _ = graph.out_table(root)
    mirror = legacy.ell_tensors(graph, dev)
    planes = legacy.to_device(dev, matrix.ann_node, matrix.ann_valid,
                              matrix.path_pref, matrix.source_pref,
                              matrix.dist_adv)
    rtab = legacy.to_device(dev, r_nbr, r_w, r_up)
    host_ms = (time.perf_counter() - t0) * 1e3
    reads0 = c.zero_counts()
    t0 = time.perf_counter()
    dist, metric, _, _, has_route = gpu_solver.legacy_pipeline(
        *mirror, root, *rtab, *planes)
    torch.cuda.synchronize()
    legacy_ms = (time.perf_counter() - t0) * 1e3
    launches, reads = c.read_counts(reads0)
    for name in LEGACY_PATH:
        check(launches[name] > 0,
              f"kernel {name} never launched on the legacy path")
    # every prefix: the oracle's metric, a route iff the oracle has one
    # (the root's own loopback: metric 0, not in the oracle's RIB); the
    # churn phases moved metrics since phase 4, so the oracle runs anew
    t0 = time.perf_counter()
    oracle = c.SpfSolver(LSDB100K_ROOT).build_route_db(LSDB100K_ROOT, states,
                                                       ps)
    oracle_ms = (time.perf_counter() - t0) * 1e3
    met, hr = metric.cpu().numpy(), has_route.cpu().numpy()
    routes = oracle.unicast_routes
    own = 0
    for p, pfx in enumerate(matrix.prefix_list):
        r = routes.get(pfx)
        if r is None:
            own += 1
            check(hr[p] and met[p] == 0, f"legacy: {pfx} has no route")
        else:
            check(hr[p] and int(met[p]) == r.igp_cost,
                  f"legacy: {pfx} metric {met[p]} != {r.igp_cost}")
    check(own == 1, f"legacy: {own} prefixes without an oracle route")
    # the distances of the main path's fast path (its shift mirror)
    ad = solver._area_dev["0"]
    plan = ad.plan
    base, _ = c.ksp2.base_sssp(ad.deltas, ad.shift_w, ad.res_rows,
                               ad.res_nbr, ad.res_w,
                               plan.node_index[LSDB100K_ROOT],
                               plan.k_res > 0)
    perm = np.array([plan.node_index[nm] for nm in graph.node_names])
    want = base.cpu().numpy()[perm]
    want = np.where(want >= 1 << 29, legacy.INF, want)
    check(np.array_equal(dist.cpu().numpy()[:graph.n_nodes], want),
          "legacy: distances != the main path's")
    log("legacy lsdb100k: metrics / routes == oracle, distances == the "
        "main path's: " + json.dumps({
            "nodes": graph.n_nodes, "n_cap": graph.n_cap,
            "k_cap": graph.k_cap, "prefixes": len(matrix.prefix_list),
            "legacy_ms": legacy_ms, "host_mirror_ms": host_ms,
            "oracle_ms": oracle_ms,
            "launches": {k: launches[k] for k in LEGACY_PATH},
            "flag_reads": reads}))

    # each kernel against its plain version on the card; K18's loop
    # alone, its launches and flag reads counted
    roots1 = torch.tensor([root], dtype=torch.int32, device=dev)
    reads0 = c.zero_counts()
    d_k, tr_k = legacy.ell_sssp(*mirror, roots1)
    k18_launches, k18_reads = c.read_counts(reads0)
    check(k18_launches["K18:ell_relax"] == tr_k == k18_reads,
          "K18: one launch and one flag read a trip")
    d_p, tr_p = plain_ell_sssp(c, mirror, roots1)
    check(max_abs_err(torch, d_k, d_p) == 0 and tr_k == tr_p,
          "K18 loop != plain")
    nh_k, nt_k = legacy.ell_next_hops(d_k[0], *mirror, root, *rtab)
    nh_p, nt_p = plain_ell_next_hops(c, d_k[0], mirror, root, rtab)
    check(max_abs_err(torch, nh_k, nh_p) == 0 and nt_k == nt_p,
          "K19 loop != plain")
    log("legacy lsdb100k K18 alone: " + json.dumps({
        "trips": tr_k, "launches": k18_launches["K18:ell_relax"],
        "flag_reads": k18_reads, "k19_trips": nt_k}))
    n_cap, k_cap = graph.in_nbr.shape
    live = int((graph.in_nbr >= 0).sum())
    ell_bytes = 9 * n_cap * k_cap + n_cap

    def mid_plane(step, plane, rounds):
        """``rounds`` rounds of ``step(src, dst, flag, seed)`` from the
        seed: a wavefront plane."""
        spare = torch.empty_like(plane)
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        for i in range(rounds):
            step(plane, spare, flag, i == 0)
            plane, spare = spare, plane
        return plane

    # K18 (single-root tiling): a trip from 40 rounds past the seed
    packed = legacy.packed_mirror(*mirror)
    mid = k18_wavefront(c, packed, roots1, n_cap, 40)
    err, trip_k, trip_p = k18_trip_check(c, "K18", mirror, packed, roots1,
                                         mid)
    c.record("K18:ell_relax", max(err, k18_edge_cases(c)), trip_k, trip_p,
             nbytes=k18_round_bytes(packed, 1), ops=4 * k18_live(packed),
             per=c.relax.UNROLL)
    c.split("K18:ell_relax", trip_k)
    d_cap = r_nbr.shape[0]
    nmid = mid_plane(lambda s, d, f, seed: legacy.ell_next_hop(
        s, d, f, d_k[0], *mirror, root, *rtab, seed),
        torch.empty_like(nh_k), 40)
    h_k, h_p = torch.empty_like(nmid), torch.empty_like(nmid)
    f_k = torch.zeros(1, dtype=torch.int32, device=dev)
    f_p = torch.zeros_like(f_k)
    legacy.ell_next_hop(nmid, h_k, f_k, d_k[0], *mirror, root, *rtab)
    legacy.ell_next_hop_plain(nmid, h_p, f_p, d_k[0], *mirror, root, *rtab)
    check(int(f_k) == 1, "K19 on a wavefront must change the plane")
    c.record(
        "K19:ell_next_hop", max_abs_err(torch, (h_k, f_k), (h_p, f_p)),
        lambda: legacy.ell_next_hop(nmid, h_k, f_k, d_k[0], *mirror, root,
                                    *rtab),
        lambda: legacy.ell_next_hop_plain(nmid, h_p, f_p, d_k[0], *mirror,
                                          root, *rtab),
        nbytes=ell_bytes + 4 * n_cap + 2 * n_cap * d_cap,
        ops=5 * live * d_cap)
    p_cap, a_cap = matrix.ann_node.shape
    sel = (d_k[0], nh_k, mirror[3], *planes)
    c.record(
        "K20:ell_select", max_abs_err(torch, legacy.ell_select(*sel),
                                      legacy.ell_select_plain(*sel)),
        lambda: legacy.ell_select(*sel), lambda: legacy.ell_select_plain(*sel),
        nbytes=p_cap * a_cap * (17 + 4 + d_cap)
        + p_cap * (4 + a_cap + d_cap + 1), ops=12 * p_cap * a_cap * d_cap)

    # -- fabric10k all-pairs -----------------------------------------------
    fls = fcell[0]["0"]
    fgraph = c.csr.build_ell(fls)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    reads0 = c.zero_counts()
    t0 = time.perf_counter()
    ap = gpu_solver.sssp_all_pairs(fgraph, device=dev)
    torch.cuda.synchronize()
    allpairs_ms = (time.perf_counter() - t0) * 1e3
    ap_launches, ap_reads = c.read_counts(reads0)
    for name in ALLPAIRS_PATH:
        check(ap_launches[name] > 0,
              f"kernel {name} never launched on the all-pairs path")
    check(ap_launches["K18:ell_relax"] == ap_reads,
          "all-pairs: one K18 launch and one flag read a trip")
    peak = torch.cuda.max_memory_allocated() - mem0
    n_roots = fgraph.n_nodes
    check(tuple(ap.shape) == (n_roots, fgraph.n_cap), "all-pairs shape")
    fmirror = legacy.ell_tensors(fgraph, dev)
    sub = torch.arange(ALLPAIRS_PLAIN_ROOTS, dtype=torch.int32, device=dev)
    d_p, _ = plain_ell_sssp(c, fmirror, sub)
    check(max_abs_err(torch, ap[:ALLPAIRS_PLAIN_ROOTS], d_p) == 0,
          "all-pairs: K18 != plain on the first roots")
    rng = random.Random(13)
    sample = rng.sample(range(n_roots), ALLPAIRS_SPF_ROOTS)
    t0 = time.perf_counter()
    rows = ap[sample].cpu().numpy()
    for i, r in enumerate(sample):
        spf = fls.run_spf(fgraph.node_names[r])
        want = [spf[nm].metric if nm in spf else legacy.INF
                for nm in fgraph.node_names]
        check(rows[i, :n_roots].tolist() == want,
              f"all-pairs: row of {fgraph.node_names[r]} != run_spf")
    spf_ms = (time.perf_counter() - t0) * 1e3
    log("all-pairs fabric10k: the first roots == plain, sampled rows == "
        "run_spf: " + json.dumps({
            "roots": n_roots, "n_cap": fgraph.n_cap, "k_cap": fgraph.k_cap,
            "live_slots": int(((fgraph.in_nbr >= 0) & fgraph.in_up).sum()),
            "allpairs_ms": allpairs_ms,
            "roots_per_s": n_roots / (allpairs_ms / 1e3),
            "trips": ap_reads, "flag_reads": ap_reads,
            "launches": ap_launches["K18:ell_relax"],
            "transposes": ap_launches["K18t:ell_transpose"],
            "dist_bytes": ap.numel() * 4, "peak_bytes": peak,
            "run_spf_rows": ALLPAIRS_SPF_ROOTS, "run_spf_ms": spf_ms}))
    del ap, d_p
    # K18 (batched tiling) over every root, a trip from 2 rounds past the
    # seed; the transpose of its result
    aroots = torch.arange(n_roots, dtype=torch.int32, device=dev)
    fpacked = legacy.packed_mirror(*fmirror)
    amid = k18_wavefront(c, fpacked, aroots, fgraph.n_cap, 2)
    err, trip_k, trip_p = k18_trip_check(c, "K18 [allpairs]", fmirror,
                                         fpacked, aroots, amid, PLAIN_CHUNK)
    c.record(
        "K18:ell_relax[allpairs]", err, trip_k, trip_p,
        nbytes=k18_round_bytes(fpacked, n_roots),
        ops=4 * k18_live(fpacked) * n_roots, reps=10, plain_reps=1,
        plain_warmup=1, per=c.relax.UNROLL)
    c.variant_launches["K18:ell_relax[allpairs]"] = ap_launches[
        "K18:ell_relax"]
    scratch = torch.empty_like(amid)
    got = legacy.ell_transpose(amid, scratch, n_roots)
    want = legacy.ell_transpose_plain(amid, torch.empty_like(amid), n_roots)
    c.record(
        "K18t:ell_transpose", max_abs_err(torch, got, want),
        lambda: legacy.ell_transpose(amid, scratch, n_roots),
        lambda: legacy.ell_transpose_plain(amid, scratch, n_roots),
        nbytes=8 * n_roots * fgraph.n_cap, ops=0, reps=20,
        library=lambda: got.copy_(amid[:, :n_roots].t()))
    return launches, ap_launches


def fabric_step_args(c, solver, names, ls, lfa):
    """The whole-fabric step's tensor arguments for ``names`` on the
    solver's resident mirror (after a fabric build synced it)."""
    torch, dev = c.torch, c.dev
    ad = solver._area_dev["0"]
    roots, out_nbr, out_w, _ = c.fabric.root_tables(ad.plan, ls, names)
    p_cap, a_cap = ad.matrix.ann_node.shape
    args = (ad.deltas, ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w,
            ad.mbuf, *(torch.tensor(a, device=dev)
                       for a in (roots, out_nbr, out_w)))
    kw = dict(has_res=ad.plan.k_res > 0, p_cap=p_cap, a_cap=a_cap, lfa=lfa,
              block_v4=block_v4(solver))
    return args, kw


def block_v4(solver) -> bool:
    return not (solver.cpu.enable_v4 or solver.cpu.v4_over_v6_nexthop)


def fabric_build(c, solver, states, ps, names, mesh=None) -> tuple:
    """One build_fabric_route_dbs (on ``mesh``; None: the solver's
    default), timed, the counts zeroed just before it and read just
    after: -> (RIBs, stats with the host wall, the peak device bytes
    above what was resident and the launches, launches by kernel)."""
    torch = c.torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    # the host wall of Python's full (generation 2) collections inside
    # the build: they walk every object alive, RIBs of earlier builds too
    gc2 = []

    def on_gc(phase, info):
        if info["generation"] == 2:
            gc2.append(time.perf_counter() * (1 if phase == "stop" else -1))

    reads0 = c.zero_counts()
    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    try:
        dbs = solver.build_fabric_route_dbs(names, states, ps, mesh=mesh)
        torch.cuda.synchronize()
    finally:
        gc.callbacks.remove(on_gc)
    build_ms = (time.perf_counter() - t0) * 1e3
    launches, reads = c.read_counts(reads0)
    st = dict(solver.last_fabric_stats)
    st["build_ms"] = build_ms
    st["gc2_passes"] = len(gc2) // 2
    st["gc2_ms"] = sum(gc2) * 1e3
    st["peak_bytes"] = torch.cuda.max_memory_allocated() - mem0
    st["launches"] = {k: v for k, v in launches.items() if v}
    st["flag_reads"] = reads
    return dbs, st, launches


def fabric_vs_plain(c, label, solver, ls, names, lfa, n_plain,
                    n_trips=None) -> tuple:
    """The step over every vantage on the card against the plain step on
    the first ``n_plain`` (per-root results are independent; the plain
    step runs PLAIN_CHUNK roots a call), at the solver's last trip bound
    or ``n_trips``. Returns the kernel step's outputs and its (args,
    kw)."""
    torch, fabric = c.torch, c.fabric
    args, kw = fabric_step_args(c, solver, names, ls, lfa)
    n_trips = n_trips or solver.last_fabric_stats["n_trips"]
    t0 = time.perf_counter()
    got = fabric.fabric_step(*args, n_trips=n_trips, **kw)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3

    def plain(s):
        want = fabric.fabric_step_plain(*args[:6], *(a[s] for a in args[6:]),
                                        n_trips=n_trips, **kw)
        return (*want[:7], torch.from_numpy(want.converged))

    t0 = time.perf_counter()
    want = by_roots(torch, n_plain, plain)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_abs_err(torch, tuple(t[:n_plain] for t in got[:7]), want[:7])
    check(err == 0
          and got.converged[:n_plain].tolist() == want[7].tolist(),
          f"{label}: the whole-fabric step != plain on {n_plain} roots")
    log(f"{label}: the step over {len(names)} roots on the card == the "
        f"plain step on the first {n_plain} (host wall {step_ms:.1f} ms, "
        f"plain {plain_ms:.1f} ms, "
        f"{int((got.lfa_slot >= 0).sum())} rows with an LFA backup)")
    return got, args, kw


def k21_floor(cuda, dist, out, flag, deltas, sw, live, roots, residual,
              col0: int = 0):
    """-> a bare ``cuda.launch`` of K21's entry point for the ungated call
    ``fabric_relax_mc(dist, out, flag, deltas, sw, residual, roots,
    col0=col0, live=live)`` (raw addresses, no checks): the host floor of
    a K21 call."""
    _, nbr, rw, ext, row_of = residual or (None,) * 5
    ptrs = [0 if t is None else t.data_ptr()
            for t in (dist, out, deltas, sw, live, roots, nbr, rw, ext,
                      row_of, flag)]
    g, d_cap, n_cap = dist.shape
    kr_cap = nbr.shape[1] if residual else 0
    return lambda: cuda.launch(
        "fabric", "fabric_relax", "p" * 10 + "i" * 6 + "pi" + "ppiiiiii",
        *ptrs[:10], d_cap, n_cap, sw.shape[0], col0, sw.shape[1], kr_cap,
        ptrs[10], g, *(0,) * 8)


# K21's seeded edge cases: (label, n_cap, d_cap, roots, s_cap, r_cap,
# kr_cap, col0, w_cols (0: the whole width), rows full to kr_cap, gated)
K21_CASES = (
    ("D 5, root slabs with tails", 1000, 5, 70, 4, 600, 40, 0, 0, False,
     False),
    ("[mc] window, roots in and out of it", 1000, 4, 45, 3, 500, 24, 500,
     500, False, False),
    ("rows past the shared copy", 256, 3, 9, 2, 256, 512, 0, 0, True, False),
    ("D 12, two row chunks", 300, 12, 10, 3, 200, 9, 0, 0, False, False),
    ("D 1, no residual", 500, 1, 33, 4, 0, 0, 0, 0, False, False),
    ("D 2, gated roots", 400, 2, 66, 3, 300, 16, 0, 0, False, True),
)


def k21_inputs(torch, dev, seed: int, n_cap: int, d_cap: int, g: int,
               s_cap: int, r_cap: int, kr_cap: int, col0: int, w_cols: int,
               full: bool) -> tuple:
    """Seeded K21 inputs: planes with INF_E words, class rows with INF_E
    weights and one void class, signed shifts; residual rows unique per
    node among pad rows (-1, INF_E weights, as a plan pads), entries
    whose source is a root, pads (-1) and INF_E entries inside a row's
    live extent; half the roots inside the column window. -> (dist,
    deltas, sw, roots, (rows, nbr, w) or None), on ``dev``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w_cols = w_cols or n_cap
    inf = 1 << 29
    dist = rng.integers(0, 60, (g, d_cap, n_cap)).astype(np.int32)
    dist[rng.random(dist.shape) < 0.3] = inf
    deltas = rng.integers(-n_cap + 1, n_cap, s_cap).astype(np.int32)
    sw = rng.integers(1, 9, (s_cap, w_cols)).astype(np.int32)
    sw[rng.random(sw.shape) < 0.4] = inf
    sw[s_cap - 1] = inf
    roots = np.where(np.arange(g) % 2 == 0,
                     rng.integers(col0, col0 + w_cols, g),
                     rng.integers(0, n_cap, g)).astype(np.int32)
    res = None
    if r_cap:
        rows = np.full(r_cap, -1, np.int32)
        n_rows = min(r_cap, n_cap) * 2 // 3
        at = rng.choice(r_cap, n_rows, replace=False)
        rows[at] = rng.choice(n_cap, n_rows, replace=False)
        nbr = rng.integers(-1, n_cap, (r_cap, kr_cap)).astype(np.int32)
        nbr[rng.random(nbr.shape) < 0.05] = roots[0]
        w = rng.integers(0, 20, (r_cap, kr_cap)).astype(np.int32)
        ends = (np.full(r_cap, kr_cap) if full
                else rng.integers(0, kr_cap + 1, r_cap))
        w[np.arange(kr_cap)[None, :] >= ends[:, None]] = inf
        w[rng.random(w.shape) < 0.1] = inf
        w[(nbr < 0) | (rows < 0)[:, None]] = inf
        res = tuple(torch.tensor(a, device=dev) for a in (rows, nbr, w))
    return (*(torch.tensor(a, device=dev) for a in (dist, deltas, sw,
                                                     roots)), res)


def k21_cases(c) -> int:
    """K21 on K21_CASES against its plain version (tolerance 0): the
    planes, the flag and, gated, the roots' stamps and counters; each
    call one launch. -> the largest error."""
    torch, fabric = c.torch, c.fabric
    errs = []
    for i, (label, n_cap, d_cap, g, s_cap, r_cap, kr_cap, col0, w_cols,
            full, gated) in enumerate(K21_CASES):
        dist, deltas, sw, roots, res = k21_inputs(
            torch, c.dev, 300 + i, n_cap, d_cap, g, s_cap, r_cap, kr_cap,
            col0, w_cols, full)
        ext, live = fabric.fabric_extent(None if res is None else res[2], sw)
        check(int(live.sum()) < s_cap, f"K21 case {label}: a void class ran")
        residual = None if res is None else (
            *res, ext, fabric.row_table(res[0], n_cap))
        lanes = [c.relax.Lanes(g, c.dev) for _ in range(2)]
        gates = [None, None]
        if gated:
            for ln in lanes:
                ln.st[::3, 0] = -5
            gates = [ln.gate((-2, c.relax.ALWAYS), (7, c.relax.KEEP), (1, 1))
                     for ln in lanes]
        outs = [torch.full_like(dist, -7) for _ in range(2)]
        flags = [torch.zeros(1, dtype=torch.int32, device=c.dev)
                 for _ in range(2)]
        if w_cols:
            one_launch(torch, c.wrappers, f"K21 case {label}",
                       lambda: fabric.fabric_relax_mc(
                           dist, outs[0], flags[0], deltas, sw, residual,
                           roots, gates[0], col0, live=live))
        else:
            one_launch(torch, c.wrappers, f"K21 case {label}",
                       lambda: fabric.fabric_relax(
                           dist, outs[0], flags[0], deltas, sw, residual,
                           roots, gates[0], live=live))
        fabric.fabric_relax_mc_plain(dist, outs[1], flags[1], deltas, sw,
                                     residual, roots, gates[1], col0)
        err = max_abs_err(torch, (outs[0], flags[0], lanes[0].st,
                                  lanes[0].cnt),
                          (outs[1], flags[1], lanes[1].st, lanes[1].cnt))
        check(err == 0, f"K21 case {label}: kernel != plain ({err})")
        check(int(flags[0]) == 1, f"K21 case {label}: nothing changed")
        errs.append(err)
    log(f"K21: {len(K21_CASES)} seeded edge cases equal to plain, one "
        f"launch each")
    return max(errs)


def fabric_kernels(c, args, kw, n_trips: int) -> None:
    """The fabric path's kernels against their plain versions on every
    root of the fabric10k step (the plain versions PLAIN_CHUNK roots a
    call), timed at that shape."""
    torch, dev, fabric, relax, select = (c.torch, c.dev, c.fabric, c.relax,
                                        c.select)
    deltas, shift_w, res_rows, res_nbr, res_w, mbuf, roots, nbr, w = args
    rt, d_cap = nbr.shape
    s_cap, n_cap = shift_w.shape
    p_cap, a_cap, lfa = kw["p_cap"], kw["a_cap"], kw["lfa"]
    check(lfa, "the fabric10k step runs with LFA")
    check(kw["has_res"], "the fabric10k step has a residual")
    ext, live = fabric.fabric_extent(res_w, shift_w)
    c.record(
        "K21e:fabric_extent",
        max_abs_err(torch, (ext, live),
                    fabric.fabric_extent_plain(res_w, shift_w)),
        lambda: fabric.fabric_extent(res_w, shift_w),
        lambda: fabric.fabric_extent_plain(res_w, shift_w),
        nbytes=4 * (res_w.numel() + res_w.shape[0] + shift_w.numel()
                    + s_cap),
        ops=2 * (res_w.numel() + shift_w.numel()))
    n_live = int(live.sum())
    residual = (res_rows, res_nbr, res_w, ext,
                fabric.row_table(res_rows, n_cap))

    def none(*shape):
        return torch.empty((rt,) + shape, dtype=torch.int32, device=dev)

    iargs = (none(0, n_cap), none(0), none(0, 0), none(0, 0), roots, nbr, w)

    def init_plain():
        return by_roots(torch, rt, lambda s: relax.sssp_init_plain(
            *(a[s] for a in iargs))[2])

    d0 = relax.sssp_init(*iargs)[2]
    c.record(
        "K1s:sssp_init[fabric]", max_abs_err(torch, d0, init_plain()),
        lambda: relax.sssp_init(*iargs), init_plain,
        nbytes=4 * (rt * d_cap * n_cap + 2 * rt * d_cap),
        ops=rt * d_cap * n_cap, reps=10, plain_reps=1, plain_warmup=0)
    # a wavefront plane: 2 relaxations from the seeds (rsws of other
    # pods are 3 hops from an uplink's seed)
    mid, spare = d0, torch.empty_like(d0)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    for _ in range(2):
        fabric.fabric_relax(mid, spare, flag, deltas, shift_w, residual,
                            roots, live=live)
        mid, spare = spare, mid
    del spare
    o_k, o_p = torch.empty_like(mid), torch.empty_like(mid)
    f_k = torch.zeros(1, dtype=torch.int32, device=dev)
    f_p = torch.zeros_like(f_k)

    def relax_plain():
        by_roots(torch, rt, lambda s: fabric.fabric_relax_plain(
            mid[s], o_p[s], f_p, deltas, shift_w, residual, roots[s]))

    def k21():
        fabric.fabric_relax(mid, o_k, f_k, deltas, shift_w, residual, roots,
                            live=live)

    one_launch(torch, c.wrappers, "K21 over fabric10k's roots", k21)
    relax_plain()
    check(int(f_k) == 1, "K21 on a wavefront must change the planes")
    # the work this data needs: the live shift classes (fabric10k: none),
    # the residual's live entries, each read once, and the node -> row
    # table
    n_ent = int((res_w < relax.INF_E).sum())
    c.record(
        "K21:fabric_relax", max(max_abs_err(torch, (o_k, f_k), (o_p, f_p)),
                                k21_cases(c)),
        k21, relax_plain,
        nbytes=4 * (2 * mid.numel() + s_cap * n_cap + s_cap
                    + 2 * res_rows.numel() + n_cap + 2 * n_ent),
        ops=2 * mid.numel() * n_live + 2 * rt * d_cap * n_ent,
        reps=10, plain_reps=1, plain_warmup=0)
    c.split("K21:fabric_relax", k21,
            floor=k21_floor(c.cuda, mid, o_k, f_k, deltas, shift_w, live,
                            roots, residual))
    c.results["K21:fabric_relax"]["live_classes"] = n_live
    del mid, o_k, o_p
    # K3 on the step's converged planes, with the uplink costs as they
    # are and skewed 1, 2, 3, ... (as phase 3: on the unit-metric fabric
    # every detour ties its primary, so only the skew leaves backups)
    planes, conv, _ = fabric.fabric_sssp(
        deltas, shift_w, residual[:3], roots, nbr, w, n_trips)
    check(conv.all(), "fabric10k: the step's SSSP did not converge")
    dist_k = torch.empty((rt, n_cap), dtype=torch.int32, device=dev)
    dist_p = torch.empty_like(dist_k)

    def sel_plain(ww):
        return by_roots(torch, rt, lambda s: select.select_routes_plain(
            planes[s], ww[s], roots[s], mbuf, p_cap, a_cap, kw["block_v4"],
            lfa, dist_out=dist_p[s]))

    def sel(ww):
        return select.select_routes(planes, ww, roots, mbuf, p_cap, a_cap,
                                    kw["block_v4"], lfa, dist_out=dist_k)

    skew = torch.where(w < relax.INF_E,
                       w + torch.arange(d_cap, dtype=torch.int32,
                                        device=dev), w)
    errs, backups = [], []
    for ww in (skew, w):
        got = sel(ww)
        want = sel_plain(ww)
        errs.append(max_abs_err(torch, got + (dist_k,), want + (dist_p,)))
        backups.append(int((got[4] >= 0).sum()))
        one_launch(torch, c.wrappers, "K3[fabric]", lambda: sel(ww))
    check(backups[0] > 0, "fabric10k step: no row has an LFA backup with "
          "skewed uplink costs")
    log(f"fabric10k step: K3 over {rt} roots with LFA equal to plain "
        f"({backups[1]} rows with a backup, {backups[0]} with skewed "
        f"uplink costs)")
    wa, wd = got[1].shape[-1], got[2].shape[-1]
    c.record(
        "K3:select_routes[fabric]", max(errs),
        lambda: sel(w), lambda: sel_plain(w),
        nbytes=4 * (planes.numel() + rt * d_cap + 6 * p_cap * a_cap
                    + rt * (n_cap + p_cap * (3 + wa + wd))) + rt * p_cap,
        ops=rt * (3 * d_cap * n_cap + 15 * p_cap * a_cap * d_cap),
        reps=10, plain_reps=1, plain_warmup=0)
    nhw = got[2]
    c.record(
        "K22:unpack_bits",
        max_abs_err(torch, fabric.unpack_bits(nhw, d_cap),
                    fabric.unpack_bits_plain(nhw, d_cap)),
        lambda: fabric.unpack_bits(nhw, d_cap),
        lambda: fabric.unpack_bits_plain(nhw, d_cap),
        nbytes=4 * nhw.numel() + rt * p_cap * d_cap,
        ops=2 * rt * p_cap * d_cap, reps=20, plain_reps=2)


def fabric_phase(c, fcell) -> tuple:
    """The whole-fabric cells (module docstring, phase 13b); ``fcell``
    is fabric10k's (states, prefix state). Returns the launches by
    kernel of fabric10k's cold build and of the array-level step."""
    torch, dev, gpu_solver = c.torch, c.dev, c.gpu_solver
    t0 = time.perf_counter()
    _, tstates, tps = build_cell(
        c.topologies, lambda: c.topologies.grid(TG1K_SIDE, node_labels=False))

    def lfa_grid():
        adj_dbs, pdbs = c.topologies.grid(TG1K_SIDE, node_labels=False)
        return seeded_metrics(adj_dbs, LFA_SEED, LFA_METRIC_MAX), pdbs

    _, lstates, lps = build_cell(c.topologies, lfa_grid)
    fstates, fps = fcell
    tnames = sorted(tstates["0"].get_adjacency_databases())
    fnames = [f"pod{p:03d}-rsw{i:02d}" for p in range(FABRIC_POD_VANTAGES)
              for i in range(FABRIC["rsws_per_pod"])]
    check(all(fstates["0"].has_node(nm) for nm in fnames),
          "fabric10k: a vantage is not in the LSDB")
    # the warm solvers' single-vantage solves measure their trips first
    t_mid = f"node-{TG1K_SIDE // 2}-{TG1K_SIDE // 2}"
    t_warm = gpu_solver.GpuSpfSolver(t_mid, device=dev)
    t_warm.build_route_db(t_mid, tstates, tps)
    f_warm = gpu_solver.GpuSpfSolver("pod000-rsw00", device=dev,
                                     enable_lfa=True)
    f_warm.build_route_db("pod000-rsw00", fstates, fps)
    t_cold = gpu_solver.GpuSpfSolver(tnames[0], device=dev)
    l_cold = gpu_solver.GpuSpfSolver(tnames[0], device=dev, enable_lfa=True)
    f_cold = gpu_solver.GpuSpfSolver(fnames[0], device=dev, enable_lfa=True)
    torch.cuda.synchronize()
    log(f"whole-fabric cells: host build and warm-up solves "
        f"{time.perf_counter() - t0:.1f} s")

    runs = {}
    # the path this phase reads: fabric10k's cold build alone, first
    f_dbs, runs["fabric10k cold"], launches = fabric_build(
        c, f_cold, fstates, fps, fnames)
    for name in FABRIC_PATH:
        check(launches[name] > 0,
              f"kernel {name} never launched on the fabric path")
    f_wdbs, runs["fabric10k warm"], _ = fabric_build(c, f_warm, fstates,
                                                     fps, fnames)
    t_dbs, runs["tg1k cold"], _ = fabric_build(c, t_cold, tstates, tps,
                                               tnames)
    t_wdbs, runs["tg1k warm"], _ = fabric_build(c, t_warm, tstates, tps,
                                                tnames)
    l_dbs, runs["tg1k-lfa cold"], _ = fabric_build(c, l_cold, lstates, lps,
                                                   tnames)
    for label, st in runs.items():
        log(f"whole-fabric {label}: " + json.dumps(st))

    # the array-level entry (the reference's sharded_fabric_step) on the
    # same cell, its own counts
    fad = f_cold._area_dev["0"]
    froots, fnbr, fw, _ = c.fabric.root_tables(fad.plan, fstates["0"],
                                               fnames)
    torch.cuda.synchronize()
    reads0 = c.zero_counts()
    t0 = time.perf_counter()
    api = c.sharding.sharded_fabric_step(
        None, fad.plan, fad.matrix, froots, fnbr, fw,
        runs["fabric10k cold"]["n_trips"], lfa=True,
        block_v4=block_v4(f_cold), with_ok=True, device=dev)
    torch.cuda.synchronize()
    api_ms = (time.perf_counter() - t0) * 1e3
    step_launches, reads = c.read_counts(reads0)
    for name in STEP_PATH:
        check(step_launches[name] > 0,
              f"kernel {name} never launched on the array-level step")
    log("fabric10k sharded_fabric_step: " + json.dumps({
        "roots": len(fnames), "host_ms": api_ms, "flag_reads": reads,
        "launches": {k: v for k, v in step_launches.items() if v}}))

    # RIBs: tg1k samples against the oracle, warm == cold; tg1k-lfa
    # samples against the LFA oracle
    t0 = time.perf_counter()
    for nm in tnames[::TG1K_ORACLE_EVERY]:
        want = c.SpfSolver(nm).build_route_db(nm, tstates, tps)
        check(rib_equal(want, t_dbs[nm]), f"tg1k fabric: {nm} != oracle")
        check(rib_equal(t_dbs[nm], t_wdbs[nm]), f"tg1k fabric: {nm} warm")
    tg1k_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    l_lfa = 0
    for nm in tnames[::LFA_ORACLE_EVERY]:
        want = c.SpfSolver(nm, enable_lfa=True).build_route_db(nm, lstates,
                                                               lps)
        check(rib_equal(want, l_dbs[nm]), f"tg1k-lfa fabric: {nm} != oracle")
        l_lfa += sum(bool(r.lfa_nexthops)
                     for r in l_dbs[nm].unicast_routes.values())
    check(l_lfa > 0, "tg1k-lfa: no sampled route has an LFA backup")
    lfa_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for nm in FABRIC_ORACLE:
        want = c.SpfSolver(nm, enable_lfa=True).build_route_db(nm, fstates,
                                                               fps)
        check(rib_equal(want, f_dbs[nm]), f"fabric10k fabric: {nm} != oracle")
    oracle_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    single = gpu_solver.GpuSpfSolver(fnames[0], device=dev, enable_lfa=True)
    for nm in fnames[::FABRIC_SINGLE_EVERY]:
        want = single.build_route_db(nm, fstates, fps)
        check(rib_equal(want, f_dbs[nm]),
              f"fabric10k fabric: {nm} != its single-vantage solve")
        check(rib_equal(f_dbs[nm], f_wdbs[nm]), f"fabric10k fabric: {nm} warm")
    single_ms = (time.perf_counter() - t0) * 1e3
    n_lfa = sum(bool(r.lfa_nexthops)
                for r in f_dbs[FABRIC_ORACLE[0]].unicast_routes.values())
    log("whole-fabric RIBs: " + json.dumps({
        "tg1k_oracle_vantages": len(tnames[::TG1K_ORACLE_EVERY]),
        "tg1k_check_ms": tg1k_ms,
        "tg1k_lfa_oracle_vantages": len(tnames[::LFA_ORACLE_EVERY]),
        "tg1k_lfa_routes_with_lfa": l_lfa, "tg1k_lfa_check_ms": lfa_ms,
        "fabric10k_oracle_vantages": len(FABRIC_ORACLE),
        "fabric10k_oracle_ms": oracle_ms,
        "fabric10k_single_vantages": len(fnames[::FABRIC_SINGLE_EVERY]),
        "fabric10k_single_ms": single_ms,
        "routes_with_lfa_at_" + FABRIC_ORACLE[0]: n_lfa}))

    # the steps' arrays against the plain step, then each kernel
    fabric_vs_plain(c, "tg1k", t_cold, tstates["0"], tnames, False,
                    FABRIC_PLAIN_ROOTS)
    # too small a trip bound: the vote and ``converged`` equal plain's
    got, _, _ = fabric_vs_plain(c, "tg1k unconverged", t_cold, tstates["0"],
                                tnames, False, FABRIC_PLAIN_ROOTS,
                                n_trips=UNCONVERGED_TRIPS)
    check(not got.converged[:FABRIC_PLAIN_ROOTS].all(),
          f"tg1k at {UNCONVERGED_TRIPS} trips: every checked root converged")
    log(f"tg1k at {UNCONVERGED_TRIPS} trips: "
        f"{int((~got.converged).sum())} of {len(tnames)} roots unconverged,"
        f" the first {FABRIC_PLAIN_ROOTS} equal to plain")
    del got
    got, _, _ = fabric_vs_plain(c, "tg1k-lfa", l_cold, lstates["0"], tnames,
                                True, FABRIC_PLAIN_ROOTS)
    check(int((got.lfa_slot[:FABRIC_PLAIN_ROOTS] >= 0).sum()) > 0,
          "tg1k-lfa: no row of the plain-checked roots has a backup")
    got, args, kw = fabric_vs_plain(c, "fabric10k", f_cold, fstates["0"],
                                    fnames, True, len(fnames))
    # the array-level entry: its unpacked masks are the step's words
    unpack = c.fabric.unpack_bits_plain
    check(max_abs_err(torch, api, (
        got.dist, got.metric, unpack(got.s3w, kw["a_cap"]),
        unpack(got.nhw, fnbr.shape[1]), got.lfa_slot, got.lfa_metric,
        got.ok)) == 0, "fabric10k: sharded_fabric_step != the solver's step")
    del api, got
    fabric_kernels(c, args, kw, runs["fabric10k cold"]["n_trips"])
    c.variant_launches["K1s:sssp_init[fabric]"] = launches["K1s:sssp_init"]
    c.variant_launches["K3:select_routes[fabric]"] = launches[
        "K3:select_routes"]
    return launches, step_launches


# the multichip tier (phase 14): MC_SHARDS logical shards on the card
# (make_mesh(8): batch 4 x graph 2), lsdb100k_mc (bench.py:1171-1183: the
# lsdb100k cell with the tier's threshold halved, so n_cap 131072 engages
# it), tg1k-lfa on MC_LFA_SHARDS (batch 2 x graph 3: the node axis pads)
MC_SHARDS = 8
MC_THRESHOLD = 65536
MC_LFA_SHARDS = (6, 2)
MC_FLAPS = 4
MC_PATH = ("K1s:sssp_init_mc", "K1:relax_step_mc", "K2:ladder_classes_mc",
           "K2:ladder_pass", "K23:shard_combine",
           "K3:select_routes", "K4:compact_outputs")
MC_INCR_PATH = MC_PATH + ("K5:scatter_parts", "K5:scatter_window",
                          "K6:parent_shift_mc",
                          "K7:owned_weights", "K7:cone_seed_mc",
                          "K8+K9:cone_resolve", "K9:cone_finish")
MESH_FABRIC_PATH = ("K1s:sssp_init", "K21e:fabric_extent",
                    "K21:fabric_relax_mc", "K23:shard_combine",
                    "K3:select_routes")


def resident_outputs(solver, root: str) -> tuple:
    """The published columns (metric, s3w, nhw, lfa_slot, lfa_metric) the
    solver keeps for its vantage in area "0"."""
    return solver._vstates[("0", root)].prev


def mc_build(c, solver, lsdb, root, window: dict) -> tuple:
    """One multichip build in a count window (counts zeroed just before,
    read just after and added to ``window``) -> (RIB, record)."""
    torch = c.torch
    _, states, ps = lsdb
    gc2 = []

    def on_gc(phase, info):
        if info["generation"] == 2:
            gc2.append(time.perf_counter() * (1 if phase == "stop" else -1))

    reads0 = c.zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    try:
        db = solver.build_route_db(root, states, ps)
        torch.cuda.synchronize()
    finally:
        gc.callbacks.remove(on_gc)
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    n, reads = c.read_counts(reads0)
    for k, v in n.items():
        window[k] = window.get(k, 0) + v
    tm, st = solver.last_timing, solver.last_device_stats
    check(st.get("multichip"), "the build did not engage the multichip tier")
    rec = {
        "build_ms": wall,
        **{k: st.get(k) for k in ("spf_kernel", "incremental", "fell_back",
                                  "cone", "trips", "rounds", "bucket_epochs",
                                  "halo_exchanges")},
        **{k: tm.get(k) for k in ("sync_ms", "exec_ms", "sssp_ms", "tail_ms",
                                  "compact_ms", "pull_ms", "unpack_ms",
                                  "scatter_ms", "bytes_uploaded",
                                  "bytes_downloaded")},
        "shard_ms": st["multichip"]["shard_ms"],
        # the wall of Python's full collections inside the build (a
        # suspected cause of multi-second host stalls: a 100k LSDB holds
        # millions of objects)
        "gc2_passes": len(gc2) // 2, "gc2_ms": sum(gc2) * 1e3,
        "launches": sum(n.values()), "flag_reads": reads,
        "peak_device_bytes": peak,
    }
    return db, rec


def mc_vs_single(c, label, mc, single, lsdb, root, window, oracle=None):
    """A multichip build and a single-device build of the same LSDB: the
    published columns byte for byte and the RIBs equal (and the oracle's
    when given). Prints the record beside the single build's counts."""
    _, states, ps = lsdb
    db, rec = mc_build(c, mc, lsdb, root, window)
    want = single.build_route_db(root, states, ps)
    err = max_abs_err(c.torch, resident_outputs(mc, root),
                      resident_outputs(single, root))
    check(err == 0, f"{label}: multichip columns != single-device columns")
    check(rib_equal(want, db), f"{label}: multichip RIB != single-device")
    if oracle is not None:
        check(rib_equal(oracle, db), f"{label}: multichip RIB != oracle")
    st = single.last_device_stats
    rec["single"] = {k: st.get(k) for k in ("incremental", "fell_back",
                                            "cone", "trips", "rounds")}
    rec["oracle_checked"] = oracle is not None
    log(f"lsdb100k_mc {label}: " + json.dumps(rec))
    return rec


# K23's seeded edge cases: (groups, members, width, also width or None,
# planes 16-byte aligned)
COMBINE_CASES = (
    (1, 1, 7, None, True),
    (1, 2, 131072, None, True),
    (4, 2, 131072, 8192, True),
    (8, 16, 1001, 3, True),
    (3, 5, 4097, None, False),
    (2, 3, 0, 5, True),
    (8, 2, 65539, None, True),
    (9, 2, 100, 10, True),
)


def combine_cases(c) -> int:
    """K23 on COMBINE_CASES, min / max / sum, with and without a ref and
    flag a group (each group's ref its own result, or one word off),
    ``also`` groups by max where given, unaligned planes (views one word
    into their storage: the scalar path), against the plain version at
    tolerance 0; one launch a call (two past 8 groups). -> the largest
    error."""
    torch, comb = c.torch, c.combine
    gen = torch.Generator().manual_seed(23)
    errs = []

    def plane(n, aligned):
        t = torch.randint(-99, 99, (n + 1,), generator=gen,
                          dtype=torch.int32).to(c.dev)
        return t[:n] if aligned else t[1:]

    for n_groups, members, width, also_w, aligned in COMBINE_CASES:
        for op in ("min", "max", "sum"):
            for with_ref in (False, True):
                groups = [[plane(width, aligned) for _ in range(members)]
                          for _ in range(n_groups)]
                also = None if also_w is None else [
                    [plane(also_w, aligned) for _ in range(members)]
                    for _ in range(n_groups)]
                want = [[t.clone() for t in grp] for grp in groups]
                want_also = None if also is None else [
                    [t.clone() for t in grp] for grp in also]
                refs = flags = flags_p = None
                if with_ref:
                    refs = [grp[0].clone() for grp in groups]
                    res0 = [t.clone() for t in groups[0]]
                    comb.shard_combine_plain(res0, op)
                    refs[0] = res0[0]
                    flags = [torch.zeros(1, dtype=torch.int32, device=c.dev)
                             for _ in groups]
                    flags_p = [torch.zeros_like(f) for f in flags]
                n = counted(torch, c.wrappers, lambda: comb.shard_combine_groups(
                    groups, op, refs, flags, also))
                check(n["launches"] == n["kernel_launches"]
                      == -(-n_groups // comb.MAX_GROUPS),
                      f"K23 {n_groups} x {members}: launches {n}")
                comb.shard_combine_groups_plain(want, op, refs, flags_p,
                                                want_also)
                err = max_abs_err(torch, (groups, also or [], flags or []),
                                  (want, want_also or [], flags_p or []))
                check(err == 0, f"K23 {n_groups} groups x {members} members"
                      f" of {width} words, {op}, ref {with_ref}: kernel != "
                      f"plain ({err})")
                errs.append(err)
    log(f"K23: {len(COMBINE_CASES)} seeded shapes x min / max / sum x "
        f"ref or not equal to plain")
    return max(errs)


def mc_kernels(c, solver, lsdb, root, dirty) -> None:
    """The mc kernels against their plain versions at lsdb100k_mc's
    shapes, on the shard of group 0 whose column window (n_cap / graph
    wide) holds the root, and K23 over the group's two planes. ``dirty``
    = (s_idx, s_old) of a flap, global flat indices."""
    torch, relax, inc, comb = c.torch, c.relax, c.incremental, c.combine
    ad = solver._area_dev["0"]
    plan, mesh = ad.plan, ad.mc_mesh
    n_cap, s_cap = plan.n_cap, plan.s_cap
    g = mesh.shape["graph"]
    w_cols = n_cap // g
    ridx = plan.node_index[root]
    jr = ridx // w_cols
    col0 = jr * w_cols
    deltas = ad.deltas.part(0, jr)
    shift = ad.shift_w.part(0, jr)
    res = [c.sharding.gather(getattr(ad, k), 0, jr)
           for k in ("res_rows", "res_nbr", "res_w")]
    has_res = plan.k_res > 0
    nbr_np, w_np, _ = plan.out_links(lsdb[1]["0"], root)
    d_pad = -(-nbr_np.shape[0] // mesh.shape["batch"]) * mesh.shape["batch"]
    d_loc = d_pad // mesh.shape["batch"]
    nbr = torch.tensor(c.sharding.pad_to(nbr_np, d_pad, -1)[:d_loc],
                       device=c.dev)
    w = torch.tensor(c.sharding.pad_to(w_np, d_pad, relax.INF_E)[:d_loc],
                     device=c.dev)
    iargs = (shift, *res, ridx, nbr, w, col0, n_cap)
    got = relax.sssp_init_mc(*iargs)
    want = relax.sssp_init_mc_plain(*iargs)
    res_bytes = 4 * (res[0].numel() + 2 * res[1].numel())
    c.record(
        "K1s:sssp_init_mc", max_abs_err(torch, (got[0], *got[1], got[2]),
                                        (want[0], *want[1], want[2])),
        lambda: relax.sssp_init_mc(*iargs),
        lambda: relax.sssp_init_mc_plain(*iargs),
        nbytes=4 * (2 * s_cap * w_cols + 2 * d_loc + d_loc * n_cap)
        + 2 * res_bytes, ops=s_cap * w_cols + d_loc * n_cap)
    sw, residual, dist0 = got
    residual = residual if has_res else None
    # a mid-solve wavefront: 16 relaxations of the group, each member's
    # and then their min
    sws = [relax.sssp_init_mc(ad.shift_w.part(0, j), *res, ridx, nbr, w,
                              j * w_cols, n_cap)[0] for j in range(g)]
    mid = dist0.clone()
    for _ in range(16):
        outs = [torch.empty_like(mid) for _ in range(g)]
        for j in range(g):
            relax.relax_step_mc(mid, outs[j], None, deltas, sws[j], residual,
                                j * w_cols)
        comb.shard_combine(outs, "min")
        mid = outs[0]
    o_k, o_p = torch.empty_like(mid), torch.empty_like(mid)
    f_k = torch.zeros(1, dtype=torch.int32, device=c.dev)
    f_p = torch.zeros_like(f_k)
    relax.relax_step_mc(mid, o_k, f_k, deltas, sw, residual, col0)
    relax.relax_step_mc_plain(mid, o_p, f_p, deltas, sw, residual, col0)
    check(int(f_k) == 1, "K1 [mc] on a wavefront must change the plane")
    c.record(
        "K1:relax_step_mc", max_abs_err(torch, (o_k, f_k), (o_p, f_p)),
        lambda: relax.relax_step_mc(mid, o_k, f_k, deltas, sw, residual,
                                    col0),
        lambda: relax.relax_step_mc_plain(mid, o_p, f_p, deltas, sw,
                                          residual, col0),
        nbytes=4 * (2 * d_loc * n_cap + s_cap * w_cols + s_cap)
        + (res_bytes if has_res else 0),
        # every class's window test, the add and min for its own sources
        ops=d_loc * n_cap * s_cap + 2 * d_loc * n_cap * s_cap // g
        + (2 * d_loc * res[1].numel() if has_res else 0))
    s_lad = min(s_cap, relax.LADDER_WIDTH)
    dq = 1 << max(plan.delta_exp, 1)
    largs = (sw, deltas, dq, s_lad, col0, n_cap)
    c.record(
        "K2:ladder_classes_mc",
        max_abs_err(torch, relax.ladder_classes_mc(*largs),
                    relax.ladder_classes_mc_plain(*largs)),
        lambda: relax.ladder_classes_mc(*largs),
        lambda: relax.ladder_classes_mc_plain(*largs),
        nbytes=4 * (s_cap * w_cols + s_cap + s_lad * n_cap + s_lad),
        ops=s_cap * w_cols + s_lad * n_cap)
    pick_only = counted(torch, c.wrappers,
                        lambda: relax.ladder_classes_mc(*largs))
    check(pick_only["launches"] == pick_only["kernel_launches"] == 1,
          f"K2 [mc]'s class pick must be one launch and no torch op: "
          f"{pick_only}")
    # the member's ladder pass on the group's wavefront, its own classes
    w_m, d_m = relax.ladder_classes_mc(*largs)
    pa, pb = mid.clone(), torch.empty_like(mid)
    w2_m, d2_m = torch.empty_like(w_m), torch.empty_like(d_m)
    c.record(
        "K2:ladder_pass[mc]", pass_check(torch, relax, mid, w_m, d_m),
        lambda: relax.ladder_pass(pa, pb, w_m, d_m, w2_m, d2_m, f_k),
        lambda: relax.ladder_pass_plain(pa, pb, w_m, d_m, w2_m, d2_m, f_p),
        nbytes=4 * (2 * d_loc * n_cap + 2 * s_lad * n_cap + 2 * s_lad),
        ops=2 * s_lad * d_loc * n_cap + 2 * s_lad * n_cap)
    # K5 [mc]: the last flap's dirty slots (global flat indices) into
    # each member's columns: held on both, timed on the one owning them
    sdi = torch.tensor(dirty[0], device=c.dev)
    sdo = torch.tensor(dirty[1], device=c.dev)
    errs, owned = [], {}
    for j in range(g):
        part = ad.shift_w.part(0, j)
        old_k, old_p = part.clone(), part.clone()
        inc.scatter_window(old_k, sdi, sdo, (s_cap, n_cap), 0, j * w_cols)
        inc.scatter_window_plain(old_p, sdi, sdo, (s_cap, n_cap), 0,
                                 j * w_cols)
        errs.append(max_abs_err(torch, old_k, old_p))
        f = sdi.long()
        u = f % n_cap - j * w_cols
        own = (f >= 0) & (f < s_cap * n_cap) & (u >= 0) & (u < w_cols)
        owned[j] = ((f // n_cap * w_cols + u)[own], sdo[own], old_k)
    jo = max(owned, key=lambda j: owned[j][0].numel())
    loc, vals, _ = owned[jo]
    check(loc.numel() > 0, "K5 [mc]: the flap dirtied no shard")
    scratch = ad.shift_w.part(0, jo).clone()
    c.record(
        "K5:scatter_window", max(errs),
        lambda: inc.scatter_window(scratch, sdi, sdo, (s_cap, n_cap), 0,
                                   jo * w_cols),
        lambda: inc.scatter_window_plain(scratch, sdi, sdo, (s_cap, n_cap),
                                         0, jo * w_cols),
        nbytes=4 * (2 * sdi.numel() + loc.numel()), ops=6 * sdi.numel(),
        library=lambda: scratch.view(-1).index_copy_(0, loc, vals))
    # K5 [mc] of a sync: every part of the resident shift plane on the
    # card (the graph's distinct column windows) in one launch, against
    # the per-part plain scatter
    (parts, wins, _), = c.sharding._scatter_targets(ad.shift_w).values()
    check(len(parts) == g, f"K5 [mc]: {len(parts)} parts on the card")
    p_k = [t.clone() for t in parts]
    p_p = [t.clone() for t in parts]
    table = inc.part_table(p_k, wins)
    scatter_args = (p_k, wins, sdi, sdo, (s_cap, n_cap), table)
    one_launch(torch, c.wrappers, "K5 [mc] all parts of the card",
               lambda: inc.scatter_parts(*scatter_args))
    inc.scatter_parts_plain(p_p, wins, sdi, sdo, (s_cap, n_cap))
    c.record(
        "K5:scatter_parts", max_abs_err(torch, p_k, p_p),
        lambda: inc.scatter_parts(*scatter_args),
        lambda: inc.scatter_parts_plain(p_p, wins, sdi, sdo,
                                        (s_cap, n_cap)),
        nbytes=4 * (2 * sdi.numel() + 5 * len(parts) + loc.numel()),
        ops=6 * sdi.numel() * len(parts))
    tab_ptr = table.data_ptr()
    c.split("K5:scatter_parts", lambda: inc.scatter_parts(*scatter_args),
            floor=lambda: c.cuda.launch(
                "incremental", "scatter_parts", "pippiii", tab_ptr,
                len(parts), sdi.data_ptr(), sdo.data_ptr(), sdi.numel(),
                s_cap, n_cap))
    old_k = owned[jr][2]
    # K6 [mc] on the solver's converged lanes of group 0 (its warm plane)
    prev = solver._vstates[("0", root)].prev_dist[0][jr]
    swm_old = relax.sssp_init_mc(old_k, *res, ridx, nbr, w, col0, n_cap)[0]
    pargs = (deltas, swm_old, prev, s_cap, col0)
    par_k = inc.parent_shift_mc(*pargs)
    c.record(
        "K6:parent_shift_mc",
        max_abs_err(torch, par_k, inc.parent_shift_mc_plain(*pargs)),
        lambda: inc.parent_shift_mc(*pargs),
        lambda: inc.parent_shift_mc_plain(*pargs),
        nbytes=4 * (2 * d_loc * n_cap + s_cap * w_cols + s_cap),
        ops=4 * d_loc * n_cap * s_cap)
    errs = []
    for j in range(g):
        oargs = (sws[j], sdi, n_cap, j * w_cols)
        errs.append(max_abs_err(torch, inc.owned_weights(*oargs),
                                inc.owned_weights_plain(*oargs)))
        if j == jo:
            timed = oargs
    oargs = (sw, sdi, n_cap, col0)
    new_m = inc.owned_weights(*oargs)
    c.record(
        "K7:owned_weights", max(errs),
        lambda: inc.owned_weights(*timed),
        lambda: inc.owned_weights_plain(*timed),
        nbytes=4 * (2 * sdi.numel() + loc.numel()), ops=6 * sdi.numel())
    rdi = torch.full((sdi.numel(),), res[2].numel(), dtype=torch.int32,
                     device=c.dev)
    rdo = torch.zeros_like(rdi)
    cargs = (par_k, new_m, residual[2] if has_res else res[2], deltas,
             res[0], res[1], ridx, sdi, sdo, rdi, rdo, has_res, s_cap)
    n_dirty = 2 * sdi.numel()
    c.record(
        "K7:cone_seed_mc",
        max_abs_err(torch, inc.cone_seed_mc(*cargs),
                    inc.cone_seed_mc_plain(*cargs)),
        lambda: inc.cone_seed_mc(*cargs),
        lambda: inc.cone_seed_mc_plain(*cargs),
        nbytes=4 * (3 * n_dirty + d_loc * n_dirty + d_loc * n_cap),
        ops=6 * d_loc * n_dirty)
    # K23 over the two members' planes of a group, min, max and sum
    a, b = mid.clone(), o_k.clone()
    a_p, b_p = a.clone(), b.clone()
    ref = mid.clone()
    fk = torch.zeros(1, dtype=torch.int32, device=c.dev)
    fp = torch.zeros_like(fk)
    errs = []
    for op in ("min", "max", "sum"):
        comb.shard_combine([a, b], op, ref=ref, flag=fk)
        comb.shard_combine_plain([a_p, b_p], op, ref=ref, flag=fp)
        errs.append(max_abs_err(torch, (a, b, fk), (a_p, b_p, fp)))
    check(int(fk) == 1, "K23: the combined plane must differ from ref")
    n = a.numel()
    c.record(
        "K23:shard_combine", max(errs + [combine_cases(c)]),
        lambda: comb.shard_combine([a, b], "min", ref=ref, flag=fk),
        lambda: comb.shard_combine_plain([a, b], "min", ref=ref, flag=fk),
        nbytes=4 * (2 * 2 * n + n), ops=2 * n,
        library=lambda: torch.minimum(a, b))
    c.split("K23:shard_combine",
            lambda: comb.shard_combine([a, b], "min", ref=ref, flag=fk),
            library=lambda: torch.minimum(a, b))
    # every group of the mc path's mesh at once (batch 4 x graph 2: one
    # launch a relaxation), against torch.minimum once a group
    nb_ = mesh.shape["batch"]
    groups = [[mid.clone(), o_k.clone()] for _ in range(nb_)]
    groups_p = [[t.clone() for t in grp] for grp in groups]
    refs = [mid.clone() for _ in range(nb_)]
    gflags = [torch.zeros(1, dtype=torch.int32, device=c.dev)
              for _ in range(2 * nb_)]

    def grouped():
        comb.shard_combine_groups(groups, "min", refs=refs,
                                  flags=gflags[:nb_])

    def per_group_library():
        for grp in groups:
            torch.minimum(grp[0], grp[1])

    one_launch(torch, c.wrappers, f"K23 over {nb_} groups", grouped)
    comb.shard_combine_groups_plain(groups_p, "min", refs=refs,
                                    flags=gflags[nb_:])
    c.record(
        "K23:shard_combine[groups]",
        max_abs_err(torch, (groups, gflags[:nb_]), (groups_p, gflags[nb_:])),
        grouped,
        lambda: comb.shard_combine_groups_plain(groups_p, "min", refs=refs,
                                                flags=gflags[nb_:]),
        nbytes=4 * nb_ * (2 * 2 * n + n), ops=2 * n * nb_,
        library=per_group_library)
    c.split("K23:shard_combine[groups]", grouped, library=per_group_library)
    c.results["K23:shard_combine[groups]"]["groups"] = nb_
    log(f"lsdb100k_mc kernels on shard (0, {jr}) (columns {col0}.."
        f"{col0 + w_cols}) equal to plain")


def mesh_fabric_kernels(c, fsolver, fnames, fstates) -> None:
    """K21 [mc] over every fabric10k root (a graph 2 split, shard 1's
    columns and residual rows) against its plain version 256 roots a
    call, and K6's residual fill at fabric10k's shapes."""
    torch, fabric, relax, inc = c.torch, c.fabric, c.relax, c.incremental
    ad = fsolver._area_dev["0"]
    plan = ad.plan
    mesh = c.sharding.make_mesh(2, batch=1, devices=[c.dev] * 2)
    roots, nbr, w, _ = fabric.root_tables(plan, fstates["0"], fnames)
    kw = c.sharding.fabric_mesh_inputs(mesh, plan, ad.matrix, roots, nbr, w)
    shift, rows, rnbr, rw = (kw[k][0][1] for k in ("shift_w", "res_rows",
                                                   "res_nbr", "res_w"))
    n_cap = 2 * shift.shape[1]
    deltas, roots_t = kw["deltas"][0][1], kw["roots"][0][1]
    col0 = n_cap // 2
    ext, live = fabric.fabric_extent(rw, shift)
    residual = (rows, rnbr, rw, ext, kw["row_of"][0][1])
    rt = roots_t.shape[0]
    inside = int(((roots_t >= col0) & (roots_t < n_cap)).sum())
    check(0 < inside < rt, "K21 [mc]: roots must lie in and out of the "
          "member's window")
    check(int((rows < 0).sum()) > 0, "K21 [mc]: the member holds no pad row")
    d0 = relax.sssp_init(*(torch.empty((rt,) + sh, dtype=torch.int32,
                                       device=c.dev)
                           for sh in ((0, n_cap), (0,), (0, 0), (0, 0))),
                         roots_t, kw["out_nbr"][0][1], kw["out_w"][0][1])[2]
    # a wavefront: 2 whole-width relaxations from the seeds
    mid, spare = d0, torch.empty_like(d0)
    flag = torch.zeros(1, dtype=torch.int32, device=c.dev)
    whole = (ad.res_rows, ad.res_nbr, ad.res_w,
             fabric.fabric_extent(ad.res_w),
             fabric.row_table(ad.res_rows, ad.plan.n_cap))
    for _ in range(2):
        fabric.fabric_relax(mid, spare, flag, ad.deltas, ad.shift_w, whole,
                            roots_t)
        mid, spare = spare, mid
    del spare
    o_k, o_p = torch.empty_like(mid), torch.empty_like(mid)
    f_k = torch.zeros(1, dtype=torch.int32, device=c.dev)
    f_p = torch.zeros_like(f_k)

    def relax_plain():
        by_roots(torch, rt, lambda s: fabric.fabric_relax_mc_plain(
            mid[s], o_p[s], f_p, deltas, shift, residual, roots_t[s],
            col0=col0))

    def k21_mc():
        fabric.fabric_relax_mc(mid, o_k, f_k, deltas, shift, residual,
                               roots_t, col0=col0, live=live)

    one_launch(torch, c.wrappers, "K21 [mc] over fabric10k's roots", k21_mc)
    relax_plain()
    check(int(f_k) == 1, "K21 [mc] on a wavefront must change the planes")
    n_ent = int((rw < relax.INF_E).sum())
    s_cap, w_cols = shift.shape
    n_live = int(live.sum())
    c.record(
        "K21:fabric_relax_mc", max_abs_err(torch, (o_k, f_k), (o_p, f_p)),
        k21_mc, relax_plain,
        nbytes=4 * (2 * mid.numel() + s_cap * w_cols + s_cap
                    + 2 * rows.numel() + n_cap + 2 * n_ent),
        ops=2 * mid.numel() * n_live + 2 * rt * nbr.shape[1] * n_ent,
        reps=10, plain_reps=1, plain_warmup=0)
    c.split("K21:fabric_relax_mc", k21_mc,
            floor=k21_floor(c.cuda, mid, o_k, f_k, deltas, shift, live,
                            roots_t, residual, col0))
    c.results["K21:fabric_relax_mc"].update(
        live_classes=n_live, roots_in_window=inside)
    del mid, o_k, o_p
    # K6's residual fill on a fabric10k root's converged planes
    r0 = plan.node_index[fnames[0]]
    n0, w0, _ = plan.out_links(fstates["0"], fnames[0])
    n0, w0 = torch.tensor(n0, device=c.dev), torch.tensor(w0, device=c.dev)
    prev, _, _ = relax.plan_sssp(ad.deltas, ad.shift_w, ad.res_rows,
                                 ad.res_nbr, ad.res_w, r0, n0, w0, True,
                                 "sync")
    swm, (_, _, rwm), _ = relax.sssp_init(ad.shift_w, ad.res_rows,
                                         ad.res_nbr, ad.res_w, r0, n0, w0)
    par = inc.parent_shift_mc(ad.deltas, swm, prev, plan.s_cap, 0)
    fk, fp, scratch = par.clone(), par.clone(), par.clone()
    fargs = (ad.res_rows, ad.res_nbr, rwm, prev)
    inc.parent_fill(fk, *fargs)
    inc.parent_fill_plain(fp, *fargs)
    check(int((fk != par).sum()) > 0, "K6 fill: no residual parent filled")
    c.record(
        "K6:parent_fill", max_abs_err(torch, fk, fp),
        lambda: inc.parent_fill(scratch, *fargs),
        lambda: inc.parent_fill_plain(scratch, *fargs),
        nbytes=4 * (ad.res_rows.numel() + 2 * ad.res_nbr.numel()
                    + 2 * prev.numel()),
        ops=4 * prev.shape[0] * ad.res_nbr.numel())
    # K6 whole with fabric10k's residual (shift phase, grid barrier,
    # residual phase: one cooperative launch) into a held plane
    held = torch.full_like(prev, -7)
    pargs = (ad.deltas, swm, ad.res_rows, ad.res_nbr, rwm, prev, plan.s_cap,
             True, plan.n_cap, prev.shape[0])

    def whole():
        inc.parent_plane(*pargs, out=held)

    held_launch(torch, c.wrappers, "K6 with fabric10k's residual", whole)
    err = max_abs_err(torch, held, inc.parent_plane_plain(*pargs))
    check(err == 0, f"K6 with fabric10k's residual: kernel != plain ({err})")
    dev_ms, host_ms = device_ms(torch, whole)
    r = c.results["K6:parent_plane"]
    r.update(
        residual_ms=time_ms(torch, whole, 50), residual_device_ms=dev_ms,
        residual_host_ms=host_ms, residual_shape=list(prev.shape),
        residual_bound_ms=bound(
            4 * (2 * prev.numel() + swm.numel() + ad.res_rows.numel()
                 + 2 * ad.res_nbr.numel()),
            4 * prev.numel() * plan.s_cap)[0])
    log("K6 with fabric10k's residual, one launch: " + json.dumps(
        {k: v for k, v in r.items() if k.startswith("residual_")}))


def mc_tail(c, solver, lsdb, root) -> None:
    """K3 and K4 on the multichip tier's tail, and each member's cone
    (``cone_resolve`` without a plane) and seed plane (K9): the arguments
    ``gpu_solver.mc_pipeline`` and ``sharding.mc_incremental_sssp`` pass
    them in one more lsdb100k_mc build of ``solver`` after a flap
    (copied as they call them), each held to its plain version
    (tolerance 0) and counted as one launch; K9's row is timed on
    member (0, 0)'s."""
    torch, gs, sh, inc = c.torch, c.gpu_solver, c.sharding, c.incremental
    adj_dbs, states, ps = lsdb
    by_name = {db.this_node_name: db for db in adj_dbs}
    seen, members = {}, {"cone_resolve": [], "cone_finish": []}
    real = {"select_routes": gs.select_routes,
            "compact_outputs": gs.compact_outputs,
            "cone_resolve": sh.cone_resolve, "cone_finish": sh.cone_finish}

    def spy(name):
        def call(*a, **k):
            # copied before the call: the cone and the tail change in place
            copy = (tensors_mapped(lambda t: t.clone(), a), k)
            if name in members:
                members[name].append(copy)
            else:
                seen[name] = copy
            return real[name](*a, **k)
        return call

    vname = adj_dbs[1].this_node_name
    cur = states["0"].get_adjacency_databases()[vname].adjacencies[0].metric
    flap(c.AdjacencyDatabase, states, adj_dbs, by_name, 1,
         (cur - 50 + 1) % 5)
    gs.select_routes, gs.compact_outputs = spy("select_routes"), spy(
        "compact_outputs")
    sh.cone_resolve, sh.cone_finish = spy("cone_resolve"), spy(
        "cone_finish")
    try:
        solver.build_route_db(root, states, ps)
    finally:
        gs.select_routes = real["select_routes"]
        gs.compact_outputs = real["compact_outputs"]
        sh.cone_resolve = real["cone_resolve"]
        sh.cone_finish = real["cone_finish"]
    check(set(seen) == {"select_routes", "compact_outputs"}
          and solver.last_device_stats.get("multichip")
          and solver.last_device_stats.get("incremental"),
          "lsdb100k_mc: the tier's incremental tail did not run")
    mesh = solver._area_dev["0"].mc_mesh
    check(len(members["cone_resolve"]) == len(members["cone_finish"])
          == mesh.size, "lsdb100k_mc: one cone and one seed plane a member")
    rows = []
    for i, (a, k) in enumerate(members["cone_resolve"]):
        par, seeded, *rest = a
        rows.append(cone_case(c, f"mc member {i}", par, seeded, tuple(rest),
                              reps=5)[0])
    (fa, fk) = members["cone_finish"][0]
    fin_tail = fa[6].clone()  # the kernel writes tail[1] in place

    def fin():
        return inc.cone_finish(*fa[:6], fin_tail, **fk)

    def fin_plain():
        return inc.cone_finish_plain(*fa[:6], fa[6][0], **fk)

    err = 0
    for fa_i, fk_i in members["cone_finish"]:
        err = max(err, max_abs_err(
            torch, inc.cone_finish(*fa_i[:6], fa_i[6].clone(), **fk_i),
            inc.cone_finish_plain(*fa_i[:6], fa_i[6][0], **fk_i)))
    one_launch(torch, c.wrappers, "cone_finish on a member", fin)
    d_loc, n_cap = fa[0].shape
    c.record(
        "K9:cone_finish", err, fin, fin_plain,
        nbytes=4 * (3 * d_loc * n_cap + 2 * d_loc + 2),
        ops=3 * d_loc * n_cap)
    log("lsdb100k_mc: every member's cone (one launch each) and seed plane "
        "equal to plain: " + json.dumps(
            {k: [r[k] for r in rows] for k in ("cone", "sweeps", "ms")}))
    for name, mod in (("select_routes", c.select),
                      ("compact_outputs", c.compact)):
        a, k = seen[name]
        err = max_abs_err(torch, getattr(mod, name)(*a, **k),
                          getattr(mod, name + "_plain")(*a, **k))
        check(err == 0, f"lsdb100k_mc tail: {name} != plain (err {err})")
        one_launch(torch, c.wrappers, f"{name} on the mc tail",
                   lambda: getattr(mod, name)(*a, **k))
    log("lsdb100k_mc: K3 and K4 on the tier's tail equal to plain, each "
        "call one launch")


def multichip_phase(c, lsdb, fcell) -> tuple:
    """Phase 14 (module docstring). Returns the launches of each path's
    count window ("mc", "mc_incr" and "fabric_mesh") and the halo
    exchanges of the cold builds (a group's combines: per relaxation
    under sync, per bucket epoch under bucketed)."""
    import numpy as np

    torch, dev, gs = c.torch, c.dev, c.gpu_solver
    root = LSDB100K_ROOT
    adj_dbs, states, ps = lsdb
    by_name = {db.this_node_name: db for db in adj_dbs}
    devices = [dev] * MC_SHARDS
    windows = {"mc": {}, "mc_incr": {}, "fabric_mesh": {}}
    kw = dict(device=dev, incremental_spf=True,
              multichip_n_cap_threshold=MC_THRESHOLD,
              multichip_devices=devices)
    t0 = time.perf_counter()
    # the LSDB as phases 6, 8 and 13 left it: a fresh oracle
    oracle = c.SpfSolver(root).build_route_db(root, states, ps)
    t_oracle = (time.perf_counter() - t0) * 1e3
    mc = gs.GpuSpfSolver(root, **kw)
    single = gs.GpuSpfSolver(root, device=dev, incremental_spf=True)
    rec = mc_vs_single(c, "cold", mc, single, lsdb, root, windows["mc"],
                       oracle)
    check(rec["spf_kernel"] == "bucketed", "lsdb100k_mc runs bucketed")
    check(rec["halo_exchanges"] == rec["bucket_epochs"] > 0,
          "bucketed: one halo exchange a bucket epoch")
    halo = {"bucketed": {
        "halo_exchanges": rec["halo_exchanges"],
        "bucket_epochs": rec["bucket_epochs"],
        "per_epoch": rec["halo_exchanges"] / rec["bucket_epochs"]}}
    ad = mc._area_dev["0"]
    check(ad.plan.n_cap > MC_THRESHOLD and ad.mc_mesh.shape == {
        "batch": 4, "graph": 2}, "lsdb100k_mc: not on a 4 x 2 mesh")
    log(f"lsdb100k_mc: n_cap {ad.plan.n_cap} on {ad.mc_mesh!r}, mirror "
        f"{ad.shift_w.nbytes()} B of shift columns over the shards, oracle "
        f"{t_oracle:.0f} ms")
    # four flaps of adj_dbs[1], each metric unlike the one before
    vname = adj_dbs[1].this_node_name
    cur = states["0"].get_adjacency_databases()[vname].adjacencies[0].metric
    i0 = (cur - 50 + 1) % 5
    for k in range(MC_FLAPS):
        flap(c.AdjacencyDatabase, states, adj_dbs, by_name, 1, i0 + k)
        r = mc_vs_single(c, f"flap {k}", mc, single, lsdb, root,
                         windows["mc_incr"],
                         oracle=None if k < MC_FLAPS - 1 else
                         c.SpfSolver(root).build_route_db(root, states, ps))
        check(r["incremental"] and not r["fell_back"],
              f"lsdb100k_mc flap {k} must be incremental without fallback")
    # the last flap's drain: its dirty shift slots and their old values
    _, s_map, _ = ad.drain_log[-1]
    cap = max(64, len(s_map))
    sidx = np.full(cap, ad.plan.s_cap * ad.plan.n_cap, np.int32)
    sold = np.zeros(cap, np.int32)
    sidx[:len(s_map)] = list(s_map)
    sold[:len(s_map)] = list(s_map.values())
    dirty = (sidx, sold)
    fb = gs.GpuSpfSolver(root, **kw, incremental_cone_frac=0.0)
    fb.build_route_db(root, states, ps)
    flap(c.AdjacencyDatabase, states, adj_dbs, by_name, 1, i0 + MC_FLAPS)
    r = mc_vs_single(c, "fallback", fb, single, lsdb, root,
                     windows["mc_incr"])
    check(r["incremental"] and r["fell_back"] and r["cone"] > 0,
          "the cone_frac=0 step must fall back on the card")
    sync = gs.GpuSpfSolver(root, **kw, spf_kernel="sync")
    r = mc_vs_single(c, "cold sync", sync, single, lsdb, root,
                     windows["mc"])
    check(r["halo_exchanges"] == r["rounds"] > 0,
          "sync: one halo exchange a relaxation")
    halo["sync"] = {"halo_exchanges": r["halo_exchanges"],
                    "relaxations": r["rounds"],
                    "per_relaxation": r["halo_exchanges"] / r["rounds"]}
    # the same flaps under sync: the incremental solve's sync branch
    for k in range(MC_FLAPS):
        flap(c.AdjacencyDatabase, states, adj_dbs, by_name, 1,
             i0 + MC_FLAPS + 1 + k)
        r = mc_vs_single(c, f"sync flap {k}", sync, single, lsdb, root,
                         windows["mc_incr"])
        check(r["spf_kernel"] == "sync" and r["incremental"]
              and not r["fell_back"],
              f"lsdb100k_mc sync flap {k} must be incremental without "
              f"fallback")
        check(r["halo_exchanges"] == r["rounds"],
              "sync: one halo exchange a relaxation")
    for name in MC_PATH:
        check(windows["mc"].get(name, 0) > 0,
              f"kernel {name} never launched on the mc path")
    for name in MC_INCR_PATH:
        check(windows["mc_incr"].get(name, 0) > 0,
              f"kernel {name} never launched on the mc churn path")
    mc_kernels(c, mc, lsdb, root, dirty)
    mc_tail(c, mc, lsdb, root)
    del fb, sync, single

    # -- whole-fabric fabric10k on the mesh ----------------------------------
    fstates, fps = fcell
    fnames = [f"pod{p:03d}-rsw{i:02d}" for p in range(FABRIC_POD_VANTAGES)
              for i in range(FABRIC["rsws_per_pod"])]
    mesh = c.sharding.make_mesh(MC_SHARDS, devices=devices)
    fsolver = gs.GpuSpfSolver(fnames[0], device=dev, enable_lfa=True,
                              multichip_devices=devices)
    f_dbs, st, launches = fabric_build(c, fsolver, fstates, fps, fnames,
                                       mesh)
    for k, v in launches.items():
        windows["fabric_mesh"][k] = v
    log("whole-fabric fabric10k on the mesh: " + json.dumps(st))
    for name in MESH_FABRIC_PATH:
        check(launches[name] > 0,
              f"kernel {name} never launched on the mesh fabric path")
    for nm in FABRIC_ORACLE:
        want = c.SpfSolver(nm, enable_lfa=True).build_route_db(nm, fstates,
                                                               fps)
        check(rib_equal(want, f_dbs[nm]), f"fabric10k mesh: {nm} != oracle")
    del f_dbs
    fad = fsolver._area_dev["0"]
    roots, nbr, w, _ = c.fabric.root_tables(fad.plan, fstates["0"], fnames)
    bv4 = block_v4(fsolver)
    t0 = time.perf_counter()
    got = c.sharding.sharded_fabric_step(mesh, fad.plan, fad.matrix, roots,
                                         nbr, w, st["n_trips"], lfa=True,
                                         block_v4=bv4, with_ok=True)
    torch.cuda.synchronize()
    mesh_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = c.sharding.sharded_fabric_step(None, fad.plan, fad.matrix, roots,
                                          nbr, w, st["n_trips"], lfa=True,
                                          block_v4=bv4, with_ok=True,
                                          device=dev)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    check(max_abs_err(torch, got, want) == 0,
          "fabric10k: the mesh step's arrays != the one-card step's")
    log(f"fabric10k: sharded_fabric_step on {mesh!r} == the one-card step, "
        f"all seven arrays over {len(fnames)} roots (host wall {mesh_ms:.1f}"
        f" ms, one card {one_ms:.1f} ms)")
    del got, want
    mesh_fabric_kernels(c, fsolver, fnames, fstates)

    # -- tg1k-lfa on a 6-shard mesh: graph 3, the node axis padded ------------
    adj_l, pdb_l = c.topologies.grid(TG1K_SIDE, node_labels=False)
    _, lstates, lps = build_cell(
        c.topologies, lambda: (seeded_metrics(adj_l, LFA_SEED,
                                              LFA_METRIC_MAX), pdb_l))
    n6, b6 = MC_LFA_SHARDS
    mesh6 = c.sharding.make_mesh(n6, batch=b6, devices=[dev] * n6)
    lsolver = gs.GpuSpfSolver("node-0-0", device=dev, enable_lfa=True)
    lnames = sorted(lstates["0"].get_adjacency_databases())
    l_dbs = lsolver.build_fabric_route_dbs(lnames, lstates, lps, mesh=mesh6)
    lad = lsolver._area_dev["0"]
    lroots, lnbr, lw, _ = c.fabric.root_tables(lad.plan, lstates["0"],
                                               lnames)
    n_trips = lsolver.last_fabric_stats["n_trips"]
    got = c.sharding.sharded_fabric_step(mesh6, lad.plan, lad.matrix, lroots,
                                         lnbr, lw, n_trips, lfa=True,
                                         with_ok=True)
    want = c.sharding.sharded_fabric_step(None, lad.plan, lad.matrix, lroots,
                                          lnbr, lw, n_trips, lfa=True,
                                          with_ok=True, device=dev)
    n_cap = lad.plan.n_cap
    check(got[0].shape[1] == -(-n_cap // 3) * 3 and max_abs_err(
        torch, (got[0][:, :n_cap],) + got[1:], want) == 0,
        "tg1k-lfa: the graph-3 mesh step != the one-card step")
    backups = int((got[4] >= 0).sum())
    check(backups > 0, "tg1k-lfa on the mesh: no LFA backup")
    for nm in lnames[::LFA_ORACLE_EVERY]:
        ref = c.SpfSolver(nm, enable_lfa=True).build_route_db(nm, lstates,
                                                              lps)
        check(rib_equal(ref, l_dbs[nm]), f"tg1k-lfa mesh: {nm} != oracle")
    log(f"tg1k-lfa on {mesh6!r}: node axis {n_cap} -> {got[0].shape[1]}, "
        f"the step == the one-card step, {backups} rows with an LFA backup, "
        f"every {LFA_ORACLE_EVERY}th RIB == the LFA oracle")
    del got, want, l_dbs

    # -- the dry run, and a mesh of real cards -----------------------------------
    c.entry.dryrun_multichip(MC_SHARDS, device=dev)  # prints its line
    cards = torch.cuda.device_count()
    if cards >= 2:
        real = gs.GpuSpfSolver(root, device=dev,
                               multichip_n_cap_threshold=MC_THRESHOLD)
        db = real.build_route_db(root, states, ps)
        logical = gs.GpuSpfSolver(root, **kw)
        want = logical.build_route_db(root, states, ps)
        check(max_abs_err(torch, resident_outputs(real, root),
                          resident_outputs(logical, root)) == 0
              and rib_equal(want, db),
              "lsdb100k_mc on the cards != on logical shards")
        log(f"lsdb100k_mc on {real._area_dev['0'].mc_mesh!r} == the logical "
            f"shards")
    else:
        log(f"one card visible: lsdb100k_mc on a mesh of real cards (NCCL "
            f"combine) not run")
    return windows, halo


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from openr_tpu_torch.decision import gpu_solver, whatif
    from openr_tpu_torch.decision.spf_solver import SpfSolver
    from openr_tpu_torch.models import topologies
    from openr_tpu_torch import entry
    from openr_tpu_torch.ops import (
        combine,
        compact,
        csr,
        cuda,
        fabric,
        incremental,
        ksp2,
        legacy,
        relax,
        select,
        stream,
        sweep,
        te,
        ucmp,
    )
    from openr_tpu_torch.parallel import sharding
    from openr_tpu_torch.runtime.counters import counters
    from openr_tpu_torch.types import (
        AdjacencyDatabase,
        PrefixDatabase,
        PrefixEntry,
        PrefixForwardingAlgorithm,
    )

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
                              "openr_tpu/ops/relax.py:227"),
        "K2:ladder_pass": (relax.ladder_pass, "relax.cu",
                           "openr_tpu/ops/relax.py:235"),
        "K3:select_routes": (select.select_routes, "select.cu",
                          "openr_tpu/decision/tpu_solver.py:511"),
        "K4:compact_outputs": (compact.compact_outputs, "compact.cu",
                            "openr_tpu/ops/stream.py:79"),
        "K5:scatter_set": (incremental.scatter_set, "incremental.cu",
                           "openr_tpu/decision/tpu_solver.py:1097"),
        "K5:old_plane": (incremental.old_plane, "incremental.cu",
                         "openr_tpu/ops/incremental.py:51"),
        "K6:parent_plane": (incremental.parent_plane, "incremental.cu",
                            "openr_tpu/ops/incremental.py:74"),
        "K7:cone_seed": (incremental.cone_seed, "incremental.cu",
                         "openr_tpu/ops/incremental.py:128"),
        "K8+K9:cone_resolve": (incremental.cone_resolve, "incremental.cu",
                               "openr_tpu/ops/incremental.py:128"),
        "K9:cone_finish": (incremental.cone_finish, "incremental.cu",
                           "openr_tpu/parallel/sharding.py:654"),
        "base_sssp": (ksp2.base_sssp, "relax.cu", "openr_tpu/ops/ksp2.py:128"),
        "ucmp_propagate": (ucmp.ucmp_propagate, "ucmp.cu",
                           "openr_tpu/ops/ucmp.py:54"),
        "K10:overlay_planes": (ksp2.overlay_planes, "ksp2.cu",
                               "openr_tpu/ops/ksp2.py:144"),
        "K11:masked_delta": (ksp2.masked_delta, "ksp2.cu",
                             "openr_tpu/ops/ksp2.py:163"),
        "K12:sweep_verdicts": (sweep.sweep_verdicts, "sweep.cu",
                               "openr_tpu/ops/sweep.py:59"),
        "K13:te_relax": (te.te_relax, "te.cu", "openr_tpu/ops/sweep.py:204"),
        "K14:te_relax_vjp": (te.te_relax_vjp, "te.cu",
                             "openr_tpu/ops/sweep.py:227"),
        "K14s:te_link_sum": (te.te_link_sum, "te.cu",
                             "openr_tpu/ops/sweep.py:227"),
        "K17:te_loss": (te.te_loss, "te.cu", "openr_tpu/ops/sweep.py:229"),
        "K15:te_relax_jvp": (te.te_relax_jvp, "te.cu",
                             "openr_tpu/ops/sweep.py:233"),
        "K16:te_relax_vjp_jvp": (te.te_relax_vjp_jvp, "te.cu",
                                 "openr_tpu/ops/sweep.py:233"),
        "K18:ell_relax": (legacy.ell_trip, "legacy.cu",
                          "openr_tpu/decision/tpu_solver.py:177"),
        "K18t:ell_transpose": (legacy.ell_transpose, "legacy.cu",
                               "openr_tpu/decision/tpu_solver.py:282"),
        "K19:ell_next_hop": (legacy.ell_next_hop, "legacy.cu",
                             "openr_tpu/decision/tpu_solver.py:197"),
        "K20:ell_select": (legacy.ell_select, "legacy.cu",
                           "openr_tpu/decision/tpu_solver.py:225"),
        "K21:fabric_relax": (fabric.fabric_relax, "fabric.cu",
                             "openr_tpu/parallel/sharding.py:104"),
        "K21e:fabric_extent": (fabric.fabric_extent, "fabric.cu",
                               "openr_tpu/ops/relax.py:148"),
        "K22:unpack_bits": (fabric.unpack_bits, "fabric.cu",
                            "openr_tpu/parallel/sharding.py:213"),
        "K1s:sssp_init_mc": (relax.sssp_init_mc, "relax.cu",
                             "openr_tpu/parallel/sharding.py:378"),
        "K1:relax_step_mc": (relax.relax_step_mc, "relax.cu",
                             "openr_tpu/parallel/sharding.py:414"),
        "K2:ladder_classes_mc": (relax.ladder_classes_mc, "relax.cu",
                                 "openr_tpu/parallel/sharding.py:402"),
        "K5:scatter_parts": (incremental.scatter_parts, "incremental.cu",
                             "openr_tpu/decision/tpu_solver.py:1113"),
        "K5:scatter_window": (incremental.scatter_window, "incremental.cu",
                              "openr_tpu/parallel/sharding.py:494"),
        "K6:parent_shift_mc": (incremental.parent_shift_mc, "incremental.cu",
                               "openr_tpu/parallel/sharding.py:527"),
        "K6:parent_fill": (incremental.parent_fill, "incremental.cu",
                           "openr_tpu/parallel/sharding.py:552"),
        "K7:owned_weights": (incremental.owned_weights, "incremental.cu",
                             "openr_tpu/parallel/sharding.py:575"),
        "K7:cone_seed_mc": (incremental.cone_seed_mc, "incremental.cu",
                            "openr_tpu/parallel/sharding.py:581"),
        "K21:fabric_relax_mc": (fabric.fabric_relax_mc, "fabric.cu",
                                "openr_tpu/parallel/sharding.py:104"),
        "K23:shard_combine": (combine.shard_combine, "combine.cu",
                              "openr_tpu/parallel/sharding.py:420"),
    }
    cold_path = list(COLD_PATH)
    # variants of a kernel: (the wrapper's entry, what it replaces); their
    # launches are the wrapper's counts on the path that runs the variant
    variants = {
        "K3:select_routes[lfa]": ("K3:select_routes",
                                  "openr_tpu/decision/tpu_solver.py:533"),
        "K4:compact_outputs[lfa]": ("K4:compact_outputs",
                                    "openr_tpu/ops/stream.py:99"),
        **{f"{n}[fused]": (n, "openr_tpu/decision/tpu_solver.py:693")
           for n in cold_path},
        "K4:compact_outputs[stream]": ("K4:compact_outputs",
                                       "openr_tpu/decision/tpu_solver.py:826"),
        "K1:relax_step[residual]": ("K1:relax_step",
                                    "openr_tpu/ops/relax.py:119"),
        "K1:relax_step[ksp2]": ("K1:relax_step", "openr_tpu/ops/ksp2.py:144"),
        "K1:relax_step[sweep]": ("K1:relax_step", "openr_tpu/ops/sweep.py:59"),
        "K10:overlay_planes[sweep]": ("K10:overlay_planes",
                                      "openr_tpu/ops/sweep.py:59"),
        "K18:ell_relax[allpairs]": ("K18:ell_relax",
                                    "openr_tpu/decision/tpu_solver.py:282"),
        "K1s:sssp_init[fabric]": ("K1s:sssp_init",
                                  "openr_tpu/parallel/sharding.py:115"),
        "K3:select_routes[fabric]": ("K3:select_routes",
                                     "openr_tpu/parallel/sharding.py:149"),
        "K2:ladder_pass[mc]": ("K2:ladder_pass",
                               "openr_tpu/parallel/sharding.py:402"),
        "K23:shard_combine[groups]": ("K23:shard_combine",
                                      "openr_tpu/parallel/sharding.py:420"),
    }
    variant_launches: dict = {}
    results = {}

    def record(name, err, fn, plain, nbytes, ops, reps=50, plain_reps=5,
               library=None, plain_warmup=2, per=1):
        """Hold ``name`` to its plain version and time both; with ``per``
        > 1 a call of ``fn`` does ``per`` rounds, ``nbytes`` / ``ops``
        are a round's, and every ms is a round's (a call's beside it as
        ``call_ms`` / ``plain_call_ms``)."""
        check(err == 0, f"{name}: kernel != plain (max abs err {err})")
        b_ms, b_by = bound(nbytes, ops)
        call_ms = time_ms(torch, fn, reps)
        plain_call_ms = time_ms(torch, plain, plain_reps, plain_warmup)
        results[name] = {
            "max_abs_err": err,
            "ms": call_ms / per,
            "plain_ms": plain_call_ms / per,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None if library is None
            else time_ms(torch, library, reps) / per,
        }
        if per > 1:
            results[name].update(rounds_a_call=per, call_ms=call_ms,
                                 plain_call_ms=plain_call_ms)
        log(f"{name}: equal; {json.dumps(results[name])}")

    def record_float(name, err, rel_err, fn, plain, nbytes, ops, reps=10,
                     plain_reps=1):
        """``record`` for a float32 kernel: ``err`` / ``rel_err`` its
        largest absolute / relative difference from its plain version,
        already held to its tolerance."""
        b_ms, b_by = bound(nbytes, ops)
        results[name] = {
            "max_abs_err": err,
            "max_rel_err": rel_err,
            "ms": time_ms(torch, fn, reps),
            "plain_ms": time_ms(torch, plain, plain_reps),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        }
        log(f"{name}: within tolerance; {json.dumps(results[name])}")

    def zero_counts():
        for fn, _, _ in wrappers.values():
            fn.launches = 0
        return relax.read_flag.reads

    def read_counts(reads0):
        return ({name: fn.launches for name, (fn, _, _) in wrappers.items()},
                relax.read_flag.reads - reads0)

    def split(name, fn, library=None, floor=None) -> None:
        """The wrapper's time split: the kernel alone on the device and
        the host's enqueue (``device_ms``), the same for the library
        call, and the host cost of the bare ``cuda.launch`` (ctypes and
        the CUDA launch, no argument checks): the floor a wrapper call
        cannot go under."""
        r = results[name]
        r["device_ms"], r["host_ms"] = device_ms(torch, fn)
        if library is not None:
            r["library_device_ms"], r["library_host_ms"] = device_ms(
                torch, library)
        if floor is not None:
            r["launch_floor_host_ms"] = device_ms(torch, floor)[1]
        log(f"{name} split: " + json.dumps(
            {k: v for k, v in r.items() if k.endswith("_ms")}))

    c = types.SimpleNamespace(
        torch=torch, dev=dev, gpu_solver=gpu_solver, relax=relax,
        compact=compact, stream=stream, ksp2=ksp2, ucmp=ucmp, sweep=sweep,
        whatif=whatif, variant_launches=variant_launches,
        te=te, record_float=record_float, legacy=legacy, fabric=fabric,
        csr=csr, sharding=sharding, select=select, combine=combine,
        incremental=incremental, entry=entry, cuda=cuda,
        topologies=topologies, SpfSolver=SpfSolver,
        AdjacencyDatabase=AdjacencyDatabase, PrefixDatabase=PrefixDatabase,
        PrefixEntry=PrefixEntry,
        PrefixForwardingAlgorithm=PrefixForwardingAlgorithm,
        wrappers=wrappers, record=record, split=split, results=results,
        zero_counts=zero_counts, read_counts=read_counts,
    )

    log(f"-- phase 2 starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    # -- 2. small cells: RIB parity, residual relaxation; also loads every
    # kernel's module, so the main path's first build times the solve ---------------------
    cells = [
        ("tg1k", lambda: topologies.grid(32, node_labels=False),
         "node-16-16"),
        ("fabric10k", lambda: topologies.fabric(**FABRIC), "pod000-rsw00"),
    ]
    for name, gen, me in cells:
        c_dbs, c_states, c_ps = build_cell(topologies, gen)
        lfa = name == "fabric10k"
        c_solver = gpu_solver.GpuSpfSolver(me, device=dev, enable_lfa=lfa)
        reads0 = zero_counts()
        got_db = c_solver.build_route_db(me, c_states, c_ps)
        torch.cuda.synchronize()
        c_launches, c_reads = read_counts(reads0)
        t0 = time.perf_counter()
        want_db = SpfSolver(me, enable_lfa=lfa).build_route_db(
            me, c_states, c_ps)
        t_oracle = (time.perf_counter() - t0) * 1e3
        check(rib_equal(want_db, got_db), f"{name}: RIB != oracle")
        tm = c_solver.last_timing
        c_ad = c_solver._area_dev["0"]
        n_lfa = sum(bool(r.lfa_nexthops)
                    for r in want_db.unicast_routes.values())
        log(f"{name}: RIB == oracle ({len(want_db.unicast_routes)} routes, "
            f"{n_lfa} with an LFA backup, oracle {t_oracle:.0f} ms): "
            + json.dumps({
                "lfa": lfa, "k_res": c_ad.plan.k_res,
                "launches": c_launches, "flag_reads": c_reads,
                **{k: tm.get(k) for k in (
                    "spf_kernel", "trips", "rounds", "sssp_ms", "tail_ms",
                    "compact_ms", "pipeline_wall_ms")},
            }))
        if name == "tg1k":
            tg1k_tail(c, c_solver, c_states, me)
        if lfa:
            for v in ("K3:select_routes[lfa]", "K4:compact_outputs[lfa]"):
                variant_launches[v] = c_launches[variants[v][0]]
                check(variant_launches[v] > 0,
                      f"{v} never launched on the fabric10k LFA path")
            lfa_kernels(torch, relax, select, compact, gpu_solver, record,
                        split, wrappers, c_solver, c_states, me)
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
            # the row of K1 with a residual: one step on that wavefront
            r_dc, r_nc = plane.shape
            r_sc = c_sw.shape[0]
            r_ell = c_res[1].numel()
            record(
                "K1:relax_step[residual]",
                max_abs_err(torch, (o_k, fk), (o_p, fp)),
                lambda: relax.relax_step(plane, o_k, fk, c_ad.deltas, c_sw,
                                         c_res),
                lambda: relax.relax_step_plain(plane, o_p, fp, c_ad.deltas,
                                               c_sw, c_res),
                nbytes=4 * (2 * r_dc * r_nc + r_sc * r_nc + r_sc
                            + c_res[0].numel() + 2 * r_ell),
                ops=2 * r_dc * (r_nc * r_sc + r_ell))
            split("K1:relax_step[residual]",
                  lambda: relax.relax_step(plane, o_k, fk, c_ad.deltas, c_sw,
                                           c_res),
                  floor=k1_floor(cuda, plane, o_k, fk, c_ad.deltas, c_sw,
                                 c_res))
            one_launch(torch, wrappers, "K1 with the residual",
                       lambda: relax.relax_step(plane, o_k, fk, c_ad.deltas,
                                                c_sw, c_res))
            variant_launches["K1:relax_step[residual]"] = c_launches[
                "K1:relax_step"]
            # the incremental kernels' residual branches (lsdb100k has no
            # residual): one flap of adj_dbs[1] — a fabric switch of the
            # root's pod, whose links sit in the residual ELL
            c_inc = gpu_solver.GpuSpfSolver(me, device=dev,
                                            incremental_spf=True,
                                            enable_lfa=lfa)
            c_inc.build_route_db(me, c_states, c_ps)
            flap(AdjacencyDatabase, c_states, c_dbs,
                 {db.this_node_name: db for db in c_dbs}, 1, 0)
            got_db = c_inc.build_route_db(me, c_states, c_ps)
            st = c_inc.last_device_stats
            check(st.get("incremental") and not st.get("fell_back"),
                  f"{name}: the flap must take the incremental solve")
            check(rib_equal(c_solver.build_route_db(me, c_states, c_ps),
                            got_db), f"{name}: incremental RIB != cold")
            check(rib_equal(SpfSolver(me, enable_lfa=lfa).build_route_db(
                me, c_states, c_ps), got_db),
                f"{name}: incremental RIB != oracle")
            ci = churn_inputs(relax, incremental, c_inc)
            r_lim = c_plan.res_nbr.size
            check(int(((ci["rdi"] >= 0) & (ci["rdi"] < r_lim)).sum()) > 0,
                  f"{name}: the flap must dirty residual slots")
            # each old plane, the residual's (its mask keyed on res_nbr)
            # included, on the flap's own dirty lists
            err = max(
                *(max_abs_err(torch, incremental.old_plane(*oa),
                              incremental.old_plane_plain(*oa))
                  for oa in ci["oargs"]),
                max_abs_err(torch, ci["par"],
                            incremental.parent_plane_plain(*ci["pargs"])),
                max_abs_err(torch, incremental.cone_seed(*ci["cargs"]),
                            incremental.cone_seed_plain(*ci["cargs"])),
            )
            check(len(ci["oargs"]) == 2 and err == 0,
                  f"{name}: the old planes / K6 / K7 with the residual != "
                  f"plain")
            whole_incremental(torch, incremental, ci)
            log(f"{name}: incremental solve after a flap equal to the cold "
                f"solve and the oracle; the old planes, K6, K7 with the "
                f"residual and the "
                f"whole {ci['whole'][1]['kernel']} incremental SSSP equal "
                f"to plain: " + json.dumps({
                    k: st.get(k) for k in ("cone", "cone_trips", "trips",
                                           "rounds", "changed_rows")}))

    log(f"-- phase 2b starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    # -- 2b. the fused path: 4 same-shape areas in one dispatch ------------
    fused_phase(torch, gpu_solver, relax, select, compact, SpfSolver,
                topologies, counters, (AdjacencyDatabase, PrefixDatabase,
                                       PrefixEntry), dev, wrappers,
                variants, variant_launches, record, zero_counts, read_counts)

    log(f"-- phase 3 starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    # -- 3. main path: lsdb100k cold solve x3 -------------------------------
    t0 = time.perf_counter()
    adj_dbs, states, ps = build_cell(
        topologies, lambda: topologies.grid(LSDB100K_SIDE, node_labels=False)
    )
    ls = states["0"]
    log(f"lsdb100k: {ls.node_count()} nodes, "
        f"{len(ps.prefixes())} prefixes, host build "
        f"{(time.perf_counter() - t0):.1f} s")
    solver = gpu_solver.GpuSpfSolver(LSDB100K_ROOT, device=dev)
    zero_counts()
    dbs = []
    gc.collect()  # as before the fused build (phase 2b)
    for i in range(3):
        with HostMeter() as meter:
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
            "host": meter.result,
        })))
    launches = {name: wrappers[name][0].launches for name in cold_path}
    log(f"lsdb100k launches over 3 builds: {json.dumps(launches)}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    check(solver.last_timing["spf_kernel"] == "bucketed",
          "lsdb100k must run the bucketed kernel")

    log(f"-- phase 4 starts at "
        f"{time.perf_counter() - t_start:.1f} s")
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

    log(f"-- phase 5 starts at "
        f"{time.perf_counter() - t_start:.1f} s")
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
    args = (ad.shift_w, ad.res_rows, ad.res_nbr, ad.res_w, root, root_nbr,
            root_w)
    got = relax.sssp_init(*args)
    want = relax.sssp_init_plain(*args)
    # the row times K1s as the churn and storm solves call it, into held
    # outputs (205 of the main path's 208 calls); the cold solve's
    # allocating call is split beside it below
    held = relax.init_outputs(*args[:4], root_nbr, n_cap)
    relax.sssp_init(*args, out=held)
    res_bytes = 4 * (ad.res_rows.numel() + 2 * ad.res_nbr.numel())
    record(
        "K1s:sssp_init", max_abs_err(torch, (got[0], *got[1], got[2], held[0],
                                             *held[1], held[2]),
                                     (want[0], *want[1], want[2]) * 2),
        lambda: relax.sssp_init(*args, out=held),
        lambda: relax.sssp_init_plain(*args),
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
    # K1s as the churn and storm solves call it (into held outputs), and
    # as the cold solve does (allocating); K1 on the wavefront
    split("K1s:sssp_init", lambda: relax.sssp_init(*args, out=held),
          floor=k1s_floor(cuda, args, held, n_cap))
    r = results["K1s:sssp_init"]
    r["alloc_ms"] = time_ms(torch, lambda: relax.sssp_init(*args), 50)
    r["alloc_device_ms"], r["alloc_host_ms"] = device_ms(
        torch, lambda: relax.sssp_init(*args))
    split("K1:relax_step",
          lambda: relax.relax_step(mid, out_k, f_k, ad.deltas, sw, residual),
          floor=k1_floor(cuda, mid, out_k, f_k, ad.deltas, sw, residual))
    k1_launches = {
        "K1s held": held_launch(torch, wrappers, "K1s held", lambda: (
            relax.sssp_init(*args, out=held))),
        "K1": one_launch(torch, wrappers, "K1", lambda: relax.relax_step(
            mid, out_k, f_k, ad.deltas, sw, residual))}
    cases = relax_cases(c)
    for label, err in cases.items():
        check(err == 0, f"{label}: kernel != plain (max abs err {err})")
    results["K1s:sssp_init"]["cases"] = sorted(
        k for k in cases if k.startswith("K1s"))
    results["K1:relax_step"]["cases"] = sorted(
        k for k in cases if k.startswith("K1 "))
    log("K1s and K1 launches: " + json.dumps(k1_launches) + "; equal to "
        "plain at the edge cases, each call one launch: "
        + json.dumps(cases))

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
    # a pass on the wavefront: 3 passes, each on the rung the last doubled
    pa, pb = mid.clone(), torch.empty_like(mid)
    w2_k, d2_k = torch.empty_like(w_k), torch.empty_like(dd_k)
    record(
        "K2:ladder_pass", pass_check(torch, relax, mid, w_k, dd_k),
        lambda: relax.ladder_pass(pa, pb, w_k, dd_k, w2_k, d2_k, f_k),
        lambda: relax.ladder_pass_plain(pa, pb, w_k, dd_k, w2_k, d2_k, f_p),
        # the plane, the rung rows and shifts read once, the result plane
        # and the next rung written once
        nbytes=4 * (2 * d_cap * n_cap + 2 * s_lad * n_cap + 2 * s_lad),
        ops=2 * s_lad * d_cap * n_cap + 2 * s_lad * n_cap,
    )
    part = torch.empty(s_cap * relax.PICK_BLOCKS, dtype=torch.int32,
                       device=dev)
    pick_ptrs = [t.data_ptr() for t in (sw, ad.deltas, part, w2_k, d2_k)]
    split("K2:ladder_classes",
          lambda: relax.ladder_classes(sw, ad.deltas, dq, s_lad),
          floor=lambda: cuda.launch("relax", "ladder_pick", "pppppiiiiiii",
                                    *pick_ptrs, s_cap, s_lad, n_cap, dq, 1,
                                    0, n_cap))
    pass_ptrs = [t.data_ptr() for t in (pa, pb, w_k, dd_k, w2_k, d2_k)]
    split("K2:ladder_pass",
          lambda: relax.ladder_pass(pa, pb, w_k, dd_k, w2_k, d2_k, f_k),
          floor=lambda: cuda.launch(
              "relax", "ladder_pass", "ppppppiiipipp" + "i" * 6,
              *pass_ptrs, s_lad, d_cap, n_cap, f_k.data_ptr(), 1, 0, 0,
              0, 0, 0, 0, 0, 0))
    # each is one launch and no torch op on the card
    pick_only = counted(torch, wrappers, lambda: relax.ladder_classes(
        sw, ad.deltas, dq, s_lad))
    pass_only = counted(torch, wrappers, lambda: relax.ladder_pass(
        pa, pb, w_k, dd_k, w2_k, d2_k, f_k))
    for label, n in (("class pick", pick_only), ("ladder pass", pass_only)):
        check(n["launches"] == n["kernel_launches"] == 1,
              f"K2's {label} must be one launch and no torch op: {n}")
    log("K2 launches: " + json.dumps({"ladder_classes": pick_only,
                                      "ladder_pass": pass_only}))

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
        plan.delta_exp, relax.ladder_classes_plain, relax.ladder_pass_plain,
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
                    + p_cap * (1 + wa + wd)) + p_cap,
        ops=3 * d_cap * n_cap + 12 * p_cap * a_cap,
    )
    split("K3:select_routes", lambda: select.select_routes(*sel),
          floor=k3_floor(torch, cuda, sel))
    tail_launches = {"K3": one_launch(torch, wrappers, "K3",
                                      lambda: select.select_routes(*sel))}
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
        tail_launches["K4"] = one_launch(
            torch, wrappers, "K4", lambda: compact.compact_outputs(*cargs))
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
    split("K4:compact_outputs", lambda: compact.compact_outputs(*cargs),
          floor=k4_floor(torch, cuda, cargs))
    stream_kernel(c, metric, s3w, nhw, ok, flags, wa, wd, a_cap)
    edge = tail_edge_shapes(c)
    edge["K4 past the tile cache, lanes"] = k4_past_cache(c)
    log("K3 and K4 launches: " + json.dumps(tail_launches) + "; equal to "
        "plain at the edge shapes, each call one launch: "
        + json.dumps(edge))

    log(f"-- phase 6 starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    # -- 6. the churn path: incremental solves at lsdb100k ------------------
    by_name = {db.this_node_name: db for db in adj_dbs}
    inc_solver = gpu_solver.GpuSpfSolver(LSDB100K_ROOT, device=dev,
                                         incremental_spf=True)
    cold_solver = gpu_solver.GpuSpfSolver(LSDB100K_ROOT, device=dev)
    db = inc_solver.build_route_db(LSDB100K_ROOT, states, ps)
    check(rib_equal(oracle, db), "churn solver's first build RIB != oracle")
    check(not inc_solver.last_device_stats.get("incremental"),
          "a vantage's first build must be the cold solve")
    cold_solver.build_route_db(LSDB100K_ROOT, states, ps)
    # the bytes a churn step re-uploaded before the device scatter: the
    # touched weight plane, whole
    whole_plane = inc_solver._area_dev["0"].shift_w.numel() * 4
    churn_launches = dict.fromkeys(wrappers, 0)
    steps = []

    def churn_step(solver, i: int, label: str, with_oracle: bool) -> dict:
        metric = flap(AdjacencyDatabase, states, adj_dbs, by_name, 1, i)
        for fn, _, _ in wrappers.values():
            fn.launches = 0
        reads0 = relax.read_flag.reads
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = solver.build_route_db(LSDB100K_ROOT, states, ps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        reads = relax.read_flag.reads - reads0
        n = {name: fn.launches for name, (fn, _, _) in wrappers.items()}
        for k, v in n.items():
            churn_launches[k] += v
        tm, st = solver.last_timing, solver.last_device_stats
        want = cold_solver.build_route_db(LSDB100K_ROOT, states, ps)
        check(rib_equal(want, got), f"churn {label}: RIB != cold solve")
        if with_oracle:
            ref = SpfSolver(LSDB100K_ROOT).build_route_db(
                LSDB100K_ROOT, states, ps)
            check(rib_equal(ref, got), f"churn {label}: RIB != oracle")
        rec = {
            "metric": metric, "build_ms": wall,
            **{k: tm.get(k) for k in (
                "sync_ms", "exec_ms", "scatter_ms", "old_planes_ms",
                "parent_ms", "cone_ms", "sssp_ms", "tail_ms", "compact_ms",
                "pull_ms", "unpack_ms", "bytes_uploaded",
                "bytes_downloaded")},
            "whole_plane_bytes": whole_plane,
            **{k: st.get(k) for k in (
                "incremental", "fell_back", "cone", "cone_trips", "trips",
                "rounds", "changed_rows")},
            "launches": sum(n.values()),
            "launches_by_kernel": {k: v for k, v in n.items() if v},
            "flag_reads": reads,
            "oracle_checked": with_oracle,
        }
        log(f"lsdb100k churn {label}: {json.dumps(rec)}")
        steps.append(rec)
        return rec

    for i in range(CHURN_STEPS):
        rec = churn_step(inc_solver, i, f"step {i}",
                         i in (0, CHURN_STEPS - 1))
        check(rec["incremental"] is True and rec["fell_back"] is False,
              f"churn step {i} must be incremental without fallback")
        check(rec["bytes_uploaded"] < whole_plane,
              f"churn step {i} uploaded a whole plane")
    fb_solver = gpu_solver.GpuSpfSolver(
        LSDB100K_ROOT, device=dev, incremental_spf=True,
        incremental_cone_frac=0.0,
    )
    fb_solver.build_route_db(LSDB100K_ROOT, states, ps)  # its cold build
    rec = churn_step(fb_solver, CHURN_STEPS, "fallback step", False)
    check(rec["incremental"] is True and rec["fell_back"] is True
          and rec["cone"] > 0,
          "the cone_frac=0 step must fall back on the device")
    log(f"lsdb100k churn launches over {CHURN_STEPS + 1} steps: "
        f"{json.dumps(churn_launches)}")
    for name in CHURN_PATH:
        check(churn_launches[name] > 0,
              f"kernel {name} never launched on the churn path")

    log(f"-- phase 7 starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    # -- 7. the churn kernels against their plain versions -----------------
    ci = churn_inputs(relax, incremental, inc_solver)
    (i_deltas, i_shift, i_rows, i_nbr, i_resw, i_mbuf, i_root, i_rnbr,
     i_rw) = ci["lane"]
    # the K1s outputs the churn solver holds: the last flap step's,
    # written in place, never its distance plane
    vs = inc_solver._vstates[("0", LSDB100K_ROOT)]
    check(vs.init is not None, "the churn solves must hold K1s's outputs")
    want = relax.sssp_init_plain(*on_cpu((i_shift, i_rows, i_nbr, i_resw)),
                                 int(i_root), *on_cpu((i_rnbr, i_rw)))
    h_sw, h_res, h_d0 = vs.init
    check(max_abs_err(torch, on_cpu((h_sw, *h_res, h_d0)),
                      (want[0], *want[1], want[2])) == 0,
          "the held K1s outputs != plain on the last flap step")
    check(vs.prev_dist.untyped_storage().data_ptr() not in {
        t.untyped_storage().data_ptr() for t in (h_sw, *h_res, h_d0)},
          "a held K1s output aliases the vantage's prev_dist")
    sdi, sdo, prev_dist = ci["sdi"], ci["sdo"], ci["prev_dist"]
    has_res = ci["has_res"]
    cap = sdi.numel()
    s_live = (sdi >= 0) & (sdi < s_cap * n_cap)
    n_live = int(s_live.sum())
    check(n_live > 0, "the last flap step must carry dirty slots")

    old_k, old_p, scratch = (i_shift.clone() for _ in range(3))
    incremental.scatter_set(old_k, sdi, sdo)
    incremental.scatter_set_plain(old_p, sdi, sdo)
    idx_live, vals_live = sdi[s_live].long(), sdo[s_live]
    record(
        "K5:scatter_set", max_abs_err(torch, old_k, old_p),
        lambda: incremental.scatter_set(scratch, sdi, sdo),
        lambda: incremental.scatter_set_plain(scratch, sdi, sdo),
        nbytes=4 * (2 * cap + n_live), ops=2 * cap,
        library=lambda: scratch.view(-1).index_copy_(0, idx_live, vals_live),
    )
    k5_ptrs = [t.data_ptr() for t in (scratch, sdi, sdo)]
    split("K5:scatter_set",
          lambda: incremental.scatter_set(scratch, sdi, sdo),
          lambda: scratch.view(-1).index_copy_(0, idx_live, vals_live),
          lambda: cuda.launch("incremental", "scatter_set", "pppiipppii",
                              *k5_ptrs, cap, scratch.numel(), 0, 0, 0, 0,
                              0))
    # both planes in one launch: the flap's slots and as many seeded
    # slots of a residual ELL of fabric10k's shape (8192 x 128)
    gen = torch.Generator().manual_seed(52)
    res_b = torch.randint(0, 99, (8192, 128), generator=gen,
                          dtype=torch.int32).to(dev)
    rb_idx = torch.randperm(res_b.numel(), generator=gen)[:cap].to(
        torch.int32).to(dev)
    rb_val = torch.randint(1, 99, (cap,), generator=gen,
                           dtype=torch.int32).to(dev)
    pair = (scratch, sdi, sdo, res_b, rb_idx, rb_val)
    one_launch(torch, wrappers, "K5 both planes",
               lambda: incremental.scatter_set(*pair))
    r5 = results["K5:scatter_set"]
    r5["pair_ms"] = time_ms(torch, lambda: incremental.scatter_set(*pair),
                            50)
    r5["pair_device_ms"], r5["pair_host_ms"] = device_ms(
        torch, lambda: incremental.scatter_set(*pair))
    # the sync's whole K5 step on the host's arrays (a solver of its own,
    # so its events stay out of the churn solver's timing): the staged
    # copy and the launch, one plane (the main path's) and both
    sync_solver = gpu_solver.GpuSpfSolver(LSDB100K_ROOT, device=dev)
    h_idx, h_val = sdi.cpu().numpy(), sdo.cpu().numpy()
    hb_idx, hb_val = rb_idx.cpu().numpy(), rb_val.cpu().numpy()
    sync_one = lambda: sync_solver._scatter_counted(  # noqa: E731
        (scratch, h_idx, h_val))
    sync_two = lambda: sync_solver._scatter_counted(  # noqa: E731
        (scratch, h_idx, h_val), (res_b, hb_idx, hb_val))
    for key, fn in (("sync", sync_one), ("sync_pair", sync_two)):
        r5.update({f"{key}_{k}": v for k, v in step_ms(torch, fn).items()})
        st0 = sync_solver.staging_counts()
        n = counted(torch, wrappers, fn)
        n["staging"] = staging_delta(st0, sync_solver.staging_counts())
        # the one torch op is the staged copy itself
        check(n["kernel_launches"] == 1
              and n["torch_ops_by_name"] == {"aten::_to_copy": 1}
              and n["staging"]["copies"] == 1,
              f"K5 {key}: one launch and one staged copy: {n}")
        r5[f"{key}_counts"] = {k: n[k] for k in (
            "kernel_launches", "torch_ops", "allocations", "staging")}
    log("K5:scatter_set both planes and the sync's step: " + json.dumps(
        {k: v for k, v in r5.items() if k.startswith(("pair", "sync"))}))
    scatter_cases(c)
    staging_cases(c)

    # the old planes: each plane's kernel against its plain version
    errs, o_bytes, o_ops = [], 0, 0
    for oa in ci["oargs"]:
        errs.append(max_abs_err(torch, incremental.old_plane(*oa),
                                incremental.old_plane_plain(*oa)))
        n_idx = oa[1].numel()
        o_bytes += 4 * (2 * oa[0].numel() + 2 * n_idx
                        + (oa[4].numel() if len(oa) > 4 else 0))
        o_ops += 2 * oa[0].numel() + 2 * n_idx
    # the whole of it against the chain it replaced, plain on CPU
    # copies: the unmasked old planes, then K1s's root mask
    odirty = (i_shift, i_resw, sdi, sdo, ci["rdi"], ci["rdo"])
    got = incremental.old_planes(*odirty, has_res, int(i_root), i_nbr)
    o_s, o_r = incremental.old_planes(*on_cpu(odirty), has_res)
    sw_ref, (_, _, rw_ref), _ = relax.sssp_init_plain(
        o_s, *on_cpu((i_rows, i_nbr)), o_r, int(i_root),
        *on_cpu((i_rnbr, i_rw)))
    errs.append(max_abs_err(torch, got[0].cpu(), sw_ref))
    if has_res:
        errs.append(max_abs_err(torch, got[1].cpu(), rw_ref))
    record(
        "K5:old_plane", max(errs),
        lambda: incremental.old_planes(*odirty, has_res, int(i_root), i_nbr),
        lambda: [incremental.old_plane_plain(*oa) for oa in ci["oargs"]],
        nbytes=o_bytes, ops=o_ops,
    )
    split("K5:old_plane", lambda: [incremental.old_plane(*oa)
                                   for oa in ci["oargs"]])

    pargs, par_k = ci["pargs"], ci["par"]
    par_p = incremental.parent_plane_plain(*pargs)
    # the main path's call: into the plane the vantage holds
    par_held = torch.full_like(par_k, -7)

    def k6_held():
        incremental.parent_plane(*pargs, out=par_held)

    held_launch(torch, wrappers, "K6 into the held plane", k6_held)
    record(
        "K6:parent_plane", max(max_abs_err(torch, par_k, par_p),
                               max_abs_err(torch, par_held, par_p)),
        k6_held, lambda: incremental.parent_plane_plain(*pargs),
        nbytes=4 * (2 * d_cap * n_cap + s_cap * n_cap + s_cap)
        + (res_bytes if has_res else 0),
        # every class tried for every word: an upper bound on the work
        ops=4 * d_cap * n_cap * s_cap,
    )
    (p_dl, p_sw, p_rows, p_nbr, p_rw, p_prev) = pargs[:6]
    k6_ptrs = [0 if t is None else t.data_ptr() for t in (
        p_dl, p_sw, p_prev, par_held, *((p_rows, p_nbr, p_rw) if has_res
                                        else (None,) * 3))]
    k6_ints = (s_cap, n_cap, d_cap, 0, n_cap,
               *(p_nbr.shape if has_res else (0, 0)))
    split("K6:parent_plane", k6_held,
          floor=lambda: cuda.launch("incremental", "parent_plane",
                                    "p" * 7 + "i" * 7, *k6_ptrs, *k6_ints))
    results["K6:parent_plane"]["alloc_ms"] = time_ms(
        torch, lambda: incremental.parent_plane(*pargs), 50)
    parent_cases(c)

    cargs, rdi = ci["cargs"], ci["rdi"]
    cargs_k7 = cargs
    aff_k = incremental.cone_seed(*cargs)
    aff_p = incremental.cone_seed_plain(*cargs)
    check(int(aff_k.sum()) > 0, "the last flap step must seed a cone")
    heads, seeds = incremental.cone_seed_entries(*cargs)
    lib_aff = torch.zeros((d_cap, n_cap + 1), dtype=torch.int32, device=dev)
    n_dirty = cap + (rdi.numel() if has_res else 0)
    record(
        "K7:cone_seed", max_abs_err(torch, aff_k, aff_p),
        lambda: incremental.cone_seed(*cargs),
        lambda: incremental.cone_seed_plain(*cargs),
        nbytes=4 * (2 * n_dirty + n_dirty + d_cap * n_dirty
                    + d_cap * n_cap),
        ops=6 * d_cap * n_dirty,
        library=lambda: lib_aff.scatter_reduce_(1, heads, seeds, "amax"),
    )
    # the bare launch into the last call's plane (same arguments)
    (c_par, c_swn, c_rwn, c_dl, c_rows, c_nbr, c_root, c_sdi, c_sdo,
     c_rdi, c_rdo, c_res) = cargs
    r_p = ((c_rwn, c_rows, c_nbr, c_rdi, c_rdo) if c_res else ())
    k7_ptrs = ([t.data_ptr() for t in (c_par, c_swn)] + [0]
               + [t.data_ptr() for t in (c_dl, c_sdi, c_sdo, *r_p)]
               + ([] if c_res else [0] * 5) + [aff_k.data_ptr()])
    k7_ints = (int(c_root), s_cap, n_cap, d_cap, c_sdi.numel(),
               *c_nbr.shape, c_rdi.numel() if c_res else 0)
    split("K7:cone_seed", lambda: incremental.cone_seed(*cargs),
          lambda: lib_aff.scatter_reduce_(1, heads, seeds, "amax"),
          lambda: cuda.launch("incremental", "cone_seed",
                              "ppppppppppppiiiiiiii", *k7_ptrs, *k7_ints))

    # K8 + K9: the cone's closure, count, fallback and seed plane in one
    # launch, on the last flap step's inputs, the fallback step's, a
    # subtree below the root and a deep chain
    c_par, c_seeded, c_rest = cone_args(ci, incremental)
    flap_row, _, _ = cone_case(c, "flap step", c_par, c_seeded, c_rest)
    check(flap_row["cone"] > 0 and not flap_row["fell_back"],
          "the last flap step must re-anchor a cone without fallback")
    fb_ci = churn_inputs(relax, incremental, fb_solver)
    fb_row, _, fb_plane = cone_case(c, "fallback step",
                                    *cone_args(fb_ci, incremental))
    check(fb_row["fell_back"] == 1 and fb_row["cone"] > 0
          and max_abs_err(torch, fb_plane, fb_ci["dist0"]) == 0,
          "cone_resolve: the fallback step's seed != K1s's cold seed")
    sub_row = cone_case(c, "subtree below the root", c_par,
                        subtree_cone(torch, c_par, i_rnbr), c_rest,
                        reps=10)[0]
    ch_par, ch_seeded = deep_chain(torch, c_par, c_seeded)
    ch_row, ch_want, _ = cone_case(
        c, "deep chain", ch_par, ch_seeded,
        (prev_dist, ci["dist0"], i_rnbr, i_rw, d_cap * n_cap,
         relax.max_trips(n_cap)), reps=2)
    check(int(ch_want[0][0].sum()) == n_cap,
          "the deep chain's cone must hold its whole lane")
    cone_err = max(r["max_abs_err"]
                   for r in (flap_row, fb_row, sub_row, ch_row))
    # the row: the flap step. The bound is what the function must move:
    # par, aff, prev (or dist0) read once and the plane written once, at
    # any sweep count; the kernel's own traffic over its s sweeps,
    # (2 s + 3) words a lane-node, is printed beside it
    sweeps = flap_row["sweeps"]
    c_scratch = c_seeded.clone()

    def cone_copy():
        c_scratch.copy_(c_seeded)

    def cone_run():
        cone_copy()
        incremental.cone_resolve(c_par, c_scratch, *c_rest)

    def cone_plain():
        cone_copy()
        incremental.cone_resolve_plain(c_par, c_scratch, *c_rest)

    record(
        "K8+K9:cone_resolve", cone_err, cone_run, cone_plain,
        nbytes=4 * 4 * d_cap * n_cap,
        ops=6 * d_cap * n_cap,
    )
    r = results["K8+K9:cone_resolve"]
    copy_ms = time_ms(torch, cone_copy, 50)
    copy_dev, copy_host = device_ms(torch, cone_copy)
    run_dev, run_host = device_ms(torch, cone_run)
    # the bare launch: the same arguments as raw addresses (on the closed
    # cone the kernel does one sweep; only its host cost is read)
    b_tail = torch.empty(6, dtype=torch.int32, device=dev)
    b_plane = torch.empty_like(prev_dist)
    b_ptrs = [t.data_ptr() for t in (c_par, c_scratch, prev_dist,
                                     ci["dist0"], i_rnbr, i_rw, b_tail,
                                     b_plane)]
    b_ints = (ci["cone_limit"], d_cap, n_cap,
              relax.max_trips(n_cap) * relax.UNROLL)
    r.update(
        ms=r["ms"] - copy_ms, plain_ms=r["plain_ms"] - copy_ms,
        device_ms=run_dev - copy_dev, host_ms=run_host - copy_host,
        launch_floor_host_ms=device_ms(torch, lambda: cuda.launch(
            "incremental", "cone_fix", "p" * 8 + "i" * 4, *b_ptrs,
            *b_ints))[1],
        seed_copy_ms=copy_ms, seed_copy_device_ms=copy_dev,
        seed_copy_host_ms=copy_host, sweeps=sweeps,
        sweep_traffic_ms=bound(4 * (2 * sweeps + 3) * d_cap * n_cap,
                               (3 * sweeps + 3) * d_cap * n_cap)[0])
    log("K8+K9:cone_resolve split (the seeded cone's copy taken off): "
        + json.dumps({k: v for k, v in r.items()
                      if k.endswith("_ms") or k == "sweeps"}))

    # the whole incremental solve: kernels on the card vs the plain
    # versions on CPU copies of the same inputs; and the cold fixpoint
    w_k, t_inc = whole_incremental(torch, incremental, ci)
    d_cold, _, _ = relax.plan_sssp(
        i_deltas, i_shift, i_rows, i_nbr, i_resw, i_root, i_rnbr, i_rw,
        has_res, "bucketed", ci["plan"].delta_exp)
    check(max_abs_err(torch, w_k[0], d_cold) == 0,
          "incremental SSSP: fixpoint != the cold solve's")
    log(f"lsdb100k incremental SSSP equal to plain and to the cold "
        f"fixpoint: cone {int(w_k[2])}, {w_k[1]} epochs / {w_k[4]} rounds "
        f"in {t_inc:.2f} ms host wall")

    m_i, s3_i, nh_i, ok_i = select.select_routes(
        w_k[0], i_rw, i_root, i_mbuf, p_cap, a_cap, False)
    i_flags = i_mbuf[p_cap * a_cap:2 * p_cap * a_cap].view(p_cap, a_cap)
    cargs = (m_i, s3_i, nh_i, ok_i, *ci["prev_out"][:3], i_flags, w_k[1],
             w_k[4],
             gpu_solver.DELTA_BUDGET, True, (w_k[2], w_k[3]))
    got = compact.compact_outputs(*cargs)
    want = compact.compact_outputs_plain(*cargs)
    err = max_abs_err(torch, got, want)
    check(err == 0, f"K4 with the incremental tail != plain (err {err})")
    one_launch(torch, wrappers, "K4 with the incremental tail",
               lambda: compact.compact_outputs(*cargs))
    check(int(got[1][-3]) == int(w_k[2]) and int(got[1][-2]) == int(w_k[3]),
          "K4: the [cone, fell_back] tail is misplaced")
    results["K4:compact_outputs"]["incr_tail_max_abs_err"] = err
    log("K4:compact_outputs with the incremental tail equal to plain")

    # device work of K7 and of the old planes alone, of one incremental
    # SSSP and of one incremental build (the change phase 6's fallback
    # step left pending for inc_solver, an increase), torch ops included
    seed_only = counted(torch, wrappers,
                        lambda: incremental.cone_seed(*cargs_k7))
    old_only = counted(torch, wrappers, lambda: incremental.old_planes(
        *odirty, has_res, int(i_root), i_nbr))
    check(seed_only["launches"] == seed_only["kernel_launches"] == 1,
          f"K7 must be one launch and no fill: {seed_only}")
    check(old_only["launches"] == old_only["kernel_launches"]
          == 1 + has_res, f"the old planes must be one launch a plane: "
          f"{old_only}")
    args_w, static_w = ci["whole"]
    per_sssp = counted(torch, wrappers, lambda: incremental.incremental_sssp(
        *args_w, **static_w))
    box = {}
    st0 = inc_solver.staging_counts()
    per_build, allocs = churn_allocations(
        torch, incremental, lambda: counted(torch, wrappers, lambda: (
            box.update(db=inc_solver.build_route_db(LSDB100K_ROOT, states,
                                                    ps)))))
    per_build.update(allocs)
    per_build["staging"] = staging_delta(st0, inc_solver.staging_counts())
    check(per_build["staging"]["copies"] == 2,
          f"the incremental build's uploads must be two staged copies "
          f"(the sync's, the solve's): {per_build['staging']}")
    check(allocs["k1s_allocations"] == [0]
          and allocs["k6_allocations"] == [0],
          f"the incremental build's K1s / K6 allocated: {allocs}")
    st = inc_solver.last_device_stats
    check(st.get("incremental") is True and st.get("fell_back") is False,
          "the counted build must be incremental without fallback")
    check(rib_equal(cold_solver.build_route_db(LSDB100K_ROOT, states, ps),
                    box["db"]), "the counted build's RIB != cold solve")
    log("lsdb100k launches: " + json.dumps({
        "cone_seed": seed_only, "old_planes": old_only,
        "incremental_sssp": per_sssp, "incremental_build": per_build,
        "cone": st.get("cone"), "trips": st.get("trips")}))

    log(f"-- phase 8 starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    # -- 8. flapstorm100k: streaming epochs --------------------------------
    stream_launches, s_solver = flapstorm_phase(c, adj_dbs, states, ps)
    for name in CHURN_PATH:
        check(stream_launches[name] > 0,
              f"kernel {name} never launched on the stream path")
    variant_launches["K4:compact_outputs[stream]"] = stream_launches[
        "K4:compact_outputs"]
    # the cone of one more storm epoch, on the arguments the epoch's
    # solve passed (copied as it called): against plain, one launch
    real_resolve, seen = incremental.cone_resolve, {}

    def spy_resolve(*a, **k):
        seen["args"] = tensors_mapped(lambda t: t.clone(), a)
        return real_resolve(*a, **k)

    # the wrapper counts its launches on the module's name, the spy now
    spy_resolve.launches = 0

    flap(AdjacencyDatabase, states, adj_dbs, by_name, 3, STORM_FLAPS + 8)
    incremental.cone_resolve = spy_resolve
    try:
        s_solver.collect_route_db(s_solver.dispatch_route_db(
            LSDB100K_ROOT, states, ps))
    finally:
        incremental.cone_resolve = real_resolve
    check("args" in seen and s_solver.last_timing.get("stream"),
          "the storm epoch must stream through the cone")
    s_par, s_seeded, *s_rest = seen["args"]
    s_row = cone_case(c, "storm epoch", s_par, s_seeded, tuple(s_rest))[0]
    r = results["K8+K9:cone_resolve"]
    r["max_abs_err"] = max(r["max_abs_err"], s_row["max_abs_err"])

    log(f"-- phase 9 starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    # -- 9. UCMP on the card ------------------------------------------------
    ucmp_launches = ucmp_phase(c, (s_solver, states))

    log(f"-- phase 10 starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    # -- 10. wan50k KSP2 ------------------------------------------------------
    ksp2_launches = ksp2_phase(c)

    log(f"-- phase 11 starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    # -- 11. what-if sweeps ---------------------------------------------------
    sweep_launches, whatif_cells = whatif_phase(c)

    log(f"-- phase 12 starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    # -- 12. differentiable TE ------------------------------------------------
    te_launches = te_phase(c, whatif_cells)

    log(f"-- phase 13 starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    # -- 13. the all-roots paths ----------------------------------------------
    t_phase = time.perf_counter()
    fcell = build_cell(topologies, lambda: topologies.fabric(**FABRIC))[1:]
    legacy_launches, allpairs_launches = legacy_phase(
        c, (s_solver, states, ps), fcell)
    t_mid = time.perf_counter()
    fabric_launches, step_launches = fabric_phase(c, fcell)
    log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s (legacy and "
        f"all-pairs {t_mid - t_phase:.1f} s, whole fabric "
        f"{time.perf_counter() - t_mid:.1f} s)")

    log(f"-- phase 14 starts at "
        f"{time.perf_counter() - t_start:.1f} s")
    # -- 14. the multichip tier on logical shards ----------------------------
    t_phase = time.perf_counter()
    mc_windows, mc_halo = multichip_phase(c, (adj_dbs, states, ps), fcell)
    variant_launches["K2:ladder_pass[mc]"] = sum(
        w.get("K2:ladder_pass", 0) for w in mc_windows.values())
    # the mc paths' K23 launches (every call goes through the grouped entry)
    variant_launches["K23:shard_combine[groups]"] = sum(
        w.get("K23:shard_combine", 0) for w in mc_windows.values())
    log(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")

    # -- result ----------------------------------------------------------
    kernels = []
    for name, (fn, src, replaces) in wrappers.items():
        by_path = {"cold": launches.get(name, 0),
                   "churn": churn_launches[name],
                   "stream": stream_launches[name],
                   "ucmp": ucmp_launches[name],
                   "ksp2": ksp2_launches[name],
                   "sweep": sweep_launches[name],
                   "te": te_launches[name],
                   "legacy": legacy_launches[name],
                   "allpairs": allpairs_launches[name],
                   "fabric": fabric_launches[name],
                   "fabric_step": step_launches[name]}
        by_mc = {k: w.get(name, 0) for k, w in mc_windows.items()}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"openr_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": sum(by_path.values()) + sum(by_mc.values()),
            "launches_by_path": {**by_path, "multichip": by_mc},
            **results[name],
        })
    for name, (base, replaces) in variants.items():
        _, src, _ = wrappers[base]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"openr_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": variant_launches[name],
            **results[name],
        })
    log(json.dumps({"kernels": kernels,
                    "multichip_halo_exchanges": mc_halo}))
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
