"""The multichip tier on a ('batch', 'graph') mesh of torch devices: the
port of the JAX package's ``parallel/sharding.py``.

The reference is single-controller: one process builds a
``jax.sharding.Mesh`` of its devices and ``shard_map``s the SSSP over it
(``make_mc_sssp``, ``make_mc_incremental_sssp``) and the whole-fabric
step (``_sharded_fabric_fn``). Here too one process drives the mesh: a
``Mesh`` is a grid of torch devices, and every shard keeps its own
tensors, as it would on its own card:

- **'batch'** splits independent lanes — the vantage's out-neighbour
  lanes of the Decision solve, the roots of the whole-fabric step. Batch
  groups share nothing and each runs its own loop to its own exit.
- **'graph'** splits the weight state: each member of a group holds the
  class-weight columns [col0, col0 + n_cap / graph) of the shift planes
  (and, in the fabric step, its own residual rows) and relaxes a
  full-width plane over its own sources only (K1 [mc], K21 [mc]). The
  group then combines its members' planes with the min
  (``ops/combine.shard_combine``: K23 on one card, NCCL across cards),
  the reference's ``lax.pmin`` over 'graph' — once per relaxation under
  the sync rounds, once per bucket epoch under Δ-stepping, where each
  member ladders its own most light-populous classes (K2 [mc]) and exits
  its ladder on its own no-change pass.

A device list that repeats one card (``[cuda:0] * 8``) makes that many
**logical shards** on it: the port's counterpart of the test suite's
``xla_force_host_platform_device_count``. The cross-card code then
differs from the one-card code only in the combine.

Counts the reference reports and how they map here:

- ``trips`` per batch group (epochs under bucketed); the pipeline takes
  the max over the groups;
- ``rounds`` per batch group: under bucketed the members of a group may
  run different ladder passes, and the reference's ``out_specs=
  P("batch")`` reports the count of the group's first 'graph' member
  (checked on the CPU mesh: the per-member counts differ, the reported
  one is member 0's), so this one reports member 0's too;
- a halo exchange is one combine of the group: rounds of them under
  sync, epochs under bucketed.

Flag reads: each group's loop reads one change flag per trip, ladder
pass or epoch; the flags of the shards on one card are one tensor read
with one sync (``ops/relax.FlagBank``).

The whole-fabric step's one loop is ``ops/fabric.fabric_step_grid``,
which the one-card step runs on a 1 x 1 grid; ``sharded_fabric_step``
places its inputs on a mesh.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from openr_tpu_torch.ops.combine import shard_combine, shard_combine_groups
from openr_tpu_torch.ops.fabric import fabric_step_grid, row_table, unpack_bits
from openr_tpu_torch.ops.incremental import (
    cone_finish,
    cone_resolve,
    cone_seed_mc,
    owned_weights,
    parent_fill,
    parent_shift_mc,
    part_table,
    scatter_parts,
    scatter_set,
    scatter_window,
)
from openr_tpu_torch.ops.relax import (
    INF_E,
    LADDER_WIDTH,
    UNROLL,
    FlagBank,
    ladder_classes_mc,
    ladder_depth,
    ladder_pass,
    max_trips,
    relax_step_mc,
    sssp_init_mc,
)
from openr_tpu_torch.ops.select import pack_matrix


class Unconverged(AssertionError):
    """The fixed trip bound was below the graph's diameter bound."""


# -- the mesh ------------------------------------------------------------------

def canonical(device) -> torch.device:
    """``device`` as a torch device, a CUDA one with its index ("cuda"
    names the current card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A ('batch', 'graph') grid of torch devices: ``devices[b][g]`` is
    the device of shard (b, g). ``shape`` maps the axis names to their
    sizes, as a ``jax.sharding.Mesh``'s does."""

    axis_names = ("batch", "graph")

    def __init__(self, devices):
        rows = [tuple(canonical(d) for d in row) for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty rectangular device grid")
        self.devices = tuple(rows)
        self.shape = {"batch": len(rows), "graph": len(rows[0])}
        self.size = len(rows) * len(rows[0])

    @property
    def first(self) -> torch.device:
        """The device of shard (0, 0), where the selection tail runs."""
        return self.devices[0][0]

    def shards(self):
        """(b, g, device) of every shard, batch-major."""
        for b, row in enumerate(self.devices):
            for g, dev in enumerate(row):
                yield b, g, dev

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self):
        return hash(self.devices)

    def __repr__(self):
        return (f"Mesh(batch={self.shape['batch']}, "
                f"graph={self.shape['graph']}, devices="
                f"{[str(d) for row in self.devices for d in row]})")


def visible_devices() -> list:
    """Every visible CUDA card (the counterpart of ``jax.devices()``);
    raises without one."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device available; pass devices=['cpu'] * n for CPU "
            "logical shards")
    return [torch.device(f"cuda:{i}") for i in range(n)]


def make_mesh(n_devices: Optional[int] = None, batch: Optional[int] = None,
              devices=None) -> Mesh:
    """Factor devices into a ('batch', 'graph') mesh as the reference
    does: graph 2 when there are at least 4 devices and their number is
    even, else 1, unless ``batch`` is given. ``devices`` defaults to the
    visible cards; a list that repeats one device gives that many
    logical shards on it."""
    devs = visible_devices() if devices is None else [
        torch.device(d) for d in devices]
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"{n} devices asked, {len(devs)} given")
    devs = devs[:n]
    if batch is None:
        graph = 2 if n >= 4 and n % 2 == 0 else 1
        batch = n // graph
    else:
        graph = n // batch
    if batch * graph != n:
        raise ValueError(f"batch {batch} x graph {graph} != {n} devices")
    return Mesh([devs[i * graph:(i + 1) * graph] for i in range(batch)])


# -- layouts: what each shard holds ------------------------------------------

class Layout(NamedTuple):
    """How an array lies on a mesh: split along ``axis`` over the mesh
    axis ``over`` ("batch" or "graph"), or whole on every shard when
    ``over`` is None."""

    axis: int = 0
    over: Optional[str] = None


REPLICATED = Layout()


def plan_shardings(mesh: Mesh, n_cap: int, r_cap: int, d_cap: int) -> dict:
    """The table of what each shard holds in the multichip tier (the
    reference's ``plan_shardings``, :272-310), keyed by role: the shift
    planes' node columns over 'graph' (``shift_w`` [S, N]), the residual
    ELL's rows over 'graph' in the resident layout (``res_rows`` [R],
    ``res_2d`` [R, K]; the SSSP gathers it whole at use, the fabric step
    keeps its rows), the vantage lanes over 'batch' (``root_vec`` [D])
    and the warm distance plane lane-split, its node axis whole
    (``dist`` [D, N]). An axis that does not divide its mesh axis stays
    whole on every shard (``replicated``)."""
    b, g = mesh.shape["batch"], mesh.shape["graph"]

    def sh(axis, over, ok):
        return Layout(axis, over) if ok else REPLICATED

    return {
        "replicated": REPLICATED,
        "shift_w": sh(1, "graph", n_cap % g == 0),
        "res_rows": sh(0, "graph", r_cap % g == 0),
        "res_2d": sh(0, "graph", r_cap % g == 0),
        "root_vec": sh(0, "batch", d_cap % b == 0),
        "dist": sh(0, "batch", d_cap % b == 0),
    }


def part_of(mesh: Mesh, layout: Layout, size: int, b: int, g: int) -> tuple:
    """(start, stop) of shard (b, g)'s part along the layout's axis of an
    array ``size`` long there."""
    if layout.over is None:
        return 0, size
    parts = mesh.shape[layout.over]
    i = b if layout.over == "batch" else g
    if size % parts:
        raise ValueError(f"{size} does not split over {parts} shards")
    step = size // parts
    return i * step, (i + 1) * step


class Sharded:
    """An array laid out on a mesh: its global ``shape``, its ``layout``
    and each shard's part (``parts[b][g]``, a tensor on the shard's
    device). Shards of one card that hold the same part share one
    tensor, as one card holds one copy."""

    def __init__(self, mesh: Mesh, shape: tuple, layout: Layout, parts):
        self.mesh, self.shape, self.layout = mesh, tuple(shape), layout
        self.parts = parts
        # card -> (parts as 2-D planes, windows, K5 [mc]'s device table),
        # built at the first scatter into this placement
        self._scatter: dict = {}

    def part(self, b: int, g: int) -> torch.Tensor:
        return self.parts[b][g]

    def window(self, b: int, g: int) -> tuple:
        return part_of(self.mesh, self.layout, self.shape[self.layout.axis],
                       b, g)

    def distinct(self):
        """(b, g, part) once for each distinct tensor."""
        seen = set()
        for b, g, _ in self.mesh.shards():
            t = self.parts[b][g]
            if id(t) not in seen:
                seen.add(id(t))
                yield b, g, t

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for _, _, t in self.distinct())


def place(mesh: Mesh, arr: np.ndarray, layout: Layout = REPLICATED) -> Sharded:
    """Upload ``arr`` (int32) to the mesh as ``layout`` says: one tensor
    per distinct (card, part)."""
    arr = np.asarray(arr)
    cache: dict = {}
    parts = []
    for b, row in enumerate(mesh.devices):
        prow = []
        for g, dev in enumerate(row):
            lo, hi = part_of(mesh, layout, arr.shape[layout.axis] if arr.ndim
                             else 1, b, g)
            key = (dev, lo, hi)
            if key not in cache:
                piece = (arr if layout.over is None
                         else np.take(arr, range(lo, hi), axis=layout.axis))
                cache[key] = torch.tensor(
                    np.ascontiguousarray(piece, dtype=np.int32), device=dev)
            prow.append(cache[key])
        parts.append(prow)
    return Sharded(mesh, arr.shape, layout, parts)


def gather(sh: Sharded, b: int, g: int) -> torch.Tensor:
    """The whole array on shard (b, g)'s device, from the parts of its
    group (a residual split over 'graph') or of its column (lanes split
    over 'batch'): the reference's all-gather at use."""
    if sh.layout.over is None:
        return sh.part(b, g)
    dev = sh.mesh.devices[b][g]
    if sh.layout.over == "graph":
        parts = [sh.part(b, j) for j in range(sh.mesh.shape["graph"])]
    else:
        parts = [sh.part(i, g) for i in range(sh.mesh.shape["batch"])]
    return torch.cat([t.to(dev) for t in parts], dim=sh.layout.axis)


def _scatter_targets(sh: Sharded) -> dict:
    """card -> (its distinct parts as 2-D planes, their (row0, col0)
    windows in the global plane, the ``scatter_parts`` table or None on
    the CPU), built once for the placed array: its parts never move."""
    if not sh._scatter:
        split_cols = len(sh.shape) == 1 or sh.layout.axis == 1
        by_dev: dict = {}
        for b, g, t in sh.distinct():
            lo, _ = sh.window(b, g)
            view = t.view(-1, t.shape[-1]) if t.dim() == 2 else t.view(1, -1)
            parts, wins = by_dev.setdefault(t.device, ([], []))
            parts.append(view)
            wins.append((0, lo) if split_cols else (lo, 0))
        for dev, (parts, wins) in by_dev.items():
            sh._scatter[dev] = (parts, wins, part_table(parts, wins)
                                if dev.type == "cuda" else None)
    return sh._scatter


def scatter_sharded(sh: Sharded, idx_on) -> None:
    """In place, on every distinct part: the global flat (idx, vals)
    scatter, each entry landing only on the shards that own it (K5 [mc],
    the reference's in-place ``_mc_scatter_jit``): one ``scatter_parts``
    launch a card for all of that card's parts. ``idx_on(device)``
    returns the index and value tensors on that device."""
    shape2 = sh.shape if len(sh.shape) == 2 else (1, sh.shape[0])
    for dev, (parts, wins, table) in _scatter_targets(sh).items():
        i_t, v_t = idx_on(dev)
        scatter_parts(parts, wins, i_t, v_t, shape2, table)


def pad_to(arr: np.ndarray, size: int, fill, axis: int = 0) -> np.ndarray:
    """``arr`` padded with ``fill`` along ``axis`` to ``size``."""
    if arr.shape[axis] == size:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, size - arr.shape[axis])
    return np.pad(arr, pad, constant_values=fill)


# -- the mc SSSP loops ----------------------------------------------------------

def _relax_groups(mesh, deltas, sw, residual, cur, spare, flags, active,
                  col_of) -> None:
    """One combined relaxation of every active group: K1 [mc] on each
    member into ``spare``, then every group's min in one combine (one K23
    launch for the groups of a card; the flag of group b, on its first
    member's device, ORs a change; a one-member group has nothing to
    combine and its step ORs the flag itself); then the buffers swap."""
    g = mesh.shape["graph"]
    for b in active:
        for j in range(g):
            relax_step_mc(cur[b][j], spare[b][j], flags[b] if g == 1 else None,
                          deltas[b][j], sw[b][j], residual[b][j], col_of(j))
    if g > 1:
        shard_combine_groups([spare[b] for b in active], "min",
                             refs=[cur[b][0] for b in active],
                             flags=[flags[b] for b in active])
    for b in active:
        cur[b], spare[b] = spare[b], cur[b]


def run_sync_mc(mesh, deltas, sw, residual, dist0, bound: int, col_of,
                done=None):
    """Synchronous rounds on the mesh: every batch group runs ``UNROLL``
    combined relaxations a trip until a trip changes nothing or ``bound``
    trips ran, each group to its own exit. ``dist0`` (a grid of each
    member's seed plane) is consumed as scratch. Returns (planes grid,
    trips [b], rounds [b]); ``done(b)`` is called as group b exits."""
    nb = mesh.shape["batch"]
    cur = [list(row) for row in dist0]
    spare = [[torch.empty_like(t) for t in row] for row in dist0]
    flags = FlagBank([mesh.devices[b][0] for b in range(nb)])
    trips = [0] * nb
    active = list(range(nb))
    while active:
        for _ in range(UNROLL):
            _relax_groups(mesh, deltas, sw, residual, cur, spare, flags,
                          active, col_of)
        for b in active:
            trips[b] += 1
        changed = flags.read()
        still = []
        for b in active:
            if changed[b] and trips[b] < bound:
                still.append(b)
            elif done is not None:
                done(b)
        active = still
    return cur, trips, [t * UNROLL for t in trips]


def run_bucketed_mc(mesh, deltas, sw, residual, dist0, n_cap: int,
                    s_cap: int, delta_exp: int, col_of, done=None):
    """Bucketed Δ-stepping on the mesh. Per epoch of a batch group: each
    member runs its own ladder (K2 [mc] classes scored on its own
    columns, full-width rows; one K2 pass launch a pass) until a pass changes
    nothing or ``ladder_depth`` passes ran, then the handoff — K1 [mc] on
    each member and the group's min — re-unifies the group's planes (one
    halo exchange an epoch). A group's epoch changed when a member's
    ladder or the combined handoff changed its plane; it exits on an
    epoch that changed nothing. Returns (planes grid, epochs [b], rounds
    [b]: member 0's ladder passes + one handoff an epoch)."""
    nb, ng = mesh.shape["batch"], mesh.shape["graph"]
    s_lad = min(s_cap, LADDER_WIDTH)
    j_cap = ladder_depth(n_cap)
    epoch_bound = max_trips(n_cap) * UNROLL
    dq = 1 << max(delta_exp, 1)
    members = [(b, j) for b in range(nb) for j in range(ng)]
    base = {m: ladder_classes_mc(sw[m[0]][m[1]], deltas[m[0]][m[1]], dq,
                                 s_lad, col_of(m[1]), n_cap)
            for m in members}
    bufs = {m: ((torch.empty_like(w), torch.empty_like(w)),
                (torch.empty_like(d), torch.empty_like(d)))
            for m, (w, d) in base.items()}
    cur = [list(row) for row in dist0]
    spare = [[torch.empty_like(t) for t in row] for row in dist0]
    mflags = FlagBank([mesh.devices[b][j] for b, j in members])
    gflags = FlagBank([mesh.devices[b][0] for b in range(nb)])
    epochs = [0] * nb
    rounds = [[0] * ng for _ in range(nb)]
    active = list(range(nb))
    while active:
        lad = [(b, j) for b in active for j in range(ng)]
        wd = {m: base[m] for m in lad}
        passes = dict.fromkeys(lad, 0)
        laddered = dict.fromkeys(lad, False)
        while lad:
            for m in lad:
                b, j = m
                w, d = wd[m]
                (w0, w1), (d0, d1) = bufs[m]
                q = passes[m] % 2
                w2, d2 = (w0, d0) if q == 0 else (w1, d1)
                cur[b][j], spare[b][j] = ladder_pass(
                    cur[b][j], spare[b][j], w, d, w2, d2,
                    mflags[members.index(m)])
                wd[m] = (w2, d2)
                passes[m] += 1
            changed = mflags.read()
            nxt = []
            for m in lad:
                ch = changed[members.index(m)]
                laddered[m] |= ch
                if ch and passes[m] < j_cap:
                    nxt.append(m)
            lad = nxt
        _relax_groups(mesh, deltas, sw, residual, cur, spare, gflags, active,
                      col_of)
        handoff = gflags.read()
        still = []
        for b in active:
            epochs[b] += 1
            for j in range(ng):
                rounds[b][j] += passes[(b, j)] + 1
            changed = handoff[b] or any(laddered[(b, j)] for j in range(ng))
            if changed and epochs[b] < epoch_bound:
                still.append(b)
            elif done is not None:
                done(b)
        active = still
    return cur, epochs, [r[0] for r in rounds]


def _grid(mesh, fn):
    return [[fn(b, j) for j in range(mesh.shape["graph"])]
            for b in range(mesh.shape["batch"])]


def _solve_mc(mesh, deltas, sw, residual, dist0, kernel, delta_exp, n_cap,
              s_cap, bound, col_of, done):
    if kernel == "bucketed":
        return run_bucketed_mc(mesh, deltas, sw, residual, dist0, n_cap,
                               s_cap, delta_exp, col_of, done)
    return run_sync_mc(mesh, deltas, sw, residual, dist0, bound, col_of, done)


def _check_mesh(mesh, n_cap: int, d_cap: int) -> int:
    g, b = mesh.shape["graph"], mesh.shape["batch"]
    if n_cap % g or d_cap % b:
        raise ValueError(f"n_cap {n_cap} / d_cap {d_cap} do not split over "
                         f"{mesh.shape}")
    return n_cap // g


def mc_sssp(mesh, deltas, shift_w, res_rows, res_nbr, res_w, root: int,
            root_nbr, root_w, *, s_cap: int, has_res: bool, n_cap: int,
            d_cap: int, max_trips: int, kernel: str = "sync",
            delta_exp: int = 0, done=None):
    """The cold batched SSSP on the mesh (``make_mc_sssp``): each input is
    a grid ``[b][g]`` of the shards' tensors as ``make_mc_sssp``'s
    in_specs lay them out — ``deltas`` and the residual ELL whole on
    every shard, ``shift_w`` the shard's columns [S, n_cap / graph],
    ``root_nbr`` / ``root_w`` its batch group's lanes [d_cap / batch].
    Returns (planes grid of [d_cap / batch, n_cap] — a group's members
    hold equal planes —, trips [b] (epochs under bucketed), rounds
    [b])."""
    shard_cols = _check_mesh(mesh, n_cap, d_cap)

    def col_of(j):
        return j * shard_cols

    sw, residual, dist0 = [], [], []
    for b in range(mesh.shape["batch"]):
        row_sw, row_res, row_d = [], [], []
        for j in range(mesh.shape["graph"]):
            s, res, d0 = sssp_init_mc(
                shift_w[b][j], res_rows[b][j], res_nbr[b][j], res_w[b][j],
                root, root_nbr[b][j], root_w[b][j], col_of(j), n_cap)
            row_sw.append(s)
            row_res.append(res if has_res else None)
            row_d.append(d0)
        sw.append(row_sw)
        residual.append(row_res)
        dist0.append(row_d)
    return _solve_mc(mesh, deltas, sw, residual, dist0, kernel, delta_exp,
                     n_cap, s_cap, max_trips, col_of, done)


def mc_incremental_sssp(mesh, deltas, shift_w, res_rows, res_nbr, res_w,
                        root: int, root_nbr, root_w, prev_dist, s_dirty_idx,
                        s_dirty_old, r_dirty_idx, r_dirty_old,
                        cone_limit: int, *, s_cap: int, has_res: bool,
                        n_cap: int, d_cap: int, max_trips: int,
                        kernel: str = "sync", delta_exp: int = 0,
                        done=None):
    """The incremental SSSP on the mesh (``make_mc_incremental_sssp``),
    inputs as ``mc_sssp``'s plus ``prev_dist`` (each shard its batch
    group's lanes of the warm plane, [d_cap / batch, n_cap]) and the
    dirty tuples (global flat indices, whole on every shard). Per shard:
    the old local plane (K5 [mc], foreign slots dropped), the parent
    plane over its own source columns (K6 [mc]) combined by the group's
    max, then the residual parents; the dirty slots' new weights from
    their owners (K7 [mc] gather, the group's min) and the cone seeds
    (K7 [mc]); the spread to the closure and the member's count in one
    launch (K8, ``cone_resolve`` without a plane); the cone summed over
    the batch groups and the one fallback decision; the warm or cold
    seed (K9) and the
    relaxation of ``mc_sssp``. The parents, and so the cone, are the
    reference's multichip ones (the max over members), not the
    single-card K6's. Returns (planes grid, trips [b], cone int32 0-d,
    fell_back int32 0-d (both on the mesh's first device), rounds [b])."""
    shard_cols = _check_mesh(mesh, n_cap, d_cap)
    nb, ng = mesh.shape["batch"], mesh.shape["graph"]

    def col_of(j):
        return j * shard_cols

    new, old = {}, {}
    # the old planes, one a distinct (part, dirty list): the shards of a
    # card that hold the same part and list share it (a clone and a
    # scatter each, not one a shard)
    olds: dict = {}

    def old_of(part, idx, vals, col0, put):
        key = (id(part), id(idx), id(vals), col0)
        if key not in olds:
            olds[key] = part.clone()
            put(olds[key], idx, vals)
        return olds[key]

    for b in range(nb):
        for j in range(ng):
            args = (res_rows[b][j], res_nbr[b][j])
            new[b, j] = sssp_init_mc(shift_w[b][j], *args, res_w[b][j], root,
                                     root_nbr[b][j], root_w[b][j], col_of(j),
                                     n_cap)
            old_shift = old_of(
                shift_w[b][j], s_dirty_idx[b][j], s_dirty_old[b][j],
                col_of(j), lambda t, i, v, c0=col_of(j): scatter_window(
                    t, i, v, (s_cap, n_cap), 0, c0))
            old_res = res_w[b][j]
            if has_res:
                old_res = old_of(old_res, r_dirty_idx[b][j],
                                 r_dirty_old[b][j], 0, scatter_set)
            old[b, j] = sssp_init_mc(old_shift, *args, old_res, root,
                                     root_nbr[b][j], root_w[b][j], col_of(j),
                                     n_cap)
    par = _grid(mesh, lambda b, j: parent_shift_mc(
        deltas[b][j], old[b, j][0], prev_dist[b][j], s_cap, col_of(j)))
    new_m = _grid(mesh, lambda b, j: owned_weights(
        new[b, j][0], s_dirty_idx[b][j], n_cap, col_of(j)))
    if ng > 1:
        # every group's parent max and new-weight min: one combine
        shard_combine_groups(par, "max", also=new_m, also_op="min")
    for b in range(nb):
        if has_res:
            for j in range(ng):
                parent_fill(par[b][j], res_rows[b][j], res_nbr[b][j],
                            old[b, j][1][2], prev_dist[b][j])
    aff, counted = {}, {}
    for b in range(nb):
        for j in range(ng):
            aff[b, j] = cone_seed_mc(
                par[b][j], new_m[b][j], new[b, j][1][2], deltas[b][j],
                res_rows[b][j], res_nbr[b][j], root, s_dirty_idx[b][j],
                s_dirty_old[b][j], r_dirty_idx[b][j], r_dirty_old[b][j],
                has_res, s_cap)
            # no plane: the spread and the member's own count
            _, counted[b, j] = cone_resolve(par[b][j], aff[b, j], None, None,
                                            None, None, 0, max_trips)
    # the cone summed over the batch groups (a group's members agree:
    # member 0 counts for its group), K23's sum (the reference's psum
    # over 'batch'): one fallback decision for the whole mesh
    first = mesh.first
    counts = [counted[b, 0][:2] for b in range(nb)]
    if nb > 1:
        shard_combine(counts, "sum")
    cone = counts[0][0].to(first)
    seed = []
    tail0 = None
    for b in range(nb):
        row = []
        for j in range(ng):
            dev = mesh.devices[b][j]
            tail = torch.stack([cone.to(dev), torch.zeros(
                (), dtype=torch.int32, device=dev)])
            plane, tail = cone_finish(aff[b, j], prev_dist[b][j],
                                      new[b, j][2], root_nbr[b][j],
                                      root_w[b][j], int(cone_limit), tail)
            tail0 = tail if tail0 is None else tail0
            row.append(plane)
        seed.append(row)
    sw = _grid(mesh, lambda b, j: new[b, j][0])
    residual = _grid(mesh, lambda b, j: new[b, j][1] if has_res else None)
    planes, trips, rounds = _solve_mc(mesh, deltas, sw, residual, seed,
                                      kernel, delta_exp, n_cap, s_cap,
                                      max_trips, col_of, done)
    return planes, trips, cone, tail0[1].to(first), rounds


# -- the whole-fabric step on a mesh ----------------------------------------------

def grid_nbytes(*grids) -> int:
    """Bytes of the distinct tensors of per-shard grids."""
    seen = {id(t): t for grid in grids for row in grid for t in row}
    return sum(t.numel() * t.element_size() for t in seen.values())


def fabric_mesh_inputs(mesh: Mesh, plan, matrix, roots, out_nbr,
                       out_w) -> dict:
    """The keyword arguments of ``ops/fabric.fabric_step_grid`` but its
    flags, from the host mirror: the node axis padded to a multiple of
    the graph size (INF_E columns, exact: shifts are signed index
    differences, so no real edge wraps through the pad, and a pad
    column neither emits nor receives a finite distance), the residual
    rows to a multiple of it (rows -1, weights INF_E), each array placed
    as the reference's in_specs lay it out, and each shard's node -> row
    table of its own residual rows (``row_of``, built here once a
    placement: -1 where the node's row lies on another member or
    nowhere). The roots must split over 'batch'."""
    g, b = mesh.shape["graph"], mesh.shape["batch"]
    if len(roots) % b:
        raise ValueError(f"{len(roots)} roots do not split over batch {b}")
    n_cap = -(-plan.n_cap // g) * g
    r_cap = -(-plan.res_rows.shape[0] // g) * g
    _, mbuf = pack_matrix(matrix, plan.node_overloaded)
    rows = Layout(0, "graph")
    lanes = Layout(0, "batch")
    p_cap, a_cap = matrix.ann_node.shape
    rows_np = pad_to(plan.res_rows, r_cap, -1)
    res_parts = place(mesh, rows_np, rows)
    return dict(
        deltas=place(mesh, plan.deltas).parts,
        shift_w=place(mesh, pad_to(plan.shift_w, n_cap, INF_E, axis=1),
                      Layout(1, "graph")).parts,
        res_rows=res_parts.parts,
        row_of=_row_tables(res_parts, rows_np, n_cap),
        res_nbr=place(mesh, pad_to(plan.res_nbr, r_cap, -1), rows).parts,
        res_w=place(mesh, pad_to(plan.res_w, r_cap, INF_E), rows).parts,
        mbuf=place(mesh, mbuf).parts,
        roots=place(mesh, roots, lanes).parts,
        out_nbr=place(mesh, out_nbr, lanes).parts,
        out_w=place(mesh, out_w, lanes).parts,
        has_res=bool(plan.k_res > 0), p_cap=p_cap, a_cap=a_cap,
    )


def _row_tables(res_parts: Sharded, rows_np: np.ndarray, n_cap: int):
    """Each shard's node -> row table of its part of the residual rows
    (``ops/fabric.row_table``), one tensor a distinct (card, part)."""
    tables: dict = {}

    def one(b, j):
        dev = res_parts.mesh.devices[b][j]
        lo, hi = res_parts.window(b, j)
        if (dev, lo) not in tables:
            tables[dev, lo] = torch.tensor(row_table(rows_np[lo:hi], n_cap),
                                           device=dev)
        return tables[dev, lo]

    return _grid(res_parts.mesh, one)


def sharded_fabric_step(mesh, plan, matrix, roots, out_nbr, out_w,
                        n_trips: int, check_convergence: bool = True,
                        lfa: bool = False, block_v4: bool = False,
                        with_ok: bool = False, *, device="cuda"):
    """Run the whole-fabric step for ``roots`` on ``mesh``.

    plan: ``ops/edgeplan.EdgePlan``; matrix: ``ops/csr.PrefixMatrix``;
    roots [Rt] int32 (a multiple of the batch axis); out_nbr / out_w
    [Rt, D]: per-root out-edge tables (pad slots -1 / INF_E); n_trips:
    the trip bound (``UNROLL`` relaxations each). With
    ``check_convergence`` a root whose planes were still changing after
    ``n_trips`` trips raises ``Unconverged``. ``mesh`` is a ``Mesh``, a
    list of devices (factored by ``make_mesh``), or None for the card of
    ``device`` alone; every mesh runs ``ops/fabric.fabric_step_grid``.

    Returns, as tensors on the mesh's first device, (dist [Rt, N_cap]
    (N_cap padded to the graph size), metric [Rt, P_cap], s3 [Rt, P_cap,
    A] selected-announcer masks, nh_mask [Rt, P_cap, D], lfa_slot [Rt,
    P_cap] (-1 = none; only meaningful with lfa=True), lfa_metric [Rt,
    P_cap]); with ``with_ok`` also the route-level ok mask [Rt, P_cap]
    (v4 rows blocked per ``block_v4``)."""
    if mesh is None:
        from openr_tpu_torch.decision.gpu_solver import resolve_device

        mesh = Mesh([[resolve_device(device)]])
    elif not isinstance(mesh, Mesh):
        mesh = make_mesh(devices=list(mesh))
    if mesh.first.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available")
    p_cap, a_cap = matrix.ann_node.shape
    out = fabric_step_grid(
        **fabric_mesh_inputs(mesh, plan, matrix, roots, out_nbr, out_w),
        n_trips=int(n_trips), lfa=lfa, block_v4=block_v4)
    if check_convergence and not out.converged.all():
        raise Unconverged(
            f"fabric SSSP unconverged for roots "
            f"{np.asarray(roots)[~out.converged].tolist()}: raise n_trips "
            f"({n_trips})"
        )
    res = (out.dist, out.metric, unpack_bits(out.s3w, a_cap),
           unpack_bits(out.nhw, out_nbr.shape[1]), out.lfa_slot,
           out.lfa_metric)
    if with_ok:
        res += (out.ok,)
    return res
