"""UCMP weight propagation on the device (the port of ``ops/ucmp.py``).

Role of the reference's ``LinkState::resolveUcmpWeights``: from a
prefix's announcers ("leaves", all equidistant from the computing root),
walk the shortest-path DAG leaf -> root accumulating advertised
weights, which gives the root's per-next-hop load-balancing weights.
The CPU oracle walks a heap (``link_state.resolve_ucmp_weights``); the
device computes the same fixpoint as masked edge aggregations over the
root's unmasked distance field (``ops/ksp2.base_sssp``):

  - DAG membership of a directed edge u -> v: dist[u] + w_eff == dist[v],
    both finite;
  - reach(v): v lies on a shortest root -> leaf path;
  - weight w(v): a leaf's advertised weight; otherwise the sum over its
    DAG out-edges v -> s with reach(s) of w(s) (prefix mode,
    SP_UCMP_PREFIX_WEIGHT_PROPAGATION) or of the edge's static link
    weight (adjacency mode, SP_UCMP_ADJ_WEIGHT_PROPAGATION).

``ucmp_propagate`` runs it: ``ucmp_init`` (``csrc/ucmp.cu``) computes
the DAG mask and the round-0 state once, then one ``ucmp_step`` launch
a round and one flag read, until a round changes nothing or
``fixpoint_bound(n_cap) = n_cap + 2`` rounds ran (a zero-weight cycle
would otherwise spin). Weights are int32 and may wrap on deep fabrics: a
float32 shadow, summed in the same fixed order as the JAX package's
serial scatter-add, flags any node past 2^30, and a bound that fired
before the fixpoint also counts as overflow; the caller then falls back
to the host walk, whose Python ints are exact. The wrapper runs the
plain version (``ucmp_propagate_plain``) only on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from openr_tpu_torch.ops import cuda
from openr_tpu_torch.ops.edgeplan import INF32E, MAX_METRIC, natural_key
from openr_tpu_torch.ops.relax import _is_cpu, read_flag
from openr_tpu_torch.runtime.counters import counters

INF_E = int(INF32E)
_OVER = float(1 << 30)


def fixpoint_bound(n_cap: int) -> int:
    """Round bound of a monotone fixpoint over ``n_cap`` nodes: one node
    settles a round in the worst case, +2 so the no-change round is
    seen."""
    return n_cap + 2


class UcmpEdges:
    """One area's directed edges (both directions of every link,
    interleaved: edge 2i is n1 -> n2 of link i, 2i + 1 its reverse),
    padded to a pow2 ``e_cap >= 8``, with the by-source CSR the step
    kernel pulls through, resident on ``device``. Rebuilt per topology
    generation. ``upload`` turns a host array into a resident tensor
    (the solver passes its counted upload)."""

    def __init__(self, link_state, node_overloaded: np.ndarray, n_cap: int,
                 device="cuda", upload=None):
        names, index, n1i, n2i, trip, links = link_state.mirror_source(
            natural_key
        )
        m = len(links)
        e2 = m * 2
        e_cap = 1
        while e_cap < max(e2, 8):
            e_cap *= 2
        src = np.zeros(e_cap, np.int32)
        dst = np.zeros(e_cap, np.int32)
        w_eff = np.full(e_cap, INF_E, np.int32)
        adj_w = np.zeros(e_cap, np.int32)
        self.adj_w_unsafe = False
        self.zero_w_unsafe = False
        if m:
            src[0:e2:2] = n1i
            src[1:e2:2] = n2i
            dst[0:e2:2] = n2i
            dst[1:e2:2] = n1i
            wdir = np.empty(e2, np.int64)
            wdir[0::2] = trip[:, 0]
            wdir[1::2] = trip[:, 1]
            up2 = np.repeat(trip[:, 2].astype(bool), 2)
            # a drained (overloaded) source provides no transit, as in
            # the shift mirror (ops/edgeplan.build_plan)
            w_eff[:e2] = np.where(
                up2 & ~node_overloaded[src[:e2]],
                np.minimum(wdir, MAX_METRIC),
                INF_E,
            ).astype(np.int32)
            # static link weights are never added to distances, so they
            # are not clipped: out-of-range ones force the host walk
            aw = np.array(
                [(l.weight_from_node(l.n1), l.weight_from_node(l.n2))
                 for l in links],
                np.int64,
            )
            self.adj_w_unsafe = bool((np.abs(aw) > (1 << 30)).any())
            if not self.adj_w_unsafe:
                adj_w[0:e2:2] = aw[:, 0]
                adj_w[1:e2:2] = aw[:, 1]
            # a live zero (or negative) metric satisfies the DAG test in
            # both directions: a 2-cycle the fixpoint cannot settle. The
            # host walk's heap order handles it; force it.
            self.zero_w_unsafe = bool(
                ((w_eff[:e2] < INF_E) & (w_eff[:e2] <= 0)).any()
            )
        # by-source CSR over the real edges, edge ids ascending per node
        order = np.argsort(src[:e2], kind="stable").astype(np.int32)
        deg = np.bincount(src[:e2], minlength=n_cap)[:n_cap]
        row_ptr = np.zeros(n_cap + 1, np.int32)
        np.cumsum(deg, out=row_ptr[1:])
        self.max_deg = int(deg.max()) if deg.size else 0
        self.e_cap = e_cap
        self.n_cap = n_cap
        self.node_index = index
        if upload is None:
            def upload(a):
                return torch.tensor(np.ascontiguousarray(a), device=device)
        self.src = upload(src)
        self.dst = upload(dst)
        self.w_eff = upload(w_eff)
        self.adj_w = upload(adj_w)
        self.row_ptr = upload(row_ptr)
        self.order = upload(order if e2 else np.zeros(1, np.int32))

    def tensors(self) -> tuple:
        """(src, dst, w_eff, adj_w, row_ptr, order): the kernels' edge
        inputs."""
        return (self.src, self.dst, self.w_eff, self.adj_w, self.row_ptr,
                self.order)


# -- the plain versions --------------------------------------------------------

def ucmp_init_plain(src, dst, w_eff, dist, leaf, leaf_w):
    """-> (dag bool [e_cap], (reach bool, w int32, wf float32) [n_cap])."""
    du, dv = dist[src.long()], dist[dst.long()]
    dag = (w_eff < INF_E) & (du < INF_E) & (dv < INF_E) & (du + w_eff == dv)
    w = torch.where(leaf, leaf_w, 0).to(torch.int32)
    return dag, (leaf.clone(), w, w.to(torch.float32))


def ucmp_step_plain(row_ptr, order, dst, adj_w, dag, leaf, leaf_w, state,
                    prefix: bool, max_deg: int):
    """One round from ``state`` = (reach, w, wf) -> (new state, changed,
    over). Each node pulls its out-edges position by position in the
    CSR (edge ids ascending), so its float sum adds in the kernel's
    order."""
    reach, w, wf = state
    n_cap = leaf.shape[0]
    start, deg = row_ptr[:-1].long(), (row_ptr[1:] - row_ptr[:-1]).long()
    acc = torch.zeros(n_cap, dtype=torch.int64, device=leaf.device)
    accf = torch.zeros(n_cap, dtype=torch.float32, device=leaf.device)
    hit = torch.zeros(n_cap, dtype=torch.bool, device=leaf.device)
    last = order.shape[0] - 1
    for j in range(max_deg):
        e = order[(start + j).clamp(max=last)].long()
        s = dst[e].long()
        rv = (j < deg) & dag[e] & reach[s]
        hit |= rv
        if prefix:
            acc = acc + torch.where(rv, w[s], 0)
            accf = accf + torch.where(rv, wf[s], 0.0)
        else:
            acc = acc + torch.where(rv, adj_w[e], 0)
            accf = accf + torch.where(rv, adj_w[e].to(torch.float32), 0.0)
    # the int32 sum wraps, as the kernel's and segment_sum's do
    acc = acc & 0xFFFFFFFF
    acc = torch.where(acc >= 1 << 31, acc - (1 << 32), acc)
    new_w = torch.where(leaf, leaf_w.long(), acc).to(torch.int32)
    new_wf = torch.where(leaf, leaf_w.to(torch.float32), accf)
    new_reach = leaf | hit
    changed = bool((new_reach != reach).any() | (new_w != w).any())
    over = bool((new_wf > _OVER).any())
    return (new_reach, new_w, new_wf), changed, over


def ucmp_propagate_plain(edges: tuple, dist, leaf, leaf_w, prefix: bool,
                         max_deg: int):
    src, dst, w_eff, adj_w, row_ptr, order = edges
    dag, state = ucmp_init_plain(src, dst, w_eff, dist, leaf, leaf_w)
    bound = fixpoint_bound(leaf.shape[0])
    rounds, changed, over = 0, True, False
    while changed and rounds < bound:
        state, changed, over = ucmp_step_plain(
            row_ptr, order, dst, adj_w, dag, leaf, leaf_w, state, prefix,
            max_deg)
        rounds += 1
    return state[0], state[1], over or changed, rounds


# -- the kernels ---------------------------------------------------------------

def ucmp_propagate(edges: tuple, dist, leaf, leaf_w, prefix: bool,
                   max_deg: int):
    """-> (reach bool [n_cap], w int32 [n_cap], overflow, rounds) of the
    fixpoint over ``edges`` (``UcmpEdges.tensors()``) and the distance
    field ``dist`` int32 [n_cap], from the leaves (``leaf`` bool
    [n_cap], ``leaf_w`` int32 [n_cap]); ``prefix`` picks prefix-weight
    propagation over adjacency weights. ``overflow`` (a host bool) means
    the int32 weights cannot be trusted — a float32 shadow passed 2^30
    or the round bound fired first — and ``rounds`` (a host int) counts
    the rounds run, the last one unchanged."""
    if _is_cpu(dist):
        return ucmp_propagate_plain(edges, dist, leaf, leaf_w, prefix,
                                    max_deg)
    src, dst, w_eff, adj_w, row_ptr, order = edges
    e_cap, n_cap = src.shape[0], dist.shape[0]
    dev = dist.device
    dag = torch.empty(e_cap, dtype=torch.bool, device=dev)
    bufs = [(torch.empty(n_cap, dtype=torch.bool, device=dev),
             torch.empty(n_cap, dtype=torch.int32, device=dev),
             torch.empty(n_cap, dtype=torch.float32, device=dev))
            for _ in range(2)]
    flag = torch.zeros(2, dtype=torch.int32, device=dev)
    cur, nxt = bufs
    buf_sig = "btT"
    cuda.launch("ucmp", "ucmp_init", "tttt" + "bbt" + buf_sig + "ii",
                src, dst, w_eff, dist, dag, leaf, leaf_w, *cur, e_cap, n_cap)
    ucmp_propagate.launches += 1
    bound = fixpoint_bound(n_cap)
    rounds, changed, over = 0, True, False
    while changed and rounds < bound:
        cuda.launch("ucmp", "ucmp_step", "ttttbbt" + buf_sig * 2 + "iit",
                    row_ptr, order, dst, adj_w, dag, leaf, leaf_w, *cur, *nxt,
                    n_cap, int(prefix), flag)
        ucmp_propagate.launches += 1
        cur, nxt = nxt, cur
        rounds += 1
        read_flag.reads += 1
        changed, over = (bool(x) for x in flag.tolist())
        flag.zero_()
    return cur[0], cur[1], over or changed, rounds


ucmp_propagate.launches = 0


def propagate(edges: UcmpEdges, dist, leaf_weights: dict,
              use_prefix_weight: bool):
    """The fixpoint for one prefix's leaves -> (reach, w, overflow) with
    reach / w as host numpy arrays ([n_cap] bool, [n_cap] int32), or
    (None, None, True) when a guard sends the prefix to the host walk:
    a leaf weight past 2^30, an out-of-range link weight in adjacency
    mode, or a zero-weight edge. ``dist`` is the root's distance field
    on the device (``ops/ksp2.base_sssp``). overflow=True means the
    int32 field is untrustworthy: the caller must take the host walk."""
    if leaf_weights and max(leaf_weights.values()) > (1 << 30):
        return None, None, True
    if not use_prefix_weight and edges.adj_w_unsafe:
        return None, None, True
    if edges.zero_w_unsafe:
        return None, None, True
    leaf = np.zeros(edges.n_cap, bool)
    leaf_w = np.zeros(edges.n_cap, np.int32)
    for name, weight in leaf_weights.items():
        i = edges.node_index.get(name)
        if i is not None:
            leaf[i] = True
            leaf_w[i] = weight
    dev = dist.device
    reach, w, overflow, rounds = ucmp_propagate(
        edges.tensors(), dist, torch.tensor(leaf, device=dev),
        torch.tensor(leaf_w, device=dev), bool(use_prefix_weight),
        edges.max_deg,
    )
    # the round ledger every device fixpoint feeds
    counters.add_stat_value("decision.device.rounds", int(rounds))
    return reach.cpu().numpy(), w.cpu().numpy(), bool(overflow)
