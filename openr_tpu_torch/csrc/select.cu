// Best-route selection for Hopper (sm_90a): the tail of the cold
// Decision pipeline that turns the [D, n_cap] per-slot distance planes
// into per-prefix routes. The entry point launches one kernel on the
// caller's stream and returns cudaGetLastError().
//
// Replaces (K3) the jitted XLA tail of decision/tpu_solver.py::
// _make_pipeline (:511-531 root distance + ECMP predicate and the
// reference-order selection, :568-574 the next-hop mask, and with `lfa`
// the RFC 5286 loop-free alternate branch at :533-566), _pack_words
// (:313), and ops/compact.py::route_ok_device (:21). With g > 1 stacked
// same-shape areas (the vmap of _fused_pipeline) the lane is the grid's
// y dimension and each lane has its own root (roots[lane]). Lanes read
// their own announcer matrix, or, with a matrix stride of 0, one shared
// matrix: the whole-fabric step of parallel/sharding.py::
// _sharded_fabric_fn (:149-217) is this tail with a lane per root.
//
// Bound: bytes. The function needs the [D, n_cap] plane and root_w
// once (the announcers' node columns are gathered from the plane, which
// an L2 of 50 MB holds at the big cells' D x n_cap), the six [P, A]
// announcer planes once, and its outputs written once: four [P]-sized
// (six with `lfa`), and with `dist_out` [n_cap] distances. A handful
// of integer compares per loaded word. chip_smoke.py counts it so.
//
// Design: one launch and no scratch. A prefix row needs the distance
// and the ECMP bits only of its own announcers' nodes, so it derives
// them from dist_d[:, u] and root_w (D loads an announcer) instead of
// reading a node plane that another launch wrote. A group of G lanes
// (1, 2, 4, 8, 16 or 32, picked from A: the power of two that gives
// each lane CACHED slots) takes a row: lane `sub` holds
// announcers sub, sub + G, ... (their six fields and their node's
// distance in registers, the first CACHED of them; any beyond are read
// again where used), so neighbouring lanes load neighbouring announcer
// words, and each selection stage is a max / min / OR over the group by
// xor shuffles. G = 1, one thread a row, serves the narrow matrices of
// the big cells (A = 2). Blocks past the row blocks write the node
// distances when `dist_out` is asked for. CACHED = 2 holds both slots
// of an A = 2 row in one lane.

#include <cuda_runtime.h>
#include <stdint.h>

#define INF_E (1 << 29)
#define NEG (-2147483647 - 1)
#define THREADS 256
#define CACHED 2  // announcers a lane keeps in registers (1 to 4)
#define FULL 0xffffffffu

struct Ann {
    int node;  // ann_node clipped to [0, n_cap - 1]
    int raw;   // ann_node as stored (the self-announced test)
    int flags, pp, sp, da, mnh;
    int dist;  // the node's distance from the root (0 at the root)
};

// dist(u) = min(min_d root_w[d] + dist_d[d, u], INF_E), 0 at the root
__device__ __forceinline__ int node_dist(const int* __restrict__ dist_d,
                                         const int* __restrict__ root_w,
                                         int d_cap, int n_cap, int u,
                                         int root) {
    if (u == root) return 0;
    int m = INF_E;
    for (int d = 0; d < d_cap; ++d)
        m = min(m, __ldg(root_w + d) + dist_d[(long long)d * n_cap + u]);
    return m;
}

// max / min / OR over the G lanes of a group (G a power of two <= 32;
// every lane of the warp calls it)
__device__ __forceinline__ int gmax(int v, int G) {
    for (int o = G >> 1; o; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
    return v;
}
__device__ __forceinline__ int gmin(int v, int G) {
    for (int o = G >> 1; o; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
    return v;
}
__device__ __forceinline__ unsigned gor(unsigned v, int G) {
    for (int o = G >> 1; o; o >>= 1) v |= __shfl_xor_sync(FULL, v, o);
    return v;
}

// the prefix rows over the packed announcer matrix mbuf = six [P, A]
// int32 planes (ann_node, flags, path_pref, source_pref, dist_adv,
// min_nh); flags bit 0 = valid, bit 1 = announcer drained, bit 2 (slot
// 0) = v4. With lfa_slot, also the backup slot and metric per row (-1
// and 0 when the row has no loop-free alternate).
__global__ void __launch_bounds__(THREADS) select_tail_kernel(
    const int* __restrict__ dist_d, const int* __restrict__ root_w,
    const int* __restrict__ mbuf, int* __restrict__ metric_out,
    int* __restrict__ s3w, int* __restrict__ nhw,
    uint8_t* __restrict__ ok_out, int* __restrict__ lfa_slot,
    int* __restrict__ lfa_metric, int* __restrict__ dist_out, int p_cap,
    int a_cap, int n_cap, int d_cap, int root,
    const int* __restrict__ roots, long long mb_stride, int block_v4,
    int G, int row_blocks) {
    const int lane = blockIdx.y;
    if (roots) root = roots[lane];
    dist_d += (long long)lane * d_cap * n_cap;
    root_w += (long long)lane * d_cap;
    if ((int)blockIdx.x >= row_blocks) {  // node blocks: dist_out only
        int u = (blockIdx.x - row_blocks) * THREADS + threadIdx.x;
        if (u < n_cap)
            dist_out[(long long)lane * n_cap + u] =
                node_dist(dist_d, root_w, d_cap, n_cap, u, root);
        return;
    }
    const int wa = (a_cap + 15) / 16;
    const int wd = (d_cap + 15) / 16;
    const int sub = threadIdx.x & (G - 1);
    const int p = (int)(((long long)blockIdx.x * THREADS + threadIdx.x) / G);
    const bool live = p < p_cap;
    const bool lead = live && sub == 0;
    const long long pa = (long long)p_cap * a_cap;
    const long long base = (long long)p * a_cap;
    mbuf += lane * mb_stride;
    const int hi = n_cap - 1;
    // this lane's announcers: a = sub + j * G, j < J (none past the rows)
    const int J = live && sub < a_cap ? (a_cap - sub + G - 1) / G : 0;

    auto load = [&](int j) {
        Ann x;
        const long long at = base + sub + (long long)j * G;
        x.raw = mbuf[at];
        x.node = min(max(x.raw, 0), hi);
        x.flags = mbuf[pa + at];
        x.pp = mbuf[2 * pa + at];
        x.sp = mbuf[3 * pa + at];
        x.da = mbuf[4 * pa + at];
        x.mnh = mbuf[5 * pa + at];
        x.dist = node_dist(dist_d, root_w, d_cap, n_cap, x.node, root);
        return x;
    };
    Ann c[CACHED];
#pragma unroll
    for (int j = 0; j < CACHED; ++j)
        if (j < J) c[j] = load(j);
    // visit(x) on every announcer of this lane, in slot order
    auto each = [&](auto&& visit) {
#pragma unroll
        for (int j = 0; j < CACHED; ++j)
            if (j < J) visit(c[j]);
        for (int j = CACHED; j < J; ++j) visit(load(j));
    };
    auto get = [&](int j) {
        if (j >= CACHED) return load(j);
        return j == 0 ? c[0] : j == 1 ? c[min(1, CACHED - 1)]
               : j == 2 ? c[min(2, CACHED - 1)] : c[min(3, CACHED - 1)];
    };

    // the reference's order: path_preference desc, source_preference
    // desc, advertised distance asc, then the drain filter with the
    // all-drained fallback
    int ppmax = NEG;
    each([&](const Ann& x) {
        if ((x.flags & 1) && x.dist < INF_E) ppmax = max(ppmax, x.pp);
    });
    ppmax = gmax(ppmax, G);
    auto s1 = [&](const Ann& x) {
        return (x.flags & 1) && x.dist < INF_E && x.pp == ppmax;
    };
    int spmax = NEG;
    each([&](const Ann& x) {
        if (s1(x)) spmax = max(spmax, x.sp);
    });
    spmax = gmax(spmax, G);
    // starts past every value so an all-selected row keeps its own
    // minimum, as a min over the [A] plane does
    int damin = 2147483647;
    each([&](const Ann& x) {
        damin = min(damin, s1(x) && x.sp == spmax ? x.da : INF_E);
    });
    damin = gmin(damin, G);
    auto s2 = [&](const Ann& x) {
        return s1(x) && x.sp == spmax && x.da == damin;
    };
    unsigned any_nd = 0;
    each([&](const Ann& x) { any_nd |= s2(x) && !(x.flags & 2); });
    any_nd = gor(any_nd, G);
    auto s3 = [&](const Ann& x) {
        return s2(x) && (!any_nd || !(x.flags & 2));
    };
    int metric = INF_E, eff_min = -1;
    unsigned any_s3 = 0, self_ann = 0;
    each([&](const Ann& x) {
        if (!s3(x)) return;
        metric = min(metric, x.dist);
        eff_min = max(eff_min, x.mnh);
        any_s3 = 1;
        self_ann |= x.raw == root;
    });
    metric = gmin(metric, G);
    eff_min = gmax(eff_min, G);
    any_s3 = gor(any_s3, G);
    self_ann = gor(self_ann, G);

    // the selected announcers as 16-bit words: word w holds slots
    // 16w .. 16w + 15 (G <= 16: lane sub's slots sub + kG of the word;
    // G = 32: the half of the warp whose lanes hold the word's slots)
    for (int w = 0; w < wa; ++w) {
        unsigned bits = 0;
        if (G <= 16) {
            for (int k = 0; k < 16 / G; ++k) {
                const int j = 16 * w / G + k;
                if (j < J && s3(get(j))) bits |= 1u << (sub + k * G);
            }
        } else if ((sub >> 4) == (w & 1) && (w >> 1) < J &&
                   s3(get(w >> 1))) {
            bits = 1u << (sub & 15);
        }
        bits = gor(bits, G);
        if (lead) s3w[((long long)lane * p_cap + p) * wa + w] = (int)bits;
    }

    // next hops: slot d is one iff it is on a shortest path to a
    // min-IGP selected announcer's node; with LFA, slot d backs the row
    // up iff its link is up, it is no next hop, and its neighbour's own
    // distance to the selected announcers beats detouring back through
    // the root (strict <); the lowest alternate cost wins, the first
    // slot on ties
    int nhc = 0, best = 1 << 30, slot = -1;
    for (int w = 0; w < wd; ++w) {
        unsigned bits = 0;
        each([&](const Ann& x) {
            if (!s3(x) || x.dist != metric) return;
            for (int b = 0; b < 16; ++b) {
                const int d = 16 * w + b;
                if (d < d_cap && __ldg(root_w + d) +
                                         dist_d[(long long)d * n_cap +
                                                x.node] == x.dist)
                    bits |= 1u << b;
            }
        });
        bits = gor(bits, G);
        nhc += __popc(bits);
        if (lead) nhw[((long long)lane * p_cap + p) * wd + w] = (int)bits;
        if (!lfa_slot) continue;
        for (int b = 0; b < 16 && 16 * w + b < d_cap; ++b) {
            const int d = 16 * w + b;
            const int* row = dist_d + (long long)d * n_cap;
            int nbr = INF_E;
            each([&](const Ann& x) {
                if (s3(x)) nbr = min(nbr, row[x.node]);
            });
            nbr = gmin(nbr, G);
            const int rw = __ldg(root_w + d);
            if (rw >= INF_E || ((bits >> b) & 1)) continue;
            if (nbr >= INF_E || !(nbr < row[root] + metric)) continue;
            if (rw + nbr < best) {
                best = rw + nbr;
                slot = d;
            }
        }
    }
    if (!lead) return;
    const long long at = (long long)lane * p_cap + p;
    if (lfa_slot) {
        lfa_slot[at] = slot;
        lfa_metric[at] = slot < 0 ? 0 : best;
    }
    const bool v4_blocked = block_v4 && a_cap > 0 && (mbuf[pa + base] & 4);
    const bool ok = any_s3 && metric < INF_E && !v4_blocked && !self_ann &&
                    eff_min <= nhc && nhc > 0;
    metric_out[at] = metric;
    ok_out[at] = ok ? 1 : 0;
}

extern "C" {

// lfa_slot / lfa_metric null without LFA, dist_out null unless the node
// distances are asked for
int select_tail(const int* dist_d, const int* root_w, const int* mbuf,
                int* metric, int* s3w, int* nhw, uint8_t* ok, int* lfa_slot,
                int* lfa_metric, int* dist_out, int p_cap, int a_cap,
                int n_cap, int d_cap, int root, const int* roots, int g,
                long long mb_stride, int block_v4, cudaStream_t stream) {
    if (g < 1) return (int)cudaErrorInvalidValue;
    // lanes a row: the power of two >= A over CACHED, 1 to 32
    int group = 1;
    while (group * CACHED < a_cap && group < 32) group <<= 1;
    long long rows = ((long long)p_cap * group + THREADS - 1) / THREADS;
    long long nodes = dist_out ? ((long long)n_cap + THREADS - 1) / THREADS
                               : 0;
    long long bx = rows + nodes;
    if (bx < 1) return (int)cudaSuccess;
    select_tail_kernel<<<dim3((unsigned)bx, (unsigned)g), THREADS, 0,
                         stream>>>(
        dist_d, root_w, mbuf, metric, s3w, nhw, ok, lfa_slot, lfa_metric,
        dist_out, p_cap, a_cap, n_cap, d_cap, root, roots, mb_stride,
        block_v4, group, (int)rows);
    return (int)cudaGetLastError();
}

}  // extern "C"
