// Best-route selection for Hopper (sm_90a): the tail of the cold
// Decision pipeline that turns the [D, n_cap] per-slot distance planes
// into per-prefix routes. Each entry point launches one kernel on the
// caller's stream and returns cudaGetLastError().
//
// Replaces (K3) the jitted XLA tail of decision/tpu_solver.py::
// _make_pipeline (root distance + ECMP predicate, the reference-order
// selection, the next-hop mask), _pack_words, and
// ops/compact.py::route_ok_device.
//
// Bound: bytes. The node pass reads the [D, n_cap] plane once and
// writes one distance and one ECMP bit word per node; the prefix pass
// reads the six [P, A] announcer planes once plus one gathered distance
// and bit word per announcer, and writes four [P]-sized outputs. There
// are a handful of integer compares per loaded word. Design: one thread
// per node, then one thread per prefix row; a row re-walks its A
// announcer slots once per selection stage instead of holding [A]
// temporaries, so any announcer width fits in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#define INF_E (1 << 29)
#define NEG (-2147483647 - 1)
#define THREADS 256

static inline unsigned blocks_for(long long n) {
    long long b = (n + THREADS - 1) / THREADS;
    return (unsigned)(b > 0 ? b : 1);
}

// node pass: via[d,u] = root_w[d] + dist_d[d,u]; dist[u] =
// min(min_d via, INF_E) with dist[root] = 0; ECMP bit d of node u is
// (via[d,u] == dist[u]), 32 lanes per uint32 word (w32 words a node).
__global__ void select_nodes_kernel(
    const int* __restrict__ dist_d, const int* __restrict__ root_w,
    int* __restrict__ dist, uint32_t* __restrict__ onsp, int d_cap,
    int n_cap, int w32, int root) {
    int u = blockIdx.x * blockDim.x + threadIdx.x;
    if (u >= n_cap) return;
    int m = INF_E;
    for (int d = 0; d < d_cap; ++d)
        m = min(m, root_w[d] + dist_d[(long long)d * n_cap + u]);
    if (u == root) m = 0;
    dist[u] = m;
    for (int w = 0; w < w32; ++w) {
        uint32_t bits = 0;
        for (int b = 0; b < 32; ++b) {
            int d = w * 32 + b;
            if (d < d_cap &&
                root_w[d] + dist_d[(long long)d * n_cap + u] == m)
                bits |= 1u << b;
        }
        onsp[(long long)u * w32 + w] = bits;
    }
}

// prefix pass over the packed announcer matrix mbuf = six [P, A] int32
// planes (ann_node, flags, path_pref, source_pref, dist_adv, min_nh);
// flags bit 0 = valid, bit 1 = announcer drained, bit 2 (slot 0) = v4.
__global__ void select_prefixes_kernel(
    const int* __restrict__ mbuf, const int* __restrict__ dist,
    const uint32_t* __restrict__ onsp, int* __restrict__ metric_out,
    int* __restrict__ s3w, int* __restrict__ nhw,
    uint8_t* __restrict__ ok_out, int p_cap, int a_cap, int n_cap,
    int d_cap, int w32, int root, int block_v4) {
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= p_cap) return;
    const long long pa = (long long)p_cap * a_cap;
    const long long base = (long long)p * a_cap;
    const int* ann_node = mbuf + base;
    const int* flags = mbuf + pa + base;
    const int* path_pref = mbuf + 2 * pa + base;
    const int* source_pref = mbuf + 3 * pa + base;
    const int* dist_adv = mbuf + 4 * pa + base;
    const int* min_nh = mbuf + 5 * pa + base;
    const int hi = n_cap - 1;
#define ANN_DIST(a) dist[min(max(ann_node[a], 0), hi)]
#define REACH(a) ((flags[a] & 1) && ANN_DIST(a) < INF_E)

    int ppmax = NEG;
    for (int a = 0; a < a_cap; ++a)
        ppmax = max(ppmax, REACH(a) ? path_pref[a] : NEG);
#define S1(a) (REACH(a) && path_pref[a] == ppmax)
    int spmax = NEG;
    for (int a = 0; a < a_cap; ++a)
        spmax = max(spmax, S1(a) ? source_pref[a] : NEG);
#define S(a) (S1(a) && source_pref[a] == spmax)
    // starts past every value so an all-selected row keeps its own
    // minimum, as a min over the [A] plane does
    int damin = 2147483647;
    for (int a = 0; a < a_cap; ++a)
        damin = min(damin, S(a) ? dist_adv[a] : INF_E);
#define S2(a) (S(a) && dist_adv[a] == damin)
    bool any_nd = false;
    for (int a = 0; a < a_cap; ++a) any_nd |= S2(a) && !(flags[a] & 2);
#define S3(a) (any_nd ? (S2(a) && !(flags[a] & 2)) : S2(a))
    int metric = INF_E;
    for (int a = 0; a < a_cap; ++a)
        metric = min(metric, S3(a) ? ANN_DIST(a) : INF_E);

    const int wa = (a_cap + 15) / 16;
    const int wd = (d_cap + 15) / 16;
    bool any_s3 = false, self_ann = false;
    int eff_min = -1;
    for (int w = 0; w < wa; ++w) {
        int word = 0;
        for (int b = 0; b < 16; ++b) {
            int a = w * 16 + b;
            if (a < a_cap && S3(a)) {
                word |= 1 << b;
                any_s3 = true;
                self_ann |= ann_node[a] == root;
                eff_min = max(eff_min, min_nh[a]);
            }
        }
        s3w[(long long)p * wa + w] = word;
    }
    // next hops: union over the min-IGP announcers of their nodes' ECMP
    // bits, regrouped from 32-lane words into 16-bit output words
    int nhc = 0;
    for (int w = 0; w < wd; ++w) {
        uint32_t word = 0;
        for (int a = 0; a < a_cap; ++a) {
            if (S3(a) && ANN_DIST(a) == metric) {
                int node = min(max(ann_node[a], 0), hi);
                uint32_t bits = onsp[(long long)node * w32 + (w >> 1)];
                word |= (bits >> ((w & 1) * 16)) & 0xFFFFu;
            }
        }
        if (w == wd - 1 && (d_cap & 15))
            word &= (1u << (d_cap & 15)) - 1u;
        nhw[(long long)p * wd + w] = (int)word;
        nhc += __popc(word);
    }
#undef ANN_DIST
#undef REACH
#undef S1
#undef S
#undef S2
#undef S3
    bool v4_blocked = block_v4 && a_cap > 0 && (flags[0] & 4);
    bool ok = any_s3 && metric < INF_E && !v4_blocked && !self_ann &&
              eff_min <= nhc && nhc > 0;
    metric_out[p] = metric;
    ok_out[p] = ok ? 1 : 0;
}

extern "C" {

int select_nodes(const int* dist_d, const int* root_w, int* dist,
                 uint32_t* onsp, int d_cap, int n_cap, int root,
                 cudaStream_t stream) {
    int w32 = (d_cap + 31) / 32;
    select_nodes_kernel<<<blocks_for(n_cap), THREADS, 0, stream>>>(
        dist_d, root_w, dist, onsp, d_cap, n_cap, w32, root);
    return (int)cudaGetLastError();
}

int select_prefixes(const int* mbuf, const int* dist, const uint32_t* onsp,
                    int* metric, int* s3w, int* nhw, uint8_t* ok,
                    int p_cap, int a_cap, int n_cap, int d_cap, int root,
                    int block_v4, cudaStream_t stream) {
    int w32 = (d_cap + 31) / 32;
    select_prefixes_kernel<<<blocks_for(p_cap), THREADS, 0, stream>>>(
        mbuf, dist, onsp, metric, s3w, nhw, ok, p_cap, a_cap, n_cap, d_cap,
        w32, root, block_v4);
    return (int)cudaGetLastError();
}

}  // extern "C"
