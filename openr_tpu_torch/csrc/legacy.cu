// Legacy ELL kernels for Hopper (sm_90a): the single-graph pipeline of
// the graft entry (__graft_entry__.entry) and the all-roots batched
// SSSP, over the padded in-neighbour mirror of ops/csr.py (in_nbr /
// in_w [n_cap, k_cap], -1 = pad slot; in_up [n_cap, k_cap] and
// node_over [n_cap] as bytes).
// Host loops in ops/legacy.py drive them; each entry point launches
// exactly one kernel on the caller's stream and returns
// cudaGetLastError().
//
// Replaces the jitted XLA device code of decision/tpu_solver.py:
//   K18  _sssp_kernel (:177), vmapped over roots by _jitted_sssp_batch
//        (:282): one Jacobi gather round of the distance fixpoint
//   K19  _next_hop_kernel (:197): one round of the first-hop slot-mask
//        fixpoint over the shortest-path DAG
//   K20  _select_metric_kernel + _select_kernel (:225, :248): per-prefix
//        best-route selection and the next-hop union
//
// INF = 2^30 (ops/csr.py's INF32), not the shift mirror's 2^29. Sums
// of a distance and a link metric are taken modulo 2^32, as the
// reference's int32 adds wrap. A pad slot (in_nbr = -1) is skipped
// before any read: the reference reads row n - 1 there and masks the
// value away.
//
// Bound: K18 and K19 read each node's k_cap in-neighbour slots (index,
// metric, up) and gather one distance (or slot byte) per live slot, so
// they are bound by those bytes; K20 reads the five [P, A] announcer
// planes once plus one distance and D slot bytes per announcer. Design:
// one thread per output word in plain global memory (no shared-memory
// row): K18 one thread per (root, node), the root on the grid's y
// dimension; K19 one thread per (node, slot); K20 one thread per prefix
// row, re-walking its A announcer slots once per selection stage. The
// change flag is reduced per block with __syncthreads_or before one
// atomicOr.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define INF (1 << 30)
#define NEG INT_MIN
#define THREADS 256

static inline dim3 grid_for(long long n, int g) {
    long long b = (n + THREADS - 1) / THREADS;
    return dim3((unsigned)(b > 0 ? b : 1), (unsigned)g);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

// K18: out[r, v] = min(dist[r, v], min over usable slots k of
// dist[r, u] + in_w[v, k]), u = in_nbr[v, k]. A slot is usable iff it
// is real, its link is up, and u is the row's root or not overloaded
// (an overloaded node transits only as the root). With `seed` set,
// `dist` is not read: the round relaxes the seed plane (0 at the row's
// root, INF elsewhere).
__global__ void ell_relax_kernel(
    const int* __restrict__ dist, int* __restrict__ out,
    const int* __restrict__ in_nbr, const int* __restrict__ in_w,
    const uint8_t* __restrict__ in_up, const uint8_t* __restrict__ node_over,
    const int* __restrict__ roots, int n_cap, int k_cap, int seed,
    int* __restrict__ flag) {
    const int r = blockIdx.y;
    const int v = blockIdx.x * blockDim.x + threadIdx.x;
    int changed = 0;
    if (v < n_cap) {
        const int root = roots[r];
        const int* row = dist + (long long)r * n_cap;
        const int cur = seed ? (v == root ? 0 : INF) : row[v];
        int acc = cur;
        const long long base = (long long)v * k_cap;
        for (int k = 0; k < k_cap; ++k) {
            const int u = in_nbr[base + k];
            if (u < 0 || !in_up[base + k]) continue;
            if (u != root && node_over[u]) continue;
            const int du = seed ? (u == root ? 0 : INF) : row[u];
            if (du >= INF) continue;
            acc = min(acc, wrap_add(du, in_w[base + k]));
        }
        out[(long long)r * n_cap + v] = acc;
        changed = acc != cur;
    }
    int any = __syncthreads_or(changed);
    if (threadIdx.x == 0 && any) atomicOr(flag, 1);
}

// the seed of K19: slot d starts at its own neighbour when the slot is
// real, its link up and the neighbour's distance is the slot's metric
__device__ __forceinline__ bool nh_seed(
    int v, int d, const int* __restrict__ dist,
    const int* __restrict__ root_nbr, const int* __restrict__ root_w,
    const uint8_t* __restrict__ root_up, int n_cap) {
    const int rn = root_nbr[d];
    return rn == v && rn >= 0 && root_up[d] &&
           dist[min(max(rn, 0), n_cap - 1)] == root_w[d];
}

// K19: out[v, d] = seed[v, d] | OR over parent slots k of nh[u, d],
// where slot k is a parent iff it is real, up, u is not the root, not
// overloaded, reachable, and dist[u] + in_w[v, k] == dist[v]. With
// `seed` set, `nh` is not read: the round propagates the seed plane.
__global__ void ell_next_hop_kernel(
    const uint8_t* __restrict__ nh, uint8_t* __restrict__ out,
    const int* __restrict__ dist, const int* __restrict__ in_nbr,
    const int* __restrict__ in_w, const uint8_t* __restrict__ in_up,
    const uint8_t* __restrict__ node_over, const int* __restrict__ root_nbr,
    const int* __restrict__ root_w, const uint8_t* __restrict__ root_up,
    int root, int n_cap, int k_cap, int d_cap, int seed,
    int* __restrict__ flag) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int changed = 0;
    if (i < (long long)n_cap * d_cap) {
        const int v = (int)(i / d_cap);
        const int d = (int)(i - (long long)v * d_cap);
        const bool sd = nh_seed(v, d, dist, root_nbr, root_w, root_up, n_cap);
        const bool cur = seed ? sd : nh[i] != 0;
        bool acc = sd;
        const int dv = dist[v];
        const long long base = (long long)v * k_cap;
        for (int k = 0; k < k_cap && !acc; ++k) {
            const int u = in_nbr[base + k];
            if (u < 0 || !in_up[base + k] || u == root || node_over[u])
                continue;
            const int du = dist[u];
            if (du >= INF || wrap_add(du, in_w[base + k]) != dv) continue;
            acc = seed ? nh_seed(u, d, dist, root_nbr, root_w, root_up, n_cap)
                       : nh[(long long)u * d_cap + d] != 0;
        }
        out[i] = acc ? 1 : 0;
        changed = acc != cur;
    }
    int any = __syncthreads_or(changed);
    if (threadIdx.x == 0 && any) atomicOr(flag, 1);
}

// K20: per prefix row, over its A announcer slots: reachable (valid,
// distance < INF), then the highest path preference, the highest
// source preference, the lowest advertised distance; the not-drained
// ones among those unless all are drained (s3); the lowest IGP
// distance among s3 (metric); the union of the slot masks of the s3
// announcers at that distance (nh_mask); a route iff s3 is not empty
// and the metric < INF.
__global__ void ell_select_kernel(
    const int* __restrict__ dist, const uint8_t* __restrict__ nh,
    const uint8_t* __restrict__ node_over, const int* __restrict__ ann_node,
    const uint8_t* __restrict__ ann_valid, const int* __restrict__ path_pref,
    const int* __restrict__ source_pref, const int* __restrict__ dist_adv,
    int* __restrict__ metric_out, uint8_t* __restrict__ s3_out,
    uint8_t* __restrict__ nh_out, uint8_t* __restrict__ has_route,
    int p_cap, int a_cap, int n_cap, int d_cap) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= p_cap) return;
    const long long base = (long long)p * a_cap;
    ann_node += base;
    ann_valid += base;
    path_pref += base;
    source_pref += base;
    dist_adv += base;
    const int hi = n_cap - 1;
#define IDX(a) min(max(ann_node[a], 0), hi)
#define ANN_DIST(a) dist[IDX(a)]
#define REACH(a) (ann_valid[a] && ANN_DIST(a) < INF)
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
    int damin = INT_MAX;
    for (int a = 0; a < a_cap; ++a)
        damin = min(damin, S(a) ? dist_adv[a] : INF);
#define S2(a) (S(a) && dist_adv[a] == damin)
    bool any_nd = false;
    for (int a = 0; a < a_cap; ++a) any_nd |= S2(a) && !node_over[IDX(a)];
#define S3(a) (any_nd ? (S2(a) && !node_over[IDX(a)]) : S2(a))
    int metric = INT_MAX;
    bool any_s3 = false;
    for (int a = 0; a < a_cap; ++a) {
        const bool s3 = S3(a);
        metric = min(metric, s3 ? ANN_DIST(a) : INF);
        s3_out[base + a] = s3 ? 1 : 0;
        any_s3 |= s3;
    }
    for (int d = 0; d < d_cap; ++d) {
        bool hit = false;
        for (int a = 0; a < a_cap && !hit; ++a)
            hit = S3(a) && ANN_DIST(a) == metric &&
                  nh[(long long)IDX(a) * d_cap + d];
        nh_out[(long long)p * d_cap + d] = hit ? 1 : 0;
    }
#undef IDX
#undef ANN_DIST
#undef REACH
#undef S1
#undef S
#undef S2
#undef S3
    metric_out[p] = metric;
    has_route[p] = (any_s3 && metric < INF) ? 1 : 0;
}

extern "C" {

int ell_relax(const int* dist, int* out, const int* in_nbr, const int* in_w,
              const uint8_t* in_up, const uint8_t* node_over,
              const int* roots, int n_cap, int k_cap, int r, int seed,
              int* flag, cudaStream_t stream) {
    ell_relax_kernel<<<grid_for(n_cap, r), THREADS, 0, stream>>>(
        dist, out, in_nbr, in_w, in_up, node_over, roots, n_cap, k_cap, seed,
        flag);
    return (int)cudaGetLastError();
}

int ell_next_hop(const uint8_t* nh, uint8_t* out, const int* dist,
                 const int* in_nbr, const int* in_w, const uint8_t* in_up,
                 const uint8_t* node_over, const int* root_nbr,
                 const int* root_w, const uint8_t* root_up, int root,
                 int n_cap, int k_cap, int d_cap, int seed, int* flag,
                 cudaStream_t stream) {
    ell_next_hop_kernel<<<grid_for((long long)n_cap * d_cap, 1), THREADS, 0,
                          stream>>>(
        nh, out, dist, in_nbr, in_w, in_up, node_over, root_nbr, root_w,
        root_up, root, n_cap, k_cap, d_cap, seed, flag);
    return (int)cudaGetLastError();
}

int ell_select(const int* dist, const uint8_t* nh, const uint8_t* node_over,
               const int* ann_node, const uint8_t* ann_valid,
               const int* path_pref, const int* source_pref,
               const int* dist_adv, int* metric, uint8_t* s3,
               uint8_t* nh_mask, uint8_t* has_route, int p_cap, int a_cap,
               int n_cap, int d_cap, cudaStream_t stream) {
    ell_select_kernel<<<grid_for(p_cap, 1), THREADS, 0, stream>>>(
        dist, nh, node_over, ann_node, ann_valid, path_pref, source_pref,
        dist_adv, metric, s3, nh_mask, has_route, p_cap, a_cap, n_cap,
        d_cap);
    return (int)cudaGetLastError();
}

}  // extern "C"
