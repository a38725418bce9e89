// Legacy ELL kernels for Hopper (sm_90a): the single-graph pipeline of
// the graft entry (__graft_entry__.entry) and the all-roots batched
// SSSP. K19 and K20 read the padded in-neighbour mirror of ops/csr.py
// (in_nbr / in_w [n_cap, k_cap], -1 = pad slot; in_up [n_cap, k_cap]
// and node_over [n_cap] as bytes); K18 reads its packed form
// (ops/legacy.pack_ell): CSR by destination node, row_ptr [n_cap + 1]
// and one int2 slot (key, w) a live slot, where key is the source node
// with its overload bit in bit 31 and down links and pad slots are
// gone.
// Host loops in ops/legacy.py drive them; each entry point launches
// exactly one kernel on the caller's stream and returns
// cudaGetLastError() (or the cooperative launch's error).
//
// Replaces the jitted XLA device code of decision/tpu_solver.py:
//   K18  _sssp_kernel (:177), vmapped over roots by _jitted_sssp_batch
//        (:282): one trip (UNROLL Jacobi gather rounds, the reference's
//        run_sync body) of the distance fixpoint, and the transpose of
//        the batched tiling's root-minor plane into the vmap's
//        [R, n_cap] result
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
// Bound: K18 reads each live slot and gathers one distance a live slot
// and a root, and reads and writes its plane once a round; K19 reads
// each node's k_cap in-neighbour slots and gathers one slot byte per
// live slot; so both are bound by those bytes. K20 reads the five
// [P, A] announcer planes once plus one distance and D slot bytes per
// announcer.
//
// K18's design (one cooperative launch a trip, the rounds separated by
// grid barriers, grid-stride loops; the change flag ORed once a block a
// trip into one of two words, so the host reads one word a trip and
// never clears it):
//   - batched tiling (R >= 32 roots, ell_trip_batch): root-minor work
//     planes [n_cap, R_pad], R_pad = R rounded up to 32. A warp takes
//     one node and a column group of 32 L roots, L consecutive roots a
//     lane (TRIP_LANE_ROOTS, 8): its lanes load 32 of the node's packed
//     slots at once and pass them round by shuffles (one read of the
//     slots for the group), and each slot's gather is two 16-byte loads
//     a lane, 1 KB contiguous of the source's row a warp, with
//     TRIP_GATHERS (2) slots in flight. Items run column-group-major, so
//     the warps in flight share one group (at fabric10k 8,192 x 256
//     words, 8 MB, held in L2) and HBM sees about one read and one write
//     of the plane a round; what is left is L2 traffic, a row segment a
//     live slot, a root group and a round. Measured on an H100 (700 W;
//     a fabric10k trip, tools/relax_split.py): 1 root a lane 12.4 ms,
//     2 9.5, 4 6.6 (8 gathers in flight +30%, 2 +10%), 8 with 2 gathers
//     -8% on 4 (4 gathers +11%); 4 blocks an SM against 8 -9%, 2 +60%;
//     an SM's blocks on one run of nodes 4.5x slower (the runs' slot
//     counts are unbalanced);
//   - single-root tiling (R < 32, ell_trip_single): the caller's
//     [R, n_cap] planes, one thread a (root, node) word over its packed
//     row (8 blocks an SM: 4, 2, 1 were no faster at lsdb100k);
//   - ell_transpose: the batched result into the caller's [R, n_cap]
//     plane through a 32 x 33 shared-memory tile (coalesced both ways).
// K19: one thread per (node, slot); K20 one thread per prefix row,
// re-walking its A announcer slots once per selection stage; K19's
// change flag is reduced per block with __syncthreads_or before one
// atomicOr.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "coop.cuh"

namespace cg = cooperative_groups;

#define INF (1 << 30)
#define NEG INT_MIN
#define THREADS 256
#define WARP 32
#define FULL_MASK 0xffffffffu
// K18: blocks an SM in a trip's cooperative grid (the batched tiling's,
// the single-root tiling's); on the batched tiling, the slots whose
// gathers a lane keeps in flight and the roots a lane (consecutive
// columns, two 16-byte loads a slot)
#define TRIP_BLOCKS_PER_SM 4
#define TRIP_SINGLE_BLOCKS_PER_SM 8
#define TRIP_GATHERS 2
#define TRIP_LANE_ROOTS 8
// the source node of a packed slot's key (bit 31: the source is
// overloaded)
#define SLOT_SRC 0x7fffffff

static inline dim3 grid_for(long long n, int g) {
    long long b = (n + THREADS - 1) / THREADS;
    return dim3((unsigned)(b > 0 ? b : 1), (unsigned)g);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

// A trip's flag words: the trip ORs into flag[trip & 1]; block 0 clears
// the other word, which the host read after the previous trip (and at
// trip 0 both, before the grid barrier that precedes any OR).
__device__ __forceinline__ void trip_clear(int* flag, int trip) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        flag[(trip + 1) & 1] = 0;
        if (trip == 0) flag[0] = 0;
    }
}

__device__ __forceinline__ void trip_or(cg::grid_group& grid, int* flag,
                                        int trip, int rounds, int changed) {
    if (trip == 0 && rounds < 2) grid.sync();  // after trip 0's clear
    const int any = __syncthreads_or(changed);
    if (threadIdx.x == 0 && any) atomicOr(flag + (trip & 1), 1);
}

// K18, one trip: `rounds` Jacobi rounds, round k reading plane a (k
// even) or b (k odd) and writing the other, so an even count leaves the
// result in a. A round sets each word of row r to the minimum of the
// word and, over the node's usable packed slots (from row r's root, or
// from a node not overloaded), the source's finite distance plus the
// slot's metric. At trip 0 round 0 reads the seed plane (0 at each
// row's root, INF elsewhere) and not a.
//
// Batched tiling: a and b are [n_cap, r_pad] (word (v, c) at
// v * r_pad + c, r_pad a multiple of 32); columns r .. r_pad - 1 are
// pads, never written. A lane takes L = TRIP_LANE_ROOTS consecutive
// columns, a warp a group of 32 L; in the last group, lanes past r_pad
// read and write nothing. A lane's run of L words is two 16-byte
// accesses.
__device__ __forceinline__ void load_run(const int* p,
                                         int (&w)[TRIP_LANE_ROOTS]) {
    const int4 x = reinterpret_cast<const int4*>(p)[0];
    const int4 y = reinterpret_cast<const int4*>(p)[1];
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
    w[4] = y.x, w[5] = y.y, w[6] = y.z, w[7] = y.w;
}

__device__ __forceinline__ void store_run(int* p,
                                          const int (&w)[TRIP_LANE_ROOTS]) {
    reinterpret_cast<int4*>(p)[0] = make_int4(w[0], w[1], w[2], w[3]);
    reinterpret_cast<int4*>(p)[1] = make_int4(w[4], w[5], w[6], w[7]);
}

// One item of the batched tiling: node v and column group g (32 L
// columns, L a lane) -> whether a word changed.
__device__ __forceinline__ int trip_item(
    const int* src, int* dst, const int* __restrict__ row_ptr,
    const int2* __restrict__ slots, const int* __restrict__ roots, int v,
    int g, int lane, int r, int r_pad, bool seed) {
    constexpr int L = TRIP_LANE_ROOTS, G = TRIP_GATHERS;
    const int c = (g * WARP + lane) * L;  // the lane's first column
    const bool in_row = c < r_pad;        // then so is c + L - 1
    const int* col = src + c;  // word (u, c) at col[u * r_pad]
    const size_t at = (size_t)v * r_pad + c;
    int root[L], cur[L], acc[L];
#pragma unroll
    for (int p = 0; p < L; ++p)
        root[p] = c + p < r ? roots[c + p] : -1;
    if (seed || !in_row) {
#pragma unroll
        for (int p = 0; p < L; ++p) cur[p] = v == root[p] ? 0 : INF;
    } else {
        load_run(src + at, cur);
    }
#pragma unroll
    for (int p = 0; p < L; ++p) acc[p] = cur[p];
    const int beg = row_ptr[v], end = row_ptr[v + 1];
    for (int s0 = beg; s0 < end; s0 += WARP) {
        const int n = min(WARP, end - s0);
        const int2 mine = lane < n ? slots[s0 + lane] : make_int2(0, 0);
        for (int j = 0; j < n; j += G) {
            int du[G][L], w[G];
#pragma unroll
            for (int q = 0; q < G; ++q) {
                const int key = __shfl_sync(FULL_MASK, mine.x, j + q);
                w[q] = __shfl_sync(FULL_MASK, mine.y, j + q);
                const int u = key & SLOT_SRC;
#pragma unroll
                for (int p = 0; p < L; ++p) du[q][p] = INF;
                if (j + q < n && in_row) {
                    if (seed) {
#pragma unroll
                        for (int p = 0; p < L; ++p)
                            du[q][p] = u == root[p] ? 0 : INF;
                    } else {
                        load_run(col + (size_t)u * r_pad, du[q]);
                    }
                    // an overloaded source transits only as its own
                    // row's root
                    if (key < 0) {
#pragma unroll
                        for (int p = 0; p < L; ++p)
                            if (u != root[p]) du[q][p] = INF;
                    }
                }
            }
#pragma unroll
            for (int q = 0; q < G; ++q)
#pragma unroll
                for (int p = 0; p < L; ++p)
                    if (du[q][p] < INF)
                        acc[p] = min(acc[p], wrap_add(du[q][p], w[q]));
        }
    }
    if (c + L <= r) {
        store_run(dst + at, acc);
    } else {
#pragma unroll
        for (int p = 0; p < L; ++p)
            if (c + p < r) dst[at + p] = acc[p];
    }
    int changed = 0;
#pragma unroll
    for (int p = 0; p < L; ++p)
        changed |= c + p < r && acc[p] != cur[p];
    return changed;
}

__global__ void __launch_bounds__(THREADS) ell_trip_batch_kernel(
    int* a, int* b, const int* __restrict__ row_ptr,
    const int2* __restrict__ slots, const int* __restrict__ roots,
    int n_cap, int r, int r_pad, int rounds, int trip, int* flag) {
    constexpr int L = TRIP_LANE_ROOTS;
    cg::grid_group grid = cg::this_grid();
    trip_clear(flag, trip);
    const int lane = threadIdx.x & (WARP - 1);
    const int groups = (r_pad + WARP * L - 1) / (WARP * L);
    const unsigned warp0 = (blockIdx.x * THREADS + threadIdx.x) / WARP;
    const unsigned warps = gridDim.x * (THREADS / WARP);
    const unsigned items = (unsigned)groups * (unsigned)n_cap;
    int changed = 0;
    for (int k = 0; k < rounds; ++k) {
        if (k) grid.sync();
        const bool seed = trip == 0 && k == 0;
        const int* src = (k & 1) ? b : a;
        int* dst = (k & 1) ? a : b;
        for (unsigned it = warp0; it < items; it += warps) {
            const int g = (int)(it / (unsigned)n_cap);
            const int v = (int)(it - (unsigned)g * n_cap);
            changed |= trip_item(src, dst, row_ptr, slots, roots, v, g,
                                 lane, r, r_pad, seed);
        }
    }
    trip_or(grid, flag, trip, rounds, changed);
}

// K18, one trip on the single-root tiling: a and b are [r, n_cap] (the
// caller's layout), one thread a word.
__global__ void __launch_bounds__(THREADS) ell_trip_single_kernel(
    int* a, int* b, const int* __restrict__ row_ptr,
    const int2* __restrict__ slots, const int* __restrict__ roots,
    int n_cap, int r, int rounds, int trip, int* flag) {
    cg::grid_group grid = cg::this_grid();
    trip_clear(flag, trip);
    const long long items = (long long)r * n_cap;
    const long long stride = (long long)gridDim.x * THREADS;
    int changed = 0;
    for (int k = 0; k < rounds; ++k) {
        if (k) grid.sync();
        const bool seed = trip == 0 && k == 0;
        const int* src = (k & 1) ? b : a;
        int* dst = (k & 1) ? a : b;
        for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
             i < items; i += stride) {
            const int row = (int)(i / n_cap);
            const int v = (int)(i - (long long)row * n_cap);
            const int root = roots[row];
            const int* dist = src + (size_t)row * n_cap;
            const int cur = seed ? (v == root ? 0 : INF) : dist[v];
            int acc = cur;
            const int end = row_ptr[v + 1];
            for (int s = row_ptr[v]; s < end; ++s) {
                const int2 sl = slots[s];
                const int u = sl.x & SLOT_SRC;
                if (sl.x < 0 && u != root) continue;
                const int du = seed ? (u == root ? 0 : INF) : dist[u];
                if (du < INF) acc = min(acc, wrap_add(du, sl.y));
            }
            dst[i] = acc;
            changed |= acc != cur;
        }
    }
    trip_or(grid, flag, trip, rounds, changed);
}

// K18's last step on the batched tiling: out[c, v] = plane[v, c] for
// c < r, a 32 x 32 tile a block (x: node tiles, y: column tiles).
__global__ void __launch_bounds__(WARP * 8) ell_transpose_kernel(
    const int* __restrict__ plane, int* __restrict__ out, int n_cap, int r,
    int r_pad) {
    __shared__ int tile[WARP][WARP + 1];
    const int v0 = blockIdx.x * WARP, c0 = blockIdx.y * WARP;
    const int tx = threadIdx.x & (WARP - 1), ty = threadIdx.x / WARP;
    for (int j = ty; j < WARP; j += 8) {
        const int v = v0 + j, c = c0 + tx;
        if (v < n_cap && c < r) tile[j][tx] = plane[(size_t)v * r_pad + c];
    }
    __syncthreads();
    for (int j = ty; j < WARP; j += 8) {
        const int c = c0 + j, v = v0 + tx;
        if (c < r && v < n_cap) out[(size_t)c * n_cap + v] = tile[tx][j];
    }
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

static inline bool aligned8(const void* p) {
    return ((uintptr_t)p & 7) == 0;
}

// One cooperative launch of `fn` on at most `blocks` blocks and at most
// `per_sm` an SM, all co-resident.
static int launch_trip(const void* fn, long long blocks, int per_sm,
                       int* grid_cache, void** args, cudaStream_t stream) {
    int nb = (int)max(1LL, min(blocks, (long long)coop_grid(
                                           fn, THREADS, per_sm, grid_cache)));
    cudaError_t rc = cudaLaunchCooperativeKernel(fn, dim3(nb), dim3(THREADS),
                                                 args, 0, stream);
    return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

int ell_trip_batch(int* a, int* b, const int* row_ptr, const int* slots,
                   const int* roots, int n_cap, int r, int r_pad,
                   int rounds, int trip, int* flag, cudaStream_t stream) {
    const int width = WARP * TRIP_LANE_ROOTS;
    const long long items = (long long)((r_pad + width - 1) / width) * n_cap;
    if (rounds < 1 || r < 0 || r_pad < r || r_pad % WARP ||
        items > INT_MAX || !aligned8(slots) ||
        ((uintptr_t)a | (uintptr_t)b) % (4 * TRIP_LANE_ROOTS))
        return (int)cudaErrorInvalidValue;
    static int grid[64];
    void* args[] = {&a,     &b, &row_ptr, &slots, &roots, &n_cap,
                    &r,     &r_pad, &rounds, &trip, &flag};
    return launch_trip((const void*)ell_trip_batch_kernel,
                       (items * WARP + THREADS - 1) / THREADS,
                       TRIP_BLOCKS_PER_SM, grid, args, stream);
}

int ell_trip_single(int* a, int* b, const int* row_ptr, const int* slots,
                    const int* roots, int n_cap, int r, int rounds,
                    int trip, int* flag, cudaStream_t stream) {
    if (rounds < 1 || r < 0 || !aligned8(slots))
        return (int)cudaErrorInvalidValue;
    static int grid[64];
    void* args[] = {&a, &b, &row_ptr, &slots, &roots, &n_cap,
                    &r, &rounds, &trip, &flag};
    return launch_trip((const void*)ell_trip_single_kernel,
                       ((long long)r * n_cap + THREADS - 1) / THREADS,
                       TRIP_SINGLE_BLOCKS_PER_SM, grid, args, stream);
}

int ell_transpose(const int* plane, int* out, int n_cap, int r, int r_pad,
                  cudaStream_t stream) {
    const long long tiles_v = (n_cap + WARP - 1) / WARP;
    const long long tiles_c = (r + WARP - 1) / WARP;
    if (r_pad < r || tiles_c > 65535) return (int)cudaErrorInvalidValue;
    if (tiles_v == 0 || tiles_c == 0) return 0;
    ell_transpose_kernel<<<dim3((unsigned)tiles_v, (unsigned)tiles_c),
                           WARP * 8, 0, stream>>>(plane, out, n_cap, r,
                                                  r_pad);
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
