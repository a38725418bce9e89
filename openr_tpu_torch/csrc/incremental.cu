// Incremental SSSP kernels for Hopper (sm_90a): the churn solve's dirty
// scatter, parent forest and affected cone (ops/incremental.py drives
// them and documents the algorithm). Each entry point launches exactly
// one kernel on the caller's stream and returns cudaGetLastError().
//
// Replaces the jitted XLA device code of the JAX package:
//   K5  decision/tpu_solver.py::_scatter_jit            flat .at[idx].set,
//       both planes of a sync in one launch
//   K5 old planes  ops/incremental.py::_old_planes with incremental_sssp's
//       root mask (:150-162): the new resident plane copied once with
//       the dirty slots' pre-drain values put back and the root's slots
//       at INF_E, one launch a plane
//   K6  ops/incremental.py::_parent_plane               parent forest
//   K7  ops/incremental.py::incremental_sssp, :169-205  cone seeds
//   K8 + K9  ops/incremental.py::incremental_sssp, :207-254: the aff
//       while-loop, cone = aff.sum(), fell_back = cone > cone_limit and
//       the warm or cold seed plane, as one cooperative launch a solve
//       (cone_fix; K9's seed plane alone, cone_plane, for the tier)
// and, with a window of columns (or rows) per shard, their multichip
// variants in parallel/sharding.py::make_mc_incremental_sssp:
//   K5 [mc]  global flat indices translated to the shard's window, the
//            rest dropped (:494-516; decision/tpu_solver.py::
//            _mc_scatter_jit, :1113, the in-place sharded scatter: every
//            part a card holds in one launch, scatter_parts)
//   K6 [mc]  tight edges over the shard's own source columns (:527-551;
//            the group then takes the max of its members' planes)
//   K7 [mc]  the dirty slots' new weights read from the owning shard
//            (:575-580; min over the group), and the seeds from those
//            combined weights (:581-598)
//   K8 [mc]  a member's spread to the closure and its own count
//            (cone_fix without a plane; the group's count is member 0's,
//            summed over the batch groups by K23)
//   K9 [mc]  the seed plane from a given cone (cone_plane, :652-655)
//
// Bound: bytes. K6 and K9's plane stream [D, n_cap] int32 planes once
// (K6 also the [s_cap, n_cap] old weights) with a handful of integer
// ops per word; the old planes read and write their plane once; K7
// writes its [D, n_cap] plane once; K5 touches a few thousand dirty
// entries; the cone's function needs the parent, cone and previous (or
// cold) planes read once and the seed plane written once, 4 D n_cap
// words at any depth, where cone_fix streams the parent and cone planes
// once a sweep, then the cone and the previous plane once more and the
// seed plane: (2 s + 3) D n_cap words for s sweeps. Design: one thread
// per (lane, node) (K6: per node and chunk of lanes) or per dirty
// entry, neighbouring threads on neighbouring nodes, so plane loads
// coalesce except the parent gathers, which follow the forest.
//
// Tiled writes (the old planes, K7): each block owns a tile of its
// output, writes all of it, and after __syncthreads() (which orders the
// block's earlier global writes before its later ones) walks the dirty
// list, patching only the entries that fall in its tile. So one launch
// replaces a copy or fill followed by a scatter, with no race: no other
// block writes the tile. Every block reads the whole list, so the host
// widens the old planes' tile until those reads stay under four times
// the plane; K7's lists are a bucket of dirty slots against a plane of
// D x n_cap words. An entry's (head, source, increased) is computed
// once per block by one thread, which then tries every lane, so the
// lanes share it.
//
// Exactness: every tie-break of the JAX functions is kept because the
// cone rides the pull buffers. K6 takes the lowest tight shift class,
// then fills nodes still without a parent from their residual row,
// first tight slot first; residual rows are unique per node, so each
// (row, lane chunk) thread owns its node's words. Pad rows (res_rows == -1) are skipped, never
// clipped onto node 0. K7's ones and K9's count commute, so their
// store order does not matter (K7's zeros precede its ones, above).
// The old planes need unique in-range dirty indices, as K5 does (the
// lists are consolidated, ops/edgeplan._consolidate).
//
// Index arithmetic: n_cap is a power of two, so the class-k edge u -> v
// with v = (u + δ_k) mod n_cap has u = (v - δ_k) & (n_cap - 1) in
// unsigned arithmetic, exact for any int32 shift. INF discipline:
// weights <= 2^28, INF_E = 2^29, every sum <= 2^30.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "coop.cuh"

namespace cg = cooperative_groups;

#define INF_E (1 << 29)
#define THREADS 256

static inline unsigned blocks_for(long long n) {
    long long b = (n + THREADS - 1) / THREADS;
    return (unsigned)(b > 0 ? b : 1);
}

// K5, the scatter of a sync: segment a's entries into plane a, then
// segment b's into plane b, in one launch (the shift and residual planes'
// drained slots; the caller stages both segments in one buffer):
// plane[idx[i]] = vals[i] for idx[i] in [0, numel), other entries drop.
// Thread i < n_a takes a's entry i, the next n_b threads b's entries.
__global__ void scatter_set_kernel(int* a, const int* idx_a,
                                   const int* vals_a, int n_a, int numel_a,
                                   int* b, const int* idx_b,
                                   const int* vals_b, int n_b, int numel_b) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool in_a = i < n_a;
    if (!in_a) i -= n_a;
    if (!in_a && i >= n_b) return;
    int* plane = in_a ? a : b;
    const int f = (in_a ? idx_a : idx_b)[i];
    if (f >= 0 && f < (in_a ? numel_a : numel_b))
        plane[f] = (in_a ? vals_a : vals_b)[i];
}

// K5 old planes: out = plane, with vals[j] at flat idx[j] for the
// entries inside this block's tile [lo, lo + tile) (pads and other
// tiles' entries drop), and INF_E at every slot whose key is the root:
// the key is the slot's column, or nbr at the slot where nbr is given
// (the residual's source node); root < 0 masks nothing. The root wins
// over a dirty value, as the reference masks after the scatter.
__global__ void old_plane_kernel(const int* __restrict__ plane,
                                 const int* __restrict__ nbr,
                                 const int* __restrict__ idx,
                                 const int* __restrict__ vals, int n_idx,
                                 int* __restrict__ out, int rows, int cols,
                                 int root, long long tile) {
    const long long numel = (long long)rows * cols;
    const long long lo = (long long)blockIdx.x * tile;
    const long long hi = min(lo + tile, numel);
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        int key = nbr ? nbr[i] : (int)(i % cols);
        out[i] = (root >= 0 && key == root) ? INF_E : plane[i];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < n_idx; j += blockDim.x) {
        long long f = idx[j];
        if (f < lo || f >= hi) continue;
        int key = nbr ? nbr[f] : (int)(f % cols);
        if (root >= 0 && key == root) continue;
        out[f] = vals[j];
    }
}

// K5 [mc]: f is a flat index into a global [rows, cols] plane; a shard
// holds the window [row0, row0 + w_rows) x [col0, col0 + w_cols) as a
// [w_rows, w_cols] plane. An entry inside the window is set at its local
// index, every other entry (foreign or pad) drops.
__device__ __forceinline__ void window_put(int* plane, int f, int v,
                                           int rows, int cols, int row0,
                                           int w_rows, int col0,
                                           int w_cols) {
    if (f < 0 || (long long)f >= (long long)rows * cols) return;
    const int lr = f / cols - row0;
    const int lc = f % cols - col0;
    if (lr < 0 || lr >= w_rows || lc < 0 || lc >= w_cols) return;
    plane[(long long)lr * w_cols + lc] = v;
}

// K5 [mc] into one window (the tier's old planes, made afresh a solve)
__global__ void scatter_window_kernel(int* __restrict__ plane,
                                      const int* __restrict__ idx,
                                      const int* __restrict__ vals, int n,
                                      int rows, int cols, int row0,
                                      int w_rows, int col0, int w_cols) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    window_put(plane, idx[i], vals[i], rows, cols, row0, w_rows, col0,
               w_cols);
}

// K5 [mc] into every distinct part of a resident sharded array that one
// card holds, in one launch: table row p = (part address, row0, col0,
// w_rows, w_cols), built once for the placed array; thread (i, p) puts
// entry i into part p (blockIdx.y = p).
__global__ void scatter_parts_kernel(const int64_t* __restrict__ table,
                                     const int* __restrict__ idx,
                                     const int* __restrict__ vals, int n,
                                     int rows, int cols) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int64_t* t = table + 5 * (long long)blockIdx.y;
    window_put(reinterpret_cast<int*>(t[0]), idx[i], vals[i], rows, cols,
               (int)t[1], (int)t[3], (int)t[2], (int)t[4]);
}

// K6: par[d, v] = the old shortest-path parent of v in lane d. Shift
// phase: (v - δ_k) mod n for the lowest class k whose old edge into v is
// tight under prev (both ends finite, prev[u] + w == prev[v]), else -1;
// K6 [mc] counts only the sources in the shard's column window [col0,
// col0 + w_cols), their old weights read from its [s_cap, w_cols] plane
// (a source outside weighs INF_E: never tight). Residual phase: each
// valid row r (node v = rows[r]; pad rows, -1, skipped) fills the lanes
// where v is still at -1 with the first slot j whose old edge
// nbr[r, j] -> v is tight (its source clipped into the plane for the
// read, written as given).
//
// Design (as K1's relax_step): a thread takes one node and DC lanes in
// registers (the host picks DC, 8 to 1, keeping PARENT_MIN_THREADS
// threads), so a class's old weight and shift are loaded once for DC
// lanes; the lowest tight class is picked with selects, no per-thread
// break, so the unrolled classes' loads go out together (without a
// residual the warp leaves the loop together, below); tile index math
// is 32-bit. A residual row likewise reads its slots once for DC lanes and
// stops once every open lane has its parent. Without a residual: a
// plain launch. With one, the residual phase reads the shift result of
// its own node, so the launch is cooperative (the grid from coop_grid,
// at most PARENT_BLOCKS_PER_SM blocks an SM) with one grid barrier
// between the phases; residual rows are unique per node, so the one
// thread of a (row, lane chunk) is the only writer of its words after
// the barrier. With deltas null only the residual phase runs (K6's fill
// after the tier's max over its members' shift parts), a plain launch.
#define PARENT_BLOCKS_PER_SM 8
// Without a residual the class loop stops, after each PARENT_EXIT_EVERY
// classes, once every lane of every thread of the warp has its parent
// (a warp-uniform exit: __all_sync); with one (the cooperative launch)
// it loads every class. Device ms on an H100 80GB HBM3 at 700 W
// (tools/relax_split.py --define): lsdb100k 0.00589-0.00592 with the
// exit every 2 classes against 0.00599-0.00606 loading every class (1
// and 4 no better); fabric10k's residual launch 0.0229-0.0235 with the
// exit every 1, 2 or 4 classes against 0.0218-0.0219 without.
#ifndef PARENT_EXIT_EVERY
#define PARENT_EXIT_EVERY 2
#endif
// 2^18: lsdb100k's 4 x 131072 at DC 2 (fabric10k's 8 x 8192 takes DC
// 1 at any target from 2^16 up), chosen on the H100 from scratch builds
// at 2^16 to 2^19
#define PARENT_MIN_THREADS (1 << 18)

template <int DC, int EXIT>
__global__ void __launch_bounds__(THREADS) parent_kernel(
    const int* __restrict__ deltas, const int* __restrict__ swm,
    const int* __restrict__ prev, int* par, const int* __restrict__ rows,
    const int* __restrict__ nbr, const int* __restrict__ rwm, int s_cap,
    int n_cap, int d_cap, int col0, int w_cols, int r_cap, int kr_cap) {
    const int t = threadIdx.x;
    const unsigned hi = (unsigned)n_cap - 1u;
    const int d_chunks = (d_cap + DC - 1) / DC;
    if (deltas) {
        const int u_tiles = (n_cap + THREADS - 1) / THREADS;
        for (int tile = blockIdx.x; tile < d_chunks * u_tiles;
             tile += gridDim.x) {
            const int c = tile / u_tiles;
            const int d0 = c * DC;
            const unsigned v = (unsigned)(tile - c * u_tiles) * THREADS + t;
            // the warp's threads on the plane (every thread of the warp
            // runs the same tiles, so all reach the ballot)
            const unsigned live =
                EXIT ? __ballot_sync(0xffffffffu, v < (unsigned)n_cap) : 0u;
            if (v >= (unsigned)n_cap) continue;
            const int* lanes = prev + (long long)d0 * n_cap;
            int pv[DC], p[DC];
#pragma unroll
            for (int j = 0; j < DC; ++j) {
                pv[j] = d0 + j < d_cap ? lanes[(long long)j * n_cap + v] : 0;
                p[j] = -1;
            }
            auto pick = [&](int k) {
                const unsigned u = (v - (unsigned)deltas[k]) & hi;
                const unsigned lc = u - (unsigned)col0;
                const int w = lc < (unsigned)w_cols
                                  ? swm[(long long)k * w_cols + lc]
                                  : INF_E;
#pragma unroll
                for (int j = 0; j < DC; ++j)
                    if (d0 + j < d_cap) {
                        const int pu = lanes[(long long)j * n_cap + u];
                        const bool tight =
                            pu < INF_E && w < INF_E && pu + w == pv[j];
                        p[j] = p[j] < 0 && tight ? (int)u : p[j];
                    }
            };
            if constexpr (EXIT > 0) {
                for (int k0 = 0; k0 < s_cap; k0 += EXIT) {
#pragma unroll
                    for (int k = k0; k < k0 + EXIT; ++k)
                        if (k < s_cap) pick(k);
                    bool done = true;
#pragma unroll
                    for (int j = 0; j < DC; ++j)
                        done = done && (d0 + j >= d_cap || p[j] >= 0);
                    if (__all_sync(live, done)) break;
                }
            } else {
#pragma unroll 4
                for (int k = 0; k < s_cap; ++k) pick(k);
            }
#pragma unroll
            for (int j = 0; j < DC; ++j)
                if (d0 + j < d_cap) par[(long long)(d0 + j) * n_cap + v] = p[j];
        }
        if (!rows) return;
        // the residual phase reads words other blocks wrote: after the
        // barrier, through L2 only (a stale L1 line stays valid)
        cg::this_grid().sync();
    }
    const int r_tiles = (r_cap + THREADS - 1) / THREADS;
    for (int tile = blockIdx.x; tile < d_chunks * r_tiles;
         tile += gridDim.x) {
        const int c = tile / r_tiles;
        const int d0 = c * DC;
        const int r = (tile - c * r_tiles) * THREADS + t;
        if (r >= r_cap) continue;
        const int v = rows[r];
        if (v < 0) continue;  // pad row
        const int* lanes = prev + (long long)d0 * n_cap;
        int* out = par + (long long)d0 * n_cap + v;
        int cur[DC], pv[DC];
        int open = 0;
#pragma unroll
        for (int j = 0; j < DC; ++j) {
            cur[j] = d0 + j < d_cap ? __ldcg(out + (long long)j * n_cap) : 0;
            open += cur[j] < 0;
        }
        if (!open) continue;
#pragma unroll
        for (int j = 0; j < DC; ++j)
            pv[j] = cur[j] < 0 ? lanes[(long long)j * n_cap + v] : 0;
        const long long base = (long long)r * kr_cap;
        for (int e = 0; e < kr_cap && open; ++e) {
            const int nb = nbr[base + e];
            const int w = rwm[base + e];
            if (nb < 0 || w >= INF_E) continue;
            const int src = min(nb, n_cap - 1);
#pragma unroll
            for (int j = 0; j < DC; ++j)
                if (cur[j] < 0) {
                    const int pu = lanes[(long long)j * n_cap + src];
                    if (pu < INF_E && pu + w == pv[j]) {
                        cur[j] = nb;
                        out[(long long)j * n_cap] = nb;
                        --open;
                    }
                }
        }
    }
}

// One K6 call at row chunk DC: plain without a residual or without the
// shift phase, cooperative with both.
template <int DC>
static int launch_parent(const int* deltas, const int* swm, const int* prev,
                         int* par, const int* rows, const int* nbr,
                         const int* rwm, int s_cap, int n_cap, int d_cap,
                         int col0, int w_cols, int r_cap, int kr_cap,
                         cudaStream_t stream) {
    const long long d_chunks = (d_cap + DC - 1) / DC;
    const long long tiles =
        deltas ? d_chunks * ((n_cap + THREADS - 1) / THREADS) : 0;
    const long long r_tiles =
        rows ? d_chunks * ((r_cap + THREADS - 1) / THREADS) : 0;
    if (tiles > 0x7fffffffLL || r_tiles > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (!deltas || !rows) {
        parent_kernel<DC, PARENT_EXIT_EVERY>
            <<<(unsigned)max(max(tiles, r_tiles), 1LL), THREADS, 0,
               stream>>>(deltas, swm, prev, par, rows, nbr, rwm, s_cap,
                         n_cap, d_cap, col0, w_cols, r_cap, kr_cap);
        return (int)cudaGetLastError();
    }
    static int grid[64];
    const void* fn = (const void*)parent_kernel<DC, 0>;
    int nb = (int)max(1LL, min(max(tiles, r_tiles),
                               (long long)coop_grid(fn, THREADS,
                                                    PARENT_BLOCKS_PER_SM,
                                                    grid)));
    void* args[] = {&deltas, &swm,   &prev,  &par,   &rows,
                    &nbr,    &rwm,   &s_cap, &n_cap, &d_cap,
                    &col0,   &w_cols, &r_cap, &kr_cap};
    cudaError_t rc = cudaLaunchCooperativeKernel(fn, dim3(nb), dim3(THREADS),
                                                 args, 0, stream);
    return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

// K7 [mc] gather: new_loc[j] = the root-masked new weight of shift entry
// j where the shard owns its source column, INF_E elsewhere (the group's
// min is then the owning shard's value).
__global__ void owned_weights_kernel(const int* __restrict__ swm_new,
                                     const int* __restrict__ s_idx,
                                     int* __restrict__ new_loc, int n_s,
                                     int s_cap, int n_cap, int col0,
                                     int w_cols) {
    int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= n_s) return;
    int f = s_idx[j];
    int v = INF_E;
    if (f >= 0 && (long long)f < (long long)s_cap * n_cap) {
        int lc = f % n_cap - col0;
        if (lc >= 0 && lc < w_cols)
            v = swm_new[(long long)(f / n_cap) * w_cols + lc];
    }
    new_loc[j] = v;
}

// K7: block b owns the node tile [v0, v0 + tile) of every lane
// (tile a power of two dividing n_cap). It zeroes its tile of aff, then
// each thread takes dirty entries (the shift entries, then the
// residual ones): an entry whose head lies in the tile and whose
// root-masked weight increased sets aff[d, head] = 1 in every lane d
// where the edge is the head's forest edge (par[d, head] == source).
// K7 [mc] passes the shift entries' new weights as `new_m_s` (the
// group's combined owned_weights) instead of reading them from a whole
// plane.
__global__ void cone_seed_kernel(
    const int* __restrict__ par, const int* __restrict__ swm_new,
    const int* __restrict__ new_m_s,
    const int* __restrict__ deltas, const int* __restrict__ s_idx,
    const int* __restrict__ s_old, const int* __restrict__ rwm_new,
    const int* __restrict__ res_rows, const int* __restrict__ res_nbr,
    const int* __restrict__ r_idx, const int* __restrict__ r_old,
    int* __restrict__ aff, int root, int s_cap, int n_cap, int d_cap,
    int n_s, int r_cap, int kr_cap, int n_r, int tile_shift) {
    const int tile = 1 << tile_shift;
    const unsigned v0 = (unsigned)blockIdx.x << tile_shift;
    for (int i = threadIdx.x; i < d_cap * tile; i += blockDim.x)
        aff[(long long)(i >> tile_shift) * n_cap + v0 + (i & (tile - 1))] =
            0;
    __syncthreads();
    const unsigned hi = (unsigned)n_cap - 1u;
    const long long s_lim = (long long)s_cap * n_cap;
    const long long r_lim = (long long)r_cap * kr_cap;
    for (int j = threadIdx.x; j < n_s + n_r; j += blockDim.x) {
        unsigned head;
        int src;
        if (j < n_s) {
            int f = s_idx[j];
            if (f < 0 || (long long)f >= s_lim) continue;
            unsigned u = (unsigned)f & hi;
            head = (u + (unsigned)deltas[f / n_cap]) & hi;
            if (head - v0 >= (unsigned)tile) continue;
            int new_m = new_m_s ? new_m_s[j] : swm_new[f];
            int old_m = ((int)u == root) ? INF_E : s_old[j];
            if (new_m <= old_m) continue;
            src = (int)u;
        } else {
            int jr = j - n_s;
            int f = r_idx[jr];
            if (f < 0 || (long long)f >= r_lim) continue;
            int rv = res_rows[f / kr_cap];
            if (rv < 0 || (unsigned)rv - v0 >= (unsigned)tile) continue;
            int ru = res_nbr[f];
            if (ru < 0) continue;
            int old_m = (ru == root) ? INF_E : r_old[jr];
            if (rwm_new[f] <= old_m) continue;
            head = (unsigned)rv;
            src = ru;
        }
        for (int d = 0; d < d_cap; ++d) {
            long long pos = (long long)d * n_cap + head;
            if (par[pos] == src) aff[pos] = 1;
        }
    }
}

// K8 + K9, cone_fix: one cooperative launch takes the seeded cone to its
// closure, counts it, decides the fallback and writes the seed plane.
//
// Sweeps. Each word does aff[d, v] = max(aff[d, v], aff[d, par[d, v]])
// in place; an unmarked word follows its ancestors (par[d, par[d, v]],
// ...) and is marked at the first marked one, up to min(2^s, CONE_HOPS)
// levels in sweep s: a shallow cone closes in sweeps of one or two
// levels, where a walk costs an unmarked word a dependent load a level,
// and a deep one soon takes CONE_HOPS levels a sweep. Marks are 0/1 and
// only rise, and every mark lies in the closure (the forest descendants
// of a seed), so any order of the updates ends at the same unique
// closure: only the sweep count depends on it, and the payload does not
// carry that. Other blocks write the plane inside the launch,
// so it is read through L2 only (__ldcg): grid.sync() fences global
// memory but leaves a stale L1 line valid.
//
// Exit. A sweep ORs its change into a device word (__syncthreads_or,
// then one atomicOr a block) and the grid syncs; every block then reads
// the word and leaves on the first sweep that changed nothing anywhere,
// or after `max_sweeps` sweeps (the host loop's bound: at least one
// level a sweep, so it never cuts a forest of n_cap levels short). The
// words rotate over three slots, sweep s in slot s % 3, and block 0
// clears slot (s + 1) % 3 during sweep s: that slot was last read just
// after sweep s - 2's barrier, which every block has left once sweep
// s - 1's barrier is passed, and its next writers start after sweep s's.
//
// Count. A sweep that changed nothing read every word at its final
// value, so each thread's marks from that sweep are the cone: a block's
// sum (warp shuffles, one atomicAdd) goes into tail[0] with no extra
// pass (a spread cut at the bound, or with no sweep, counts in a pass
// of its own). Then a grid barrier, and every block reads fell_back =
// tail[0] > cone_limit; block 0 writes it to tail[1] and the sweep
// count to tail[2].
//
// Plane (as cone_plane below): dist0 when it fell back, else prev with
// the cone at INF_E and the lane's live seed pinned to 0. Without a
// plane (the tier's members) the launch ends after the count.
//
// tail: int32 [6] = [cone, fell_back, sweeps, three change words], all
// written by the kernel (block 0 zeroes what it accumulates into before
// the first barrier), so no fill runs ahead of it. Grid: at most
// FIX_BLOCKS_PER_SM blocks an SM, all co-resident, over tiles of
// FIX_WPT x THREADS words whose loads a thread issues together.
#define FIX_BLOCKS_PER_SM 4
#define FIX_WPT 4
#define FIX_TILE (THREADS * FIX_WPT)
// the most ancestors a sweep follows from an unmarked word: of caps 1 to
// 64 on the H100, 16 read best on a deep cone of lsdb100k's own forest,
// and a shallow cone closes in the first sweep at any cap (PERF.md)
#define CONE_HOPS 16

// word i = (lane d, node u) of K9's seed plane: dist0 when the solve
// fell back, else prev with the cone at INF_E and the lane's live seed
// pinned to 0
__device__ __forceinline__ int seed_word(
    long long i, int d, int u, int n_cap, bool fell, bool marked,
    const int* __restrict__ prev, const int* __restrict__ dist0,
    const int* __restrict__ seeds_nbr, const int* __restrict__ seeds_w) {
    if (fell) return dist0[i];
    int v = marked ? INF_E : prev[i];
    const int seed = min(max(seeds_nbr[d], 0), n_cap - 1);
    if (u == seed && seeds_w[d] < INF_E) v = min(v, 0);
    return v;
}

// the block's sum of `s`, at thread 0 (shuffles within each warp, then
// one word a warp through shared memory)
__device__ __forceinline__ int block_sum(int s) {
    __shared__ int part[THREADS / 32];
    for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
    __syncthreads();
    int tot = 0;
    if (threadIdx.x == 0)
        for (int w = 0; w < THREADS / 32; ++w) tot += part[w];
    return tot;
}

__global__ void __launch_bounds__(THREADS) cone_fix_kernel(
    const int* __restrict__ par, int* aff, const int* __restrict__ prev,
    const int* __restrict__ dist0, const int* __restrict__ seeds_nbr,
    const int* __restrict__ seeds_w, int* tail, int* __restrict__ plane,
    int cone_limit, int d_cap, int n_cap, int max_sweeps) {
    cg::grid_group grid = cg::this_grid();
    const long long total = (long long)d_cap * n_cap;
    const long long tiles = (total + FIX_TILE - 1) / FIX_TILE;
    const int lg = __ffs(n_cap) - 1;  // n_cap is a power of two
    const int t = threadIdx.x;
    const bool lead = blockIdx.x == 0 && t == 0;
    int* word = tail + 3;
    if (lead) {
        tail[0] = 0;
        word[0] = 0;
    }
    grid.sync();
    int sweeps = 0, sum = 0;
    bool closed = false;
    while (sweeps < max_sweeps) {
        const int slot = sweeps % 3;
        const int reach = min(CONE_HOPS, 1 << min(sweeps, 30));
        if (lead) word[(slot + 1) % 3] = 0;
        int changed = 0;
        sum = 0;
        for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            const long long base = tile * FIX_TILE + t;
            int mark[FIX_WPT], anc[FIX_WPT];
#pragma unroll
            for (int j = 0; j < FIX_WPT; ++j) {
                const long long i = base + j * THREADS;
                mark[j] = 0;
                anc[j] = -1;
                if (i < total) {
                    mark[j] = __ldcg(aff + i);
                    if (!mark[j]) anc[j] = par[i];
                }
            }
            for (int h = 0; h < reach; ++h) {
                int pending = 0;
#pragma unroll
                for (int j = 0; j < FIX_WPT; ++j) {
                    if (anc[j] < 0) continue;
                    const long long i = base + j * THREADS;
                    const long long at = ((i >> lg) << lg) + anc[j];
                    if (__ldcg(aff + at)) {
                        mark[j] = 1;
                        anc[j] = -1;
                        __stcg(aff + i, 1);
                        changed = 1;
                    } else {
                        anc[j] = h + 1 < reach ? par[at] : -1;
                        pending |= anc[j] >= 0;
                    }
                }
                if (!pending) break;
            }
#pragma unroll
            for (int j = 0; j < FIX_WPT; ++j) sum += mark[j];
        }
        const int any = __syncthreads_or(changed);
        if (t == 0 && any) atomicOr(word + slot, 1);
        grid.sync();
        ++sweeps;
        if (!__ldcg(word + slot)) {
            closed = true;
            break;
        }
    }
    if (!closed) {
        sum = 0;
        for (long long i = (long long)blockIdx.x * THREADS + t; i < total;
             i += (long long)gridDim.x * THREADS)
            sum += __ldcg(aff + i);
    }
    const int bsum = block_sum(sum);
    if (t == 0 && bsum) atomicAdd(tail, bsum);
    if (lead) tail[2] = sweeps;
    if (!plane) {
        if (lead) tail[1] = 0;
        return;
    }
    grid.sync();
    const bool fell = __ldcg(tail) > cone_limit;
    if (lead) tail[1] = fell ? 1 : 0;
    for (long long i = (long long)blockIdx.x * THREADS + t; i < total;
         i += (long long)gridDim.x * THREADS)
        plane[i] = seed_word(i, (int)(i >> lg), (int)(i & (n_cap - 1)),
                             n_cap, fell, !fell && __ldcg(aff + i) > 0, prev,
                             dist0, seeds_nbr, seeds_w);
}

// K9 plane, for the tier (each member's plane from the cone summed over
// the groups): fell_back = tail[0] > cone_limit (written to tail[1]),
// then seed_word.
__global__ void cone_plane_kernel(const int* __restrict__ aff,
                                  const int* __restrict__ prev,
                                  const int* __restrict__ dist0,
                                  const int* __restrict__ seeds_nbr,
                                  const int* __restrict__ seeds_w,
                                  int* __restrict__ tail,
                                  int* __restrict__ plane, int cone_limit,
                                  int d_cap, int n_cap) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    bool fell = tail[0] > cone_limit;
    if (i == 0) tail[1] = fell ? 1 : 0;
    if (i >= (long long)d_cap * n_cap) return;
    const int d = (int)(i / n_cap);
    plane[i] = seed_word(i, d, (int)(i - (long long)d * n_cap), n_cap, fell,
                         !fell && aff[i] > 0, prev, dist0, seeds_nbr,
                         seeds_w);
}

extern "C" {

int scatter_set(int* a, const int* idx_a, const int* vals_a, int n_a,
                int numel_a, int* b, const int* idx_b, const int* vals_b,
                int n_b, int numel_b, cudaStream_t stream) {
    scatter_set_kernel<<<blocks_for((long long)n_a + n_b), THREADS, 0,
                         stream>>>(a, idx_a, vals_a, n_a, numel_a, b, idx_b,
                                   vals_b, n_b, numel_b);
    return (int)cudaGetLastError();
}

int old_plane(const int* plane, const int* nbr, const int* idx,
              const int* vals, int n_idx, int* out, int rows, int cols,
              int root, cudaStream_t stream) {
    long long numel = (long long)rows * cols;
    long long tile = THREADS * 8;
    while (tile < numel && (numel + tile - 1) / tile * n_idx > 4 * numel)
        tile *= 2;
    long long nblk = (numel + tile - 1) / tile;
    old_plane_kernel<<<(unsigned)(nblk > 0 ? nblk : 1), THREADS, 0,
                       stream>>>(plane, nbr, idx, vals, n_idx, out, rows,
                                 cols, root, tile);
    return (int)cudaGetLastError();
}

int scatter_window(int* plane, const int* idx, const int* vals, int n,
                   int rows, int cols, int row0, int w_rows, int col0,
                   int w_cols, cudaStream_t stream) {
    scatter_window_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
        plane, idx, vals, n, rows, cols, row0, w_rows, col0, w_cols);
    return (int)cudaGetLastError();
}

int scatter_parts(const int64_t* table, int n_parts, const int* idx,
                  const int* vals, int n, int rows, int cols,
                  cudaStream_t stream) {
    if (n_parts < 1 || n_parts > 65535) return (int)cudaErrorInvalidValue;
    scatter_parts_kernel<<<dim3(blocks_for(n), (unsigned)n_parts), THREADS,
                           0, stream>>>(table, idx, vals, n, rows, cols);
    return (int)cudaGetLastError();
}

int parent_plane(const int* deltas, const int* swm, const int* prev,
                 int* par, const int* rows, const int* nbr, const int* rwm,
                 int s_cap, int n_cap, int d_cap, int col0, int w_cols,
                 int r_cap, int kr_cap, cudaStream_t stream) {
    if (n_cap <= 0 || (n_cap & (n_cap - 1)))
        return (int)cudaErrorInvalidValue;
    // the largest lane chunk that still gives the call enough threads
    const long long width = deltas ? n_cap : r_cap;
    int dc = 8;
    while (dc > 1 && (dc >= 2 * d_cap ||
                      width * ((d_cap + dc - 1) / dc) < PARENT_MIN_THREADS))
        dc >>= 1;
    switch (dc) {
        case 8:
            return launch_parent<8>(deltas, swm, prev, par, rows, nbr, rwm,
                                    s_cap, n_cap, d_cap, col0, w_cols, r_cap,
                                    kr_cap, stream);
        case 4:
            return launch_parent<4>(deltas, swm, prev, par, rows, nbr, rwm,
                                    s_cap, n_cap, d_cap, col0, w_cols, r_cap,
                                    kr_cap, stream);
        case 2:
            return launch_parent<2>(deltas, swm, prev, par, rows, nbr, rwm,
                                    s_cap, n_cap, d_cap, col0, w_cols, r_cap,
                                    kr_cap, stream);
        default:
            return launch_parent<1>(deltas, swm, prev, par, rows, nbr, rwm,
                                    s_cap, n_cap, d_cap, col0, w_cols, r_cap,
                                    kr_cap, stream);
    }
}

int owned_weights(const int* swm_new, const int* s_idx, int* new_loc,
                  int n_s, int s_cap, int n_cap, int col0, int w_cols,
                  cudaStream_t stream) {
    owned_weights_kernel<<<blocks_for(n_s), THREADS, 0, stream>>>(
        swm_new, s_idx, new_loc, n_s, s_cap, n_cap, col0, w_cols);
    return (int)cudaGetLastError();
}

int cone_seed(const int* par, const int* swm_new, const int* new_m_s,
              const int* deltas, const int* s_idx, const int* s_old,
              const int* rwm_new, const int* res_rows, const int* res_nbr,
              const int* r_idx, const int* r_old, int* aff, int root,
              int s_cap, int n_cap, int d_cap, int n_s, int r_cap,
              int kr_cap, int n_r, cudaStream_t stream) {
    // a tile of about 8 words a thread over all lanes, at least a
    // warp's width of nodes, at most the plane's
    int shift = 5;
    while ((2 << shift) * (long long)d_cap <= 8 * THREADS &&
           (2 << shift) <= n_cap)
        ++shift;
    if ((1 << shift) > n_cap) shift = __builtin_ctz((unsigned)n_cap);
    cone_seed_kernel<<<(unsigned)(n_cap >> shift), THREADS, 0, stream>>>(
        par, swm_new, new_m_s, deltas, s_idx, s_old, rwm_new, res_rows,
        res_nbr, r_idx, r_old, aff, root, s_cap, n_cap, d_cap, n_s, r_cap,
        kr_cap, n_r, shift);
    return (int)cudaGetLastError();
}

int cone_fix(const int* par, int* aff, const int* prev, const int* dist0,
             const int* seeds_nbr, const int* seeds_w, int* tail, int* plane,
             int cone_limit, int d_cap, int n_cap, int max_sweeps,
             cudaStream_t stream) {
    if (n_cap <= 0 || (n_cap & (n_cap - 1)))
        return (int)cudaErrorInvalidValue;
    static int grid[64];
    long long tiles = ((long long)d_cap * n_cap + FIX_TILE - 1) / FIX_TILE;
    int nb = (int)max(1LL, min(tiles, (long long)coop_grid(
                                          (const void*)cone_fix_kernel,
                                          THREADS, FIX_BLOCKS_PER_SM,
                                          grid)));
    void* args[] = {&par,  &aff,   &prev,       &dist0, &seeds_nbr,
                    &seeds_w, &tail, &plane, &cone_limit, &d_cap,
                    &n_cap, &max_sweeps};
    cudaError_t rc = cudaLaunchCooperativeKernel(
        (const void*)cone_fix_kernel, dim3(nb), dim3(THREADS), args, 0,
        stream);
    return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

int cone_plane(const int* aff, const int* prev, const int* dist0,
               const int* seeds_nbr, const int* seeds_w, int* tail,
               int* plane, int cone_limit, int d_cap, int n_cap,
               cudaStream_t stream) {
    cone_plane_kernel<<<blocks_for((long long)d_cap * n_cap), THREADS, 0,
                        stream>>>(aff, prev, dist0, seeds_nbr, seeds_w, tail,
                                  plane, cone_limit, d_cap, n_cap);
    return (int)cudaGetLastError();
}

}  // extern "C"
