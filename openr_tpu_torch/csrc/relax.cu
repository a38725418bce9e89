// SSSP relaxation kernels for Hopper (sm_90a): the cold Decision solve's
// batched shortest paths over the shift-decomposed mirror
// (ops/edgeplan.py). Host loops in ops/relax.py drive them; each entry
// point below launches exactly one kernel on the caller's stream and
// returns cudaGetLastError().
//
// Replaces the jitted XLA device code of the JAX package:
//   K1s  decision/tpu_solver.py::_plan_sssp      root masking + seed plane
//   K1   ops/relax.py::make_relax / run_sync     one Jacobi min-plus step
//   K2   ops/relax.py::run_bucketed             Δ-stepping light ladder:
//        the class pick and each ladder pass are one cooperative launch
//        each (a grid-wide barrier inside, cooperative_groups)
// K1s (seed plane only) and K1 over the unmasked planes also carry the
// single-root SSSP of ops/ksp2.py::_base_sssp_fn (ops/ksp2.py::base_sssp),
// and, with g > 1 lanes, their vmap in decision/tpu_solver.py::
// _fused_pipeline: every kernel takes `g` stacked same-shape areas and
// runs them as the grid's y dimension (K2's cooperative kernels loop over
// them inside one flat grid), so one launch covers every lane.
//
// Column windows (the multichip tier, parallel/sharding.py): a shard
// holds only the class-weight columns [col0, col0 + w_cols) of the
// [s_cap, n_cap] planes, as an [s_cap, w_cols] tensor. K1s [mc] masks
// the root's column only where it lies in the window, K1 [mc] relaxes
// over the shard's own source columns only (a source outside the
// window weighs INF_E, as in the reference's INF-padded full-width row:
// dist + INF_E never lowers a word), and K2 [mc] gathers its
// ladder rows full width with INF_E outside the window
// (parallel/sharding.py::make_mc_sssp, :381-400; ops/relax.py:227-232).
// The one-card path passes the whole width (col0 = 0, w_cols = n_cap).
// A null change flag is allowed where the caller reads the group's
// change from the combine (csrc/combine.cu) instead.
//
// Lane gates (fused solves): under vmap each lane's while-loop carry
// advances only while that lane's own predicate holds. A Gate carries
// per-lane stamps st[g][2] of the step in which the lane last changed
// (ops/relax.py::Lanes sets the thresholds per launch): a lane whose
// stamps fall below the thresholds reached its fixpoint at this loop
// level, and its tiles are skipped before touching memory. A lane that
// changed stores the launch's `put` stamps; the block of an open lane's
// first tile adds the `inc` pair to the lane's counters cnt[g][2] (trips
// or epochs, and rounds) once a launch, so the counters stop with the
// lane. Stamps only grow and every
// put passes its own launch's thresholds, so blocks of one launch agree
// on which lanes are open whatever order they run in. A skipped lane's
// two plane buffers are equal (its last step changed nothing), so the
// host's buffer swaps stay valid for it. A null `st` means no gating.
//
// Bound: every kernel here streams int32 planes ([D, n_cap] distances,
// [s_cap, n_cap] class weights) and does a few integer ops per loaded
// word, so each launch is bound by device-memory bytes. Design:
// neighbouring threads on neighbouring nodes so every plane load is
// coalesced (a shift class reads a contiguous, rotated window); the
// change flag is reduced per block with __syncthreads_or before one
// atomicOr, so a launch that changes half a million words makes at most
// one atomic per block. Each kernel's own note below says how it walks
// its outputs.
//
// Index arithmetic: n_cap is a power of two, so roll(x, s)[u] =
// x[(u - s) mod n_cap] is (u - s) & (n_cap - 1) in unsigned arithmetic,
// which is exact for any int32 shift, negative or doubled past 2^31.
// INF discipline (ops/edgeplan.py): weights <= 2^28, INF_E = 2^29, so
// every sum below is <= 2^30 and int32-exact.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "coop.cuh"

namespace cg = cooperative_groups;

#define INF_E (1 << 29)
#define THREADS 256
#define KEEP (-2147483647 - 1)  // a put stamp that is not stored

struct Gate {
    int* st;   // [g, 2] stamps of each lane's last change, or null
    int* cnt;  // [g, 2] per-lane counters
    int thr0, thr1, put0, put1, inc0, inc1;
};

static inline Gate make_gate(int* st, int* cnt, int thr0, int thr1,
                             int put0, int put1, int inc0, int inc1) {
    Gate g = {st, cnt, thr0, thr1, put0, put1, inc0, inc1};
    return g;
}

__device__ __forceinline__ bool gate_open(const Gate& g, int lane) {
    return !g.st || (g.st[2 * lane] >= g.thr0 && g.st[2 * lane + 1] >= g.thr1);
}

// thread 0 of a block whose tile of an open, gated lane changed a word
__device__ __forceinline__ void gate_put(const Gate& g, int lane) {
    if (g.put0 != KEEP) g.st[2 * lane] = g.put0;
    if (g.put1 != KEEP) g.st[2 * lane + 1] = g.put1;
}

// thread 0 of the block of an open, gated lane's first tile, once a launch
__device__ __forceinline__ void gate_count(const Gate& g, int lane) {
    g.cnt[2 * lane] += g.inc0;
    g.cnt[2 * lane + 1] += g.inc1;
}

// K1s: sw = shift_w with column `root` set to INF_E (root is never a
// transit node); residual weights masked where the source is the root,
// residual indices clipped into range; dist0[d, clip(seed_d)] = 0 for
// live seeds, INF_E elsewhere. lane = blockIdx.y, its root roots[lane]
// (or `root` when roots is null). With s_cap = r_cap = 0 only the seed
// plane is written: the unmasked single-root SSSP (ops/ksp2.py::
// base_sssp) and the KSP2 batch seed their rows so and relax the
// resident planes as they are.
//
// Bound: bytes — the class plane and the ELL read once and written once,
// the seed plane written once. Design: one launch, each output in a
// range of whole blocks of its own (no warp mixes two outputs): the
// class plane and the seed plane by chunks of INIT_CHUNK words of one
// row a block (the row from the block index: one 32-bit division a
// block, none a thread), the ELL and its row list flat. A thread takes
// INIT_VEC neighbouring words with one 16-byte load and store where the
// host found the row width a multiple of 4 and the pointers aligned (the
// VEC_* bits), else INIT_VEC words THREADS apart (an [mc] window of odd
// width, an odd r_cap). The root's column is masked inside the copy, and
// a seed's zero is written by the thread whose words hold it, so every
// word has one writer. The wrapper may hand in the outputs (held by the
// caller across solves): the launch then allocates nothing.
#define INIT_VEC 4
#define INIT_CHUNK (THREADS * INIT_VEC)
#define VEC_SW 1
#define VEC_RES 2
#define VEC_DIST 4

__device__ __forceinline__ int4 ld4(const int* p) {
    return *reinterpret_cast<const int4*>(p);
}

__device__ __forceinline__ void st4(int* p, int4 v) {
    *reinterpret_cast<int4*>(p) = v;
}

__device__ __forceinline__ int clip(int x, int hi) {
    return min(max(x, 0), hi);
}

__global__ void __launch_bounds__(THREADS) sssp_init_kernel(
    const int* __restrict__ shift_w, int* __restrict__ sw,
    const int* __restrict__ res_rows, const int* __restrict__ res_nbr,
    const int* __restrict__ res_w, int* __restrict__ rows_c,
    int* __restrict__ nbr_c, int* __restrict__ rw,
    const int* __restrict__ seeds_nbr, const int* __restrict__ seeds_w,
    int* __restrict__ dist0, int s_cap, int n_cap, int r_cap, int kr_cap,
    int d_cap, int root, const int* __restrict__ roots, int col0,
    int w_cols, int sw_chunks, int b_sw, int b_res, int b_rows, int vec) {
    const int lane = blockIdx.y, t = threadIdx.x, hi = n_cap - 1;
    if (roots) root = roots[lane];
    int b = blockIdx.x;
    if (b < b_sw) {
        // class row k, window columns [c0, c0 + INIT_CHUNK)
        const int k = b / sw_chunks;
        const int c0 = (b - k * sw_chunks) * INIT_CHUNK;
        const long long row = ((long long)lane * s_cap + k) * w_cols;
        const int lc = root - col0;  // the root's column in the window
        if (vec & VEC_SW) {
            const int c = c0 + INIT_VEC * t;
            if (c < w_cols) {
                int4 v = ld4(shift_w + row + c);
                if (lc == c) v.x = INF_E;
                if (lc == c + 1) v.y = INF_E;
                if (lc == c + 2) v.z = INF_E;
                if (lc == c + 3) v.w = INF_E;
                st4(sw + row + c, v);
            }
        } else {
#pragma unroll
            for (int j = 0; j < INIT_VEC; ++j) {
                const int c = c0 + t + j * THREADS;
                if (c < w_cols)
                    sw[row + c] = c == lc ? INF_E : shift_w[row + c];
            }
        }
        return;
    }
    b -= b_sw;
    if (b < b_res) {
        const long long n_res = (long long)r_cap * kr_cap;
        const long long base = lane * n_res;
        const long long e0 = (long long)b * INIT_CHUNK;
        if (vec & VEC_RES) {
            const long long e = base + e0 + INIT_VEC * t;
            if (e0 + INIT_VEC * t < n_res) {
                const int4 nb = ld4(res_nbr + e);
                int4 w = ld4(res_w + e);
                if (nb.x == root) w.x = INF_E;
                if (nb.y == root) w.y = INF_E;
                if (nb.z == root) w.z = INF_E;
                if (nb.w == root) w.w = INF_E;
                st4(rw + e, w);
                st4(nbr_c + e, make_int4(clip(nb.x, hi), clip(nb.y, hi),
                                         clip(nb.z, hi), clip(nb.w, hi)));
            }
        } else {
#pragma unroll
            for (int j = 0; j < INIT_VEC; ++j) {
                const long long e = e0 + t + j * THREADS;
                if (e < n_res) {
                    const int nb = res_nbr[base + e];
                    rw[base + e] = nb == root ? INF_E : res_w[base + e];
                    nbr_c[base + e] = clip(nb, hi);
                }
            }
        }
        return;
    }
    b -= b_res;
    if (b < b_rows) {
        const long long base = (long long)lane * r_cap;
#pragma unroll
        for (int j = 0; j < INIT_VEC; ++j) {
            const int r = b * INIT_CHUNK + t + j * THREADS;
            if (r < r_cap) rows_c[base + r] = clip(res_rows[base + r], hi);
        }
        return;
    }
    b -= b_rows;
    // seed plane row d, columns [c0, c0 + INIT_CHUNK)
    const int n_chunks = (n_cap + INIT_CHUNK - 1) / INIT_CHUNK;
    const int d = b / n_chunks;
    if (d >= d_cap) return;  // the one idle block of an empty launch
    const int c0 = (b - d * n_chunks) * INIT_CHUNK;
    const int sd = lane * d_cap + d;
    const int seed = seeds_w[sd] < INF_E ? clip(seeds_nbr[sd], hi) : -1;
    int* row = dist0 + (long long)sd * n_cap;
    if (vec & VEC_DIST) {
        const int c = c0 + INIT_VEC * t;
        if (c < n_cap)
            st4(row + c, make_int4(seed == c ? 0 : INF_E,
                                   seed == c + 1 ? 0 : INF_E,
                                   seed == c + 2 ? 0 : INF_E,
                                   seed == c + 3 ? 0 : INF_E));
    } else {
#pragma unroll
        for (int j = 0; j < INIT_VEC; ++j) {
            const int c = c0 + t + j * THREADS;
            if (c < n_cap) row[c] = c == seed ? 0 : INF_E;
        }
    }
}

// K1: out[d,u] = min(dist[d,u], min_k dist[d,src] + sw[k,src]) with src
// = (u - deltas[k]) mod n_cap, over the sources in the column window (K1
// [mc]; the whole width on one card), then the row-compact residual ELL
// scatter-min'd in: out[d, rows_c[r]] = min(., min_j dist[d, nbr_c[r,j]]
// + rw[r,j]). Both phases read `dist` and write `out` (a different
// buffer: Jacobi), so trips and rounds match the JAX loop. Indices are
// clipped as they are read (K1s's clipped copies are idempotent under
// it), so the unmasked SSSP passes the resident ELL as it is. Pad rows
// clip to row 0 and carry INF_E weights, and real rows may repeat, so
// the scatter is an atomicMin — exact on int32 in any order. With
// `shared` set, every lane reads the one resident row / neighbour index
// table and only the weights `rw` are per lane: the masked KSP2 rows and
// the what-if lanes (csrc/ksp2.cu's overlay_planes) override weights,
// never indices. A null rows_c means no residual.
//
// Bound: bytes — the plane read and written once, the class weights and
// the ELL read once. Design: one launch a step. A thread takes one node
// u of one lane and DC of its D rows in registers, so each class weight
// sw[k, src] is loaded once for DC rows, neighbouring threads on
// neighbouring nodes (every load coalesced: a class reads a contiguous,
// rotated window); a residual row likewise loads its indices and
// weights once for DC rows. The host picks DC (8, 4, 2 or 1, a template
// argument) as the largest that still gives the step RELAX_MIN_THREADS
// threads, so a small plane (fabric10k's 8 x 8192) keeps its
// parallelism and a wide one (lsdb100k's 4 x 131072) takes one load of
// a weight a node. A tile is THREADS nodes of one DC-row chunk of one
// lane. Without a residual it is a plain launch, a tile a block. With
// one, it is a cooperative launch (the grid from coop_grid, at most
// RELAX_BLOCKS_PER_SM blocks an SM) whose blocks walk the shift tiles,
// meet at one grid barrier (the scatter must follow every plain store
// of `out`), then walk the residual tiles. No block barrier inside the
// tile loops: a thread keeps its own change, one __syncthreads_or at
// the end feeds one atomicOr a block; a gated lane's stamps are stored
// by lane 0 of each warp whose tile changed a word (__any_sync; every
// thread of a block walks the same tiles). A lane's counters go up once
// a launch (by the block of its first shift tile), and its stamps on a
// change in either phase (stamps only grow and every put passes its own
// launch's thresholds, so a lane's gate reads the same in both phases).
#define RELAX_BLOCKS_PER_SM 8
#define RELAX_MIN_THREADS (1 << 17)

template <int DC>
__global__ void __launch_bounds__(THREADS) relax_step_kernel(
    const int* __restrict__ dist, int* out, const int* __restrict__ deltas,
    const int* __restrict__ sw, const int* __restrict__ rows_c,
    const int* __restrict__ nbr_c, const int* __restrict__ rw, int d_cap,
    int n_cap, int s_cap, int col0, int w_cols, int r_cap, int kr_cap,
    int shared, int g, int* flag, Gate gate) {
    const int t = threadIdx.x;
    const long long plane = (long long)d_cap * n_cap;
    const unsigned hi = (unsigned)n_cap - 1u;
    const int d_chunks = (d_cap + DC - 1) / DC;
    int changed = 0;
    // shift phase: tile = (lane, row chunk, THREADS nodes)
    const int u_tiles = (n_cap + THREADS - 1) / THREADS;
    const int per_lane = d_chunks * u_tiles;
    // the host keeps every tile count under 2^31: 32-bit index math
    for (int tile = blockIdx.x; tile < per_lane * g; tile += gridDim.x) {
        const int lane = tile / per_lane;
        if (!gate_open(gate, lane)) continue;  // uniform in the block
        const int rem = tile - lane * per_lane;
        const int d0 = rem / u_tiles * DC;
        const unsigned u = (unsigned)(rem - d0 / DC * u_tiles) * THREADS + t;
        const int* rows = dist + lane * plane + (long long)d0 * n_cap;
        int* lo = out + lane * plane + (long long)d0 * n_cap;
        const int* ldl = deltas + (long long)lane * s_cap;
        const int* lsw = sw + (long long)lane * s_cap * w_cols;
        int hit = 0;
        if (u < (unsigned)n_cap) {
            int cur[DC], acc[DC];
#pragma unroll
            for (int j = 0; j < DC; ++j)
                cur[j] = acc[j] =
                    d0 + j < d_cap ? rows[(long long)j * n_cap + u] : 0;
            // a source outside the column window weighs INF_E, as the
            // reference's INF-padded full-width row; no branch, so the
            // unrolled classes' loads go out together
#pragma unroll 4
            for (int k = 0; k < s_cap; ++k) {
                const unsigned src = (u - (unsigned)ldl[k]) & hi;
                const unsigned lc = src - (unsigned)col0;  // local column
                const int w = lc < (unsigned)w_cols
                                  ? lsw[(long long)k * w_cols + lc]
                                  : INF_E;
#pragma unroll
                for (int j = 0; j < DC; ++j)
                    if (d0 + j < d_cap)
                        acc[j] =
                            min(acc[j], rows[(long long)j * n_cap + src] + w);
            }
#pragma unroll
            for (int j = 0; j < DC; ++j)
                if (d0 + j < d_cap) {
                    lo[(long long)j * n_cap + u] = acc[j];
                    hit |= acc[j] < cur[j];
                }
        }
        changed |= hit;
        if (gate.st) {
            if (__any_sync(0xffffffffu, hit) && (t & 31) == 0)
                gate_put(gate, lane);
            if (t == 0 && rem == 0) gate_count(gate, lane);
        }
    }
    if (rows_c) {
        cg::this_grid().sync();
        // residual phase: tile = (lane, row chunk, THREADS ELL rows)
        const int r_tiles = (r_cap + THREADS - 1) / THREADS;
        const int r_per = d_chunks * r_tiles;
        const long long ell = (long long)r_cap * kr_cap;
        for (int tile = blockIdx.x; tile < r_per * g; tile += gridDim.x) {
            const int lane = tile / r_per;
            if (!gate_open(gate, lane)) continue;
            const int rem = tile - lane * r_per;
            const int d0 = rem / r_tiles * DC;
            const int r = (rem - d0 / DC * r_tiles) * THREADS + t;
            const int* rows = dist + lane * plane + (long long)d0 * n_cap;
            int* lo = out + lane * plane + (long long)d0 * n_cap;
            const int* lrows =
                shared ? rows_c : rows_c + (long long)lane * r_cap;
            const int* lnbr = shared ? nbr_c : nbr_c + lane * ell;
            const int* lrw = rw + lane * ell;
            int hit = 0;
            if (r < r_cap) {
                int cand[DC];
#pragma unroll
                for (int j = 0; j < DC; ++j) cand[j] = INF_E << 1;
#pragma unroll 4
                for (int e = 0; e < kr_cap; ++e) {
                    const long long i = (long long)r * kr_cap + e;
                    const long long nb = clip(lnbr[i], (int)hi);
                    const int w = lrw[i];
#pragma unroll
                    for (int j = 0; j < DC; ++j)
                        if (d0 + j < d_cap)
                            cand[j] = min(cand[j],
                                          rows[j * (long long)n_cap + nb] + w);
                }
                const long long v = clip(lrows[r], (int)hi);
#pragma unroll
                for (int j = 0; j < DC; ++j) {
                    const long long o = j * (long long)n_cap + v;
                    if (d0 + j < d_cap && cand[j] < rows[o]) {
                        atomicMin(lo + o, cand[j]);
                        hit = 1;
                    }
                }
            }
            changed |= hit;
            if (gate.st && __any_sync(0xffffffffu, hit) && (t & 31) == 0)
                gate_put(gate, lane);
        }
    }
    if (__syncthreads_or(changed) && t == 0 && flag) atomicOr(flag, 1);
}

// K2 class pick, one cooperative launch (replaces the JAX package's
// ops/relax.py:227-232 — the light-edge score, lax.top_k and the masked
// gather of run_bucketed — which the port ran as a score kernel, a
// torch.sort and a gather kernel): score[k] = #{u : sw[k,u] <= dq} over
// the held columns, lad = the s_lad highest scores in descending order,
// ties to the lower class (lax.top_k, a stable sort), then w_base[i,u] =
// sw[lad[i],u] if <= dq else INF_E (INF_E outside the column window) and
// d_base[i] = deltas[lad[i]] mod n_cap, for each of g stacked lanes.
//
// Bound: bytes — s_cap x w_cols words read, s_lad x n_cap written, one
// compare or select per word. Design: every block counts its stripe of
// columns of every (lane, class) row — 16-byte loads where the rows
// allow, a warp sum, one shared atomic a warp — into part[row][block];
// one grid-wide barrier; then every block sums the partial columns of a
// lane in shared memory, ranks the lane's s_cap classes itself (s_cap is
// small: 4 on lsdb100k, at most PICK_CLASSES), and writes its stripe of
// the lane's ladder rows, PICK_WPT words a thread with their loads issued
// together. The grid is at most PICK_BLOCKS_PER_SM blocks an SM and
// PICK_BLOCKS in all, every block co-resident under the cooperative
// launch.
#define PICK_BLOCKS 1024
#define PICK_BLOCKS_PER_SM 4
#define PICK_ROWS 1024  // rows counted per shared-memory round
#define PICK_CLASSES 1024
#define PICK_WPT 4

__global__ void __launch_bounds__(THREADS) ladder_pick_kernel(
    const int* __restrict__ sw, const int* __restrict__ deltas,
    int* part, int* __restrict__ w_base, int* __restrict__ d_base,
    int s_cap, int s_lad, int n_cap, int dq, int g, int col0,
    int w_cols) {
    __shared__ int cnt[PICK_ROWS];
    __shared__ int score[PICK_CLASSES];
    __shared__ int lad[PICK_CLASSES];
    const int nb = gridDim.x, b = blockIdx.x, t = threadIdx.x;
    const int rows = g * s_cap;
    const bool vec = (w_cols & 3) == 0 && ((uintptr_t)sw & 15) == 0;
    for (int r0 = 0; r0 < rows; r0 += PICK_ROWS) {
        const int nr = min(PICK_ROWS, rows - r0);
        for (int i = t; i < nr; i += THREADS) cnt[i] = 0;
        __syncthreads();
        for (int r = 0; r < nr; ++r) {
            const int* row = sw + (long long)(r0 + r) * w_cols;
            int c = 0;
            if (vec) {
                const int4* row4 = reinterpret_cast<const int4*>(row);
                for (int q = b * THREADS + t; q < (w_cols >> 2);
                     q += nb * THREADS) {
                    int4 v = row4[q];
                    c += (v.x <= dq) + (v.y <= dq) + (v.z <= dq) + (v.w <= dq);
                }
            } else {
                for (int u = b * THREADS + t; u < w_cols; u += nb * THREADS)
                    c += row[u] <= dq;
            }
            c = __reduce_add_sync(0xffffffffu, c);
            if ((t & 31) == 0 && c) atomicAdd(&cnt[r], c);
        }
        __syncthreads();
        for (int i = t; i < nr; i += THREADS)
            part[(long long)(r0 + i) * nb + b] = cnt[i];
        __syncthreads();
    }
    cg::this_grid().sync();
    const int warp = t >> 5, wl = t & 31;
    const unsigned hi = (unsigned)n_cap - 1u;
    const int lg = __ffs(n_cap) - 1;  // n_cap is a power of two
    const long long n_out = (long long)s_lad * n_cap;
    const long long step = (long long)nb * THREADS * PICK_WPT;
    for (int lane = 0; lane < g; ++lane) {
        for (int k = warp; k < s_cap; k += THREADS / 32) {
            const int* p = part + (long long)(lane * s_cap + k) * nb;
            int sum = 0;
            for (int i = wl; i < nb; i += 32) sum += p[i];
            sum = __reduce_add_sync(0xffffffffu, sum);
            if (wl == 0) score[k] = sum;
        }
        __syncthreads();
        // rank = the classes ahead of k in a stable descending sort
        for (int k = t; k < s_cap; k += THREADS) {
            const int sk = score[k];
            int rank = 0;
            for (int j = 0; j < s_cap; ++j) {
                const int sj = score[j];
                rank += (sj > sk) || (sj == sk && j < k);
            }
            if (rank < s_lad) lad[rank] = k;
        }
        __syncthreads();
        const int* lsw = sw + (long long)lane * s_cap * w_cols;
        int* out = w_base + (long long)lane * n_out;
        for (long long i0 = ((long long)b * PICK_WPT) * THREADS + t;
             i0 < n_out; i0 += step) {
            int v[PICK_WPT];
#pragma unroll
            for (int j = 0; j < PICK_WPT; ++j) {
                const long long i = i0 + j * THREADS;
                const unsigned lc = ((unsigned)i & hi) - (unsigned)col0;
                v[j] = INF_E;
                if (i < n_out && lc < (unsigned)w_cols)
                    v[j] = lsw[(long long)lad[i >> lg] * w_cols + lc];
            }
#pragma unroll
            for (int j = 0; j < PICK_WPT; ++j) {
                const long long i = i0 + j * THREADS;
                if (i < n_out) out[i] = v[j] <= dq ? v[j] : INF_E;
            }
        }
        if (b == 0 && t < s_lad)
            d_base[lane * s_lad + t] =
                (int)((unsigned)deltas[lane * s_cap + lad[t]] & hi);
        __syncthreads();  // the next lane reuses the scores
    }
}

// K2 ladder pass, one cooperative launch (replaces one iteration of the
// JAX package's ops/relax.py:236-247 — pass_once and the rung doubling
// of run_bucketed's ladder body — which the port ran as s_lad class
// launches and a rung launch): for k = 0 .. s_lad - 1 in order (Gauss-
// Seidel across classes), plane[(k + 1) % 2] = min(plane[k % 2],
// roll(plane[k % 2] + w[k], d[k])) — each class Jacobi-style over the
// whole plane the previous class left, so the result lies in plane[s_lad
// % 2], where the host's s_lad buffer swaps put it; then the rung:
// w2[k,u] = min(w[k,u] + w[k,(u + d[k]) mod n], INF_E), d2[k] = 2 d[k]
// mod n_cap, into separate buffers. The change flag is ORed on any
// decrease.
//
// Gates (fused lanes): the pass's gate opens a lane for every class
// (stamps only grow, and a put passes its own thresholds, so a lane open
// at class 0 stays open), stores its put stamps on a change in any class
// and adds its inc to the lane's counters once. The rung runs for the
// lanes whose stamps then pass (thr0, put1) — those that changed in this
// pass, when put1 is the pass's serial number — so it waits for one more
// barrier; ungated, it reads only w and d and needs none.
//
// Bound: bytes — the function reads the plane, the rung rows and shifts
// once and writes the result plane and the next rung once; the kernel
// streams the plane s_lad times, from the 50 MB L2 at lsdb100k's 2 MB
// plane. Design: a flat loop over tiles of PASS_WPT x 256 words of every
// lane's plane, each thread taking PASS_WPT words 256 apart with their
// loads issued together, neighbouring threads on neighbouring nodes
// (coalesced, as the launches it replaces), a block vote per tile for
// the lane's stamps, one atomicOr a block at the end for the flag, and
// a grid-wide barrier between classes. The grid is at most
// PASS_BLOCKS_PER_SM blocks an SM, all co-resident.
#define PASS_BLOCKS_PER_SM 4
#define PASS_WPT 4  // words a thread takes of each tile, loads issued together
#define PASS_TILE (THREADS * PASS_WPT)

__global__ void __launch_bounds__(THREADS) ladder_pass_kernel(
    int* a, int* b, const int* __restrict__ w, const int* __restrict__ dd,
    int* __restrict__ w2, int* __restrict__ d2, int s_lad, int d_cap,
    int n_cap, int g, int* flag, Gate gate) {
    cg::grid_group grid = cg::this_grid();
    const long long plane = (long long)d_cap * n_cap;
    const long long per_lane = (plane + PASS_TILE - 1) / PASS_TILE;  // tiles
    const long long tiles = per_lane * g;
    const unsigned hi = (unsigned)n_cap - 1u;
    const int lg = __ffs(n_cap) - 1;  // n_cap is a power of two
    const int t = threadIdx.x;
    int block_changed = 0;
    for (int k = 0; k < s_lad; ++k) {
        if (k) grid.sync();
        const int* src = (k & 1) ? b : a;
        int* dst = (k & 1) ? a : b;
        for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            const int lane = (int)(tile / per_lane);
            if (!gate_open(gate, lane)) continue;  // uniform in the block
            const long long base = (tile - lane * per_lane) * PASS_TILE + t;
            const long long c = (long long)lane * s_lad + k;
            const unsigned dk = (unsigned)dd[c];
            const int* lsrc = src + lane * plane;
            const int* wk = w + c * n_cap;
            int cur[PASS_WPT], cand[PASS_WPT];
#pragma unroll
            for (int j = 0; j < PASS_WPT; ++j) {
                const long long i = base + j * THREADS;
                cur[j] = cand[j] = INF_E;
                if (i < plane) {
                    const int* row = lsrc + ((i >> lg) << lg);
                    const unsigned u = (unsigned)i & hi;
                    const unsigned s = (u - dk) & hi;
                    cur[j] = row[u];
                    cand[j] = row[s] + wk[s];
                }
            }
            int changed = 0;
#pragma unroll
            for (int j = 0; j < PASS_WPT; ++j) {
                const long long i = base + j * THREADS;
                if (i < plane) {
                    const int v = min(cur[j], cand[j]);
                    dst[lane * plane + i] = v;
                    changed |= v < cur[j];
                }
            }
            const int any = __syncthreads_or(changed);
            if (t == 0) {
                block_changed |= any;
                if (gate.st) {
                    if (any) gate_put(gate, lane);
                    if (k == 0 && tile == lane * per_lane)
                        gate_count(gate, lane);
                }
            }
        }
    }
    if (gate.st) grid.sync();  // every class's stamps, before the rung
    const long long rung = (long long)s_lad * n_cap;
    for (long long i = (long long)blockIdx.x * THREADS + t; i < rung * g;
         i += (long long)gridDim.x * THREADS) {
        const int lane = (int)(i / rung);
        if (gate.st) {
            const volatile int* st = gate.st + 2 * lane;
            if (!(st[0] >= gate.thr0 && st[1] >= gate.put1)) continue;
        }
        const long long j = i - lane * rung;
        const int kk = (int)(j >> lg);
        const unsigned u = (unsigned)j & hi;
        const int* row = w + lane * rung + (long long)kk * n_cap;
        const unsigned dk = (unsigned)dd[lane * s_lad + kk];
        w2[i] = min(row[u] + row[(u + dk) & hi], INF_E);
        if (u == 0) d2[lane * s_lad + kk] = (int)((dk * 2u) & hi);
    }
    if (t == 0 && block_changed && flag) atomicOr(flag, 1);
}

// One K1 step at row chunk DC: a plain launch without a residual, a
// cooperative one with it.
template <int DC>
static int launch_relax(const int* dist, int* out, const int* deltas,
                        const int* sw, const int* rows_c, const int* nbr_c,
                        const int* rw, int d_cap, int n_cap, int s_cap,
                        int col0, int w_cols, int r_cap, int kr_cap,
                        int shared, int g, int* flag, Gate gate,
                        cudaStream_t stream) {
    const long long d_chunks = (d_cap + DC - 1) / DC;
    const long long tiles =
        d_chunks * ((n_cap + THREADS - 1) / THREADS) * g;
    const long long r_tiles =
        d_chunks * ((r_cap + THREADS - 1) / THREADS) * g;
    if (tiles > 0x7fffffffLL || r_tiles > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (!rows_c) {
        relax_step_kernel<DC><<<(unsigned)max(tiles, 1LL), THREADS, 0,
                                stream>>>(
            dist, out, deltas, sw, rows_c, nbr_c, rw, d_cap, n_cap, s_cap,
            col0, w_cols, r_cap, kr_cap, shared, g, flag, gate);
        return (int)cudaGetLastError();
    }
    static int grid[64];
    const void* fn = (const void*)relax_step_kernel<DC>;
    int nb = (int)max(1LL, min(max(tiles, r_tiles),
                               (long long)coop_grid(fn, THREADS,
                                                    RELAX_BLOCKS_PER_SM,
                                                    grid)));
    void* args[] = {&dist,  &out,    &deltas, &sw, &rows_c, &nbr_c,
                    &rw,    &d_cap,  &n_cap,  &s_cap, &col0, &w_cols,
                    &r_cap, &kr_cap, &shared, &g,  &flag,   &gate};
    cudaError_t rc = cudaLaunchCooperativeKernel(fn, dim3(nb), dim3(THREADS),
                                                 args, 0, stream);
    return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

extern "C" {

static inline bool aligned16(const void* p) {
    return ((uintptr_t)p & 15) == 0;
}

int sssp_init(const int* shift_w, int* sw, const int* res_rows,
              const int* res_nbr, const int* res_w, int* rows_c,
              int* nbr_c, int* rw, const int* seeds_nbr,
              const int* seeds_w, int* dist0, int s_cap, int n_cap,
              int r_cap, int kr_cap, int d_cap, int root, const int* roots,
              int g, int col0, int w_cols, cudaStream_t stream) {
    const int sw_chunks = (w_cols + INIT_CHUNK - 1) / INIT_CHUNK;
    const long long n_res = (long long)r_cap * kr_cap;
    const long long b_sw = (long long)s_cap * sw_chunks;
    const long long b_res = (n_res + INIT_CHUNK - 1) / INIT_CHUNK;
    const long long b_rows = (r_cap + INIT_CHUNK - 1) / INIT_CHUNK;
    const long long b_dist =
        (long long)d_cap * ((n_cap + INIT_CHUNK - 1) / INIT_CHUNK);
    const long long blocks = b_sw + b_res + b_rows + b_dist;
    if (blocks > 0x7fffffffLL || g < 1 || g > 65535)
        return (int)cudaErrorInvalidValue;
    int vec = 0;
    if ((w_cols & 3) == 0 && aligned16(shift_w) && aligned16(sw))
        vec |= VEC_SW;
    if ((n_res & 3) == 0 && aligned16(res_nbr) && aligned16(res_w) &&
        aligned16(nbr_c) && aligned16(rw))
        vec |= VEC_RES;
    if ((n_cap & 3) == 0 && aligned16(dist0)) vec |= VEC_DIST;
    sssp_init_kernel<<<dim3((unsigned)max(blocks, 1LL), (unsigned)g),
                       THREADS, 0, stream>>>(
        shift_w, sw, res_rows, res_nbr, res_w, rows_c, nbr_c, rw,
        seeds_nbr, seeds_w, dist0, s_cap, n_cap, r_cap, kr_cap, d_cap,
        root, roots, col0, w_cols, sw_chunks, (int)b_sw, (int)b_res,
        (int)b_rows, vec);
    return (int)cudaGetLastError();
}

int relax_step(const int* dist, int* out, const int* deltas, const int* sw,
               const int* rows_c, const int* nbr_c, const int* rw,
               int d_cap, int n_cap, int s_cap, int col0, int w_cols,
               int r_cap, int kr_cap, int shared, int* flag, int g, int* st,
               int* cnt, int thr0, int thr1, int put0, int put1, int inc0,
               int inc1, cudaStream_t stream) {
    Gate gate = make_gate(st, cnt, thr0, thr1, put0, put1, inc0, inc1);
    // the largest row chunk that still gives the step enough threads
    int dc = 8;
    while (dc > 1 &&
           (dc >= 2 * d_cap || (long long)g * n_cap * ((d_cap + dc - 1) / dc) <
                                   RELAX_MIN_THREADS))
        dc >>= 1;
    switch (dc) {
        case 8:
            return launch_relax<8>(dist, out, deltas, sw, rows_c, nbr_c, rw,
                                   d_cap, n_cap, s_cap, col0, w_cols, r_cap,
                                   kr_cap, shared, g, flag, gate, stream);
        case 4:
            return launch_relax<4>(dist, out, deltas, sw, rows_c, nbr_c, rw,
                                   d_cap, n_cap, s_cap, col0, w_cols, r_cap,
                                   kr_cap, shared, g, flag, gate, stream);
        case 2:
            return launch_relax<2>(dist, out, deltas, sw, rows_c, nbr_c, rw,
                                   d_cap, n_cap, s_cap, col0, w_cols, r_cap,
                                   kr_cap, shared, g, flag, gate, stream);
        default:
            return launch_relax<1>(dist, out, deltas, sw, rows_c, nbr_c, rw,
                                   d_cap, n_cap, s_cap, col0, w_cols, r_cap,
                                   kr_cap, shared, g, flag, gate, stream);
    }
}

int ladder_pick(const int* sw, const int* deltas, int* part, int* w_base,
                int* d_base, int s_cap, int s_lad, int n_cap, int dq, int g,
                int col0, int w_cols, cudaStream_t stream) {
    if (s_cap > PICK_CLASSES || s_lad > s_cap)
        return (int)cudaErrorInvalidValue;
    static int grid[64];
    int nb = min(PICK_BLOCKS, coop_grid((const void*)ladder_pick_kernel,
                                        THREADS, PICK_BLOCKS_PER_SM, grid));
    void* args[] = {&sw, &deltas, &part, &w_base, &d_base, &s_cap, &s_lad,
                    &n_cap, &dq, &g, &col0, &w_cols};
    cudaError_t rc = cudaLaunchCooperativeKernel(
        (const void*)ladder_pick_kernel, dim3(nb), dim3(THREADS), args, 0,
        stream);
    return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

int ladder_pass(int* a, int* b, const int* w, const int* dd, int* w2,
                int* d2, int s_lad, int d_cap, int n_cap, int* flag, int g,
                int* st, int* cnt, int thr0, int thr1, int put0, int put1,
                int inc0, int inc1, cudaStream_t stream) {
    static int grid[64];
    long long tiles =
        ((long long)d_cap * n_cap + PASS_TILE - 1) / PASS_TILE * g;
    int nb = (int)max(1LL, min(tiles, (long long)coop_grid(
                                          (const void*)ladder_pass_kernel,
                                          THREADS, PASS_BLOCKS_PER_SM,
                                          grid)));
    Gate gate = make_gate(st, cnt, thr0, thr1, put0, put1, inc0, inc1);
    void* args[] = {&a, &b, &w, &dd, &w2, &d2, &s_lad, &d_cap, &n_cap, &g,
                    &flag, &gate};
    cudaError_t rc = cudaLaunchCooperativeKernel(
        (const void*)ladder_pass_kernel, dim3(nb), dim3(THREADS), args, 0,
        stream);
    return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

}  // extern "C"
