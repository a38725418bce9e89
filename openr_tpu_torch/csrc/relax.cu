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
// window contributes nothing, as the reference's INF-padded full-width
// row does: dist + INF_E never lowers a word), and K2 [mc] gathers its
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
// level, and its blocks return before touching memory. A lane that
// changed stores the launch's `put` stamps; block 0 of an open lane adds
// the `inc` pair to the lane's counters cnt[g][2] (trips or epochs, and
// rounds), so the counters stop with the lane. Stamps only grow and every
// put passes its own launch's thresholds, so blocks of one launch agree
// on which lanes are open whatever order they run in. A skipped lane's
// two plane buffers are equal (its last step changed nothing), so the
// host's buffer swaps stay valid for it. A null `st` means no gating.
//
// Bound: every kernel here streams int32 planes ([D, n_cap] distances,
// [s_cap, n_cap] class weights) once and does 2 integer ops per loaded
// word, so each launch is bound by device-memory bytes. Design: one
// thread per output word, neighbouring threads on neighbouring nodes so
// every plane load is coalesced (a shift class reads a contiguous,
// rotated window); the change flag is reduced per block with
// __syncthreads_or before one atomicOr, so a launch that changes half a
// million words makes at most one atomic per block.
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

static inline dim3 grid_for(long long n, int g) {
    long long b = (n + THREADS - 1) / THREADS;
    return dim3((unsigned)(b > 0 ? b : 1), (unsigned)g);
}

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

// thread 0 of each open block, after the block's change vote
__device__ __forceinline__ void gate_close(const Gate& g, int lane,
                                           bool changed) {
    if (!g.st) return;
    if (changed) {
        if (g.put0 != KEEP) g.st[2 * lane] = g.put0;
        if (g.put1 != KEEP) g.st[2 * lane + 1] = g.put1;
    }
    if (blockIdx.x == 0) {
        g.cnt[2 * lane] += g.inc0;
        g.cnt[2 * lane + 1] += g.inc1;
    }
}

// K1s: sw = shift_w with column `root` set to INF_E (root is never a
// transit node); residual weights masked where the source is the root,
// residual indices clipped into range; dist0[d, clip(seed_d)] = 0 for
// live seeds, INF_E elsewhere. One flat index space over the four
// outputs so the whole init is a single launch; lane = blockIdx.y, its
// root roots[lane] (or `root` when roots is null). With s_cap = r_cap =
// 0 only the seed plane is written: the unmasked single-root SSSP
// (ops/ksp2.py::base_sssp) seeds its one row so and relaxes the
// resident planes as they are.
__global__ void sssp_init_kernel(
    const int* __restrict__ shift_w, int* __restrict__ sw,
    const int* __restrict__ res_rows, const int* __restrict__ res_nbr,
    const int* __restrict__ res_w, int* __restrict__ rows_c,
    int* __restrict__ nbr_c, int* __restrict__ rw,
    const int* __restrict__ seeds_nbr, const int* __restrict__ seeds_w,
    int* __restrict__ dist0, int s_cap, int n_cap, int r_cap, int kr_cap,
    int d_cap, int root, const int* __restrict__ roots, int col0,
    int w_cols) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = blockIdx.y;
    const long long n_sw = (long long)s_cap * w_cols;
    const long long n_res = (long long)r_cap * kr_cap;
    const long long n_dist = (long long)d_cap * n_cap;
    const int hi = n_cap - 1;
    if (roots) root = roots[lane];
    if (i < n_sw) {
        int u = col0 + (int)(i % w_cols);
        i += lane * n_sw;
        sw[i] = (u == root) ? INF_E : shift_w[i];
        return;
    }
    i -= n_sw;
    if (i < n_res) {
        i += lane * n_res;
        int nb = res_nbr[i];
        rw[i] = (nb == root) ? INF_E : res_w[i];
        nbr_c[i] = min(max(nb, 0), hi);
        return;
    }
    i -= n_res;
    if (i < r_cap) {
        i += (long long)lane * r_cap;
        rows_c[i] = min(max(res_rows[i], 0), hi);
        return;
    }
    i -= r_cap;
    if (i < n_dist) {
        int d = (int)(i / n_cap);
        int u = (int)(i - (long long)d * n_cap);
        d += lane * d_cap;
        int seed = min(max(seeds_nbr[d], 0), hi);
        int v = INF_E;
        if (u == seed && seeds_w[d] < INF_E) v = 0;
        dist0[lane * n_dist + i] = v;
    }
}

// K1 shift part: out[d,u] = min(dist[d,u], min_k dist[d,src] + sw[k,src])
// with src = (u - deltas[k]) mod n_cap, over the sources in the column
// window (K1 [mc]; the whole width on one card). Jacobi: reads `dist`, writes
// `out` (a different buffer), so trips/rounds match the JAX loop.
__global__ void relax_shift_kernel(
    const int* __restrict__ dist, int* __restrict__ out,
    const int* __restrict__ deltas, const int* __restrict__ sw,
    int d_cap, int n_cap, int s_cap, int col0, int w_cols,
    int* __restrict__ flag, Gate gate) {
    const int lane = blockIdx.y;
    if (!gate_open(gate, lane)) return;
    const long long plane = (long long)d_cap * n_cap;
    dist += lane * plane;
    out += lane * plane;
    deltas += (long long)lane * s_cap;
    sw += lane * (long long)s_cap * w_cols;
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int changed = 0;
    if (i < plane) {
        const unsigned hi = (unsigned)n_cap - 1u;
        int d = (int)(i / n_cap);
        unsigned u = (unsigned)(i - (long long)d * n_cap);
        const int* row = dist + (long long)d * n_cap;
        int cur = row[u];
        int acc = cur;
        for (int k = 0; k < s_cap; ++k) {
            unsigned src = (u - (unsigned)deltas[k]) & hi;
            unsigned lc = src - (unsigned)col0;  // local column
            if (lc < (unsigned)w_cols)
                acc = min(acc, row[src] + sw[(long long)k * w_cols + lc]);
        }
        out[i] = acc;
        changed = acc < cur;
    }
    int any = __syncthreads_or(changed);
    if (threadIdx.x == 0) {
        if (any && flag) atomicOr(flag, 1);
        gate_close(gate, lane, any);
    }
}

// K1 residual part: the row-compact ELL tail scatter-min'd into `out`
// after relax_shift_kernel wrote it. Candidates read the incoming plane
// `dist` (Jacobi). Indices are clipped into range here too (K1s's
// clipped copies are idempotent under it), so the unmasked SSSP passes
// the resident ELL as it is. Pad rows clip to row 0 and carry INF_E
// weights, and real rows may repeat, so the scatter is an atomicMin —
// exact on int32 in any order. With `shared` set, every lane reads the
// one resident row / neighbour index table and only the weights `rw`
// are per lane: the masked KSP2 rows and the what-if lanes
// (csrc/ksp2.cu's overlay_planes) override weights, never indices.
__global__ void relax_residual_kernel(
    const int* __restrict__ dist, int* __restrict__ out,
    const int* __restrict__ rows_c, const int* __restrict__ nbr_c,
    const int* __restrict__ rw, int d_cap, int n_cap, int r_cap,
    int kr_cap, int shared, int* __restrict__ flag, Gate gate) {
    const int lane = blockIdx.y;
    if (!gate_open(gate, lane)) return;
    const long long plane = (long long)d_cap * n_cap;
    const long long ell = (long long)r_cap * kr_cap;
    dist += lane * plane;
    out += lane * plane;
    if (!shared) {
        rows_c += (long long)lane * r_cap;
        nbr_c += lane * ell;
    }
    rw += lane * ell;
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int changed = 0;
    if (i < (long long)d_cap * r_cap) {
        int d = (int)(i / r_cap);
        int r = (int)(i - (long long)d * r_cap);
        const int* row = dist + (long long)d * n_cap;
        const int hi = n_cap - 1;
        int cand = INF_E << 1;
        for (int j = 0; j < kr_cap; ++j) {
            long long e = (long long)r * kr_cap + j;
            cand = min(cand, row[min(max(nbr_c[e], 0), hi)] + rw[e]);
        }
        int v = min(max(rows_c[r], 0), hi);
        if (cand < row[v]) {
            atomicMin(out + (long long)d * n_cap + v, cand);
            changed = 1;
        }
    }
    int any = __syncthreads_or(changed);
    if (threadIdx.x == 0) {
        if (any && flag) atomicOr(flag, 1);
        gate_close(gate, lane, any);
    }
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
                    if (any) {
                        if (gate.put0 != KEEP) gate.st[2 * lane] = gate.put0;
                        if (gate.put1 != KEEP)
                            gate.st[2 * lane + 1] = gate.put1;
                    }
                    if (k == 0 && tile == lane * per_lane) {
                        gate.cnt[2 * lane] += gate.inc0;
                        gate.cnt[2 * lane + 1] += gate.inc1;
                    }
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

extern "C" {

int sssp_init(const int* shift_w, int* sw, const int* res_rows,
              const int* res_nbr, const int* res_w, int* rows_c,
              int* nbr_c, int* rw, const int* seeds_nbr,
              const int* seeds_w, int* dist0, int s_cap, int n_cap,
              int r_cap, int kr_cap, int d_cap, int root, const int* roots,
              int g, int col0, int w_cols, cudaStream_t stream) {
    long long total = (long long)s_cap * w_cols + (long long)r_cap * kr_cap +
                      r_cap + (long long)d_cap * n_cap;
    sssp_init_kernel<<<grid_for(total, g), THREADS, 0, stream>>>(
        shift_w, sw, res_rows, res_nbr, res_w, rows_c, nbr_c, rw,
        seeds_nbr, seeds_w, dist0, s_cap, n_cap, r_cap, kr_cap, d_cap,
        root, roots, col0, w_cols);
    return (int)cudaGetLastError();
}

int relax_shift(const int* dist, int* out, const int* deltas,
                const int* sw, int d_cap, int n_cap, int s_cap, int col0,
                int w_cols, int* flag, int g, int* st, int* cnt, int thr0,
                int thr1, int put0, int put1, int inc0, int inc1,
                cudaStream_t stream) {
    relax_shift_kernel<<<grid_for((long long)d_cap * n_cap, g), THREADS, 0,
                         stream>>>(
        dist, out, deltas, sw, d_cap, n_cap, s_cap, col0, w_cols, flag,
        make_gate(st, cnt, thr0, thr1, put0, put1, inc0, inc1));
    return (int)cudaGetLastError();
}

int relax_residual(const int* dist, int* out, const int* rows_c,
                   const int* nbr_c, const int* rw, int d_cap, int n_cap,
                   int r_cap, int kr_cap, int shared, int* flag, int g,
                   int* st, int* cnt, int thr0, int thr1, int put0,
                   int put1, int inc0, int inc1, cudaStream_t stream) {
    relax_residual_kernel<<<grid_for((long long)d_cap * r_cap, g), THREADS,
                            0, stream>>>(
        dist, out, rows_c, nbr_c, rw, d_cap, n_cap, r_cap, kr_cap, shared,
        flag,
        make_gate(st, cnt, thr0, thr1, put0, put1, inc0, inc1));
    return (int)cudaGetLastError();
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
