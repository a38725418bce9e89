// SSSP relaxation kernels for Hopper (sm_90a): the cold Decision solve's
// batched shortest paths over the shift-decomposed mirror
// (ops/edgeplan.py). Host loops in ops/relax.py drive them; each entry
// point below launches exactly one kernel on the caller's stream and
// returns cudaGetLastError().
//
// Replaces the jitted XLA device code of the JAX package:
//   K1s  decision/tpu_solver.py::_plan_sssp      root masking + seed plane
//   K1   ops/relax.py::make_relax / run_sync     one Jacobi min-plus step
//   K2   ops/relax.py::run_bucketed             Δ-stepping light ladder
// K1s (seed plane only) and K1 over the unmasked planes also carry the
// single-root SSSP of ops/ksp2.py::_base_sssp_fn (ops/ksp2.py::base_sssp),
// and, with g > 1 lanes, their vmap in decision/tpu_solver.py::
// _fused_pipeline: every kernel takes `g` stacked same-shape areas and
// runs them as the grid's y dimension, so one launch covers every lane.
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

#include <cuda_runtime.h>
#include <stdint.h>

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

// K2 class score: score[k] = #{u : sw[k,u] <= dq}, one block per
// (class, lane).
__global__ void ladder_score_kernel(const int* __restrict__ sw,
                                    int* __restrict__ score, int s_cap,
                                    int n_cap, int dq) {
    __shared__ int part[THREADS];
    const long long k = (long long)blockIdx.y * s_cap + blockIdx.x;
    const int* row = sw + k * n_cap;
    int c = 0;
    for (int u = threadIdx.x; u < n_cap; u += blockDim.x) c += row[u] <= dq;
    part[threadIdx.x] = c;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
        __syncthreads();
    }
    if (threadIdx.x == 0) score[k] = part[0];
}

// K2 ladder rows: w_base[i,u] = sw[lad[i],u] if <= dq else INF_E, and
// d_base[i] = deltas[lad[i]] reduced mod n_cap. The rows are full width;
// K2 [mc] reads a shard's window of columns and leaves INF_E outside it.
__global__ void ladder_gather_kernel(
    const int* __restrict__ sw, const int* __restrict__ deltas,
    const int64_t* __restrict__ lad, int* __restrict__ w_base,
    int* __restrict__ d_base, int s_cap, int s_lad, int n_cap, int dq,
    int col0, int w_cols) {
    const int lane = blockIdx.y;
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)s_lad * n_cap) return;
    sw += lane * (long long)s_cap * w_cols;
    deltas += (long long)lane * s_cap;
    lad += (long long)lane * s_lad;
    w_base += lane * (long long)s_lad * n_cap;
    d_base += (long long)lane * s_lad;
    int k = (int)(i / n_cap);
    int u = (int)(i - (long long)k * n_cap);
    long long cls = lad[k];
    unsigned lc = (unsigned)(u - col0);
    int w = lc < (unsigned)w_cols ? sw[cls * w_cols + lc] : INF_E;
    w_base[i] = (w <= dq) ? w : INF_E;
    if (u == 0) d_base[k] = (int)((unsigned)deltas[cls] & ((unsigned)n_cap - 1u));
}

// K2 one class application of a ladder pass (Gauss-Seidel across
// classes, so one launch per class): dst = min(src, roll(src + w[k],
// d[k])). src and dst are different buffers.
__global__ void ladder_apply_kernel(
    const int* __restrict__ src, int* __restrict__ dst,
    const int* __restrict__ w, const int* __restrict__ dd, int k,
    int s_lad, int d_cap, int n_cap, int* __restrict__ flag, Gate gate) {
    const int lane = blockIdx.y;
    if (!gate_open(gate, lane)) return;
    const long long plane = (long long)d_cap * n_cap;
    src += lane * plane;
    dst += lane * plane;
    w += lane * (long long)s_lad * n_cap;
    dd += (long long)lane * s_lad;
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int changed = 0;
    if (i < plane) {
        const unsigned hi = (unsigned)n_cap - 1u;
        int d = (int)(i / n_cap);
        unsigned u = (unsigned)(i - (long long)d * n_cap);
        const int* row = src + (long long)d * n_cap;
        unsigned s = (u - (unsigned)dd[k]) & hi;
        int cur = row[u];
        int v = min(cur, row[s] + w[(long long)k * n_cap + s]);
        dst[i] = v;
        changed = v < cur;
    }
    int any = __syncthreads_or(changed);
    if (threadIdx.x == 0) {
        if (any) atomicOr(flag, 1);
        gate_close(gate, lane, any);
    }
}

// K2 rung doubling: w2[k,u] = min(w[k,u] + w[k,(u + d[k]) mod n], INF_E),
// d2[k] = 2 d[k] mod n_cap. Separate output buffers: every thread reads
// w and d as the previous rung left them. Gated lanes (their ladder
// stopped) keep stale rungs they never read.
__global__ void ladder_rung_kernel(
    const int* __restrict__ w, const int* __restrict__ dd,
    int* __restrict__ w2, int* __restrict__ d2, int s_lad, int n_cap,
    Gate gate) {
    const int lane = blockIdx.y;
    if (!gate_open(gate, lane)) return;
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)s_lad * n_cap) return;
    const long long rung = (long long)s_lad * n_cap;
    w += lane * rung;
    w2 += lane * rung;
    dd += (long long)lane * s_lad;
    d2 += (long long)lane * s_lad;
    const unsigned hi = (unsigned)n_cap - 1u;
    int k = (int)(i / n_cap);
    unsigned u = (unsigned)(i - (long long)k * n_cap);
    const int* row = w + (long long)k * n_cap;
    unsigned dk = (unsigned)dd[k];
    w2[i] = min(row[u] + row[(u + dk) & hi], INF_E);
    if (u == 0) d2[k] = (int)((dk * 2u) & hi);
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

int ladder_score(const int* sw, int* score, int s_cap, int n_cap, int dq,
                 int g, cudaStream_t stream) {
    ladder_score_kernel<<<dim3(s_cap, g), THREADS, 0, stream>>>(
        sw, score, s_cap, n_cap, dq);
    return (int)cudaGetLastError();
}

int ladder_gather(const int* sw, const int* deltas, const int64_t* lad,
                  int* w_base, int* d_base, int s_cap, int s_lad, int n_cap,
                  int dq, int g, int col0, int w_cols, cudaStream_t stream) {
    ladder_gather_kernel<<<grid_for((long long)s_lad * n_cap, g), THREADS, 0,
                           stream>>>(sw, deltas, lad, w_base, d_base, s_cap,
                                     s_lad, n_cap, dq, col0, w_cols);
    return (int)cudaGetLastError();
}

int ladder_apply(const int* src, int* dst, const int* w, const int* dd,
                 int k, int s_lad, int d_cap, int n_cap, int* flag, int g,
                 int* st, int* cnt, int thr0, int thr1, int put0, int put1,
                 int inc0, int inc1, cudaStream_t stream) {
    ladder_apply_kernel<<<grid_for((long long)d_cap * n_cap, g), THREADS, 0,
                          stream>>>(
        src, dst, w, dd, k, s_lad, d_cap, n_cap, flag,
        make_gate(st, cnt, thr0, thr1, put0, put1, inc0, inc1));
    return (int)cudaGetLastError();
}

int ladder_rung(const int* w, const int* dd, int* w2, int* d2, int s_lad,
                int n_cap, int g, int* st, int* cnt, int thr0, int thr1,
                int put0, int put1, int inc0, int inc1,
                cudaStream_t stream) {
    ladder_rung_kernel<<<grid_for((long long)s_lad * n_cap, g), THREADS, 0,
                         stream>>>(
        w, dd, w2, d2, s_lad, n_cap,
        make_gate(st, cnt, thr0, thr1, put0, put1, inc0, inc1));
    return (int)cudaGetLastError();
}

}  // extern "C"
