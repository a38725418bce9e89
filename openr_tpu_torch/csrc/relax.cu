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

static inline unsigned blocks_for(long long n) {
    long long b = (n + THREADS - 1) / THREADS;
    return (unsigned)(b > 0 ? b : 1);
}

// K1s: sw = shift_w with column `root` set to INF_E (root is never a
// transit node); residual weights masked where the source is the root,
// residual indices clipped into range; dist0[d, clip(seed_d)] = 0 for
// live seeds, INF_E elsewhere. One flat index space over the four
// outputs so the whole init is a single launch.
__global__ void sssp_init_kernel(
    const int* __restrict__ shift_w, int* __restrict__ sw,
    const int* __restrict__ res_rows, const int* __restrict__ res_nbr,
    const int* __restrict__ res_w, int* __restrict__ rows_c,
    int* __restrict__ nbr_c, int* __restrict__ rw,
    const int* __restrict__ seeds_nbr, const int* __restrict__ seeds_w,
    int* __restrict__ dist0, int s_cap, int n_cap, int r_cap, int kr_cap,
    int d_cap, int root) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long n_sw = (long long)s_cap * n_cap;
    const long long n_res = (long long)r_cap * kr_cap;
    const long long n_dist = (long long)d_cap * n_cap;
    const int hi = n_cap - 1;
    if (i < n_sw) {
        int u = (int)(i & hi);
        sw[i] = (u == root) ? INF_E : shift_w[i];
        return;
    }
    i -= n_sw;
    if (i < n_res) {
        int nb = res_nbr[i];
        rw[i] = (nb == root) ? INF_E : res_w[i];
        nbr_c[i] = min(max(nb, 0), hi);
        return;
    }
    i -= n_res;
    if (i < r_cap) {
        rows_c[i] = min(max(res_rows[i], 0), hi);
        return;
    }
    i -= r_cap;
    if (i < n_dist) {
        int d = (int)(i / n_cap);
        int u = (int)(i - (long long)d * n_cap);
        int seed = min(max(seeds_nbr[d], 0), hi);
        int v = INF_E;
        if (u == seed && seeds_w[d] < INF_E) v = 0;
        dist0[i] = v;
    }
}

// K1 shift part: out[d,u] = min(dist[d,u], min_k dist[d,src] + sw[k,src])
// with src = (u - deltas[k]) mod n_cap. Jacobi: reads `dist`, writes
// `out` (a different buffer), so trips/rounds match the JAX loop.
__global__ void relax_shift_kernel(
    const int* __restrict__ dist, int* __restrict__ out,
    const int* __restrict__ deltas, const int* __restrict__ sw,
    int d_cap, int n_cap, int s_cap, int* __restrict__ flag) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int changed = 0;
    if (i < (long long)d_cap * n_cap) {
        const unsigned hi = (unsigned)n_cap - 1u;
        int d = (int)(i / n_cap);
        unsigned u = (unsigned)(i - (long long)d * n_cap);
        const int* row = dist + (long long)d * n_cap;
        int cur = row[u];
        int acc = cur;
        for (int k = 0; k < s_cap; ++k) {
            unsigned src = (u - (unsigned)deltas[k]) & hi;
            acc = min(acc, row[src] + sw[(long long)k * n_cap + src]);
        }
        out[i] = acc;
        changed = acc < cur;
    }
    if (__syncthreads_or(changed) && threadIdx.x == 0) atomicOr(flag, 1);
}

// K1 residual part: the row-compact ELL tail scatter-min'd into `out`
// after relax_shift_kernel wrote it. Candidates read the incoming plane
// `dist` (Jacobi). Pad rows were clipped to row 0 and carry INF_E
// weights, and real rows may repeat, so the scatter is an atomicMin —
// exact on int32 in any order.
__global__ void relax_residual_kernel(
    const int* __restrict__ dist, int* __restrict__ out,
    const int* __restrict__ rows_c, const int* __restrict__ nbr_c,
    const int* __restrict__ rw, int d_cap, int n_cap, int r_cap,
    int kr_cap, int* __restrict__ flag) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int changed = 0;
    if (i < (long long)d_cap * r_cap) {
        int d = (int)(i / r_cap);
        int r = (int)(i - (long long)d * r_cap);
        const int* row = dist + (long long)d * n_cap;
        int cand = INF_E << 1;
        for (int j = 0; j < kr_cap; ++j) {
            long long e = (long long)r * kr_cap + j;
            cand = min(cand, row[nbr_c[e]] + rw[e]);
        }
        int v = rows_c[r];
        if (cand < row[v]) {
            atomicMin(out + (long long)d * n_cap + v, cand);
            changed = 1;
        }
    }
    if (__syncthreads_or(changed) && threadIdx.x == 0) atomicOr(flag, 1);
}

// K2 class score: score[k] = #{u : sw[k,u] <= dq}, one block per class.
__global__ void ladder_score_kernel(const int* __restrict__ sw,
                                    int* __restrict__ score, int n_cap,
                                    int dq) {
    __shared__ int part[THREADS];
    const int* row = sw + (long long)blockIdx.x * n_cap;
    int c = 0;
    for (int u = threadIdx.x; u < n_cap; u += blockDim.x) c += row[u] <= dq;
    part[threadIdx.x] = c;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
        __syncthreads();
    }
    if (threadIdx.x == 0) score[blockIdx.x] = part[0];
}

// K2 ladder rows: w_base[i,u] = sw[lad[i],u] if <= dq else INF_E, and
// d_base[i] = deltas[lad[i]] reduced mod n_cap.
__global__ void ladder_gather_kernel(
    const int* __restrict__ sw, const int* __restrict__ deltas,
    const int64_t* __restrict__ lad, int* __restrict__ w_base,
    int* __restrict__ d_base, int s_lad, int n_cap, int dq) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)s_lad * n_cap) return;
    int k = (int)(i / n_cap);
    int u = (int)(i - (long long)k * n_cap);
    long long cls = lad[k];
    int w = sw[cls * n_cap + u];
    w_base[i] = (w <= dq) ? w : INF_E;
    if (u == 0) d_base[k] = (int)((unsigned)deltas[cls] & ((unsigned)n_cap - 1u));
}

// K2 one class application of a ladder pass (Gauss-Seidel across
// classes, so one launch per class): dst = min(src, roll(src + w[k],
// d[k])). src and dst are different buffers.
__global__ void ladder_apply_kernel(
    const int* __restrict__ src, int* __restrict__ dst,
    const int* __restrict__ w, const int* __restrict__ dd, int k,
    int d_cap, int n_cap, int* __restrict__ flag) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int changed = 0;
    if (i < (long long)d_cap * n_cap) {
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
    if (__syncthreads_or(changed) && threadIdx.x == 0) atomicOr(flag, 1);
}

// K2 rung doubling: w2[k,u] = min(w[k,u] + w[k,(u + d[k]) mod n], INF_E),
// d2[k] = 2 d[k] mod n_cap. Separate output buffers: every thread reads
// w and d as the previous rung left them.
__global__ void ladder_rung_kernel(
    const int* __restrict__ w, const int* __restrict__ dd,
    int* __restrict__ w2, int* __restrict__ d2, int s_lad, int n_cap) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)s_lad * n_cap) return;
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
              int r_cap, int kr_cap, int d_cap, int root,
              cudaStream_t stream) {
    long long total = (long long)s_cap * n_cap + (long long)r_cap * kr_cap +
                      r_cap + (long long)d_cap * n_cap;
    sssp_init_kernel<<<blocks_for(total), THREADS, 0, stream>>>(
        shift_w, sw, res_rows, res_nbr, res_w, rows_c, nbr_c, rw,
        seeds_nbr, seeds_w, dist0, s_cap, n_cap, r_cap, kr_cap, d_cap,
        root);
    return (int)cudaGetLastError();
}

int relax_shift(const int* dist, int* out, const int* deltas,
                const int* sw, int d_cap, int n_cap, int s_cap, int* flag,
                cudaStream_t stream) {
    relax_shift_kernel<<<blocks_for((long long)d_cap * n_cap), THREADS, 0,
                         stream>>>(dist, out, deltas, sw, d_cap, n_cap,
                                   s_cap, flag);
    return (int)cudaGetLastError();
}

int relax_residual(const int* dist, int* out, const int* rows_c,
                   const int* nbr_c, const int* rw, int d_cap, int n_cap,
                   int r_cap, int kr_cap, int* flag, cudaStream_t stream) {
    relax_residual_kernel<<<blocks_for((long long)d_cap * r_cap), THREADS,
                            0, stream>>>(dist, out, rows_c, nbr_c, rw,
                                         d_cap, n_cap, r_cap, kr_cap, flag);
    return (int)cudaGetLastError();
}

int ladder_score(const int* sw, int* score, int s_cap, int n_cap, int dq,
                 cudaStream_t stream) {
    ladder_score_kernel<<<s_cap, THREADS, 0, stream>>>(sw, score, n_cap, dq);
    return (int)cudaGetLastError();
}

int ladder_gather(const int* sw, const int* deltas, const int64_t* lad,
                  int* w_base, int* d_base, int s_lad, int n_cap, int dq,
                  cudaStream_t stream) {
    ladder_gather_kernel<<<blocks_for((long long)s_lad * n_cap), THREADS, 0,
                           stream>>>(sw, deltas, lad, w_base, d_base, s_lad,
                                     n_cap, dq);
    return (int)cudaGetLastError();
}

int ladder_apply(const int* src, int* dst, const int* w, const int* dd,
                 int k, int d_cap, int n_cap, int* flag,
                 cudaStream_t stream) {
    ladder_apply_kernel<<<blocks_for((long long)d_cap * n_cap), THREADS, 0,
                          stream>>>(src, dst, w, dd, k, d_cap, n_cap, flag);
    return (int)cudaGetLastError();
}

int ladder_rung(const int* w, const int* dd, int* w2, int* d2, int s_lad,
                int n_cap, cudaStream_t stream) {
    ladder_rung_kernel<<<blocks_for((long long)s_lad * n_cap), THREADS, 0,
                         stream>>>(w, dd, w2, d2, s_lad, n_cap);
    return (int)cudaGetLastError();
}

}  // extern "C"
