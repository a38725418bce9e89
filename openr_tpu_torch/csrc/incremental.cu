// Incremental SSSP kernels for Hopper (sm_90a): the churn solve's dirty
// scatter, parent forest and affected cone (ops/incremental.py drives
// them and documents the algorithm). Each entry point launches exactly
// one kernel on the caller's stream and returns cudaGetLastError().
//
// Replaces the jitted XLA device code of the JAX package:
//   K5  decision/tpu_solver.py::_scatter_jit            flat .at[idx].set
//   K5 old planes  ops/incremental.py::_old_planes with incremental_sssp's
//       root mask (:150-162): the new resident plane copied once with
//       the dirty slots' pre-drain values put back and the root's slots
//       at INF_E, one launch a plane
//   K6  ops/incremental.py::_parent_plane               parent forest
//   K7  ops/incremental.py::incremental_sssp, :169-205  cone seeds
//   K8  ops/incremental.py::incremental_sssp, :207-240  cone spread step
//   K9  ops/incremental.py::incremental_sssp, :242-254  cone size,
//       in-device fallback decision, warm or cold seed plane
// and, with a window of columns (or rows) per shard, their multichip
// variants in parallel/sharding.py::make_mc_incremental_sssp:
//   K5 [mc]  global flat indices translated to the shard's window, the
//            rest dropped (:494-516; decision/tpu_solver.py::
//            _mc_scatter_jit, :1113, the in-place sharded scatter)
//   K6 [mc]  tight edges over the shard's own source columns (:527-551;
//            the group then takes the max of its members' planes)
//   K7 [mc]  the dirty slots' new weights read from the owning shard
//            (:575-580; min over the group), and the seeds from those
//            combined weights (:581-598)
//
// Bound: bytes. K6, K8 and K9 stream [D, n_cap] int32 planes once
// (K6 also the [s_cap, n_cap] old weights) with a handful of integer
// ops per word; the old planes read and write their plane once; K7
// writes its [D, n_cap] plane once; K5 touches a few thousand dirty
// entries. Design: one thread per (lane, node) or per dirty entry,
// neighbouring threads on neighbouring nodes, so plane loads coalesce
// except the parent gathers of K8, which follow the forest. Change
// flags reduce per block with __syncthreads_or before one atomicOr; the
// cone count reduces per warp with shuffles before one atomicAdd.
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
// cone rides the pull buffers. K6 tries shift classes in order and
// stops at the first tight one (lowest class wins), then fills nodes
// still without a parent from their residual row, first tight slot
// first; residual rows are unique per node, so each (lane, row) thread
// owns its node's word. Pad rows (res_rows == -1) are skipped, never
// clipped onto node 0. K7's ones and K9's count commute, so their
// store order does not matter (K7's zeros precede its ones, above).
// The old planes need unique in-range dirty indices, as K5 does (the
// lists are consolidated, ops/edgeplan._consolidate).
//
// Index arithmetic: n_cap is a power of two, so the class-k edge u -> v
// with v = (u + δ_k) mod n_cap has u = (v - δ_k) & (n_cap - 1) in
// unsigned arithmetic, exact for any int32 shift. INF discipline:
// weights <= 2^28, INF_E = 2^29, every sum <= 2^30.

#include <cuda_runtime.h>
#include <stdint.h>

#define INF_E (1 << 29)
#define THREADS 256

static inline unsigned blocks_for(long long n) {
    long long b = (n + THREADS - 1) / THREADS;
    return (unsigned)(b > 0 ? b : 1);
}

// K5: plane[idx[i]] = vals[i] for idx[i] in [0, numel); others drop.
__global__ void scatter_set_kernel(int* __restrict__ plane,
                                   const int* __restrict__ idx,
                                   const int* __restrict__ vals, int n,
                                   int numel) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int f = idx[i];
    if (f >= 0 && f < numel) plane[f] = vals[i];
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

// K5 [mc]: idx[i] is a flat index into a global [rows, cols] plane; the
// shard holds the window [row0, row0 + w_rows) x [col0, col0 + w_cols)
// as a [w_rows, w_cols] plane. Entries inside the window are set at
// their local index, every other entry (foreign or pad) drops.
__global__ void scatter_window_kernel(int* __restrict__ plane,
                                      const int* __restrict__ idx,
                                      const int* __restrict__ vals, int n,
                                      int rows, int cols, int row0,
                                      int w_rows, int col0, int w_cols) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int f = idx[i];
    if (f < 0 || (long long)f >= (long long)rows * cols) return;
    int lr = f / cols - row0;
    int lc = f % cols - col0;
    if (lr < 0 || lr >= w_rows || lc < 0 || lc >= w_cols) return;
    plane[(long long)lr * w_cols + lc] = vals[i];
}

// K6 shift part: par[d, v] = (v - δ_k) mod n for the lowest class k
// whose old edge into v is tight under prev, else -1. K6 [mc]: only the
// sources u in the shard's column window [col0, col0 + w_cols) count,
// their old weights read from its [s_cap, w_cols] plane.
__global__ void parent_shift_kernel(const int* __restrict__ deltas,
                                    const int* __restrict__ swm_old,
                                    const int* __restrict__ prev,
                                    int* __restrict__ par, int s_cap,
                                    int n_cap, int d_cap, int col0,
                                    int w_cols) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)d_cap * n_cap) return;
    const unsigned hi = (unsigned)n_cap - 1u;
    int d = (int)(i / n_cap);
    unsigned v = (unsigned)(i - (long long)d * n_cap);
    const int* row = prev + (long long)d * n_cap;
    int pv = row[v];
    int p = -1;
    for (int k = 0; k < s_cap; ++k) {
        unsigned u = (v - (unsigned)deltas[k]) & hi;
        unsigned lc = u - (unsigned)col0;
        if (lc >= (unsigned)w_cols) continue;
        int pu = row[u];
        int w = swm_old[(long long)k * w_cols + lc];
        if (pu < INF_E && w < INF_E && pu + w == pv) {
            p = (int)u;
            break;
        }
    }
    par[i] = p;
}

// K6 residual part: for each valid row r (node v = res_rows[r]) still
// without a parent, the first slot j whose old edge nbr -> v is tight.
__global__ void parent_residual_kernel(const int* __restrict__ res_rows,
                                       const int* __restrict__ res_nbr,
                                       const int* __restrict__ rwm_old,
                                       const int* __restrict__ prev,
                                       int* __restrict__ par, int r_cap,
                                       int kr_cap, int n_cap, int d_cap) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)d_cap * r_cap) return;
    int d = (int)(i / r_cap);
    int r = (int)(i - (long long)d * r_cap);
    int v = res_rows[r];
    if (v < 0) return;  // pad row
    long long pos = (long long)d * n_cap + v;
    if (par[pos] >= 0) return;
    const int* row = prev + (long long)d * n_cap;
    int pv = row[v];
    for (int j = 0; j < kr_cap; ++j) {
        long long e = (long long)r * kr_cap + j;
        int nb = res_nbr[e];
        if (nb < 0) continue;
        int pu = row[min(nb, n_cap - 1)];
        int w = rwm_old[e];
        if (pu < INF_E && w < INF_E && pu + w == pv) {
            par[pos] = nb;
            return;
        }
    }
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

// K8: dst[d, v] = max(src[d, v], src[d, par[d, v]]) — Jacobi, one
// forest level per step.
__global__ void cone_step_kernel(const int* __restrict__ par,
                                 const int* __restrict__ src,
                                 int* __restrict__ dst,
                                 int* __restrict__ flag, int d_cap,
                                 int n_cap) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int changed = 0;
    if (i < (long long)d_cap * n_cap) {
        int cur = src[i];
        int p = par[i];
        int v = cur;
        if (p >= 0) {
            long long d = i / n_cap;
            v = max(cur, src[d * n_cap + p]);
        }
        dst[i] = v;
        changed = v != cur;
    }
    if (__syncthreads_or(changed) && threadIdx.x == 0) atomicOr(flag, 1);
}

// K9 count: tail[0] += sum(aff) (tail zeroed by the caller).
__global__ void cone_count_kernel(const int* __restrict__ aff,
                                  int* __restrict__ tail, int total) {
    int s = 0;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += (long long)gridDim.x * blockDim.x)
        s += aff[i];
    for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
    if ((threadIdx.x & 31) == 0 && s) atomicAdd(tail, s);
}

// K9 plane: fell_back = tail[0] > cone_limit (written to tail[1]); the
// seed is dist0 when it fell back, else prev with the cone at INF_E
// and the lane's live seed pinned to 0.
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
    if (fell) {
        plane[i] = dist0[i];
        return;
    }
    int d = (int)(i / n_cap);
    int u = (int)(i - (long long)d * n_cap);
    int v = aff[i] > 0 ? INF_E : prev[i];
    int seed = min(max(seeds_nbr[d], 0), n_cap - 1);
    if (u == seed && seeds_w[d] < INF_E) v = min(v, 0);
    plane[i] = v;
}

extern "C" {

int scatter_set(int* plane, const int* idx, const int* vals, int n,
                int numel, cudaStream_t stream) {
    scatter_set_kernel<<<blocks_for(n), THREADS, 0, stream>>>(plane, idx,
                                                              vals, n, numel);
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

int parent_shift(const int* deltas, const int* swm_old, const int* prev,
                 int* par, int s_cap, int n_cap, int d_cap, int col0,
                 int w_cols, cudaStream_t stream) {
    parent_shift_kernel<<<blocks_for((long long)d_cap * n_cap), THREADS, 0,
                          stream>>>(deltas, swm_old, prev, par, s_cap, n_cap,
                                    d_cap, col0, w_cols);
    return (int)cudaGetLastError();
}

int owned_weights(const int* swm_new, const int* s_idx, int* new_loc,
                  int n_s, int s_cap, int n_cap, int col0, int w_cols,
                  cudaStream_t stream) {
    owned_weights_kernel<<<blocks_for(n_s), THREADS, 0, stream>>>(
        swm_new, s_idx, new_loc, n_s, s_cap, n_cap, col0, w_cols);
    return (int)cudaGetLastError();
}

int parent_residual(const int* res_rows, const int* res_nbr,
                    const int* rwm_old, const int* prev, int* par, int r_cap,
                    int kr_cap, int n_cap, int d_cap, cudaStream_t stream) {
    parent_residual_kernel<<<blocks_for((long long)d_cap * r_cap), THREADS, 0,
                             stream>>>(res_rows, res_nbr, rwm_old, prev, par,
                                       r_cap, kr_cap, n_cap, d_cap);
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

int cone_step(const int* par, const int* src, int* dst, int* flag, int d_cap,
              int n_cap, cudaStream_t stream) {
    cone_step_kernel<<<blocks_for((long long)d_cap * n_cap), THREADS, 0,
                       stream>>>(par, src, dst, flag, d_cap, n_cap);
    return (int)cudaGetLastError();
}

int cone_count(const int* aff, int* tail, int total, cudaStream_t stream) {
    unsigned nblk = blocks_for(total);
    if (nblk > 1056) nblk = 1056;  // 8 blocks an SM, grid-stride past that
    cone_count_kernel<<<nblk, THREADS, 0, stream>>>(aff, tail, total);
    return (int)cudaGetLastError();
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
