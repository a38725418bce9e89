// Whole-fabric SSSP kernels for Hopper (sm_90a): every requested root's
// batched-seed SSSP over ONE shared copy of the shift-decomposed mirror
// (ops/edgeplan.py), and the unpacking of the selection's bit words.
// The host loop in ops/fabric.py drives them; each entry point launches
// exactly one kernel on the caller's stream and returns
// cudaGetLastError().
//
// Replaces the jitted XLA device code of parallel/sharding.py::
// _sharded_fabric_fn (:70) on one card (graph axis 1, so its pmin is
// the identity):
//   K21  one relaxation of every root's [D, n_cap] plane (make_relax
//        under the fori_loop, :125-147, and the vote, :148), the root
//        masked as a transit node (:108-112), gated per root
//   K21e each residual row's live extent, once a step, for K21
//   K22  the selection's 16-bit words unpacked to the bool [.., X]
//        masks the step returns (s3, nh_mask, :213)
// The seed planes come from K1s with a root axis and the selection is K3
// with a root axis and one shared announcer matrix.
//
// K21 [mc], the same step on a ('batch', 'graph') mesh wider than one
// card (_sharded_fabric_fn's graph split, :104-148): a shard holds the
// class-weight columns [col0, col0 + w_cols) as [s_cap, w_cols] and its
// own residual rows, and relaxes over those sources only; the group's
// min over its members' planes (csrc/combine.cu) is the reference's
// pmin. The node axis may then be padded to a multiple of the graph
// size (sharded_fabric_step, :755-762), so n_cap need not be a power of
// two: a shift is a signed difference of node indices (|δ| < n_cap,
// ops/edgeplan.py), so a source index u - δ wraps at most once. The pad
// columns carry INF_E weights: they never
// lower a word and are never a real edge's target.
//
// Root masking without copies: the reference gives each root private
// class weights with the root's source column set to INF_E, and
// residual weights set to INF_E where the source is the root. Such a
// candidate is dist + INF_E >= INF_E and never lowers a word (every
// plane word is <= INF_E), so here a relaxation skips the source that
// is its lane's root instead; the planes stay one shared copy (private
// planes would cost roots x s_cap x n_cap x 4 bytes, ~2 GB at 4,096
// fabric10k roots).
//
// Lane gates (the Gate of csrc/relax.cu): lane = root, on the grid's y
// dimension. A root whose planes changed nothing in the previous trip
// reached its fixpoint; its blocks return before touching memory and
// its two plane buffers are equal, so the host's buffer swaps stay
// valid for it. The per-root change stamps also carry the convergence
// vote: one more gated relaxation after the fixed trips, and a root
// that changed in it did not converge.
//
// Bound: the shift part streams each root's [D, n_cap] plane once (the
// s_cap shared class rows stay in L2) with 2 integer ops per class and
// word; the residual part reads r_cap x kr_cap shared index and weight
// words per (root, lane) from L2 and gathers one distance for each
// entry of finite weight (an INF_E weight cannot lower a word). Design
// as K1: one thread per output word (shift) or per (lane, residual row)
// (residual, atomicMin into the row's target), neighbouring threads on
// neighbouring nodes; the change flag is reduced per block with
// __syncthreads_or before one atomicOr.

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

// K21 shift part: out[r,d,u] = min(dist[r,d,u], min over classes k whose
// source src = (u - deltas[k]) mod n_cap is not roots[r] and lies in the
// column window of dist[r,d,src] + sw[k,src - col0]). Jacobi: reads
// `dist`, writes `out`. |deltas[k]| < n_cap.
__global__ void fabric_shift_kernel(
    const int* __restrict__ dist, int* __restrict__ out,
    const int* __restrict__ deltas, const int* __restrict__ sw,
    const int* __restrict__ roots, int d_cap, int n_cap, int s_cap,
    int col0, int w_cols, int* __restrict__ flag, Gate gate) {
    const int lane = blockIdx.y;
    if (!gate_open(gate, lane)) return;
    const long long plane = (long long)d_cap * n_cap;
    dist += lane * plane;
    out += lane * plane;
    const unsigned root = (unsigned)roots[lane];
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int changed = 0;
    if (i < plane) {
        int d = (int)(i / n_cap);
        unsigned u = (unsigned)(i - (long long)d * n_cap);
        const int* row = dist + (long long)d * n_cap;
        int cur = row[u];
        int acc = cur;
        for (int k = 0; k < s_cap; ++k) {
            int s = (int)u - deltas[k];
            s += s < 0 ? n_cap : (s >= n_cap ? -n_cap : 0);
            unsigned src = (unsigned)s;
            unsigned lc = src - (unsigned)col0;
            if (src == root || lc >= (unsigned)w_cols) continue;
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

// K21e: ext[r] = 1 + the last column of residual row r whose weight is
// finite (< INF_E), 0 for a row with none. Entries past it cannot lower
// a word, so K21's residual part stops there: the pad rows of the
// row-compact ELL (most of its r_cap rows) then cost one load a lane
// instead of kr_cap.
__global__ void fabric_extent_kernel(const int* __restrict__ res_w,
                                     int* __restrict__ ext, int r_cap,
                                     int kr_cap) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= r_cap) return;
    const int* row = res_w + (long long)r * kr_cap;
    int e = 0;
    for (int j = 0; j < kr_cap; ++j)
        if (row[j] < INF_E) e = j + 1;
    ext[r] = e;
}

// K21 residual part: the shared row-compact ELL tail scatter-min'd into
// `out` after fabric_shift_kernel wrote it, candidates from the
// incoming plane `dist` (Jacobi), row r's entries up to ext[r] (K21e).
// Indices are clipped into range as they are read; entries whose
// (unclipped) source is the lane's root are skipped. Pad rows clip to
// row 0 and carry INF_E weights, and real rows may repeat, so the
// scatter is an atomicMin.
__global__ void fabric_residual_kernel(
    const int* __restrict__ dist, int* __restrict__ out,
    const int* __restrict__ res_rows, const int* __restrict__ res_nbr,
    const int* __restrict__ res_w, const int* __restrict__ ext,
    const int* __restrict__ roots, int d_cap, int n_cap, int r_cap,
    int kr_cap, int* __restrict__ flag, Gate gate) {
    const int lane = blockIdx.y;
    if (!gate_open(gate, lane)) return;
    const long long plane = (long long)d_cap * n_cap;
    dist += lane * plane;
    out += lane * plane;
    const int root = roots[lane];
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int changed = 0;
    if (i < (long long)d_cap * r_cap) {
        int d = (int)(i / r_cap);
        int r = (int)(i - (long long)d * r_cap);
        const int* row = dist + (long long)d * n_cap;
        const int hi = n_cap - 1;
        int cand = INF_E << 1;
        const int e_r = ext[r];
        for (int j = 0; j < e_r; ++j) {
            long long e = (long long)r * kr_cap + j;
            // an INF_E weight (pads, tombstones) never lowers a word
            int w = res_w[e];
            if (w >= INF_E) continue;
            int nb = res_nbr[e];
            if (nb == root) continue;
            cand = min(cand, row[min(max(nb, 0), hi)] + w);
        }
        int v = min(max(res_rows[r], 0), hi);
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

// K22: bits[m, x] = bit (x mod 16) of words[m, x / 16], as bytes.
__global__ void unpack_bits_kernel(const int* __restrict__ words,
                                   uint8_t* __restrict__ bits, long long m,
                                   int w, int x) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m * x) return;
    long long row = i / x;
    int c = (int)(i - row * x);
    bits[i] = (uint8_t)((words[row * w + (c >> 4)] >> (c & 15)) & 1);
}

extern "C" {

int fabric_shift(const int* dist, int* out, const int* deltas, const int* sw,
                 const int* roots, int d_cap, int n_cap, int s_cap, int col0,
                 int w_cols, int* flag, int g, int* st, int* cnt, int thr0,
                 int thr1, int put0, int put1, int inc0, int inc1,
                 cudaStream_t stream) {
    Gate gate = {st, cnt, thr0, thr1, put0, put1, inc0, inc1};
    fabric_shift_kernel<<<grid_for((long long)d_cap * n_cap, g), THREADS, 0,
                          stream>>>(dist, out, deltas, sw, roots, d_cap, n_cap,
                                    s_cap, col0, w_cols, flag, gate);
    return (int)cudaGetLastError();
}

int fabric_extent(const int* res_w, int* ext, int r_cap, int kr_cap,
                  cudaStream_t stream) {
    fabric_extent_kernel<<<grid_for(r_cap, 1), THREADS, 0, stream>>>(
        res_w, ext, r_cap, kr_cap);
    return (int)cudaGetLastError();
}

int fabric_residual(const int* dist, int* out, const int* res_rows,
                    const int* res_nbr, const int* res_w, const int* ext,
                    const int* roots, int d_cap, int n_cap, int r_cap,
                    int kr_cap, int* flag, int g, int* st, int* cnt, int thr0,
                    int thr1, int put0, int put1, int inc0, int inc1,
                    cudaStream_t stream) {
    Gate gate = {st, cnt, thr0, thr1, put0, put1, inc0, inc1};
    fabric_residual_kernel<<<grid_for((long long)d_cap * r_cap, g), THREADS,
                             0, stream>>>(dist, out, res_rows, res_nbr, res_w,
                                          ext, roots, d_cap, n_cap, r_cap,
                                          kr_cap, flag, gate);
    return (int)cudaGetLastError();
}

int unpack_bits(const int* words, uint8_t* bits, long long m, int w, int x,
                cudaStream_t stream) {
    unpack_bits_kernel<<<grid_for(m * x, 1), THREADS, 0, stream>>>(
        words, bits, m, w, x);
    return (int)cudaGetLastError();
}

}  // extern "C"
