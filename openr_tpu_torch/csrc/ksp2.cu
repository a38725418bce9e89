// Masked-row kernels for Hopper (sm_90a): the device half of KSP2's
// second pass and of the what-if sweeps (ops/ksp2.py, ops/sweep.py).
// Each entry point launches exactly one kernel on the caller's stream
// and returns cudaGetLastError().
//
// Replaces the jitted XLA device code of the JAX package:
//   K10  ops/ksp2.py::_make_one_sssp's masked planes (the vmapped
//        `.at[idx].set(INF_E, mode="drop")` of _masked_rows_fn /
//        _masked_rows_delta_fn) and ops/sweep.py::_make_sweep's per-lane
//        overlays (`.at[si].set(sv, mode="drop")`)
//   K11  ops/ksp2.py::_masked_rows_delta_fn's compaction: per row the
//        count of nodes that differ from the previous generation's row,
//        and the first k_cap of them as (idx, val) pairs
// The masked rows then relax on K1 (csrc/relax.cu) with a leading lane
// axis, seeded by K1s; the sweep verdicts reduce on K12 (csrc/sweep.cu).
//
// K10 overlay_planes: B private copies of the shared resident planes
// (shift_w [s_cap, n_cap] and, with a residual, res_w [r_cap, kr_cap]),
// each with its lane's (flat idx, val) overrides written in. Pads are
// flat indices past the plane (s_cap * n_cap, r_cap * kr_cap) and are
// dropped, as mode="drop" drops them. A null value array means INF_E
// for every override (KSP2 removes edges). Bound: bytes — it writes
// B * 4 * (s_cap * n_cap + r_cap * kr_cap) and reads the shared planes
// once from device memory (the other lanes' reads hit L2). Design: one
// flat index space over both planes, grid.y the lane; each block copies
// its slice, then (after __syncthreads, so the copy is ordered before)
// the block's first threads write those of the lane's overrides that
// fall inside the slice. No override is written by two blocks, so one
// launch is race-free; two overrides of one slot with different values
// never occur in either caller (KSP2 writes INF_E only, a what-if
// scenario touches each directed slot once).
//
// K11 masked_delta: one block per row. The row streams through in
// chunks of the block's width; a warp-ballot + shared-memory scan gives
// each changed node its rank, and ranks below k_cap write idx/val.
// Ranks are taken in node order, so the indices come out ascending, as
// jnp.nonzero(size=k_cap, fill_value=n_cap) gives them. Pad slots carry
// idx n_cap and val dist[n_cap - 1] (the clip of the pad index), and
// cnt counts every changed node, past k_cap too (the host reads cnt >
// k_cap as overflow). Bound: bytes — two [n_cap] int32 rows read per
// row, 4 * (1 + 2 k_cap) bytes written.

#include <cuda_runtime.h>
#include <stdint.h>

#define INF_E (1 << 29)
#define THREADS 256
#define ITEMS 8            // plane words a K10 thread copies
#define DELTA_THREADS 1024  // K11 block width (32 warps)

__global__ void overlay_planes_kernel(
    const int* __restrict__ shift_w, const int* __restrict__ res_w,
    int* __restrict__ sw, int* __restrict__ rw, long long n_s,
    long long n_r, const int* __restrict__ s_idx,
    const int* __restrict__ s_val, int es, const int* __restrict__ r_idx,
    const int* __restrict__ r_val, int er) {
    const int lane = blockIdx.y;
    const long long span = (long long)THREADS * ITEMS;
    const long long lo = (long long)blockIdx.x * span;
    const long long hi = lo + span;
    int* sw_l = sw + lane * n_s;
    int* rw_l = rw ? rw + lane * n_r : nullptr;
    for (int j = 0; j < ITEMS; ++j) {
        long long i = lo + (long long)j * THREADS + threadIdx.x;
        if (i < n_s) {
            sw_l[i] = shift_w[i];
        } else if (i - n_s < n_r) {
            rw_l[i - n_s] = res_w[i - n_s];
        }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < es + er; t += THREADS) {
        if (t < es) {
            long long f = s_idx[(long long)lane * es + t];
            if (f >= 0 && f < n_s && f >= lo && f < hi)
                sw_l[f] = s_val ? s_val[(long long)lane * es + t] : INF_E;
        } else {
            int tr = t - es;
            long long f = r_idx[(long long)lane * er + tr];
            if (f >= 0 && f < n_r && f + n_s >= lo && f + n_s < hi)
                rw_l[f] = r_val ? r_val[(long long)lane * er + tr] : INF_E;
        }
    }
}

__global__ void masked_delta_kernel(const int* __restrict__ dist,
                                    const int* __restrict__ prev,
                                    int* __restrict__ packed, int n_cap,
                                    int k_cap) {
    __shared__ int warp_off[DELTA_THREADS / 32];
    __shared__ int chunk_total;
    const long long row = blockIdx.x;
    const int* d = dist + row * n_cap;
    const int* p = prev + row * n_cap;
    int* out = packed + row * (1 + 2 * (long long)k_cap);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    int running = 0;
    for (int start = 0; start < n_cap; start += blockDim.x) {
        const int u = start + threadIdx.x;
        int v = 0;
        bool f = false;
        if (u < n_cap) {
            v = d[u];
            f = v != p[u];
        }
        unsigned m = __ballot_sync(0xffffffffu, f);
        if (lane == 0) warp_off[warp] = __popc(m);
        __syncthreads();
        if (threadIdx.x == 0) {
            int acc = 0;
            for (int w = 0; w < nwarps; ++w) {
                int c = warp_off[w];
                warp_off[w] = acc;
                acc += c;
            }
            chunk_total = acc;
        }
        __syncthreads();
        if (f) {
            int rank = running + warp_off[warp] +
                       __popc(m & ((1u << lane) - 1u));
            if (rank < k_cap) {
                out[1 + rank] = u;
                out[1 + k_cap + rank] = v;
            }
        }
        running += chunk_total;
        __syncthreads();  // warp_off / chunk_total are rewritten next chunk
    }
    const int pad_val = d[n_cap - 1];
    for (int j = min(running, k_cap) + threadIdx.x; j < k_cap;
         j += blockDim.x) {
        out[1 + j] = n_cap;
        out[1 + k_cap + j] = pad_val;
    }
    if (threadIdx.x == 0) out[0] = running;
}

extern "C" {

int overlay_planes(const int* shift_w, const int* res_w, int* sw, int* rw,
                   long long n_s, long long n_r, const int* s_idx,
                   const int* s_val, int es, const int* r_idx,
                   const int* r_val, int er, int b, cudaStream_t stream) {
    long long span = (long long)THREADS * ITEMS;
    long long blocks = (n_s + n_r + span - 1) / span;
    overlay_planes_kernel<<<dim3((unsigned)(blocks > 0 ? blocks : 1),
                                 (unsigned)b),
                            THREADS, 0, stream>>>(
        shift_w, res_w, sw, rw, n_s, n_r, s_idx, s_val, es, r_idx, r_val,
        er);
    return (int)cudaGetLastError();
}

int masked_delta(const int* dist, const int* prev, int* packed, int n_cap,
                 int k_cap, int b, cudaStream_t stream) {
    masked_delta_kernel<<<b, DELTA_THREADS, 0, stream>>>(dist, prev, packed,
                                                         n_cap, k_cap);
    return (int)cudaGetLastError();
}

}  // extern "C"
