// What-if sweep verdicts for Hopper (sm_90a) (ops/sweep.py). The entry
// point launches exactly one kernel on the caller's stream and returns
// cudaGetLastError().
//
// Replaces the jitted XLA device code of the JAX package:
//   K12  ops/sweep.py::_make_sweep's verdict reductions (:113-122): per
//        lane, against lane 0 (the identity overlay, the baseline):
//          valid       = base < INF_E
//          unreachable = sum(valid & dist >= INF_E)
//          stretch     = max(where(valid & dist < INF_E, dist - base, 0))
//          changed     = sum(valid & dist != base)
// over the lane's [r, n_cap] distance plane. Lane 0 is judged against
// itself (0, 0, 0), as in the reference.
//
// Bound: bytes — every lane's plane is read once, and lane 0's plane
// once more per lane (from L2: it is r * n_cap * 4 bytes). Design: one
// block per lane, each thread strides over the plane, then one
// shared-memory tree reduction of the three partials. The sums are
// int32, as the reference's bool sums; the max starts from INT_MIN and
// takes every word's where() value, so a lane whose reachable words all
// shortened reports the same negative maximum the reference does.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define INF_E (1 << 29)
#define THREADS 256

__global__ void sweep_verdicts_kernel(const int* __restrict__ dist,
                                      int* __restrict__ unreachable,
                                      int* __restrict__ stretch,
                                      int* __restrict__ changed,
                                      long long plane) {
    __shared__ int s_u[THREADS];
    __shared__ int s_s[THREADS];
    __shared__ int s_c[THREADS];
    const long long lane = blockIdx.x;
    const int* d = dist + lane * plane;
    int u = 0, s = INT_MIN, c = 0;
    for (long long i = threadIdx.x; i < plane; i += THREADS) {
        const int b = dist[i];
        const int v = d[i];
        const bool valid = b < INF_E;
        u += valid && v >= INF_E;
        s = max(s, (valid && v < INF_E) ? v - b : 0);
        c += valid && v != b;
    }
    s_u[threadIdx.x] = u;
    s_s[threadIdx.x] = s;
    s_c[threadIdx.x] = c;
    __syncthreads();
    for (int k = THREADS / 2; k > 0; k >>= 1) {
        if (threadIdx.x < k) {
            s_u[threadIdx.x] += s_u[threadIdx.x + k];
            s_s[threadIdx.x] = max(s_s[threadIdx.x], s_s[threadIdx.x + k]);
            s_c[threadIdx.x] += s_c[threadIdx.x + k];
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        unreachable[lane] = s_u[0];
        stretch[lane] = s_s[0];
        changed[lane] = s_c[0];
    }
}

extern "C" {

int sweep_verdicts(const int* dist, int* unreachable, int* stretch,
                   int* changed, long long plane, int b,
                   cudaStream_t stream) {
    sweep_verdicts_kernel<<<b, THREADS, 0, stream>>>(dist, unreachable,
                                                     stretch, changed,
                                                     plane);
    return (int)cudaGetLastError();
}

}  // extern "C"
