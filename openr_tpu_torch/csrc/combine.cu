// The multichip tier's combine for Hopper (sm_90a): the members of one
// ('batch', 'graph') mesh group that lie on the same card, each holding
// its own copy of a plane, end up holding the elementwise min, max or
// sum of all the copies. ops/combine.py drives it; the entry point launches
// exactly one kernel on the caller's stream and returns
// cudaGetLastError().
//
// Replaces the collectives of the JAX package's multichip tier:
//   K23  jax.lax.pmin over 'graph' (parallel/sharding.py: the sync
//        relaxation's combine, :414-421 via ops/relax.py::make_relax
//        (combine=); the bucketed epoch's plane_combine, :402-413 via
//        ops/relax.py::run_bucketed; the dirty slots' new weights,
//        :575-586; _sharded_fabric_fn's relaxation, :125-147),
//        jax.lax.pmax over 'graph' (the parent plane, :527-551) and
//        jax.lax.psum over 'batch' (the incremental solve's cone count,
//        :654)
// Members on distinct cards combine through NCCL instead
// (ops/combine.py).
//
// With a reference plane `ref`, the kernel also ORs 1 into `flag` when
// the combined value differs from `ref` anywhere: the relaxation loops
// read one change flag per group from it (ref = the plane the step read;
// a relaxation only ever lowers words, so "differs" is "decreased").
//
// Bound: bytes. Each word of the g planes is read once and written once
// (2 g x 4 bytes a word, plus 4 for `ref`), one min, max or add a
// plane (a sum wraps modulo 2^32, as psum's int32 add). One
// thread a word, neighbouring threads on neighbouring words; the member
// pointers travel by value in the launch's parameter block, so no
// pointer table is uploaded. The flag is reduced per block with
// __syncthreads_or before one atomicOr.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_MEMBERS 16

struct Members {
    int* p[MAX_MEMBERS];
};

__global__ void shard_combine_kernel(Members m, int g, long long n, int op,
                                     const int* __restrict__ ref,
                                     int* __restrict__ flag) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    int changed = 0;
    if (i < n) {
        int v = m.p[0][i];
        for (int j = 1; j < g; ++j) {
            int x = m.p[j][i];
            v = op == 0 ? min(v, x) : op == 1 ? max(v, x)
                        : (int)((unsigned)v + (unsigned)x);
        }
        for (int j = 0; j < g; ++j) m.p[j][i] = v;
        if (ref) changed = v != ref[i];
    }
    if (flag) {
        int any = __syncthreads_or(changed);
        if (any && threadIdx.x == 0) atomicOr(flag, 1);
    }
}

extern "C" {

// ptrs: a host array of g device pointers (g <= MAX_MEMBERS); op 0 = min,
// 1 = max, 2 = sum; ref and flag may be null.
int shard_combine(const long long* ptrs, int g, long long n, int op,
                  const int* ref, int* flag, cudaStream_t stream) {
    if (g < 1 || g > MAX_MEMBERS || op < 0 || op > 2)
        return (int)cudaErrorInvalidValue;
    Members m;
    for (int j = 0; j < MAX_MEMBERS; ++j)
        m.p[j] = j < g ? (int*)(intptr_t)ptrs[j] : nullptr;
    long long blocks = (n + THREADS - 1) / THREADS;
    shard_combine_kernel<<<(unsigned)(blocks > 0 ? blocks : 1), THREADS, 0,
                           stream>>>(m, g, n, op, ref, flag);
    return (int)cudaGetLastError();
}

}  // extern "C"
