// The multichip tier's combine for Hopper (sm_90a): the members of each
// ('batch', 'graph') mesh group that lie on the same card, each holding
// its own copy of a plane, end up holding the elementwise min, max or
// sum of all the copies. ops/combine.py drives it; the entry point
// launches exactly one kernel on the caller's stream for every group of
// the call and returns cudaGetLastError().
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
// One launch takes up to MAX_GROUPS groups of g members each (a mesh's
// groups all have `graph` members), and optionally a second set of as
// many groups of another width and op (`also`): the whole-fabric step
// combines its planes by min and its per-root change stamps by max in
// one launch a relaxation. The member pointers travel by value in the
// launch's parameter block (read from the constant bank), so no table
// is uploaded; the host passes them in one array with the refs and
// flags (ops/cuda.py packs a sequence of the same live tensors once). With a reference plane `ref` a group's kernel also ORs 1
// into its `flag` when the combined value differs from `ref` anywhere:
// the relaxation loops read one change flag per group from it (ref =
// the plane the step read; a relaxation only ever lowers words, so
// "differs" is "decreased").
//
// Bound: bytes. Each word of the g planes is read once and written once
// (2 g x 4 bytes a word, plus 4 for `ref`), one min, max or add a
// plane (a sum wraps modulo 2^32, as psum's int32 add). Design: the
// grid's y dimension is the group (the second set's groups after the
// first's), x the words; a thread takes 4 neighbouring words with one
// 16-byte load and store a member where every pointer of its set is
// 16-byte aligned (the host checks), the last n mod 4 words one each;
// index math in 32 bits when the widths are below 2^31. A block's change
// is voted with __syncthreads_or before one atomicOr into its group's
// flag.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_MEMBERS 16
#define MAX_GROUPS 8

struct Set {
    int* p[MAX_GROUPS * MAX_MEMBERS];  // group q's member j at q * g + j
    const int* ref[MAX_GROUPS];        // or null
    int* flag[MAX_GROUPS];             // or null
    long long n;                       // words a plane
    int op;                            // 0 min, 1 max, 2 sum
    int vec;                           // 16-byte loads and stores
};

__device__ __forceinline__ int fold(int op, int v, int x) {
    return op == 0 ? min(v, x)
                   : op == 1 ? max(v, x) : (int)((unsigned)v + (unsigned)x);
}

__device__ __forceinline__ int4 fold4(int op, int4 v, int4 x) {
    return make_int4(fold(op, v.x, x.x), fold(op, v.y, x.y),
                     fold(op, v.z, x.z), fold(op, v.w, x.w));
}

// Members, refs and flags are read from the parameter block with a
// block-uniform index (constant-bank loads); selecting values, not a
// reference to one of the two sets, keeps the sets out of local memory.
template <typename I>
__global__ void __launch_bounds__(THREADS)
    shard_combine_kernel(Set a, Set b, int groups_a, int g) {
    const bool second = (int)blockIdx.y >= groups_a;
    const int q = second ? blockIdx.y - groups_a : blockIdx.y;
    const int base = q * g;
#define MEMBER(j) (second ? b.p[base + (j)] : a.p[base + (j)])
    const int* ref = second ? nullptr : a.ref[q];
    int* flag = second ? nullptr : a.flag[q];
    const int op = second ? b.op : a.op;
    const I n = (I)(second ? b.n : a.n);
    const I n4 = (second ? b.vec : a.vec) ? n / 4 : 0;
    const I u = (I)blockIdx.x * THREADS + threadIdx.x;
    int changed = 0;
    if (u < n4) {
        int4 v = reinterpret_cast<const int4*>(MEMBER(0))[u];
        for (int j = 1; j < g; ++j)
            v = fold4(op, v, reinterpret_cast<const int4*>(MEMBER(j))[u]);
        for (int j = 0; j < g; ++j) reinterpret_cast<int4*>(MEMBER(j))[u] = v;
        if (ref) {
            const int4 r = __ldg(reinterpret_cast<const int4*>(ref) + u);
            changed = (v.x != r.x) | (v.y != r.y) | (v.z != r.z) |
                      (v.w != r.w);
        }
    } else if (u - n4 < n - 4 * n4) {
        const I i = 3 * n4 + u;  // 4 n4 + (u - n4)
        int v = MEMBER(0)[i];
        for (int j = 1; j < g; ++j) v = fold(op, v, MEMBER(j)[i]);
        for (int j = 0; j < g; ++j) MEMBER(j)[i] = v;
        if (ref) changed = v != __ldg(ref + i);
    }
#undef MEMBER
    if (flag) {  // uniform in the block
        if (__syncthreads_or(changed) && threadIdx.x == 0) atomicOr(flag, 1);
    }
}

static inline bool aligned16(const void* p) {
    return ((uintptr_t)p & 15) == 0;
}

// One set's parameters from host arrays; false if it does not fit.
static bool make_set(Set* s, const long long* ptrs, int groups, int g,
                     long long n, int op, const long long* refs,
                     const long long* flags) {
    if (groups < 0 || groups > MAX_GROUPS || op < 0 || op > 2 || n < 0)
        return false;
    bool vec = true;
    for (int k = 0; k < MAX_GROUPS * MAX_MEMBERS; ++k) {
        s->p[k] = k < groups * g ? (int*)(intptr_t)ptrs[k] : nullptr;
        if (k < groups * g) vec = vec && aligned16(s->p[k]);
    }
    for (int q = 0; q < MAX_GROUPS; ++q) {
        s->ref[q] = refs && q < groups ? (const int*)(intptr_t)refs[q]
                                       : nullptr;
        s->flag[q] = flags && q < groups ? (int*)(intptr_t)flags[q] : nullptr;
        if (s->ref[q]) vec = vec && aligned16(s->ref[q]);
    }
    s->n = n;
    s->op = op;
    s->vec = vec ? 1 : 0;
    return true;
}

// the threads a set's plane needs: one a 4-word vector, one a tail word
static inline long long units(const Set& s) {
    return s.vec ? s.n / 4 + s.n % 4 : s.n;
}

extern "C" {

// ptrs: one host array of device pointers: the groups x g member planes,
// group-major (g <= MAX_MEMBERS, groups <= MAX_GROUPS), n words each;
// with with_ref, a ref plane a group and then a flag a group; with
// with_also, groups x g planes more (the second set, n_also words each,
// combined by op_also, no ref or flag). op 0 = min, 1 = max, 2 = sum.
int shard_combine(const long long* ptrs, int groups, int g, long long n,
                  int op, int with_ref, int with_also, long long n_also,
                  int op_also, cudaStream_t stream) {
    if (g < 1 || g > MAX_MEMBERS || groups < 1 || groups > MAX_GROUPS)
        return (int)cudaErrorInvalidValue;
    const long long* refs = with_ref ? ptrs + groups * g : nullptr;
    const long long* flags = with_ref ? refs + groups : nullptr;
    const long long* also =
        with_also ? ptrs + groups * g + (with_ref ? 2 * groups : 0) : nullptr;
    Set a, b;
    if (!make_set(&a, ptrs, groups, g, n, op, refs, flags) ||
        !make_set(&b, also, also ? groups : 0, g, also ? n_also : 0, op_also,
                  nullptr, nullptr))
        return (int)cudaErrorInvalidValue;
    const int ys = groups + (also ? groups : 0);
    const long long most = units(a) > units(b) ? units(a) : units(b);
    const long long blocks = (most + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)(blocks > 0 ? blocks : 1), (unsigned)ys);
    if (a.n < 0x7fffffffLL && b.n < 0x7fffffffLL)
        shard_combine_kernel<int><<<grid, THREADS, 0, stream>>>(a, b, groups,
                                                                 g);
    else
        shard_combine_kernel<long long><<<grid, THREADS, 0, stream>>>(
            a, b, groups, g);
    return (int)cudaGetLastError();
}

}  // extern "C"
