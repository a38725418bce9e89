// UCMP weight propagation for Hopper (sm_90a): the fixpoint that turns
// a prefix's announcers ("leaves", equidistant from the root) into
// per-node weights over the shortest-path DAG of the root's distance
// field (ops/ucmp.py drives it; ops/ksp2.py::base_sssp makes the field).
// Each entry point launches one kernel on the caller's stream and
// returns cudaGetLastError().
//
// Replaces ops/ucmp.py::_ucmp_fn of the JAX package, a while_loop of
// segment_sum / segment_max rounds:
//   ucmp_init  the DAG mask once per call — w_eff < INF_E, both endpoint
//              distances finite and du + w_eff == dv (the distance field
//              is fixed during the fixpoint) — and the round-0 state
//              (reach = leaf, w = leaf weight, wf its float);
//   ucmp_step  one round, Jacobi: for every node v that is not a leaf,
//              over its DAG out-edges e = (v -> s) whose head s is
//              reached, acc = sum of w[s] (prefix mode) or of adj_w[e]
//              (adjacency mode), reach = any such edge; a leaf keeps its
//              weight. It ORs flag[0] when a node's reach or weight
//              changed and flag[1] when a node's float shadow passed
//              2^30 (the JAX overflow test on the round's output).
//
// Determinism: the step pulls each node's out-edges through a by-source
// CSR (edge ids ascending within a node, built on the host beside the
// edge arrays), one thread a node. The int32 sum wraps the same in any
// order (unsigned arithmetic here); the float32 shadow is summed from
// 0.0f in ascending edge order, the order of XLA's serial scatter-add,
// so the overflow flag is the same as the reference's, not only close.
//
// Bound: bytes — a round reads the CSR, the DAG mask and the previous
// state once and writes the new state; two integer ops per edge.

#include <cuda_runtime.h>
#include <stdint.h>

#define INF_E (1 << 29)
#define THREADS 256
#define OVER_F 1073741824.0f  // 2^30

__global__ void ucmp_init_kernel(
    const int* __restrict__ src, const int* __restrict__ dst,
    const int* __restrict__ w_eff, const int* __restrict__ dist,
    uint8_t* __restrict__ dag, const uint8_t* __restrict__ leaf,
    const int* __restrict__ leaf_w, uint8_t* __restrict__ reach,
    int* __restrict__ w, float* __restrict__ wf, int e_cap, int n_cap) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < e_cap) {
        int we = w_eff[i];
        int du = dist[src[i]], dv = dist[dst[i]];
        dag[i] = we < INF_E && du < INF_E && dv < INF_E && du + we == dv;
        return;
    }
    i -= e_cap;
    if (i < n_cap) {
        int v = leaf[i] ? leaf_w[i] : 0;
        reach[i] = leaf[i] != 0;
        w[i] = v;
        wf[i] = (float)v;
    }
}

__global__ void ucmp_step_kernel(
    const int* __restrict__ row_ptr, const int* __restrict__ order,
    const int* __restrict__ dst, const int* __restrict__ adj_w,
    const uint8_t* __restrict__ dag, const uint8_t* __restrict__ leaf,
    const int* __restrict__ leaf_w, const uint8_t* __restrict__ reach,
    const int* __restrict__ w, const float* __restrict__ wf,
    uint8_t* __restrict__ reach2, int* __restrict__ w2,
    float* __restrict__ wf2, int n_cap, int prefix,
    int* __restrict__ flag) {
    int v = blockIdx.x * blockDim.x + threadIdx.x;
    int changed = 0, over = 0;
    if (v < n_cap) {
        uint8_t nr;
        int nw;
        float nf;
        if (leaf[v]) {
            nr = 1;
            nw = leaf_w[v];
            nf = (float)nw;
        } else {
            unsigned acc = 0u;
            float accf = 0.0f;
            bool hit = false;
            for (int j = row_ptr[v], end = row_ptr[v + 1]; j < end; ++j) {
                int e = order[j];
                int s = dst[e];
                if (!dag[e] || !reach[s]) continue;
                hit = true;
                if (prefix) {
                    acc += (unsigned)w[s];
                    accf += wf[s];
                } else {
                    acc += (unsigned)adj_w[e];
                    accf += (float)adj_w[e];
                }
            }
            nr = hit;
            nw = (int)acc;
            nf = accf;
        }
        changed = nr != reach[v] || nw != w[v];
        over = nf > OVER_F;
        reach2[v] = nr;
        w2[v] = nw;
        wf2[v] = nf;
    }
    int any_changed = __syncthreads_or(changed);
    int any_over = __syncthreads_or(over);
    if (threadIdx.x == 0) {
        if (any_changed) atomicOr(flag, 1);
        if (any_over) atomicOr(flag + 1, 1);
    }
}

extern "C" {

int ucmp_init(const int* src, const int* dst, const int* w_eff,
              const int* dist, uint8_t* dag, const uint8_t* leaf,
              const int* leaf_w, uint8_t* reach, int* w, float* wf,
              int e_cap, int n_cap, cudaStream_t stream) {
    long long n = (long long)e_cap + n_cap;
    int blocks = (int)((n + THREADS - 1) / THREADS);
    ucmp_init_kernel<<<blocks, THREADS, 0, stream>>>(
        src, dst, w_eff, dist, dag, leaf, leaf_w, reach, w, wf, e_cap, n_cap);
    return (int)cudaGetLastError();
}

int ucmp_step(const int* row_ptr, const int* order, const int* dst,
              const int* adj_w, const uint8_t* dag, const uint8_t* leaf,
              const int* leaf_w, const uint8_t* reach, const int* w,
              const float* wf, uint8_t* reach2, int* w2, float* wf2,
              int n_cap, int prefix, int* flag, cudaStream_t stream) {
    int blocks = (n_cap + THREADS - 1) / THREADS;
    ucmp_step_kernel<<<blocks, THREADS, 0, stream>>>(
        row_ptr, order, dst, adj_w, dag, leaf, leaf_w, reach, w, wf, reach2,
        w2, wf2, n_cap, prefix, flag);
    return (int)cudaGetLastError();
}

}  // extern "C"
