// Differentiable traffic engineering for Hopper (sm_90a) (ops/te.py). Each
// entry point launches exactly one kernel on the caller's stream and
// returns cudaGetLastError().
//
// Replaces the jitted XLA device code of the JAX package's
// ops/sweep.py::_make_te (:165, run by te_step :240): a fixed-length
// float32 softmin relaxation per demand source over the shift classes and
// the residual ELL, with theta scattered onto the theta slots (_BIG_F
// elsewhere), then cost, util = d cost / d theta, the soft max-util loss
// and its gradient (a Hessian-vector product along v = softmax(util /
// tau_u)). ops/te.py's docstring states the arithmetic and JAX's tie
// rules, which every kernel here keeps:
//
//   K13  te_relax          forward trips; fields[t + 1] from fields[t]
//   K15  te_relax_jvp      the same trips' tangent along v
//   K14  te_relax_vjp      the adjoint sweep from trip T back to 0: the
//                          cotangent of every theta slot, per source
//   K16  te_relax_vjp_jvp  the adjoint sweep and its tangent along v: the
//                          second-order slot cotangents, per source
//   K14s te_link_sum       slot cotangents -> links, over the sources
//   K17  te_loss           cost, loss and v (one block)
//
// Bound: operations — every (trip, source, node) evaluates exp and log1p
// per shift class and exp per residual column, on the float32 pipes and
// the special-function units, and reads only the previous trip's field
// (L2-resident: a source's field is 4 * n_cap bytes). Design: one block
// per source loops over all the trips (a trip needs the whole previous
// field of its own source, nothing of another source), __syncthreads()
// between trips, so a step is one launch per kernel whatever the trip
// count. A thread owns nodes i = tid, tid + blockDim, ...; its node's
// class chain is recomputed from the kept field where the adjoint and
// the tangents need it (the same __device__ code as the forward, with
// explicitly rounded adds, multiplies and divides, so a recomputed acc is
// bit-identical to the one K13 compared with d and the tie decisions
// agree). The adjoint pushes nothing across threads: in a first phase
// each node writes the cotangents it sends — to the input word of each
// class it read (a unique word per class) and to each live residual
// entry — and in a second phase each node sums what it receives, in a
// fixed order (own, classes in order, its residual entries by CSR). Slot
// cotangents accumulate in per-source rows, each slot written by the one
// thread that owns its word; K14s sums them in a fixed order. No float
// atomics: two runs give the same bits.
//
// The residual pad rows are skipped and, in the adjoint, the pad columns
// (see ops/te.py: exact for tau <= MAX_TAU, which the wrapper checks).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BIG_F 1.0e9f
#define THREADS 1024
#define LOSS_THREADS 1024
#define MAX_C 64

struct Plan {
    const int* deltas;     // [C]
    int C;
    const int* sh_slot;    // [C * N]: theta shift slot at each word, or -1
    const int* sh_lnk;     // [C * N]: its link, or -1
    const int* row_of;     // [N]: residual row of a node, or -1
    const int* res_nbr;    // [R * K], -1 pad
    const int* rs_slot;    // [R * K]: theta residual slot, or -1
    const int* rs_lnk;     // [R * K]: its link, or -1
    const int* row_start;  // [R]: first live entry of a row
    const int* inv_ptr;    // [N + 1]: live entries by source node
    const int* inv_ent;    // [n_live]
    int K;
    const int* srcs;       // [S]
    const int* dem_row;    // [D]
    const int* dem_dst;
    const float* dem_vol;
    int D, S, N, has_res, n_sh, n_rs, n_live;
};

// -- shared arithmetic ---------------------------------------------------------

// jnp.logaddexp's primal: amax + log1p(exp(-|x1 - x2|))
__device__ __forceinline__ float lae(float x1, float x2) {
    const float delta = __fsub_rn(x1, x2);
    if (isnan(delta)) return __fadd_rn(x1, x2);
    return __fadd_rn(fmaxf(x1, x2), log1pf(expf(-fabsf(delta))));
}

// -a / tau, as the reference writes it
__device__ __forceinline__ float nd(float a, float tau) {
    return __fdiv_rn(-a, tau);
}

__device__ __forceinline__ int wrap(int i, int n) {
    int j = i % n;
    return j < 0 ? j + n : j;
}

__device__ __forceinline__ int clip(int i, int n) {
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// a plane word's weight (and tangent) from its link: _BIG_F (0) off
// the theta slots
__device__ __forceinline__ float link_w(int link, const float* th,
                                        float off) {
    return link >= 0 ? th[link] : off;
}

// One residual row's candidate: -tau * logsumexp(-(d[nbr] + rw) / tau)
// over all K columns. The live columns lead the row; the pad columns all
// read node 0 and _BIG_F, as the reference's clip reads them, so they
// are one value counted K - fill times (0 in the sum unless every live
// column is as far as _BIG_F). With TAN also the softmax's tangent mean
// ybar = sum(e * y_t) / s; the candidate's tangent is -tau * ybar.
template <bool TAN>
struct Cand {
    float m, s, cand, st;
};

template <bool TAN>
__device__ __forceinline__ Cand<TAN> row_cand(const Plan& P, int r,
                                              const float* th,
                                              const float* v,
                                              const float* d,
                                              const float* dd, float tau) {
    const int* nb = P.res_nbr + (long long)r * P.K;
    const int* ln = P.rs_lnk + (long long)r * P.K;
    float m = -INFINITY;
    int fill = 0;
    for (; fill < P.K && nb[fill] >= 0; ++fill) {
        const float z = __fadd_rn(d[nb[fill]], link_w(ln[fill], th, BIG_F));
        m = fmaxf(m, nd(z, tau));
    }
    const float pads = (float)(P.K - fill);
    const float y_pad = nd(__fadd_rn(d[0], BIG_F), tau);
    if (pads > 0.0f) m = fmaxf(m, y_pad);
    if (!isfinite(m)) m = 0.0f;
    float s = 0.0f, st = 0.0f;
    for (int c = 0; c < fill; ++c) {
        const int j = nb[c];
        const float z = __fadd_rn(d[j], link_w(ln[c], th, BIG_F));
        const float e = expf(__fsub_rn(nd(z, tau), m));
        s = __fadd_rn(s, e);
        if (TAN) st += e * (-(dd[j] + link_w(ln[c], v, 0.0f)) / tau);
    }
    if (pads > 0.0f) {
        const float e = expf(__fsub_rn(y_pad, m));
        s = __fadd_rn(s, __fmul_rn(pads, e));
        if (TAN) st += pads * e * (-dd[0] / tau);
    }
    Cand<TAN> out;
    out.m = m;
    out.s = s;
    out.cand = __fmul_rn(-tau, __fadd_rn(logf(s), m));
    out.st = st / s;
    return out;
}

// The tie rules: the share of the gradient of z = min(x, y) that x takes
// (lax._balanced_eq); with one real row per node the scatter-min's rule
// (_scatter_extremal_jvp) is the same.
__device__ __forceinline__ float share(float x, float z, float y) {
    return x == z ? (y == z ? 0.5f : 1.0f) : 0.0f;
}

// -- K13 / K15: forward trips ---------------------------------------------------

// node i's next value from field d (and with TAN its tangent from dd)
template <bool TAN>
__device__ float node_fwd(const Plan& P, const float* th, const float* v,
                          const float* d, const float* dd, int i, float tau,
                          float* out_t) {
    const int N = P.N;
    const float dv = d[i];
    float acc = dv, acc_t = TAN ? dd[i] : 0.0f;
    for (int k = 0; k < P.C; ++k) {
        const int j = wrap(i - P.deltas[k], N);
        const long long word = (long long)k * N + j;
        const int lk = P.sh_lnk[word];
        const float x = __fadd_rn(d[j], link_w(lk, th, BIG_F));
        const float p = nd(acc, tau), q = nd(x, tau);
        const float L = lae(p, q);
        if (TAN) {
            const float xt = dd[j] + link_w(lk, v, 0.0f);
            const float Lt = (-acc_t / tau) * expf(p - L)
                             + (-xt / tau) * expf(q - L);
            acc_t = -tau * Lt;
        }
        acc = __fmul_rn(-tau, L);
    }
    float acc2 = acc, acc2_t = acc_t;
    const int r = P.has_res ? P.row_of[i] : -1;
    if (r >= 0) {
        const Cand<TAN> c = row_cand<TAN>(P, r, th, v, d, dd, tau);
        acc2 = fminf(acc, c.cand);
        if (TAN)
            acc2_t = share(acc, acc2, c.cand) * acc_t
                     + share(c.cand, acc2, acc) * (-tau * c.st);
    }
    const float out = fminf(acc2, dv);
    if (TAN)
        *out_t = share(acc2, out, dv) * acc2_t + share(dv, out, acc2) * dd[i];
    return out;
}

template <bool TAN>
__global__ void __launch_bounds__(THREADS)
te_forward_kernel(Plan P, const float* th, const float* v, float* fields,
                  float* tfields, float tau, int T, int seed) {
    const int s = blockIdx.x, N = P.N;
    const long long plane = (long long)P.S * N;
    if (seed) {
        const int src = clip(P.srcs[s], N);
        for (int i = threadIdx.x; i < N; i += THREADS) {
            if (TAN)
                tfields[(long long)s * N + i] = 0.0f;
            else
                fields[(long long)s * N + i] = i == src ? 0.0f : BIG_F;
        }
        __syncthreads();
    }
    for (int t = 0; t < T; ++t) {
        const float* d = fields + t * plane + (long long)s * N;
        const float* dd = TAN ? tfields + t * plane + (long long)s * N
                              : nullptr;
        for (int i = threadIdx.x; i < N; i += THREADS) {
            float ot;
            const float o = node_fwd<TAN>(P, th, v, d, dd, i, tau, &ot);
            if (TAN)
                tfields[(t + 1) * plane + (long long)s * N + i] = ot;
            else
                fields[(t + 1) * plane + (long long)s * N + i] = o;
        }
        __syncthreads();
    }
}

// -- K14 / K16: the adjoint sweep ----------------------------------------------

struct Adj {
    float* lam;    // [N] in: cotangent of the trip's output; out: of input
    float* lam_t;  // its tangent (TAN)
    float* gx;     // [C * N] class cotangents sent, at the word read
    float* gx_t;
    float* rc;     // [n_live] residual entries' cotangents sent
    float* rc_t;
    float* ct_sh;  // [n_sh] slot cotangents (first or second order)
    float* ct_rs;  // [n_rs]
};

// Phase 1 for node i: recompute its chain from d (and dd), take lam[i]
// (and lam_t[i]) back through min, scatter-min, residual softmax and the
// classes in reverse, write what it sends to gx / rc, accumulate the
// theta slots' cotangents, and leave its own share in lam[i].
template <bool TAN>
__device__ void node_adj(const Plan& P, const float* th, const float* v,
                         const float* d, const float* dd, const Adj& A,
                         int i, float tau) {
    const int N = P.N;
    float al[MAX_C], be[MAX_C], alt[MAX_C], bet[MAX_C];
    const float dv = d[i];
    float acc = dv, acc_t = TAN ? dd[i] : 0.0f;
    for (int k = 0; k < P.C; ++k) {
        const int j = wrap(i - P.deltas[k], N);
        const long long word = (long long)k * N + j;
        const int lk = P.sh_lnk[word];
        const float x = __fadd_rn(d[j], link_w(lk, th, BIG_F));
        const float p = nd(acc, tau), q = nd(x, tau);
        const float L = lae(p, q);
        al[k] = expf(p - L);
        be[k] = expf(q - L);
        if (TAN) {
            const float xt = dd[j] + link_w(lk, v, 0.0f);
            const float pt = -acc_t / tau, qt = -xt / tau;
            const float Lt = pt * al[k] + qt * be[k];
            alt[k] = al[k] * (pt - Lt);
            bet[k] = be[k] * (qt - Lt);
            acc_t = -tau * Lt;
        }
        acc = __fmul_rn(-tau, L);
    }
    const int r = P.has_res ? P.row_of[i] : -1;
    Cand<TAN> c = {0.0f, 1.0f, 0.0f, 0.0f};
    float acc2 = acc;
    if (r >= 0) {
        c = row_cand<TAN>(P, r, th, v, d, dd, tau);
        acc2 = fminf(acc, c.cand);
    }
    const float out = fminf(acc2, dv);
    const float c_acc = share(acc2, out, dv), c_d = share(dv, out, acc2);
    const float lam = A.lam[i];
    const float lam_t = TAN ? A.lam_t[i] : 0.0f;
    float g = lam * c_acc, g_t = lam_t * c_acc;
    const float g_dv = lam * c_d, g_dv_t = lam_t * c_d;
    if (r >= 0) {
        const float c_op = share(acc, acc2, c.cand);
        const float c_up = share(c.cand, acc2, acc);
        const float g_c = g * c_up, g_c_t = g_t * c_up;
        g *= c_op;
        g_t *= c_op;
        const int* nb = P.res_nbr + (long long)r * P.K;
        const long long base = (long long)r * P.K;
        const float sg = g_c / c.s;
        for (int col = 0; col < P.K && nb[col] >= 0; ++col) {
            const int j = nb[col];
            const int lk = P.rs_lnk[base + col];
            const float z = __fadd_rn(d[j], link_w(lk, th, BIG_F));
            const float e = expf(__fsub_rn(nd(z, tau), c.m));
            const float gz = sg * e;
            const int ent = P.row_start[r] + col;
            const int slot = P.rs_slot[base + col];
            A.rc[ent] = gz;
            if (TAN) {
                const float zt = dd[j] + link_w(lk, v, 0.0f);
                const float pc = e / c.s;
                const float gz_t = g_c_t * pc
                                   + g_c * (pc * ((-zt / tau) - c.st));
                A.rc_t[ent] = gz_t;
                if (slot >= 0) A.ct_rs[slot] += gz_t;
            } else if (slot >= 0) {
                A.ct_rs[slot] += gz;
            }
        }
    }
    for (int k = P.C - 1; k >= 0; --k) {
        const int j = wrap(i - P.deltas[k], N);
        const long long word = (long long)k * N + j;
        const float gx = g * be[k];
        const int slot = P.sh_slot[word];
        A.gx[word] = gx;
        if (TAN) {
            const float gx_t = g_t * be[k] + g * bet[k];
            g_t = g_t * al[k] + g * alt[k];
            A.gx_t[word] = gx_t;
            if (slot >= 0) A.ct_sh[slot] += gx_t;
        } else if (slot >= 0) {
            A.ct_sh[slot] += gx;
        }
        g *= al[k];
    }
    A.lam[i] = g + g_dv;
    if (TAN) A.lam_t[i] = g_t + g_dv_t;
}

// Phase 2 for node j: what it received, in a fixed order.
template <bool TAN>
__device__ void node_gather(const Plan& P, const Adj& A, int j) {
    float s = A.lam[j], st = TAN ? A.lam_t[j] : 0.0f;
    for (int k = 0; k < P.C; ++k) {
        s += A.gx[(long long)k * P.N + j];
        if (TAN) st += A.gx_t[(long long)k * P.N + j];
    }
    if (P.has_res) {
        for (int e = P.inv_ptr[j]; e < P.inv_ptr[j + 1]; ++e) {
            const int ent = P.inv_ent[e];
            s += A.rc[ent];
            if (TAN) st += A.rc_t[ent];
        }
    }
    A.lam[j] = s;
    if (TAN) A.lam_t[j] = st;
}

template <bool TAN>
__global__ void __launch_bounds__(THREADS)
te_adjoint_kernel(Plan P, const float* th, const float* v,
                  const float* fields, const float* tfields, Adj A,
                  float tau, int T, int seed) {
    const int s = blockIdx.x, N = P.N;
    const long long plane = (long long)P.S * N;
    Adj B = A;  // this source's rows
    B.lam += (long long)s * N;
    B.gx += (long long)s * P.C * N;
    B.rc += (long long)s * (P.n_live > 0 ? P.n_live : 1);
    B.ct_sh += (long long)s * P.n_sh;
    B.ct_rs += (long long)s * P.n_rs;
    if (TAN) {
        B.lam_t += (long long)s * N;
        B.gx_t += (long long)s * P.C * N;
        B.rc_t += (long long)s * (P.n_live > 0 ? P.n_live : 1);
    }
    if (seed) {
        for (int i = threadIdx.x; i < N; i += THREADS) {
            B.lam[i] = 0.0f;
            if (TAN) B.lam_t[i] = 0.0f;
        }
        for (int e = threadIdx.x; e < P.n_sh; e += THREADS) B.ct_sh[e] = 0.0f;
        for (int e = threadIdx.x; e < P.n_rs; e += THREADS) B.ct_rs[e] = 0.0f;
        __syncthreads();
        // the cost's cotangent: vol at each of this source's demands, in
        // demand order (duplicates add, as the reference's scatter-add)
        if (threadIdx.x == 0)
            for (int q = 0; q < P.D; ++q)
                if (P.dem_row[q] == s) B.lam[P.dem_dst[q]] += P.dem_vol[q];
        __syncthreads();
    }
    for (int t = T - 1; t >= 0; --t) {
        const float* d = fields + t * plane + (long long)s * N;
        const float* dd = TAN ? tfields + t * plane + (long long)s * N
                              : nullptr;
        for (int i = threadIdx.x; i < N; i += THREADS)
            node_adj<TAN>(P, th, v, d, dd, B, i, tau);
        __syncthreads();
        for (int j = threadIdx.x; j < N; j += THREADS)
            node_gather<TAN>(P, B, j);
        __syncthreads();
    }
}

// -- K14s: slot cotangents -> links ---------------------------------------------

__global__ void te_link_sum_kernel(const float* __restrict__ ct_sh,
                                   const float* __restrict__ ct_rs,
                                   const int* __restrict__ link_ptr,
                                   const int* __restrict__ link_slot,
                                   float* __restrict__ out, int n_sh,
                                   int n_rs, int S, int L) {
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    float acc = 0.0f;
    for (int p = link_ptr[l]; p < link_ptr[l + 1]; ++p) {
        const int e = link_slot[p];
        for (int s = 0; s < S; ++s)
            acc += e < n_sh ? ct_sh[(long long)s * n_sh + e]
                            : ct_rs[(long long)s * n_rs + (e - n_sh)];
    }
    out[l] = acc;
}

// -- K17: cost, loss, v --------------------------------------------------------

__device__ float block_sum(float x, float* red) {
    red[threadIdx.x] = x;
    __syncthreads();
    for (int k = LOSS_THREADS / 2; k > 0; k >>= 1) {
        if (threadIdx.x < k) red[threadIdx.x] += red[threadIdx.x + k];
        __syncthreads();
    }
    const float out = red[0];
    __syncthreads();
    return out;
}

__device__ float block_max(float x, float* red) {
    red[threadIdx.x] = x;
    __syncthreads();
    for (int k = LOSS_THREADS / 2; k > 0; k >>= 1) {
        if (threadIdx.x < k)
            red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + k]);
        __syncthreads();
    }
    const float out = red[0];
    __syncthreads();
    return out;
}

__global__ void __launch_bounds__(LOSS_THREADS)
te_loss_kernel(const float* __restrict__ util, int L,
               const float* __restrict__ last,
               const int* __restrict__ dem_row,
               const int* __restrict__ dem_dst,
               const float* __restrict__ dem_vol, int D, int N, float tau_u,
               float* __restrict__ out, float* __restrict__ v) {
    __shared__ float red[LOSS_THREADS];
    float c = 0.0f;
    for (int q = threadIdx.x; q < D; q += LOSS_THREADS)
        c += dem_vol[q] * last[(long long)dem_row[q] * N + dem_dst[q]];
    const float cost = block_sum(c, red);
    float m = -INFINITY;
    for (int l = threadIdx.x; l < L; l += LOSS_THREADS)
        m = fmaxf(m, __fdiv_rn(util[l], tau_u));
    m = block_max(m, red);
    if (!isfinite(m)) m = 0.0f;
    float z = 0.0f;
    for (int l = threadIdx.x; l < L; l += LOSS_THREADS)
        z += expf(__fdiv_rn(util[l], tau_u) - m);
    z = block_sum(z, red);
    for (int l = threadIdx.x; l < L; l += LOSS_THREADS)
        v[l] = expf(__fdiv_rn(util[l], tau_u) - m) / z;
    if (threadIdx.x == 0) {
        out[0] = tau_u * (logf(z) + m);
        out[1] = cost;
    }
}

// -- entry points --------------------------------------------------------------

#define PLAN_PARAMS                                                         \
    const int *deltas, int C, const int *sh_slot, const int *sh_lnk,        \
        const int *row_of, const int *res_nbr, const int *rs_slot,          \
        const int *rs_lnk, const int *row_start, const int *inv_ptr,        \
        const int *inv_ent, int K, const int *srcs, const int *dem_row,     \
        const int *dem_dst, const float *dem_vol, int D, int S, int N,      \
        int has_res, int n_sh, int n_rs, int n_live
#define BUF_PARAMS                                                          \
    const float *theta, const float *v, float *fields, float *tfields,      \
        float *lam, float *lam_t, float *gx, float *gx_t, float *rc,        \
        float *rc_t, float *ct_sh, float *ct_rs, float tau, int T, int seed, \
        cudaStream_t stream

static Plan make_plan(PLAN_PARAMS) {
    Plan P;
    P.deltas = deltas; P.C = C; P.sh_slot = sh_slot; P.sh_lnk = sh_lnk;
    P.row_of = row_of; P.res_nbr = res_nbr; P.rs_slot = rs_slot;
    P.rs_lnk = rs_lnk; P.row_start = row_start; P.inv_ptr = inv_ptr;
    P.inv_ent = inv_ent; P.K = K; P.srcs = srcs; P.dem_row = dem_row;
    P.dem_dst = dem_dst; P.dem_vol = dem_vol; P.D = D; P.S = S; P.N = N;
    P.has_res = has_res; P.n_sh = n_sh; P.n_rs = n_rs; P.n_live = n_live;
    return P;
}

#define MAKE_PLAN                                                         \
    make_plan(deltas, C, sh_slot, sh_lnk, row_of, res_nbr, rs_slot,       \
              rs_lnk, row_start, inv_ptr, inv_ent, K, srcs, dem_row,     \
              dem_dst, dem_vol, D, S, N, has_res, n_sh, n_rs, n_live)

extern "C" {

int te_relax(PLAN_PARAMS, BUF_PARAMS) {
    te_forward_kernel<false><<<S, THREADS, 0, stream>>>(
        MAKE_PLAN, theta, v, fields, tfields, tau, T, seed);
    return (int)cudaGetLastError();
}

int te_relax_jvp(PLAN_PARAMS, BUF_PARAMS) {
    te_forward_kernel<true><<<S, THREADS, 0, stream>>>(
        MAKE_PLAN, theta, v, fields, tfields, tau, T, seed);
    return (int)cudaGetLastError();
}

int te_relax_vjp(PLAN_PARAMS, BUF_PARAMS) {
    const Adj A = {lam, lam_t, gx, gx_t, rc, rc_t, ct_sh, ct_rs};
    te_adjoint_kernel<false><<<S, THREADS, 0, stream>>>(
        MAKE_PLAN, theta, v, fields, tfields, A, tau, T, seed);
    return (int)cudaGetLastError();
}

int te_relax_vjp_jvp(PLAN_PARAMS, BUF_PARAMS) {
    const Adj A = {lam, lam_t, gx, gx_t, rc, rc_t, ct_sh, ct_rs};
    te_adjoint_kernel<true><<<S, THREADS, 0, stream>>>(
        MAKE_PLAN, theta, v, fields, tfields, A, tau, T, seed);
    return (int)cudaGetLastError();
}

int te_link_sum(const float* ct_sh, const float* ct_rs, const int* link_ptr,
                const int* link_slot, float* out, int n_sh, int n_rs, int S,
                int L, cudaStream_t stream) {
    te_link_sum_kernel<<<(L + 255) / 256, 256, 0, stream>>>(
        ct_sh, ct_rs, link_ptr, link_slot, out, n_sh, n_rs, S, L);
    return (int)cudaGetLastError();
}

int te_loss(const float* util, int L, const float* last, const int* dem_row,
            const int* dem_dst, const float* dem_vol, int D, int N,
            float tau_u, float* out, float* v, cudaStream_t stream) {
    te_loss_kernel<<<1, LOSS_THREADS, 0, stream>>>(
        util, L, last, dem_row, dem_dst, dem_vol, D, N, tau_u, out, v);
    return (int)cudaGetLastError();
}

}  // extern "C"
