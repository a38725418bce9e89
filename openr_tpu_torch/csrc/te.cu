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
// (a source's field is 4 * n_cap bytes). The forward kernels (K13, K15):
// one block per source loops over all the trips (a trip needs the whole
// previous field of its own source, nothing of another source),
// __syncthreads() between trips, so a step is one launch per kernel
// whatever the trip count. A thread owns nodes i = tid, tid + blockDim,
// ...; its node's class chain is recomputed from the kept field where
// the adjoint and the tangents need it (the same __device__ code as the
// forward, with explicitly rounded adds, multiplies and divides, so a
// recomputed acc is bit-identical to the one K13 compared with d and the
// tie decisions agree).
//
// The adjoint (K14, K16) spreads each source over a thread-block cluster
// (cudaLaunchKernelEx, cluster dimension cs: ops/te.py's adjoint_layout
// takes the largest cs <= 8 with S * cs blocks on the card's SMs, so 32
// or 64 sources fill the card). The cluster's blocks own consecutive
// spans of the source's nodes and visit them in the layout's order (a
// span's nodes dealt to warps by residual row fill, longest first, so
// every warp walks about as many entries and its 32 rows are of one
// fill: adjoint_order), a warp's rows interleaved so each step of a walk
// reads 32 consecutive words (adjoint_tables). The class and entry
// weights are gathered from theta (and v) once a launch into one table
// for all sources; each trip every block copies the previous field (and
// its tangent) into its shared memory, where the gathers read it; a
// node's chain runs on registers (the classes a template argument up to
// 8, the loops unrolled). It pushes nothing across threads: in a first
// phase each node writes the class words it sends into the receiving
// block's shared memory through distributed shared memory (or a
// per-block row in device memory where it does not fit) and leaves its
// residual row's scalars (m and g_c / s; K16 also s, g_c's tangent and
// the softmax's tangent mean) in its block's shared memory; then
// cluster.sync(), and in a second phase each node sums what it
// received, in a fixed order (own, classes in order, its received
// residual entries by CSR), each entry's cotangent computed from its
// sender's row scalars (through distributed shared memory) and the
// receiver's own d as the sender computed it before, into its cotangent
// kept in shared memory across the trips; cluster.sync() again. Slot
// cotangents accumulate in each source's scratch, one word a slot in the
// layout of its writer (coalesced), read from and written back to the
// slot rows once a launch; K14s sums them in a fixed order. No float
// atomics: two runs give the same bits.
//
// The residual pad rows are skipped and, in the adjoint, the pad columns
// (see ops/te.py: exact for tau <= MAX_TAU, which the wrapper checks).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define BIG_F 1.0e9f
#define THREADS 1024
#define LOSS_THREADS 1024
#define MAX_C 64
// the adjoint: blocks a source at most (its threads a block at most are
// THREADS, CUDA's most)
#define MAX_CLUSTER 8

struct Plan {
    const int* deltas;     // [C]
    int C;
    const int* sh_slot;    // [C * N]: theta shift slot at each word, or -1
    const int* sh_lnk;     // [C * N]: its link, or -1
    const int* row_of;     // [N]: residual row of a node, or -1
    const int* res_nbr;    // [R * K], -1 pad
    const int* rs_lnk;     // [R * K]: its link, or -1
    const int* row_fill;   // [R]: a row's live entries
    const int* inv_ptr;    // [N + 1]: live entries by source node
    int K;
    const int* srcs;       // [S]
    const int* dem_dst;    // [D]
    const float* dem_vol;
    const int* dem_ptr;    // [S + 1]: each source's demands in dem_ids
    const int* dem_ids;    // [D], in demand order
    int S, N, has_res, n_sh, n_rs;
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

// The cluster launch and its tables (ops/te.py adjoint_layout and
// adjoint_tables), shared by every source. A block of rank q owns nodes
// [q * span, (q + 1) * span) (fewer in the last) and visits the node
// order[P] at each of its positions P = q * span + i * threads + tid (its
// i-th pass), dealt to warps by row fill. A warp's 32 positions interleave
// their entries: entry c of position P's row is sender index e0[P] + 32 c
// (its neighbour snbr, link slnk), and the c-th entry its node receives
// (in inv_ptr / inv_ent's order: by receiver, then row-major) is receiver
// index r0[P] + 32 c (its sender's rank << 24 | local index rsrc, link
// rlnk, residual theta slot rslot).
struct Layout {
    const int* order;  // [N] the node at each position
    const int* e0;     // [N]
    const int* r0;     // [N]
    const int* snbr;   // [es]
    const int* slnk;   // [es], -1: no link
    const int* rsrc;   // [er]
    const int* rlnk;   // [er]
    const int* rslot;  // [er], -1: no slot
    int es, er;
    // which buffers shared memory holds: a block's own nodes'
    // cotangents and row scalars, the field, the received class
    // cotangents (each in device memory where it does not fit)
    int cs, span, own_sm, field_sm, gx_sm, smem, threads;
    float* tab;        // the weights (adj_tab), one table for all sources
    float* scr;        // [S][er + C * N] each source's slot cotangents
    float* own;        // [S * cs][own_stride] row scalars, where not
                       //   in shared memory
};

// a block's row scalars in device memory: float4 [span], then st [span],
// rounded to whole float4s
__host__ __device__ __forceinline__ long long own_stride(int span) {
    return (5LL * span + 3) / 4 * 4;
}

// The weights of the class words (by class and position) and of the
// entries (by sender and by receiver index), gathered from theta (and v)
// once a launch. Every cluster writes the same values: relaxed
// device-scope stores and loads, so the copies never race.
struct Tab {
    float *ws, *wvs, *wr, *wvr, *cw, *cwv;
};

__device__ __forceinline__ Tab adj_tab(const Layout& Lo, int C, int N) {
    Tab t;
    t.ws = Lo.tab;
    t.wvs = t.ws + Lo.es;
    t.wr = t.wvs + Lo.es;
    t.wvr = t.wr + Lo.er;
    t.cw = t.wvr + Lo.er;
    t.cwv = t.cw + (long long)C * N;
    return t;
}

// (both volatile: a thread's loads stay after its own stores)
__device__ __forceinline__ void st_tab(float* p, float v) {
    asm volatile("st.relaxed.gpu.global.f32 [%0], %1;" ::"l"(p), "f"(v)
                 : "memory");
}

__device__ __forceinline__ float ld_tab(const float* p) {
    float v;
    asm volatile("ld.relaxed.gpu.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
    return v;
}

struct Adj {
    float* lam;    // [S, N] in: cotangent of fields[T]; out: of fields[0]
    float* lam_t;  // its tangent (TAN)
    float* gx;     // [S * cs, C, span] class cotangents received, where
    float* gx_t;   //   shared memory does not hold them
    float* ct_sh;  // [S, n_sh] slot cotangents (first or second order)
    float* ct_rs;  // [S, n_rs]
};

// What a block's threads work on during a trip.
struct Blk {
    const float* d;    // the trip's field: shared memory, or fields
    const float* dd;   // its tangent (TAN)
    float* lam;        // [span] own nodes' cotangents, in shared memory
    float* lam_t;
    float* const* gx;  // [cs] each rank's received class cotangents
    float* const* gx_t;  //   [C][span]
    // [cs] each rank's rows' scalars [span] (shared memory): (m,
    // g_c / s) (K14) or (m, s, g_c, g_c_t) and st (K16)
    float4* const* row;
    float* const* row_st;
    Tab tb;
    float* ctw;        // [er] this source's entries' slot cotangents
    float* ctc;        // [C][N] its class words' slot cotangents
    int lo, span;
};

// Phase 1 for the node at position P: recompute its chain from d (and
// dd), take its cotangent (and tangent) back through min, scatter-min and
// the classes in reverse, write the class words it sends to their
// receivers' blocks, leave its row's scalars for the nodes it sends
// residual entries to, accumulate its class slots' cotangents, and leave
// its own share in B.lam. The arithmetic and its order are K13's
// (row_cand's over the row's live entries, in order), so the tie
// decisions agree.
template <bool TAN, int CT>
__device__ __forceinline__ void node_adj(const Plan& P, const Layout& Lo,
                                         const Blk& B, int rank, int Pos,
                                         float tau) {
    constexpr int NA = CT > 0 ? CT : MAX_C;
    const int N = P.N, C = CT > 0 ? CT : P.C;
    const int i = Lo.order[Pos];
    const float* d = B.d;
    const float* dd = B.dd;
    float al[NA], be[NA], alt[NA], bet[NA];
    int jw[NA];
    const float dv = d[i];
    float acc = dv, acc_t = TAN ? dd[i] : 0.0f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
        const int j = wrap(i - P.deltas[k], N);
        jw[k] = j;
        const long long word = (long long)k * N + Pos;
        const float x = __fadd_rn(d[j], ld_tab(B.tb.cw + word));
        const float p = nd(acc, tau), q = nd(x, tau);
        const float L = lae(p, q);
        al[k] = expf(p - L);
        be[k] = expf(q - L);
        if (TAN) {
            const float xt = dd[j] + ld_tab(B.tb.cwv + word);
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
        // row_cand over the row's live entries (its pads as there)
        const int fill = P.row_fill[r], e0 = Lo.e0[Pos];
        float m = -INFINITY;
#pragma unroll 4
        for (int col = 0; col < fill; ++col) {
            const int e = e0 + 32 * col;
            const float z = __fadd_rn(d[Lo.snbr[e]], ld_tab(B.tb.ws + e));
            m = fmaxf(m, nd(z, tau));
        }
        const float pads = (float)(P.K - fill);
        const float y_pad = nd(__fadd_rn(d[0], BIG_F), tau);
        if (pads > 0.0f) m = fmaxf(m, y_pad);
        if (!isfinite(m)) m = 0.0f;
        float s = 0.0f, st = 0.0f;
#pragma unroll 4
        for (int col = 0; col < fill; ++col) {
            const int e = e0 + 32 * col;
            const int j = Lo.snbr[e];
            const float z = __fadd_rn(d[j], ld_tab(B.tb.ws + e));
            const float ex = expf(__fsub_rn(nd(z, tau), m));
            s = __fadd_rn(s, ex);
            if (TAN) st += ex * (-(dd[j] + ld_tab(B.tb.wvs + e)) / tau);
        }
        if (pads > 0.0f) {
            const float ex = expf(__fsub_rn(y_pad, m));
            s = __fadd_rn(s, __fmul_rn(pads, ex));
            if (TAN) st += pads * ex * (-dd[0] / tau);
        }
        c.m = m;
        c.s = s;
        c.cand = __fmul_rn(-tau, __fadd_rn(logf(s), m));
        c.st = st / s;
        acc2 = fminf(acc, c.cand);
    }
    const float out = fminf(acc2, dv);
    const float c_acc = share(acc2, out, dv), c_d = share(dv, out, acc2);
    const int il = i - B.lo;
    const float lam = B.lam[il];
    const float lam_t = TAN ? B.lam_t[il] : 0.0f;
    float g = lam * c_acc, g_t = lam_t * c_acc;
    const float g_dv = lam * c_d, g_dv_t = lam_t * c_d;
    if (r >= 0) {
        const float c_op = share(acc, acc2, c.cand);
        const float c_up = share(c.cand, acc2, acc);
        const float g_c = g * c_up, g_c_t = g_t * c_up;
        g *= c_op;
        g_t *= c_op;
        if (TAN) {
            B.row[rank][il] = make_float4(c.m, c.s, g_c, g_c_t);
            B.row_st[rank][il] = c.st;
        } else {
            B.row[rank][il] = make_float4(c.m, g_c / c.s, 0.0f, 0.0f);
        }
    }
#pragma unroll
    for (int k = C - 1; k >= 0; --k) {
        const int j = jw[k];
        const float gx = g * be[k];
        const int to = j / B.span;
        const int at = k * B.span + (j - to * B.span);
        B.gx[to][at] = gx;
        float* ct = B.ctc + (long long)k * N + Pos;
        if (TAN) {
            const float gx_t = g_t * be[k] + g * bet[k];
            g_t = g_t * al[k] + g * alt[k];
            B.gx_t[to][at] = gx_t;
            *ct += gx_t;
        } else {
            *ct += gx;
        }
        g *= al[k];
    }
    B.lam[il] = g + g_dv;
    if (TAN) B.lam_t[il] = g_t + g_dv_t;
}

// Phase 2 for the node at position P: what it received, in a fixed
// order (own, classes in order, its residual entries by CSR). A residual
// entry's cotangent, g_c / s * exp(-(d[j] + w) / tau - m), comes from the
// sender's row scalars and this node's own d in the sender's arithmetic
// (the product rounded on its own); the entry's slot accumulates it.
template <bool TAN, int CT>
__device__ __forceinline__ void node_gather(const Plan& P, const Layout& Lo,
                                            const Blk& B, int rank,
                                            int Pos, float tau) {
    const int C = CT > 0 ? CT : P.C;
    const int j = Lo.order[Pos];
    const int jl = j - B.lo;
    const float* gx = B.gx[rank] + jl;
    const float* gx_t = TAN ? B.gx_t[rank] + jl : nullptr;
    float s = B.lam[jl], st = TAN ? B.lam_t[jl] : 0.0f;
#pragma unroll
    for (int k = 0; k < C; ++k) {
        s += gx[k * B.span];
        if (TAN) st += gx_t[k * B.span];
    }
    if (P.has_res) {
        const int n_in = P.inv_ptr[j + 1] - P.inv_ptr[j];
        const int r0 = Lo.r0[Pos];
        const float dj = B.d[j];
        const float ddj = TAN ? B.dd[j] : 0.0f;
#pragma unroll 4
        for (int c = 0; c < n_in; ++c) {
            const int e = r0 + 32 * c;
            const int src = Lo.rsrc[e];
            const int sl = src & 0xffffff;
            const float4 R = B.row[src >> 24][sl];
            const float z = __fadd_rn(dj, ld_tab(B.tb.wr + e));
            const float ex = expf(__fsub_rn(nd(z, tau), R.x));
            if (TAN) {
                const float sg = R.z / R.y;
                const float gz = __fmul_rn(sg, ex);
                const float zt = ddj + ld_tab(B.tb.wvr + e);
                const float pc = ex / R.y;
                const float gz_t = R.w * pc
                    + R.z * (pc * ((-zt / tau) - B.row_st[src >> 24][sl]));
                s += gz;
                st += gz_t;
                B.ctw[e] += gz_t;
            } else {
                const float gz = __fmul_rn(R.y, ex);
                s += gz;
                B.ctw[e] += gz;
            }
        }
    }
    B.lam[jl] = s;
    if (TAN) B.lam_t[jl] = st;
}

// The weights of the position's class words and entries (into the
// table) and its slots' cotangents into this source's scratch (into), or
// the cotangents back to their slots.
template <bool TAN, int CT>
__device__ __forceinline__ void node_slots(const Plan& P, const Layout& Lo,
                                           const Blk& B, const float* th,
                                           const float* v, float* ct_sh,
                                           float* ct_rs, int Pos, bool into) {
    const int N = P.N, C = CT > 0 ? CT : P.C;
    const int i = Lo.order[Pos];
#pragma unroll
    for (int k = 0; k < C; ++k) {
        const long long word = (long long)k * N + wrap(i - P.deltas[k], N);
        const long long at = (long long)k * N + Pos;
        const int slot = P.sh_slot[word];
        if (into) {
            const int lk = P.sh_lnk[word];
            st_tab(B.tb.cw + at, link_w(lk, th, BIG_F));
            if (TAN) st_tab(B.tb.cwv + at, link_w(lk, v, 0.0f));
            B.ctc[at] = slot >= 0 ? ct_sh[slot] : 0.0f;
        } else if (slot >= 0) {
            ct_sh[slot] = B.ctc[at];
        }
    }
    if (!P.has_res) return;
    const int r = P.row_of[i];
    if (into && r >= 0) {
        const int fill = P.row_fill[r], e0 = Lo.e0[Pos];
        for (int c = 0; c < fill; ++c) {
            const int e = e0 + 32 * c, lk = Lo.slnk[e];
            st_tab(B.tb.ws + e, link_w(lk, th, BIG_F));
            if (TAN) st_tab(B.tb.wvs + e, link_w(lk, v, 0.0f));
        }
    }
    const int n_in = P.inv_ptr[i + 1] - P.inv_ptr[i], r0 = Lo.r0[Pos];
    for (int c = 0; c < n_in; ++c) {
        const int e = r0 + 32 * c, slot = Lo.rslot[e];
        if (into) {
            const int lk = Lo.rlnk[e];
            st_tab(B.tb.wr + e, link_w(lk, th, BIG_F));
            if (TAN) st_tab(B.tb.wvr + e, link_w(lk, v, 0.0f));
            B.ctw[e] = slot >= 0 ? ct_rs[slot] : 0.0f;
        } else if (slot >= 0) {
            ct_rs[slot] = B.ctw[e];
        }
    }
}

template <bool TAN, int CT>
__global__ void __launch_bounds__(THREADS)
te_adjoint_kernel(Plan P, Layout Lo, const float* th, const float* v,
                  const float* fields, const float* tfields, Adj A,
                  float tau, int T, int seed) {
    cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank(), s = blockIdx.x / Lo.cs;
    const int N = P.N, C = CT > 0 ? CT : P.C, f = TAN ? 2 : 1;
    const int lo = rank * Lo.span;
    const int own = max(0, min(N, lo + Lo.span) - lo);
    // shared memory: if own_sm the rows' scalars [span] (float4, and st
    // [span] in K16) and own cotangents [f][span]; the field [f][N] if
    // field_sm; the received class cotangents [f][C][span] if gx_sm.
    // Where not own_sm the rows' scalars are this block's rows of
    // Lo.own and its cotangents those of A.lam.
    extern __shared__ float4 sm4[];
    const long long row = (long long)s * N;
    float4* rows = Lo.own_sm ? sm4 : reinterpret_cast<float4*>(
        Lo.own + ((long long)s * Lo.cs + rank) * own_stride(Lo.span));
    float* row_st = reinterpret_cast<float*>(rows + Lo.span);
    float* lam = Lo.own_sm ? row_st + (TAN ? Lo.span : 0)
                           : reinterpret_cast<float*>(sm4);
    float* field = lam + (Lo.own_sm ? f * Lo.span : 0);
    float* gx_sm = field + (Lo.field_sm ? f * N : 0);
    __shared__ float* gx_of[MAX_CLUSTER];
    __shared__ float* gxt_of[MAX_CLUSTER];
    __shared__ float4* rows_of[MAX_CLUSTER];
    __shared__ float* row_st_of[MAX_CLUSTER];
    if (threadIdx.x < Lo.cs) {
        const int q = threadIdx.x;
        if (Lo.own_sm) {
            rows_of[q] = cl.map_shared_rank(sm4, q);
            row_st_of[q] = TAN ? cl.map_shared_rank(row_st, q) : nullptr;
        } else {
            rows_of[q] = rows + (q - rank) * own_stride(Lo.span) / 4;
            row_st_of[q] = reinterpret_cast<float*>(rows_of[q] + Lo.span);
        }
        if (Lo.gx_sm) {
            gx_of[q] = cl.map_shared_rank(gx_sm, q);
            gxt_of[q] = TAN ? cl.map_shared_rank(gx_sm + C * Lo.span, q)
                            : nullptr;
        } else {
            const long long at = ((long long)s * Lo.cs + q) * C * Lo.span;
            gx_of[q] = A.gx + at;
            gxt_of[q] = TAN ? A.gx_t + at : nullptr;
        }
    }
    const long long plane = (long long)P.S * N;
    float* ct_sh = A.ct_sh + (long long)s * P.n_sh;
    float* ct_rs = A.ct_rs + (long long)s * P.n_rs;
    Blk B;
    B.lam = Lo.own_sm ? lam : A.lam + row + lo;
    B.lam_t = !TAN ? nullptr : Lo.own_sm ? lam + Lo.span
                                         : A.lam_t + row + lo;
    B.gx = gx_of;
    B.gx_t = gxt_of;
    B.row = rows_of;
    B.row_st = row_st_of;
    B.tb = adj_tab(Lo, C, N);
    B.ctw = Lo.scr + (long long)s * (Lo.er + (long long)C * N);
    B.ctc = B.ctw + Lo.er;
    B.lo = lo;
    B.span = Lo.span;
    if (seed) {
        // the slot rows, split over the cluster
        const int tid = rank * blockDim.x + threadIdx.x;
        const int nth = Lo.cs * blockDim.x;
        for (int e = tid; e < P.n_sh; e += nth) ct_sh[e] = 0.0f;
        for (int e = tid; e < P.n_rs; e += nth) ct_rs[e] = 0.0f;
        for (int p = threadIdx.x; p < own; p += blockDim.x) {
            B.lam[p] = 0.0f;
            if (TAN) B.lam_t[p] = 0.0f;
        }
        __syncthreads();
        // the cost's cotangent: vol at each of this source's demands that
        // this block owns, in demand order (duplicates add, as the
        // reference's scatter-add)
        if (threadIdx.x == 0)
            for (int q = P.dem_ptr[s]; q < P.dem_ptr[s + 1]; ++q) {
                const int e = P.dem_ids[q], dst = P.dem_dst[e];
                if (dst >= lo && dst < lo + own)
                    B.lam[dst - lo] += P.dem_vol[e];
            }
    } else if (Lo.own_sm) {
        for (int p = threadIdx.x; p < own; p += blockDim.x) {
            B.lam[p] = A.lam[row + lo + p];
            if (TAN) B.lam_t[p] = A.lam_t[row + lo + p];
        }
    }
    cl.sync();
    // a position's weights and slots are its own thread's, every trip
    for (int p = threadIdx.x; p < own; p += blockDim.x)
        node_slots<TAN, CT>(P, Lo, B, th, v, ct_sh, ct_rs, lo + p, true);
    for (int t = T - 1; t >= 0; --t) {
        B.d = fields + t * plane + row;
        B.dd = TAN ? tfields + t * plane + row : nullptr;
        if (Lo.field_sm) {
            for (int i = threadIdx.x; i < N; i += blockDim.x) {
                field[i] = B.d[i];
                if (TAN) field[N + i] = B.dd[i];
            }
            __syncthreads();
            B.d = field;
            if (TAN) B.dd = field + N;
        }
        for (int p = threadIdx.x; p < own; p += blockDim.x)
            node_adj<TAN, CT>(P, Lo, B, rank, lo + p, tau);
        cl.sync();
        for (int p = threadIdx.x; p < own; p += blockDim.x)
            node_gather<TAN, CT>(P, Lo, B, rank, lo + p, tau);
        // the rows' scalars, the received buffers and the field are
        // reused next trip
        cl.sync();
    }
    for (int p = threadIdx.x; p < own; p += blockDim.x) {
        node_slots<TAN, CT>(P, Lo, B, th, v, ct_sh, ct_rs, lo + p, false);
        if (Lo.own_sm) {
            A.lam[row + lo + p] = B.lam[p];
            if (TAN) A.lam_t[row + lo + p] = B.lam_t[p];
        }
    }
}

// One cluster launch; a launch the card refuses returns its error.
template <bool TAN, int CT>
static int adjoint_launch(const Plan& P, const Layout& Lo, const float* th,
                          const float* v, const float* fields,
                          const float* tfields, const Adj& A, float tau,
                          int T, int seed, cudaStream_t stream) {
    void (*fn)(Plan, Layout, const float*, const float*, const float*,
               const float*, Adj, float, int, int) =
        te_adjoint_kernel<TAN, CT>;
    cudaError_t rc = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, Lo.smem);
    if (rc != cudaSuccess) return (int)rc;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(P.S * Lo.cs);
    cfg.blockDim = dim3(Lo.threads);
    cfg.dynamicSmemBytes = Lo.smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = Lo.cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    rc = cudaLaunchKernelEx(&cfg, fn, P, Lo, th, v, fields, tfields, A, tau,
                            T, seed);
    const cudaError_t last = cudaGetLastError();
    return (int)(rc != cudaSuccess ? rc : last);
}

// the class chain on registers for C <= 8, else in local memory
template <bool TAN>
static int adjoint(const Plan& P, const Layout& Lo, const float* th,
                   const float* v, const float* fields, const float* tfields,
                   const Adj& A, float tau, int T, int seed,
                   cudaStream_t stream) {
#define ADJ_C(n)                                                            \
    case n:                                                                 \
        return adjoint_launch<TAN, n>(P, Lo, th, v, fields, tfields, A, tau, \
                                      T, seed, stream)
    switch (P.C) {
        ADJ_C(1); ADJ_C(2); ADJ_C(3); ADJ_C(4);
        ADJ_C(5); ADJ_C(6); ADJ_C(7); ADJ_C(8);
        default:
            return adjoint_launch<TAN, 0>(P, Lo, th, v, fields, tfields, A,
                                          tau, T, seed, stream);
    }
#undef ADJ_C
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
        const int *row_of, const int *res_nbr, const int *rs_lnk,           \
        const int *row_fill, const int *inv_ptr, int K, const int *srcs,    \
        const int *dem_dst, const float *dem_vol, const int *dem_ptr,       \
        const int *dem_ids, int S, int N, int has_res, int n_sh, int n_rs
#define LAYOUT_PARAMS                                                       \
    const int *order, const int *e0, const int *r0, const int *snbr,        \
        const int *slnk, const int *rsrc, const int *rlnk,                  \
        const int *rslot, int es, int er, int cs, int span, int own_sm,     \
        int field_sm, int gx_sm, int smem, int threads, float *tab,         \
        float *scr, float *own
#define BUF_PARAMS                                                          \
    const float *theta, const float *v, float *fields, float *tfields,      \
        float *lam, float *lam_t, float *gx, float *gx_t, float *ct_sh,     \
        float *ct_rs, float tau, int T, int seed, cudaStream_t stream

static Plan make_plan(PLAN_PARAMS) {
    Plan P;
    P.deltas = deltas; P.C = C; P.sh_slot = sh_slot; P.sh_lnk = sh_lnk;
    P.row_of = row_of; P.res_nbr = res_nbr; P.rs_lnk = rs_lnk;
    P.row_fill = row_fill; P.inv_ptr = inv_ptr; P.K = K; P.srcs = srcs;
    P.dem_dst = dem_dst; P.dem_vol = dem_vol; P.dem_ptr = dem_ptr;
    P.dem_ids = dem_ids; P.S = S; P.N = N; P.has_res = has_res;
    P.n_sh = n_sh; P.n_rs = n_rs;
    return P;
}

#define MAKE_PLAN                                                         \
    make_plan(deltas, C, sh_slot, sh_lnk, row_of, res_nbr, rs_lnk,        \
              row_fill, inv_ptr, K, srcs, dem_dst, dem_vol, dem_ptr,      \
              dem_ids, S, N, has_res, n_sh, n_rs)
#define MAKE_LAYOUT                                                       \
    {order, e0, r0, snbr, slnk, rsrc, rlnk, rslot, es, er, cs, span,      \
     own_sm, field_sm, gx_sm, smem, threads, tab, scr, own}
#define MAKE_ADJ {lam, lam_t, gx, gx_t, ct_sh, ct_rs}

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

int te_relax_vjp(PLAN_PARAMS, LAYOUT_PARAMS, BUF_PARAMS) {
    const Layout Lo = MAKE_LAYOUT;
    const Adj A = MAKE_ADJ;
    return adjoint<false>(MAKE_PLAN, Lo, theta, v, fields, tfields, A, tau,
                          T, seed, stream);
}

int te_relax_vjp_jvp(PLAN_PARAMS, LAYOUT_PARAMS, BUF_PARAMS) {
    const Layout Lo = MAKE_LAYOUT;
    const Adj A = MAKE_ADJ;
    return adjoint<true>(MAKE_PLAN, Lo, theta, v, fields, tfields, A, tau,
                         T, seed, stream);
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
