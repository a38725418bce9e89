// Output compaction for Hopper (sm_90a): the end of the cold Decision
// pipeline, which packs the per-prefix outputs into the two pull
// buffers the host reads (decision/gpu_solver.py documents the layout).
// The entry point launches one cooperative kernel on the caller's
// stream and returns its error (a refused launch included).
//
// Replaces (K4) ops/stream.py::column_diff + compact_changed_rows (:79,
// :99), the full-pull compaction and the numerical-health sentinel
// counts of decision/tpu_solver.py::_make_pipeline (:590-630) — there
// `jnp.nonzero(size=, fill_value=)` plus gathers. Pad slots past the
// live count carry index p_cap and the values of row p_cap - 1: the
// fixed-size nonzero fills with p_cap and the gather clips it to the
// last row. After an incremental solve the cone size and the fallback
// flag join the tail, read on the device where K9 left them
// (ops/incremental.py). With LFA the backup slot and metric columns
// join the diff and follow the next-hop words in both payloads
// (ops/stream.py:79/99 and tpu_solver.py:601-603 of the JAX package).
// With g > 1 stacked same-shape areas (the vmap of _fused_pipeline)
// each lane's rows are tiles of their own, and each lane's trips and
// rounds come from the device counters of its own loop
// (ops/relax.py::Lanes).
//
// The streaming epoch (decision/tpu_solver.py::_stream_pipeline, K4
// [stream]) is the same launch with a small bucketed delta budget and
// one more delta column: the route-ok bit of each changed row, after
// the next-hop words and before the LFA columns (ops/stream.py layout),
// so the host applies the rows without unpacking words. Pad slots take
// row p_cap - 1's ok bit, as they take its other columns. The full
// payload never carries it. `count` is every changed row, also past the
// budget; only the first `budget` are placed.
//
// Bound: bytes — every [P]-sized input is read once and every output
// slot written once.
//
// Design: one cooperative launch (fixed output sizes, no host sync, no
// dynamic shape). A block takes a tile of THREADS rows of one lane: it
// evaluates each row's predicates once (changed, ok, unreachable,
// saturated), keeps the changed and ok bits in registers (two bits a
// tile, for its first CACHE_TILES tiles; rows of later tiles are read
// again) and writes its four counts to a scratch. After one grid
// barrier, warp 0 of each block sums the counts of its lane's tiles
// (the tiles before its own: its offsets; all: the lane's totals), and
// the block ranks its rows with warp ballots and places them and the
// pad slots at once. The block of each lane's tile 0 writes the
// scalars and the tail. The grid is the co-resident blocks, at most
// BLOCKS_PER_SM an SM; blocks stride over the g x ceil(max(P, budget) /
// THREADS) tiles when there are more.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "coop.cuh"

namespace cg = cooperative_groups;

#define INF_E (1 << 29)
#define SENTINEL_SAT (1 << 28)
#define THREADS 1024
#define WARPS (THREADS / 32)
#define CACHE_TILES 16
#define BLOCKS_PER_SM 2
#define FULL 0xffffffffu

struct Rows {
    const int* metric;
    const int* s3w;
    const int* nhw;
    const uint8_t* ok;
    const int* prev_metric;
    const int* prev_s3w;
    const int* prev_nhw;
    const int* flags;  // [P, A] announcer flag plane, bit 0 = valid
    // the LFA columns and their previous values, all null without LFA
    const int* lfa_slot;
    const int* lfa_metric;
    const int* prev_lfa_slot;
    const int* prev_lfa_metric;
    int p_cap, a_cap, wa, wd;
    long long flags_stride;  // elements from one lane's flags to the next
};

// the two buffers and the scalars of their heads and tails
struct Tail {
    int* delta_buf;
    int* full_buf;
    int delta_len, full_len, budget, with_ok;
    int trips, rounds, sentinels;
    const int* cone;  // the incremental solve's (cone, fell_back), or null
    const int* fell;
    const int* tr;  // [g, 2] per-lane (trips, rounds), or null
};

// the rows of lane `lane` of g stacked areas
__device__ __forceinline__ Rows lane_rows(Rows r, int lane) {
    const long long p = r.p_cap;
    r.metric += lane * p;
    r.s3w += lane * p * r.wa;
    r.nhw += lane * p * r.wd;
    r.ok += lane * p;
    r.prev_metric += lane * p;
    r.prev_s3w += lane * p * r.wa;
    r.prev_nhw += lane * p * r.wd;
    r.flags += lane * r.flags_stride;
    if (r.lfa_slot) {
        r.lfa_slot += lane * p;
        r.lfa_metric += lane * p;
        r.prev_lfa_slot += lane * p;
        r.prev_lfa_metric += lane * p;
    }
    return r;
}

__device__ __forceinline__ bool row_changed(const Rows& r, int p) {
    if (r.metric[p] != r.prev_metric[p]) return true;
    if (r.lfa_slot && (r.lfa_slot[p] != r.prev_lfa_slot[p] ||
                       r.lfa_metric[p] != r.prev_lfa_metric[p]))
        return true;
    for (int w = 0; w < r.wa; ++w)
        if (r.s3w[(long long)p * r.wa + w] != r.prev_s3w[(long long)p * r.wa + w])
            return true;
    for (int w = 0; w < r.wd; ++w)
        if (r.nhw[(long long)p * r.wd + w] != r.prev_nhw[(long long)p * r.wd + w])
            return true;
    return false;
}

// write row `src` (its index is `idx`) into slot `pos` of a buffer laid
// out as [count, trips, idx[cap], metric[cap], s3w[cap*wa], nhw[cap*wd]
// (, ok[cap] when `with_ok`) (, lfa_slot[cap], lfa_metric[cap])]
__device__ __forceinline__ void put_row(const Rows& r, int* buf, int cap,
                                        int pos, int idx, int src,
                                        bool with_ok) {
    buf[2 + pos] = idx;
    buf[2 + cap + pos] = r.metric[src];
    int* s3 = buf + 2 + 2 * (long long)cap;
    for (int w = 0; w < r.wa; ++w)
        s3[(long long)pos * r.wa + w] = r.s3w[(long long)src * r.wa + w];
    int* nh = s3 + (long long)cap * r.wa;
    for (int w = 0; w < r.wd; ++w)
        nh[(long long)pos * r.wd + w] = r.nhw[(long long)src * r.wd + w];
    int* rest = nh + (long long)cap * r.wd;
    if (with_ok) {
        rest[pos] = r.ok[src] != 0;
        rest += cap;
    }
    if (r.lfa_slot) {
        rest[pos] = r.lfa_slot[src];
        rest[cap + pos] = r.lfa_metric[src];
    }
}


// the scalars of lane `lane`'s buffers: the counts and trips at the
// head; the tail back to front: rounds; the incremental solve's (cone,
// fell_back) when `cone` is not null; the sentinel pair when
// `sentinels`
__device__ void put_scalars(const Tail& t, int lane, int ch, int ok,
                            int unreach, int sat) {
    int* delta = t.delta_buf + (long long)t.delta_len * lane;
    int* full = t.full_buf + (long long)t.full_len * lane;
    const int trips = t.tr ? t.tr[2 * lane] : t.trips;
    const int rounds = t.tr ? t.tr[2 * lane + 1] : t.rounds;
    const int dl = t.delta_len, fl = t.full_len;
    delta[0] = ch;
    delta[1] = trips;
    full[0] = ok;
    full[1] = trips;
    int end = 1;  // tail words written so far, back to front
    if (t.cone) {
        delta[dl - 3] = *t.cone;
        delta[dl - 2] = *t.fell;
        full[fl - 3] = *t.cone;
        full[fl - 2] = *t.fell;
        end = 3;
    }
    if (t.sentinels) {
        delta[dl - end - 2] = unreach;
        delta[dl - end - 1] = sat;
        full[fl - end - 2] = unreach;
        full[fl - end - 1] = sat;
    }
    delta[dl - 1] = rounds;
    full[fl - 1] = rounds;
}

// part[4 tile + k]: tile's changed (k 0), ok (1), unreachable (a live
// announcer, no finite metric: 2) and saturated (a finite metric past
// 2^28: 3) rows, tiles numbered lane * ntile + tile
__global__ void __launch_bounds__(THREADS) compact_tail_kernel(
    Rows r, Tail t, int* __restrict__ part, int g, int ntile) {
    cg::grid_group grid = cg::this_grid();
    __shared__ int warp_ch[WARPS], warp_ok[WARPS];
    __shared__ int sums[6];  // offsets ch, ok; totals ch, ok, unreach, sat
    const long long tiles = (long long)g * ntile;
    const int tid = threadIdx.x, wl = tid & 31, warp = tid >> 5;
    unsigned cache = 0;  // (changed, ok) of this thread's row, per tile
    int k = 0;
    for (long long tt = blockIdx.x; tt < tiles; tt += gridDim.x, ++k) {
        const int lane = (int)(tt / ntile);
        const Rows rl = lane_rows(r, lane);
        const int i = (int)(tt - (long long)lane * ntile) * THREADS + tid;
        bool ch = false, ok = false, unreach = false, sat = false;
        if (i < rl.p_cap) {
            ch = row_changed(rl, i);
            ok = rl.ok[i] != 0;
            const int m = rl.metric[i];
            bool live = false;
            for (int a = 0; a < rl.a_cap; ++a)
                live |= (rl.flags[(long long)i * rl.a_cap + a] & 1) != 0;
            unreach = live && m >= INF_E;
            sat = m < INF_E && m > SENTINEL_SAT;
        }
        if (k < CACHE_TILES)
            cache |= ((unsigned)ch | (unsigned)ok << 1) << (2 * k);
        const int c0 = __syncthreads_count(ch);
        const int c1 = __syncthreads_count(ok);
        const int c2 = __syncthreads_count(unreach);
        const int c3 = __syncthreads_count(sat);
        if (tid == 0) {
            part[4 * tt + 0] = c0;
            part[4 * tt + 1] = c1;
            part[4 * tt + 2] = c2;
            part[4 * tt + 3] = c3;
        }
    }
    grid.sync();
    k = 0;
    for (long long tt = blockIdx.x; tt < tiles; tt += gridDim.x, ++k) {
        const int lane = (int)(tt / ntile);
        const int tile = (int)(tt - (long long)lane * ntile);
        const Rows rl = lane_rows(r, lane);
        const int i = tile * THREADS + tid;
        if (warp == 0) {
            const int* pl = part + 4LL * ntile * lane;
            int pch = 0, pok = 0, tch = 0, tok = 0, un = 0, sa = 0;
            for (int u = wl; u < ntile; u += 32) {
                const int a0 = pl[4 * u], a1 = pl[4 * u + 1];
                tch += a0;
                tok += a1;
                if (u < tile) {
                    pch += a0;
                    pok += a1;
                }
                un += pl[4 * u + 2];
                sa += pl[4 * u + 3];
            }
            pch = __reduce_add_sync(FULL, pch);
            pok = __reduce_add_sync(FULL, pok);
            tch = __reduce_add_sync(FULL, tch);
            tok = __reduce_add_sync(FULL, tok);
            un = __reduce_add_sync(FULL, un);
            sa = __reduce_add_sync(FULL, sa);
            if (wl == 0) {
                sums[0] = pch;
                sums[1] = pok;
                sums[2] = tch;
                sums[3] = tok;
                sums[4] = un;
                sums[5] = sa;
            }
        }
        bool ch = false, ok = false;
        if (k < CACHE_TILES) {
            ch = (cache >> (2 * k)) & 1;
            ok = (cache >> (2 * k + 1)) & 1;
        } else if (i < rl.p_cap) {
            ch = row_changed(rl, i);
            ok = rl.ok[i] != 0;
        }
        const unsigned bch = __ballot_sync(FULL, ch);
        const unsigned bok = __ballot_sync(FULL, ok);
        if (wl == 0) {
            warp_ch[warp] = __popc(bch);
            warp_ok[warp] = __popc(bok);
        }
        __syncthreads();
        const unsigned below = (1u << wl) - 1u;
        int rch = sums[0] + __popc(bch & below);
        int rok = sums[1] + __popc(bok & below);
        for (int w = 0; w < warp; ++w) {
            rch += warp_ch[w];
            rok += warp_ok[w];
        }
        const int tch = sums[2], tok = sums[3];
        int* delta = t.delta_buf + (long long)t.delta_len * lane;
        int* full = t.full_buf + (long long)t.full_len * lane;
        const int p_cap = rl.p_cap, last = p_cap - 1;
        const bool with_ok = t.with_ok != 0;
        // ranks are < count <= pad slots: the writes never collide
        if (ok) put_row(rl, full, p_cap, rok, i, i, false);
        if (ch && rch < t.budget)
            put_row(rl, delta, t.budget, rch, i, i, with_ok);
        if (i < p_cap && i >= tok) put_row(rl, full, p_cap, i, p_cap, last,
                                           false);
        if (i < t.budget && i >= tch)
            put_row(rl, delta, t.budget, i, p_cap, last, with_ok);
        if (tile == 0 && tid == 0)
            put_scalars(t, lane, tch, tok, sums[4], sums[5]);
        __syncthreads();  // sums and warp counts are reused next tile
    }
}

extern "C" {

// the lfa pointers (lfa_slot, lfa_metric, prev_lfa_slot,
// prev_lfa_metric) are each null without LFA; flags_stride is the
// element distance between two lanes' flag planes; `part` holds 4 x g x
// ceil(max(p_cap, budget) / 1024) ints of scratch; trips and rounds are
// the arguments, or each lane's tr[2 lane], tr[2 lane + 1] when `tr`
// is not null
int compact_tail(const int* metric, const int* s3w, const int* nhw,
                 const uint8_t* ok, const int* prev_metric,
                 const int* prev_s3w, const int* prev_nhw, const int* flags,
                 const int* lfa_slot, const int* lfa_metric,
                 const int* prev_lfa_slot, const int* prev_lfa_metric,
                 int* part, int* delta_buf, int* full_buf, int p_cap,
                 int a_cap, int wa, int wd, int budget, int delta_len,
                 int full_len, int trips, int rounds, int sentinels,
                 const int* cone, const int* fell, const int* tr,
                 int with_ok, int g, long long flags_stride,
                 cudaStream_t stream) {
    Rows r;
    r.metric = metric;
    r.s3w = s3w;
    r.nhw = nhw;
    r.ok = ok;
    r.prev_metric = prev_metric;
    r.prev_s3w = prev_s3w;
    r.prev_nhw = prev_nhw;
    r.flags = flags;
    r.lfa_slot = lfa_slot;
    r.lfa_metric = lfa_metric;
    r.prev_lfa_slot = prev_lfa_slot;
    r.prev_lfa_metric = prev_lfa_metric;
    r.p_cap = p_cap;
    r.a_cap = a_cap;
    r.wa = wa;
    r.wd = wd;
    r.flags_stride = flags_stride;
    Tail t;
    t.delta_buf = delta_buf;
    t.full_buf = full_buf;
    t.delta_len = delta_len;
    t.full_len = full_len;
    t.budget = budget;
    t.with_ok = with_ok;
    t.trips = trips;
    t.rounds = rounds;
    t.sentinels = sentinels;
    t.cone = cone;
    t.fell = fell;
    t.tr = tr;
    int span = p_cap > budget ? p_cap : budget;
    int ntile = (span + THREADS - 1) / THREADS;
    if (g < 1 || ntile < 1) return (int)cudaErrorInvalidValue;
    static int grid[64];
    long long tiles = (long long)g * ntile;
    int nb = (int)min(tiles, (long long)coop_grid(
                                 (const void*)compact_tail_kernel, THREADS,
                                 BLOCKS_PER_SM, grid));
    if (nb < 1) return (int)cudaErrorInvalidConfiguration;
    void* args[] = {&r, &t, &part, &g, &ntile};
    cudaError_t rc = cudaLaunchCooperativeKernel(
        (const void*)compact_tail_kernel, dim3(nb), dim3(THREADS), args, 0,
        stream);
    return rc != cudaSuccess ? (int)rc : (int)cudaGetLastError();
}

}  // extern "C"
