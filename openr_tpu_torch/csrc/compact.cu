// Output compaction for Hopper (sm_90a): the end of the cold Decision
// pipeline, which packs the per-prefix outputs into the two pull
// buffers the host reads (decision/gpu_solver.py documents the layout).
// Each entry point launches one kernel on the caller's stream and
// returns cudaGetLastError().
//
// Replaces (K4) ops/stream.py::column_diff + compact_changed_rows, the
// full-pull compaction and the numerical-health sentinel counts of
// decision/tpu_solver.py::_make_pipeline — there `jnp.nonzero(size=,
// fill_value=)` plus gathers.
//
// Bound: bytes — every [P]-sized input is read once and every output
// slot written once. Design: a three-launch block-scan compaction with
// fixed output sizes (no host sync, no dynamic shape): count per block
// with __syncthreads_count, an exclusive scan of the block counts in one
// block, then a scatter that ranks each row inside its block with warp
// ballots. Pad slots past the live count carry index p_cap and the
// values of row p_cap - 1: the fixed-size nonzero fills with p_cap and
// the gather clips it to the last row. After an incremental solve the
// cone size and the fallback flag join the tail (ops/incremental.py).
// With LFA the backup slot and metric columns join the diff and follow
// the next-hop words in both payloads (ops/stream.py:79/99 and
// tpu_solver.py:601-603 of the JAX package). With g > 1 stacked
// same-shape areas (the vmap of _fused_pipeline) the lane is the grid's
// y dimension (the scan's x), and each lane's trips and rounds come from
// the device counters of its own loop (ops/relax.py::Lanes).
//
// The streaming epoch (decision/tpu_solver.py::_stream_pipeline, K4
// [stream]) is the same three launches with a small bucketed delta budget
// and one more delta column: the route-ok bit of each changed row, after
// the next-hop words and before the LFA columns (ops/stream.py layout),
// so the host applies the rows without unpacking words. Pad slots take
// row p_cap - 1's ok bit, as they take its other columns. The full
// payload never carries it.

#include <cuda_runtime.h>
#include <stdint.h>

#define INF_E (1 << 29)
#define SENTINEL_SAT (1 << 28)
#define THREADS 1024
#define WARPS (THREADS / 32)

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

// per-block counts: blk[4b + 0] changed rows, +1 ok rows, +2
// unreachable rows (a live announcer, no finite metric), +3 saturated
// rows (finite metric past 2^28)
__global__ void compact_count_kernel(Rows r, int* __restrict__ blk) {
    r = lane_rows(r, blockIdx.y);
    blk += 4LL * gridDim.x * blockIdx.y;
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    bool ch = false, ok = false, unreach = false, sat = false;
    if (p < r.p_cap) {
        ch = row_changed(r, p);
        ok = r.ok[p] != 0;
        int m = r.metric[p];
        bool live = false;
        for (int a = 0; a < r.a_cap; ++a)
            live |= (r.flags[(long long)p * r.a_cap + a] & 1) != 0;
        unreach = live && m >= INF_E;
        sat = m < INF_E && m > SENTINEL_SAT;
    }
    int c0 = __syncthreads_count(ch);
    int c1 = __syncthreads_count(ok);
    int c2 = __syncthreads_count(unreach);
    int c3 = __syncthreads_count(sat);
    if (threadIdx.x == 0) {
        blk[4 * blockIdx.x + 0] = c0;
        blk[4 * blockIdx.x + 1] = c1;
        blk[4 * blockIdx.x + 2] = c2;
        blk[4 * blockIdx.x + 3] = c3;
    }
}

// one block a lane: exclusive scan of the per-block counts in place
// (blk[4b] and blk[4b+1] become offsets) and the scalar fields of both
// buffers. The block count is p_cap / 1024, so a serial scan by one
// thread is a few hundred adds. trips and rounds are the arguments, or
// the lane's counters tr[2 lane], tr[2 lane + 1] when `tr` is not null.
// The tail, back to front: rounds; the incremental solve's (cone,
// fell_back), read from the device where K9 left them, when `cone` is
// not null; the sentinel pair when `sentinels`.
__global__ void compact_scan_kernel(int* __restrict__ blk, int nblk,
                                    int* __restrict__ delta_buf,
                                    int* __restrict__ full_buf,
                                    int delta_len, int full_len, int trips,
                                    int rounds, int sentinels,
                                    const int* __restrict__ cone,
                                    const int* __restrict__ fell,
                                    const int* __restrict__ tr) {
    if (threadIdx.x != 0) return;
    const int lane = blockIdx.x;
    blk += 4LL * nblk * lane;
    delta_buf += (long long)delta_len * lane;
    full_buf += (long long)full_len * lane;
    if (tr) {
        trips = tr[2 * lane];
        rounds = tr[2 * lane + 1];
    }
    int ch = 0, ok = 0, unreach = 0, sat = 0;
    for (int b = 0; b < nblk; ++b) {
        int c0 = blk[4 * b], c1 = blk[4 * b + 1];
        blk[4 * b] = ch;
        blk[4 * b + 1] = ok;
        ch += c0;
        ok += c1;
        unreach += blk[4 * b + 2];
        sat += blk[4 * b + 3];
    }
    delta_buf[0] = ch;
    delta_buf[1] = trips;
    full_buf[0] = ok;
    full_buf[1] = trips;
    int end = 1;  // tail words written so far, back to front
    if (cone) {
        delta_buf[delta_len - 3] = *cone;
        delta_buf[delta_len - 2] = *fell;
        full_buf[full_len - 3] = *cone;
        full_buf[full_len - 2] = *fell;
        end = 3;
    }
    if (sentinels) {
        delta_buf[delta_len - end - 2] = unreach;
        delta_buf[delta_len - end - 1] = sat;
        full_buf[full_len - end - 2] = unreach;
        full_buf[full_len - end - 1] = sat;
    }
    delta_buf[delta_len - 1] = rounds;
    full_buf[full_len - 1] = rounds;
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

// scatter: thread i places row i (when it is ok / changed) at its rank,
// and fills slot i with the pad row when i is past the live count. The
// two writes never collide: ranks are < count <= pad slots.
__global__ void compact_scatter_kernel(Rows r, const int* __restrict__ blk,
                                       int* __restrict__ delta_buf,
                                       int* __restrict__ full_buf,
                                       int budget, int nblk, int delta_len,
                                       int full_len, int stream) {
    __shared__ int warp_ch[WARPS], warp_ok[WARPS];
    const int area = blockIdx.y;
    r = lane_rows(r, area);
    blk += 4LL * nblk * area;
    delta_buf += (long long)delta_len * area;
    full_buf += (long long)full_len * area;
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    bool ch = false, ok = false;
    if (i < r.p_cap) {
        ch = row_changed(r, i);
        ok = r.ok[i] != 0;
    }
    unsigned bch = __ballot_sync(0xffffffffu, ch);
    unsigned bok = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) {
        warp_ch[warp] = __popc(bch);
        warp_ok[warp] = __popc(bok);
    }
    __syncthreads();
    unsigned below = (1u << lane) - 1u;
    int rch = __popc(bch & below), rok = __popc(bok & below);
    for (int w = 0; w < warp; ++w) {
        rch += warp_ch[w];
        rok += warp_ok[w];
    }
    const int last = r.p_cap - 1;
    const bool with_ok = stream != 0;
    if (ok)
        put_row(r, full_buf, r.p_cap, blk[4 * blockIdx.x + 1] + rok, i, i,
                false);
    if (ch) {
        int pos = blk[4 * blockIdx.x] + rch;
        if (pos < budget) put_row(r, delta_buf, budget, pos, i, i, with_ok);
    }
    if (i < r.p_cap && i >= full_buf[0])
        put_row(r, full_buf, r.p_cap, i, r.p_cap, last, false);
    if (i < budget && i >= delta_buf[0])
        put_row(r, delta_buf, budget, i, r.p_cap, last, with_ok);
}

extern "C" {

static Rows make_rows(const int* metric, const int* s3w, const int* nhw,
                      const uint8_t* ok, const int* prev_metric,
                      const int* prev_s3w, const int* prev_nhw,
                      const int* flags, const int* const* lfa, int p_cap,
                      int a_cap, int wa, int wd, long long flags_stride) {
    Rows r;
    r.lfa_slot = lfa[0];
    r.lfa_metric = lfa[1];
    r.prev_lfa_slot = lfa[2];
    r.prev_lfa_metric = lfa[3];
    r.flags_stride = flags_stride;
    r.metric = metric;
    r.s3w = s3w;
    r.nhw = nhw;
    r.ok = ok;
    r.prev_metric = prev_metric;
    r.prev_s3w = prev_s3w;
    r.prev_nhw = prev_nhw;
    r.flags = flags;
    r.p_cap = p_cap;
    r.a_cap = a_cap;
    r.wa = wa;
    r.wd = wd;
    return r;
}

// the lfa pointer array holds (lfa_slot, lfa_metric, prev_lfa_slot,
// prev_lfa_metric), each null without LFA; flags_stride is the element
// distance between two lanes' flag planes
int compact_count(const int* metric, const int* s3w, const int* nhw,
                  const uint8_t* ok, const int* prev_metric,
                  const int* prev_s3w, const int* prev_nhw, const int* flags,
                  const int* lfa_slot, const int* lfa_metric,
                  const int* prev_lfa_slot, const int* prev_lfa_metric,
                  int* blk, int p_cap, int a_cap, int wa, int wd, int g,
                  long long flags_stride, cudaStream_t stream) {
    const int* lfa[4] = {lfa_slot, lfa_metric, prev_lfa_slot,
                         prev_lfa_metric};
    Rows r = make_rows(metric, s3w, nhw, ok, prev_metric, prev_s3w, prev_nhw,
                       flags, lfa, p_cap, a_cap, wa, wd, flags_stride);
    int nblk = (p_cap + THREADS - 1) / THREADS;
    compact_count_kernel<<<dim3(nblk, g), THREADS, 0, stream>>>(r, blk);
    return (int)cudaGetLastError();
}

int compact_scan(int* blk, int nblk, int* delta_buf, int* full_buf,
                 int delta_len, int full_len, int trips, int rounds,
                 int sentinels, const int* cone, const int* fell,
                 const int* tr, int g, cudaStream_t stream) {
    compact_scan_kernel<<<g, 32, 0, stream>>>(blk, nblk, delta_buf, full_buf,
                                              delta_len, full_len, trips,
                                              rounds, sentinels, cone, fell,
                                              tr);
    return (int)cudaGetLastError();
}

int compact_scatter(const int* metric, const int* s3w, const int* nhw,
                    const uint8_t* ok, const int* prev_metric,
                    const int* prev_s3w, const int* prev_nhw,
                    const int* flags, const int* lfa_slot,
                    const int* lfa_metric, const int* prev_lfa_slot,
                    const int* prev_lfa_metric, const int* blk,
                    int* delta_buf, int* full_buf, int p_cap, int a_cap,
                    int wa, int wd, int budget, int delta_len, int full_len,
                    int with_ok, int g, long long flags_stride,
                    cudaStream_t stream) {
    const int* lfa[4] = {lfa_slot, lfa_metric, prev_lfa_slot,
                         prev_lfa_metric};
    Rows r = make_rows(metric, s3w, nhw, ok, prev_metric, prev_s3w, prev_nhw,
                       flags, lfa, p_cap, a_cap, wa, wd, flags_stride);
    int span = p_cap > budget ? p_cap : budget;
    int nblk = (span + THREADS - 1) / THREADS;
    int count_blk = (p_cap + THREADS - 1) / THREADS;
    compact_scatter_kernel<<<dim3(nblk, g), THREADS, 0, stream>>>(
        r, blk, delta_buf, full_buf, budget, count_blk, delta_len, full_len,
        with_ok);
    return (int)cudaGetLastError();
}

}  // extern "C"
