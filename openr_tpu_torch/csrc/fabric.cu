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
//   K21e each residual row's live extent and each class row's
//        liveness, once a step, for K21
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
// Lane gates (the Gate of csrc/relax.cu): lane = root. A root whose
// planes changed nothing in the previous trip reached its fixpoint; no
// block touches its words and its two plane buffers are equal, so the
// host's buffer swaps stay valid for it. The per-root change stamps also
// carry the convergence vote: one more gated relaxation after the fixed
// trips, and a root that changed in it did not converge.
//
// K21's bound: bytes — each root's [D, n_cap] plane read once and
// written once; the class rows, the residual ELL up to its live extents
// and the node -> row table read once. What bounds the design instead
// is the residual's gathers: every (root, row, live entry) reads one
// distance of the root's row, and the ELL itself would be read once a
// plane if a thread walked its node's row (fabric10k: 32,768 planes x
// 153,600 entries, ~40 GB of table reads a relaxation against a 2.1 GB
// plane).
//
// K21's design (one launch a relaxation, no atomics on device memory,
// each output word written once by a plain store): a block owns a tile
// of FAB_TN nodes and FAB_ROOTS roots of the grid's y. It first copies
// its tile's residual entries into shared memory once — each node's row
// found through the node -> row table `row_of` (-1: no row in this
// member; rows are unique per node, ops/fabric.row_table), read up to
// the row's live extent (K21e `ext`), cut into items of FAB_CHUNK
// entries so that a fabric switch's 100 entries and a rack switch's 8
// share the threads evenly, the items listed chunk-major — and then
// serves every root it takes from that copy: the table is fetched from
// L2 once for FAB_ROOTS x D planes. It walks its roots FAB_RS at a time
// (a slab) and the rows DC at a time. Phase 1: a thread takes an (item,
// root) pair, gathers its entries' sources from DC rows of the root (a
// tile's neighbours are few and local, so the gathers mostly hit L1)
// and min's its candidates into a shared accumulator [FAB_RS, DC,
// FAB_TN] (shared atomicMin; chunk-major items put distinct nodes on a
// warp's lanes, so the atomics do not collide).
// Phase 2: a thread takes an output word (32 neighbouring nodes a
// warp), reads the word, its live shift classes' candidates (a class
// whose weights are all INF_E never lowers a word and is not run, so
// fabric10k's four void classes cost nothing) and the accumulator, and
// stores the word. Blocks of one root group run side by side (x is the
// tile), so the rows they gather from are fetched from device memory
// about once. The change is voted per root in shared memory (its
// stamps) and per block (__syncthreads_or before one atomicOr).
// FAB_RS 4 and FAB_ROOTS 16 read fastest on fabric10k (H100: of FAB_RS
// 2, 4, 8 and FAB_ROOTS 8, 16, 32, 64, with DC 4 or 8; a slab's
// accumulator and the rows it gathers from stay small enough for L1);
// tools/relax_split.py --lib fabric --define FAB_RS=8 times another.

#include <cuda_runtime.h>
#include <stdint.h>

#define INF_E (1 << 29)
#define THREADS 256
#define KEEP (-2147483647 - 1)  // a put stamp that is not stored
#define FAB_TN 32               // nodes a tile: one warp's worth
#define FAB_CHUNK 8             // residual entries an item
#ifndef FAB_RS
#define FAB_RS 4                // roots a slab
#endif
#ifndef FAB_ROOTS
#define FAB_ROOTS 16            // roots a block
#endif
#define FAB_ENT_MAX 8192        // residual entries a block holds in shared
#define FAB_THREADS 256

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

// a thread of a block that changed a word of an open, gated lane
__device__ __forceinline__ void gate_put(const Gate& g, int lane) {
    if (g.put0 != KEEP) g.st[2 * lane] = g.put0;
    if (g.put1 != KEEP) g.st[2 * lane + 1] = g.put1;
}

// once a launch for each open, gated lane
__device__ __forceinline__ void gate_count(const Gate& g, int lane) {
    g.cnt[2 * lane] += g.inc0;
    g.cnt[2 * lane + 1] += g.inc1;
}

// K21: out[r,d,v] = min(dist[r,d,v], over the live classes k whose
// source src = (v - deltas[k]) mod n_cap is not roots[r] and lies in the
// column window: dist[r,d,src] + sw[k, src - col0], and over the entries
// j < ext[row] of v's residual row (row = row_of[v]) whose source nbr is
// not roots[r]: dist[r,d,clip(nbr)] + res_w[row, j]). Jacobi: reads
// `dist`, writes `out`. |deltas[k]| < n_cap. `live` null: every class
// runs; `row_of` null: no residual.
template <int DC>
__global__ void __launch_bounds__(FAB_THREADS) fabric_relax_kernel(
    const int* __restrict__ dist, int* __restrict__ out,
    const int* __restrict__ deltas, const int* __restrict__ sw,
    const int* __restrict__ live, const int* __restrict__ roots,
    const int* __restrict__ res_nbr, const int* __restrict__ res_w,
    const int* __restrict__ ext, const int* __restrict__ row_of, int d_cap,
    int n_cap, int s_cap, int col0, int w_cols, int kr_cap, int ent_cap,
    int* __restrict__ flag, int g, Gate gate) {
    // ent_cap entries, then each item's node and chunk (node | chunk << 5)
    extern __shared__ int2 s_ent[];
    unsigned short* s_item = reinterpret_cast<unsigned short*>(s_ent + ent_cap);
    __shared__ int s_acc[FAB_RS * DC * FAB_TN];
    __shared__ int s_row[FAB_TN], s_ext[FAB_TN];
    __shared__ int s_root[FAB_RS], s_hit[FAB_RS], s_items;
    const int t = threadIdx.x;
    const int v0 = blockIdx.x * FAB_TN;
    const int rb0 = blockIdx.y * FAB_ROOTS;
    const int rb = min(FAB_ROOTS, g - rb0);
    if (!__syncthreads_or(t < rb && gate_open(gate, rb0 + t))) return;

    // the tile's residual items: node i's row cut into FAB_CHUNK-entry
    // chunks, listed chunk-major (every node's chunk 0, then chunk 1, ...)
    // so that the lanes of a warp take distinct nodes: their shared
    // atomics do not collide and, the tile's nodes being alike, their
    // gathers mostly share sources
    if (t < FAB_TN) {
        const int v = v0 + t;
        const int row = row_of && v < n_cap ? row_of[v] : -1;
        const int e = row >= 0 ? ext[row] : 0;
        const int it = (e + FAB_CHUNK - 1) / FAB_CHUNK;
        s_row[t] = row;
        s_ext[t] = e;
        const int most = __reduce_max_sync(0xffffffffu, it);
        int base = 0;
        for (int c = 0; c < most; ++c) {
            const unsigned m = __ballot_sync(0xffffffffu, it > c);
            if (it > c)
                s_item[base + __popc(m & ((1u << t) - 1u))] =
                    (unsigned short)(t | c << 5);
            base += __popc(m);
        }
        if (t == 0) s_items = base;
    }
    if (t < FAB_RS) s_hit[t] = 0;
    for (int i = t; i < FAB_RS * DC * FAB_TN; i += FAB_THREADS)
        s_acc[i] = INF_E;
    __syncthreads();
    const int n_items = s_items;
    // the items whose entries fit in shared memory (the rest are read
    // from the table as they are used)
    const int sh_items = min(n_items, ent_cap / FAB_CHUNK);
    for (int q = t; q < sh_items * FAB_CHUNK; q += FAB_THREADS) {
        const int m = s_item[q / FAB_CHUNK];
        const int i = m & (FAB_TN - 1);
        const int j = (m >> 5) * FAB_CHUNK + q % FAB_CHUNK;
        int2 e = make_int2(0, INF_E);
        if (j < s_ext[i]) {
            const long long at = (long long)s_row[i] * kr_cap + j;
            e = make_int2(res_nbr[at], res_w[at]);
        }
        s_ent[q] = e;
    }
    // (the first slab's barrier orders the copy before its reads)

    const long long plane = (long long)d_cap * n_cap;
    const int hi = n_cap - 1;
    int changed = 0;
    for (int s0 = 0; s0 < rb; s0 += FAB_RS) {
        if (t < FAB_RS) {
            const int r = rb0 + s0 + t;
            const bool open = s0 + t < rb && gate_open(gate, r);
            s_root[t] = open ? roots[r] : -1;
            if (open && gate.st && blockIdx.x == 0) gate_count(gate, r);
        }
        __syncthreads();
        for (int d0 = 0; d0 < d_cap; d0 += DC) {
            const int dn = min(DC, d_cap - d0);
            // phase 1: (item, root) pairs, the root slowest
            for (int u = t; u < n_items * FAB_RS; u += FAB_THREADS) {
                const int s = u / n_items;
                const int it = u - s * n_items;
                const int root = s_root[s];
                if (root < 0) continue;
                const int* rows =
                    dist + (rb0 + s0 + s) * plane + (long long)d0 * n_cap;
                int cand[DC];
#pragma unroll
                for (int j = 0; j < DC; ++j) cand[j] = INF_E;
                const int m = s_item[it];
                const int i = m & (FAB_TN - 1);
                if (it < sh_items) {
#pragma unroll
                    for (int c = 0; c < FAB_CHUNK; ++c) {
                        const int2 e = s_ent[it * FAB_CHUNK + c];
                        // an INF_E weight never lowers a word
                        if (e.y >= INF_E || e.x == root) continue;
                        const int nb = min(max(e.x, 0), hi);
#pragma unroll
                        for (int j = 0; j < DC; ++j)
                            if (j < dn)
                                cand[j] =
                                    min(cand[j], rows[j * n_cap + nb] + e.y);
                    }
                } else {
                    const int j0 = (m >> 5) * FAB_CHUNK;
                    const int e_n = min(FAB_CHUNK, s_ext[i] - j0);
                    const long long at = (long long)s_row[i] * kr_cap + j0;
                    for (int c = 0; c < e_n; ++c) {
                        const int w = res_w[at + c];
                        const int nbr = res_nbr[at + c];
                        if (w >= INF_E || nbr == root) continue;
                        const int nb = min(max(nbr, 0), hi);
#pragma unroll
                        for (int j = 0; j < DC; ++j)
                            if (j < dn)
                                cand[j] = min(cand[j], rows[j * n_cap + nb] + w);
                    }
                }
#pragma unroll
                for (int j = 0; j < DC; ++j)
                    if (j < dn && cand[j] < INF_E)
                        atomicMin(&s_acc[(s * DC + j) * FAB_TN + i], cand[j]);
            }
            __syncthreads();
            // phase 2: the words, 32 neighbouring nodes a warp
            for (int w = t; w < FAB_RS * DC * FAB_TN; w += FAB_THREADS) {
                const int s = w / (DC * FAB_TN);
                const int j = (w / FAB_TN) % DC;
                const int v = v0 + w % FAB_TN;
                const int root = s_root[s];
                if (root < 0 || j >= dn || v >= n_cap) continue;
                const long long o =
                    (rb0 + s0 + s) * plane + (long long)(d0 + j) * n_cap;
                const int* row = dist + o;
                const int cur = row[v];
                int acc = min(cur, s_acc[w]);
                s_acc[w] = INF_E;
                for (int k = 0; k < s_cap; ++k) {
                    if (live && !__ldg(live + k)) continue;
                    int src = v - __ldg(deltas + k);
                    src += src < 0 ? n_cap : (src >= n_cap ? -n_cap : 0);
                    const unsigned lc = (unsigned)(src - col0);
                    if (src == root || lc >= (unsigned)w_cols) continue;
                    acc = min(acc,
                              row[src] + __ldg(sw + (long long)k * w_cols + lc));
                }
                out[o + v] = acc;
                if (acc < cur) {
                    s_hit[s] = 1;
                    changed = 1;
                }
            }
            __syncthreads();
        }
        if (t < FAB_RS && s_hit[t]) {
            if (gate.st) gate_put(gate, rb0 + s0 + t);
            s_hit[t] = 0;
        }
    }
    if (__syncthreads_or(changed) && t == 0 && flag) atomicOr(flag, 1);
}

// K21e: ext[r] = 1 + the last column of residual row r whose weight is
// finite (< INF_E), 0 for a row with none (entries past it cannot lower
// a word: K21 reads a row up to there); live[k] = 1 where class row k of
// the member's window holds a finite weight, else 0 (K21 runs only
// those). One launch a step: blocks [0, row_blocks) a thread a row, then
// one block a class row.
__global__ void fabric_extent_kernel(const int* __restrict__ res_w,
                                     int* __restrict__ ext, int r_cap,
                                     int kr_cap, const int* __restrict__ sw,
                                     int* __restrict__ live, int w_cols,
                                     int row_blocks) {
    if ((int)blockIdx.x < row_blocks) {
        const int r = blockIdx.x * blockDim.x + threadIdx.x;
        if (r >= r_cap) return;
        const int* row = res_w + (long long)r * kr_cap;
        int e = 0;
        for (int j = 0; j < kr_cap; ++j)
            if (row[j] < INF_E) e = j + 1;
        ext[r] = e;
        return;
    }
    const int k = blockIdx.x - row_blocks;
    const int* row = sw + (long long)k * w_cols;
    int any = 0;
    for (int c = threadIdx.x; c < w_cols; c += blockDim.x)
        any |= row[c] < INF_E;
    any = __syncthreads_or(any);
    if (threadIdx.x == 0) live[k] = any;
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

template <int DC>
static int launch_fabric(const int* dist, int* out, const int* deltas,
                         const int* sw, const int* live, const int* roots,
                         const int* res_nbr, const int* res_w, const int* ext,
                         const int* row_of, int d_cap, int n_cap, int s_cap,
                         int col0, int w_cols, int kr_cap, int* flag, int g,
                         Gate gate, cudaStream_t stream) {
    const int items =
        row_of ? FAB_TN * ((kr_cap + FAB_CHUNK - 1) / FAB_CHUNK) : 0;
    const int ent_cap = min(items * FAB_CHUNK, FAB_ENT_MAX);
    const size_t smem =
        (size_t)ent_cap * sizeof(int2) + ((2 * items + 15) & ~15);
    // the kernel's static arrays (s_acc, s_row, s_ext, s_root, s_hit,
    // s_items) and the dynamic copy past 48 KB need the opt-in
    const size_t fixed = sizeof(int) * (FAB_RS * DC * FAB_TN + 2 * FAB_TN +
                                        2 * FAB_RS + 1);
    if (smem + fixed > 48 * 1024) {
        const cudaError_t rc = cudaFuncSetAttribute(
            (const void*)fabric_relax_kernel<DC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (rc != cudaSuccess) return (int)rc;
    }
    const dim3 grid((n_cap + FAB_TN - 1) / FAB_TN,
                    (g + FAB_ROOTS - 1) / FAB_ROOTS);
    fabric_relax_kernel<DC><<<grid, FAB_THREADS, smem, stream>>>(
        dist, out, deltas, sw, live, roots, res_nbr, res_w, ext, row_of,
        d_cap, n_cap, s_cap, col0, w_cols, kr_cap, ent_cap, flag, g, gate);
    return (int)cudaGetLastError();
}

extern "C" {

// One K21 relaxation: row chunk DC of 8, 4, 2 or 1 (the smallest that
// holds d_cap, at most 8). live may be null (every class runs); row_of
// null means no residual (res_nbr, res_w, ext unread).
int fabric_relax(const int* dist, int* out, const int* deltas, const int* sw,
                 const int* live, const int* roots, const int* res_nbr,
                 const int* res_w, const int* ext, const int* row_of,
                 int d_cap, int n_cap, int s_cap, int col0, int w_cols,
                 int kr_cap, int* flag, int g, int* st, int* cnt, int thr0,
                 int thr1, int put0, int put1, int inc0, int inc1,
                 cudaStream_t stream) {
    Gate gate = {st, cnt, thr0, thr1, put0, put1, inc0, inc1};
    if (g < 1 || n_cap < 1 || d_cap < 1 ||
        (long long)d_cap * n_cap > 0x7fffffffLL ||
        (g + FAB_ROOTS - 1) / FAB_ROOTS > 65535 ||
        (row_of && (kr_cap < 1 || kr_cap > 16 * 1024)))
        return (int)cudaErrorInvalidValue;
    if (d_cap > 4)
        return launch_fabric<8>(dist, out, deltas, sw, live, roots, res_nbr,
                                res_w, ext, row_of, d_cap, n_cap, s_cap, col0,
                                w_cols, kr_cap, flag, g, gate, stream);
    if (d_cap > 2)
        return launch_fabric<4>(dist, out, deltas, sw, live, roots, res_nbr,
                                res_w, ext, row_of, d_cap, n_cap, s_cap, col0,
                                w_cols, kr_cap, flag, g, gate, stream);
    if (d_cap > 1)
        return launch_fabric<2>(dist, out, deltas, sw, live, roots, res_nbr,
                                res_w, ext, row_of, d_cap, n_cap, s_cap, col0,
                                w_cols, kr_cap, flag, g, gate, stream);
    return launch_fabric<1>(dist, out, deltas, sw, live, roots, res_nbr,
                            res_w, ext, row_of, d_cap, n_cap, s_cap, col0,
                            w_cols, kr_cap, flag, g, gate, stream);
}

// res_w may be null (r_cap 0: no residual rows), sw null (s_cap 0)
int fabric_extent(const int* res_w, int* ext, int r_cap, int kr_cap,
                  const int* sw, int* live, int s_cap, int w_cols,
                  cudaStream_t stream) {
    const int row_blocks = (r_cap + THREADS - 1) / THREADS;
    if (row_blocks + s_cap < 1) return 0;
    fabric_extent_kernel<<<row_blocks + s_cap, THREADS, 0, stream>>>(
        res_w, ext, r_cap, kr_cap, sw, live, w_cols, row_blocks);
    return (int)cudaGetLastError();
}

int unpack_bits(const int* words, uint8_t* bits, long long m, int w, int x,
                cudaStream_t stream) {
    unpack_bits_kernel<<<grid_for(m * x, 1), THREADS, 0, stream>>>(
        words, bits, m, w, x);
    return (int)cudaGetLastError();
}

}  // extern "C"
