// Shared by the sources whose kernels launch cooperatively
// (cudaLaunchCooperativeKernel: relax.cu's ladder pick and pass,
// compact.cu's route tail, incremental.cu's cone). ops/cuda.py hashes this header into every
// library's name, so an edit rebuilds them all.

#pragma once
#include <cuda_runtime.h>

// The largest grid a cooperative launch of `fn` (`threads` threads, no
// dynamic shared memory) takes on the current card, at most `per_sm`
// blocks an SM: every block co-resident. Cached per card in `cache`.
static int coop_grid(const void* fn, int threads, int per_sm, int* cache) {
    int card = 0;
    cudaGetDevice(&card);
    int v = card < 64 ? cache[card] : 0;
    if (!v) {
        int sms = 0, occ = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, card);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, threads, 0);
        v = sms * (occ < per_sm ? occ : per_sm);
        if (card < 64) cache[card] = v;
    }
    return v;
}
