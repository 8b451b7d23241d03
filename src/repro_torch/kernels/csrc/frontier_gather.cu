// frontier_gather: one sampling hop's adjacency words through the tiered
// edge-page store,
//   s = page_slots[inverse[n]]
//   out[n] = s >= 0 ? hot[s][offsets[n]] : staged[inverse[n]][offsets[n]]
// for the hop's N edge reads.  `hot` is the (H, W) array of device-resident
// edge pages, `staged` the (P, W) rows of the hop's P unique pages (only the
// rows of pages that are not resident are read), W = words per 4 KB page.
// A pure word copy: bit-identical to the plain version for int32 and int64
// words.
//
// Replaces the Pallas TPU kernel `frontier_gather`
// (src/repro/kernels/tiered_gather.py:277; `ops.tiered_frontier_gather`
// src/repro/kernels/ops.py:57).  The TPU version fetches every unique page
// whole through `tiered_gather` (one (1, bd) DMA per page row, :293) and
// then extracts the words with one vectorized take (:296).  Here the two
// steps are fused: one thread per read loads its page slot and the one word
// it needs, so a hop reads about 20 bytes per read (inverse, offset, slot,
// word, output) instead of whole 4 KB pages.  The output is the same.
//
// Bound on an H100 SXM: about 20 B per read (4 + 4 + 4 + 4 or 8 + 4 or 8),
// about 0.3 MB or 0.09 us for a 15k-read hop at 3.35 TB/s.  Far below one
// launch, so it is latency-bound: every read is a dependent chain of three
// loads (inverse, then slot, then word).
//
// Left for later PRs: the host builds the unique pages, inverse and offsets
// and stages the non-resident pages whole; moving that dedup onto the card
// (a sort or a hash over the read positions) and reading non-resident words
// zero-copy from pinned host memory would remove the staging copy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename W>
__global__ void frontier_gather_kernel(const int32_t* __restrict__ page_slots,
                                       const W* __restrict__ hot,
                                       const W* __restrict__ staged,
                                       const int32_t* __restrict__ inverse,
                                       const int32_t* __restrict__ offsets,
                                       W* __restrict__ out, int64_t N,
                                       int64_t page_words) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= N) return;
  const int64_t p = inverse[n];
  const int32_t s = page_slots[p];
  const int64_t off = offsets[n];
  out[n] = s >= 0 ? hot[static_cast<int64_t>(s) * page_words + off]
                  : staged[p * page_words + off];
}

template <typename W>
void launch(const void* page_slots, const void* hot, const void* staged,
            const void* inverse, const void* offsets, void* out, int64_t N,
            int64_t page_words, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((N + kThreads - 1) / kThreads);
  frontier_gather_kernel<W><<<blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(page_slots), static_cast<const W*>(hot),
      static_cast<const W*>(staged), static_cast<const int32_t*>(inverse),
      static_cast<const int32_t*>(offsets), static_cast<W*>(out), N,
      page_words);
}

}  // namespace

// page_slots (P,), inverse (N,), offsets (N,) int32; hot (H, page_words) and
// staged (P, page_words) of word_bytes 4 (int32) or 8 (int64); out (N,).
// Every inverse entry must index a unique page, every slot >= 0 a hot row,
// every offset a word of the page.  Returns cudaErrorInvalidValue for any
// other word size.
extern "C" int frontier_gather(const void* page_slots, const void* hot,
                               const void* staged, const void* inverse,
                               const void* offsets, void* out, long long N,
                               long long page_words, int word_bytes,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (word_bytes == 4) {
    launch<int32_t>(page_slots, hot, staged, inverse, offsets, out, N,
                    page_words, s);
  } else if (word_bytes == 8) {
    launch<int64_t>(page_slots, hot, staged, inverse, offsets, out, N,
                    page_words, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
