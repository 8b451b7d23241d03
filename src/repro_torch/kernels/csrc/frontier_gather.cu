// One sampling hop's adjacency words through the tiered edge-page store.
// Two entry points:
//
// frontier_read, the topology plane's data path: for each of a hop's N
// edge positions,
//   p = pos[n] / W, off = pos[n] % W, s = page_table[p]
//   out[n] = s >= 0 ? hot[s][off] : words[pos[n]]
// `hot` is the (H, W) array of device-resident edge pages, `words` the
// whole (E,) adjacency in pinned host memory, read in place over PCIe
// through its device mapping at the raw position; W = words per 4 KB page.
// A hot page's words are read only from `hot`, never over PCIe.
//
// frontier_gather, the JAX package's contract over a hop's P unique pages:
//   s = page_slots[inverse[n]]
//   out[n] = s >= 0 ? hot[s][offsets[n]] : staged[inverse[n]][offsets[n]]
// (only the staged rows of pages that are not resident are read).
//
// Both are pure word copies: bit-identical to the plain versions for int32
// and int64 words.
//
// Replaces the Pallas TPU kernel `frontier_gather`
// (src/repro/kernels/tiered_gather.py:277; `ops.tiered_frontier_gather`
// src/repro/kernels/ops.py:57).  The TPU version fetches every unique page
// whole through `tiered_gather` (one (1, bd) DMA per page row, :293) and
// then extracts the words with one vectorized take (:296), after the host
// deduplicated the pages and staged the non-resident ones.  Here a read
// fetches only its own word where its tier keeps it: frontier_read takes
// the raw positions, so the host neither deduplicates nor stages, and a
// non-resident word crosses PCIe as one 32-byte sector instead of inside a
// copied 4 KB page.
//
// Bound on an H100 SXM: frontier_read reads 8 B of position, a 4 B page
// table entry and a word per read and writes the word; a 15k-read hop is
// ~0.3 MB of device memory, 0.1 us at 3.35 TB/s, and ~2/3 of its reads are
// host sectors of 32 B over PCIe (~63 GB/s for Gen5 x16).  Both are far below one launch: the
// kernel is latency-bound, a chain of three dependent loads per read
// (position, page table, word), the last ~1-2 us over PCIe for a cold
// word.  One read per thread in 128-thread blocks puts every read's chain
// in flight at once (a 25,600-read hop is 200 blocks); a power-of-two W
// takes a shift and a mask instead of a 64-bit division.
//
// Left for later PRs: the cold reads stay latency-bound well above their
// PCIe bound; reading each touched 32-byte sector once per warp and
// sharing it across the lanes that need it, or overlapping a hop's H2D of
// positions with the previous hop's host work, would shorten a call.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kReadThreads = 128;

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

template <typename W, bool kPow2>
__global__ void frontier_read_kernel(const int64_t* __restrict__ pos,
                                     const int32_t* __restrict__ page_table,
                                     const W* __restrict__ hot,
                                     const W* __restrict__ words,
                                     W* __restrict__ out, int64_t N,
                                     int64_t page_words, int shift) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kReadThreads +
                    threadIdx.x;
  if (n >= N) return;
  const int64_t q = pos[n];
  const int64_t p = kPow2 ? q >> shift : q / page_words;
  const int64_t off = kPow2 ? q & (page_words - 1) : q - p * page_words;
  const int32_t s = page_table[p];
  out[n] = s >= 0 ? hot[static_cast<int64_t>(s) * page_words + off]
                  : words[q];
}

template <typename W>
void launch_read(const void* pos, const void* page_table, const void* hot,
                 const void* words, void* out, int64_t N, int64_t page_words,
                 cudaStream_t s) {
  const unsigned blocks =
      static_cast<unsigned>((N + kReadThreads - 1) / kReadThreads);
  const int64_t* q = static_cast<const int64_t*>(pos);
  const int32_t* t = static_cast<const int32_t*>(page_table);
  const W* h = static_cast<const W*>(hot);
  const W* c = static_cast<const W*>(words);
  W* o = static_cast<W*>(out);
  if ((page_words & (page_words - 1)) == 0) {
    int shift = 0;
    while ((int64_t{1} << shift) < page_words) ++shift;
    frontier_read_kernel<W, true><<<blocks, kReadThreads, 0, s>>>(
        q, t, h, c, o, N, page_words, shift);
  } else {
    frontier_read_kernel<W, false><<<blocks, kReadThreads, 0, s>>>(
        q, t, h, c, o, N, page_words, 0);
  }
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

// pos (N,) int64 in [0, E); page_table (n_pages,) int32, -1 off the hot
// tier; hot (H, page_words) in device memory and words (E,) through a
// device pointer of mapped host memory (frontier_mapped_pointer), words of
// word_bytes 4 (int32) or 8 (int64); out (N,).  Every entry s >= 0 of the
// page table must index a hot row.  Returns cudaErrorInvalidValue for any
// other word size or a page_words < 1.
extern "C" int frontier_read(const void* pos, const void* page_table,
                             const void* hot, const void* words, void* out,
                             long long N, long long page_words,
                             int word_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (page_words < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (word_bytes == 4) {
    launch_read<int32_t>(pos, page_table, hot, words, out, N, page_words, s);
  } else if (word_bytes == 8) {
    launch_read<int64_t>(pos, page_table, hot, words, out, N, page_words, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The device pointer through which a kernel reads the host memory at
// `host` (pinned by cudaHostAlloc or cudaHostRegister and mapped into the
// device's address space), written to *device_ptr.  Returns
// cudaErrorInvalidValue if the memory is not host memory that the device
// can address, or the error of cudaPointerGetAttributes.
extern "C" int frontier_mapped_pointer(const void* host, void** device_ptr) {
  cudaPointerAttributes attr;
  const cudaError_t err = cudaPointerGetAttributes(&attr, host);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not report it
    return static_cast<int>(err);
  }
  if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *device_ptr = attr.devicePointer;
  return 0;
}
