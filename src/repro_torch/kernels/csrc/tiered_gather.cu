// tiered_gather: out[i] = slots[i] >= 0 ? cache[slots[i]] : staged[i],
// tiered_gather_unique: out[n] = the same over U unique rows, expanded by
// inverse: u = inverse[n], out[n] = slots[u] >= 0 ? cache[slots[u]]
// : staged[u], and
// store_fill: rows[l] = staged[last_filler[l]] for every line l that a
// request filled in this call (last_filler[l] >= 0).  All three are pure row
// copies, so their output is bit-identical to the plain versions for any
// dtype.
//
// Staged rows, with or without a map.  Without one (staged_map null) the
// staged buffer holds one row per request, and request r's staged row is
// staged[r]: the JAX package's contract.  With one, the buffer holds only
// the M rows the card reads from it, compacted in request order: the
// device tier stages and copies the rows of the requests its cache access
// did not serve from the row store (serve slot -1: misses, bypasses, and
// hits on a line an earlier request of the call filled), and
// staged_map[r] is request r's row in that buffer, -1 for a request served
// from the row store.  Each kernel reads the map only on its staged branch,
// where the entry is always a real row: staged[staged_map[r]] in place of
// staged[r].  A filler is always a request read from the staged buffer.
//
// tiered_gather replaces the Pallas TPU kernel `tiered_gather`
// (src/repro/kernels/tiered_gather.py:154; `_single_row_kernel` :76 via
// `pallas_call` :111, `_kernel` :57 via `pallas_call` :136).  The TPU
// version prefetches the slot table to SMEM and DMAs one (1, bd) cache row
// per grid step, padding B with -1 slots and shrinking or padding D.  Here
// one warp copies one row: the warp reads its slot, picks the cache or the
// staged row, and its 32 lanes stride over the row in words.  No padding
// copy is made for any B or D.  store_fill replaces the row-store scatter of
// src/repro/core/device_store.py:48 (a jnp `.at[].set`, not a Pallas
// kernel); it runs after the gather, so a hit is always served the bytes
// the line held before this call's fills land.
//
// tiered_gather_unique replaces the Pallas TPU kernel `tiered_gather_unique`
// (src/repro/kernels/tiered_gather.py:235; `_unique_row_kernel` via
// `pallas_call` :226, whose index maps send the scalar-prefetched inverse
// into both the cache-row and the staged-tile DMA, or the blocked gather of
// the U unique rows followed by a `jnp.take`).  Here one warp writes one
// output row n: it reads u = inverse[n] and s = slots[u] and copies the
// cache row or unique staged row u.  The duplicated (N, D) staged buffer is
// never built and the unique rows are not gathered first: each output row
// is read once from where it lies.  The merged-window executor launches it
// once per batch of a window, over the window's U unique rows, all before
// the window's store_fill.
//
// Word width: the widest of 16, 8, 4, 2 and 1 bytes that divides the row
// width in bytes and the alignment of every base pointer.  A 1024-wide f32
// row is 256 16-byte words; a ragged width falls to a narrower word for the
// whole row rather than a vector body plus a scalar tail, because row
// starts are then not 16-byte aligned either.
//
// Bound on an H100 SXM (3.35 TB/s): memory, 2 * B * D * itemsize bytes
// (each served row read once and written once) plus the 4-byte slots; for
// tiered_gather_unique 2 * N * D * itemsize plus 8 * N bytes (the inverse
// and one slot per output row), about 67 MB or 0.020 ms for one batch of
// N = 8192 1024-d f32 rows.  A map adds 4 bytes per staged row read.
//
// Left for later PRs: cp.async.bulk / TMA row copies (one thread issues a
// whole 4 KB row), several rows in flight per warp, fusing store_fill into
// the staged-row read of the gather, and one launch per window instead of
// one per batch (a batch index per output row).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps, 8 rows per block
constexpr int kRowsPerBlock = kThreads / 32;

// Row r of the staged buffer: r itself without a map, else its map entry.
__device__ __forceinline__ int64_t staged_row(const int32_t* staged_map,
                                              int64_t r) {
  return staged_map ? static_cast<int64_t>(staged_map[r]) : r;
}

template <typename W>
__global__ void tiered_gather_kernel(const int32_t* __restrict__ slots,
                                     const W* __restrict__ cache,
                                     const W* __restrict__ staged,
                                     const int32_t* __restrict__ staged_map,
                                     W* __restrict__ out, int64_t B,
                                     int64_t row_words) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;
  const int lane = threadIdx.x & 31;
  const int32_t s = slots[row];
  const W* src = s >= 0 ? cache + static_cast<int64_t>(s) * row_words
                        : staged + staged_row(staged_map, row) * row_words;
  W* dst = out + row * row_words;
  for (int64_t k = lane; k < row_words; k += 32) dst[k] = src[k];
}

template <typename W>
__global__ void tiered_gather_unique_kernel(
    const int32_t* __restrict__ slots, const int32_t* __restrict__ inverse,
    const W* __restrict__ cache, const W* __restrict__ staged,
    const int32_t* __restrict__ staged_map, W* __restrict__ out, int64_t N,
    int64_t row_words) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;
  const int lane = threadIdx.x & 31;
  const int64_t u = inverse[row];
  const int32_t s = slots[u];
  const W* src = s >= 0 ? cache + static_cast<int64_t>(s) * row_words
                        : staged + staged_row(staged_map, u) * row_words;
  W* dst = out + row * row_words;
  for (int64_t k = lane; k < row_words; k += 32) dst[k] = src[k];
}

template <typename W>
__global__ void store_fill_kernel(const int32_t* __restrict__ last_filler,
                                  const W* __restrict__ staged,
                                  const int32_t* __restrict__ staged_map,
                                  W* __restrict__ rows, int64_t L,
                                  int64_t row_words) {
  const int64_t line =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (line >= L) return;
  const int32_t filler = last_filler[line];
  if (filler < 0) return;
  const int lane = threadIdx.x & 31;
  const W* src = staged + staged_row(staged_map, filler) * row_words;
  W* dst = rows + line * row_words;
  for (int64_t k = lane; k < row_words; k += 32) dst[k] = src[k];
}

int word_bytes(int64_t row_bytes, const void* a, const void* b,
               const void* c) {
  const uintptr_t mix = reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(c) |
                        static_cast<uintptr_t>(row_bytes);
  for (int w = 16; w > 1; w >>= 1) {
    if (mix % w == 0) return w;
  }
  return 1;
}

struct alignas(8) Word8 { uint32_t a, b; };

template <typename W>
void gather(const void* slots, const void* cache, const void* staged,
            const void* staged_map, void* out, int64_t B, int64_t row_bytes,
            cudaStream_t s) {
  const unsigned blocks =
      static_cast<unsigned>((B + kRowsPerBlock - 1) / kRowsPerBlock);
  tiered_gather_kernel<W><<<blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(slots), static_cast<const W*>(cache),
      static_cast<const W*>(staged), static_cast<const int32_t*>(staged_map),
      static_cast<W*>(out), B, row_bytes / static_cast<int64_t>(sizeof(W)));
}

template <typename W>
void gather_unique(const void* slots, const void* inverse, const void* cache,
                   const void* staged, const void* staged_map, void* out,
                   int64_t N, int64_t row_bytes, cudaStream_t s) {
  const unsigned blocks =
      static_cast<unsigned>((N + kRowsPerBlock - 1) / kRowsPerBlock);
  tiered_gather_unique_kernel<W><<<blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(inverse),
      static_cast<const W*>(cache), static_cast<const W*>(staged),
      static_cast<const int32_t*>(staged_map), static_cast<W*>(out), N,
      row_bytes / static_cast<int64_t>(sizeof(W)));
}

template <typename W>
void fill(const void* last_filler, const void* staged, const void* staged_map,
          void* rows, int64_t L, int64_t row_bytes, cudaStream_t s) {
  const unsigned blocks =
      static_cast<unsigned>((L + kRowsPerBlock - 1) / kRowsPerBlock);
  store_fill_kernel<W><<<blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(last_filler), static_cast<const W*>(staged),
      static_cast<const int32_t*>(staged_map), static_cast<W*>(rows), L,
      row_bytes / static_cast<int64_t>(sizeof(W)));
}

}  // namespace

// row_bytes = D * itemsize of the staged / out and (L, D) cache rows.  out is
// (B, D); staged is (B, D) with a null staged_map, else (M, D) with
// staged_map (B,) int32.
extern "C" int tiered_gather(const void* slots, const void* cache,
                             const void* staged, const void* staged_map,
                             void* out, long long B, long long row_bytes,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* m = staged_map;
  switch (word_bytes(row_bytes, cache, staged, out)) {
    case 16:
      gather<uint4>(slots, cache, staged, m, out, B, row_bytes, s);
      break;
    case 8:
      gather<Word8>(slots, cache, staged, m, out, B, row_bytes, s);
      break;
    case 4:
      gather<uint32_t>(slots, cache, staged, m, out, B, row_bytes, s);
      break;
    case 2:
      gather<uint16_t>(slots, cache, staged, m, out, B, row_bytes, s);
      break;
    default: gather<uint8_t>(slots, cache, staged, m, out, B, row_bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// slots (U,) and inverse (N,) int32, cache (L, D), out (N, D); staged (U, D)
// with a null staged_map, else (M, D) with staged_map (U,) int32;
// row_bytes = D * itemsize.  Every inverse entry must index a unique row.
extern "C" int tiered_gather_unique(const void* slots, const void* inverse,
                                    const void* cache, const void* staged,
                                    const void* staged_map, void* out,
                                    long long N, long long row_bytes,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* m = staged_map;
  switch (word_bytes(row_bytes, cache, staged, out)) {
    case 16:
      gather_unique<uint4>(slots, inverse, cache, staged, m, out, N, row_bytes,
                           s);
      break;
    case 8:
      gather_unique<Word8>(slots, inverse, cache, staged, m, out, N, row_bytes,
                           s);
      break;
    case 4:
      gather_unique<uint32_t>(slots, inverse, cache, staged, m, out, N,
                              row_bytes, s);
      break;
    case 2:
      gather_unique<uint16_t>(slots, inverse, cache, staged, m, out, N,
                              row_bytes, s);
      break;
    default:
      gather_unique<uint8_t>(slots, inverse, cache, staged, m, out, N,
                             row_bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// last_filler (L,) int32: request index whose staged row line l must hold
// after the call, -1 for lines no request filled; staged_map as for
// tiered_gather (null: staged row r is request r's).  rows is (L, D),
// updated in place.
extern "C" int store_fill(const void* last_filler, const void* staged,
                          const void* staged_map, void* rows, long long L,
                          long long row_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* m = staged_map;
  switch (word_bytes(row_bytes, staged, rows, rows)) {
    case 16: fill<uint4>(last_filler, staged, m, rows, L, row_bytes, s); break;
    case 8: fill<Word8>(last_filler, staged, m, rows, L, row_bytes, s); break;
    case 4:
      fill<uint32_t>(last_filler, staged, m, rows, L, row_bytes, s);
      break;
    case 2:
      fill<uint16_t>(last_filler, staged, m, rows, L, row_bytes, s);
      break;
    default: fill<uint8_t>(last_filler, staged, m, rows, L, row_bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}
