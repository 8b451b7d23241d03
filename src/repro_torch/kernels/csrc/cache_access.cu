// cache_access: lookup + fill of the window-buffered, set-associative device
// cache for one batch of B requests, with the metadata updated in place.
//
// Replaces `access` in src/repro/core/cache_jax.py:70-128.  That function is
// not Pallas: it is a jnp `fori_loop` over the B requests, so request order
// decides the result.  Requests in different sets never touch the same
// state, so here one thread owns one set and walks the requests that hash to
// it in request order.  Each block stages tiles of the per-request set index
// in shared memory and every thread scans the tile for its own set.
//
// The per-request rule is the reference's, exactly:
//   hit    (first way whose tag equals the id): reuse = max(reuse - 1, 0)
//   fill   (miss): the first empty way (tag -1), else the first way whose
//          reuse is 0; the tag becomes the id and reuse its future count
//   bypass (miss, no such way): nothing changes
// and ids < 0 are padding that change nothing.  The set of id n is
// ((uint32)n * 0x9E3779B9) >> 8 mod num_sets, a wrapping 32-bit multiply.
//
// Besides hit mask, slot per request and the three running counters, it
// writes what a correct row store needs (the reference's device_gather gets
// this wrong, see ROADMAP.md Queue 3):
//   serve[i]        the slot of a hit whose line no earlier request of this
//                   call filled, else -1 (served from the staged row, which
//                   holds the same bytes)
//   last_filler[l]  the request whose row line l holds after the call, or
//                   -1 if no request filled it (store_fill consumes it)
//
// Bound on an H100 SXM (3.35 TB/s): memory in principle (ids, future counts
// and outputs once, tags and reuse read and written once), but this simple
// design is latency-bound: every thread scans all B set indices, and only
// num_sets threads exist (2048 at the main path's 16384 lines x 8 ways).
//
// Left for later PRs: bucket requests by set first (a counting sort) so a
// thread reads only its own requests, and keep each set's ways in registers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 2048;

__global__ void set_of_kernel(const int32_t* __restrict__ ids,
                              int32_t* __restrict__ sets,
                              bool* __restrict__ hit,
                              int32_t* __restrict__ slot,
                              int32_t* __restrict__ serve, int B,
                              int num_sets) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int32_t n = ids[i];
  const uint32_t h = (static_cast<uint32_t>(n) * 0x9E3779B9u) >> 8;
  sets[i] = n >= 0 ? static_cast<int32_t>(h % static_cast<uint32_t>(num_sets))
                   : -1;
  hit[i] = false;
  slot[i] = -1;
  serve[i] = -1;
}

__global__ void access_kernel(const int32_t* __restrict__ ids,
                              const int32_t* __restrict__ future_counts,
                              const int32_t* __restrict__ sets, int B,
                              int32_t* __restrict__ tags,
                              int32_t* __restrict__ reuse,
                              const int32_t* __restrict__ slot_table,
                              int num_sets, int ways, bool* __restrict__ hit,
                              int32_t* __restrict__ slot,
                              int32_t* __restrict__ serve,
                              int32_t* __restrict__ last_filler,
                              unsigned long long* __restrict__ n_hits,
                              unsigned long long* __restrict__ n_misses,
                              unsigned long long* __restrict__ n_bypasses) {
  __shared__ int32_t tile[kTile];
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool owner = s < num_sets;
  const int64_t base = static_cast<int64_t>(s) * ways;
  if (owner) {
    for (int w = 0; w < ways; ++w) last_filler[slot_table[base + w]] = -1;
  }
  uint64_t filled = 0;  // ways filled by an earlier request of this call
  unsigned long long hits = 0, misses = 0, bypasses = 0;

  for (int start = 0; start < B; start += kTile) {
    const int n = min(kTile, B - start);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      tile[k] = sets[start + k];
    }
    __syncthreads();
    if (!owner) continue;
    for (int k = 0; k < n; ++k) {
      if (tile[k] != s) continue;
      const int i = start + k;
      const int32_t id = ids[i];
      int way_hit = -1, way_empty = -1, way_safe = -1;
      for (int w = 0; w < ways; ++w) {
        const int32_t t = tags[base + w];
        if (way_hit < 0 && t == id) way_hit = w;
        if (way_empty < 0 && t == -1) way_empty = w;
        if (way_safe < 0 && reuse[base + w] == 0) way_safe = w;
      }
      if (way_hit >= 0) {
        const int32_t r = reuse[base + way_hit];
        reuse[base + way_hit] = r > 0 ? r - 1 : 0;
        const int32_t line = slot_table[base + way_hit];
        hit[i] = true;
        slot[i] = line;
        serve[i] = (filled >> way_hit) & 1u ? -1 : line;
        ++hits;
        continue;
      }
      ++misses;
      const int way = way_empty >= 0 ? way_empty : way_safe;
      if (way < 0) {
        ++bypasses;
        continue;
      }
      tags[base + way] = id;
      reuse[base + way] = future_counts[i];
      const int32_t line = slot_table[base + way];
      slot[i] = line;
      filled |= uint64_t{1} << way;
      last_filler[line] = i;
    }
  }
  if (hits) atomicAdd(n_hits, hits);
  if (misses) atomicAdd(n_misses, misses);
  if (bypasses) atomicAdd(n_bypasses, bypasses);
}

}  // namespace

// ids, future_counts, sets (work buffer), slot, serve: (B,) int32; hit: (B,)
// bool; tags, reuse, slot_table: (num_sets, ways) int32, tags and reuse
// updated in place; last_filler: (num_sets * ways,) int32; the counters are
// int64 scalars incremented in place.  ways <= 64.
extern "C" int cache_access(const void* ids, const void* future_counts,
                            void* sets, int B, void* tags, void* reuse,
                            const void* slot_table, int num_sets, int ways,
                            void* hit, void* slot, void* serve,
                            void* last_filler, void* n_hits, void* n_misses,
                            void* n_bypasses, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    set_of_kernel<<<(B + 255) / 256, 256, 0, s>>>(
        static_cast<const int32_t*>(ids), static_cast<int32_t*>(sets),
        static_cast<bool*>(hit), static_cast<int32_t*>(slot),
        static_cast<int32_t*>(serve), B, num_sets);
  }
  access_kernel<<<(num_sets + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const int32_t*>(ids),
      static_cast<const int32_t*>(future_counts),
      static_cast<const int32_t*>(sets), B, static_cast<int32_t*>(tags),
      static_cast<int32_t*>(reuse), static_cast<const int32_t*>(slot_table),
      num_sets, ways, static_cast<bool*>(hit), static_cast<int32_t*>(slot),
      static_cast<int32_t*>(serve), static_cast<int32_t*>(last_filler),
      static_cast<unsigned long long*>(n_hits),
      static_cast<unsigned long long*>(n_misses),
      static_cast<unsigned long long*>(n_bypasses));
  return static_cast<int>(cudaGetLastError());
}
