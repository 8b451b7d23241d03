// cache_access: lookup + fill of the window-buffered, set-associative device
// cache for one batch of B requests, with the metadata updated in place;
// cache_bucket: the stable counting sort of the requests by set that it
// walks.
//
// Replaces `access` in src/repro/core/cache_jax.py:70-128.  That function is
// not Pallas: it is a jnp `fori_loop` over the B requests, so request order
// decides the result.  Requests in different sets never touch the same
// state, and within a set only their order matters, so the requests are
// first bucketed by set with a stable counting sort (cache_bucket), and
// then one warp per set walks its own bucket in request order
// (cache_access).
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
// Bucketing (cache_bucket, three small kernels).  The key of request i is
// its set, or num_sets for padding, which so lands in a trailing bucket of
// its own and never in a set.  (1) One block per tile of kTile requests:
// a histogram of the tile's keys in shared memory, and each request's rank
// among the earlier requests of its tile with the same key, counted from
// the tile's keys in shared memory, so ranks follow request order and never
// the order in which atomics land.  (2) One block sums each key over the
// tiles and scans the totals into the bucket starts.  (3) order[start[key]
// + the key's count in earlier tiles + rank] = i.  `order` is then the
// stable argsort of the keys and start[s] .. start[s + 1] is set s's
// bucket.
//
// Walk (cache_access).  One warp per set: lanes 0..31 hold ways w and
// w + 32 (tag, reuse, line) in registers; a bucket's requests are loaded 32
// at a time, one per lane, and then decided one after another with
// __ballot_sync / __ffsll for the first matching, empty or safe way.  A
// set's tags and reuse are read and written once per call; each request's
// outputs are written by the lane that loaded it.  Counters are summed per
// block and added with one atomic each.
//
// Bound on an H100 SXM (3.35 TB/s): memory in principle (0.5-0.9 MB at the
// main paths' B 8192 / 28000 over 2048 sets x 8 ways, 0.2-0.3 us), but at
// these sizes launch latency and a few dependent passes over B ints bound
// it: four launches, each reading B ints or the 2049-column count matrix,
// and one serial walk per set of B / num_sets requests on average (4 and
// 14 at the main paths' B).  A hot set is serial by the reference's rule: one set
// holding n requests costs n dependent steps of one warp, a few shuffles
// each (chip_smoke.py times 4 sets of ~2,000 requests each).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;         // requests per bucketing tile and block
constexpr int kScanThreads = 1024;
constexpr int kWalkWarps = 8;
// bucket_count_kernel holds (num_sets + 1) int32 of histogram beside its
// static keys[kTile] in one block's shared memory, at most 227 KB on an H100
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxSets =
    (kMaxSmem - kTile * static_cast<int>(sizeof(int32_t))) /
        static_cast<int>(sizeof(int32_t)) - 1;   // 57087

__device__ __forceinline__ int key_of(int32_t n, int num_sets) {
  const uint32_t h = (static_cast<uint32_t>(n) * 0x9E3779B9u) >> 8;
  return n >= 0 ? static_cast<int>(h % static_cast<uint32_t>(num_sets))
                : num_sets;
}

// (1) per-tile histogram (counts[t * cols + key]) and in-tile stable rank
__global__ void __launch_bounds__(kTile)
    bucket_count_kernel(const int32_t* __restrict__ ids, int B, int num_sets,
                        int32_t* __restrict__ counts,
                        int32_t* __restrict__ rank) {
  extern __shared__ int32_t hist[];   // cols = num_sets + 1
  __shared__ __align__(16) int32_t keys[kTile];
  const int cols = num_sets + 1;
  const int k = threadIdx.x;
  const int i = blockIdx.x * kTile + k;
  for (int c = k; c < cols; c += kTile) hist[c] = 0;
  const int key = i < B ? key_of(ids[i], num_sets) : -1;
  keys[k] = key;
  __syncthreads();
  if (i < B) {
    atomicAdd(&hist[key], 1);         // a count: order-free
    int r = 0;
    const int4* k4 = reinterpret_cast<const int4*>(keys);
    int j = 0;
    for (; j + 4 <= k; j += 4) {
      const int4 v = k4[j >> 2];
      r += (v.x == key) + (v.y == key) + (v.z == key) + (v.w == key);
    }
    for (; j < k; ++j) r += keys[j] == key;
    rank[i] = r;
  }
  __syncthreads();
  int32_t* row = counts + static_cast<int64_t>(blockIdx.x) * cols;
  for (int c = k; c < cols; c += kTile) row[c] = hist[c];
}

// (2) one block: each key's total over the tiles, summed in shared memory
// from coalesced reads of the count rows, then an exclusive scan over keys:
// start[key] for key in [0, cols], start[cols] = B
__global__ void __launch_bounds__(kScanThreads)
    bucket_scan_kernel(const int32_t* __restrict__ counts, int tiles,
                       int cols, int B, int32_t* __restrict__ start) {
  extern __shared__ int32_t total[];  // cols
  __shared__ int32_t warp_sums[kScanThreads / 32];
  for (int c = threadIdx.x; c < cols; c += kScanThreads) total[c] = 0;
  __syncthreads();
  const int64_t cells = static_cast<int64_t>(tiles) * cols;
  for (int64_t idx = threadIdx.x; idx < cells; idx += kScanThreads) {
    const int v = counts[idx];
    if (v) atomicAdd(&total[idx % cols], v);
  }
  __syncthreads();
  const int per = (cols + kScanThreads - 1) / kScanThreads;
  const int c0 = min(cols, threadIdx.x * per), c1 = min(cols, c0 + per);
  int mine = 0;
  for (int c = c0; c < c1; ++c) mine += total[c];
  // exclusive scan of the per-thread sums over the block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;              // inclusive over warps
  }
  __syncthreads();
  int base = incl - mine + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int c = c0; c < c1; ++c) {
    start[c] = base;
    base += total[c];
  }
  if (threadIdx.x == 0) start[cols] = B;
}

// (3) stable scatter: a request's place is its bucket's start, the count
// of its key in earlier tiles, and its rank in its own tile
__global__ void __launch_bounds__(kTile)
    bucket_scatter_kernel(const int32_t* __restrict__ ids, int B,
                          int num_sets, const int32_t* __restrict__ counts,
                          const int32_t* __restrict__ start,
                          const int32_t* __restrict__ rank,
                          int32_t* __restrict__ order) {
  const int i = blockIdx.x * kTile + threadIdx.x;
  if (i >= B) return;
  const int key = key_of(ids[i], num_sets);
  int pos = start[key] + rank[i];
  for (int t = 0; t < static_cast<int>(blockIdx.x); ++t) {
    pos += counts[static_cast<int64_t>(t) * (num_sets + 1) + key];
  }
  order[pos] = i;
}

__device__ __forceinline__ uint64_t ballot64(bool lo, bool hi) {
  return static_cast<uint64_t>(__ballot_sync(0xffffffffu, lo)) |
         (static_cast<uint64_t>(__ballot_sync(0xffffffffu, hi)) << 32);
}

// one warp per set walks its bucket; the last block writes the padding's
// outputs
__global__ void __launch_bounds__(kWalkWarps * 32)
    walk_kernel(const int32_t* __restrict__ ids,
                const int32_t* __restrict__ future_counts,
                const int32_t* __restrict__ order,
                const int32_t* __restrict__ start, int B,
                int32_t* __restrict__ tags, int32_t* __restrict__ reuse,
                const int32_t* __restrict__ slot_table, int num_sets,
                int ways, bool* __restrict__ hit, int32_t* __restrict__ slot,
                int32_t* __restrict__ serve,
                int32_t* __restrict__ last_filler,
                unsigned long long* __restrict__ n_hits,
                unsigned long long* __restrict__ n_misses,
                unsigned long long* __restrict__ n_bypasses) {
  if (blockIdx.x == gridDim.x - 1) {
    for (int k = start[num_sets] + threadIdx.x; k < B; k += blockDim.x) {
      const int i = order[k];
      hit[i] = false;
      slot[i] = -1;
      serve[i] = -1;
    }
    return;
  }
  __shared__ unsigned long long sums[3][kWalkWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = blockIdx.x * kWalkWarps + warp;
  unsigned long long hits = 0, misses = 0, bypasses = 0;
  if (s < num_sets) {
    const int64_t base = static_cast<int64_t>(s) * ways;
    const int w0 = lane, w1 = lane + 32;
    const bool has0 = w0 < ways, has1 = w1 < ways;
    // absent ways: tag -2 (no id, not empty), reuse 1 (not safe)
    int32_t tag0 = has0 ? tags[base + w0] : -2;
    int32_t tag1 = has1 ? tags[base + w1] : -2;
    int32_t re0 = has0 ? reuse[base + w0] : 1;
    int32_t re1 = has1 ? reuse[base + w1] : 1;
    const int32_t line0 = has0 ? slot_table[base + w0] : -1;
    const int32_t line1 = has1 ? slot_table[base + w1] : -1;
    int32_t lf0 = -1, lf1 = -1;       // last filler of each way
    uint64_t filled = 0;              // ways filled earlier in this call
    const int b0 = start[s], b1 = start[s + 1];
    for (int c = b0; c < b1; c += 32) {
      const int n = min(32, b1 - c);
      const int my_i = lane < n ? order[c + lane] : 0;
      const int32_t my_id = lane < n ? ids[my_i] : 0;
      const int32_t my_fc = lane < n ? future_counts[my_i] : 0;
      bool my_hit = false;
      int32_t my_slot = -1, my_serve = -1;
      for (int j = 0; j < n; ++j) {
        const int32_t id = __shfl_sync(0xffffffffu, my_id, j);
        const uint64_t match = ballot64(tag0 == id, tag1 == id);
        if (match) {
          const int way = __ffsll(static_cast<long long>(match)) - 1;
          if (lane == (way & 31)) {
            if (way < 32) re0 = re0 > 0 ? re0 - 1 : 0;
            else re1 = re1 > 0 ? re1 - 1 : 0;
          }
          const int32_t line =
              __shfl_sync(0xffffffffu, way < 32 ? line0 : line1, way & 31);
          if (lane == j) {
            my_hit = true;
            my_slot = line;
            my_serve = (filled >> way) & 1u ? -1 : line;
          }
          ++hits;
          continue;
        }
        ++misses;
        const uint64_t empty = ballot64(tag0 == -1, tag1 == -1);
        const uint64_t safe = ballot64(re0 == 0, re1 == 0);
        const uint64_t cand = empty ? empty : safe;
        if (!cand) {
          ++bypasses;
          continue;
        }
        const int way = __ffsll(static_cast<long long>(cand)) - 1;
        const int32_t fc = __shfl_sync(0xffffffffu, my_fc, j);
        const int i = __shfl_sync(0xffffffffu, my_i, j);
        if (lane == (way & 31)) {
          if (way < 32) {
            tag0 = id;
            re0 = fc;
            lf0 = i;
          } else {
            tag1 = id;
            re1 = fc;
            lf1 = i;
          }
        }
        const int32_t line =
            __shfl_sync(0xffffffffu, way < 32 ? line0 : line1, way & 31);
        if (lane == j) my_slot = line;
        filled |= uint64_t{1} << way;
      }
      if (lane < n) {
        hit[my_i] = my_hit;
        slot[my_i] = my_slot;
        serve[my_i] = my_serve;
      }
    }
    if (b1 > b0) {
      if (has0) {
        tags[base + w0] = tag0;
        reuse[base + w0] = re0;
      }
      if (has1) {
        tags[base + w1] = tag1;
        reuse[base + w1] = re1;
      }
    }
    if (has0) last_filler[line0] = lf0;
    if (has1) last_filler[line1] = lf1;
  }
  if (lane == 0) {
    sums[0][warp] = hits;
    sums[1][warp] = misses;
    sums[2][warp] = bypasses;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned long long total = 0;
    for (int w = 0; w < kWalkWarps; ++w) total += sums[threadIdx.x][w];
    unsigned long long* dst =
        threadIdx.x == 0 ? n_hits : threadIdx.x == 1 ? n_misses : n_bypasses;
    if (total) atomicAdd(dst, total);
  }
}

}  // namespace

// Stable bucketing of B requests by set.  ids: (B,) int32; scratch:
// B + ceil(B / 1024) * (num_sets + 1) int32; order: (B,) int32, the stable
// argsort of key = set (or num_sets for ids < 0); start: (num_sets + 2,)
// int32, start[key] the first position of bucket key, start[num_sets + 1]
// = B.  The histogram takes (num_sets + 1) * 4 bytes of shared memory beside
// 4 KB of keys, so 1 <= num_sets <= kMaxSets (57087); any other count is
// refused with cudaErrorInvalidValue before anything launches.
extern "C" int cache_bucket(const void* ids, int B, int num_sets,
                            void* scratch, void* order, void* start,
                            void* stream) {
  if (num_sets < 1 || num_sets > kMaxSets) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (B + kTile - 1) / kTile;
  const int cols = num_sets + 1;
  int32_t* rank = static_cast<int32_t*>(scratch);
  int32_t* counts = rank + B;
  const size_t smem = sizeof(int32_t) * cols;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bucket_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          bucket_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (tiles > 0) {
    bucket_count_kernel<<<tiles, kTile, smem, s>>>(
        static_cast<const int32_t*>(ids), B, num_sets, counts, rank);
  }
  bucket_scan_kernel<<<1, kScanThreads, smem, s>>>(
      counts, tiles, cols, B, static_cast<int32_t*>(start));
  if (tiles > 0) {
    bucket_scatter_kernel<<<tiles, kTile, 0, s>>>(
        static_cast<const int32_t*>(ids), B, num_sets, counts,
        static_cast<const int32_t*>(start), rank,
        static_cast<int32_t*>(order));
  }
  return static_cast<int>(cudaGetLastError());
}

// ids, future_counts, slot, serve: (B,) int32; order, start: cache_bucket's
// outputs for these ids; hit: (B,) bool; tags, reuse, slot_table:
// (num_sets, ways) int32, tags and reuse updated in place; last_filler:
// (num_sets * ways,) int32; the counters are int64 scalars incremented in
// place.  ways <= 64.
extern "C" int cache_access(const void* ids, const void* future_counts,
                            const void* order, const void* start, int B,
                            void* tags, void* reuse, const void* slot_table,
                            int num_sets, int ways, void* hit, void* slot,
                            void* serve, void* last_filler, void* n_hits,
                            void* n_misses, void* n_bypasses, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (num_sets + kWalkWarps - 1) / kWalkWarps + 1;
  walk_kernel<<<blocks, kWalkWarps * 32, 0, s>>>(
      static_cast<const int32_t*>(ids),
      static_cast<const int32_t*>(future_counts),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(start),
      B, static_cast<int32_t*>(tags), static_cast<int32_t*>(reuse),
      static_cast<const int32_t*>(slot_table), num_sets, ways,
      static_cast<bool*>(hit), static_cast<int32_t*>(slot),
      static_cast<int32_t*>(serve), static_cast<int32_t*>(last_filler),
      static_cast<unsigned long long*>(n_hits),
      static_cast<unsigned long long*>(n_misses),
      static_cast<unsigned long long*>(n_bypasses));
  return static_cast<int>(cudaGetLastError());
}
