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
// Bound on an H100 SXM (3.35 TB/s).  The bucketing moves B ids in, B order
// entries and num_sets + 2 starts out: 74 KB at the main paths' B 8192 over
// 2048 sets, 0.02 us.  One launch costs a few us, so the number of
// launches, and the dependent steps inside one, set its floor, never the
// bytes.  The walk moves 0.5-0.9 MB (0.2-0.3 us) and is one serial chain
// per set of B / num_sets requests on average (4 and 14 at the main paths'
// B); a hot set is serial by the reference's rule: one set holding n
// requests costs n dependent steps of one warp, a few shuffles each
// (chip_smoke.py times 4 sets of ~2,000 requests each).
//
// Bucketing (cache_bucket): one launch of one cluster of kCtas = 8 blocks
// of 512 threads, everything in shared memory, no scratch in device
// memory.  The key of request i is its set, or num_sets for padding, which
// so lands in a trailing bucket of its own.  Warp g of the cluster (block
// by block) owns the contiguous chunk [g * ceil(B / 128), ...) of the
// requests and a row of counters, one per key; counters are 16 bits wide
// where B <= 65535 (no count or offset exceeds B), two to a 32-bit word,
// else 32.  For each window of keys (one at the paths' 2049 keys: a window
// holds 4448 keys of 16-bit counters, 2312 of 32-bit ones):
//   (a) each warp counts its chunk's keys into its row, one shared atomic
//       add a request (counts do not depend on order).
//   (b) per uint4 of counters, the counts over the block's warps become
//       each warp's offset within the block's share of the bucket, and the
//       block's totals are stored into row `rank` of a (blocks x keys)
//       table in every block's shared memory; one cluster barrier.  Then
//       each block, from its own copy of the table, sums each key over the
//       blocks (the bucket sizes, scanned into the starts, which block 0
//       writes to `start`) and over the blocks before it: place[key] is
//       where this block's share of the bucket begins.
//   (c) each warp walks its chunk again, 32 requests at a time in request
//       order.  A lane adds one to its key's offset in its warp's row, and
//       reads the row back once the group's adds are in: the k lanes of
//       equal key took the places from (read back - k) on, and each takes
//       the one of its rank among them in lane order, popc(peers & lanes
//       below).  Stability follows from the construction (blocks, warps,
//       groups and lanes in request order), never from the order in which
//       atomics land, so `order` is the stable argsort of the keys.  The
//       peers come from __match_any_sync, which is slow where a group's
//       keys are many and distinct; it runs only in a group where some key
//       came twice (a lane's add and read back then differ by more than
//       one), about a fifth of the groups at 2048 sets.
// Why a cluster: (a) and (c) cost each SM a few cycles a request (the
// shared atomics, the match, the scattered stores), so one block's SM
// paces the whole sort; 8 blocks divide that by 8, for one barrier and
// 33 KB of stores into the other blocks' shared memory (`chip_smoke.py
// --cache-variants` times 1, 4 and 16 blocks beside 8).  Why 512 threads a
// block: fewer warps make each block's rows shorter to zero and to scan.
// Why 16-bit counters where they suffice: half the words to zero, count
// into, scan and copy between blocks (`--cache-variants` times 32-bit
// counters at every B beside them).
// The first 8 groups of a warp's ids are loaded once, before the counters
// are zeroed, and serve both passes: at the paths' B they are all of them.
//
// Walk (cache_access).  One warp per set: lanes 0..31 hold ways w and
// w + 32 (tag, reuse, line) in registers; a bucket's requests are loaded 32
// at a time, one per lane, and then decided one after another with
// __ballot_sync / __ffsll for the first matching, empty or safe way.  A
// set's tags and reuse are read and written once per call; each request's
// outputs are written by the lane that loaded it.  Counters are summed per
// block and added with one atomic each.
//
// The hand-off is programmatic dependent launch (Hopper): cache_bucket
// allows its dependents to launch as soon as it starts
// (griddepcontrol.launch_dependents), and cache_access launches the walk
// with cudaLaunchAttributeProgrammaticStreamSerialization, so the walk's
// blocks are scheduled and load their set's tags, reuse and slot table,
// which the bucketing never writes, while the sort runs; each thread then
// waits (griddepcontrol.wait: the sort has completed and its writes are
// visible) before it reads `order` or `start` or writes anything, and
// reads them through L2 (__ldcg: never the read-only path, which assumes
// that nothing writes the data while the kernel runs).  The walk's launch latency so hides
// behind the sort.  The sort itself is launched in plain stream order: it
// reads the ids that the copy before it wrote.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSortThreads = 512;    // threads of one block of the sort
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kCtas = 8;             // blocks of the sort's cluster
constexpr int kUnroll = 8;           // groups of 32 ids a warp loads at once
constexpr int kWalkWarps = 8;
// a block's shared memory on an H100, less 1 KB for the sort's static
// shared memory
constexpr int kSortSmem = 227 * 1024 - 1024;
// The largest set count accepted.  The three-kernel sort this one replaced
// held a (num_sets + 1) int32 histogram beside a 1024-key tile in one
// block's 227 KB; the windowed sort has no such ceiling (13 windows at
// this count), and keeps the value so that every count accepted before is
// accepted now.
constexpr int kMaxSets = 57087;

// The key of id n: its set, h mod num_sets with h = (n * 0x9E3779B9) >> 8
// (uint32), or num_sets for padding.  The remainder is Lemire's: with
// m = 2^64 / num_sets + 1 (wrapping to 0 for one set), h mod num_sets =
// hi64(lo64(m * h) * num_sets), exact for every 32-bit h and divisor.
__device__ __forceinline__ int key_of(int32_t n, int num_sets, uint64_t m) {
  const uint32_t h = (static_cast<uint32_t>(n) * 0x9E3779B9u) >> 8;
  return n >= 0 ? static_cast<int>(__umul64hi(m * h, num_sets)) : num_sets;
}

// ids of requests c + u * 32 + lane, u < kUnroll (0 past the chunk's end)
__device__ __forceinline__ void load_ids(const int32_t* __restrict__ ids,
                                         int c, int c1, int lane,
                                         int (&id)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int i = c + u * 32 + lane;
    id[u] = i < c1 ? __ldg(ids + i) : 0;
  }
}

// their keys in place, -1 past the chunk's end
__device__ __forceinline__ void to_keys(int c, int c1, int lane,
                                        int num_sets, uint64_t m,
                                        int (&id)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    id[u] = c + u * 32 + lane < c1 ? key_of(id[u], num_sets, m) : -1;
  }
}

// Counters are kBits wide, 32 / kBits to a 32-bit word of shared memory:
// 16 where B <= 65535 (a count, or an offset within a bucket, is at most
// B), else 32.  A word's counters are added as one integer: none carries
// into the next.
template <int kBits>
struct Counters {
  static constexpr int kPerWord = 32 / kBits;
  static constexpr int kPerVec = 4 * kPerWord;     // keys in a uint4
  static constexpr uint32_t kMask =
      kBits == 32 ? 0xffffffffu : (1u << kBits) - 1u;
  __device__ static int word(int j) { return j / kPerWord; }
  __device__ static int shift(int j) { return (j % kPerWord) * kBits; }
};

__device__ __forceinline__ uint4 operator+(uint4 a, uint4 b) {
  return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Exclusive prefix of v over the block's threads in order; *total gets the
// sum over all of them.
__device__ int block_exclusive_sum(int v, int32_t* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kSortWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kSortWarps) warp_sums[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  const int excl = incl - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[kSortWarps - 1];
  __syncthreads();                   // warp_sums free again
  return excl;
}

// Keys a window holds: per key, a kBits counter for each warp of the block
// and for each block of the cluster, and an int32 place; rounded down to 8
// so that every row is a whole number of uint4.
__host__ __device__ constexpr int window_capacity(int bits) {
  return kSortSmem * 8 / ((kSortWarps + kCtas) * bits + 32) / 8 * 8;
}

template <int kBits>
__global__ void __launch_bounds__(kSortThreads)
    bucket_kernel(const int32_t* __restrict__ ids, int B, int num_sets,
                  uint64_t m, int window, int32_t* __restrict__ order,
                  int32_t* __restrict__ start) {
  using Cnt = Counters<kBits>;
  // the walk may be scheduled now: it reads nothing of ours before its wait
  asm volatile("griddepcontrol.launch_dependents;");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  extern __shared__ __align__(16) uint32_t smem[];
  const int row = window / Cnt::kPerWord;      // words of a row of counters
  const int vecs = row / 4;                    // uint4 of a row
  int32_t* place = reinterpret_cast<int32_t*>(smem);        // (window,)
  uint4* totals = reinterpret_cast<uint4*>(smem + window);  // (kCtas, vecs)
  uint32_t* count = smem + window + kCtas * row;        // (kSortWarps, row)
  uint4* count4 = reinterpret_cast<uint4*>(count);
  __shared__ int32_t warp_sums[kSortWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int cols = num_sets + 1;
  // warp g = rank * kSortWarps + warp of the cluster owns [c0, c1)
  const long long chunk =
      (static_cast<long long>(B) + kCtas * kSortWarps - 1) /
      (kCtas * kSortWarps);
  const int g = rank * kSortWarps + warp;
  const int c0 = static_cast<int>(min(static_cast<long long>(B), g * chunk));
  const int c1 = static_cast<int>(min(static_cast<long long>(B), c0 + chunk));
  uint32_t* mine = count + warp * row;
  // the keys of the warp's first kUnroll groups, for every pass: at the
  // paths' B, all of its keys (loaded now, hashed once the counters are
  // zero)
  int first[kUnroll];
  load_ids(ids, c0, c1, lane, first);
  int base = 0;                      // first position of this window's keys
  for (int k0 = 0; k0 < cols; k0 += window) {
    const int n = min(window, cols - k0);
    for (int v = threadIdx.x; v < kSortWarps * vecs; v += kSortThreads) {
      count4[v] = make_uint4(0, 0, 0, 0);
    }
    if (k0 == 0) to_keys(c0, c1, lane, num_sets, m, first);
    __syncthreads();
    // (a) this window's keys counted per warp, one shared atomic a request
    for (int c = c0; c < c1; c += 32 * kUnroll) {
      int key[kUnroll];
      if (c == c0) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) key[u] = first[u];
      } else {
        load_ids(ids, c, c1, lane, key);
        to_keys(c, c1, lane, num_sets, m, key);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c + u * 32 >= c1) break;           // the same for the warp
        const int j = key[u] - k0;
        if (static_cast<unsigned>(j) < static_cast<unsigned>(n)) {
          atomicAdd(mine + Cnt::word(j), 1u << Cnt::shift(j));
        }
      }
    }
    __syncthreads();
    // (b) per uint4 of counters: the counts over this block's warps ->
    // each warp's offset in the block's share of the bucket; the block's
    // totals into row `rank` of every block's totals (stores into the other
    // blocks' shared memory, made visible by the cluster barrier) ...
    for (int v = threadIdx.x; v < vecs; v += kSortThreads) {
      uint4 run = make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int w = 0; w < kSortWarps; ++w) {
        const uint4 x = count4[w * vecs + v];
        count4[w * vecs + v] = run;
        run = run + x;
      }
#pragma unroll
      for (int c = 0; c < kCtas; ++c) {
        cluster.map_shared_rank(totals, c)[rank * vecs + v] = run;
      }
    }
    cluster.sync();
    // ... each key's total over the blocks, scanned over the keys in order
    // (thread t takes the `runs` uint4s from t * runs) into the buckets'
    // starts, and place[j] = the first place of this block's share of
    // bucket j: its start and the blocks before this one
    constexpr int kRuns =
        (window_capacity(kBits) / Cnt::kPerVec + kSortThreads - 1) /
        kSortThreads;
    const int runs = (vecs + kSortThreads - 1) / kSortThreads;
    uint4 sum[kRuns], before[kRuns];
    int keys = 0;
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      const int v = threadIdx.x * runs + r;
      sum[r] = before[r] = make_uint4(0, 0, 0, 0);
      if (r < runs && v < vecs) {
#pragma unroll
        for (int c = 0; c < kCtas; ++c) {
          if (c == rank) before[r] = sum[r];
          sum[r] = sum[r] + totals[c * vecs + v];
        }
        totals[rank * vecs + v] = before[r];   // this block's row: no
                                               // other reads it now
      }
      const uint32_t w[4] = {sum[r].x, sum[r].y, sum[r].z, sum[r].w};
#pragma unroll
      for (int k = 0; k < Cnt::kPerVec; ++k) {
        keys += static_cast<int>((w[k / Cnt::kPerWord] >>
                                  ((k % Cnt::kPerWord) * kBits)) & Cnt::kMask);
      }
    }
    int window_sum;
    int at = base + block_exclusive_sum(keys, warp_sums, &window_sum);
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      const uint32_t w[4] = {sum[r].x, sum[r].y, sum[r].z, sum[r].w};
#pragma unroll
      for (int k = 0; k < Cnt::kPerVec; ++k) {
        const int j = (threadIdx.x * runs + r) * Cnt::kPerVec + k;
        if (r < runs && j < n) {
          place[j] = at;
          at += static_cast<int>((w[k / Cnt::kPerWord] >>
                                  ((k % Cnt::kPerWord) * kBits)) &
                                 Cnt::kMask);
        }
      }
    }
    __syncthreads();
    // the starts out in key order, and the blocks before this one's share
    // added
    const uint32_t* earlier =
        reinterpret_cast<const uint32_t*>(totals + rank * vecs);
    for (int j = threadIdx.x; j < n; j += kSortThreads) {
      const int at_j = place[j];
      if (rank == 0) start[k0 + j] = at_j;
      place[j] = at_j + static_cast<int>((earlier[Cnt::word(j)] >>
                                          Cnt::shift(j)) & Cnt::kMask);
    }
    __syncthreads();
    // (c) stable placement, chunk by chunk in request order.  Each lane
    // adds one to its key's offset in its warp's row and reads the row back
    // once the group's adds are in: the k equal lanes of a group took the
    // places from (read back - k) on, and a lane's place among them is its
    // rank in lane order, popc(peers & lanes below), whatever the order in
    // which the adds landed.  Lanes whose key no other lane of the group
    // has took one place each; __match_any_sync (slow where the keys are
    // many) runs only for a group where some key came twice, which every
    // lane sees from its add and its read back.
    for (int c = c0; c < c1; c += 32 * kUnroll) {
      int key[kUnroll];
      if (c == c0) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) key[u] = first[u];
      } else {
        load_ids(ids, c, c1, lane, key);
        to_keys(c, c1, lane, num_sets, m, key);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (c + u * 32 >= c1) break;           // the same for the warp
        const int j = key[u] - k0;
        const bool here =
            static_cast<unsigned>(j) < static_cast<unsigned>(n);
        const int shift = here ? Cnt::shift(j) : 0;
        uint32_t* word = mine + (here ? Cnt::word(j) : 0);
        uint32_t added = 0;
        if (here) added = atomicAdd(word, 1u << shift);
        __syncwarp();
        const int after = here ? static_cast<int>((*word >> shift) &
                                                  Cnt::kMask)
                               : 0;
        const int mine_before = static_cast<int>((added >> shift) & Cnt::kMask);
        unsigned peers = 1u << lane;
        if (__any_sync(0xffffffffu, here && after != mine_before + 1)) {
          peers = __match_any_sync(0xffffffffu, key[u]);
        }
        if (here) {
          order[place[j] + after - __popc(peers) +
                __popc(peers & lanes_below)] = c + u * 32 + lane;
        }
        __syncwarp();                          // read back before next adds
      }
    }
    base += window_sum;
    // the next window's totals go into every block's shared memory: no
    // block may still be reading this window's
    if (k0 + window < cols) cluster.sync();
  }
  if (rank == 0 && threadIdx.x == 0) start[cols] = B;
}

__device__ __forceinline__ uint64_t ballot64(bool lo, bool hi) {
  return static_cast<uint64_t>(__ballot_sync(0xffffffffu, lo)) |
         (static_cast<uint64_t>(__ballot_sync(0xffffffffu, hi)) << 32);
}

// wait for the bucketing: it has completed and its writes are visible
__device__ __forceinline__ void wait_for_bucketing() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// one warp per set walks its bucket; the last block writes the padding's
// outputs
__global__ void __launch_bounds__(kWalkWarps * 32)
    walk_kernel(const int32_t* __restrict__ ids,
                const int32_t* __restrict__ future_counts,
                const int32_t* order, const int32_t* start, int B,
                int32_t* __restrict__ tags, int32_t* __restrict__ reuse,
                const int32_t* __restrict__ slot_table, int num_sets,
                int ways, bool* __restrict__ hit, int32_t* __restrict__ slot,
                int32_t* __restrict__ serve,
                int32_t* __restrict__ last_filler,
                unsigned long long* __restrict__ n_hits,
                unsigned long long* __restrict__ n_misses,
                unsigned long long* __restrict__ n_bypasses) {
  if (blockIdx.x == gridDim.x - 1) {
    wait_for_bucketing();
    for (int k = __ldcg(start + num_sets) + threadIdx.x; k < B;
         k += blockDim.x) {
      const int i = __ldcg(order + k);
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
    wait_for_bucketing();
    int32_t lf0 = -1, lf1 = -1;       // last filler of each way
    uint64_t filled = 0;              // ways filled earlier in this call
    const int b0 = __ldcg(start + s), b1 = __ldcg(start + s + 1);
    for (int c = b0; c < b1; c += 32) {
      const int n = min(32, b1 - c);
      const int my_i = lane < n ? __ldcg(order + c + lane) : 0;
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

// One launch of bucket_kernel<kBits>, one cluster of kCtas blocks, for B
// ids over num_sets + 1 keys.
template <int kBits>
cudaError_t launch_bucket(const int32_t* ids, int B, int num_sets,
                          int32_t* order, int32_t* start, cudaStream_t s) {
  constexpr int kCapacity = window_capacity(kBits);
  static const cudaError_t attr = [] {
    cudaError_t err = cudaFuncSetAttribute(
        bucket_kernel<kBits>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSortSmem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(bucket_kernel<kBits>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
    }
    return err;
  }();
  if (attr != cudaSuccess) return attr;
  const int window = min(kCapacity, (num_sets + 1 + 7) / 8 * 8);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kCtas;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCtas);
  cfg.blockDim = dim3(kSortThreads);
  cfg.dynamicSmemBytes =
      static_cast<size_t>(window) * ((kSortWarps + kCtas) * kBits + 32) / 8;
  cfg.stream = s;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const uint64_t m = ~uint64_t{0} / static_cast<uint32_t>(num_sets) + 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, bucket_kernel<kBits>, ids, B, num_sets, m, window, order, start);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Stable bucketing of B requests by set, one launch.  ids: (B,) int32;
// order: (B,) int32, the stable argsort of key = set (or num_sets for ids
// < 0); start: (num_sets + 2,) int32, start[key] the first position of
// bucket key, start[num_sets + 1] = B.  1 <= num_sets <= kMaxSets (57087);
// any other count is refused with cudaErrorInvalidValue before anything
// launches.
extern "C" int cache_bucket(const void* ids, int B, int num_sets,
                            void* order, void* start, void* stream) {
  if (num_sets < 1 || num_sets > kMaxSets || B < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* in = static_cast<const int32_t*>(ids);
  int32_t* o = static_cast<int32_t*>(order);
  int32_t* st = static_cast<int32_t*>(start);
  const cudaError_t err =
      B <= 65535 ? launch_bucket<16>(in, B, num_sets, o, st, s)
                 : launch_bucket<32>(in, B, num_sets, o, st, s);
  return static_cast<int>(err);
}

// ids, future_counts, slot, serve: (B,) int32; order, start: cache_bucket's
// outputs for these ids, launched just before on the same stream (the walk
// starts before it ends, see the note at the top); hit: (B,) bool; tags,
// reuse, slot_table: (num_sets, ways) int32, tags and reuse updated in
// place; last_filler: (num_sets * ways,) int32; the counters are int64
// scalars incremented in place.  ways <= 64.
extern "C" int cache_access(const void* ids, const void* future_counts,
                            const void* order, const void* start, int B,
                            void* tags, void* reuse, const void* slot_table,
                            int num_sets, int ways, void* hit, void* slot,
                            void* serve, void* last_filler, void* n_hits,
                            void* n_misses, void* n_bypasses, void* stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((num_sets + kWalkWarps - 1) / kWalkWarps + 1);
  cfg.blockDim = dim3(kWalkWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, walk_kernel, static_cast<const int32_t*>(ids),
      static_cast<const int32_t*>(future_counts),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(start),
      B, static_cast<int32_t*>(tags), static_cast<int32_t*>(reuse),
      static_cast<const int32_t*>(slot_table), num_sets, ways,
      static_cast<bool*>(hit), static_cast<int32_t*>(slot),
      static_cast<int32_t*>(serve), static_cast<int32_t*>(last_filler),
      static_cast<unsigned long long*>(n_hits),
      static_cast<unsigned long long*>(n_misses),
      static_cast<unsigned long long*>(n_bypasses));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
