// flash_attention: out = softmax(q k^T * scale + mask) v with an online
// softmax, for q (B, H, Sq, hd) and k, v (B, KV, Sk, hd), q head h reading
// kv head h / (H / KV) (GQA).  Masks: causal k <= pos, sliding window
// k > pos - window, kv padding k < Sk, where query i of sequence b sits at
// pos = q_offset[b] + i (q_offset 0 when not given).  Statistics (m, l) and
// the accumulator in f32; NEG_INF = -1e30, masked p forced to 0 and the
// denominator clamped at 1e-30, so a fully masked row gives 0.
//
// Replaces the Pallas TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py:74, `_kernel` :30, `pallas_call` :107).  On the TPU the
// kv axis is the innermost, sequential grid axis and m, l, acc sit in VMEM
// scratch between grid steps; here blocks run in parallel, so the kv loop
// moves inside the block, or is split across blocks and merged after.  The
// TPU kernel takes no query offset, so with a KV cache its causal mask
// counts queries from 0; this kernel takes the cache's per-sequence offset,
// which is what the model's attention means (the einsum path).
//
// Every path packs the GROUP = H / KV query heads that share one kv head
// into a tile: tile row r = i * GROUP + g is query i of head kvh * GROUP + g,
// so each K/V row is read once for the whole group.  Rows are read from
// global memory in 16-byte words through element strides, so the
// (B, S, KV, hd) cache's transposed view goes in without a copy (only the
// last dim must be contiguous).  kv tiles wholly outside the causal or
// window band of a block's positions are skipped; per-element masks apply
// within it.  Three paths, chosen by the launcher from static shapes:
//
// * Split-KV (Sq * GROUP <= 16: decode, f32 and bf16).  A decode step reads
//   each visible cache row once per kv head and is bound by bytes
//   (3.35 TB/s), but B * KV blocks (16 on the serving path) cannot pull
//   that rate from 132 SMs, and the longest sequence would set the time.
//   So each sequence's kv range is cut into `splits` chunks of a multiple
//   of 64 rows, chosen by the launcher from static shapes so that
//   B * KV * splits is about 4 blocks per SM (2 per SM was slower on the
//   serving shape), one block of 4 warps per (split, kv head, b).  The block clips its chunk to the band of its positions,
//   read from q_offset on the card (never on the host); a chunk past the
//   band writes the neutral partial (m = NEG_INF, l = 0, acc = 0) at once.
//   Q and each 64-row K and V tile are copied to shared memory in the input
//   type with cp.async, all in flight together (one round trip a tile),
//   rows padded to an odd number of 16-byte words so that 16-byte reads of
//   8 rows meet distinct banks.  Warp w owns 2 rows (4 when the group's
//   rows pass 8), lane c scores kv rows c and c + 32 in f32, the row max
//   and sum reduce with shuffles, and p v reads p from shared memory.
//   Each block writes f32 partials (m, l, unnormalised acc) to scratch
//   from the launcher; `flash_combine_kernel`, a second launch with its own
//   count, merges them by log-sum-exp, one block per packed row.
// * Tensor cores (bf16, Sq * GROUP > 16: prefill).  Bound by operations
//   (4 hd per visible pair per head at 989 TFLOP/s).  S = Q K^T and
//   O += P V run as mma.sync.m16n8k16 bf16 with f32 accumulators,
//   FlashAttention-2 style: 4 warps per 64-row tile, 16 rows a warp, 64 kv
//   rows per step; Q fragments stay in registers, P goes from the S
//   accumulators to the A fragments of P V in registers (never through
//   shared memory), K and V tiles stream through a three-stage ring in
//   shared memory with cp.async (zero-filled past Sk), so the next two
//   tiles' loads overlap this tile's math (104 KB at hd 128: two blocks per
//   SM); ldmatrix (.trans for V) feeds the fragments from rows padded by
//   16 bytes, free of bank conflicts.  hd 80 is 5 k-steps of 16 and 10
//   n-tiles of 8.  Tiles inside every row's band skip the masks; the
//   others mask with two compares against each row's key limits; exp2 is
//   the special-function unit's.  Blocks run the longest q-tiles of every
//   kv head first.  A causal prefill is a chain: the last q-tile walks
//   every kv tile (16 at Sq 1024), so the time is that chain of
//   latency-bound steps, not the card's rate.  This uses mma.sync and not
//   wgmma: wgmma needs shared-memory descriptors with a swizzled layout
//   and warpgroup-wide asynchronous fences, which cannot be compiled or
//   checked off the card and had to be right within a small chip budget;
//   mma.sync is this kernel's first tensor-core step, and at the serving
//   path's prefill (192 blocks for 132 SMs) the chain, not the
//   instruction's rate, limits it.  wgmma on 64-row tiles with TMA is left
//   for a later PR.
// * f32 tiles (f32, Sq * GROUP > 16).  f32 stays on the CUDA cores (TF32
//   would miss the f32 gates): a 16 x 16 thread grid owns 4 x 4 scores and
//   4 x hd/16 output columns per thread of a 64 x 64 tile, K then V staged
//   in shared memory as f32 with a padded row (hd + 1 floats).  Bound by
//   operations at 67 TFLOP/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // f32 tile kernel
constexpr int kBK = 64;               // kv rows per tile, every path
constexpr int kSplitRows = 16;        // rows of a split-KV tile
constexpr int kSplitThreads = 128;
constexpr int kMaxSplits = 64;
constexpr int kMmaThreads = 128;
constexpr int kMmaRows = 64;
constexpr int kStages = 3;            // the tensor-core kernel's K/V ring
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int32_t* q_offset;            // (B,) or null
  int H, KV, Sq, Sk, causal, window;  // window <= 0: none
  float scale;
  int64_t qs[3], ks[3], vs[3], os[3]; // element strides of batch, head, seq
};

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 r = *reinterpret_cast<const float4*>(src);
  dst[0] = r.x;
  dst[1] = r.y;
  dst[2] = r.z;
  dst[3] = r.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 r = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    dst[2 * j] = f.x;
    dst[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);         // round to nearest even, as torch's cast
}

// the kv band [begin, end) that positions [plo, phi] can see
__device__ __forceinline__ void kv_band(const Params& p, int plo, int phi,
                                        int* begin, int* end) {
  *end = p.causal ? min(p.Sk, phi + 1) : p.Sk;
  *begin = p.window > 0 ? max(0, plo - p.window + 1) : 0;
}

__device__ __forceinline__ bool visible(const Params& p, int kp, int qpos) {
  return (!p.causal || kp <= qpos) && (p.window <= 0 || kp > qpos - p.window);
}

// rows [k0, k0 + kBK) of one (Sk, HD) head into dst (kBK x (HD + 1) f32),
// zeros from `end` on so that a masked p of 0 never meets an unread value
template <typename T, int HD, int NT>
__device__ __forceinline__ void load_kv_tile(float* dst, const T* head,
                                             int64_t row_stride, int k0,
                                             int end) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += NT) {
    const int c = idx / kChunks, d0 = (idx % kChunks) * kVec;
    float vals[kVec];
    if (k0 + c < end) {
      load16(head + static_cast<int64_t>(k0 + c) * row_stride + d0, vals);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) vals[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[c * (HD + 1) + d0 + j] = vals[j];
  }
}

// the tile's rows of q (packed r = i * group + g) into dst (nrows x
// (HD + 1) f32), zeros past `rows`
template <typename T, int HD, int NT>
__device__ __forceinline__ void load_q_tile(float* dst, const Params& p,
                                            int b, int kvh, int r0,
                                            int nrows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  const T* q = static_cast<const T*>(p.q);
  const int group = p.H / p.KV, rows = p.Sq * group;
  for (int idx = threadIdx.x; idx < nrows * kChunks; idx += NT) {
    const int r = idx / kChunks, d0 = (idx % kChunks) * kVec;
    const int rr = r0 + r;
    float vals[kVec];
    if (rr < rows) {
      const int i = rr / group, h = kvh * group + rr % group;
      load16(q + b * p.qs[0] + h * p.qs[1] + i * p.qs[2] + d0, vals);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) vals[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[r * (HD + 1) + d0 + j] = vals[j];
  }
}

// ---- f32 tiles ---------------------------------------------------------------

constexpr int kRM = 4;                // rows per thread: 64-row tiles

template <int HD>
constexpr size_t tile_smem_bytes() {
  return sizeof(float) * (16 * kRM * (HD + 1) + kBK * (HD + 1) +
                          16 * kRM * (kBK + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  constexpr int kBQ = 16 * kRM;       // tile rows
  constexpr int kDN = HD / 16;        // output columns per thread
  constexpr int kCN = kBK / 16;       // score columns per thread
  constexpr int kLD = HD + 1;
  constexpr int kPLD = kBK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                   // kBQ x kLD
  float* KVs = Qs + kBQ * kLD;        // kBK x kLD: K, then V
  float* Ps = KVs + kBK * kLD;        // kBQ x kPLD

  float* o = static_cast<float*>(p.o);
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.KV;
  const int rows = p.Sq * group;
  const int r0 = blockIdx.x * kBQ;
  const int off = p.q_offset != nullptr ? p.q_offset[b] : 0;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  load_q_tile<float, HD, kThreads>(Qs, p, b, kvh, r0, kBQ);

  const float* kh = static_cast<const float*>(p.k) + b * p.ks[0] +
                    kvh * p.ks[1];
  const float* vh = static_cast<const float*>(p.v) + b * p.vs[0] +
                    kvh * p.vs[1];
  int qpos[kRM];
  bool rvalid[kRM];
#pragma unroll
  for (int rm = 0; rm < kRM; ++rm) {
    const int rr = r0 + ty + 16 * rm;
    rvalid[rm] = rr < rows;
    qpos[rm] = off + (rvalid[rm] ? rr / group : 0);
  }
  const int last = min(r0 + kBQ, rows) - 1;
  int lo, hi;
  kv_band(p, off + r0 / group, off + last / group, &lo, &hi);

  float m[kRM], l[kRM], acc[kRM][kDN];
#pragma unroll
  for (int rm = 0; rm < kRM; ++rm) {
    m[rm] = kNegInf;
    l[rm] = 0.0f;
#pragma unroll
    for (int dn = 0; dn < kDN; ++dn) acc[rm][dn] = 0.0f;
  }

  for (int k0 = lo / kBK * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();                  // Q staged; last tile's p v finished
    load_kv_tile<float, HD, kThreads>(KVs, kh, p.ks[2], k0, p.Sk);
    __syncthreads();

    float s[kRM][kCN];
#pragma unroll
    for (int rm = 0; rm < kRM; ++rm) {
#pragma unroll
      for (int cn = 0; cn < kCN; ++cn) s[rm][cn] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[kRM], c[kCN];
#pragma unroll
      for (int rm = 0; rm < kRM; ++rm) a[rm] = Qs[(ty + 16 * rm) * kLD + d];
#pragma unroll
      for (int cn = 0; cn < kCN; ++cn) c[cn] = KVs[(tx + 16 * cn) * kLD + d];
#pragma unroll
      for (int rm = 0; rm < kRM; ++rm) {
#pragma unroll
        for (int cn = 0; cn < kCN; ++cn) {
          s[rm][cn] = fmaf(a[rm], c[cn], s[rm][cn]);
        }
      }
    }

#pragma unroll
    for (int rm = 0; rm < kRM; ++rm) {
      bool ok[kCN];
      float mx = kNegInf;
#pragma unroll
      for (int cn = 0; cn < kCN; ++cn) {
        const int kp = k0 + tx + 16 * cn;
        ok[cn] = rvalid[rm] && kp < p.Sk && visible(p, kp, qpos[rm]);
        s[rm][cn] = ok[cn] ? s[rm][cn] * p.scale : kNegInf;
        mx = fmaxf(mx, s[rm][cn]);
      }
      // a row's 64 scores sit on the 16 lanes of one half-warp
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      }
      const float m_new = fmaxf(m[rm], mx);
      float sum = 0.0f;
#pragma unroll
      for (int cn = 0; cn < kCN; ++cn) {
        const float pv = ok[cn] ? expf(s[rm][cn] - m_new) : 0.0f;
        sum += pv;
        Ps[(ty + 16 * rm) * kPLD + tx + 16 * cn] = pv;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      }
      const float alpha = expf(m[rm] - m_new);
      l[rm] = alpha * l[rm] + sum;
#pragma unroll
      for (int dn = 0; dn < kDN; ++dn) acc[rm][dn] *= alpha;
      m[rm] = m_new;
    }
    __syncthreads();                  // K read by every thread, p written
    load_kv_tile<float, HD, kThreads>(KVs, vh, p.vs[2], k0, p.Sk);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pr[kRM];
#pragma unroll
      for (int rm = 0; rm < kRM; ++rm) pr[rm] = Ps[(ty + 16 * rm) * kPLD + c];
#pragma unroll
      for (int dn = 0; dn < kDN; ++dn) {
        const float vv = KVs[c * kLD + tx + 16 * dn];
#pragma unroll
        for (int rm = 0; rm < kRM; ++rm) {
          acc[rm][dn] = fmaf(pr[rm], vv, acc[rm][dn]);
        }
      }
    }
  }

#pragma unroll
  for (int rm = 0; rm < kRM; ++rm) {
    if (!rvalid[rm]) continue;
    const int rr = r0 + ty + 16 * rm;
    const int i = rr / group, h = kvh * group + rr % group;
    float* dst = o + b * p.os[0] + h * p.os[1] + i * p.os[2];
    const float denom = fmaxf(l[rm], 1e-30f);
#pragma unroll
    for (int dn = 0; dn < kDN; ++dn) dst[tx + 16 * dn] = acc[rm][dn] / denom;
  }
}

// ---- split-KV ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Split {
  int splits, chunk;
  float* ml;                          // (B, KV, splits, 16, 2): m, l
  float* acc;                         // (B, KV, splits, 16, HD)
};

constexpr int kSplitPLD = kBK + 4;    // p rows, 16-byte aligned

// rows are kept in the input type, padded by 16 bytes: a row is an odd
// number of 16-byte words, so a quarter-warp's 16-byte reads of 8 rows
// meet 8 distinct bank groups
template <typename T, int HD, int RW>
constexpr size_t split_smem_bytes() {
  return sizeof(T) * (4 * RW + 2 * kBK) * (HD + 16 / sizeof(T)) +
         sizeof(float) * 4 * RW * kSplitPLD;
}

// 16 bytes of T as floats
__device__ __forceinline__ void to_f32(const float* src, float* dst) {
  load16(src, dst);
}
__device__ __forceinline__ void to_f32(const __nv_bfloat16* src, float* dst) {
  load16(src, dst);
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// rows [k0, k0 + kBK) of one head into dst (kBK x LD of T) with cp.async,
// rows from `end` on zero-filled
template <typename T, int HD, int LD>
__device__ __forceinline__ void copy_rows_async(T* dst, const T* head,
                                                int64_t row_stride, int k0,
                                                int end) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  static_assert(kBK * kChunks % kSplitThreads == 0, "whole rounds");
#pragma unroll
  for (int i = 0; i < kBK * kChunks / kSplitThreads; ++i) {
    const int idx = threadIdx.x + i * kSplitThreads;
    const int c = idx / kChunks, d0 = (idx % kChunks) * kVec;
    const bool valid = k0 + c < end;
    cp_async16(dst + c * LD + d0,
               valid ? head + static_cast<int64_t>(k0 + c) * row_stride + d0
                     : head,
               valid);
  }
}

// RW rows per warp: 2 when the group's rows fit 8 (every warp then holds
// work at GROUP 4 or 6), else 4
template <typename T, int HD, int RW>
__global__ void __launch_bounds__(kSplitThreads)
    flash_split_kernel(const Params p, const Split sp) {
  constexpr int kLD = HD + 16 / static_cast<int>(sizeof(T));
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRows = 4 * RW;
  constexpr int kDN = (HD + 31) / 32; // output columns per lane
  extern __shared__ __align__(16) unsigned char split_raw[];
  T* Qs = reinterpret_cast<T*>(split_raw);  // kRows x kLD
  T* Ks = Qs + kRows * kLD;                 // kBK x kLD
  T* Vs = Ks + kBK * kLD;                   // kBK x kLD
  float* Ps = reinterpret_cast<float*>(Vs + kBK * kLD);  // kRows x kSplitPLD

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.KV, rows = p.Sq * group;
  const int off = p.q_offset != nullptr ? p.q_offset[b] : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int lo, hi;
  kv_band(p, off, off + p.Sq - 1, &lo, &hi);
  lo = max(lo, split * sp.chunk);
  hi = min(hi, split * sp.chunk + sp.chunk);

  int qpos[RW];
  bool rvalid[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const int r = warp * RW + j;
    rvalid[j] = r < rows;
    qpos[j] = off + (rvalid[j] ? r / group : 0);
  }
  const bool active = warp * RW < rows;  // warp-uniform
  int kv_lo[RW], kv_hi[RW];           // the keys row j sees in this split
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    kv_hi[j] = rvalid[j] ? (p.causal ? min(hi, qpos[j] + 1) : hi) : 0;
    kv_lo[j] = p.window > 0 ? qpos[j] - p.window + 1 : 0;
  }
  float m[RW], l[RW], acc[RW][kDN];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    m[j] = kNegInf;
    l[j] = 0.0f;
#pragma unroll
    for (int dn = 0; dn < kDN; ++dn) acc[j][dn] = 0.0f;
  }

  if (lo < hi) {
    // Q, then each tile's K and V: one round trip per tile, all copies in
    // flight together
    const T* q = static_cast<const T*>(p.q);
    for (int idx = threadIdx.x; idx < kRows * (HD / kVec);
         idx += kSplitThreads) {
      const int r = idx / (HD / kVec), d0 = (idx % (HD / kVec)) * kVec;
      const bool valid = r < rows;
      const T* src = q;
      if (valid) {
        const int i = r / group, h = kvh * group + r % group;
        src = q + b * p.qs[0] + h * p.qs[1] + i * p.qs[2] + d0;
      }
      cp_async16(Qs + r * kLD + d0, src, valid);
    }
    const T* kh = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[1];
    const T* vh = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[1];
    for (int k0 = lo; k0 < hi; k0 += kBK) {
      if (k0 > lo) __syncthreads();   // last tile's p v finished
      copy_rows_async<T, HD, kLD>(Ks, kh, p.ks[2], k0, hi);
      copy_rows_async<T, HD, kLD>(Vs, vh, p.vs[2], k0, hi);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (!active) continue;
      float s[RW][2];
#pragma unroll
      for (int j = 0; j < RW; ++j) s[j][0] = s[j][1] = 0.0f;
      const T* k_lo = Ks + lane * kLD;
      const T* k_hi = Ks + (lane + 32) * kLD;
      const T* qw = Qs + warp * RW * kLD;
#pragma unroll 2
      for (int d = 0; d < HD; d += kVec) {
        float c0[kVec], c1[kVec];
        to_f32(k_lo + d, c0);
        to_f32(k_hi + d, c1);
#pragma unroll
        for (int j = 0; j < RW; ++j) {
          float a[kVec];
          to_f32(qw + j * kLD + d, a);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            s[j][0] = fmaf(a[e], c0[e], s[j][0]);
            s[j][1] = fmaf(a[e], c1[e], s[j][1]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < RW; ++j) {
        bool ok[2];
        float mx = kNegInf;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kp = k0 + lane + 32 * c;
          ok[c] = (kp >= kv_lo[j]) & (kp < kv_hi[j]);
          s[j][c] = ok[c] ? s[j][c] * p.scale : kNegInf;
          mx = fmaxf(mx, s[j][c]);
        }
#pragma unroll
        for (int w = 16; w > 0; w >>= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
        }
        const float m_new = fmaxf(m[j], mx);
        const float p0 = ok[0] ? expf(s[j][0] - m_new) : 0.0f;
        const float p1 = ok[1] ? expf(s[j][1] - m_new) : 0.0f;
        float sum = p0 + p1;
#pragma unroll
        for (int w = 16; w > 0; w >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, w);
        }
        const float alpha = expf(m[j] - m_new);
        l[j] = alpha * l[j] + sum;
#pragma unroll
        for (int dn = 0; dn < kDN; ++dn) acc[j][dn] *= alpha;
        m[j] = m_new;
        Ps[(warp * RW + j) * kSplitPLD + lane] = p0;
        Ps[(warp * RW + j) * kSplitPLD + lane + 32] = p1;
      }
      __syncwarp();                   // a warp reads only its own p rows
      const int nc = (min(kBK, hi - k0) + 3) & ~3;  // rows past hi are 0
      for (int c = 0; c < nc; c += 4) {
        float4 pr[RW];
#pragma unroll
        for (int j = 0; j < RW; ++j) {
          pr[j] = *reinterpret_cast<const float4*>(
              Ps + (warp * RW + j) * kSplitPLD + c);
        }
#pragma unroll
        for (int dn = 0; dn < kDN; ++dn) {
          const int d = lane + 32 * dn;
          if (d < HD) {
            const float v0 = to_f32(Vs[c * kLD + d]);
            const float v1 = to_f32(Vs[(c + 1) * kLD + d]);
            const float v2 = to_f32(Vs[(c + 2) * kLD + d]);
            const float v3 = to_f32(Vs[(c + 3) * kLD + d]);
#pragma unroll
            for (int j = 0; j < RW; ++j) {
              acc[j][dn] = fmaf(pr[j].x, v0, fmaf(pr[j].y, v1,
                           fmaf(pr[j].z, v2, fmaf(pr[j].w, v3, acc[j][dn]))));
            }
          }
        }
      }
    }
  }

  // partials of this split; rows past `rows` are never read
  const int64_t cell = (static_cast<int64_t>(b) * p.KV + kvh) * sp.splits +
                       split;
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const int r = warp * RW + j;
    if (r >= rows) continue;
    const int64_t row = cell * kSplitRows + r;
    if (lane == 0) {
      sp.ml[row * 2] = m[j];
      sp.ml[row * 2 + 1] = l[j];
    }
#pragma unroll
    for (int dn = 0; dn < kDN; ++dn) {
      const int d = lane + 32 * dn;
      if (d < HD) sp.acc[row * HD + d] = acc[j][dn];
    }
  }
}

// out[b, h, i] = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s over the
// splits s with l_s > 0, M their largest m; 0 where no split saw a key.
// One block per packed row (r, kv head, b): warp 0 turns the splits' (m, l)
// into weights, then thread d sums its column over the splits, whose loads
// are independent of each other.
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
    flash_combine_kernel(const float* __restrict__ ml,
                         const float* __restrict__ acc, T* __restrict__ o,
                         int H, int KV, int Sq, int hd, int splits,
                         int64_t os0, int64_t os1, int64_t os2) {
  __shared__ float w[kMaxSplits];
  __shared__ float inv;
  const int r = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KV;
  const int64_t cell = (static_cast<int64_t>(b) * KV + kvh) * splits;
  const int t = threadIdx.x;
  if (t < 32) {
    float mv[2], lv[2], M = kNegInf;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int s = t + 32 * h2;
      const float* x = ml + ((cell + s) * kSplitRows + r) * 2;
      mv[h2] = s < splits ? x[0] : kNegInf;
      lv[h2] = s < splits ? x[1] : 0.0f;
      if (lv[h2] > 0.0f) M = fmaxf(M, mv[h2]);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, d));
    }
    float L = 0.0f;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int s = t + 32 * h2;
      const float e = lv[h2] > 0.0f ? expf(mv[h2] - M) : 0.0f;
      if (s < splits) w[s] = e;
      L += e * lv[h2];
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) L += __shfl_xor_sync(0xffffffffu, L, d);
    if (t == 0) inv = 1.0f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  const int i = r / group, h = kvh * group + r % group;
  for (int d = t; d < hd; d += kSplitThreads) {
    float sum = 0.0f;
#pragma unroll 32
    for (int s = 0; s < splits; ++s) {  // loads batched, not chained
      // a split that saw no key wrote acc = 0 and weighs 0
      sum = fmaf(w[s], acc[((cell + s) * kSplitRows + r) * hd + d], sum);
    }
    store(o + b * os0 + h * os1 + i * os2 + d, sum * inv);
  }
}

// ---- bf16 tensor cores ---------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit, flushing denormals: 0 for x = NEG_INF
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// one 64-row K tile and V tile (rows from k0) into shared memory with
// cp.async, 16 bytes a copy, rows at or past `left` zero-filled.  Each
// thread's share is a fixed column and rows a fixed step apart whenever
// the block's threads cover whole rows, so the addresses are a base plus a
// stride (hd 80 takes the general split of the index)
template <int HD>
__device__ __forceinline__ void load_kv_tile_async(
    __nv_bfloat16* ks, __nv_bfloat16* vs, const __nv_bfloat16* kb,
    const __nv_bfloat16* vb, int64_t ks2, int64_t vs2, int left, int tid) {
  constexpr int kLD = HD + 8;
  constexpr int kChunks = HD / 8;
  constexpr int kIters = kBK * kChunks / kMmaThreads;
  static_assert(kBK * kChunks % kMmaThreads == 0, "whole rounds of copies");
  if constexpr (kMmaThreads % kChunks == 0) {
    constexpr int kStep = kMmaThreads / kChunks;
    const int r = tid / kChunks, c = (tid % kChunks) * 8;
    const __nv_bfloat16* kp = kb + r * ks2 + c;
    const __nv_bfloat16* vp = vb + r * vs2 + c;
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const bool valid = r + i * kStep < left;
      cp_async16(ks + (r + i * kStep) * kLD + c,
                 valid ? kp + i * kStep * ks2 : kb, valid);
      cp_async16(vs + (r + i * kStep) * kLD + c,
                 valid ? vp + i * kStep * vs2 : vb, valid);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int idx = tid + i * kMmaThreads;
      const int r = idx / kChunks, c = (idx % kChunks) * 8;
      const bool valid = r < left;
      cp_async16(ks + r * kLD + c, valid ? kb + r * ks2 + c : kb, valid);
      cp_async16(vs + r * kLD + c, valid ? vb + r * vs2 + c : vb, valid);
    }
  }
}

template <int HD>
constexpr size_t mma_smem_bytes() {
  // kStages stages of K and of V, rows padded by 8 elements; Q passes
  // through the last stage's K before the loop
  return sizeof(__nv_bfloat16) * 2 * kStages * kBK * (HD + 8);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_mma_kernel(const Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int kLD = HD + 8;         // 16-byte pad: ldmatrix rows hit
                                      // distinct banks
  constexpr int kKS = HD / 16;        // k-steps of Q K^T
  constexpr int kDT = HD / 8;         // n-tiles of P V
  constexpr int kChunks = HD / 8;     // 16-byte words per row
  constexpr int kStage = kBK * kLD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // kStages stages
  bf16* Vs = Ks + kStages * kStage;                // kStages stages
  bf16* Qs = Ks + (kStages - 1) * kStage;          // before the loop only

  // blocks in order of work: the longest q-tiles of every kv head first,
  // so the short ones that share an SM with them finish early
  const int qt = gridDim.x / p.KV - 1 - static_cast<int>(blockIdx.x) / p.KV;
  const int kvh = blockIdx.x % p.KV, b = blockIdx.z;
  const int group = p.H / p.KV, rows = p.Sq * group;
  const int r0 = qt * kMmaRows;
  const int off = p.q_offset != nullptr ? p.q_offset[b] : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int last = min(r0 + kMmaRows, rows) - 1;
  int lo, hi;
  kv_band(p, off + r0 / group, off + last / group, &lo, &hi);
  const int kt_begin = lo / kBK, kt_end = (hi + kBK - 1) / kBK;

  const bf16* q = static_cast<const bf16*>(p.q);
  const bf16* kh = static_cast<const bf16*>(p.k) + b * p.ks[0] +
                   kvh * p.ks[1];
  const bf16* vh = static_cast<const bf16*>(p.v) + b * p.vs[0] +
                   kvh * p.vs[1];
  for (int idx = tid; idx < kMmaRows * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const int rr = r0 + r;
    const bool valid = rr < rows;
    const bf16* src = q;
    if (valid) {
      const int i = rr / group, h = kvh * group + rr % group;
      src = q + b * p.qs[0] + h * p.qs[1] + i * p.qs[2] + c * 8;
    }
    cp_async16(Qs + r * kLD + c * 8, src, valid);
  }
  const int64_t ks2 = p.ks[2], vs2 = p.vs[2];
  const auto load_kv = [=](int stage, int kt) {
    load_kv_tile_async<HD>(Ks + stage * kStage, Vs + stage * kStage,
                           kh + kt * kBK * ks2, vh + kt * kBK * vs2, ks2, vs2,
                           p.Sk - kt * kBK, tid);
  };
  // prologue: Q and the first kStages - 1 tiles in flight, one group each
  // tile (an empty group past the band keeps the count uniform)
  if (kt_begin < kt_end) load_kv(0, kt_begin);
  cp_async_commit();
#pragma unroll
  for (int j = 1; j < kStages - 1; ++j) {
    if (kt_begin + j < kt_end) load_kv(j, kt_begin + j);
    cp_async_commit();
  }

  // this thread's two rows: g and g + 8 of the warp's 16
  int qpos[2];
  bool rvalid[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int rr = r0 + warp * 16 + g + 8 * h2;
    rvalid[h2] = rr < rows;
    qpos[h2] = off + (rvalid[h2] ? rr / group : 0);
  }
  // the keys each of this thread's rows sees, [kv_lo, kv_hi): two
  // compares an element, no branch
  int kv_lo[2], kv_hi[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    kv_hi[h2] = rvalid[h2] ? (p.causal ? min(p.Sk, qpos[h2] + 1) : p.Sk) : 0;
    kv_lo[h2] = p.window > 0 ? qpos[h2] - p.window + 1 : 0;
  }
  // the warp's valid rows all see every key of a tile in [full_lo,
  // full_hi): such tiles skip the per-element masks (rows past `rows` hold
  // zeros and are never stored)
  const int wr_last = min(r0 + warp * 16 + 15, rows - 1);
  const int wq_lo = off + (r0 + warp * 16) / group;
  const int wq_hi = off + max(wr_last, r0 + warp * 16) / group;
  const int full_hi = p.causal ? min(p.Sk, wq_lo + 1) : p.Sk;
  const int full_lo = p.window > 0 ? max(0, wq_hi - p.window + 1) : 0;
  const float sl2 = p.scale * 1.4426950408889634f;   // scores in log2 units
  float o[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  uint32_t qf[kKS][4];

  if (kt_begin < kt_end) {            // Q fragments into registers
    cp_async_wait<kStages - 2>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const int r = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(qf[ks], Qs + r * kLD + ks * 16 + (lane >> 4) * 8);
    }                                 // Q's stage is refilled after the
  }                                   // first iteration's barrier

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int j = kt - kt_begin;
    const int stage = j % kStages;
    cp_async_wait<kStages - 2>();     // tile kt has landed, and past this
    __syncthreads();                  // barrier no warp reads stage j - 1
    // tile kt + kStages - 1 refills the stage read at iteration j - 1
    if (kt + kStages - 1 < kt_end) {
      load_kv((j + kStages - 1) % kStages, kt + kStages - 1);
    }
    cp_async_commit();
    const bf16* Kt = Ks + stage * kStage;
    const bf16* Vt = Vs + stage * kStage;

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        const int r = np * 16 + (lane & 7) + (lane >> 4) * 8;
        ldmatrix_x4(kb, Kt + r * kLD + ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    const int k0 = kt * kBK;
    float mx[2] = {kNegInf, kNegInf};
    if (k0 >= full_lo && k0 + kBK <= full_hi) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h2 = e >> 1;
          const int kp = k0 + nt * 8 + 2 * t4 + (e & 1);
          const bool ok = (kp >= kv_lo[h2]) & (kp < kv_hi[h2]);
          s[nt][e] = ok ? s[nt][e] : kNegInf;
          mx[h2] = fmaxf(mx[h2], s[nt][e]);
        }
      }
    }
    float alpha[2], mu[2];
    const float m_old[2] = {m[0], m[1]};
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {  // a row's scores sit on one quad
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 1));
      mx[h2] = fmaxf(mx[h2], __shfl_xor_sync(0xffffffffu, mx[h2], 2));
      m[h2] = fmaxf(m[h2], mx[h2] * sl2);   // in log2 units
      // a row that has seen no key yet (m at most NEG_INF * sl2) subtracts
      // 0, so its masked scores still give exp2 = 0 and no compare per
      // element is needed
      mu[h2] = m[h2] < -1e20f ? 0.0f : m[h2];
      alpha[h2] = ex2(m_old[h2] - mu[h2]);
      l[h2] *= alpha[h2];             // this thread's share of the row sum
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = ex2(fmaf(s[nt][e], sl2, -mu[e >> 1]));
        l[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    // P (16 x 64) from the S accumulators to A fragments, 16 kv rows a step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        uint32_t vb[4];
        const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(vb, Vt + r * kLD + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(p.o);
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float sum = l[h2];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (!rvalid[h2]) continue;
    const float inv = 1.0f / fmaxf(sum, 1e-30f);
    const int rr = r0 + warp * 16 + g + 8 * h2;
    const int i = rr / group, h = kvh * group + rr % group;
    bf16* dst = out + b * p.os[0] + h * p.os[1] + i * p.os[2] + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
          __floats2bfloat162_rn(o[dt][2 * h2] * inv, o[dt][2 * h2 + 1] * inv);
    }
  }
}

// ---- launch ------------------------------------------------------------------

template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int HD>
int launch_tiles(const Params& p, int B, int dtype, cudaStream_t stream) {
  const int rows = p.Sq * (p.H / p.KV);
  if (dtype == 0) {
    constexpr size_t smem = tile_smem_bytes<HD>();
    auto kernel = flash_fwd_kernel<HD>;
    if (const int err = allow_smem(kernel, smem)) return err;
    const dim3 grid((rows + 16 * kRM - 1) / (16 * kRM), p.KV, B);
    kernel<<<grid, kThreads, smem, stream>>>(p);
  } else {
    constexpr size_t smem = mma_smem_bytes<HD>();
    auto kernel = flash_mma_kernel<HD>;
    if (const int err = allow_smem(kernel, smem)) return err;
    const dim3 grid((rows + kMmaRows - 1) / kMmaRows * p.KV, 1, B);
    kernel<<<grid, kMmaThreads, smem, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_split(const Params& p, const Split& sp, int B,
                 cudaStream_t stream) {
  const dim3 grid(sp.splits, p.KV, B);
  if (p.Sq * (p.H / p.KV) <= 8) {
    constexpr size_t smem = split_smem_bytes<T, HD, 2>();
    auto kernel = flash_split_kernel<T, HD, 2>;
    if (const int err = allow_smem(kernel, smem)) return err;
    kernel<<<grid, kSplitThreads, smem, stream>>>(p, sp);
  } else {
    constexpr size_t smem = split_smem_bytes<T, HD, 4>();
    auto kernel = flash_split_kernel<T, HD, 4>;
    if (const int err = allow_smem(kernel, smem)) return err;
    kernel<<<grid, kSplitThreads, smem, stream>>>(p, sp);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int split_hd(const Params& p, const Split& sp, int B, int hd,
             cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_split<T, 16>(p, sp, B, stream);
    case 32: return launch_split<T, 32>(p, sp, B, stream);
    case 64: return launch_split<T, 64>(p, sp, B, stream);
    case 80: return launch_split<T, 80>(p, sp, B, stream);
    case 128: return launch_split<T, 128>(p, sp, B, stream);
    default: return -1;               // the wrapper refuses other head dims
  }
}

Params make_params(const void* q, const void* k, const void* v, void* o,
                   const void* q_offset, int H, int KV, int Sq, int Sk,
                   int causal, int window, float scale,
                   const long long* strides) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_offset = static_cast<const int32_t*>(q_offset);
  p.H = H;
  p.KV = KV;
  p.Sq = Sq;
  p.Sk = Sk;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  for (int j = 0; j < 3; ++j) {
    p.qs[j] = strides[j];
    p.ks[j] = strides[3 + j];
    p.vs[j] = strides[6 + j];
    p.os[j] = strides[9 + j];
  }
  return p;
}

}  // namespace

// Tiles of 64 rows in one launch: f32 on the CUDA cores, bf16 on the tensor
// cores.  dtype 0: float32, 1: bfloat16.  strides: q, k, v, o, each (batch,
// head, seq) in elements; the head dim is contiguous.  Returns
// cudaGetLastError() after the launch, or -1 for an unsupported dtype or
// head dim.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, const void* q_offset, int dtype,
                                   int B, int H, int KV, int Sq, int Sk,
                                   int hd, int causal, int window, float scale,
                                   const long long* strides, void* stream) {
  const Params p = make_params(q, k, v, o, q_offset, H, KV, Sq, Sk, causal,
                               window, scale, strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return -1;
  switch (hd) {
    case 16: return launch_tiles<16>(p, B, dtype, s);
    case 32: return launch_tiles<32>(p, B, dtype, s);
    case 64: return launch_tiles<64>(p, B, dtype, s);
    case 80: return launch_tiles<80>(p, B, dtype, s);
    case 128: return launch_tiles<128>(p, B, dtype, s);
    default: return -1;
  }
}

// Split-KV partials for Sq * (H / KV) <= 16: grid (splits, KV, B), split s
// covering kv rows [s * chunk, (s + 1) * chunk).  ml (B, KV, splits, 16, 2)
// and acc (B, KV, splits, 16, hd) f32 are written for the rows < Sq * group;
// o is not touched (flash_attention_combine writes it).  splits <= 64.
extern "C" int flash_attention_split(const void* q, const void* k,
                                     const void* v, const void* q_offset,
                                     int dtype, int B, int H, int KV, int Sq,
                                     int Sk, int hd, int causal, int window,
                                     float scale, const long long* strides,
                                     int splits, int chunk, void* ml,
                                     void* acc, void* stream) {
  if (Sq * (H / KV) > kSplitRows || splits < 1 || splits > kMaxSplits) {
    return -1;
  }
  const Params p = make_params(q, k, v, nullptr, q_offset, H, KV, Sq, Sk,
                               causal, window, scale, strides);
  const Split sp{splits, chunk, static_cast<float*>(ml),
                 static_cast<float*>(acc)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return split_hd<float>(p, sp, B, hd, s);
  if (dtype == 1) return split_hd<__nv_bfloat16>(p, sp, B, hd, s);
  return -1;
}

// Merge of flash_attention_split's partials into o (B, H, Sq, hd) through o's
// element strides (os: batch, head, seq).
extern "C" int flash_attention_combine(const void* ml, const void* acc,
                                       void* o, int dtype, int B, int H,
                                       int KV, int Sq, int hd, int splits,
                                       const long long* os, void* stream) {
  if (Sq * (H / KV) > kSplitRows || splits < 1 || splits > kMaxSplits) {
    return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(Sq * (H / KV), KV, B);
  const float* m = static_cast<const float*>(ml);
  const float* a = static_cast<const float*>(acc);
  if (dtype == 0) {
    flash_combine_kernel<float><<<grid, kSplitThreads, 0, s>>>(
        m, a, static_cast<float*>(o), H, KV, Sq, hd, splits, os[0], os[1],
        os[2]);
  } else if (dtype == 1) {
    flash_combine_kernel<__nv_bfloat16><<<grid, kSplitThreads, 0, s>>>(
        m, a, static_cast<__nv_bfloat16*>(o), H, KV, Sq, hd, splits, os[0],
        os[1], os[2]);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
