// flash_attention: out = softmax(q k^T * scale + mask) v with an online
// softmax, for q (B, H, Sq, hd) and k, v (B, KV, Sk, hd), q head h reading
// kv head h / (H / KV) (GQA).  Masks: causal k <= pos, sliding window
// k > pos - window, kv padding k < Sk, where query i of sequence b sits at
// pos = q_offset[b] + i (q_offset 0 when not given).  Statistics (m, l) and
// the accumulator in f32, inputs cast to f32, p kept in f32 for p v;
// NEG_INF = -1e30, masked p forced to 0 and the denominator clamped at
// 1e-30, so a fully masked row gives 0.
//
// Replaces the Pallas TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention.py:74, `_kernel` :30, `pallas_call` :107).  On the TPU the
// kv axis is the innermost, sequential grid axis and m, l, acc sit in VMEM
// scratch between grid steps; here blocks run in parallel, so the kv loop
// moves inside the block and the statistics live in registers.  The TPU
// kernel takes no query offset, so with a KV cache its causal mask counts
// queries from 0; this kernel takes the cache's per-sequence offset, which
// is what the model's attention means (the einsum path).
//
// Layout: one block of 256 threads per (q-tile, kv head, b).  A tile packs
// the GROUP = H / KV query heads that share one kv head: tile row
// r = i * GROUP + g is query i of head kvh * GROUP + g, so each K/V tile is
// read once for the whole group and a decode step (Sq = 1) fills GROUP rows
// of one tile.  Tiles are 16 or 64 rows (16 when Sq * GROUP <= 16) by 64 kv
// columns; a 16 x 16 thread grid owns RM x 4 scores and RM x hd/16 output
// columns per thread.  Q, then K, then V (one buffer) are staged in shared
// memory as f32 with a padded row (hd + 1 floats) so that the column reads
// of the score loop are free of bank conflicts; rows are read from global
// memory in 16-byte words through element strides, so the (B, S, KV, hd)
// cache's transposed view goes in without a copy (only the last dim must
// be contiguous).  kv tiles wholly outside the causal or window band of
// the tile's positions are skipped (the Pallas docstring promises it, its
// grid visits every block); the per-element masks are applied either way.
//
// Bound on an H100 SXM: a prefill tile is bound by operations (4 Sq Sk hd
// per head, halved by the causal band); a decode step reads each visible
// cache row once per kv head and is bound by bytes (3.35 TB/s).  This first
// version computes in f32 on the CUDA cores (67 TFLOP/s peak), far from the
// bf16 tensor-core rate, and a decode step runs only B * KV blocks.  Left
// for later PRs: wgmma on bf16 tiles with TMA staging, double-buffered
// tiles, and a split of the kv range across blocks for decode.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;               // kv rows per tile
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

// rows [k0, k0 + kBK) of one (Sk, HD) head into dst (kBK x (HD + 1) f32),
// zeros past Sk so that a masked p of 0 never meets an unread value
template <typename T, int HD>
__device__ __forceinline__ void load_kv_tile(float* dst, const T* head,
                                             int64_t row_stride, int k0,
                                             int Sk) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kThreads) {
    const int c = idx / kChunks, d0 = (idx % kChunks) * kVec;
    float vals[kVec];
    if (k0 + c < Sk) {
      load16(head + static_cast<int64_t>(k0 + c) * row_stride + d0, vals);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) vals[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) dst[c * (HD + 1) + d0 + j] = vals[j];
  }
}

template <int HD, int RM>
constexpr size_t smem_bytes() {
  return sizeof(float) * (16 * RM * (HD + 1) + kBK * (HD + 1) +
                          16 * RM * (kBK + 1));
}

template <typename T, int HD, int RM>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  constexpr int kBQ = 16 * RM;        // tile rows
  constexpr int kDN = HD / 16;        // output columns per thread
  constexpr int kCN = kBK / 16;       // score columns per thread
  constexpr int kLD = HD + 1;
  constexpr int kPLD = kBK + 1;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  extern __shared__ float smem[];
  float* Qs = smem;                   // kBQ x kLD
  float* KVs = Qs + kBQ * kLD;        // kBK x kLD: K, then V
  float* Ps = KVs + kBK * kLD;        // kBQ x kPLD

  const T* q = static_cast<const T*>(p.q);
  T* o = static_cast<T*>(p.o);
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.H / p.KV;
  const int rows = p.Sq * group;
  const int r0 = blockIdx.x * kBQ;
  const int off = p.q_offset != nullptr ? p.q_offset[b] : 0;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int idx = tid; idx < kBQ * kChunks; idx += kThreads) {
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
    for (int j = 0; j < kVec; ++j) Qs[r * kLD + d0 + j] = vals[j];
  }

  const T* kh = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[1];
  const T* vh = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[1];
  int qpos[RM];
  bool rvalid[RM];
#pragma unroll
  for (int rm = 0; rm < RM; ++rm) {
    const int rr = r0 + ty + 16 * rm;
    rvalid[rm] = rr < rows;
    qpos[rm] = off + (rvalid[rm] ? rr / group : 0);
  }
  // the kv tiles that the tile's positions [plo, phi] can see
  const int last = min(r0 + kBQ, rows) - 1;
  const int plo = off + r0 / group, phi = off + last / group;
  const int nk = (p.Sk + kBK - 1) / kBK;
  const int kt_end = p.causal ? min(nk, phi / kBK + 1) : nk;
  int kt_begin = 0;
  if (p.window > 0 && plo - p.window + 1 > 0) {
    kt_begin = (plo - p.window + 1) / kBK;
  }

  float m[RM], l[RM], acc[RM][kDN];
#pragma unroll
  for (int rm = 0; rm < RM; ++rm) {
    m[rm] = kNegInf;
    l[rm] = 0.0f;
#pragma unroll
    for (int dn = 0; dn < kDN; ++dn) acc[rm][dn] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                  // Q staged; last tile's p v finished
    load_kv_tile<T, HD>(KVs, kh, p.ks[2], k0, p.Sk);
    __syncthreads();

    float s[RM][kCN];
#pragma unroll
    for (int rm = 0; rm < RM; ++rm) {
#pragma unroll
      for (int cn = 0; cn < kCN; ++cn) s[rm][cn] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[RM], c[kCN];
#pragma unroll
      for (int rm = 0; rm < RM; ++rm) a[rm] = Qs[(ty + 16 * rm) * kLD + d];
#pragma unroll
      for (int cn = 0; cn < kCN; ++cn) c[cn] = KVs[(tx + 16 * cn) * kLD + d];
#pragma unroll
      for (int rm = 0; rm < RM; ++rm) {
#pragma unroll
        for (int cn = 0; cn < kCN; ++cn) {
          s[rm][cn] = fmaf(a[rm], c[cn], s[rm][cn]);
        }
      }
    }

#pragma unroll
    for (int rm = 0; rm < RM; ++rm) {
      bool ok[kCN];
      float mx = kNegInf;
#pragma unroll
      for (int cn = 0; cn < kCN; ++cn) {
        const int kp = k0 + tx + 16 * cn;
        ok[cn] = rvalid[rm] && kp < p.Sk && (!p.causal || kp <= qpos[rm]) &&
                 (p.window <= 0 || kp > qpos[rm] - p.window);
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
    load_kv_tile<T, HD>(KVs, vh, p.vs[2], k0, p.Sk);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pr[RM];
#pragma unroll
      for (int rm = 0; rm < RM; ++rm) pr[rm] = Ps[(ty + 16 * rm) * kPLD + c];
#pragma unroll
      for (int dn = 0; dn < kDN; ++dn) {
        const float vv = KVs[c * kLD + tx + 16 * dn];
#pragma unroll
        for (int rm = 0; rm < RM; ++rm) {
          acc[rm][dn] = fmaf(pr[rm], vv, acc[rm][dn]);
        }
      }
    }
  }

#pragma unroll
  for (int rm = 0; rm < RM; ++rm) {
    if (!rvalid[rm]) continue;
    const int rr = r0 + ty + 16 * rm;
    const int i = rr / group, h = kvh * group + rr % group;
    T* dst = o + b * p.os[0] + h * p.os[1] + i * p.os[2];
    const float denom = fmaxf(l[rm], 1e-30f);
#pragma unroll
    for (int dn = 0; dn < kDN; ++dn) store(dst + tx + 16 * dn, acc[rm][dn] / denom);
  }
}

template <typename T, int HD, int RM>
int launch_tiles(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, RM>();
  auto kernel = flash_fwd_kernel<T, HD, RM>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rows = p.Sq * (p.H / p.KV);
  const dim3 grid((rows + 16 * RM - 1) / (16 * RM), p.KV, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const Params& p, int B, cudaStream_t stream) {
  if (p.Sq * (p.H / p.KV) <= 16) return launch_tiles<T, HD, 1>(p, B, stream);
  return launch_tiles<T, HD, 4>(p, B, stream);
}

template <typename T>
int launch_hd(const Params& p, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(p, B, stream);
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 80: return launch<T, 80>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return -1;               // the wrapper refuses other head dims
  }
}

}  // namespace

// dtype 0: float32, 1: bfloat16.  strides: q, k, v, o, each (batch, head,
// seq) in elements; the head dim is contiguous.  Returns cudaGetLastError()
// after the launch, or -1 for an unsupported dtype or head dim.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, const void* q_offset, int dtype,
                                   int B, int H, int KV, int Sq, int Sk,
                                   int hd, int causal, int window, float scale,
                                   const long long* strides, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(p, B, hd, s);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(p, B, hd, s);
  return -1;
}
