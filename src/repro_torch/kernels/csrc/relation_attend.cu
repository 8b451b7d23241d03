// relation_attend: R-GAT's attention over one relation's block, forward and
// backward, reading the projected rows z (R, H, C) by index.  For a
// destination v with slots j (source rows i_src[v, j], mask[v, j]) and head
// h:
//
//   e_vj  = LeakyReLU_0.2(a_src[h] . z[i_src[v, j], h] + a_dst[h] . z[i_dst[v], h])
//   alpha = softmax over v's unmasked slots of e_vj
//   agg[v, h] = sum_j alpha_vj z[i_src[v, j], h]
//
// Replaces no TPU kernel: R-GAT has no JAX original.  It was added because
// the torch ops it replaces (`models/rgat.py` `_attend` after the
// projection: the score gathers, masked softmax and an einsum over the
// gathered (m, f, H, C) rows, and their backward) were the largest cost of
// R-GAT's step after the f32 projections, and they materialise z[i_src]
// (1.78 GB at layer 0 of a 1024-seed IGBH batch) forward and again as its
// gradient.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  A slot costs ~10 flops a float
// of its row against 4 bytes read.  The least traffic is z read once (R rows
// of H * C floats), the indices and mask, agg (m, H * C) written; the
// backward reads z, agg and its gradient once and writes grad_z.  A slot's
// row that several destinations share is read again from L2 where it is
// still there, so the traffic lies between the unique rows and one 512 B
// row a slot and head.
//
// Forward, destination-major: one warp per (destination, head), each lane
// one float4 of the head's 128 floats, so a row is one coalesced 512 B
// load.  Lanes load the slots' indices and mask together; up to KB
// unmasked slots' rows are loaded before the first is used.  The softmax
// is online (running max, running sum, float4 accumulator, as flash
// attention over keys), in slot order: no score tensor, one pass.  It
// writes agg and the log-sum-exp (m, H) for the backward, and the sort key
// of every slot (its source row, or R where masked) and destination (its
// row), in the order of torch.unique's inverse, for the backward's
// source-major pass.  A destination with no unmasked slot gets zeros.
//
// Backward, two passes and no float atomics, so a gradient is the same in
// every run:
//  1. destination-major, a persistent grid whose warp count is a multiple
//     of H, so each warp keeps one head: per slot the score again, alpha =
//     exp(e - lse), dp = <g_v, z_u>, ds = alpha (dp - D_v) with D_v = <g_v,
//     agg_v> (the flash-attention identity), de = ds * LeakyReLU'.  It
//     writes alpha and de per slot (m, f, H), sum_j de per destination,
//     and accumulates grad_a_src = sum de z_u and grad_a_dst = sum (sum_j
//     de) z_v in registers, reduced per block in shared memory into one
//     partial a block.  Its threads also turn the sorted keys into each
//     row's range of entries.
//  2. source-major: one warp per (row u, head) walks u's entries in the
//     stably sorted order (slots in flat order, then the destination entry)
//     and writes grad_z[u] = sum alpha g_v + (sum de) a_src + (sum_j de)
//     a_dst once.  Extra blocks sum the partials in block order.
//
// Float32 throughout: expf and logf, no fast-math, the dot products as
// explicit fmaf chains so that both passes compute each score to the bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 128;           // a head's width: one float4 a lane
constexpr int kWarps = 8;         // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int KB = 4;             // slots' rows in flight a warp
constexpr float kSlope = 0.2f;    // LeakyReLU's negative slope
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

// every lane ends with the same bits: each step adds a pair in both orders
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kAll, x, o);
  return x;
}

__device__ __forceinline__ float4 load4(const float* row, int lane) {
  return reinterpret_cast<const float4*>(row)[lane];
}

__device__ __forceinline__ void store4(float* row, int lane, float4 x) {
  reinterpret_cast<float4*>(row)[lane] = x;
}

__device__ __forceinline__ void axpy4(float4& acc, float a, float4 x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

__device__ __forceinline__ float leaky(float x) {
  return x > 0.0f ? x : x * kSlope;
}

// Lane l < nj loads slot j0 + l of destination v: its source row where the
// slot is unmasked, else -1.
__device__ __forceinline__ int slot_row(const int32_t* i_src,
                                        const uint8_t* mask, int64_t v, int f,
                                        int j0, int nj, int lane) {
  if (lane >= nj) return -1;
  const int64_t s = v * f + j0 + lane;
  return mask[s] ? i_src[s] : -1;
}

__global__ void __launch_bounds__(kThreads)
relation_attend_fwd_kernel(const float* __restrict__ z,
                           const float* __restrict__ a_src,
                           const float* __restrict__ a_dst,
                           const int32_t* __restrict__ i_src,
                           const int32_t* __restrict__ i_dst,
                           const uint8_t* __restrict__ mask,
                           float* __restrict__ agg, float* __restrict__ lse,
                           int32_t* __restrict__ key, int m, int f, int H,
                           int R) {
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (w >= static_cast<int64_t>(m) * H) return;       // the whole warp
  const int64_t v = w / H;
  const int h = static_cast<int>(w % H);
  const int64_t HC = static_cast<int64_t>(H) * kC;
  const int64_t dv = i_dst[v];
  const float4 zv = load4(z + dv * HC + h * kC, lane);
  const float4 as = load4(a_src + h * kC, lane);
  const float4 ad = load4(a_dst + h * kC, lane);
  if (h == 0 && lane == 0) key[static_cast<int64_t>(m) * f + v] = dv;

  float sd = 0.0f, mx = -INFINITY, l = 0.0f;
  bool have_sd = false;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j0 = 0; j0 < f; j0 += 32) {
    const int nj = min(32, f - j0);
    const int mine = slot_row(i_src, mask, v, f, j0, nj, lane);
    if (h == 0 && lane < nj) key[v * f + j0 + lane] = mine >= 0 ? mine : R;
    unsigned on = __ballot_sync(kAll, mine >= 0);
    while (on) {
      float4 zu[KB];
      bool ok[KB];                    // a prefix: the slots taken this round
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        ok[k] = on != 0;
        const int j = ok[k] ? __ffs(on) - 1 : 0;
        on &= on - 1;
        const int64_t u = __shfl_sync(kAll, mine, j);
        if (ok[k]) zu[k] = load4(z + u * HC + h * kC, lane);
      }
      if (!have_sd) {                 // once the first rows' loads are out
        sd = warp_sum(dot4(ad, zv));
        have_sd = true;
      }
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        if (!ok[k]) break;
        const float e = leaky(warp_sum(dot4(as, zu[k])) + sd);
        if (e > mx) {
          const float c = expf(mx - e);
          l = fmaf(l, c, 1.0f);
          acc.x = fmaf(acc.x, c, zu[k].x);
          acc.y = fmaf(acc.y, c, zu[k].y);
          acc.z = fmaf(acc.z, c, zu[k].z);
          acc.w = fmaf(acc.w, c, zu[k].w);
          mx = e;
        } else {
          const float p = expf(e - mx);
          l += p;
          axpy4(acc, p, zu[k]);
        }
      }
    }
  }
  float4 out = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (l > 0.0f) {
    out = make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
  }
  store4(agg + v * HC + h * kC, lane, out);
  if (lane == 0) lse[v * H + h] = l > 0.0f ? mx + logf(l) : -INFINITY;
}

// Pass 1.  `off[r]` becomes the first sorted entry whose key is >= r, for
// r in [0, R]; gridDim.x is a multiple of H.
__global__ void __launch_bounds__(kThreads)
relation_attend_bwd_dst_kernel(
    const float* __restrict__ z, const float* __restrict__ a_src,
    const float* __restrict__ a_dst, const int32_t* __restrict__ i_src,
    const int32_t* __restrict__ i_dst, const uint8_t* __restrict__ mask,
    const float* __restrict__ agg, const float* __restrict__ lse,
    const float* __restrict__ g, const int32_t* __restrict__ skey,
    int64_t n_keys, int32_t* __restrict__ off, float* __restrict__ alpha,
    float* __restrict__ de, float* __restrict__ sum_de,
    float* __restrict__ partial, int m, int f, int H, int R) {
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       s < n_keys; s += nthreads) {
    const int k = skey[s];
    const int before = s > 0 ? skey[s - 1] : -1;
    for (int r = before + 1; r <= k; ++r) off[r] = static_cast<int32_t>(s);
    if (s == n_keys - 1) {
      for (int r = k + 1; r <= R; ++r) off[r] = static_cast<int32_t>(n_keys);
    }
  }

  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int64_t W = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + wib;
  const int h = static_cast<int>(w % H);             // the same every item
  const int64_t HC = static_cast<int64_t>(H) * kC;
  const float4 as = load4(a_src + h * kC, lane);
  const float4 ad = load4(a_dst + h * kC, lane);
  float4 ga_s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 ga_d = ga_s;
  for (int64_t item = w; item < static_cast<int64_t>(m) * H; item += W) {
    const int64_t v = item / H;
    const float4 zv = load4(z + static_cast<int64_t>(i_dst[v]) * HC + h * kC,
                            lane);
    const float4 gv = load4(g + v * HC + h * kC, lane);
    const float4 av = load4(agg + v * HC + h * kC, lane);
    const float L = lse[v * H + h];
    const float sd = warp_sum(dot4(ad, zv));
    const float D = warp_sum(dot4(gv, av));
    float sde = 0.0f;
    for (int j0 = 0; j0 < f; j0 += 32) {
      const int nj = min(32, f - j0);
      const int mine = slot_row(i_src, mask, v, f, j0, nj, lane);
      unsigned on = __ballot_sync(kAll, mine >= 0);
      while (on) {
        float4 zu[KB];
        int js[KB];
#pragma unroll
        for (int k = 0; k < KB; ++k) {
          js[k] = on ? __ffs(on) - 1 : -1;
          on &= on - 1;
          const int64_t u = __shfl_sync(kAll, mine, js[k] < 0 ? 0 : js[k]);
          if (js[k] >= 0) zu[k] = load4(z + u * HC + h * kC, lane);
        }
#pragma unroll
        for (int k = 0; k < KB; ++k) {
          if (js[k] < 0) break;
          const float x = warp_sum(dot4(as, zu[k])) + sd;
          const float dp = warp_sum(dot4(gv, zu[k]));
          const float a = expf(leaky(x) - L);
          const float ds = a * (dp - D);
          const float d = x > 0.0f ? ds : ds * kSlope;
          if (lane == 0) {
            const int64_t s = (v * f + j0 + js[k]) * H + h;
            alpha[s] = a;
            de[s] = d;
          }
          sde += d;
          axpy4(ga_s, d, zu[k]);
        }
      }
    }
    if (lane == 0) sum_de[v * H + h] = sde;
    axpy4(ga_d, sde, zv);
  }

  __shared__ float4 sh[kWarps][2][32];
  sh[wib][0][lane] = ga_s;
  sh[wib][1][lane] = ga_d;
  __syncthreads();
  // this block's partial (2, H, C) as float4s, its warps summed in order
  for (int e = threadIdx.x; e < 2 * H * 32; e += kThreads) {
    const int which = e / (H * 32), hh = (e / 32) % H, ln = e % 32;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = 0; k < kWarps; ++k) {
      if ((static_cast<int64_t>(blockIdx.x) * kWarps + k) % H != hh) continue;
      const float4 x = sh[k][which][ln];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    reinterpret_cast<float4*>(partial)[static_cast<int64_t>(blockIdx.x) * 2 *
                                           H * 32 + e] = s;
  }
}

// Pass 2: blocks [0, src_blocks) walk the rows, the rest sum the partials.
__global__ void __launch_bounds__(kThreads)
relation_attend_bwd_src_kernel(
    const float* __restrict__ a_src, const float* __restrict__ a_dst,
    const float* __restrict__ g, const int64_t* __restrict__ order,
    const int32_t* __restrict__ off, const float* __restrict__ alpha,
    const float* __restrict__ de, const float* __restrict__ sum_de,
    const float* __restrict__ partial, int n_partials,
    float* __restrict__ grad_z, float* __restrict__ grad_a_src,
    float* __restrict__ grad_a_dst, int m, int f, int H, int R,
    int src_blocks) {
  if (static_cast<int>(blockIdx.x) >= src_blocks) {
    const int e = (blockIdx.x - src_blocks) * kThreads + threadIdx.x;
    const int n = H * kC;
    if (e >= 2 * n) return;
    float s = 0.0f;
    for (int b = 0; b < n_partials; ++b) {
      s += partial[static_cast<int64_t>(b) * 2 * n + e];
    }
    if (e < n) {
      grad_a_src[e] = s;
    } else {
      grad_a_dst[e - n] = s;
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (w >= static_cast<int64_t>(R) * H) return;      // the whole warp
  const int64_t u = w / H;
  const int h = static_cast<int>(w % H);
  const int64_t HC = static_cast<int64_t>(H) * kC;
  const int64_t mf = static_cast<int64_t>(m) * f;
  const int s0 = off[u], s1 = off[u + 1];
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float sd_src = 0.0f, sd_dst = 0.0f;
  for (int b = s0; b < s1; b += 32) {
    const int n = min(32, s1 - b);
    // lane k holds entry b + k: its slot's alpha and de, or its
    // destination's sum of de (v < 0 marks a destination entry)
    int v = 0;
    float a = 0.0f, d = 0.0f;
    if (lane < n) {
      const int64_t idx = order[b + lane];
      if (idx < mf) {
        v = static_cast<int>(idx / f);
        a = alpha[idx * H + h];
        d = de[idx * H + h];
      } else {
        v = -1;
        d = sum_de[(idx - mf) * H + h];
      }
    }
    for (int k0 = 0; k0 < n; k0 += KB) {
      float4 gv[KB];
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        const int64_t vk = __shfl_sync(kAll, v, (k0 + k) & 31);
        if (k0 + k < n && vk >= 0) gv[k] = load4(g + vk * HC + h * kC, lane);
      }
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        const int src = (k0 + k) & 31;
        const int vk = __shfl_sync(kAll, v, src);
        const float ak = __shfl_sync(kAll, a, src);
        const float dk = __shfl_sync(kAll, d, src);
        if (k0 + k >= n) break;
        if (vk >= 0) {
          axpy4(acc, ak, gv[k]);
          sd_src += dk;
        } else {
          sd_dst += dk;
        }
      }
    }
  }
  const float4 as = load4(a_src + h * kC, lane);
  const float4 ad = load4(a_dst + h * kC, lane);
  axpy4(acc, sd_src, as);
  axpy4(acc, sd_dst, ad);
  store4(grad_z + u * HC + h * kC, lane, acc);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

int blocks_for(int64_t warps) {
  return static_cast<int>((warps + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" {

int relation_attend_fwd(const float* z, const float* a_src,
                        const float* a_dst, const int32_t* i_src,
                        const int32_t* i_dst, const uint8_t* mask, float* agg,
                        float* lse, int32_t* key, int m, int f, int H, int R,
                        cudaStream_t stream) {
  const int blocks = blocks_for(static_cast<int64_t>(m) * H);
  relation_attend_fwd_kernel<<<blocks, kThreads, 0, stream>>>(
      z, a_src, a_dst, i_src, i_dst, mask, agg, lse, key, m, f, H, R);
  return static_cast<int>(cudaGetLastError());
}

// Pass 1's grid: as many blocks as the card keeps resident (fewer where
// there are fewer (destination, head) pairs), rounded up to a multiple of
// H.  The wrapper sizes the partials, one (2, H, C) a block, from it.
int relation_attend_bwd_blocks(int m, int H) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, relation_attend_bwd_dst_kernel, kThreads, 0);
  int64_t blocks = static_cast<int64_t>(sm_count()) * (per_sm > 0 ? per_sm : 1);
  const int64_t needed = blocks_for(static_cast<int64_t>(m) * H);
  if (needed < blocks) blocks = needed;
  blocks = (blocks + H - 1) / H * H;
  return static_cast<int>(blocks);
}

int relation_attend_bwd(const float* z, const float* a_src,
                        const float* a_dst, const int32_t* i_src,
                        const int32_t* i_dst, const uint8_t* mask,
                        const float* agg, const float* lse, const float* g,
                        const int32_t* skey, const int64_t* order,
                        int32_t* off, float* alpha, float* de, float* sum_de,
                        float* partial, int n_partials, float* grad_z,
                        float* grad_a_src, float* grad_a_dst, int m, int f,
                        int H, int R, cudaStream_t stream) {
  const int64_t n_keys = static_cast<int64_t>(m) * f + m;
  relation_attend_bwd_dst_kernel<<<n_partials, kThreads, 0, stream>>>(
      z, a_src, a_dst, i_src, i_dst, mask, agg, lse, g, skey, n_keys, off,
      alpha, de, sum_de, partial, m, f, H, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int src_blocks = blocks_for(static_cast<int64_t>(R) * H);
  const int sum_blocks = (2 * H * kC + kThreads - 1) / kThreads;
  relation_attend_bwd_src_kernel<<<src_blocks + sum_blocks, kThreads, 0,
                                   stream>>>(
      a_src, a_dst, g, order, off, alpha, de, sum_de, partial, n_partials,
      grad_z, grad_a_src, grad_a_dst, m, f, H, R, src_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
