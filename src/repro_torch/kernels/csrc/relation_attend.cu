// relation_attend: R-GAT's attention over one relation's block, forward and
// backward, reading the projected source rows z (R, H, C) by index.  For a
// destination v with slots j (source rows i_src[v, j], mask[v, j]), its
// score s_dst[v, h] and head h:
//
//   e_vj  = LeakyReLU_0.2(a_src[h] . z[i_src[v, j], h] + s_dst[v, h])
//   alpha = softmax over v's unmasked slots of e_vj
//   agg[v, h] = sum_j alpha_vj z[i_src[v, j], h]
//
// s_dst = a_dst . (W x_v) per head comes in from the caller, which folds
// W into a_dst (`models/rgat.py`), so z holds source rows only.
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
// of H * C floats), the indices, mask and s_dst, agg (m, H * C) written;
// the backward reads z, agg and its gradient once and writes grad_z.  A slot's
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
// of every slot (its source row, or R where masked), for the backward's
// source-major pass.  A destination with no unmasked slot gets zeros.
//
// Backward, two passes and no float atomics, so a gradient is the same in
// every run:
//  1. destination-major, a persistent grid whose warp count is a multiple
//     of H, so each warp keeps one head: per slot the score again, alpha =
//     exp(e - lse), dp = <g_v, z_u>, ds = alpha (dp - D_v) with D_v = <g_v,
//     agg_v> (the flash-attention identity), de = ds * LeakyReLU'.  It
//     writes alpha and de per slot (m, f, H) and grad_s_dst = sum_j de per
//     destination, and accumulates grad_a_src = sum de z_u in registers,
//     reduced per block in shared memory into one partial a block.  Its
//     threads also turn the sorted keys into each row's range of slots.
//  2. source-major: one warp per (row u, head) walks u's slots in the
//     stably sorted order (flat slot order) and writes grad_z[u] = sum
//     alpha g_v + (sum de) a_src once.  Extra blocks sum the partials in
//     block order.
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
                           const float* __restrict__ s_dst,
                           const int32_t* __restrict__ i_src,
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
  const float4 as = load4(a_src + h * kC, lane);
  const float sd = s_dst[v * H + h];

  float mx = -INFINITY, l = 0.0f;
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
    const float* __restrict__ s_dst, const int32_t* __restrict__ i_src,
    const uint8_t* __restrict__ mask, const float* __restrict__ agg,
    const float* __restrict__ lse, const float* __restrict__ g,
    const int32_t* __restrict__ skey, int64_t n_keys,
    int32_t* __restrict__ off, float* __restrict__ alpha,
    float* __restrict__ de, float* __restrict__ grad_s_dst,
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
  float4 ga_s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int64_t item = w; item < static_cast<int64_t>(m) * H; item += W) {
    const int64_t v = item / H;
    const float4 gv = load4(g + v * HC + h * kC, lane);
    const float4 av = load4(agg + v * HC + h * kC, lane);
    const float L = lse[v * H + h];
    const float sd = s_dst[v * H + h];
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
    if (lane == 0) grad_s_dst[v * H + h] = sde;
  }

  __shared__ float4 sh[kWarps][32];
  sh[wib][lane] = ga_s;
  __syncthreads();
  // this block's partial (H, C) as float4s, its warps summed in order
  for (int e = threadIdx.x; e < H * 32; e += kThreads) {
    const int hh = e / 32, ln = e % 32;
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = 0; k < kWarps; ++k) {
      if ((static_cast<int64_t>(blockIdx.x) * kWarps + k) % H != hh) continue;
      const float4 x = sh[k][ln];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    reinterpret_cast<float4*>(partial)[static_cast<int64_t>(blockIdx.x) * H *
                                           32 + e] = s;
  }
}

// Pass 2: blocks [0, src_blocks) walk the rows, the rest sum the partials.
__global__ void __launch_bounds__(kThreads)
relation_attend_bwd_src_kernel(
    const float* __restrict__ a_src, const float* __restrict__ g,
    const int64_t* __restrict__ order, const int32_t* __restrict__ off,
    const float* __restrict__ alpha, const float* __restrict__ de,
    const float* __restrict__ partial, int n_partials,
    float* __restrict__ grad_z, float* __restrict__ grad_a_src, int f, int H,
    int R, int src_blocks) {
  if (static_cast<int>(blockIdx.x) >= src_blocks) {
    const int e = (blockIdx.x - src_blocks) * kThreads + threadIdx.x;
    const int n = H * kC;
    if (e >= n) return;
    float s = 0.0f;
    for (int b = 0; b < n_partials; ++b) {
      s += partial[static_cast<int64_t>(b) * n + e];
    }
    grad_a_src[e] = s;
    return;
  }
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (w >= static_cast<int64_t>(R) * H) return;      // the whole warp
  const int64_t u = w / H;
  const int h = static_cast<int>(w % H);
  const int64_t HC = static_cast<int64_t>(H) * kC;
  const int s0 = off[u], s1 = off[u + 1];
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float sde = 0.0f;
  for (int b = s0; b < s1; b += 32) {
    const int n = min(32, s1 - b);
    // lane k holds slot b + k of the sorted order: its destination, alpha
    // and de
    int v = 0;
    float a = 0.0f, d = 0.0f;
    if (lane < n) {
      const int64_t idx = order[b + lane];
      v = static_cast<int>(idx / f);
      a = alpha[idx * H + h];
      d = de[idx * H + h];
    }
    for (int k0 = 0; k0 < n; k0 += KB) {
      float4 gv[KB];
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        const int64_t vk = __shfl_sync(kAll, v, (k0 + k) & 31);
        if (k0 + k < n) gv[k] = load4(g + vk * HC + h * kC, lane);
      }
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        const int src = (k0 + k) & 31;
        const float ak = __shfl_sync(kAll, a, src);
        const float dk = __shfl_sync(kAll, d, src);
        if (k0 + k >= n) break;
        axpy4(acc, ak, gv[k]);
        sde += dk;
      }
    }
  }
  const float4 as = load4(a_src + h * kC, lane);
  axpy4(acc, sde, as);
  store4(grad_z + u * HC + h * kC, lane, acc);
}

// fold_scores: the destinations' scores of one R-GAT layer, every
// relation's W_r folded into its a_dst (`models/rgat.py` `_dst_scores`):
//
//   s[v, j] = sum_d h[pos[v], d] ut[j, d]          (n, J), J <= 32
//
// read from h by row position, so the level's rows are never gathered into
// a tensor of their own; backward dut[j] = sum_v ds[v, j] h[pos[v]] and
// dh[pos[v]] = sum_j ds[v, j] ut[j] (pos holds distinct rows).
//
// Bound on an H100 SXM: bytes, h's n rows read once forward and once
// backward (4 n d B each; 0.28 GB at layer 0 of a 1024-seed rgat3-igbh
// batch, ~0.08 ms), at 2 J / 4 flops a byte.  There the gather h[pos]
// alone took 0.20 ms and cuBLAS 0.18-0.27 ms for the skinny (n, d) x
// (d, J) product and 0.15 for its dut; these kernels read each row once,
// coalesced, forward 0.27 ms and backward 0.19: ut's chunk in registers
// (128 of them at J 32) leaves 8 warps an SM, too few to cover the loads'
// latency, so the rows' positions are loaded two groups ahead and the rows
// one (0.29 and 0.25 without).  Blocks of 4 warps over half of d read the
// same (registers, not the block's shape, cap the warps); a warp a half of
// the columns, 0.42 forward (spills); one row a thread, ut in shared memory
// read by broadcast, 0.47 forward.
//
// Layout: a block's d / 128 warps split d into 128-float chunks; lane l
// holds floats [4 l, 4 l + 4) of its warp's chunk, and ut's J rows of that
// chunk in registers.  The block walks groups of kRows rows, its warps
// together, each warp loading the next group's rows and the positions of
// the group after while it works on this one.  Forward: a warp's J
// partial dot products of a row are summed over its lanes by a transposing
// butterfly (31 shuffles, lane j ends with column j), then over the warps
// in warp order through shared memory.
// Backward: dut as one (J, d) partial a block, summed over the blocks in
// block order by a second launch; dh row by row.  No atomics: the same
// inputs give the same bits.
constexpr int kJ = 32;            // most columns: one a lane
constexpr int kRows = 4;          // rows a block takes at a time
constexpr int kChunks = kWarps;   // most 128-float chunks of d: d <= 1024

// One step of the transposing butterfly: lanes with bit O keep the upper
// O of their values and add their partner's, the others the lower O.
template <int O>
__device__ __forceinline__ void butterfly(float (&p)[kJ], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float send = up ? p[k] : p[k + O];
    const float keep = up ? p[k + O] : p[k];
    p[k] = keep + __shfl_xor_sync(kAll, send, O);
  }
}

// p[j] summed over the warp's lanes lands in lane j
__device__ __forceinline__ float transpose_sum(float (&p)[kJ], int lane) {
  butterfly<16>(p, lane);
  butterfly<8>(p, lane);
  butterfly<4>(p, lane);
  butterfly<2>(p, lane);
  butterfly<1>(p, lane);
  return p[0];
}

__device__ __forceinline__ void load_chunk(float4 (&u)[kJ],
                                           const float* __restrict__ ut,
                                           int d, int J, int w, int lane) {
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    u[j] = j < J ? load4(ut + static_cast<int64_t>(j) * d + w * kC, lane)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// The positions of rows v0 .. v0 + kRows - 1, -1 past n.
__device__ __forceinline__ void load_pos(int64_t (&p)[kRows],
                                         const int64_t* __restrict__ pos,
                                         int64_t v0, int64_t n) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) p[r] = v0 + r < n ? pos[v0 + r] : -1;
}

// The warp's chunk of the rows at p (zeros where -1).
__device__ __forceinline__ void load_rows(float4 (&x)[kRows],
                                          const float* __restrict__ h,
                                          const int64_t (&p)[kRows], int d,
                                          int w, int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    x[r] = p[r] >= 0 ? load4(h + p[r] * d + w * kC, lane)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Lane j < J: ds[v, j] of the rows v0 .. v0 + kRows - 1 (zeros past n).
__device__ __forceinline__ void load_grads(float (&g)[kRows],
                                           const float* __restrict__ ds,
                                           int64_t v0, int64_t n, int J,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    g[r] = v0 + r < n && lane < J ? ds[(v0 + r) * J + lane] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
fold_scores_fwd_kernel(const float* __restrict__ h,
                       const int64_t* __restrict__ pos,
                       const float* __restrict__ ut, float* __restrict__ s,
                       int64_t n, int d, int J) {
  __shared__ float red[kRows][kChunks][kJ];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kRows;
  float4 u[kJ];
  load_chunk(u, ut, d, J, w, lane);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRows;
  int64_t p[kRows];
  float4 x[kRows];
  load_pos(p, pos, first, n);
  load_rows(x, h, p, d, w, lane);
  load_pos(p, pos, first + step, n);
  for (int64_t v0 = first; v0 < n; v0 += step) {
    float4 next[kRows];
    load_rows(next, h, p, d, w, lane);
    load_pos(p, pos, v0 + 2 * step, n);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float p[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) p[j] = dot4(x[r], u[j]);
      red[r][w][lane] = transpose_sum(p, lane);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kRows * J; e += blockDim.x) {
      const int r = e / J, j = e % J;
      if (v0 + r >= n) continue;
      float acc = 0.0f;
      for (int k = 0; k < W; ++k) acc += red[r][k][j];
      s[(v0 + r) * J + j] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRows; ++r) x[r] = next[r];
  }
}

// Each block's share of the rows into partial[blockIdx.x] (J, d).
__global__ void __launch_bounds__(kThreads)
fold_scores_bwd_u_kernel(const float* __restrict__ h,
                         const int64_t* __restrict__ pos,
                         const float* __restrict__ ds,
                         float* __restrict__ partial, int64_t n, int d,
                         int J) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kRows;
  float4 acc[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 x[kRows];
  float g[kRows];
  int64_t p[kRows];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRows;
  load_pos(p, pos, first, n);
  load_rows(x, h, p, d, w, lane);
  load_grads(g, ds, first, n, J, lane);
  load_pos(p, pos, first + step, n);
  for (int64_t v0 = first; v0 < n; v0 += step) {
    float4 next[kRows];
    float next_g[kRows];
    load_rows(next, h, p, d, w, lane);
    load_grads(next_g, ds, v0 + step, n, J, lane);
    load_pos(p, pos, v0 + 2 * step, n);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        axpy4(acc[j], __shfl_sync(kAll, g[r], j), x[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      x[r] = next[r];
      g[r] = next_g[r];
    }
  }
  float* out = partial + static_cast<int64_t>(blockIdx.x) * J * d;
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if (j < J) {
      store4(out + static_cast<int64_t>(j) * d + w * kC, lane, acc[j]);
    }
  }
}

// dut[e] = sum of the partials in block order, e over J * d.
__global__ void __launch_bounds__(kThreads)
fold_scores_sum_kernel(const float* __restrict__ partial, int n_partials,
                       float* __restrict__ dut, int64_t size) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= size) return;
  float acc = 0.0f;
  for (int b = 0; b < n_partials; ++b) acc += partial[b * size + e];
  dut[e] = acc;
}

// dh[pos[v]] = sum_j ds[v, j] ut[j]; rows of dh that pos does not name
// are left as they are.
__global__ void __launch_bounds__(kThreads)
fold_scores_bwd_h_kernel(const int64_t* __restrict__ pos,
                         const float* __restrict__ ut,
                         const float* __restrict__ ds, float* __restrict__ dh,
                         int64_t n, int d, int J) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float4 u[kJ];
  load_chunk(u, ut, d, J, w, lane);
  for (int64_t v = blockIdx.x; v < n; v += gridDim.x) {
    const float g = lane < J ? ds[v * J + lane] : 0.0f;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < kJ; ++j) axpy4(acc, __shfl_sync(kAll, g, j), u[j]);
    store4(dh + pos[v] * d + w * kC, lane, acc);
  }
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
                        const float* s_dst, const int32_t* i_src,
                        const uint8_t* mask, float* agg, float* lse,
                        int32_t* key, int m, int f, int H, int R,
                        cudaStream_t stream) {
  const int blocks = blocks_for(static_cast<int64_t>(m) * H);
  relation_attend_fwd_kernel<<<blocks, kThreads, 0, stream>>>(
      z, a_src, s_dst, i_src, mask, agg, lse, key, m, f, H, R);
  return static_cast<int>(cudaGetLastError());
}

// Pass 1's grid: as many blocks as the card keeps resident (fewer where
// there are fewer (destination, head) pairs), rounded up to a multiple of
// H.  The wrapper sizes the partials, one (H, C) a block, from it.
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
                        const float* s_dst, const int32_t* i_src,
                        const uint8_t* mask, const float* agg,
                        const float* lse, const float* g, const int32_t* skey,
                        const int64_t* order, int32_t* off, float* alpha,
                        float* de, float* partial, int n_partials,
                        float* grad_z, float* grad_a_src, float* grad_s_dst,
                        int m, int f, int H, int R, cudaStream_t stream) {
  const int64_t n_keys = static_cast<int64_t>(m) * f;
  relation_attend_bwd_dst_kernel<<<n_partials, kThreads, 0, stream>>>(
      z, a_src, s_dst, i_src, mask, agg, lse, g, skey, n_keys, off, alpha, de,
      grad_s_dst, partial, m, f, H, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int src_blocks = blocks_for(static_cast<int64_t>(R) * H);
  const int sum_blocks = (H * kC + kThreads - 1) / kThreads;
  relation_attend_bwd_src_kernel<<<src_blocks + sum_blocks, kThreads, 0,
                                   stream>>>(
      a_src, g, order, off, alpha, de, partial, n_partials, grad_z,
      grad_a_src, f, H, R, src_blocks);
  return static_cast<int>(cudaGetLastError());
}

// The fold_scores launches: blocks of d / 128 warps, as many as the card
// keeps resident (fewer where there are fewer row groups).
int fold_scores_blocks(int64_t n, int d) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fold_scores_bwd_u_kernel, d / kC * 32, 0);
  const int64_t blocks =
      static_cast<int64_t>(sm_count()) * (per_sm > 0 ? per_sm : 1);
  const int64_t needed = (n + kRows - 1) / kRows;
  return static_cast<int>(needed < blocks ? needed : blocks);
}

int fold_scores_fwd(const float* h, const int64_t* pos, const float* ut,
                    float* s, int64_t n, int d, int J, int blocks,
                    cudaStream_t stream) {
  fold_scores_fwd_kernel<<<blocks, d / kC * 32, 0, stream>>>(h, pos, ut, s, n,
                                                             d, J);
  return static_cast<int>(cudaGetLastError());
}

// dut (J, d) from ds (n, J), through partial (blocks, J, d); and dh's rows
// pos where dh is not null.
int fold_scores_bwd(const float* h, const int64_t* pos, const float* ut,
                    const float* ds, float* partial, float* dut, float* dh,
                    int64_t n, int d, int J, int blocks, cudaStream_t stream) {
  const int threads = d / kC * 32;
  fold_scores_bwd_u_kernel<<<blocks, threads, 0, stream>>>(h, pos, ds,
                                                           partial, n, d, J);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t size = static_cast<int64_t>(J) * d;
  fold_scores_sum_kernel<<<static_cast<int>((size + kThreads - 1) / kThreads),
                           kThreads, 0, stream>>>(partial, blocks, dut, size);
  err = cudaGetLastError();
  if (err != cudaSuccess || dh == nullptr) return static_cast<int>(err);
  fold_scores_bwd_h_kernel<<<blocks * kRows, threads, 0, stream>>>(
      pos, ut, ds, dh, n, d, J);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
