// hgt_attend: HGT's attention (arXiv:2003.01332, Eqs. 3-4) over every
// relation into a destination at once, forward and backward, reading the
// relation-transformed rows k' and v' (R, H, D) by index.  For a destination
// t with slots s in [indptr[t], indptr[t + 1]) (rows idx[s]: every unmasked
// slot of every relation into t's type, relation by relation) and head h:
//
//   e_ts   = q[t, h] . k'[idx[s], h]      (mu_r / sqrt(D) folded into k')
//   alpha  = softmax over ALL of t's slots of e_ts
//   out[t, h] = sum_s alpha_ts v'[idx[s], h]        (0 where t has none)
//
// Replaces no TPU kernel: HGT has no JAX original.  It was added because
// no kernel of the port normalises over several relations' slots together
// (`relation_attend` takes one relation's block at a time, with additive
// LeakyReLU scores at C = 128), and the torch path it replaces would build
// the (S, H, D) gathers of k' and v' and their gradients (~0.9 GB each at
// layer 0 of a 1024-seed IGBH batch) plus scatter-max and scatter-sum.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  A slot costs 2 flops a float
// of its two rows against 8 bytes read.  The least traffic is q, k', v'
// read once, indptr and idx, out and the log-sum-exp written; the
// backward reads those and the output's gradient g and writes dq, dk', dv'.
// A row that several slots name is read again from L2 where it is still
// there, so the traffic lies between the distinct rows and 2 KB a slot.
//
// Layout: one warp per destination, all 8 heads; lane l holds floats
// [8 l, 8 l + 8) of a 256-float row, so a head is 4 lanes and its dot
// product a 2-step shuffle within them; a row is one coalesced 1 KB load.
// Lanes load 32 slots' indices together; KB slots' k' and v' rows are in
// flight before the first is used.  The softmax is online (running max,
// running sum, accumulator, as flash attention over keys), in slot order:
// no score tensor, one pass.  It writes out and the log-sum-exp (n, H).
//
// Backward, two passes and no float atomics, so a gradient is the same in
// every run:
//  1. destination-major, one warp per destination: per slot the score
//     again, alpha = exp(e - lse), dp = <g_t, v'_s>, ds = alpha (dp - D_t)
//     with D_t = <g_t, out_t> (the flash-attention identity); dq_t = sum_s
//     ds k'_s written once; alpha, ds (S, H) and each slot's destination
//     written for pass 2.  Its threads also turn the slots' rows, sorted
//     stably by the wrapper, into each row's range of slots.
//  2. row-major, one warp per row r of k'/v': walks r's slots in the
//     stable order and writes dk'_r = sum ds q_t and dv'_r = sum alpha g_t
//     once.
//
// Float32 throughout: expf and logf, no fast-math, the dot products as
// explicit fmaf chains so that both passes compute each score to the bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH = 8;             // heads
constexpr int kD = 32;            // a head's width
constexpr int kWidth = kH * kD;   // a row: 256 floats, 8 a lane
constexpr int kWarps = 8;         // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int KB = 4;             // slots' rows in flight a warp
constexpr unsigned kAll = 0xffffffffu;

struct F8 {
  float4 a, b;
};

__device__ __forceinline__ F8 zero8() {
  return {make_float4(0.0f, 0.0f, 0.0f, 0.0f),
          make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
}

// lane's 8 floats of a 256-float row
__device__ __forceinline__ F8 load8(const float* row, int lane) {
  const float4* p = reinterpret_cast<const float4*>(row) + 2 * lane;
  return {p[0], p[1]};
}

__device__ __forceinline__ void store8(float* row, int lane, const F8& x) {
  float4* p = reinterpret_cast<float4*>(row) + 2 * lane;
  p[0] = x.a;
  p[1] = x.b;
}

__device__ __forceinline__ float dot8(const F8& x, const F8& y) {
  float s = x.a.x * y.a.x;
  s = fmaf(x.a.y, y.a.y, s);
  s = fmaf(x.a.z, y.a.z, s);
  s = fmaf(x.a.w, y.a.w, s);
  s = fmaf(x.b.x, y.b.x, s);
  s = fmaf(x.b.y, y.b.y, s);
  s = fmaf(x.b.z, y.b.z, s);
  return fmaf(x.b.w, y.b.w, s);
}

// the sum over a head's 4 lanes, the same bits in each of them
__device__ __forceinline__ float head_sum(float x) {
  x += __shfl_xor_sync(kAll, x, 1);
  return x + __shfl_xor_sync(kAll, x, 2);
}

__device__ __forceinline__ void axpy8(F8& acc, float a, const F8& x) {
  acc.a.x = fmaf(a, x.a.x, acc.a.x);
  acc.a.y = fmaf(a, x.a.y, acc.a.y);
  acc.a.z = fmaf(a, x.a.z, acc.a.z);
  acc.a.w = fmaf(a, x.a.w, acc.a.w);
  acc.b.x = fmaf(a, x.b.x, acc.b.x);
  acc.b.y = fmaf(a, x.b.y, acc.b.y);
  acc.b.z = fmaf(a, x.b.z, acc.b.z);
  acc.b.w = fmaf(a, x.b.w, acc.b.w);
}

// acc * c + x
__device__ __forceinline__ void rescale_add8(F8& acc, float c, const F8& x) {
  acc.a.x = fmaf(acc.a.x, c, x.a.x);
  acc.a.y = fmaf(acc.a.y, c, x.a.y);
  acc.a.z = fmaf(acc.a.z, c, x.a.z);
  acc.a.w = fmaf(acc.a.w, c, x.a.w);
  acc.b.x = fmaf(acc.b.x, c, x.b.x);
  acc.b.y = fmaf(acc.b.y, c, x.b.y);
  acc.b.z = fmaf(acc.b.z, c, x.b.z);
  acc.b.w = fmaf(acc.b.w, c, x.b.w);
}

__device__ __forceinline__ F8 scale8(const F8& x, float c) {
  return {make_float4(x.a.x * c, x.a.y * c, x.a.z * c, x.a.w * c),
          make_float4(x.b.x * c, x.b.y * c, x.b.z * c, x.b.w * c)};
}

__global__ void __launch_bounds__(kThreads)
hgt_attend_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const int32_t* __restrict__ indptr,
                      const int32_t* __restrict__ idx, float* __restrict__ out,
                      float* __restrict__ lse, int n) {
  const int lane = threadIdx.x & 31;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (t >= n) return;                                 // the whole warp
  const F8 qt = load8(q + t * kWidth, lane);
  const int s0 = indptr[t], s1 = indptr[t + 1];
  float mx = -INFINITY, l = 0.0f;
  F8 acc = zero8();
  for (int b = s0; b < s1; b += 32) {
    const int nb = min(32, s1 - b);
    const int mine = lane < nb ? idx[b + lane] : 0;
    for (int j0 = 0; j0 < nb; j0 += KB) {
      F8 kr[KB], vr[KB];
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        const int64_t r = __shfl_sync(kAll, mine, (j0 + j) & 31);
        if (j0 + j < nb) {
          kr[j] = load8(k + r * kWidth, lane);
          vr[j] = load8(v + r * kWidth, lane);
        }
      }
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        if (j0 + j >= nb) break;
        const float e = head_sum(dot8(qt, kr[j]));
        if (e > mx) {
          const float c = expf(mx - e);
          l = fmaf(l, c, 1.0f);
          rescale_add8(acc, c, vr[j]);
          mx = e;
        } else {
          const float p = expf(e - mx);
          l += p;
          axpy8(acc, p, vr[j]);
        }
      }
    }
  }
  store8(out + t * kWidth, lane, l > 0.0f ? scale8(acc, 1.0f / l) : zero8());
  if ((lane & 3) == 0) {
    lse[t * kH + (lane >> 2)] = l > 0.0f ? mx + logf(l) : -INFINITY;
  }
}

// Pass 1.  `off[r]` becomes the first sorted slot whose row is >= r, for r
// in [0, R].
__global__ void __launch_bounds__(kThreads)
hgt_attend_bwd_dst_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int32_t* __restrict__ indptr,
    const int32_t* __restrict__ idx, const float* __restrict__ out,
    const float* __restrict__ lse, const float* __restrict__ g,
    const int32_t* __restrict__ skey, int32_t* __restrict__ off,
    float* __restrict__ alpha, float* __restrict__ ds,
    int32_t* __restrict__ slot_dst, float* __restrict__ dq, int n, int S,
    int R) {
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       s < S; s += nthreads) {
    const int key = skey[s];
    const int before = s > 0 ? skey[s - 1] : -1;
    for (int r = before + 1; r <= key; ++r) off[r] = static_cast<int32_t>(s);
    if (s == S - 1) {
      for (int r = key + 1; r <= R; ++r) off[r] = S;
    }
  }

  const int lane = threadIdx.x & 31;
  const int head = lane >> 2;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (t >= n) return;                                 // the whole warp
  const F8 qt = load8(q + t * kWidth, lane);
  const F8 gt = load8(g + t * kWidth, lane);
  const float D = head_sum(dot8(gt, load8(out + t * kWidth, lane)));
  const float L = lse[t * kH + head];
  const int s0 = indptr[t], s1 = indptr[t + 1];
  F8 acc = zero8();
  for (int b = s0; b < s1; b += 32) {
    const int nb = min(32, s1 - b);
    const int mine = lane < nb ? idx[b + lane] : 0;
    if (lane < nb) slot_dst[b + lane] = static_cast<int32_t>(t);
    for (int j0 = 0; j0 < nb; j0 += KB) {
      F8 kr[KB], vr[KB];
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        const int64_t r = __shfl_sync(kAll, mine, (j0 + j) & 31);
        if (j0 + j < nb) {
          kr[j] = load8(k + r * kWidth, lane);
          vr[j] = load8(v + r * kWidth, lane);
        }
      }
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        if (j0 + j >= nb) break;
        const float e = head_sum(dot8(qt, kr[j]));
        const float dp = head_sum(dot8(gt, vr[j]));
        const float a = expf(e - L);
        const float d = a * (dp - D);
        axpy8(acc, d, kr[j]);
        if ((lane & 3) == 0) {
          const int64_t s = static_cast<int64_t>(b + j0 + j) * kH + head;
          alpha[s] = a;
          ds[s] = d;
        }
      }
    }
  }
  store8(dq + t * kWidth, lane, acc);
}

// Pass 2: one warp per row of k' and v'.
__global__ void __launch_bounds__(kThreads)
hgt_attend_bwd_row_kernel(const float* __restrict__ q,
                          const float* __restrict__ g,
                          const int64_t* __restrict__ order,
                          const int32_t* __restrict__ off,
                          const float* __restrict__ alpha,
                          const float* __restrict__ ds,
                          const int32_t* __restrict__ slot_dst,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int R) {
  const int lane = threadIdx.x & 31;
  const int head = lane >> 2;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (r >= R) return;                                 // the whole warp
  const int s0 = off[r], s1 = off[r + 1];
  F8 ak = zero8(), av = zero8();
  for (int b = s0; b < s1; b += 32) {
    const int nb = min(32, s1 - b);
    // lane j holds sorted slot b + j and its destination
    int64_t slot = 0;
    int dst = 0;
    if (lane < nb) {
      slot = order[b + lane];
      dst = slot_dst[slot];
    }
    for (int j0 = 0; j0 < nb; j0 += KB) {
      F8 qr[KB], gr[KB];
      float a[KB], d[KB];
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        const int64_t t = __shfl_sync(kAll, dst, (j0 + j) & 31);
        const int64_t s = __shfl_sync(kAll, slot, (j0 + j) & 31);
        if (j0 + j < nb) {
          qr[j] = load8(q + t * kWidth, lane);
          gr[j] = load8(g + t * kWidth, lane);
          a[j] = alpha[s * kH + head];
          d[j] = ds[s * kH + head];
        }
      }
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        if (j0 + j >= nb) break;
        axpy8(ak, d[j], qr[j]);
        axpy8(av, a[j], gr[j]);
      }
    }
  }
  store8(dk + r * kWidth, lane, ak);
  store8(dv + r * kWidth, lane, av);
}

int blocks_for(int64_t warps) {
  return static_cast<int>((warps + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" {

int hgt_attend_fwd(const float* q, const float* k, const float* v,
                   const int32_t* indptr, const int32_t* idx, float* out,
                   float* lse, int n, cudaStream_t stream) {
  hgt_attend_fwd_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      q, k, v, indptr, idx, out, lse, n);
  return static_cast<int>(cudaGetLastError());
}

// skey and order: the slots' rows sorted stably and their slot numbers.
// Pass 2 runs where there are slots; the caller zeroes dk and dv where
// there are none.
int hgt_attend_bwd(const float* q, const float* k, const float* v,
                   const int32_t* indptr, const int32_t* idx, const float* out,
                   const float* lse, const float* g, const int32_t* skey,
                   const int64_t* order, int32_t* off, float* alpha, float* ds,
                   int32_t* slot_dst, float* dq, float* dk, float* dv, int n,
                   int S, int R, cudaStream_t stream) {
  hgt_attend_bwd_dst_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      q, k, v, indptr, idx, out, lse, g, skey, off, alpha, ds, slot_dst, dq,
      n, S, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 0) return static_cast<int>(err);
  hgt_attend_bwd_row_kernel<<<blocks_for(R), kThreads, 0, stream>>>(
      q, g, order, off, alpha, ds, slot_dst, dk, dv, R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
