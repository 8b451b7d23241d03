// gat_attend: GAT's attention over a destination's fixed fanout, forward
// and backward, reading the two projections in place.  For a destination t
// with its f sampled slots j (slot rows zn[t, j], all present) and head h:
//
//   s_tj  = <zd[t, h], a_src[h]> + <zn[t, j, h], a_dst[h]>
//   e_tj  = LeakyReLU_0.2(s_tj)
//   alpha = softmax over t's f slots of e_tj
//   agg[t, h] = sum_j alpha_tj zn[t, j, h]
//
// zd = x_dst W_self and zn = x_nbr W_nbr are computed by the caller
// (`models/gnn.py` `GNN._layer`) exactly as the reference computes them.
//
// Replaces no TPU kernel: the JAX package leaves GAT's attention to XLA.
// It was added because the eager chain it replaces (two broadcast products
// and sums for the scores, the LeakyReLU, the softmax over the slots, a
// broadcast product with zn and its sum, and autograd's mirror of each)
// passes over zn ~15 times a step forward and backward, ~2.9 GB at a
// 1024-seed IGB batch.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  A slot costs ~4 flops a float
// against 4 bytes read.  The least traffic is zd and zn read once and agg
// and the softmax's max and sum written; the backward reads zd, zn, the
// output's gradient g and those statistics, and writes dzd and dzn once.
// To sum the attention vectors' gradients as torch does it also writes the
// products they are summed from, as large as zd and zn.
//
// Layout: one warp per destination, all 4 heads; lane l holds floats
// [4 l, 4 l + 4) of a 128-float row, so a head is 8 lanes and its dot
// product three shuffles among them and two adds in a lane, and a row is
// one coalesced 512 B load.  A destination's f slot rows are loaded into
// registers at once (the kernels are instantiated for each f up to kMaxF)
// and used from there: zn is read once in each direction.  Each slot owns
// its row of zn, so the backward writes dzn_j straight to slot j's row: no
// sort and no atomic, and every result is the same in every run.
//
// Every number is the eager chain's to the bit, so that a training step
// through the kernels follows the reference step for step.  Sums of
// floats are not associative, and a score within rounding of 0 takes the
// LeakyReLU's slope by its sign, so a step summed in another order drifts
// from the reference by more than rounding once a score near 0 falls on
// the other side.  So each operation rounds where torch's does
// (__fmul_rn / __fadd_rn keep nvcc from contracting a product and a sum
// that torch rounds apart, fmaf where torch's kernel contracts), and each
// sum runs in the order of torch's kernel for it: a head's 32-float dot
// product as ATen's warp reduction (`head_dot`), a sum over the f slots as
// ATen's per-thread reduction with four accumulators (`SlotSum`), the
// softmax as ATen's spatial softmax (max, then expf(e - max) summed in
// slot order, alpha = expf(e - max) / sum; backward p = da alpha, then
// p - alpha sum_k p_k, the sum in slot order and the last step one fmaf).
// The attention vectors' gradients are sums over every slot of a level,
// whose order in torch depends on its grid; the backward writes the
// products they are summed from, and the wrapper sums them with torch's
// own reduction.  No fast-math.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH = 4;             // heads
constexpr int kC = 32;            // a head's width
constexpr int kLanes = 32;        // float4s a 128-float row
constexpr int kWarps = 8;         // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxF = 16;         // the largest fanout instantiated
constexpr float kSlope = 0.2f;
constexpr unsigned kAll = 0xffffffffu;

static_assert(kH * kC == 4 * kLanes, "a lane holds one float4 of a row");

__device__ __forceinline__ float4 mul4(const float4& x, const float4& y) {
  return make_float4(__fmul_rn(x.x, y.x), __fmul_rn(x.y, y.y),
                     __fmul_rn(x.z, y.z), __fmul_rn(x.w, y.w));
}

__device__ __forceinline__ float4 scale4(float a, const float4& x) {
  return make_float4(__fmul_rn(a, x.x), __fmul_rn(a, x.y),
                     __fmul_rn(a, x.z), __fmul_rn(a, x.w));
}

__device__ __forceinline__ float4 add4(const float4& x, const float4& y) {
  return make_float4(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y),
                     __fadd_rn(x.z, y.z), __fadd_rn(x.w, y.w));
}

__device__ __forceinline__ float4 shfl_xor4(const float4& x, int mask) {
  return make_float4(__shfl_xor_sync(kAll, x.x, mask),
                     __shfl_xor_sync(kAll, x.y, mask),
                     __shfl_xor_sync(kAll, x.z, mask),
                     __shfl_xor_sync(kAll, x.w, mask));
}

// A head's dot product, the same bits in each of its 8 lanes, summed as
// torch's `(x * y).sum(-1)` over 32 floats: one warp a row, product c in
// lane c, shuffled down by 16, 8, 4, 2, 1 (`block_x_reduce` in ATen's
// Reduce.cuh).  Here product c = 4 m + k sits in the head's lane m,
// component k, so the first three steps pair lanes 4, 2 and 1 apart and the
// last two pair components.
__device__ __forceinline__ float head_dot(const float4& x, const float4& y) {
  float4 p = mul4(x, y);
  p = add4(p, shfl_xor4(p, 4));     // c + 16
  p = add4(p, shfl_xor4(p, 2));     // c + 8
  p = add4(p, shfl_xor4(p, 1));     // c + 4
  return __fadd_rn(__fadd_rn(p.x, p.z), __fadd_rn(p.y, p.w));
}

__device__ __forceinline__ float leaky(float s) {
  return s > 0.0f ? s : __fmul_rn(s, kSlope);
}

__device__ __forceinline__ float add(float x, float y) {
  return __fadd_rn(x, y);
}

__device__ __forceinline__ float4 add(const float4& x, const float4& y) {
  return add4(x, y);
}

// A sum over the f slots as torch's `.sum(dim=1)` takes it when one thread
// reduces each output (ATen's `thread_reduce_impl`, four accumulators):
// term j goes to accumulator j % 4, in slot order, then
// ((acc0 + acc1) + acc2) + acc3.  `term` is called with j = 0, 1, ... in
// an unrolled loop, so every index is known when it compiles.
template <typename T, int F>
struct SlotSum {
  T acc[4];

  __device__ __forceinline__ void term(int j, const T& x) {
    acc[j & 3] = j < 4 ? x : add(acc[j & 3], x);
  }

  __device__ __forceinline__ T total() const {
    T r = acc[0];
#pragma unroll
    for (int i = 1; i < 4 && i < F; ++i) r = add(r, acc[i]);
    return r;
  }
};

// the destination's pre-activation scores s_j = es + <zn_j, a_dst>
template <int F>
__device__ __forceinline__ void scores(const float4& zd, const float4 (&z)[F],
                                       const float4& as, const float4& ad,
                                       float (&s)[F]) {
  const float es = head_dot(zd, as);
#pragma unroll
  for (int j = 0; j < F; ++j) s[j] = __fadd_rn(es, head_dot(z[j], ad));
}

template <int F>
__global__ void __launch_bounds__(kThreads)
gat_attend_fwd_kernel(const float4* __restrict__ zd,
                      const float4* __restrict__ zn,
                      const float4* __restrict__ a_src,
                      const float4* __restrict__ a_dst,
                      float4* __restrict__ out, float* __restrict__ stats,
                      int n) {
  const int lane = threadIdx.x & 31;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (t >= n) return;                                 // the whole warp
  float4 z[F];
#pragma unroll
  for (int j = 0; j < F; ++j) z[j] = zn[(t * F + j) * kLanes + lane];
  const float4 as = a_src[lane], ad = a_dst[lane];
  float s[F];
  scores<F>(zd[t * kLanes + lane], z, as, ad, s);
  float mx = leaky(s[0]);
#pragma unroll
  for (int j = 0; j < F; ++j) {
    s[j] = leaky(s[j]);
    mx = fmaxf(mx, s[j]);
  }
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < F; ++j) sum = __fadd_rn(sum, expf(__fsub_rn(s[j], mx)));
  SlotSum<float4, F> agg;
#pragma unroll
  for (int j = 0; j < F; ++j) {
    agg.term(j, scale4(__fdiv_rn(expf(__fsub_rn(s[j], mx)), sum), z[j]));
  }
  out[t * kLanes + lane] = agg.total();
  if ((lane & 7) == 0) {
    const int head = lane >> 3;
    stats[t * 2 * kH + head] = mx;
    stats[t * 2 * kH + kH + head] = sum;
  }
}

// pd (n, kH, kC) and pn (n, f, kH, kC) get des_h zd[t, h] and ds_jh
// zn[t, j, h], the products autograd sums into a_src's and a_dst's
// gradients for the eager chain.
template <int F>
__global__ void __launch_bounds__(kThreads)
gat_attend_bwd_kernel(const float4* __restrict__ zd,
                      const float4* __restrict__ zn,
                      const float4* __restrict__ a_src,
                      const float4* __restrict__ a_dst,
                      const float* __restrict__ stats,
                      const float4* __restrict__ g, float4* __restrict__ dzd,
                      float4* __restrict__ dzn, float4* __restrict__ pd,
                      float4* __restrict__ pn, int n) {
  const int lane = threadIdx.x & 31;
  const int head = lane >> 3;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (t >= n) return;                                 // the whole warp
  float4 z[F];
#pragma unroll
  for (int j = 0; j < F; ++j) z[j] = zn[(t * F + j) * kLanes + lane];
  const float4 d = zd[t * kLanes + lane];
  const float4 as = a_src[lane], ad = a_dst[lane];
  const float4 gt = g[t * kLanes + lane];
  const float mx = stats[t * 2 * kH + head];
  const float sum = stats[t * 2 * kH + kH + head];
  float s[F], alpha[F], p[F];
  scores<F>(d, z, as, ad, s);
  // ATen's softmax backward: p = da * alpha, then p - alpha * sum_k p_k
  float dot = 0.0f;
#pragma unroll
  for (int j = 0; j < F; ++j) {
    alpha[j] = __fdiv_rn(expf(__fsub_rn(leaky(s[j]), mx)), sum);
    p[j] = __fmul_rn(head_dot(gt, z[j]), alpha[j]);
    dot = __fadd_rn(dot, p[j]);
  }
  SlotSum<float, F> des;
#pragma unroll
  for (int j = 0; j < F; ++j) {
    const float de = fmaf(-alpha[j], dot, p[j]);
    const float ds = s[j] > 0.0f ? de : __fmul_rn(de, kSlope);
    const int64_t row = (t * F + j) * kLanes + lane;
    dzn[row] = add4(scale4(alpha[j], gt), scale4(ds, ad));
    pn[row] = scale4(ds, z[j]);
    des.term(j, ds);
  }
  const float total = des.total();
  dzd[t * kLanes + lane] = scale4(total, as);
  pd[t * kLanes + lane] = scale4(total, d);
}

int blocks_for(int64_t warps) {
  return static_cast<int>((warps + kWarps - 1) / kWarps);
}

template <int F>
int fwd(const float* zd, const float* zn, const float* a_src,
        const float* a_dst, float* out, float* stats, int n,
        cudaStream_t stream) {
  gat_attend_fwd_kernel<F><<<blocks_for(n), kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(zd), reinterpret_cast<const float4*>(zn),
      reinterpret_cast<const float4*>(a_src),
      reinterpret_cast<const float4*>(a_dst), reinterpret_cast<float4*>(out),
      stats, n);
  return static_cast<int>(cudaGetLastError());
}

template <int F>
int bwd(const float* zd, const float* zn, const float* a_src,
        const float* a_dst, const float* stats, const float* g, float* dzd,
        float* dzn, float* pd, float* pn, int n, cudaStream_t stream) {
  gat_attend_bwd_kernel<F><<<blocks_for(n), kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(zd), reinterpret_cast<const float4*>(zn),
      reinterpret_cast<const float4*>(a_src),
      reinterpret_cast<const float4*>(a_dst), stats,
      reinterpret_cast<const float4*>(g), reinterpret_cast<float4*>(dzd),
      reinterpret_cast<float4*>(dzn), reinterpret_cast<float4*>(pd),
      reinterpret_cast<float4*>(pn), n);
  return static_cast<int>(cudaGetLastError());
}

// every fanout the kernels are instantiated for, 1 to kMaxF
#define GAT_ATTEND_FANOUTS(X)                                              \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13)     \
  X(14) X(15) X(16)
static_assert(kMaxF == 16, "GAT_ATTEND_FANOUTS lists 1 to kMaxF");

}  // namespace

extern "C" {

// stats (n, 2, kH): each destination's max and sum per head.  Returns
// cudaErrorInvalidValue for a fanout outside [1, kMaxF].
int gat_attend_fwd(const float* zd, const float* zn, const float* a_src,
                   const float* a_dst, float* out, float* stats, int n, int f,
                   cudaStream_t stream) {
  switch (f) {
#define X(F) \
    case F: return fwd<F>(zd, zn, a_src, a_dst, out, stats, n, stream);
    GAT_ATTEND_FANOUTS(X)
#undef X
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// pd (n, kH, kC) and pn (n, f, kH, kC) get the products the attention
// vectors' gradients are summed from (the caller sums them).
int gat_attend_bwd(const float* zd, const float* zn, const float* a_src,
                   const float* a_dst, const float* stats, const float* g,
                   float* dzd, float* dzn, float* pd, float* pn, int n, int f,
                   cudaStream_t stream) {
  switch (f) {
#define X(F)                                                                \
    case F: return bwd<F>(zd, zn, a_src, a_dst, stats, g, dzd, dzn, pd, pn, \
                          n, stream);
    GAT_ATTEND_FANOUTS(X)
#undef X
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
