// segment_mean: out[b, :] = mean_f feats[idx[b, f], :] for a (B, F) int32
// index matrix over an (N, D) feature table, f32 accumulation, cast to the
// table's dtype once at the end.
//
// Replaces the Pallas TPU kernel `segment_mean` (src/repro/kernels/
// segment_mean.py:40, `_kernel` :30, `pallas_call` :60).  On the TPU the
// fanout axis is the innermost, sequential grid axis and the output block
// stays resident in VMEM while it is revisited; here blocks run in parallel,
// so the fanout loop moves inside the block and the sum lives in registers.
//
// Layout: one block per destination row b (grid.x = B), grid.y tiles D.  The
// block stages the row's F indices in shared memory once, then each thread
// owns VEC consecutive columns and walks f = 0..F-1 accumulating in f32.
// Loads are 16 bytes (float4 / 8 x bf16) when the row width in bytes is a
// multiple of 16 and both tables are 16-byte aligned; otherwise a scalar
// path takes any D, so the reference's `D % block_d == 0` assert is gone.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  The compulsory traffic is every
// distinct feature row the index matrix names, read once, plus B*D*itemsize
// written and the B*F*4 index bytes; the F*D adds are far below the f32
// vector rate.  Rows shared between destinations are re-read from L2 here.
//
// Left for later PRs: cp.async / TMA staging of the gathered rows so loads
// of f+1 overlap the adds of f, several destination rows per block to cut
// the per-block index staging, and a persistent grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// VEC elements of T per thread and per load; VEC * sizeof(T) is 16 on the
// vector path and sizeof(T) on the scalar one.
template <typename T, int VEC>
__global__ void segment_mean_kernel(const int32_t* __restrict__ idx,
                                    const T* __restrict__ feats,
                                    T* __restrict__ out, int F, int D) {
  extern __shared__ int32_t s_idx[];
  const int64_t b = blockIdx.x;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    s_idx[f] = idx[b * F + f];
  }
  __syncthreads();

  const int n_groups = D / VEC;
  for (int g = blockIdx.y * blockDim.x + threadIdx.x; g < n_groups;
       g += gridDim.y * blockDim.x) {
    const int64_t col = static_cast<int64_t>(g) * VEC;
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
    for (int f = 0; f < F; ++f) {
      const T* src = feats + static_cast<int64_t>(s_idx[f]) * D + col;
      if constexpr (VEC * sizeof(T) == 16) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src);
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += to_float(v[k]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += to_float(src[k]);
      }
    }
    T* dst = out + b * D + col;
    if constexpr (VEC * sizeof(T) == 16) {
      uint4 raw;
      T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = from_float<T>(acc[k] / F);
      *reinterpret_cast<uint4*>(dst) = raw;
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) dst[k] = from_float<T>(acc[k] / F);
    }
  }
}

template <typename T>
int launch(const void* idx, const void* feats, void* out, int B, int F, int D,
           void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = (static_cast<int64_t>(D) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int groups = vec ? D / kVec : D;
  int tiles = (groups + kThreads - 1) / kThreads;
  if (tiles < 1) tiles = 1;
  const dim3 grid(B, tiles);
  const size_t smem = static_cast<size_t>(F) * sizeof(int32_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const T* x = static_cast<const T*>(feats);
  T* y = static_cast<T*>(out);
  if (vec) {
    segment_mean_kernel<T, kVec><<<grid, kThreads, smem, s>>>(i, x, y, F, D);
  } else {
    segment_mean_kernel<T, 1><<<grid, kThreads, smem, s>>>(i, x, y, F, D);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int segment_mean_f32(const void* idx, const void* feats, void* out,
                                int B, int F, int D, void* stream) {
  return launch<float>(idx, feats, out, B, F, D, stream);
}

extern "C" int segment_mean_bf16(const void* idx, const void* feats, void* out,
                                 int B, int F, int D, void* stream) {
  return launch<__nv_bfloat16>(idx, feats, out, B, F, D, stream);
}
