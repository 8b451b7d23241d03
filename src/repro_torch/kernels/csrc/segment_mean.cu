// segment_mean: out[b, :] = mean_f feats[idx[b, f], :] for a (B, F) int32
// index matrix over an (N, D) feature table, f32 accumulation, cast to the
// table's dtype once at the end.
//
// Replaces the Pallas TPU kernel `segment_mean` (src/repro/kernels/
// segment_mean.py:40, `_kernel` :30, `pallas_call` :60).  On the TPU the
// fanout axis is the innermost, sequential grid axis and the output block
// stays resident in VMEM while it is revisited; here warps run in parallel,
// so the fanout loop moves inside the warp and the sum lives in registers.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  The compulsory traffic is every
// distinct feature row the index matrix names, read once, plus B*D*itemsize
// written and the B*F*4 index bytes; the F*D adds are far below the f32
// vector rate.  Rows shared between destinations are re-read from L2 here.
// A gather of whole rows at random is a latency problem first: the card
// needs a few MB of loads in flight to reach its memory rate.
//
// Layout: one warp per (destination row b, column chunk), a chunk being one
// 16-byte load per lane (512 B of the row: 128 f32 or 256 bf16 columns), so
// B = 512 destination rows of 1024 f32 columns make 4,096 warps.  Lane f
// loads index f of the row and `__shfl_sync` hands it to the warp: no shared
// memory and no barrier before the first feature load.  The warps run chunk
// by chunk (every destination's chunk 0, then every destination's chunk 1,
// ...), so while a chunk is being summed the table's working set is one
// 512-byte column stripe of it (4 MB of an (8192, 1024) f32 table), which
// L2 holds while other destinations re-read its rows.  The fanout is walked
// KB neighbours at a time, all KB loads issued before the first add: KB = 8
// on the vector path when the grid fits in one wave of the card (few warps,
// each needs loads in flight), else 2 (fewer registers, more warps
// resident).  The sum still runs over f in order and ends with one division
// by F, as the plain version's mean.  Loads are 16 bytes (float4 / 8 x bf16)
// when the row width in bytes is a multiple of 16 and both tables are
// 16-byte aligned; otherwise a scalar path (2 columns a lane per chunk)
// takes any D, so the reference's `D % block_d == 0` assert is gone.
//
// `chip_smoke.py --segment-mean-variants` times this kernel beside copies
// with another work order, batch or scalar chunk, and beside the
// block-per-destination kernel it replaced.  On the H100, taking the chunks
// column stripe by column stripe made the large launch faster; 8 loads in
// flight won at B = 512, F = 33 and lost at B = 5120, F = 5, hence the
// choice by grid size; on the scalar path 2 loads of 64-column chunks beat
// the other batches and chunks and the older kernel.  At B = 512 a fixed
// chain (launch, index load, row load, store, each from a cold L2) is most
// of the time: F = 1 already takes it.
//
// Left for later PRs: TMA or `cp.async.bulk` row copies into shared memory
// (one instruction per row instead of one per lane), and keeping a row that
// several destinations share in shared memory instead of re-reading L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;         // warps per block
constexpr int kWarpsPerSM = 64;   // the most an H100 SM keeps resident
constexpr unsigned kAll = 0xffffffffu;

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

// VEC elements of T per load (16 bytes on the vector path, one element on
// the scalar one), GROUPS loads per lane per chunk, KB neighbours' loads in
// flight; lane l owns groups chunk * 32 * GROUPS + l + 32 * j, so a warp's
// loads of one row are contiguous.
template <typename T, int VEC, int GROUPS, int KB>
__global__ void __launch_bounds__(kWarps * 32)
segment_mean_kernel(const int32_t* __restrict__ idx,
                    const T* __restrict__ feats, T* __restrict__ out, int B,
                    int F, int D, int chunks) {
  using Raw = std::conditional_t<VEC * sizeof(T) == 16, uint4, T>;
  const int lane = threadIdx.x & 31;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (w >= static_cast<int64_t>(B) * chunks) return;  // the whole warp
  const int64_t b = w % B;                               // chunk-major
  const int g0 = static_cast<int>(w / B) * 32 * GROUPS + lane;
  const int n_groups = D / VEC;

  float acc[GROUPS][VEC];
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.0f;
  }
  for (int f0 = 0; f0 < F; f0 += 32) {
    const int nf = min(32, F - f0);
    const int mine = lane < nf ? idx[b * F + f0 + lane] : 0;
    // k0 + k stays below 32: k0 is a multiple of KB (a power of two up to
    // 8) below nf
    for (int k0 = 0; k0 < nf; k0 += KB) {
      Raw v[KB][GROUPS];
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        const int64_t row = __shfl_sync(kAll, mine, k0 + k);
        const T* src = feats + row * D;
#pragma unroll
        for (int j = 0; j < GROUPS; ++j) {
          const int g = g0 + 32 * j;
          if (k0 + k < nf && g < n_groups) {
            v[k][j] = *reinterpret_cast<const Raw*>(
                src + static_cast<int64_t>(g) * VEC);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < KB; ++k) {
#pragma unroll
        for (int j = 0; j < GROUPS; ++j) {
          if (k0 + k < nf && g0 + 32 * j < n_groups) {
            const T* x = reinterpret_cast<const T*>(&v[k][j]);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[j][e] += to_float(x[e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    const int g = g0 + 32 * j;
    if (g >= n_groups) continue;
    Raw raw;
    T* y = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int e = 0; e < VEC; ++e) y[e] = from_float<T>(acc[j][e] / F);
    *reinterpret_cast<Raw*>(out + b * D + static_cast<int64_t>(g) * VEC) =
        raw;
  }
}

template <typename T, int VEC, int GROUPS>
int launch_as(const int32_t* idx, const T* feats, T* out, int B, int F,
              int D, cudaStream_t s) {
  const int per_chunk = 32 * GROUPS;
  const int chunks = (D / VEC + per_chunk - 1) / per_chunk;
  const int64_t warps = static_cast<int64_t>(B) * chunks;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  // 8 neighbours' loads in flight for 16-byte loads on a grid that fits
  // one wave of the card, else 2: each measured faster on its side
  bool deep = false;
  if (VEC > 1) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    deep = warps <= static_cast<int64_t>(sms) * kWarpsPerSM;
  }
  const unsigned grid = static_cast<unsigned>(blocks);
  if (deep) {
    segment_mean_kernel<T, VEC, GROUPS, 8>
        <<<grid, kWarps * 32, 0, s>>>(idx, feats, out, B, F, D, chunks);
  } else {
    segment_mean_kernel<T, VEC, GROUPS, 2>
        <<<grid, kWarps * 32, 0, s>>>(idx, feats, out, B, F, D, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* idx, const void* feats, void* out, int B, int F, int D,
           void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = (static_cast<int64_t>(D) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const T* x = static_cast<const T*>(feats);
  T* y = static_cast<T*>(out);
  if (vec) return launch_as<T, kVec, 1>(i, x, y, B, F, D, s);
  return launch_as<T, 1, 2>(i, x, y, B, F, D, s);
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
