// K1: per-sample 1-D LUT application (apply_rf), forward, and K1-bwd, its
// backward (below).
//
// Replaces the Pallas kernel singlehdr_tpu/ops/pallas/apply_rf_pallas.py
// (_kernel, called from _apply_rf_core).  The TPU has no per-lane gather, so
// that kernel turned each lookup into one-hot matmuls on the MXU.  On Hopper a
// gather from shared memory is native: each block stages its sample's curve
// (k floats, 4 KB for k = 1024) in shared memory and every thread looks up its
// own pixels there.  The op is bound by device-memory bytes (read x, write
// out: 8 bytes a pixel); the curve is read once per block.
//
// Bit-exactness: the plain PyTorch version rounds every operation, so the
// arithmetic here uses the _rn intrinsics, which nvcc never contracts into
// FMAs.  Index semantics follow ops/curves.apply_rf: i0 = clip(floor(y)),
// i1 = clip(floor(y) + 1) (the clamp is on floor+1, not on clip(floor)+1).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 4;

__global__ void __launch_bounds__(kThreads)
apply_rf_kernel(const float* __restrict__ x, const float* __restrict__ rf,
                float* __restrict__ out, long long n, int k) {
  extern __shared__ float lut[];
  const int s = blockIdx.y;
  const float* curve = rf + static_cast<long long>(s) * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) lut[i] = curve[i];
  __syncthreads();

  const float scale = static_cast<float>(k - 1);
  const float top = static_cast<float>(k);
  const long long base = static_cast<long long>(s) * n;
  const long long start =
      static_cast<long long>(blockIdx.x) * kThreads * kPixelsPerThread + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kPixelsPerThread; ++j) {
    const long long p = start + static_cast<long long>(j) * kThreads;
    if (p >= n) break;
    const float y = __fmul_rn(x[base + p], scale);
    const float y0 = floorf(y);
    const float frac = __fsub_rn(y, y0);
    // clamp in float first so the int conversion (and +1) cannot overflow;
    // for every finite y this gives the same i0/i1 as clipping the ints
    const int iy = static_cast<int>(fminf(fmaxf(y0, -1.0f), top));
    const int i0 = min(max(iy, 0), k - 1);
    const int i1 = min(max(iy + 1, 0), k - 1);
    const float v0 = lut[i0];
    const float v1 = lut[i1];
    out[base + p] = __fadd_rn(v0, __fmul_rn(frac, __fsub_rn(v1, v0)));
  }
}

// K1-bwd.  Replaces _core_bwd / _bwd_kernel of apply_rf_pallas.py, which
// built the curve-gradient scatter from two one-hot MXU contractions per
// index set because the TPU has no scatter.  Here each block recomputes the
// forward's y, frac, i0, i1 for its pixels and
//   gx  = ((k-1) * (v1 - v0)) * g           (when gx is not null)
//   grf[s, i0] += (1 - frac) * g;  grf[s, i1] += frac * g   (when grf is not null)
// with the curve gradient accumulated first in a shared 1024-bin array
// (shared atomics), then flushed with one global atomicAdd per non-zero bin.
// gx rounds each op in that order (_rn intrinsics), as the plain version
// apply_rf_bwd_plain does, so gx is bit-equal to it; float atomics reorder
// the sums of grf, which is held to a tolerance.  Saturated pixels (x >= 1
// lands in bin k-1, x <= 0 in bin 0) serialise on one shared address: a
// per-warp pre-aggregation is the later lever.  Bound by device memory:
// 12 bytes a pixel with gx (read x and g, write gx), 8 without.
constexpr int kBwdPixelsPerThread = 8;

__global__ void __launch_bounds__(kThreads)
apply_rf_bwd_kernel(const float* __restrict__ x, const float* __restrict__ rf,
                    const float* __restrict__ g, float* __restrict__ gx,
                    float* __restrict__ grf, long long n, int k) {
  extern __shared__ float smem[];
  float* lut = smem;      // [k] the sample's curve (read for gx)
  float* acc = smem + k;  // [k] this block's share of grf[s, :]
  const int s = blockIdx.y;
  const float* curve = rf + static_cast<long long>(s) * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    if (gx) lut[i] = curve[i];
    if (grf) acc[i] = 0.0f;
  }
  __syncthreads();

  const float scale = static_cast<float>(k - 1);
  const float top = static_cast<float>(k);
  const long long base = static_cast<long long>(s) * n;
  const long long start =
      static_cast<long long>(blockIdx.x) * kThreads * kBwdPixelsPerThread + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kBwdPixelsPerThread; ++j) {
    const long long p = start + static_cast<long long>(j) * kThreads;
    if (p >= n) break;
    const float gv = g[base + p];
    // index arithmetic identical to apply_rf_kernel
    const float y = __fmul_rn(x[base + p], scale);
    const float y0 = floorf(y);
    const float frac = __fsub_rn(y, y0);
    const int iy = static_cast<int>(fminf(fmaxf(y0, -1.0f), top));
    const int i0 = min(max(iy, 0), k - 1);
    const int i1 = min(max(iy + 1, 0), k - 1);
    if (gx) {
      gx[base + p] = __fmul_rn(__fmul_rn(scale, __fsub_rn(lut[i1], lut[i0])), gv);
    }
    if (grf) {
      const float w0 = __fmul_rn(__fsub_rn(1.0f, frac), gv);
      const float w1 = __fmul_rn(frac, gv);
      if (w0 != 0.0f) atomicAdd(&acc[i0], w0);
      if (w1 != 0.0f) atomicAdd(&acc[i1], w1);
    }
  }
  if (grf) {  // uniform over the block
    __syncthreads();
    float* out = grf + static_cast<long long>(s) * k;
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      const float a = acc[i];
      if (a != 0.0f) atomicAdd(&out[i], a);
    }
  }
}

}  // namespace

// x, out: [b, n] contiguous f32; rf: [b, k] contiguous f32.
SHDR_API int shdr_apply_rf_f32(const float* x, const float* rf, float* out,
                               int b, long long n, int k, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  const long long per_block = static_cast<long long>(kThreads) * kPixelsPerThread;
  dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block), b);
  const size_t smem = static_cast<size_t>(k) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(apply_rf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  apply_rf_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, rf, out, n, k);
  return static_cast<int>(cudaGetLastError());
}

// x, g, gx: [b, n] contiguous f32; rf, grf: [b, k] contiguous f32.  gx or
// grf may be null (that gradient is not wanted); grf must arrive zeroed.
SHDR_API int shdr_apply_rf_bwd_f32(const float* x, const float* rf, const float* g,
                                   float* gx, float* grf, int b, long long n, int k,
                                   void* stream) {
  if (b <= 0 || n <= 0 || (gx == nullptr && grf == nullptr)) return 0;
  const long long per_block = static_cast<long long>(kThreads) * kBwdPixelsPerThread;
  dim3 grid(static_cast<unsigned>((n + per_block - 1) / per_block), b);
  const size_t smem = 2 * static_cast<size_t>(k) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(apply_rf_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  apply_rf_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, rf, g, gx, grf, n, k);
  return static_cast<int>(cudaGetLastError());
}

SHDR_API const char* shdr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
