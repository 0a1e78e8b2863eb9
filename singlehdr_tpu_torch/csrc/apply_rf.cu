// K1: per-sample 1-D LUT application (apply_rf), forward, and K1-bwd, its
// backward (below).
//
// Replaces the Pallas kernel singlehdr_tpu/ops/pallas/apply_rf_pallas.py
// (_kernel, called from _apply_rf_core).  The TPU has no per-lane gather, so
// that kernel turned each lookup into one-hot matmuls on the MXU.  On Hopper a
// gather from shared memory is native: a block stages its sample's curve
// (k floats, 4 KB for k = 1024) in shared memory and its threads look up their
// pixels there.
//
// What bounds it: device-memory bytes (read x, write out: 8 bytes a pixel).
// So the forward streams: the grid is sized to the card, not to the pixels
// (a few blocks per SM over all samples, ops/cuda/apply_rf_cuda.py
// blocks_per_sample), and each block stages its curve once and then walks one
// long contiguous run of its sample's pixels in 16-byte float4 loads and
// stores.  A thread keeps kVec float4 loads in flight: the first round is
// issued before the curve's barrier, and each later round before the lookups
// of the one before it.  A sample's run need not start 16-byte aligned
// (n = 3 h w may be odd): the scalar head before the first aligned pixel and
// the tail after the last whole float4 are done by the sample's first and last
// block.  If x and out differ in alignment modulo 16 bytes, the block walks
// its run in scalars.
//
// Bit-exactness: the plain PyTorch version rounds every operation, so the
// arithmetic here uses the _rn intrinsics, which nvcc never contracts into
// FMAs.  Index semantics follow ops/curves.apply_rf: i0 = clip(floor(y)),
// i1 = clip(floor(y) + 1) (the clamp is on floor+1, not on clip(floor)+1).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // float4 loads a thread has in flight

__device__ __forceinline__ float lerp_lut(const float* lut, float xv, float scale, float top,
                                          int k) {
  const float y = __fmul_rn(xv, scale);
  const float y0 = floorf(y);
  const float frac = __fsub_rn(y, y0);
  // clamp in float first so the int conversion (and +1) cannot overflow;
  // for every finite y this gives the same i0/i1 as clipping the ints
  const int iy = static_cast<int>(fminf(fmaxf(y0, -1.0f), top));
  const int i0 = min(max(iy, 0), k - 1);
  const int i1 = min(max(iy + 1, 0), k - 1);
  const float v0 = lut[i0];
  const float v1 = lut[i1];
  return __fadd_rn(v0, __fmul_rn(frac, __fsub_rn(v1, v0)));
}

// grid (bps, b): block bi of sample s owns float4 units [bi * per, (bi + 1) *
// per) of the sample's aligned body, per = ceil(units / bps)
__global__ void __launch_bounds__(kThreads)
apply_rf_kernel(const float* __restrict__ x, const float* __restrict__ rf,
                float* __restrict__ out, long long n, int k) {
  extern __shared__ float lut[];
  const int s = blockIdx.y, bi = blockIdx.x, bps = gridDim.x, tid = threadIdx.x;
  const float* curve = rf + static_cast<long long>(s) * k;
  for (int i = tid; i < k; i += kThreads) lut[i] = curve[i];

  const float scale = static_cast<float>(k - 1);
  const float top = static_cast<float>(k);
  const float* xs = x + static_cast<long long>(s) * n;
  float* os = out + static_cast<long long>(s) * n;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(xs);
  if (((xa ^ reinterpret_cast<uintptr_t>(os)) & 15) != 0) {  // uniform over the grid
    const long long per = (n + bps - 1) / bps;
    const long long p1 = min(n, (bi + 1) * per);
    __syncthreads();
    for (long long p = bi * per + tid; p < p1; p += kThreads) {
      os[p] = lerp_lut(lut, xs[p], scale, top, k);
    }
    return;
  }
  const long long head = min(n, static_cast<long long>(((16 - (xa & 15)) & 15) >> 2));
  const long long units = (n - head) >> 2;
  const long long per = (units + bps - 1) / bps;
  const long long u0 = bi * per, u1 = min(units, u0 + per);
  const float4* xv = reinterpret_cast<const float4*>(xs + head);
  float4* ov = reinterpret_cast<float4*>(os + head);

  float4 v[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const long long q = u0 + tid + j * kThreads;
    if (q < u1) v[j] = xv[q];
  }
  __syncthreads();  // the curve is staged
  if (bi == 0 && tid < head) os[tid] = lerp_lut(lut, xs[tid], scale, top, k);
  const long long tail0 = head + 4 * units;
  if (bi == bps - 1 && tail0 + tid < n) {
    os[tail0 + tid] = lerp_lut(lut, xs[tail0 + tid], scale, top, k);
  }
  for (long long q0 = u0 + tid; q0 < u1; q0 += kVec * kThreads) {
    float4 next[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const long long q = q0 + (kVec + j) * kThreads;
      if (q < u1) next[j] = xv[q];
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const long long q = q0 + j * kThreads;
      if (q < u1) {
        float4 r;
        r.x = lerp_lut(lut, v[j].x, scale, top, k);
        r.y = lerp_lut(lut, v[j].y, scale, top, k);
        r.z = lerp_lut(lut, v[j].z, scale, top, k);
        r.w = lerp_lut(lut, v[j].w, scale, top, k);
        ov[q] = r;
      }
      v[j] = next[j];
    }
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

// x, out: [b, n] contiguous f32; rf: [b, k] contiguous f32; bps: blocks a
// sample (ops/cuda/apply_rf_cuda.py blocks_per_sample).
SHDR_API int shdr_apply_rf_f32(const float* x, const float* rf, float* out,
                               int b, long long n, int k, int bps, void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (bps <= 0 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(bps), b);
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
