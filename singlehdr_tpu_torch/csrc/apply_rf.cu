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
// index set because the TPU has no scatter, and summed them in grid order.
// Each pixel recomputes the forward's y, frac, i0, i1 and gives
//   gx  = ((k-1) * (v1 - v0)) * g           (when gx is wanted)
//   grf[s, i0] += (1 - frac) * g;  grf[s, i1] += frac * g   (when grf is wanted)
// gx rounds each op in that order (_rn intrinsics), as apply_rf_bwd_plain
// does, so gx is bit-equal to it.
//
// What bounds it: device-memory bytes, 12 a pixel with gx (read x and g,
// write gx), 8 without.  So it streams as the forward does: the same grid
// (blocks_per_sample) and the same block -> pixel map, float4 loads of x and
// g with the first round issued before the shared arrays are ready, scalar
// head and tail, and a scalar walk when x, g and gx differ in alignment.
//
// The curve gradient without atomics on the bins, and the same bits on every
// run.  Each warp owns a k-bin histogram in shared memory and takes one pixel
// a lane at a time (a step).  A pixel with i0 == i1 (x out of range, or on
// the top knot) lands in bin 0 or bin k - 1 with both weights: its lane sums
// those in two registers, so saturated runs and clipped pixels never touch
// the histogram.  For the others, the lanes of one bin i0 form a group (found
// through per-bin tags, warp_bin_add), and the group's lowest lane adds the
// group's (1 - frac) g to bin i0, then, after a __syncwarp, its frac g to bin
// i0 + 1 (= i1).  Distinct groups have distinct bins, so each bin takes at
// most one add a step and the adds are plain read-add-writes.  A lone lane
// adds its own weights, the lowest lane of a group sums the group in lane
// order, and a run of 32 lanes in one bin is summed by a __shfl_xor_sync
// tree.  At the end each warp adds its lanes' two register sums (a tree) to
// bins 0 and k - 1, the block sums its warps' histograms in warp order into
// its row of a [b, bps, k] scratch (plain coalesced stores), and
// apply_rf_bwd_sum_kernel sums each bin's bps rows in a fixed order into
// grf, which is written once.  Every sum's order is fixed by the data alone,
// so grf is bit-identical from run to run.
constexpr int kBwdWarps = kThreads / 32;
constexpr int kBwdVec = 1;          // float4 loads each of x and g a thread has in flight
constexpr int kBwdMaxBins = 4096;   // shared memory: 9 k floats + 8 k tag bytes + 3 KB
constexpr int kSumBins = 32;   // apply_rf_bwd_sum_kernel: bins a block
constexpr int kSumParts = 8;   // and threads a bin
constexpr unsigned kFull = 0xffffffffu;

// The 5-step __shfl_xor_sync tree: every lane ends with the sum of v over
// the warp, added in the same order on every run.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// A warp's share of the block's shared memory for the curve gradient.
struct BwdWarp {
  float* hist;          // [k] its histogram
  float2* scratch;      // [32] the lanes' weights, for a group's lowest lane to sum
  unsigned* groups;     // [32] group lane masks by representative lane, 0 between steps
  unsigned char* tags;  // [k] a lane of each bin taken in the current step
};

// Adds a to bin key and b to bin key + 1 of the warp's histogram, for every
// lane with key >= 0 (key <= k - 2), without atomics on the histogram (see
// above).  Every lane of the warp calls it together.  The lanes of one bin
// find each other through the bin's tag: each writes its lane number there
// and reads back whichever write landed, the same for all of them and for no
// other bin, so a lane that reads another's number has company.  Only then
// (one vote a step otherwise) the lanes OR their bits into the group mask of
// that representative, and the lowest lane of each group sums it.  Which
// write lands changes neither the groups nor the sums.  (__match_any_sync,
// or one ballot a bit of the key, cost more than the rest of the histogram
// work.)
__device__ __forceinline__ void warp_bin_add(int key, float a, float b, const BwdWarp& w,
                                             int lane) {
  const bool on = key >= 0;
  const unsigned me = 1u << lane;
  if (on) w.tags[key] = static_cast<unsigned char>(lane);
  __syncwarp();
  const int rep = on ? w.tags[key] : lane;
  bool lead = on;
  if (__any_sync(kFull, rep != lane)) {  // some bin has several lanes
    const int rep0 = __shfl_sync(kFull, rep, 0);  // every lane takes part in the shuffle
    if (__all_sync(kFull, on && rep == rep0)) {    // a run of one bin
      a = warp_sum(a);
      b = warp_sum(b);
      lead = lane == 0;
    } else {  // the lowest lane of each bin sums its group in lane order
      if (on) atomicOr(&w.groups[rep], me);
      w.scratch[lane] = make_float2(a, b);
      __syncwarp();
      const unsigned group = on ? w.groups[rep] : me;
      lead = on && (group & (me - 1)) == 0;
      if (lead) {
        for (unsigned rest = group & ~me; rest != 0; rest &= rest - 1) {
          const float2 v = w.scratch[__ffs(rest) - 1];
          a = __fadd_rn(a, v.x);
          b = __fadd_rn(b, v.y);
        }
      }
      __syncwarp();
      if (lead) w.groups[rep] = 0;
    }
  }
  if (lead) w.hist[key] = __fadd_rn(w.hist[key], a);
  __syncwarp();
  if (lead) w.hist[key + 1] = __fadd_rn(w.hist[key + 1], b);
  __syncwarp();
}

// A thread's curve-gradient state: its warp's shared arrays, and its own
// sums of the pixels with i0 == i1, which all land in bin 0 or bin k - 1.
struct BwdAcc {
  BwdWarp warp;
  float lo = 0.0f, hi = 0.0f;
};

// One pixel a lane; every lane of the warp calls it together, valid or not.
// Returns the lane's gx (when kGx) and adds the valid lanes' curve-gradient
// weights into the warp's histogram (when kRf).  Index arithmetic identical
// to lerp_lut.
template <bool kGx, bool kRf>
__device__ __forceinline__ float bwd_pixel(bool valid, float xv, float gv, const float* lut,
                                           BwdAcc& acc, float scale, float top, int k,
                                           int lane) {
  const float y = __fmul_rn(xv, scale);
  const float y0 = floorf(y);
  const float frac = __fsub_rn(y, y0);
  const int iy = static_cast<int>(fminf(fmaxf(y0, -1.0f), top));
  const int i0 = min(max(iy, 0), k - 1);
  const int i1 = min(max(iy + 1, 0), k - 1);
  float out = 0.0f;
  if constexpr (kGx) out = __fmul_rn(__fmul_rn(scale, __fsub_rn(lut[i1], lut[i0])), gv);
  if constexpr (kRf) {
    const float w0 = __fmul_rn(__fsub_rn(1.0f, frac), gv);
    const float w1 = __fmul_rn(frac, gv);
    const bool merged = i0 == i1;  // x out of range or on the top knot
    if (valid && merged) {
      if (i0 == 0) {
        acc.lo = __fadd_rn(acc.lo, __fadd_rn(w0, w1));
      } else {
        acc.hi = __fadd_rn(acc.hi, __fadd_rn(w0, w1));
      }
    }
    warp_bin_add(valid && !merged ? i0 : -1, w0, w1, acc.warp, lane);
  }
  return out;
}

// grid (bps, b), the forward's block -> pixel map.  partial: [b, bps, k], this
// block's row of the curve gradient (when kRf).
template <bool kGx, bool kRf>
__global__ void __launch_bounds__(kThreads)
apply_rf_bwd_kernel(const float* __restrict__ x, const float* __restrict__ rf,
                    const float* __restrict__ g, float* __restrict__ gx,
                    float* __restrict__ partial, long long n, int k) {
  extern __shared__ float4 smem4[];
  // when kRf: [kBwdWarps][k] histograms, [kThreads] float2 scratch, [kThreads]
  // group masks, [kBwdWarps][k] byte tags; when kGx: the sample's curve [k]
  float* hists = reinterpret_cast<float*>(smem4);
  float2* scratch = reinterpret_cast<float2*>(hists + (kRf ? kBwdWarps * k : 0));
  unsigned* groups = reinterpret_cast<unsigned*>(scratch + (kRf ? kThreads : 0));
  unsigned char* tags = reinterpret_cast<unsigned char*>(groups + (kRf ? kThreads : 0));
  float* lut = reinterpret_cast<float*>(tags + (kRf ? kBwdWarps * k : 0));  // 4-aligned
  const int s = blockIdx.y, bi = blockIdx.x, bps = gridDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  BwdAcc acc{{hists + warp * k, scratch + warp * 32, groups + warp * 32, tags + warp * k}};
  if constexpr (kGx) {
    const float* curve = rf + static_cast<long long>(s) * k;
    for (int i = tid; i < k; i += kThreads) lut[i] = curve[i];
  }
  if constexpr (kRf) {  // kBwdWarps * k is a multiple of 4
    float4* h4 = reinterpret_cast<float4*>(hists);
    for (int i = tid; i < kBwdWarps * k / 4; i += kThreads) h4[i] = make_float4(0, 0, 0, 0);
    groups[tid] = 0;
  }

  const float scale = static_cast<float>(k - 1);
  const float top = static_cast<float>(k);
  const float* xs = x + static_cast<long long>(s) * n;
  const float* gs = g + static_cast<long long>(s) * n;
  float* gxs = kGx ? gx + static_cast<long long>(s) * n : nullptr;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(xs);
  const uintptr_t skew = (xa ^ reinterpret_cast<uintptr_t>(gs)) |
                         (kGx ? xa ^ reinterpret_cast<uintptr_t>(gxs) : 0);
  if ((skew & 15) != 0) {  // uniform over the grid: a scalar walk of the block's run
    const long long per = (n + bps - 1) / bps;
    const long long p1 = min(n, (bi + 1) * per);
    __syncthreads();
    for (long long p0 = bi * per; p0 < p1; p0 += kThreads) {
      const long long p = p0 + tid;
      const bool valid = p < p1;
      const float r = bwd_pixel<kGx, kRf>(valid, valid ? xs[p] : 0.0f, valid ? gs[p] : 0.0f,
                                          lut, acc, scale, top, k, lane);
      if (kGx && valid) gxs[p] = r;
    }
  } else {
    const long long head = min(n, static_cast<long long>(((16 - (xa & 15)) & 15) >> 2));
    const long long units = (n - head) >> 2;
    const long long per = (units + bps - 1) / bps;
    const long long u0 = bi * per, u1 = min(units, u0 + per);
    const float4* xv = reinterpret_cast<const float4*>(xs + head);
    const float4* gv = reinterpret_cast<const float4*>(gs + head);
    float4* gxv = kGx ? reinterpret_cast<float4*>(gxs + head) : nullptr;
    const float4 zero = make_float4(0, 0, 0, 0);

    float4 vx[kBwdVec], vg[kBwdVec];
#pragma unroll
    for (int j = 0; j < kBwdVec; ++j) {
      const long long q = u0 + j * kThreads + tid;
      vx[j] = q < u1 ? xv[q] : zero;
      vg[j] = q < u1 ? gv[q] : zero;
    }
    __syncthreads();  // the curve is staged, the histograms are zeroed
    if (bi == 0) {
      const bool valid = tid < head;
      const float r = bwd_pixel<kGx, kRf>(valid, valid ? xs[tid] : 0.0f,
                                          valid ? gs[tid] : 0.0f, lut, acc, scale, top, k, lane);
      if (kGx && valid) gxs[tid] = r;
    }
    const long long tail = head + 4 * units + tid;
    if (bi == bps - 1) {
      const bool valid = tail < n;
      const float r = bwd_pixel<kGx, kRf>(valid, valid ? xs[tail] : 0.0f,
                                          valid ? gs[tail] : 0.0f, lut, acc, scale, top, k, lane);
      if (kGx && valid) gxs[tail] = r;
    }
    for (long long r0 = u0; r0 < u1; r0 += kBwdVec * kThreads) {  // uniform over the block
      float4 nx[kBwdVec], ng[kBwdVec];
#pragma unroll
      for (int j = 0; j < kBwdVec; ++j) {
        const long long q = r0 + (kBwdVec + j) * kThreads + tid;
        nx[j] = q < u1 ? xv[q] : zero;
        ng[j] = q < u1 ? gv[q] : zero;
      }
#pragma unroll
      for (int j = 0; j < kBwdVec; ++j) {
        const long long q = r0 + j * kThreads + tid;
        const bool valid = q < u1;
        float4 r;
        r.x = bwd_pixel<kGx, kRf>(valid, vx[j].x, vg[j].x, lut, acc, scale, top, k, lane);
        r.y = bwd_pixel<kGx, kRf>(valid, vx[j].y, vg[j].y, lut, acc, scale, top, k, lane);
        r.z = bwd_pixel<kGx, kRf>(valid, vx[j].z, vg[j].z, lut, acc, scale, top, k, lane);
        r.w = bwd_pixel<kGx, kRf>(valid, vx[j].w, vg[j].w, lut, acc, scale, top, k, lane);
        if (kGx && valid) gxv[q] = r;
        vx[j] = nx[j];
        vg[j] = ng[j];
      }
    }
  }
  if constexpr (kRf) {  // the edge sums into the histograms, then the warps' in warp order
    const float lo = warp_sum(acc.lo), hi = warp_sum(acc.hi);
    if (lane == 0) {
      acc.warp.hist[0] = __fadd_rn(acc.warp.hist[0], lo);
      acc.warp.hist[k - 1] = __fadd_rn(acc.warp.hist[k - 1], hi);
    }
    __syncthreads();
    float* row = partial + (static_cast<long long>(s) * bps + bi) * k;
    for (int i = tid; i < k; i += kThreads) {
      float a = hists[i];
#pragma unroll
      for (int w = 1; w < kBwdWarps; ++w) a = __fadd_rn(a, hists[w * k + i]);
      row[i] = a;
    }
  }
}

// grid (ceil(k / kSumBins), b): grf[s, i] = the sum of partial[s, :, i].
// A block takes kSumBins bins; its kSumParts threads of a bin sum rows p,
// p + kSumParts, ... in order, then part 0 adds the parts in order.
__global__ void __launch_bounds__(kSumBins * kSumParts)
apply_rf_bwd_sum_kernel(const float* __restrict__ partial, float* __restrict__ grf, int bps,
                        int k) {
  __shared__ float parts[kSumParts][kSumBins];
  const int s = blockIdx.y, c = threadIdx.x % kSumBins, p = threadIdx.x / kSumBins;
  const int i = blockIdx.x * kSumBins + c;
  float a = 0.0f;
  if (i < k) {
    const float* rows = partial + static_cast<long long>(s) * bps * k + i;
#pragma unroll 4
    for (int j = p; j < bps; j += kSumParts) a = __fadd_rn(a, rows[static_cast<long long>(j) * k]);
  }
  parts[p][c] = a;
  __syncthreads();
  if (p == 0 && i < k) {
#pragma unroll
    for (int q = 1; q < kSumParts; ++q) a = __fadd_rn(a, parts[q][c]);
    grf[static_cast<long long>(s) * k + i] = a;
  }
}

template <bool kGx, bool kRf>
int launch_bwd(const float* x, const float* rf, const float* g, float* gx, float* partial,
               dim3 grid, long long n, int k, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>((kRf ? kBwdWarps : 0) + (kGx ? 1 : 0)) * k +
                       (kRf ? 3 * kThreads + kBwdWarps * k / 4 : 0)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(apply_rf_bwd_kernel<kGx, kRf>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  }
  apply_rf_bwd_kernel<kGx, kRf><<<grid, kThreads, smem, stream>>>(x, rf, g, gx, partial, n, k);
  return static_cast<int>(cudaGetLastError());
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

// x, g, gx: [b, n] contiguous f32; rf, grf: [b, k] contiguous f32; partial:
// [b, bps, k] f32 scratch; bps: blocks a sample (blocks_per_sample).  gx or
// grf may be null (that gradient is not wanted); partial is needed with grf.
// grf is written, not accumulated into (n > 0).
SHDR_API int shdr_apply_rf_bwd_f32(const float* x, const float* rf, const float* g,
                                   float* gx, float* grf, float* partial, int b, long long n,
                                   int k, int bps, void* stream) {
  if (b <= 0 || n <= 0 || (gx == nullptr && grf == nullptr)) return 0;
  if (bps <= 0 || b > 65535 || k < 2 || k > kBwdMaxBins ||
      (grf != nullptr && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(bps), b);
  const int err = gx == nullptr ? launch_bwd<false, true>(x, rf, g, gx, partial, grid, n, k, st)
                  : grf == nullptr ? launch_bwd<true, false>(x, rf, g, gx, partial, grid, n, k, st)
                                   : launch_bwd<true, true>(x, rf, g, gx, partial, grid, n, k, st);
  if (err != 0 || grf == nullptr) return err;
  const dim3 sum_grid(static_cast<unsigned>((k + kSumBins - 1) / kSumBins), b);
  apply_rf_bwd_sum_kernel<<<sum_grid, kSumBins * kSumParts, 0, st>>>(partial, grf, bps, k);
  return static_cast<int>(cudaGetLastError());
}

SHDR_API const char* shdr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
