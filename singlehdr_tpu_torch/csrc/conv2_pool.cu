// K2 and K4: a SAME conv + bias + activation as an implicit GEMM on the tensor
// cores in 3xTF32, with an optional 2x2 pool in the epilogue.  One fused
// encoder stage is two launches of this kernel:
//
//   mid    = ACT(conv_K(x, w1) + b1)                       (epilogue: store)
//   act    = ACT(conv_K(mid, w2) + b2);  pooled = POOL(act) (epilogue: store + pool)
//
// K2 (leaky ReLU 0.1, 2x2 average pool, VALID: H/2; K in {3, 5, 7}) replaces
// unet_stage2 in singlehdr_tpu/ops/pallas/unet_stage_pallas.py (deq/ref U-Net
// encoder prefix); K4 (ReLU, 2x2 max pool, SAME: ceil(H/2), over the in-image
// members only; K = 3) replaces encoder_stage2 in
// singlehdr_tpu/ops/pallas/enc_pool_pallas.py (hal enc1/enc2).
//
// What bounds it on this card: the convs' multiply-adds.  The port is f32, so
// a product must be f32-accurate: on the CUDA cores that caps the stage at
// 67 TFLOP/s; on the tensor cores three TF32 products per f32 product
// (a_hi*b_hi + a_hi*b_lo + a_lo*b_hi, x_hi = rna_tf32(x), x_lo =
// rna_tf32(x - x_hi), accumulated in f32) cap it at 495 / 3 = 165 TFLOP/s.
// This kernel takes the second road.  The TPU kernels kept conv1's activation
// in VMEM; here it is a stored tensor (b4 at 576^2 it costs ~0.1-0.2 ms of
// HBM traffic, much of it in L2), which removes the halo recompute and the
// shared-memory ceiling that a fused tile hit at 128 channels.  conv2's SAME
// padding then sees zeros outside the image by itself.
//
// The GEMM, per launch:  M = the output pixels of a 16 x 16 tile of one image,
// N = BN output channels (blockIdx.y picks the slice), K = C*k*k in
// (c, kh, kw) order, walked in chunks of `cc` input channels (8, or all C when
// C is not a multiple of 8; a chunk's K is zero-padded to a multiple of 8).
// A 3-stage cp.async ring holds, per chunk, the input tile with its halo
// (4-byte copies; the zero-fill form, source size 0, is the SAME padding) and
// the chunk's weights, already split into hi/lo planes by the wrapper and laid
// out as wgmma's K-major core matrices.  A fragments are gathered from the
// staged tile through a per-k offset table (im2col in shared memory) and split
// as they are loaded.  A warp owns 2 tile rows x all BN channels.  For BN >= 32
// the two warpgroups issue wgmma.mma_async m64nBNk8 (tf32), B read from shared
// memory through a descriptor, A from registers, the next k-steps' A loads
// overlapping the MMAs in flight.  (An mma.sync m16n8k8 version was bound by
// its instruction stream, the B fragments' shared-memory loads beside the A
// gather and split: without its MMAs it ran barely faster.)  For BN = 16
// (the U-Nets' 7x7 stems) mma.sync m16n8k8 stays: there a wgmma moves a
// 64 x 8 A operand for a 16-wide product, and measured slower.
// The epilogue adds the bias, applies the activation, stores NCHW, and pools
// from registers: the two rows of a pool window sit in one thread (m64 tiles
// mt and mt + 1), the two columns in lanes g and g ^ 1 (one shuffle).
//
// The index maps (tile, halo, offset table, fragment and descriptor layouts,
// pool) are simulated in numpy by tests/test_torch_conv_gemm.py.
#include <cstdint>

#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

enum Mode { kLeakyStore = 0, kLeakyAvgPool = 1, kReluStore = 2, kReluMaxPool = 3 };

constexpr int TH = 16;  // output tile rows    (ops/cuda/conv_gemm.py TILE)
constexpr int TW = 16;  // output tile columns (one m16 MMA tile per row)
constexpr int kWarps = 8;  // a warp: 2 tile rows x all BN channels of the block
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;

template <Mode M>
__device__ __forceinline__ float activate(float v) {
  if constexpr (M == kLeakyStore || M == kLeakyAvgPool) {
    return v > 0.0f ? v : v * 0.1f;
  } else {
    return fmaxf(v, 0.0f);
  }
}

// The staged input tile's channel stride: IH * IW plus KS + 7 floats, which
// spreads the 4 k-columns of an A fragment load over distinct banks (checked
// for every layer by tests/test_torch_conv_gemm.py).
template <int KS>
__host__ __device__ constexpr int channel_stride() {
  return (TH + KS - 1) * (TW + KS - 1) + KS + 7;
}

// Shared-memory plan of one launch (floats): kStages (or fewer, when the
// layer has fewer chunks) stages of [weights hi/lo | input tile | zero rows],
// then the k -> offset table.
struct Plan {
  int w_floats;      // kc_pad * BN * 2
  int in_floats;     // cc * channel_stride
  int zero_floats;   // TH * IW when the chunk's K is padded, else 0
  int stage_floats;  // w_floats + in_floats + zero_floats, rounded up to 4
  int stages;
  size_t smem_bytes;
};

template <int KS, int BN>
__host__ __device__ inline Plan make_plan(int C, int cc, int kc_pad) {
  constexpr int IW = TW + KS - 1;
  Plan p;
  p.w_floats = kc_pad * BN * 2;
  p.in_floats = cc * channel_stride<KS>();
  p.zero_floats = cc * KS * KS < kc_pad ? TH * IW : 0;
  p.stage_floats = p.w_floats + ((p.in_floats + p.zero_floats + 3) & ~3);
  const int chunks = C / cc;
  p.stages = chunks < kStages ? chunks : kStages;
  p.smem_bytes = sizeof(float) * (static_cast<size_t>(p.stages) * p.stage_floats + kc_pad);
  return p;
}

// x: [B, C, H, W]; wpk: [F/BN][C/cc][kc_pad/8][hi, lo][BN/8][2][8][4], the core
// matrices of ops/cuda/conv_gemm.py pack_weights; bias: [F]; out: [B, F, H, W];
// pooled: [B, F, PH, PW] (pooling modes only)
template <int KS, int BN, Mode M>
__global__ void __launch_bounds__(kThreads, 1)
conv_gemm_kernel(const float* __restrict__ x, const float4* __restrict__ wpk,
                 const float* __restrict__ bias, float* __restrict__ out,
                 float* __restrict__ pooled, int C, int F, int H, int W, int PH, int PW, int cc,
                 int kc_pad, int tiles_x) {
  constexpr int R = KS / 2;
  constexpr int IH = TH + KS - 1, IW = TW + KS - 1, CS = channel_stride<KS>();
  constexpr int MT = TH / kWarps;  // tile rows (m16 tiles) of a warp
  constexpr int NT = BN / 8;       // n8 tiles of a warp
  // register sets of A fragments for the wgmma path: more k-steps in flight
  // where each wgmma is shorter
  constexpr int kSets = BN == 32 ? 3 : 2;
  constexpr bool kPool = M == kLeakyAvgPool || M == kReluMaxPool;
  static_assert(MT % 2 == 0, "a pool window's two rows must sit in one warp");

  extern __shared__ __align__(16) float smem[];
  const Plan plan = make_plan<KS, BN>(C, cc, kc_pad);
  const int chunks = C / cc;
  const int ksteps = kc_pad / 8;
  const int kvalid = cc * KS * KS;
  int* koff = reinterpret_cast<int*>(smem + plan.stages * plan.stage_floats);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, nblk = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TH, tx0 = (blockIdx.x % tiles_x) * TW;

  // im2col in shared memory: chunk-local k = (c, kh, kw) -> offset of tap
  // (0, 0)'s input in the staged tile; the padded k read the zero rows
  for (int k = tid; k < kc_pad; k += kThreads) {
    int off = plan.in_floats;
    if (k < kvalid) {
      const int c = k / (KS * KS), r = k % (KS * KS);
      off = c * CS + (r / KS) * IW + r % KS;
    }
    koff[k] = off;
  }
  for (int s = 0; s < plan.stages; ++s) {
    float* z = smem + s * plan.stage_floats + plan.w_floats + plan.in_floats;
    for (int i = tid; i < plan.zero_floats; i += kThreads) z[i] = 0.0f;
  }

  const float* xb = x + static_cast<long long>(b) * C * H * W;
  const float4* wb = wpk + static_cast<long long>(nblk) * chunks * (plan.w_floats / 4);

  auto load_chunk = [&](int j) {
    float* st = smem + (j % kStages) * plan.stage_floats;
    const float4* wsrc = wb + static_cast<long long>(j) * (plan.w_floats / 4);
    float4* wdst = reinterpret_cast<float4*>(st);
    for (int i = tid; i < plan.w_floats / 4; i += kThreads) cp_async16(wdst + i, wsrc + i);
    float* in = st + plan.w_floats;
    const float* xc = xb + static_cast<long long>(j) * cc * H * W;
    for (int i = tid; i < cc * IH * IW; i += kThreads) {
      const int c = i / (IH * IW), r = i % (IH * IW);
      const int gy = ty0 - R + r / IW, gx = tx0 - R + r % IW;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async4(in + c * CS + r, ok ? xc + (static_cast<long long>(c) * H + gy) * W + gx : xc,
                ok);
    }
  };

  int moff[MT];  // staged-tile offset of this lane's A row g, per tile row
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) moff[mt] = (warp * MT + mt) * IW + g;

  // acc[mt][4 * nt + i]: the wgmma accumulator of the m64 tile whose rows are
  // tile row (warp % 4) * 2 + mt of each of the warpgroup's 4 warps
  float acc[MT][BN / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.0f;

  // A fragments of k-step ks: 4 loads and 4 splits a tile row
  auto load_a = [&](const float* in, int ks, uint32_t (&ah)[MT][4], uint32_t (&al)[MT][4]) {
    const int k0 = koff[ks * 8 + t], k1 = koff[ks * 8 + t + 4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      split_tf32(in[moff[mt] + k0], ah[mt][0], al[mt][0]);      // (row g,     k t)
      split_tf32(in[moff[mt] + 8 + k0], ah[mt][1], al[mt][1]);  // (row g + 8, k t)
      split_tf32(in[moff[mt] + k1], ah[mt][2], al[mt][2]);      // (row g,     k t + 4)
      split_tf32(in[moff[mt] + 8 + k1], ah[mt][3], al[mt][3]);  // (row g + 8, k t + 4)
    }
  };
  // wgmma path, one k-step: the warpgroup's 3 MMAs a tile row, al*bh + ah*bl
  // + ah*bh, committed as one group
  auto step = [&](const float* in, const float* wst, int ks, uint32_t (&ah)[MT][4],
                  uint32_t (&al)[MT][4]) {
    load_a(in, ks, ah, al);
    const uint64_t bh = b_desc(wst + (2 * ks) * BN * 8);
    const uint64_t bl = b_desc(wst + (2 * ks + 1) * BN * 8);
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      wgmma_tf32<BN>(acc[mt], al[mt], bh);
      wgmma_tf32<BN>(acc[mt], ah[mt], bl);
      wgmma_tf32<BN>(acc[mt], ah[mt], bh);
    }
    wgmma_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load_chunk(s);
    cp_async_commit();
  }
  for (int j = 0; j < chunks; ++j) {
    cp_async_wait<kStages - 2>();  // chunk j has landed (this thread's copies)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // ... for wgmma's reads
    __syncthreads();               // ... everyone's; stage (j - 1) % 3 is free
    if (j + kStages - 1 < chunks) load_chunk(j + kStages - 1);
    cp_async_commit();

    const float* wst = smem + (j % kStages) * plan.stage_floats;
    const float* in = wst + plan.w_floats;
    if constexpr (BN == 16) {
      // mma.sync path: b0 = B[k t][n g], b1 = B[k t + 4][n g] of n8 tile nt
      // are floats 64 nt + lane and 64 nt + 32 + lane of a (k-step, plane)
      // block of the core-matrix layout
#pragma unroll 2
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t ah[MT][4], al[MT][4];
        load_a(in, ks, ah, al);
        const float* bh = wst + (2 * ks) * BN * 8 + lane;
        const float* bl = bh + BN * 8;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t h0 = __float_as_uint(bh[64 * nt]), h1 = __float_as_uint(bh[64 * nt + 32]);
          const uint32_t l0 = __float_as_uint(bl[64 * nt]), l1 = __float_as_uint(bl[64 * nt + 32]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_tf32(&acc[mt][4 * nt], al[mt], h0, h1);
            mma_tf32(&acc[mt][4 * nt], ah[mt], l0, l1);
            mma_tf32(&acc[mt][4 * nt], ah[mt], h0, h1);
          }
        }
      }
    } else {
      // kSets register sets: the loads of the next k-steps overlap the MMAs of
      // the kSets - 1 k-steps in flight
      uint32_t ah[kSets][MT][4], al[kSets][MT][4];
      for (int ks = 0; ks < ksteps; ks += kSets) {
#pragma unroll
        for (int u = 0; u < kSets; ++u) {
          if (ks + u < ksteps) {
            step(in, wst, ks + u, ah[u], al[u]);
            wgmma_wait<kSets - 1>();  // k-step ks + u - kSets + 1 is done: its set is free
          }
        }
      }
      wgmma_wait<0>();  // this stage is read to the end before it is refilled
    }
  }
  cp_async_wait<0>();

  // epilogue: acc[mt][4 * nt + i] is pixel (row warp*MT + mt, column
  // g + 8*(i >> 1)), channel 8 nt + 2t + (i & 1) of the block
  const int n0 = nblk * BN;
  float bv[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    bv[nt][0] = __ldg(bias + n0 + nt * 8 + 2 * t);
    bv[nt][1] = __ldg(bias + n0 + nt * 8 + 2 * t + 1);
  }
  float* ob = out + static_cast<long long>(b) * F * H * W;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int y = ty0 + warp * MT + mt;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int xx = tx0 + g + 8 * (i >> 1);
        const int n = n0 + nt * 8 + 2 * t + (i & 1);
        const float v = activate<M>(acc[mt][4 * nt + i] + bv[nt][i & 1]);
        acc[mt][4 * nt + i] = v;
        if (y < H && xx < W) ob[(static_cast<long long>(n) * H + y) * W + xx] = v;
      }
    }
  }
  if constexpr (kPool) {
    float* pb = pooled + static_cast<long long>(b) * F * PH * PW;
#pragma unroll
    for (int mt = 0; mt < MT; mt += 2) {
      const int y = ty0 + warp * MT + mt;  // even: the window's top row
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int xx = tx0 + g + 8 * (i >> 1);
          float top = acc[mt][4 * nt + i], bot = acc[mt + 1][4 * nt + i], v;
          if constexpr (M == kReluMaxPool) {
            // SAME pool: max over the in-image members only
            if (!(y < H && xx < W)) top = __int_as_float(0xff800000);  // -inf
            if (!(y + 1 < H && xx < W)) bot = __int_as_float(0xff800000);
            v = fmaxf(top, bot);
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));  // column pair: lane g ^ 1
          } else {
            // VALID pool: a written window lies inside the image
            v = top + bot;
            v = (v + __shfl_xor_sync(0xffffffffu, v, 4)) * 0.25f;
          }
          const int py = y / 2, px = xx / 2;
          if (!(g & 1) && py < PH && px < PW) {
            const int n = n0 + nt * 8 + 2 * t + (i & 1);
            pb[(static_cast<long long>(n) * PH + py) * PW + px] = v;
          }
        }
      }
    }
  }
}

template <int KS, int BN, Mode M>
int launch(const float* x, const float* wpk, const float* bias, float* out, float* pooled, int B,
           int C, int F, int H, int W, int cc, int kc_pad, cudaStream_t stream) {
  const Plan plan = make_plan<KS, BN>(C, cc, kc_pad);
  if (plan.smem_bytes > static_cast<size_t>(kMaxSmemBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = conv_gemm_kernel<KS, BN, M>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(plan.smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int PH = 0, PW = 0;
  if (M == kLeakyAvgPool) {
    PH = H / 2;
    PW = W / 2;
  } else if (M == kReluMaxPool) {
    PH = (H + 1) / 2;
    PW = (W + 1) / 2;
  }
  const int tiles_x = shdr_ceil_div(W, TW);
  const dim3 grid(tiles_x * shdr_ceil_div(H, TH), F / BN, B);
  kernel<<<grid, kThreads, plan.smem_bytes, stream>>>(
      x, reinterpret_cast<const float4*>(wpk), bias, out, pooled, C, F, H, W, PH, PW, cc, kc_pad,
      tiles_x);
  return static_cast<int>(cudaGetLastError());
}

template <int KS, Mode M>
int launch_bn(int bn, const float* x, const float* wpk, const float* bias, float* out,
              float* pooled, int B, int C, int F, int H, int W, int cc, int kc_pad,
              cudaStream_t stream) {
  switch (bn) {
    case 16:
      return launch<KS, 16, M>(x, wpk, bias, out, pooled, B, C, F, H, W, cc, kc_pad, stream);
    case 32:
      return launch<KS, 32, M>(x, wpk, bias, out, pooled, B, C, F, H, W, cc, kc_pad, stream);
    case 64:
      return launch<KS, 64, M>(x, wpk, bias, out, pooled, B, C, F, H, W, cc, kc_pad, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <Mode M>
int launch_ks(int ks, int bn, const float* x, const float* wpk, const float* bias, float* out,
              float* pooled, int B, int C, int F, int H, int W, int cc, int kc_pad,
              cudaStream_t stream) {
  switch (ks) {
    case 3:
      return launch_bn<3, M>(bn, x, wpk, bias, out, pooled, B, C, F, H, W, cc, kc_pad, stream);
    case 5:
      if constexpr (M == kLeakyStore || M == kLeakyAvgPool) {
        return launch_bn<5, M>(bn, x, wpk, bias, out, pooled, B, C, F, H, W, cc, kc_pad, stream);
      }
      break;
    case 7:
      if constexpr (M == kLeakyStore || M == kLeakyAvgPool) {
        return launch_bn<7, M>(bn, x, wpk, bias, out, pooled, B, C, F, H, W, cc, kc_pad, stream);
      }
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// One SAME conv of a K2/K4 stage.  mode: 0 leaky store, 1 leaky + 2x2 avg pool
// (VALID), 2 ReLU store, 3 ReLU + 2x2 max pool (SAME); ReLU modes take ks = 3.
// The packing (bn, cc, kc_pad) is the wrapper's (ops/cuda/conv_gemm.py).
SHDR_API int shdr_conv_gemm_f32(int ks, int mode, const float* x, const float* wpk,
                                const float* bias, float* out, float* pooled, int B, int C, int F,
                                int H, int W, int bn, int cc, int kc_pad, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || cc <= 0 || C % cc != 0 || F % bn != 0 || kc_pad % 8 != 0 ||
      kc_pad < cc * ks * ks || kc_pad >= cc * ks * ks + 8 || B > 65535 || F / bn > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kLeakyStore:
      return launch_ks<kLeakyStore>(ks, bn, x, wpk, bias, out, pooled, B, C, F, H, W, cc, kc_pad, s);
    case kLeakyAvgPool:
      return launch_ks<kLeakyAvgPool>(ks, bn, x, wpk, bias, out, pooled, B, C, F, H, W, cc, kc_pad,
                                      s);
    case kReluStore:
      return launch_ks<kReluStore>(ks, bn, x, wpk, bias, out, pooled, B, C, F, H, W, cc, kc_pad, s);
    case kReluMaxPool:
      return launch_ks<kReluMaxPool>(ks, bn, x, wpk, bias, out, pooled, B, C, F, H, W, cc, kc_pad,
                                     s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
