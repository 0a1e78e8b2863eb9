// K2 and K4: a SAME conv + bias + activation as an implicit GEMM on the tensor
// cores, in 3xTF32 for f32 tensors and in one bf16 product for bf16 tensors,
// with an optional 2x2 pool in the epilogue.  One fused encoder stage is two
// launches of this kernel:
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
// What bounds it on this card: the convs' multiply-adds.  In f32 a product
// must be f32-accurate: on the CUDA cores that caps the stage at
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
//
// bf16 (the JAX package's compute dtype; x, w and the outputs bf16, the
// bias f32): the same GEMM in k-steps of 16 on bf16 tensor cores, one MMA a
// product (wgmma.mma_async m64nNk16 bf16 for BN >= 32, mma.sync m16n8k16
// bf16 for BN = 16; bf16_mma.cuh), accumulated in f32 at 989 TFLOP/s dense.
// Chunks are 16 channels (C = 3 or 9: one chunk, K padded to a multiple of
// 16), the weights one plane of bf16 core matrices (8 n x 8 k, the same 16-byte
// rows as TF32's, so the descriptor carries over).  An A register holds two
// consecutive k (2t, 2t+1), which the (c, kh, kw) order puts at two places
// of the staged tile: two 16-bit loads and a pack a register, no split.  The
// staged channel stride is side^2 rounded up to 48 mod 64 elements, which
// keeps each load on distinct words a bank (tests/test_torch_bf16.py).  The
// input tile is staged with plain loads (cp.async copies 4 bytes at least,
// and a bf16 row need not start on 4 bytes), so two blocks share an SM to
// hide that latency; the weights stream through the cp.async ring as in f32.  Epilogues round to bf16 where the Pallas kernels
// round: conv1's activation and the skip when stored; the average pool is
// taken from conv2's f32 values and then rounded; the max pool of the f32
// values, which rounds to the max of the rounded ones.  At bf16's rate the
// bound is nearer the bytes (mid written and read, skip, pool): both terms
// are printed by chip_smoke.py.  The bf16 index maps (K order, core
// matrices, A-fragment addressing, banks) are simulated in
// tests/test_torch_bf16.py.
#include <cstdint>
#include <type_traits>

#include "bf16_mma.cuh"
#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

enum Mode { kLeakyStore = 0, kLeakyAvgPool = 1, kReluStore = 2, kReluMaxPool = 3 };

constexpr int TH = 16;  // output tile rows    (ops/cuda/conv_gemm.py TILE)
constexpr int TW = 16;  // output tile columns (one m16 MMA tile per row)
constexpr int kWarps = 8;  // a warp: 2 tile rows x all BN channels of the block
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;

// Element types: f32 (3xTF32) or bf16 (kept as its 16-bit pattern)
template <bool kBf16>
struct Elem {
  using T = float;
  static constexpr int kStep = 8;    // k of one MMA step
  static constexpr int kWBytes = 8;  // packed B bytes a weight: TF32 hi + lo
};
template <>
struct Elem<true> {
  using T = uint16_t;
  static constexpr int kStep = 16;
  static constexpr int kWBytes = 2;  // one bf16
};

template <Mode M>
__device__ __forceinline__ float activate(float v) {
  if constexpr (M == kLeakyStore || M == kLeakyAvgPool) {
    return v > 0.0f ? v : v * 0.1f;
  } else {
    return fmaxf(v, 0.0f);
  }
}

template <bool kBf16>
__device__ __forceinline__ typename Elem<kBf16>::T to_elem(float v) {
  if constexpr (kBf16) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// The staged input tile's channel stride in elements.  f32: IH * IW plus
// KS + 7 floats, which spreads the 4 k-columns of an A fragment load over
// distinct banks.  bf16: IH * IW rounded up to 48 mod 64 elements, which
// keeps the 16-bit loads of a fragment on distinct words a bank.  Both are
// checked for every layer of the main path by tests/test_torch_conv_gemm.py
// and tests/test_torch_bf16.py.
template <int KS, bool kBf16>
__host__ __device__ constexpr int channel_stride() {
  constexpr int area = (TH + KS - 1) * (TW + KS - 1);
  if constexpr (kBf16) {
    return area + (112 - area % 64) % 64;
  } else {
    return area + KS + 7;
  }
}

// Shared-memory plan of one launch (bytes): kStages (or fewer, when the
// layer has fewer chunks) stages of [packed weights | input tile | zero
// rows], then the k -> offset table.
struct Plan {
  int w_bytes;      // kc_pad * BN * (8 f32 hi/lo | 2 bf16)
  int in_elems;     // cc * channel_stride
  int zero_elems;   // TH * IW when the chunk's K is padded, else 0
  int stage_bytes;  // w_bytes + (in_elems + zero_elems) elements, rounded up to 16 bytes
  int stages;
  size_t smem_bytes;
};

template <bool kBf16, int KS, int BN>
__host__ __device__ inline Plan make_plan(int C, int cc, int kc_pad) {
  using T = typename Elem<kBf16>::T;
  constexpr int IW = TW + KS - 1;
  Plan p;
  p.w_bytes = kc_pad * BN * Elem<kBf16>::kWBytes;
  p.in_elems = cc * channel_stride<KS, kBf16>();
  p.zero_elems = cc * KS * KS < kc_pad ? TH * IW : 0;
  p.stage_bytes = p.w_bytes + ((static_cast<int>(sizeof(T)) * (p.in_elems + p.zero_elems) + 15) & ~15);
  const int chunks = C / cc;
  p.stages = chunks < kStages ? chunks : kStages;
  p.smem_bytes = static_cast<size_t>(p.stages) * p.stage_bytes + sizeof(int) * kc_pad;
  return p;
}

// x: [B, C, H, W]; wpk: the core matrices of ops/cuda/conv_gemm.py
// pack_weights, f32 [F/BN][C/cc][kc_pad/8][hi, lo][BN/8][2][8][4] or bf16
// [F/BN][C/cc][kc_pad/16][BN/8][2][8][8]; bias: [F] f32; out: [B, F, H, W];
// pooled: [B, F, PH, PW] (pooling modes only); x, out, pooled in T
// bf16 runs two blocks an SM (a bf16 stage is at most 90 KB of shared memory,
// and registers are capped at 128 a thread, a few spilled at BN = 64): one
// block's staging of its input tile with plain loads overlaps the other's
// MMAs.  f32 keeps one block an SM.
template <bool kBf16, int KS, int BN, Mode M>
__global__ void __launch_bounds__(kThreads, kBf16 ? 2 : 1)
conv_gemm_kernel(const typename Elem<kBf16>::T* __restrict__ x, const uint4* __restrict__ wpk,
                 const float* __restrict__ bias, typename Elem<kBf16>::T* __restrict__ out,
                 typename Elem<kBf16>::T* __restrict__ pooled, int C, int F, int H, int W,
                 int PH, int PW, int cc, int kc_pad, int tiles_x) {
  using T = typename Elem<kBf16>::T;
  constexpr int R = KS / 2;
  constexpr int IH = TH + KS - 1, IW = TW + KS - 1, CS = channel_stride<KS, kBf16>();
  constexpr int MT = TH / kWarps;  // tile rows (m16 tiles) of a warp
  constexpr int NT = BN / 8;       // n8 tiles of a warp
  constexpr int KSTEP = Elem<kBf16>::kStep;
  // register sets of A fragments for the wgmma path: more k-steps in flight
  // where each wgmma is shorter
  constexpr int kSets = BN == 32 ? 3 : 2;
  constexpr bool kPool = M == kLeakyAvgPool || M == kReluMaxPool;
  static_assert(MT % 2 == 0, "a pool window's two rows must sit in one warp");

  extern __shared__ __align__(16) unsigned char smem[];
  const Plan plan = make_plan<kBf16, KS, BN>(C, cc, kc_pad);
  const int chunks = C / cc;
  const int ksteps = kc_pad / KSTEP;
  const int kvalid = cc * KS * KS;
  int* koff = reinterpret_cast<int*>(smem + plan.stages * plan.stage_bytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, nblk = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TH, tx0 = (blockIdx.x % tiles_x) * TW;

  // im2col in shared memory: chunk-local k = (c, kh, kw) -> offset of tap
  // (0, 0)'s input in the staged tile; the padded k read the zero rows
  for (int k = tid; k < kc_pad; k += kThreads) {
    int off = plan.in_elems;
    if (k < kvalid) {
      const int c = k / (KS * KS), r = k % (KS * KS);
      off = c * CS + (r / KS) * IW + r % KS;
    }
    koff[k] = off;
  }
  for (int s = 0; s < plan.stages; ++s) {
    T* z = reinterpret_cast<T*>(smem + s * plan.stage_bytes + plan.w_bytes) + plan.in_elems;
    for (int i = tid; i < plan.zero_elems; i += kThreads) z[i] = T(0);
  }

  const T* xb = x + static_cast<long long>(b) * C * H * W;
  const uint4* wb = wpk + static_cast<long long>(nblk) * chunks * (plan.w_bytes / 16);

  auto load_chunk = [&](int j) {
    unsigned char* st = smem + (j % kStages) * plan.stage_bytes;
    const uint4* wsrc = wb + static_cast<long long>(j) * (plan.w_bytes / 16);
    uint4* wdst = reinterpret_cast<uint4*>(st);
    for (int i = tid; i < plan.w_bytes / 16; i += kThreads) cp_async16(wdst + i, wsrc + i);
    T* in = reinterpret_cast<T*>(st + plan.w_bytes);
    const T* xc = xb + static_cast<long long>(j) * cc * H * W;
#pragma unroll 4
    for (int i = tid; i < cc * IH * IW; i += kThreads) {
      const int c = i / (IH * IW), r = i % (IH * IW);
      const int gy = ty0 - R + r / IW, gx = tx0 - R + r % IW;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const long long at = (static_cast<long long>(c) * H + gy) * W + gx;
      if constexpr (kBf16) {
        in[c * CS + r] = ok ? __ldg(xc + at) : T(0);  // plain load; 0 is the SAME padding
      } else {
        cp_async4(in + c * CS + r, ok ? xc + at : xc, ok);
      }
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

  // f32: A fragments of k-step ks, 4 loads and 4 splits a tile row
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
  // bf16: A fragments of k-step ks, 8 16-bit loads and 4 packs a tile row
  auto load_a_bf16 = [&](const uint16_t* in, int ks, uint32_t (&a)[MT][4]) {
    const int kb = ks * 16 + 2 * t;
    const int k0 = koff[kb], k1 = koff[kb + 1], k8 = koff[kb + 8], k9 = koff[kb + 9];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint16_t* p = in + moff[mt];
      a[mt][0] = pack_bf16(p[k0], p[k1]);          // (row g,     k 2t, 2t + 1)
      a[mt][1] = pack_bf16(p[8 + k0], p[8 + k1]);  // (row g + 8, k 2t, 2t + 1)
      a[mt][2] = pack_bf16(p[k8], p[k9]);          // (row g,     k 2t + 8, 2t + 9)
      a[mt][3] = pack_bf16(p[8 + k8], p[8 + k9]);  // (row g + 8, k 2t + 8, 2t + 9)
    }
  };
  // f32 wgmma path, one k-step: the warpgroup's 3 MMAs a tile row, al*bh +
  // ah*bl + ah*bh, committed as one group
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
  // bf16 wgmma path, one k-step: one MMA a tile row (a k-step's B is BN x 16
  // bf16, BN * 32 bytes)
  auto step_bf16 = [&](const uint16_t* in, const unsigned char* wst, int ks, uint32_t (&a)[MT][4]) {
    load_a_bf16(in, ks, a);
    const uint64_t bd = b_desc(wst + ks * BN * 32);
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) wgmma_bf16<BN>(acc[mt], a[mt], bd);
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

    const unsigned char* wst_bytes = smem + (j % kStages) * plan.stage_bytes;
    if constexpr (kBf16) {
      const uint16_t* in = reinterpret_cast<const uint16_t*>(wst_bytes + plan.w_bytes);
      if constexpr (BN == 16) {
        // mma.sync path: b0 = B[k 2t, 2t+1][n g], b1 = B[k 2t+8, 2t+9][n g]
        // of n8 tile nt are words 64 nt + lane and 64 nt + 32 + lane of a
        // k-step's block of the core-matrix layout (BN * 8 words)
#pragma unroll 2
        for (int ks = 0; ks < ksteps; ++ks) {
          uint32_t a[MT][4];
          load_a_bf16(in, ks, a);
          const uint32_t* bw = reinterpret_cast<const uint32_t*>(wst_bytes) + ks * BN * 8 + lane;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint32_t b0 = bw[64 * nt], b1 = bw[64 * nt + 32];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma_bf16(&acc[mt][4 * nt], a[mt], b0, b1);
          }
        }
      } else {
        uint32_t a[kSets][MT][4];
        for (int ks = 0; ks < ksteps; ks += kSets) {
#pragma unroll
          for (int u = 0; u < kSets; ++u) {
            if (ks + u < ksteps) {
              step_bf16(in, wst_bytes, ks + u, a[u]);
              wgmma_wait<kSets - 1>();  // k-step ks + u - kSets + 1 is done: its set is free
            }
          }
        }
        wgmma_wait<0>();  // this stage is read to the end before it is refilled
      }
    } else {
      const float* wst = reinterpret_cast<const float*>(wst_bytes);
      const float* in = reinterpret_cast<const float*>(wst_bytes + plan.w_bytes);
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
  }
  cp_async_wait<0>();

  // epilogue: acc[mt][4 * nt + i] is pixel (row warp*MT + mt, column
  // g + 8*(i >> 1)), channel 8 nt + 2t + (i & 1) of the block; the stored
  // value is rounded to T, the pool reads the f32 values
  const int n0 = nblk * BN;
  float bv[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    bv[nt][0] = __ldg(bias + n0 + nt * 8 + 2 * t);
    bv[nt][1] = __ldg(bias + n0 + nt * 8 + 2 * t + 1);
  }
  T* ob = out + static_cast<long long>(b) * F * H * W;
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
        if (y < H && xx < W) ob[(static_cast<long long>(n) * H + y) * W + xx] = to_elem<kBf16>(v);
      }
    }
  }
  if constexpr (kPool) {
    T* pb = pooled + static_cast<long long>(b) * F * PH * PW;
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
            pb[(static_cast<long long>(n) * PH + py) * PW + px] = to_elem<kBf16>(v);
          }
        }
      }
    }
  }
}

template <bool kBf16, int KS, int BN, Mode M>
int launch(const void* x, const void* wpk, const float* bias, void* out, void* pooled, int B,
           int C, int F, int H, int W, int cc, int kc_pad, cudaStream_t stream) {
  using T = typename Elem<kBf16>::T;
  const Plan plan = make_plan<kBf16, KS, BN>(C, cc, kc_pad);
  if (plan.smem_bytes > static_cast<size_t>(kMaxSmemBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = conv_gemm_kernel<kBf16, KS, BN, M>;
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
      static_cast<const T*>(x), static_cast<const uint4*>(wpk), bias, static_cast<T*>(out),
      static_cast<T*>(pooled), C, F, H, W, PH, PW, cc, kc_pad, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16, int KS, Mode M>
int launch_bn(int bn, const void* x, const void* wpk, const float* bias, void* out,
              void* pooled, int B, int C, int F, int H, int W, int cc, int kc_pad,
              cudaStream_t stream) {
  switch (bn) {
    case 16:
      return launch<kBf16, KS, 16, M>(x, wpk, bias, out, pooled, B, C, F, H, W, cc, kc_pad, stream);
    case 32:
      return launch<kBf16, KS, 32, M>(x, wpk, bias, out, pooled, B, C, F, H, W, cc, kc_pad, stream);
    case 64:
      return launch<kBf16, KS, 64, M>(x, wpk, bias, out, pooled, B, C, F, H, W, cc, kc_pad, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kBf16, Mode M>
int launch_ks(int ks, int bn, const void* x, const void* wpk, const float* bias, void* out,
              void* pooled, int B, int C, int F, int H, int W, int cc, int kc_pad,
              cudaStream_t stream) {
  switch (ks) {
    case 3:
      return launch_bn<kBf16, 3, M>(bn, x, wpk, bias, out, pooled, B, C, F, H, W, cc, kc_pad,
                                    stream);
    case 5:
      if constexpr (M == kLeakyStore || M == kLeakyAvgPool) {
        return launch_bn<kBf16, 5, M>(bn, x, wpk, bias, out, pooled, B, C, F, H, W, cc, kc_pad,
                                      stream);
      }
      break;
    case 7:
      if constexpr (M == kLeakyStore || M == kLeakyAvgPool) {
        return launch_bn<kBf16, 7, M>(bn, x, wpk, bias, out, pooled, B, C, F, H, W, cc, kc_pad,
                                      stream);
      }
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kBf16>
int launch_mode(int ks, int mode, const void* x, const void* wpk, const float* bias, void* out,
                void* pooled, int B, int C, int F, int H, int W, int bn, int cc, int kc_pad,
                void* stream) {
  constexpr int step = Elem<kBf16>::kStep;
  if (B <= 0 || H <= 0 || W <= 0 || cc <= 0 || C % cc != 0 || F % bn != 0 ||
      kc_pad % step != 0 || kc_pad < cc * ks * ks || kc_pad >= cc * ks * ks + step ||
      B > 65535 || F / bn > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kLeakyStore:
      return launch_ks<kBf16, kLeakyStore>(ks, bn, x, wpk, bias, out, pooled, B, C, F, H, W, cc,
                                           kc_pad, s);
    case kLeakyAvgPool:
      return launch_ks<kBf16, kLeakyAvgPool>(ks, bn, x, wpk, bias, out, pooled, B, C, F, H, W, cc,
                                             kc_pad, s);
    case kReluStore:
      return launch_ks<kBf16, kReluStore>(ks, bn, x, wpk, bias, out, pooled, B, C, F, H, W, cc,
                                          kc_pad, s);
    case kReluMaxPool:
      return launch_ks<kBf16, kReluMaxPool>(ks, bn, x, wpk, bias, out, pooled, B, C, F, H, W, cc,
                                            kc_pad, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One SAME conv of a K2/K4 stage in f32 (3xTF32).  mode: 0 leaky store, 1
// leaky + 2x2 avg pool (VALID), 2 ReLU store, 3 ReLU + 2x2 max pool (SAME);
// ReLU modes take ks = 3.  The packing (bn, cc, kc_pad) is the wrapper's
// (ops/cuda/conv_gemm.py).
SHDR_API int shdr_conv_gemm_f32(int ks, int mode, const float* x, const float* wpk,
                                const float* bias, float* out, float* pooled, int B, int C, int F,
                                int H, int W, int bn, int cc, int kc_pad, void* stream) {
  return launch_mode<false>(ks, mode, x, wpk, bias, out, pooled, B, C, F, H, W, bn, cc, kc_pad,
                            stream);
}

// The same conv in bf16: x, wpk, out and pooled bf16, bias f32.
SHDR_API int shdr_conv_gemm_bf16(int ks, int mode, const void* x, const void* wpk,
                                 const float* bias, void* out, void* pooled, int B, int C, int F,
                                 int H, int W, int bn, int cc, int kc_pad, void* stream) {
  return launch_mode<true>(ks, mode, x, wpk, bias, out, pooled, B, C, F, H, W, bn, cc, kc_pad,
                           stream);
}
