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
// f32, the GEMM per launch:  M = the output pixels of a 16 x 16 tile of one
// image, N = BN output channels (blockIdx.y picks the slice), K = C*k*k in
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
// mt and mt + 1), the two columns in lanes g and g ^ 1 (one shuffle).  The
// index maps (tile, halo, offset table, fragment and descriptor layouts, pool)
// are simulated in numpy by tests/test_torch_conv_gemm.py.
//
// bf16 (the JAX package's compute dtype; x, w and the outputs bf16, the bias
// f32): one bf16 product a multiply-add, accumulated in f32, 989 TFLOP/s
// dense.  At that rate what bounds a tensor-core conv is how its operands
// reach the tensor cores, so the bf16 path is built around one layout:
//   * K in (kh, kw, c) order.  A chunk of 16 input channels is staged as two
//     planes of 8 channels, [plane][iy][ix][8 c]: one pixel is one 16-byte
//     row, and 8 neighbouring pixels of a staged row are one 128-byte core
//     matrix.  A k-step is one tap x 16 channels (k 0-7 plane 0, 8-15 plane
//     1).  A layer of at most 4 input channels (the RGB inputs) stages one
//     plane whose 16-byte row at pixel p holds 4 channels (3 of them real) of
//     pixels p and p + 1: a k half is then two taps of a kernel row, and a
//     k-step four (taps past the row meet zero weights): 3-3.5x fewer
//     k-steps than 16 padded channels; 9 channels take two planes.  The
//     weights are packed in the same order (ops/cuda/conv_gemm.py
//     weight_rows_bf16) as wgmma's K-major core matrices, as in f32.
//   * BN >= 32: wgmma.mma_async m64nBNk16 with A and B both read by the tensor
//     cores from shared memory through descriptors.  An m64 tile is 8 tile
//     rows x 8 columns; its descriptor starts at the tap's pixel of the
//     tile's corner, strides one staged row (IW x 16 bytes) from core to core,
//     and leads to channels 8-15 by one plane (or to the taps kw + 2, kw + 3).
//     No A registers, no gather, no offset table: each k-step is a
//     descriptor and one instruction per m64 tile.  A block is 16 x 16 pixels
//     (four m64 tiles, two a warpgroup) and at most 64 channels, two blocks
//     an SM.  (hal enc2 at BN = 128, each A tile read once for all 128
//     channels, ran one block an SM and measured slower.)
//   * BN = 16 (the U-Nets' 7x7 stems): mma.sync m16n8k16, A by ldmatrix.x4
//     from the same tile (one instruction a fragment), B by ldmatrix.x4 from
//     the packed weights.  A warp owns 4 tile rows (a block 32 x 16 pixels);
//     a fragment of staged row y and column kw serves every (tile row, kh)
//     with row + kh = y, so a warp loads 10 A fragments, not 28, for a kernel
//     column of 7 taps, with that column's 7 B fragments held in registers.
//     At N = 16 the stems reach about a third of the tensor cores' rate; a
//     wgmma m64n16, which reads the whole A tile a product, measured slower.
//   * Staging runs ahead of the MMAs in a 3-slot ring.  conv1's activation
//     `mid` is private to the stage and is stored channel-blocked,
//     [B][F/8][H][W][8] (lanes t = 0..3 of a fragment row write one pixel's
//     16 bytes), so conv2 stages its tile with 16-byte cp.async copies whose
//     zero-fill form is the SAME padding.  conv1's input is NCHW (the
//     wrappers' contract): 8 channels of a pixel are loaded into registers
//     (where they fit, the next chunk's while a chunk's MMAs run) and stored
//     as one 16-byte row.  `skip` and `pooled` stay NCHW; conv2 stages both
//     in shared memory and writes them in 16-byte rows.
// Epilogues round to bf16 where the Pallas kernels round: conv1's activation
// and the skip when stored; the average pool is taken from conv2's f32 values
// and then rounded; the max pool of the f32 values, which rounds to the max of
// the rounded ones.  The bf16 index maps (staging, descriptors, ldmatrix
// addresses, packing, the blocked mid, pool) are simulated lane by lane in
// tests/test_torch_bf16.py.
#include <cstdint>

#include "bf16_mma.cuh"
#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

enum Mode { kLeakyStore = 0, kLeakyAvgPool = 1, kReluStore = 2, kReluMaxPool = 3 };

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

template <Mode M>
__device__ __forceinline__ float activate(float v) {
  if constexpr (M == kLeakyStore || M == kLeakyAvgPool) {
    return v > 0.0f ? v : v * 0.1f;
  } else {
    return fmaxf(v, 0.0f);
  }
}

template <Mode M>
__host__ __device__ constexpr bool pools() {
  return M == kLeakyAvgPool || M == kReluMaxPool;
}

// ---------------------------------------------------------------- f32 ----

constexpr int TH = 16;  // output tile rows    (ops/cuda/conv_gemm.py TILE)
constexpr int TW = 16;  // output tile columns (one m16 MMA tile per row)
constexpr int kStages = 3;

// The staged input tile's channel stride in floats: IH * IW plus KS + 7,
// which spreads the 4 k-columns of an A fragment load over distinct banks
// (checked for every layer of the main path by tests/test_torch_conv_gemm.py).
template <int KS>
__host__ __device__ constexpr int channel_stride() {
  return (TH + KS - 1) * (TW + KS - 1) + KS + 7;
}

// Shared-memory plan of one launch (bytes): kStages (or fewer, when the
// layer has fewer chunks) stages of [packed weights | input tile | zero
// rows], then the k -> offset table.
struct Plan {
  int w_bytes;      // kc_pad * BN * 8 (hi/lo)
  int in_elems;     // cc * channel_stride
  int zero_elems;   // TH * IW when the chunk's K is padded, else 0
  int stage_bytes;  // w_bytes + (in_elems + zero_elems) floats, rounded up to 16 bytes
  int stages;
  size_t smem_bytes;
};

template <int KS, int BN>
__host__ __device__ inline Plan make_plan(int C, int cc, int kc_pad) {
  constexpr int IW = TW + KS - 1;
  Plan p;
  p.w_bytes = kc_pad * BN * 8;
  p.in_elems = cc * channel_stride<KS>();
  p.zero_elems = cc * KS * KS < kc_pad ? TH * IW : 0;
  p.stage_bytes = p.w_bytes + ((4 * (p.in_elems + p.zero_elems) + 15) & ~15);
  const int chunks = C / cc;
  p.stages = chunks < kStages ? chunks : kStages;
  p.smem_bytes = static_cast<size_t>(p.stages) * p.stage_bytes + sizeof(int) * kc_pad;
  return p;
}

// x: [B, C, H, W]; wpk: the core matrices of ops/cuda/conv_gemm.py
// pack_weights, [F/BN][C/cc][kc_pad/8][hi, lo][BN/8][2][8][4]; bias: [F];
// out: [B, F, H, W]; pooled: [B, F, PH, PW] (pooling modes only)
template <int KS, int BN, Mode M>
__global__ void __launch_bounds__(kThreads, 1)
conv_gemm_kernel(const float* __restrict__ x, const uint4* __restrict__ wpk,
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
  constexpr bool kPool = pools<M>();
  static_assert(MT % 2 == 0, "a pool window's two rows must sit in one warp");

  extern __shared__ __align__(16) unsigned char smem[];
  const Plan plan = make_plan<KS, BN>(C, cc, kc_pad);
  const int chunks = C / cc;
  const int ksteps = kc_pad / 8;
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
    float* z = reinterpret_cast<float*>(smem + s * plan.stage_bytes + plan.w_bytes) + plan.in_elems;
    for (int i = tid; i < plan.zero_elems; i += kThreads) z[i] = 0.0f;
  }

  const float* xb = x + static_cast<long long>(b) * C * H * W;
  const uint4* wb = wpk + static_cast<long long>(nblk) * chunks * (plan.w_bytes / 16);

  auto load_chunk = [&](int j) {
    unsigned char* st = smem + (j % kStages) * plan.stage_bytes;
    const uint4* wsrc = wb + static_cast<long long>(j) * (plan.w_bytes / 16);
    uint4* wdst = reinterpret_cast<uint4*>(st);
    for (int i = tid; i < plan.w_bytes / 16; i += kThreads) cp_async16(wdst + i, wsrc + i);
    float* in = reinterpret_cast<float*>(st + plan.w_bytes);
    const float* xc = xb + static_cast<long long>(j) * cc * H * W;
#pragma unroll 4
    for (int i = tid; i < cc * IH * IW; i += kThreads) {
      const int c = i / (IH * IW), r = i % (IH * IW);
      const int gy = ty0 - R + r / IW, gx = tx0 - R + r % IW;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const long long at = (static_cast<long long>(c) * H + gy) * W + gx;
      cp_async4(in + c * CS + r, ok ? xc + at : xc, ok);
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

  // A fragments of k-step ks, 4 loads and 4 splits a tile row
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
  // wgmma path, one k-step: the warpgroup's 3 MMAs a tile row, al*bh +
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
  cp_async_wait<0>();

  // epilogue: acc[mt][4 * nt + i] is pixel (row warp*MT + mt, column
  // g + 8*(i >> 1)), channel 8 nt + 2t + (i & 1) of the block; the pool reads
  // the stored values
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

// --------------------------------------------------------------- bf16 ----

// The 16-channel stems (BN = 16) take mma.sync; wider blocks take wgmma.
template <int BN>
__host__ __device__ constexpr bool sync_path() {
  return BN == 16;
}

// Output tile rows: a warp's 4 rows x 8 warps on the mma.sync path, two
// warpgroups' m64 tiles of 8 rows on the wgmma path; 16 columns on both.
template <int BN>
__host__ __device__ constexpr int tile_rows_bf16() {
  return sync_path<BN>() ? 32 : 16;
}
constexpr int kTileColsBf16 = 16;
constexpr int kRingBf16 = 3;  // ring slots: chunk j's MMAs run while j + 1 and j + 2 load

// k-steps of a chunk: one a tap with two planes; with one plane (pixel-pair
// rows of 4 channels), four taps of a kernel row, each row padded to a
// multiple of 4 taps
__host__ __device__ constexpr int ksteps_bf16(int ks, int planes) {
  return planes == 2 ? ks * ks : ks * ((ks + 3) / 4);
}

// Shared memory of one ring slot (bytes): the chunk's packed B, then its
// staged planes of IH x IW pixels x 16 bytes.  A launch holds
// min(chunks, kRingBf16) slots and nothing else.
template <int KS, int BN, int P>
__host__ __device__ constexpr int slot_bytes_bf16() {
  return ksteps_bf16(KS, P) * 32 * BN +
         P * (tile_rows_bf16<BN>() + KS - 1) * (kTileColsBf16 + KS - 1) * 16;
}

// x: conv1 (store modes) [B, C, H, W], conv2 (pool modes) channel-blocked
// [B, C/8, H, W, 8]; wpk: ops/cuda/conv_gemm.py pack_weights,
// [F/BN][chunks][ksteps][BN/8][2][8][8]; bias: [F] f32; out: conv1
// channel-blocked [B, F/8, H, W, 8], conv2 [B, F, H, W]; pooled: [B, F, PH,
// PW]; all but the bias bf16 bit patterns.  P: two staged planes of 8
// channels, or (P = 1) one plane of pixel pairs x 4 channels.
// Two blocks an SM.
template <int KS, int BN, Mode M, int P>
__global__ void __launch_bounds__(kThreads, 2)
conv_gemm_bf16_kernel(const uint16_t* __restrict__ x, const uint4* __restrict__ wpk,
                      const float* __restrict__ bias, uint16_t* __restrict__ out,
                      uint16_t* __restrict__ pooled, int C, int F, int H, int W, int PH, int PW,
                      int tiles_x) {
  constexpr bool kPool = pools<M>();  // conv2: blocked input, NCHW skip + pool
  constexpr bool kSync = sync_path<BN>();
  constexpr int TH_ = tile_rows_bf16<BN>(), TW_ = kTileColsBf16;
  constexpr int R = KS / 2, IH = TH_ + KS - 1, IW = TW_ + KS - 1;
  constexpr int CSR = P == 2 ? KS : (KS + 3) / 4;  // k-steps of a kernel row
  constexpr int WB = ksteps_bf16(KS, P) * 32 * BN;  // a chunk's packed B
  constexpr int PB = IH * IW * 16;                  // one staged plane
  constexpr int SLOT = slot_bytes_bf16<KS, BN, P>();
  constexpr int PIX = P * IH * IW;                  // staged 16-byte rows a chunk
  // mma.sync: tile rows of a warp; wgmma: m64 tiles of a warpgroup
  constexpr int MT = kSync ? 4 : 2;
  constexpr int NT = BN / 8;
  static_assert(!kPool || P == 2, "conv2 reads 16-channel chunks of the blocked mid");
  static_assert(!kSync || BN == 16, "the mma.sync path holds one 16-wide B a tap");

  extern __shared__ __align__(128) unsigned char smem[];
  const int chunks = P == 2 ? (C + 15) / 16 : 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, nblk = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TH_, tx0 = (blockIdx.x % tiles_x) * TW_;
  const uint32_t smem0 = smem_addr(smem);
  const uint4* wb = wpk + static_cast<long long>(nblk) * chunks * (WB / 16);

  auto load_weights = [&](int j) {
    uint4* dst = reinterpret_cast<uint4*>(smem + (j % kRingBf16) * SLOT);
    const uint4* src = wb + static_cast<long long>(j) * (WB / 16);
    for (int i = tid; i < WB / 16; i += kThreads) cp_async16(dst + i, src + i);
  };
  // conv2: chunk j's tile of the blocked input, one 16-byte copy a pixel and
  // plane; 16 zero bytes outside the image
  auto load_tile_async = [&](int j) {
    const uint32_t dst = smem0 + (j % kRingBf16) * SLOT + WB;
    for (int i = tid; i < PIX; i += kThreads) {
      const int q = i / (IH * IW), r = i % (IH * IW);
      const int gy = ty0 - R + r / IW, gx = tx0 - R + r % IW;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const uint16_t* src =
          x + (((static_cast<long long>(b) * (C / 8) + j * P + q) * H + gy) * W + gx) * 8;
      cp_async16_zfill(dst + i * 16, ok ? src : x, ok);
    }
  };
  // conv1: chunk j's tile of the NCHW input through registers, one 16-byte
  // row (8 channels of a pixel and plane, or 4 channels of pixels p and
  // p + 1) a time; zeros outside the image and past C.
  // A load lands in a register of its own and is packed only when stored, so
  // all of a thread's loads are in flight together.  Where those registers
  // fit beside the accumulators (the wgmma path's 3x3 and 32-channel layers),
  // chunk j + 1's loads are in flight while chunk j's MMAs run; elsewhere a
  // chunk is loaded and stored after the one before it has run, in groups
  // of at most 4 rows a thread (3 at BN = 64).
  constexpr int U = kPool ? 1 : (PIX + kThreads - 1) / kThreads;  // rows a thread
  constexpr int kStageRegs = 88 - MT * BN / 2;  // registers beside the accumulators
  constexpr bool kAhead = !kPool && !kSync && U * 8 <= kStageRegs;
  constexpr int UG = kAhead ? U : (U < 4 && U * 8 <= kStageRegs ? U : (kStageRegs < 32 ? kStageRegs / 8 : 4));
  uint32_t staged[UG][8];
  auto fetch_rows = [&](int j, int u0) {
#pragma unroll
    for (int u = 0; u < UG; ++u) {
      const int i = tid + (u0 + u) * kThreads;
#pragma unroll
      for (int c = 0; c < 8; ++c) staged[u][c] = 0u;
      const int q = i / (IH * IW), r = i % (IH * IW);
      const int gy = ty0 - R + r / IW, gx = tx0 - R + r % IW;
      if (i < PIX && gy >= 0 && gy < H) {
        const int c0 = P == 2 ? j * 16 + q * 8 : 0;
        const uint16_t* src = x + ((static_cast<long long>(b) * C + c0) * H + gy) * W + gx;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = P == 2 ? e : e & 3, dx = P == 2 ? 0 : e >> 2;  // channel, pixel
          if (c0 + c < C && gx + dx >= 0 && gx + dx < W) {
            staged[u][e] = __ldg(src + static_cast<long long>(c) * H * W + dx);
          }
        }
      }
    }
  };
  auto store_rows = [&](int j, int u0) {
    uint4* dst = reinterpret_cast<uint4*>(smem + (j % kRingBf16) * SLOT + WB);
#pragma unroll
    for (int u = 0; u < UG; ++u) {
      const int i = tid + (u0 + u) * kThreads;
      if (i < PIX) {
        dst[i] = make_uint4(staged[u][0] | staged[u][1] << 16, staged[u][2] | staged[u][3] << 16,
                            staged[u][4] | staged[u][5] << 16, staged[u][6] | staged[u][7] << 16);
      }
    }
  };
  auto stage_now = [&](int j) {
    for (int u0 = 0; u0 < U; u0 += UG) {
      fetch_rows(j, u0);
      store_rows(j, u0);
    }
  };

  // acc[mt][4 * nt + i]: mma.sync, tile row 4 warp + mt, column g + 8 (i >> 1);
  // wgmma, the m64 tile of columns 8 mt .. 8 mt + 7: tile row
  // 8 (warp / 4) + 2 (warp % 4) + (i >> 1), column 8 mt + g; channel
  // 8 nt + 2t + (i & 1) of the block in both
  float acc[MT][BN / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.0f;

  // wgmma: a chunk's k-steps issued back to back and committed as one group
  auto mma_chunk_wgmma = [&](int j) {
    if constexpr (!kSync) {
      const uint32_t wbase = smem0 + (j % kRingBf16) * SLOT, tbase = wbase + WB;
      const int row0 = 8 * (warp / 4);  // the warpgroup's first tile row
      wgmma_fence();
#pragma unroll
      for (int kh = 0; kh < KS; ++kh) {
#pragma unroll
        for (int c = 0; c < CSR; ++c) {
          // k 0-7: tap (kh, kw0), plane 0; k 8-15: plane 1 of the same tap, or
          // (one plane) taps kw0, kw0 + 1 and kw1, kw1 + 1 (kw1 = kw0 against
          // zero weights past the row)
          const int kw0 = P == 2 ? c : 4 * c;
          const int kw1 = P == 2 ? c : (4 * c + 2 < KS ? 4 * c + 2 : 4 * c);
          const uint32_t lead = P == 2 ? PB : (kw1 - kw0) * 16;
          const uint64_t bd =
              smem_desc(wbase + (kh * CSR + c) * BN * 32, kLeadBytes, kStrideBytes);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint32_t a = tbase + ((row0 + kh) * IW + 8 * mt + kw0) * 16;
            wgmma_bf16_ss<BN>(acc[mt], smem_desc(a, lead, IW * 16), bd);
          }
        }
      }
      wgmma_commit();
    }
  };
  // mma.sync: kernel column by kernel column; the column's B fragments in
  // registers, each A fragment (staged row y) used for every tile row it feeds
  auto mma_chunk_sync = [&](int j) {
    if constexpr (kSync) {
      const uint32_t wbase = smem0 + (j % kRingBf16) * SLOT, tbase = wbase + WB;
      const int q = lane >> 3, h = q >> 1;  // this lane's ldmatrix matrix, and its k half
      // row (lane & 7) of matrix q: pixel column (lane & 7) + 8 (q & 1) of the
      // warp's first tile row, channels 8h .. 8h + 7 (two planes; one plane:
      // the row 2h columns on)
      const uint32_t a_lane =
          tbase + (P == 2 ? h * PB : 0) + ((warp * MT) * IW + (lane & 7) + 8 * (q & 1)) * 16;
#pragma unroll 1
      for (int c = 0; c < CSR; ++c) {
        const int kw = P == 2 ? c : (4 * c + 2 * h < KS ? 4 * c + 2 * h : 4 * c);
        uint32_t bf[KS][4];
#pragma unroll
        for (int kh = 0; kh < KS; ++kh) {
          ldmatrix_x4(bf[kh], wbase + (kh * CSR + c) * BN * 32 + lane * 16);
        }
#pragma unroll
        for (int y = 0; y < MT + KS - 1; ++y) {
          uint32_t a[4];
          ldmatrix_x4(a, a_lane + (y * IW + kw) * 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int kh = y - mt;
            if (kh >= 0 && kh < KS) {
              mma_bf16(&acc[mt][0], a, bf[kh][0], bf[kh][1]);
              mma_bf16(&acc[mt][4], a, bf[kh][2], bf[kh][3]);
            }
          }
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kRingBf16 - 1; ++s) {
    if (s < chunks) {
      load_weights(s);
      if constexpr (kPool) load_tile_async(s);
    }
    cp_async_commit();
  }
  if constexpr (!kPool) {
    stage_now(0);
    if (kAhead && chunks > 1) fetch_rows(1, 0);
  }
  for (int j = 0; j < chunks; ++j) {
    cp_async_wait<kRingBf16 - 2>();  // chunk j has landed (this thread's copies)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // ... for wgmma's reads
    __syncthreads();                 // ... everyone's; slot (j - 1) % 3 is free
    if (j + kRingBf16 - 1 < chunks) {
      load_weights(j + kRingBf16 - 1);
      if constexpr (kPool) load_tile_async(j + kRingBf16 - 1);
    }
    cp_async_commit();
    if constexpr (kSync) {
      mma_chunk_sync(j);
    } else {
      mma_chunk_wgmma(j);
    }
    if constexpr (kAhead) {
      // while the MMAs run: chunk j + 1 into its slot (last read by chunk
      // j - 2), then chunk j + 2's loads
      if (j + 1 < chunks) {
        store_rows(j + 1, 0);
        if (j + 2 < chunks) fetch_rows(j + 2, 0);
      }
    } else if constexpr (!kPool) {
      if (j + 1 < chunks) stage_now(j + 1);
    }
    if constexpr (!kSync) wgmma_wait<0>();  // the slot is read to the end before it is refilled
  }
  cp_async_wait<0>();

  // epilogue, one n8 tile at a time (its accumulators die as it is written):
  // the stored values are rounded to bf16, the pool reads the f32 values
  const int n0 = nblk * BN;
  const long long plane = static_cast<long long>(H) * W;
  auto row_of = [&](int mt, int i) {
    return kSync ? warp * MT + mt : 8 * (warp / 4) + 2 * (warp % 4) + (i >> 1);
  };
  auto col_of = [&](int mt, int i) { return kSync ? g + 8 * (i >> 1) : 8 * mt + g; };
  auto bf16_bits = [](float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); };
  // conv2's outputs are staged in shared memory (the ring is free by then)
  // and written in 16-byte rows: the skip tile [BN][TH][TW] at a channel
  // stride of ECS elements, then the pool tile [BN][TH/2][TW/2] at PCS (the
  // pads put lanes t = 0..3 on distinct banks)
  constexpr int ECS = TH_ * TW_ + 8, PCS = TH_ * TW_ / 4 + 8;
  uint16_t* es = reinterpret_cast<uint16_t*>(smem);
  uint16_t* ps = es + BN * ECS;
  // the window (y, y + 1) x (xx, xx + 1) of the tile, y even: both rows in
  // this thread, the columns in lanes g and g ^ 1
  auto pool = [&](float top, float bot, int y, int xx, int n) {
    float v;
    if constexpr (M == kReluMaxPool) {
      // SAME pool: max over the in-image members only, which are >= 0 (ReLU)
      // where the members outside the image were set to 0
      v = fmaxf(top, bot);
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
    } else {
      // VALID pool: a written window lies inside the image
      v = top + bot;
      v = (v + __shfl_xor_sync(0xffffffffu, v, 4)) * 0.25f;
    }
    if (!(g & 1)) ps[n * PCS + (y / 2) * (TW_ / 2) + xx / 2] = bf16_bits(v);
  };
  if constexpr (kPool) __syncthreads();  // every warp's MMAs have read the ring
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + nt * 8 + 2 * t;  // this thread's channels n, n + 1 of the tile
    const float b0 = __ldg(bias + n), b1 = __ldg(bias + n + 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = activate<M>(acc[mt][4 * nt + i] + (i & 1 ? b1 : b0));
        if constexpr (M == kReluMaxPool) {
          if (!(ty0 + row_of(mt, i) < H && tx0 + col_of(mt, i) < W)) v = 0.0f;
        }
        acc[mt][4 * nt + i] = v;
      }
    }
    if constexpr (!kPool) {
      // mid, channel-blocked: channels n, n + 1 of a pixel as one word, lanes
      // t = 0..3 one pixel's 16 bytes
      uint16_t* ob = out + ((static_cast<long long>(b) * (F / 8) + n0 / 8 + nt) * plane) * 8 + 2 * t;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < 4; i += 2) {
          const int y = ty0 + row_of(mt, i), xx = tx0 + col_of(mt, i);
          if (y < H && xx < W) {
            *reinterpret_cast<uint32_t*>(ob + (static_cast<long long>(y) * W + xx) * 8) =
                pack_bf16(bf16_bits(acc[mt][4 * nt + i]), bf16_bits(acc[mt][4 * nt + i + 1]));
          }
        }
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          es[(nt * 8 + 2 * t + (i & 1)) * ECS + row_of(mt, i) * TW_ + col_of(mt, i)] =
              bf16_bits(acc[mt][4 * nt + i]);
        }
      }
      if constexpr (kSync) {
#pragma unroll
        for (int mt = 0; mt < MT; mt += 2)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pool(acc[mt][4 * nt + i], acc[mt + 1][4 * nt + i], row_of(mt, i), col_of(mt, i),
                 nt * 8 + 2 * t + (i & 1));
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            pool(acc[mt][4 * nt + e], acc[mt][4 * nt + 2 + e], row_of(mt, e), col_of(mt, e),
                 nt * 8 + 2 * t + e);
      }
    }
  }
  if constexpr (kPool) {
    // 8 columns (16 bytes) of a channel's tile row a thread, consecutive
    // threads along a channel's rows; 16-byte stores where the rows are
    // 16-byte aligned
    __syncthreads();
    auto copy_rows = [&](const uint16_t* tile, int stride, int rows, int cols, uint16_t* dst0,
                         int h, int w, int y0, int x0) {
      const bool vec = w % 8 == 0;
      const int pieces = cols / 8;  // 16-byte pieces of a tile row
      for (int k = tid; k < BN * rows * pieces; k += kThreads) {
        const int piece = k % pieces, row = (k / pieces) % rows, n = k / (pieces * rows);
        const int y = y0 + row, x = x0 + 8 * piece;
        if (y >= h || x >= w) continue;
        const uint16_t* src = tile + n * stride + row * cols + 8 * piece;
        uint16_t* dst = dst0 + (static_cast<long long>(n) * h + y) * w + x;
        if (vec) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && x + e < w; ++e) dst[e] = src[e];
        }
      }
    };
    static_assert(TW_ % 16 == 0, "skip rows of 16-byte pieces, pool rows of 8 columns or more");
    copy_rows(es, ECS, TH_, TW_, out + (static_cast<long long>(b) * F + n0) * plane, H, W, ty0,
              tx0);
    copy_rows(ps, PCS, TH_ / 2, TW_ / 2, pooled + (static_cast<long long>(b) * F + n0) * PH * PW,
              PH, PW, ty0 / 2, tx0 / 2);
  }
}

// ------------------------------------------------------------ launches ----

template <Mode M>
void pool_shape(int H, int W, int& PH, int& PW) {
  PH = PW = 0;
  if (M == kLeakyAvgPool) {
    PH = H / 2;
    PW = W / 2;
  } else if (M == kReluMaxPool) {
    PH = (H + 1) / 2;
    PW = (W + 1) / 2;
  }
}

template <int KS, int BN, Mode M>
int launch(const void* x, const void* wpk, const float* bias, void* out, void* pooled, int B,
           int C, int F, int H, int W, int cc, int kc_pad, cudaStream_t stream) {
  const Plan plan = make_plan<KS, BN>(C, cc, kc_pad);
  if (plan.smem_bytes > static_cast<size_t>(kMaxSmemBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = conv_gemm_kernel<KS, BN, M>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(plan.smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int PH, PW;
  pool_shape<M>(H, W, PH, PW);
  const int tiles_x = shdr_ceil_div(W, TW);
  const dim3 grid(tiles_x * shdr_ceil_div(H, TH), F / BN, B);
  kernel<<<grid, kThreads, plan.smem_bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const uint4*>(wpk), bias, static_cast<float*>(out),
      static_cast<float*>(pooled), C, F, H, W, PH, PW, cc, kc_pad, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

template <int KS, int BN, Mode M, int P>
int launch_bf16(const void* x, const void* wpk, const float* bias, void* out, void* pooled, int B,
                int C, int F, int H, int W, cudaStream_t stream) {
  const int chunks = P == 2 ? (C + 15) / 16 : 1;
  size_t smem =
      static_cast<size_t>(chunks < kRingBf16 ? chunks : kRingBf16) * slot_bytes_bf16<KS, BN, P>();
  constexpr int kTile = tile_rows_bf16<BN>() * kTileColsBf16;
  const size_t epi = static_cast<size_t>(BN) * ((kTile + 8) + (kTile / 4 + 8)) * 2;  // skip + pool
  if (pools<M>() && smem < epi) smem = epi;
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv_gemm_bf16_kernel<KS, BN, M, P>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int PH, PW;
  pool_shape<M>(H, W, PH, PW);
  const int tiles_x = shdr_ceil_div(W, kTileColsBf16);
  const dim3 grid(tiles_x * shdr_ceil_div(H, tile_rows_bf16<BN>()), F / BN, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint4*>(wpk), bias,
      static_cast<uint16_t*>(out), static_cast<uint16_t*>(pooled), C, F, H, W, PH, PW, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

// One (ks, bn, planes) of a mode: f32 ignores the planes; bf16 stages one
// plane (pixel pairs) only for conv1 (store modes).
template <bool kBf16, int KS, int BN, Mode M>
int launch_one(int planes, const void* x, const void* wpk, const float* bias, void* out,
               void* pooled, int B, int C, int F, int H, int W, int cc, int kc_pad,
               cudaStream_t stream) {
  if constexpr (!kBf16) {
    return launch<KS, BN, M>(x, wpk, bias, out, pooled, B, C, F, H, W, cc, kc_pad, stream);
  } else {
    if (planes == 2) {
      return launch_bf16<KS, BN, M, 2>(x, wpk, bias, out, pooled, B, C, F, H, W, stream);
    }
    if constexpr (!pools<M>()) {
      if (planes == 1) {
        return launch_bf16<KS, BN, M, 1>(x, wpk, bias, out, pooled, B, C, F, H, W, stream);
      }
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kBf16, int KS, Mode M>
int launch_bn(int bn, int planes, const void* x, const void* wpk, const float* bias, void* out,
              void* pooled, int B, int C, int F, int H, int W, int cc, int kc_pad,
              cudaStream_t stream) {
  switch (bn) {
    case 16:
      return launch_one<kBf16, KS, 16, M>(planes, x, wpk, bias, out, pooled, B, C, F, H, W, cc,
                                          kc_pad, stream);
    case 32:
      return launch_one<kBf16, KS, 32, M>(planes, x, wpk, bias, out, pooled, B, C, F, H, W, cc,
                                          kc_pad, stream);
    case 64:
      return launch_one<kBf16, KS, 64, M>(planes, x, wpk, bias, out, pooled, B, C, F, H, W, cc,
                                          kc_pad, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kBf16, Mode M>
int launch_ks(int ks, int bn, int planes, const void* x, const void* wpk, const float* bias,
              void* out, void* pooled, int B, int C, int F, int H, int W, int cc, int kc_pad,
              cudaStream_t stream) {
  switch (ks) {
    case 3:
      return launch_bn<kBf16, 3, M>(bn, planes, x, wpk, bias, out, pooled, B, C, F, H, W, cc,
                                    kc_pad, stream);
    case 5:
      if constexpr (M == kLeakyStore || M == kLeakyAvgPool) {
        return launch_bn<kBf16, 5, M>(bn, planes, x, wpk, bias, out, pooled, B, C, F, H, W, cc,
                                      kc_pad, stream);
      }
      break;
    case 7:
      if constexpr (M == kLeakyStore || M == kLeakyAvgPool) {
        return launch_bn<kBf16, 7, M>(bn, planes, x, wpk, bias, out, pooled, B, C, F, H, W, cc,
                                      kc_pad, stream);
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
  if (B <= 0 || H <= 0 || W <= 0 || cc <= 0 || F % bn != 0 || B > 65535 || F / bn > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int planes = 0;
  if constexpr (kBf16) {
    // 16 channels a chunk (C a multiple of it, or one chunk), or 4 (one
    // chunk of pixel-pair rows); K in the chunk's k-steps of 16; conv2 reads
    // 16-channel chunks of the blocked mid
    const bool pool = mode == kLeakyAvgPool || mode == kReluMaxPool;
    planes = cc == 16 ? 2 : 1;
    if ((cc != 4 && cc != 16) || (C % cc != 0 && C > cc) || kc_pad != 16 * ksteps_bf16(ks, planes) ||
        F % 8 != 0 || (pool && (cc != 16 || C % 16 != 0))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (C % cc != 0 || kc_pad % 8 != 0 || kc_pad < cc * ks * ks || kc_pad >= cc * ks * ks + 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kLeakyStore:
      return launch_ks<kBf16, kLeakyStore>(ks, bn, planes, x, wpk, bias, out, pooled, B, C, F, H,
                                           W, cc, kc_pad, s);
    case kLeakyAvgPool:
      return launch_ks<kBf16, kLeakyAvgPool>(ks, bn, planes, x, wpk, bias, out, pooled, B, C, F,
                                             H, W, cc, kc_pad, s);
    case kReluStore:
      return launch_ks<kBf16, kReluStore>(ks, bn, planes, x, wpk, bias, out, pooled, B, C, F, H,
                                          W, cc, kc_pad, s);
    case kReluMaxPool:
      return launch_ks<kBf16, kReluMaxPool>(ks, bn, planes, x, wpk, bias, out, pooled, B, C, F,
                                            H, W, cc, kc_pad, s);
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

// The same conv in bf16: x, wpk, out and pooled bf16, bias f32; the store
// modes (conv1) write `out` channel-blocked and the pool modes (conv2) read
// `x` channel-blocked, [B, C/8, H, W, 8].
SHDR_API int shdr_conv_gemm_bf16(int ks, int mode, const void* x, const void* wpk,
                                 const float* bias, void* out, void* pooled, int B, int C, int F,
                                 int H, int W, int bn, int cc, int kc_pad, void* stream) {
  return launch_mode<true>(ks, mode, x, wpk, bias, out, pooled, B, C, F, H, W, bn, cc, kc_pad,
                           stream);
}
