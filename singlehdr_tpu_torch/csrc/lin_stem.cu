// K3: Linearization-Net front end, the 93-channel feature stack and the
// 7x7 stride-2 stem in one pass:
//
//   out = relu(conv7x7/2_SAME(features93(x)) + bias)      (BN folded by caller)
//
// Replaces lin_feature_stem in singlehdr_tpu/ops/pallas/lin_stem_pallas.py.
// As there, the 93-channel stack (image 3 | Sobel dy/dx color-major 6 |
// soft histograms at 4/8/16 bins, bin-major 84) never reaches device memory:
// a block builds the features of its stride-2 receptive field in shared
// memory, a chunk of channels at a time, and runs the stem over them.  Device
// traffic is the 3-channel input, the 64-channel output and the packed
// weights (read from L2 by every block).
//
// Border semantics are handled in the kernel, so the TPU wrapper's border
// ring recompute is not needed:
//   * Sobel REFLECT-pads the image (index -1 -> 1, H -> H-2), per axis;
//   * the stack is zero-padded AS FEATURES for the conv: a tap outside the
//     image contributes 0 (a zero pixel would have nonzero histograms);
//   * SAME padding at stride 2 is asymmetric (2 low / 3 high on an even
//     extent); the wrapper passes the low pads.
//
// What bounds it: the stem's 49 * 93 * 64 multiply-adds an output pixel.  A
// block owns a 16 x 16 output tile of one image: M = 256 pixels, N = 64
// channels, K = 96 * 49 (93 channels padded to 96 with zero weights).
//
// f32 (lin_stem_kernel): in f32 on the CUDA cores the stem is capped at 67
// TFLOP/s; the kernel runs it as an implicit GEMM on the tensor cores in
// 3xTF32 (tf32_mma.cuh), capped at 165 TFLOP/s, K in 12 chunks of 8 channels.
// Per chunk:
//   * the block builds the chunk's features over the tile's 37 x 37
//     receptive field and splits each ONCE into TF32 hi and lo planes, stored
//     by column parity (ops/cuda/lin_stem_cuda.py documents the layout), so
//     that a stride-2 tap of 8 neighbouring output columns reads 8
//     neighbouring words; the channel stride (1416 = 8 mod 32 floats) puts
//     the 4 channels of an A-fragment load on distinct banks;
//   * K runs in 49 k-steps, one tap (ky, kx) x the chunk's 8 channels each.
//     The 8 warps (2 warpgroups) each own 2 output rows; a warpgroup issues
//     wgmma.mma_async m64n64k8 tf32 for its two m64 row blocks, A gathered
//     from the feature planes into registers, B from shared memory by
//     descriptor, 3 products a block (lo*hi + hi*lo + hi*hi), each k-step's
//     A loads overlapping the MMAs of the two k-steps in flight;
//   * B (the BN-folded weights, split and packed once by the wrapper as
//     wgmma's K-major core matrices) cannot sit beside the features whole
//     (196 KB a chunk), so it streams through a 4-slot cp.async ring, one
//     kernel row (7 k-steps, 28 KB) a slot, two slots ahead.
// The epilogue adds the bias, applies ReLU and stores NCHW, masked at the
// ragged edge.  The index maps are simulated in numpy by
// tests/test_torch_lin_stem_gemm.py.
//
// bf16 (lin_stem_bf16_kernel; the JAX package's compute dtype: x, the folded
// kernel and the output bf16, the bias f32): one bf16 product a multiply-add,
// accumulated in f32 (989 TFLOP/s dense), K in 6 chunks of 16 channels, a
// k-step one tap x 16 channels.  Each feature is computed in f32 from the
// bf16 image and rounded to bf16 once.  The block is warp-specialised:
//   * two producer warpgroups build chunk j + 1's features into one of two
//     buffers while two consumer warpgroups run chunk j's 49 k-steps.  A
//     buffer holds a 16-byte row of 8 channels a receptive-field position
//     and 8-channel group (channel-inner, column-parity split as in f32), so
//     the 8 output columns of one tap are 8 neighbouring rows: one core
//     matrix.  wgmma reads the features through shared-memory descriptors
//     (lead: the next 8-channel group; stride: two receptive rows, one
//     output row), nothing passes through registers.  A producer thread
//     writes a position's 16 channels as two 16-byte stores, zeros outside
//     the image on every chunk, then fences the stores for the async proxy
//     and arrives on the buffer's mbarrier;
//   * the GEMM runs with the 64 output channels as M (the packed weights'
//     core matrices are the A operand) and a consumer warpgroup's 16 output
//     rows x 8 columns as N = 128 (wgmma m64n128k16): a k-step reads 2 KB of
//     A and 4 KB of B for 262 k multiply-adds, where pixels as M (two
//     m64n64k16, A 8 x 8 pixels, B the weights) read 8 KB for as many; the
//     accumulators then hold pixel pairs neighbouring along W, stored 4 bytes
//     a store (tools/stem_variants.py measures the other orientation);
//   * B streams through a 4-slot ring, one kernel row (7 k-steps, 14 KB) a
//     slot, copied by one thread of a loader warp with cp.async.bulk, which
//     completes on the slot's mbarrier; consumers release a slot (and a
//     feature buffer) through mbarriers once the wgmma group that read it is
//     done.  No block-wide barrier after the barriers are set;
//   * one block an SM walks its tiles with the three roles' counts running
//     on, so the producers stage the next tile's image (each thread's loads
//     issued together) and build its first chunk while the consumers run the
//     last chunk and the epilogue of the tile before.
// The plan (shared memory, descriptor fields, roles) is mirrored by
// ops/cuda/lin_stem_cuda.py plan_bf16; the layout, the descriptors and a
// launch lane by lane are simulated in tests/test_torch_bf16.py.
#include <cstdint>
#include <utility>

#include "bf16_mma.cuh"
#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int TO = 16;                 // output tile: TO x TO pixels
constexpr int RY = 2 * TO + 5;         // receptive field extent (rows and cols), 37
constexpr int PWID = (RY + 1) / 2;     // entries of a column-parity plane row, 19
constexpr int ROW = 2 * PWID;          // entries of a feature row (both parities), 38
constexpr int CS = 1416;               // words between two f32 feature planes (>= RY * ROW)
constexpr int NF = 93;                 // feature channels
constexpr int OUT_F = 64;              // stem output channels
constexpr int TAPS = 49;               // k-steps a chunk
constexpr int IMG = RY + 2;            // raw image extent (+1 Sobel border a side)
constexpr int SLICE = 7;               // k-steps a ring slot: one kernel row
constexpr int kBuf = 4;                // f32 ring slots; slice s + 2 loads while s runs
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSets = 3;               // A register sets: 2 k-steps of MMAs in flight
constexpr int kChannels = 96;          // 93 padded to whole chunks (zero weights)
static_assert(CS >= RY * ROW && CS % 32 == 8, "feature plane stride");
static_assert(TAPS % SLICE == 0, "a slice is one kernel row");

// f32: 12 chunks of 8 channels, a chunk's features split into TF32 hi and lo
// planes of 8 channels each (16 planes), a k-step's B 4 KB (hi + lo)
constexpr int CC = 8;                            // channels a chunk (the MMA's k)
constexpr int PLANES = 2 * CC;                   // hi planes, then lo planes
constexpr int KSTEP_BYTES = 2 * OUT_F * CC * 4;
constexpr int CHUNKS = kChannels / CC;           // 12
constexpr int SLICE_BYTES = SLICE * KSTEP_BYTES;
// ring | feature planes | image | channel table [3][96], in 4-byte words
constexpr int kSmemWords = kBuf * SLICE_BYTES / 4 + PLANES * CS + 3 * IMG * IMG + 3 * kChannels;

__device__ __forceinline__ int reflect_clamp(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

// feature ch (< 9: the image or a Sobel edge) of the pixel whose 3x3
// neighbourhood centres at img_s[.][a][b]; the histogram channels take the
// channel table (below)
__device__ __forceinline__ float feature(const float* img_s, int ch, int a, int b) {
  const int plane = IMG * IMG;
  if (ch < 3) return img_s[ch * plane + a * IMG + b];
  if (ch < 9) {
    const int k = ch - 3;
    const float* p = img_s + (k >> 1) * plane;
    if ((k & 1) == 0) {  // dy: [1,2,1] along W, difference along H
      const float* up = p + (a - 1) * IMG + b;
      const float* dn = p + (a + 1) * IMG + b;
      const float sd = (dn[-1] + 2.0f * dn[0]) + dn[1];
      const float su = (up[-1] + 2.0f * up[0]) + up[1];
      return sd - su;
    }
    // dx: [1,2,1] along H, difference along W
    const float* c = p + a * IMG + b;
    const float sr = (c[1 - IMG] + 2.0f * c[1]) + c[1 + IMG];
    const float sl = (c[-1 - IMG] + 2.0f * c[-1]) + c[-1 + IMG];
    return sr - sl;
  }
  return 0.0f;
}

// Channel table of the 96 padded channels: a soft-histogram channel ch
// (9 <= ch < 93, bin-major at 4, 8, 16 bins) is max(0, 1 - |x[color] -
// center| * nb); color -1 marks the image and Sobel channels, -2 the zero
// padding channels.
__device__ __forceinline__ void channel_entry(int ch, float& center, float& nbf, int& color) {
  center = 0.0f;
  nbf = 0.0f;
  color = ch < 9 ? -1 : -2;
  if (ch < 9 || ch >= NF) return;
  int j = ch - 9;
  int nb = 4;
  if (j >= 12) {
    j -= 12;
    nb = 8;
    if (j >= 24) {
      j -= 24;
      nb = 16;
    }
  }
  const int bin = j / 3;
  center = (2.0f * static_cast<float>(bin + 1) - 1.0f) / (2.0f * nb);
  nbf = static_cast<float>(nb);
  color = j % 3;
}

// one feature value (f32) of channel ch at a receptive-field position whose
// pixel values are p0..p2; 0 outside the image (the stack's zero padding)
__device__ __forceinline__ float feature_value(const float* img_s, const float* tab, int ch,
                                               bool inside, float p0, float p1, float p2,
                                               int ry, int rx) {
  const int color = __float_as_int(tab[2 * kChannels + ch]);  // uniform over the block
  if (!inside) return 0.0f;
  if (color >= 0) {
    const float d = fabsf((color == 0 ? p0 : color == 1 ? p1 : p2) - tab[ch]);
    return fmaxf(0.0f, 1.0f - d * tab[kChannels + ch]);
  }
  if (color == -1) return feature(img_s, ch, ry + 1, rx + 1);
  return 0.0f;
}

// x: [B, 3, H, W]; wpk: [CHUNKS][TAPS][hi, lo][8 (n8 group)][2 (k half)][8 n][4 k]
// (ops/cuda/lin_stem_cuda.py pack_stem_weights); bias: [64]; out: [B, 64, HO, WO]
__global__ void __launch_bounds__(kThreads, 1)
lin_stem_kernel(const float* __restrict__ x, const uint4* __restrict__ wpk,
                const float* __restrict__ bias, float* __restrict__ out,
                int H, int W, int HO, int WO, int pad_t, int pad_l, int tiles_x) {
  constexpr int SLICES = CHUNKS * TAPS / SLICE;

  extern __shared__ __align__(16) float smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem);  // [kBuf][SLICE_BYTES]
  // feature planes [PLANES][CS] words: row ry at ry * ROW, column rx at
  // (rx & 1) * PWID + rx / 2; hi planes of channels 0..7, then lo planes
  float* feat = smem + kBuf * SLICE_BYTES / 4;
  float* img_s = feat + PLANES * CS;    // [3][IMG][IMG]
  float* tab = img_s + 3 * IMG * IMG;  // [center | nb | color][96]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_x) * TO;
  const int ox0 = (blockIdx.x % tiles_x) * TO;
  const int ry0 = 2 * oy0 - pad_t;  // image row of receptive-field row 0
  const int rx0 = 2 * ox0 - pad_l;

  // slice s of the ring: k-steps 7 (s % 7) .. 7 (s % 7) + 6 of chunk s / 7,
  // contiguous in wpk; an empty group past the end keeps the counts uniform
  auto load_slice = [&](int s) {
    if (s < SLICES) {
      uint4* dst = reinterpret_cast<uint4*>(ring + (s % kBuf) * SLICE_BYTES);
      const uint4* src = wpk + static_cast<long long>(s) * (SLICE_BYTES / 16);
      for (int i = tid; i < SLICE_BYTES / 16; i += kThreads) cp_async16(dst + i, src + i);
    }
    cp_async_commit();
  };
  load_slice(0);
  load_slice(1);

  const float* xb = x + static_cast<long long>(b) * 3 * H * W;
  for (int i = tid; i < 3 * IMG * IMG; i += kThreads) {
    const int c = i / (IMG * IMG);
    const int r = i % (IMG * IMG);
    const int gy = reflect_clamp(ry0 - 1 + r / IMG, H);
    const int gx = reflect_clamp(rx0 - 1 + r % IMG, W);
    img_s[i] = xb[(static_cast<long long>(c) * H + gy) * W + gx];
  }
  for (int ch = tid; ch < kChannels; ch += kThreads) {
    int color;
    channel_entry(ch, tab[ch], tab[kChannels + ch], color);
    tab[2 * kChannels + ch] = __int_as_float(color);
  }

  // A rows of this lane: output row warp * 2 + mt, column g (+8); receptive
  // row 2 * (warp * 2 + mt) + ky, column 2 * column + kx.  k column t is
  // chunk channel t (plane t), k column t + 4 channel t + 4.
  int moff[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) moff[mt] = 2 * (warp * 2 + mt) * ROW + g;
  const int ch_t = t * CS, ch_t4 = (t + 4) * CS;

  // acc[mt][4 * nt + i]: pixel (row warp * 2 + mt, column g + 8 (i >> 1)),
  // channel 8 nt + 2 t + (i & 1)
  float acc[2][OUT_F / 2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < OUT_F / 2; ++i) acc[mt][i] = 0.0f;

  for (int j = 0; j < CHUNKS; ++j) {
    __syncthreads();  // the image is staged / the previous chunk's A loads are done
    // a thread builds all CC channels of its receptive-field positions: the
    // position's index math and its 3 pixel loads once, CC independent values
    for (int pos = tid; pos < RY * RY; pos += kThreads) {
      const int ry = pos / RY, rx = pos - ry * RY;
      const int gy = ry0 + ry, gx = rx0 + rx;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const int at = (ry + 1) * IMG + rx + 1;
      const float p0 = img_s[at], p1 = img_s[IMG * IMG + at], p2 = img_s[2 * IMG * IMG + at];
      const int off = ry * ROW + (rx & 1) * PWID + (rx >> 1);
#pragma unroll
      for (int cl = 0; cl < CC; ++cl) {
        const float v = feature_value(img_s, tab, j * CC + cl, inside, p0, p1, p2, ry, rx);
        uint32_t hi, lo;
        split_tf32(v, hi, lo);
        feat[cl * CS + off] = __uint_as_float(hi);
        feat[(CC + cl) * CS + off] = __uint_as_float(lo);
      }
    }
    // (the barrier at the chunk's first slice publishes the features)

    // kSets register sets of A fragments: k-step ks uses set ks % kSets, and
    // its loads overlap the MMAs of the kSets - 1 k-steps in flight
    uint32_t ah[kSets][2][4], al[kSets][2][4];
    for (int kk = 0; kk < TAPS; kk += kSets) {
#pragma unroll
      for (int u = 0; u < kSets; ++u) {
        const int ks = kk + u;
        if (ks < TAPS) {
          const int ky = ks / 7, kx = ks - 7 * ky;
          const int s = j * 7 + ky;
          if (kx == 0) {
            cp_async_wait<1>();  // slice s has landed (this thread's copies)
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // ... for wgmma
            __syncthreads();     // ... everyone's; slice s - 2's slot is free
            load_slice(s + 2);
          }
          const int off = ky * ROW + (kx & 1) * PWID + (kx >> 1);
          const unsigned char* wst = ring + (s % kBuf) * SLICE_BYTES + kx * KSTEP_BYTES;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int p0 = ch_t + moff[mt] + off, p1 = ch_t4 + moff[mt] + off;
            ah[u][mt][0] = __float_as_uint(feat[p0]);      // (row g,     k t)
            ah[u][mt][1] = __float_as_uint(feat[p0 + 8]);  // (row g + 8, k t)
            ah[u][mt][2] = __float_as_uint(feat[p1]);      // (row g,     k t+4)
            ah[u][mt][3] = __float_as_uint(feat[p1 + 8]);  // (row g + 8, k t+4)
            const float* lo = feat + CC * CS;
            al[u][mt][0] = __float_as_uint(lo[p0]);
            al[u][mt][1] = __float_as_uint(lo[p0 + 8]);
            al[u][mt][2] = __float_as_uint(lo[p1]);
            al[u][mt][3] = __float_as_uint(lo[p1 + 8]);
          }
          const uint64_t bh = b_desc(wst);
          const uint64_t bl = b_desc(wst + OUT_F * CC * 4);
          wgmma_fence();
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            wgmma_tf32<OUT_F>(acc[mt], al[u][mt], bh);
            wgmma_tf32<OUT_F>(acc[mt], ah[u][mt], bl);
            wgmma_tf32<OUT_F>(acc[mt], ah[u][mt], bh);
          }
          wgmma_commit();
          wgmma_wait<kSets - 1>();  // k-step ks + 1 - kSets is done: its set is free
        }
      }
    }
    wgmma_wait<0>();  // the features are read to the end before they are rebuilt
  }
  cp_async_wait<0>();

  float bv[OUT_F / 8][2];
#pragma unroll
  for (int nt = 0; nt < OUT_F / 8; ++nt) {
    bv[nt][0] = __ldg(bias + nt * 8 + 2 * t);
    bv[nt][1] = __ldg(bias + nt * 8 + 2 * t + 1);
  }
  float* ob = out + static_cast<long long>(b) * OUT_F * HO * WO;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int oy = oy0 + warp * 2 + mt;
#pragma unroll
    for (int nt = 0; nt < OUT_F / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ox = ox0 + g + 8 * (i >> 1);
        const int n = nt * 8 + 2 * t + (i & 1);
        if (oy < HO && ox < WO) {
          ob[(static_cast<long long>(n) * HO + oy) * WO + ox] =
              fmaxf(acc[mt][4 * nt + i] + bv[nt][i & 1], 0.0f);
        }
      }
    }
  }
}

// --------------------------------------------------------------- bf16 ----

constexpr int kChunksBf16 = 6;                          // chunks of 16 channels
constexpr int kKstepBytesBf16 = OUT_F * 16 * 2;         // a k-step's B: 2 KB
constexpr int kSliceBytesBf16 = SLICE * kKstepBytesBf16;  // a ring slot, one kernel row: 14 KB
constexpr int kSlicesBf16 = kChunksBf16 * TAPS / SLICE;   // 42
constexpr int kRingBf16 = 4;                            // B ring slots
constexpr int kGroupRows = RY * ROW;                    // 16-byte rows of an 8-channel group
constexpr int kGroupBytes = kGroupRows * 16;            // 22,496: the descriptors' lead
constexpr int kFeatBytes = 2 * kGroupBytes;             // a feature buffer, 16 channels
constexpr int kOutRowBytes = 2 * ROW * 16;              // two receptive rows: the stride
constexpr int kConsumerWarps = 8;                       // two warpgroups of wgmma
constexpr int kProducerWarps = 8;                       // two warpgroups build features
constexpr int kProducerThreads = 32 * kProducerWarps;
constexpr int kLoaderWarp = kConsumerWarps + kProducerWarps;  // one thread copies B
constexpr int kThreadsBf16 = 32 * (kLoaderWarp + 1);
// shared memory: B ring | two feature buffers | f32 image [3][IMG][IMG] |
// mbarriers (B full and empty a slot, features full and empty a buffer)
constexpr int kFeatOffsetBf16 = kRingBf16 * kSliceBytesBf16;
constexpr int kImgOffsetBf16 = kFeatOffsetBf16 + 2 * kFeatBytes;
constexpr int kBarOffsetBf16 = (kImgOffsetBf16 + 3 * IMG * IMG * 4 + 7) / 8 * 8;
constexpr int kSmemBf16 = kBarOffsetBf16 + 8 * (2 * kRingBf16 + 4);
static_assert(kFeatOffsetBf16 % 16 == 0 && kFeatBytes % 16 == 0, "16-byte core matrices");
static_assert(kBarOffsetBf16 % 8 == 0 && kSmemBf16 <= kMaxSmemBytes, "bf16 shared-memory plan");
static_assert(kImgOffsetBf16 < (1 << 18) && (kGroupBytes >> 4) < (1 << 14), "14-bit fields");

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from global to shared memory, completing on bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// A soft-histogram channel (9 <= ch < 93): max(0, 1 - |x[color] - center| * nb)
struct HistBin {
  int color;
  float center;
  float nb;
};
__host__ __device__ constexpr HistBin hist_bin(int ch) {
  int j = ch - 9, nb = 4;
  if (j >= 12) {
    j -= 12;
    nb = 8;
    if (j >= 24) {
      j -= 24;
      nb = 16;
    }
  }
  return {j % 3, (2.0f * static_cast<float>(j / 3 + 1) - 1.0f) / (2.0f * nb),
          static_cast<float>(nb)};
}

// feature CH (a compile-time channel, so the channel's kind, color, center
// and bin count fold into the code) of the position at image-tile entry
// (a, b), whose pixel values are p; f32, as the f32 kernel computes it
template <int CH>
__device__ __forceinline__ float feature_bf16(const float* img_s, const float (&p)[3], int a,
                                              int b) {
  if constexpr (CH < 3) {
    return p[CH];
  } else if constexpr (CH < 9) {
    return feature(img_s, CH, a, b);
  } else if constexpr (CH < NF) {
    constexpr HistBin h = hist_bin(CH);
    return fmaxf(0.0f, 1.0f - fabsf(p[h.color] - h.center) * h.nb);
  } else {
    return 0.0f;
  }
}

// the 8 words (channel pairs 16 J + 2 Q, + 1) of one position, each feature
// rounded to bf16 once
template <int J, int... Q>
__device__ __forceinline__ void chunk_words(uint32_t (&w)[8], const float* img_s,
                                            const float (&p)[3], int a, int b,
                                            std::integer_sequence<int, Q...>) {
  ((w[Q] = pack_bf16(bf16_bits(feature_bf16<16 * J + 2 * Q>(img_s, p, a, b)),
                     bf16_bits(feature_bf16<16 * J + 2 * Q + 1>(img_s, p, a, b)))),
   ...);
}

// The producers' part of chunk J: the buffer's 16-byte row e of
// group 0 (channels 16 J .. 16 J + 7) and of group 1 (+ 8 .. + 15) is
// receptive row e / ROW, column-parity entry e % ROW (column 2 e' for the
// even entries e' < PWID, 2 (e' - PWID) + 1 for the odd ones).  Consecutive
// threads write consecutive rows; a position outside the image (and the odd
// plane's unused last entry) is written as zeros.
template <int J>
__device__ __forceinline__ void build_chunk_bf16(uint4* buf, const float* img_s, int ptid,
                                                 int ry0, int rx0, int H, int W) {
  for (int e = ptid; e < kGroupRows; e += kProducerThreads) {
    const int ry = e / ROW, idx = e - ry * ROW;
    const int rx = idx < PWID ? 2 * idx : 2 * (idx - PWID) + 1;
    const int gy = ry0 + ry, gx = rx0 + rx;
    uint32_t w[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    if (rx < RY && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int a = ry + 1, b = rx + 1, at = a * IMG + b;
      const float p[3] = {img_s[at], img_s[IMG * IMG + at], img_s[2 * IMG * IMG + at]};
      chunk_words<J>(w, img_s, p, a, b, std::make_integer_sequence<int, 8>{});
    }
    buf[e] = make_uint4(w[0], w[1], w[2], w[3]);
    buf[kGroupRows + e] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// The f32 image tile of a receptive field at image row ry0 - 1, column
// rx0 - 1 (REFLECT-clamped), by kThreadsStage threads: each thread's loads in
// a batch are all issued before its stores.
template <int kThreadsStage>
__device__ __forceinline__ void stage_image(float* img_s, const uint16_t* xb, int tid, int ry0,
                                            int rx0, int H, int W) {
  constexpr int kCount = 3 * IMG * IMG, kPer = (kCount + kThreadsStage - 1) / kThreadsStage;
  constexpr int kBatch = 12;
  for (int k0 = 0; k0 < kPer; k0 += kBatch) {
    uint16_t v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = tid + (k0 + k) * kThreadsStage;
      const int c = i / (IMG * IMG), r = i % (IMG * IMG);
      const int gy = reflect_clamp(ry0 - 1 + r / IMG, H);
      const int gx = reflect_clamp(rx0 - 1 + r % IMG, W);
      v[k] = i < kCount ? xb[(static_cast<long long>(c) * H + gy) * W + gx] : 0;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = tid + (k0 + k) * kThreadsStage;
      if (i < kCount) img_s[i] = __bfloat162float(__ushort_as_bfloat16(v[k]));
    }
  }
}

// x: [B, 3, H, W]; wpk: [6 chunks][TAPS][8 (n8 group)][2 (k half)][8 n][8 k]
// (pack_stem_weights); bias: [64] f32; out: [B, 64, HO, WO]; x, wpk and out
// bf16 bit patterns.  Warps 0-7 consume (two warpgroups), 8-15 produce the
// features (two warpgroups), lane 0 of warp 16 copies B.  A block walks the
// tiles blockIdx.x, + gridDim.x, ... of all images (tiles_x x tiles_y an
// image); the slice and chunk counts run on across its tiles, so the
// producers stage the next tile's image and build its first chunk while the
// consumers finish the tile before it.
__global__ void __launch_bounds__(kThreadsBf16, 1)
lin_stem_bf16_kernel(const uint16_t* __restrict__ x, const uint4* __restrict__ wpk,
                     const float* __restrict__ bias, uint16_t* __restrict__ out, int H, int W,
                     int HO, int WO, int pad_t, int pad_l, int tiles_x, int tiles_y, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem_bf16[];  // (smem is the f32 kernel's)
  float* img_s = reinterpret_cast<float*>(smem_bf16 + kImgOffsetBf16);
  const uint32_t smem0 = smem_addr(smem_bf16);
  const uint32_t full_b = smem0 + kBarOffsetBf16;  // [kRingBf16]: the slot's copy landed
  const uint32_t empty_b = full_b + 8 * kRingBf16;  // [kRingBf16]: its 8 consumer warps read it
  const uint32_t full_f = empty_b + 8 * kRingBf16;  // [2]: the buffer's producers wrote it
  const uint32_t empty_f = full_f + 16;             // [2]: its 8 consumer warps read it

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // tile -> image b, output origin (oy0, ox0), receptive-field origin (ry0, rx0)
  auto origin = [&](int tile, int& b, int& oy0, int& ox0) {
    b = tile / (tiles_x * tiles_y);
    const int r = tile - b * tiles_x * tiles_y;
    oy0 = (r / tiles_x) * TO;
    ox0 = (r % tiles_x) * TO;
  };

  if (tid == 0) {
    for (int i = 0; i < kRingBf16; ++i) {
      mbar_init(full_b + 8 * i, 1);
      mbar_init(empty_b + 8 * i, kConsumerWarps);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(full_f + 8 * i, kProducerThreads);
      mbar_init(empty_f + 8 * i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are set; roles from here on

  if (warp < kConsumerWarps) {
    const int cw = warp >> 2, wq = warp & 3;  // consumer warpgroup, warp within it
    const int g = lane >> 2, t = lane & 3;
    // row q (kernel row q % 7 of chunk q / 7) is read: its slot, and after a
    // chunk's last row its buffer, are free (lane 0 of each consumer warp)
    auto release = [&](int q) {
      mbar_arrive(empty_b + 8 * (q % kRingBf16));
      if (q % SLICE == SLICE - 1) mbar_arrive(empty_f + 8 * ((q / SLICE) & 1));
    };
    int q = 0;  // kernel rows (ring slices) this block has consumed
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int b, oy0, ox0;
      origin(tile, b, oy0, ox0);
      // acc[4 r + i]: channel 16 wq + g + 8 (i >> 1), output row r, column
      // 8 cw + 2t + (i & 1) (wgmma's D fragment: M the channels, N the pixels)
      float acc[OUT_F] = {};
      for (int s = 0; s < kSlicesBf16; ++s, ++q) {  // kernel row ky of chunk j
        const int j = q / SLICE, ky = q - SLICE * j;
        if (ky == 0) mbar_wait(full_f + 8 * (j & 1), (j >> 1) & 1);
        mbar_wait(full_b + 8 * (q % kRingBf16), (q / kRingBf16) & 1);
        const uint32_t wst = smem0 + (q % kRingBf16) * kSliceBytesBf16;
        const uint32_t fst = smem0 + kFeatOffsetBf16 + (j & 1) * kFeatBytes;
        wgmma_fence();
#pragma unroll
        for (int kx = 0; kx < SLICE; ++kx) {
          // the weights' core matrices: 8 channels x 8 k, k halves 128 B apart,
          // channel groups 256 B
          const uint64_t wd = smem_desc(wst + kx * kKstepBytesBf16, kLeadBytes, kStrideBytes);
          const int col = (kx & 1) * PWID + (kx >> 1);  // parity entry of output column 0
          const uint32_t f = fst + (ky * ROW + col + 8 * cw) * 16;
          wgmma_bf16_ss<2 * OUT_F>(acc, wd, smem_desc(f, kGroupBytes, kOutRowBytes));
        }
        wgmma_commit();
        wgmma_wait<1>();  // the row before this one is read
        if (s > 0 && lane == 0) release(q - 1);
      }
      wgmma_wait<0>();
      if (lane == 0) release(q - 1);  // the tile's last row

      // two neighbouring columns a store, 4 bytes where the rows are even
      uint16_t* ob = out + static_cast<long long>(b) * OUT_F * HO * WO;
      const int ox = ox0 + 8 * cw + 2 * t;
      const bool pairs = (WO & 1) == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 16 * wq + g + 8 * h;
        const float bv = __ldg(bias + n);
        uint16_t* on = ob + static_cast<long long>(n) * HO * WO;
#pragma unroll
        for (int r = 0; r < TO; ++r) {
          const int oy = oy0 + r;
          if (oy < HO && ox < WO) {
            const uint16_t v0 = bf16_bits(fmaxf(acc[4 * r + 2 * h] + bv, 0.0f));
            const uint16_t v1 = bf16_bits(fmaxf(acc[4 * r + 2 * h + 1] + bv, 0.0f));
            uint16_t* dst = on + static_cast<long long>(oy) * WO + ox;
            if (pairs) {
              *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
            } else {
              dst[0] = v0;
              if (ox + 1 < WO) dst[1] = v1;
            }
          }
        }
      }
    }
  } else if (warp < kLoaderWarp) {
    const int ptid = tid - 32 * kConsumerWarps;
    int j = 0;  // chunks this block has built
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int b, oy0, ox0;
      origin(tile, b, oy0, ox0);
      const int ry0 = 2 * oy0 - pad_t, rx0 = 2 * ox0 - pad_l;  // image origin of the field
      // the producers are done with the last tile's image, then this one is staged
      asm volatile("bar.sync 1, %0;\n" ::"n"(kProducerThreads) : "memory");
      stage_image<kProducerThreads>(img_s, x + static_cast<long long>(b) * 3 * H * W, ptid, ry0,
                                    rx0, H, W);
      asm volatile("bar.sync 1, %0;\n" ::"n"(kProducerThreads) : "memory");
      for (int c = 0; c < kChunksBf16; ++c, ++j) {
        if (j >= 2) mbar_wait(empty_f + 8 * (j & 1), ((j >> 1) - 1) & 1);  // chunk j - 2 is read
        uint4* buf = reinterpret_cast<uint4*>(smem_bf16 + kFeatOffsetBf16 + (j & 1) * kFeatBytes);
        switch (c) {
          case 0: build_chunk_bf16<0>(buf, img_s, ptid, ry0, rx0, H, W); break;
          case 1: build_chunk_bf16<1>(buf, img_s, ptid, ry0, rx0, H, W); break;
          case 2: build_chunk_bf16<2>(buf, img_s, ptid, ry0, rx0, H, W); break;
          case 3: build_chunk_bf16<3>(buf, img_s, ptid, ry0, rx0, H, W); break;
          case 4: build_chunk_bf16<4>(buf, img_s, ptid, ry0, rx0, H, W); break;
          default: build_chunk_bf16<5>(buf, img_s, ptid, ry0, rx0, H, W); break;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the stores, for wgmma
        mbar_arrive(full_f + 8 * (j & 1));
      }
    }
  } else if (lane == 0) {
    // slice s (kernel row s % 7 of chunk s / 7) is contiguous in wpk
    int q = 0;  // slices this block has copied
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      for (int s = 0; s < kSlicesBf16; ++s, ++q) {
        const int slot = q % kRingBf16;
        if (q >= kRingBf16) mbar_wait(empty_b + 8 * slot, (q / kRingBf16 - 1) & 1);
        const uint4* src = wpk + static_cast<long long>(s) * (kSliceBytesBf16 / 16);
        mbar_arrive_expect_tx(full_b + 8 * slot, kSliceBytesBf16);
        bulk_copy(smem0 + slot * kSliceBytesBf16, src, kSliceBytesBf16, full_b + 8 * slot);
      }
    }
  }
}

int launch_stem_f32(const float* x, const float* wpk, const float* bias, float* out, int B, int H,
                    int W, int HO, int WO, int pad_t, int pad_l, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * kSmemWords;
  const cudaError_t err = cudaFuncSetAttribute(
      lin_stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = shdr_ceil_div(WO, TO);
  const dim3 grid(tiles_x * shdr_ceil_div(HO, TO), B);
  lin_stem_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, reinterpret_cast<const uint4*>(wpk), bias, out, H, W, HO, WO, pad_t, pad_l, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

int launch_stem_bf16(const void* x, const void* wpk, const float* bias, void* out, int B, int H,
                     int W, int HO, int WO, int pad_t, int pad_l, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lin_stem_bf16_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBf16);
  int device, sms;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = shdr_ceil_div(WO, TO), tiles_y = shdr_ceil_div(HO, TO);
  const long long n_tiles = static_cast<long long>(B) * tiles_x * tiles_y;
  if (n_tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = n_tiles < sms ? static_cast<int>(n_tiles) : sms;  // one block an SM
  kernel<<<grid, kThreadsBf16, kSmemBf16, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint4*>(wpk), bias,
      static_cast<uint16_t*>(out), H, W, HO, WO, pad_t, pad_l, tiles_x, tiles_y,
      static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

SHDR_API int shdr_lin_stem_f32(const float* x, const float* wpk, const float* bias,
                               float* out, int B, int H, int W, int HO, int WO,
                               int pad_t, int pad_l, void* stream) {
  return launch_stem_f32(x, wpk, bias, out, B, H, W, HO, WO, pad_t, pad_l, stream);
}

// The same stem in bf16: x, wpk and out bf16, bias f32.
SHDR_API int shdr_lin_stem_bf16(const void* x, const void* wpk, const float* bias, void* out,
                                int B, int H, int W, int HO, int WO, int pad_t, int pad_l,
                                void* stream) {
  return launch_stem_bf16(x, wpk, bias, out, B, H, W, HO, WO, pad_t, pad_l, stream);
}
