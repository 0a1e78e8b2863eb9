// K3: Linearization-Net front end, the 93-channel feature stack and the
// 7x7 stride-2 stem in one pass:
//
//   out = relu(conv7x7/2_SAME(features93(x)) + bias)      (BN folded by caller)
//
// Replaces lin_feature_stem in singlehdr_tpu/ops/pallas/lin_stem_pallas.py.
// As there, the 93-channel stack (image 3 | Sobel dy/dx color-major 6 |
// soft histograms at 4/8/16 bins, bin-major 84) never reaches device memory:
// a block builds the features of its stride-2 receptive field in shared
// memory, 8 channels at a time, and runs the stem over them.  Device traffic
// is the 3-channel input, the 64-channel output and the packed weights (read
// from L2 by every block).
//
// Border semantics are handled in the kernel, so the TPU wrapper's border
// ring recompute is not needed:
//   * Sobel REFLECT-pads the image (index -1 -> 1, H -> H-2), per axis;
//   * the stack is zero-padded AS FEATURES for the conv: a tap outside the
//     image contributes 0 (a zero pixel would have nonzero histograms);
//   * SAME padding at stride 2 is asymmetric (2 low / 3 high on an even
//     extent); the wrapper passes the low pads.
//
// What bounds it: the stem's 49 * 93 * 64 multiply-adds an output pixel.  In
// f32 on the CUDA cores that caps it at 67 TFLOP/s; this kernel runs the conv
// as an implicit GEMM on the tensor cores in 3xTF32 (tf32_mma.cuh), capped at
// 165 TFLOP/s.  A block owns a 16 x 16 output tile of one image: M = 256
// pixels, N = 64 channels, K = 96 * 49 (93 channels padded to 96 with zero
// weights), walked in 12 chunks of 8 channels.  Per chunk:
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
// bf16 (the JAX package's compute dtype; x, the folded kernel and the output
// bf16, the bias f32): the same GEMM on wgmma.mma_async m64n64k16 bf16, one
// MMA a product, accumulated in f32 (989 TFLOP/s dense).  A k-step is one tap
// x 16 channels, so a chunk is 16 channels (6 chunks, 49 k-steps each) and an
// A register (k 2t, 2t+1) is two neighbouring channels of one feature: each
// feature is built in f32 from the bf16 image and rounded to bf16 once, and
// channel pairs share a 4-byte word, stored in 8 pair planes with the f32
// design's word layout and stride (one 32-bit load a register, no split).
// The feature planes take 45 KB, half the f32 hi/lo planes; B streams
// through the same 4-slot ring, 14 KB a kernel row.  The bf16 packing and
// the pair planes are simulated in tests/test_torch_bf16.py.
#include <cstdint>

#include "bf16_mma.cuh"
#include "common.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int TO = 16;                 // output tile: TO x TO pixels
constexpr int RY = 2 * TO + 5;         // receptive field extent (rows and cols), 37
constexpr int PWID = (RY + 1) / 2;     // entries of a column-parity plane row, 19
constexpr int ROW = 2 * PWID;          // words of a feature row (both parities), 38
constexpr int CS = 1416;               // words between two feature planes (>= RY * ROW)
constexpr int NF = 93;                 // feature channels
constexpr int OUT_F = 64;              // stem output channels (the MMA's n)
constexpr int TAPS = 49;               // k-steps a chunk
constexpr int IMG = RY + 2;            // raw image extent (+1 Sobel border a side)
constexpr int SLICE = 7;               // k-steps a ring slot: one kernel row
constexpr int kBuf = 4;                // ring slots; slice s + 2 loads while s runs
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSets = 3;               // A register sets: 2 k-steps of MMAs in flight
constexpr int kChannels = 96;          // 93 padded to whole chunks (zero weights)
static_assert(CS >= RY * ROW && CS % 32 == 8, "feature plane stride");
static_assert(TAPS % SLICE == 0, "a slice is one kernel row");

// The plan of either dtype.  f32: 12 chunks of 8 channels, a chunk's features
// split into TF32 hi and lo planes of 8 channels each (16 planes), a k-step's
// B 4 KB (hi + lo).  bf16: 6 chunks of 16 channels, 8 planes of channel pairs
// (one bf16x2 word an entry), a k-step's B 2 KB.
template <bool kBf16>
struct StemPlan {
  using T = float;
  static constexpr int CC = 8;                       // channels a chunk (the MMA's k)
  static constexpr int PLANES = 2 * CC;              // hi planes, then lo planes
  static constexpr int KSTEP_BYTES = 2 * OUT_F * CC * 4;
};
template <>
struct StemPlan<true> {
  using T = uint16_t;
  static constexpr int CC = 16;
  static constexpr int PLANES = CC / 2;              // channel pairs
  static constexpr int KSTEP_BYTES = OUT_F * CC * 2;
};

template <bool kBf16>
__host__ __device__ constexpr int chunks() { return kChannels / StemPlan<kBf16>::CC; }  // 12 | 6
template <bool kBf16>
__host__ __device__ constexpr int slice_bytes() { return SLICE * StemPlan<kBf16>::KSTEP_BYTES; }
// ring | feature planes | image | channel table [3][96], in 4-byte words
template <bool kBf16>
__host__ __device__ constexpr int smem_words() {
  return kBuf * slice_bytes<kBf16>() / 4 + StemPlan<kBf16>::PLANES * CS + 3 * IMG * IMG +
         3 * kChannels;
}

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

template <bool kBf16>
__device__ __forceinline__ float load_pixel(const typename StemPlan<kBf16>::T* p) {
  if constexpr (kBf16) {
    return __bfloat162float(__ushort_as_bfloat16(*p));
  } else {
    return *p;
  }
}

// x: [B, 3, H, W]; wpk: f32 [CHUNKS][TAPS][hi, lo][8 (n8 group)][2 (k half)][8 n][4 k]
// or bf16 [CHUNKS][TAPS][8 (n8 group)][2 (k half)][8 n][8 k] (ops/cuda/lin_stem_cuda.py
// pack_stem_weights); bias: [64] f32; out: [B, 64, HO, WO]; x and out in T
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
lin_stem_kernel(const typename StemPlan<kBf16>::T* __restrict__ x, const uint4* __restrict__ wpk,
                const float* __restrict__ bias, typename StemPlan<kBf16>::T* __restrict__ out,
                int H, int W, int HO, int WO, int pad_t, int pad_l, int tiles_x) {
  using T = typename StemPlan<kBf16>::T;
  constexpr int CC = StemPlan<kBf16>::CC;
  constexpr int CHUNKS = chunks<kBf16>();
  constexpr int SLICE_BYTES = slice_bytes<kBf16>();
  constexpr int SLICES = CHUNKS * TAPS / SLICE;
  constexpr int KSTEP_BYTES = StemPlan<kBf16>::KSTEP_BYTES;

  extern __shared__ __align__(16) float smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem);  // [kBuf][SLICE_BYTES]
  // feature planes [PLANES][CS] words: row ry at ry * ROW, column rx at
  // (rx & 1) * PWID + rx / 2.  f32: hi planes of channels 0..7, then lo
  // planes; bf16: plane q holds channels (2q, 2q + 1) of the chunk
  float* feat = smem + kBuf * SLICE_BYTES / 4;
  float* img_s = feat + StemPlan<kBf16>::PLANES * CS;  // [3][IMG][IMG]
  float* tab = img_s + 3 * IMG * IMG;                  // [center | nb | color][96]

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

  const T* xb = x + static_cast<long long>(b) * 3 * H * W;
  for (int i = tid; i < 3 * IMG * IMG; i += kThreads) {
    const int c = i / (IMG * IMG);
    const int r = i % (IMG * IMG);
    const int gy = reflect_clamp(ry0 - 1 + r / IMG, H);
    const int gx = reflect_clamp(rx0 - 1 + r % IMG, W);
    img_s[i] = load_pixel<kBf16>(xb + (static_cast<long long>(c) * H + gy) * W + gx);
  }
  for (int ch = tid; ch < kChannels; ch += kThreads) {
    int color;
    channel_entry(ch, tab[ch], tab[kChannels + ch], color);
    tab[2 * kChannels + ch] = __int_as_float(color);
  }

  // A rows of this lane: output row warp * 2 + mt, column g (+8); receptive
  // row 2 * (warp * 2 + mt) + ky, column 2 * column + kx.  f32: k column t is
  // chunk channel t (plane t), k column t + 4 channel t + 4; bf16: k columns
  // 2t, 2t + 1 are pair plane t, k columns 2t + 8, 2t + 9 pair plane t + 4.
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
      if constexpr (kBf16) {
        // each feature in f32, rounded to bf16 once; channel pairs share a word
#pragma unroll
        for (int q = 0; q < CC / 2; ++q) {
          const int ch = j * CC + 2 * q;
          const float v0 = feature_value(img_s, tab, ch, inside, p0, p1, p2, ry, rx);
          const float v1 = feature_value(img_s, tab, ch + 1, inside, p0, p1, p2, ry, rx);
          feat[q * CS + off] = __uint_as_float(
              pack_bf16(__bfloat16_as_ushort(__float2bfloat16_rn(v0)),
                        __bfloat16_as_ushort(__float2bfloat16_rn(v1))));
        }
      } else {
#pragma unroll
        for (int cl = 0; cl < CC; ++cl) {
          const float v = feature_value(img_s, tab, j * CC + cl, inside, p0, p1, p2, ry, rx);
          uint32_t hi, lo;
          split_tf32(v, hi, lo);
          feat[cl * CS + off] = __uint_as_float(hi);
          feat[(CC + cl) * CS + off] = __uint_as_float(lo);
        }
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
            ah[u][mt][0] = __float_as_uint(feat[p0]);      // (row g,     k t | 2t, 2t+1)
            ah[u][mt][1] = __float_as_uint(feat[p0 + 8]);  // (row g + 8, k t | 2t, 2t+1)
            ah[u][mt][2] = __float_as_uint(feat[p1]);      // (row g,     k t+4 | 2t+8, 2t+9)
            ah[u][mt][3] = __float_as_uint(feat[p1 + 8]);  // (row g + 8, k t+4 | 2t+8, 2t+9)
            if constexpr (!kBf16) {
              const float* lo = feat + CC * CS;
              al[u][mt][0] = __float_as_uint(lo[p0]);
              al[u][mt][1] = __float_as_uint(lo[p0 + 8]);
              al[u][mt][2] = __float_as_uint(lo[p1]);
              al[u][mt][3] = __float_as_uint(lo[p1 + 8]);
            }
          }
          if constexpr (kBf16) {
            const uint64_t bd = b_desc(wst);
            wgmma_fence();
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) wgmma_bf16<OUT_F>(acc[mt], ah[u][mt], bd);
            wgmma_commit();
          } else {
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
          }
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
  T* ob = out + static_cast<long long>(b) * OUT_F * HO * WO;
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
          const float v = fmaxf(acc[mt][4 * nt + i] + bv[nt][i & 1], 0.0f);
          T* dst = ob + (static_cast<long long>(n) * HO + oy) * WO + ox;
          if constexpr (kBf16) {
            *dst = __bfloat16_as_ushort(__float2bfloat16_rn(v));
          } else {
            *dst = v;
          }
        }
      }
    }
  }
}

template <bool kBf16>
int launch_stem(const void* x, const void* wpk, const float* bias, void* out, int B, int H,
                int W, int HO, int WO, int pad_t, int pad_l, void* stream) {
  using T = typename StemPlan<kBf16>::T;
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * smem_words<kBf16>();
  auto kernel = lin_stem_kernel<kBf16>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = shdr_ceil_div(WO, TO);
  const dim3 grid(tiles_x * shdr_ceil_div(HO, TO), B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const uint4*>(wpk), bias, static_cast<T*>(out), H, W,
      HO, WO, pad_t, pad_l, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

SHDR_API int shdr_lin_stem_f32(const float* x, const float* wpk, const float* bias,
                               float* out, int B, int H, int W, int HO, int WO,
                               int pad_t, int pad_l, void* stream) {
  return launch_stem<false>(x, wpk, bias, out, B, H, W, HO, WO, pad_t, pad_l, stream);
}

// The same stem in bf16: x, wpk and out bf16, bias f32.
SHDR_API int shdr_lin_stem_bf16(const void* x, const void* wpk, const float* bias, void* out,
                                int B, int H, int W, int HO, int WO, int pad_t, int pad_l,
                                void* stream) {
  return launch_stem<true>(x, wpk, bias, out, B, H, W, HO, WO, pad_t, pad_l, stream);
}
