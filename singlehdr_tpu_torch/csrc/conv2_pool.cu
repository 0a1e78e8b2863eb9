// K2 and K4: one fused encoder stage, two SAME convs + activation + 2x2 pool.
//
//   act    = ACT(conv_K(ACT(conv_K(x) + b1)) + b2)        (the skip)
//   pooled = POOL_2x2(act)
//
// K2 (LEAKY, avg pool, K in {3,5,7}) replaces unet_stage2 in
// singlehdr_tpu/ops/pallas/unet_stage_pallas.py (deq/ref U-Net encoder
// prefix); K4 (ReLU, max pool, K = 3) replaces encoder_stage2 in
// singlehdr_tpu/ops/pallas/enc_pool_pallas.py (hal enc1/enc2).
//
// What the TPU kernels kept out of device memory, this one does too: the
// conv1 activation.  A block owns one T x T output tile of one image and all
// F channels.  It stages the input tile plus a 2R halo (R = (K-1)/2) in
// shared memory, computes conv1 over the tile plus an R halo for all F
// channels into shared memory, then conv2 from there, and writes the skip
// and the complete 2x2 pool (the TPU kernels left the W-pair half of the
// pool to XLA).  conv1 rows/cols outside the image are stored as ZERO, which
// is what conv2's SAME padding must see (not ACT(b1)).
//
// Bound on this card: the two f32 convs are FMA-bound (no TF32 here, the
// port is f32).  Each thread keeps a register tile of a 2x2 pixel quad x FG
// output channels (conv2) or a 1x2 pixel pair x FG channels (conv1), so one
// shared-memory read feeds FG FMAs.  Weights are pre-packed by the wrapper as
// [C][K][K][F] so a thread's FG channels are one contiguous 32-byte read that
// the threads of a warp share (broadcast through L1).  The conv1 halo is
// recomputed per tile: (T+2R)^2 / T^2 of conv1's work.  (Larger register
// tiles, 2x4 pixels or 16 channels, measured no faster on the H100.)
#include "common.cuh"

namespace {

enum class Act { kLeaky, kRelu };
enum class Pool { kAvg, kMax };

constexpr int kMaxThreads = 256;
constexpr int FG = 8;  // output channels per thread

template <Act A>
__device__ __forceinline__ float act(float v) {
  if constexpr (A == Act::kLeaky) {
    return v > 0.0f ? v : v * 0.1f;
  } else {
    return fmaxf(v, 0.0f);
  }
}

__device__ __forceinline__ void load_fg(const float* __restrict__ p, float w[FG]) {
#pragma unroll
  for (int q = 0; q < FG / 4; ++q) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + q);
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
}

// x: [B, C, H, W]; w1t: [C][K][K][F]; w2t: [F][K][K][F]; b1, b2: [F]
// act_out: [B, F, H, W]; pooled: [B, F, PH, PW]
template <int K, int T, Act A, Pool P>
__global__ void __launch_bounds__(kMaxThreads)
conv2_pool_kernel(const float* __restrict__ x, const float* __restrict__ w1t,
                  const float* __restrict__ b1, const float* __restrict__ w2t,
                  const float* __restrict__ b2, float* __restrict__ act_out,
                  float* __restrict__ pooled, int C, int F, int H, int W,
                  int PH, int PW, int tiles_x) {
  constexpr int R = (K - 1) / 2;
  constexpr int IN = T + 4 * R;   // staged input extent
  constexpr int MID = T + 2 * R;  // conv1 extent (tile + conv2 halo)
  static_assert(T % 2 == 0, "the pool pairs rows and columns inside a tile");
  extern __shared__ float smem[];
  float* in_s = smem;                 // [C][IN][IN]
  float* mid_s = smem + C * IN * IN;  // [F][MID][MID]

  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * T;
  const int tx0 = (blockIdx.x % tiles_x) * T;
  const int n_fg = F / FG;

  // 1. input tile + 2R halo, zero outside the image (SAME padding of conv1)
  const float* xb = x + static_cast<long long>(b) * C * H * W;
  for (int i = threadIdx.x; i < C * IN * IN; i += blockDim.x) {
    const int c = i / (IN * IN);
    const int r = i % (IN * IN);
    const int gy = ty0 - 2 * R + r / IN;
    const int gx = tx0 - 2 * R + r % IN;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = xb[(static_cast<long long>(c) * H + gy) * W + gx];
    }
    in_s[i] = v;
  }
  __syncthreads();

  // 2. conv1 over the tile + R halo, all F channels, into shared memory
  constexpr int PAIRS = MID * MID / 2;  // MID is even: T even, 2R even
  for (int item = threadIdx.x; item < n_fg * PAIRS; item += blockDim.x) {
    const int fg = item / PAIRS;
    const int pr = item % PAIRS;
    const int my = pr / (MID / 2);
    const int mx = 2 * (pr % (MID / 2));
    float acc0[FG], acc1[FG];
#pragma unroll
    for (int j = 0; j < FG; ++j) {
      acc0[j] = __ldg(b1 + fg * FG + j);
      acc1[j] = acc0[j];
    }
    for (int c = 0; c < C; ++c) {
      const float* src = in_s + (c * IN + my) * IN + mx;
      const float* wc = w1t + static_cast<long long>(c) * K * K * F + fg * FG;
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
        float row[K + 1];
#pragma unroll
        for (int i = 0; i <= K; ++i) row[i] = src[kh * IN + i];
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          float w[FG];
          load_fg(wc + (kh * K + kw) * F, w);
#pragma unroll
          for (int j = 0; j < FG; ++j) {
            acc0[j] = fmaf(row[kw], w[j], acc0[j]);
            acc1[j] = fmaf(row[kw + 1], w[j], acc1[j]);
          }
        }
      }
    }
    const int gy = ty0 - R + my;
    const int gx = tx0 - R + mx;
    const bool row_in = gy >= 0 && gy < H;
    const bool in0 = row_in && gx >= 0 && gx < W;
    const bool in1 = row_in && gx + 1 >= 0 && gx + 1 < W;
#pragma unroll
    for (int j = 0; j < FG; ++j) {
      float* dst = mid_s + ((fg * FG + j) * MID + my) * MID + mx;
      dst[0] = in0 ? act<A>(acc0[j]) : 0.0f;
      dst[1] = in1 ? act<A>(acc1[j]) : 0.0f;
    }
  }
  __syncthreads();

  // 3. conv2 on 2x2 quads, activation, skip write and the full 2x2 pool
  constexpr int QUADS = (T / 2) * (T / 2);
  float* act_b = act_out + static_cast<long long>(b) * F * H * W;
  float* pool_b = pooled + static_cast<long long>(b) * F * PH * PW;
  for (int item = threadIdx.x; item < n_fg * QUADS; item += blockDim.x) {
    const int fg = item / QUADS;
    const int q = item % QUADS;
    const int oy = 2 * (q / (T / 2));
    const int ox = 2 * (q % (T / 2));
    float acc[4][FG];
#pragma unroll
    for (int j = 0; j < FG; ++j) {
      acc[0][j] = __ldg(b2 + fg * FG + j);
      acc[1][j] = acc[0][j];
      acc[2][j] = acc[0][j];
      acc[3][j] = acc[0][j];
    }
    for (int c = 0; c < F; ++c) {
      const float* src = mid_s + (c * MID + oy) * MID + ox;
      const float* wc = w2t + static_cast<long long>(c) * K * K * F + fg * FG;
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
        float top[K + 1], bot[K + 1];
#pragma unroll
        for (int i = 0; i <= K; ++i) {
          top[i] = src[kh * MID + i];
          bot[i] = src[(kh + 1) * MID + i];
        }
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          float w[FG];
          load_fg(wc + (kh * K + kw) * F, w);
#pragma unroll
          for (int j = 0; j < FG; ++j) {
            acc[0][j] = fmaf(top[kw], w[j], acc[0][j]);
            acc[1][j] = fmaf(top[kw + 1], w[j], acc[1][j]);
            acc[2][j] = fmaf(bot[kw], w[j], acc[2][j]);
            acc[3][j] = fmaf(bot[kw + 1], w[j], acc[3][j]);
          }
        }
      }
    }
    const int gy = ty0 + oy;
    const int gx = tx0 + ox;
    const bool ok[4] = {gy < H && gx < W, gy < H && gx + 1 < W,
                        gy + 1 < H && gx < W, gy + 1 < H && gx + 1 < W};
    const int py = gy / 2;
    const int px = gx / 2;
#pragma unroll
    for (int j = 0; j < FG; ++j) {
      const int f = fg * FG + j;
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = act<A>(acc[u][j]);
      float* dst = act_b + (static_cast<long long>(f) * H + gy) * W + gx;
      if (ok[0]) dst[0] = v[0];
      if (ok[1]) dst[1] = v[1];
      if (ok[2]) dst[W] = v[2];
      if (ok[3]) dst[W + 1] = v[3];
      if (py < PH && px < PW) {
        float pv;
        if constexpr (P == Pool::kAvg) {
          // VALID pool: (py, px) < (H/2, W/2) means all four are inside
          pv = ((v[0] + v[1]) + (v[2] + v[3])) * 0.25f;
        } else {
          // SAME pool: max over the in-image members (ok[0] always holds)
          pv = v[0];
          if (ok[1]) pv = fmaxf(pv, v[1]);
          if (ok[2]) pv = fmaxf(pv, v[2]);
          if (ok[3]) pv = fmaxf(pv, v[3]);
        }
        pool_b[(static_cast<long long>(f) * PH + py) * PW + px] = pv;
      }
    }
  }
}

constexpr size_t smem_bytes(int K, int T, int C, int F) {
  return sizeof(float) * (static_cast<size_t>(C) * (T + 2 * (K - 1)) * (T + 2 * (K - 1)) +
                          static_cast<size_t>(F) * (T + K - 1) * (T + K - 1));
}

template <int K, int T, Act A, Pool P>
int launch_tile(const float* x, const float* w1t, const float* b1, const float* w2t,
                const float* b2, float* act_out, float* pooled, int B, int C, int F,
                int H, int W, int PH, int PW, cudaStream_t stream) {
  if (F % FG != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(K, T, C, F);
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv2_pool_kernel<K, T, A, P>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int tiles_x = shdr_ceil_div(W, T);
  const int tiles_y = shdr_ceil_div(H, T);
  const int items = (F / FG) * (T / 2) * (T / 2);
  const int threads = items < 64 ? 64 : (items > kMaxThreads ? kMaxThreads : items);
  dim3 grid(tiles_x * tiles_y, B);
  kernel<<<grid, threads, smem, stream>>>(x, w1t, b1, w2t, b2, act_out, pooled, C, F, H,
                                          W, PH, PW, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

// The tile: 16 x 16 when its shared memory stays near 100 KB (two blocks an
// SM), else 8 x 8; a stage that does not fit even 8 x 8 is refused.
template <int K, Act A, Pool P>
int launch_k(const float* x, const float* w1t, const float* b1, const float* w2t,
             const float* b2, float* act_out, float* pooled, int B, int C, int F,
             int H, int W, int PH, int PW, cudaStream_t stream) {
  if (smem_bytes(K, 16, C, F) <= 100 * 1024) {
    return launch_tile<K, 16, A, P>(x, w1t, b1, w2t, b2, act_out, pooled, B, C, F, H, W,
                                    PH, PW, stream);
  }
  return launch_tile<K, 8, A, P>(x, w1t, b1, w2t, b2, act_out, pooled, B, C, F, H, W,
                                 PH, PW, stream);
}

template <Act A, Pool P>
int launch(int K, const float* x, const float* w1t, const float* b1, const float* w2t,
           const float* b2, float* act_out, float* pooled, int B, int C, int F, int H,
           int W, int PH, int PW, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (K) {
    case 3:
      return launch_k<3, A, P>(x, w1t, b1, w2t, b2, act_out, pooled, B, C, F, H, W, PH,
                               PW, stream);
    case 5:
      return launch_k<5, A, P>(x, w1t, b1, w2t, b2, act_out, pooled, B, C, F, H, W, PH,
                               PW, stream);
    case 7:
      return launch_k<7, A, P>(x, w1t, b1, w2t, b2, act_out, pooled, B, C, F, H, W, PH,
                               PW, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K2: leaky-ReLU(0.1) convs + 2x2 average pool (VALID: PH = H/2, PW = W/2).
SHDR_API int shdr_unet_stage2_f32(int K, const float* x, const float* w1t,
                                  const float* b1, const float* w2t, const float* b2,
                                  float* act_out, float* pooled, int B, int C, int F,
                                  int H, int W, void* stream) {
  return launch<Act::kLeaky, Pool::kAvg>(K, x, w1t, b1, w2t, b2, act_out, pooled, B, C,
                                         F, H, W, H / 2, W / 2,
                                         static_cast<cudaStream_t>(stream));
}

// K4: ReLU 3x3 convs + 2x2 max pool (SAME: PH = ceil(H/2), PW = ceil(W/2)).
SHDR_API int shdr_encoder_stage2_f32(const float* x, const float* w1t, const float* b1,
                                     const float* w2t, const float* b2, float* act_out,
                                     float* pooled, int B, int C, int F, int H, int W,
                                     void* stream) {
  return launch<Act::kRelu, Pool::kMax>(3, x, w1t, b1, w2t, b2, act_out, pooled, B, C, F,
                                        H, W, (H + 1) / 2, (W + 1) / 2,
                                        static_cast<cudaStream_t>(stream));
}
