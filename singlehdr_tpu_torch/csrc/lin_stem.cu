// K3: Linearization-Net front end, the 93-channel feature stack and the
// 7x7 stride-2 stem in one pass:
//
//   out = relu(conv7x7/2_SAME(features93(x)) + bias)      (BN folded by caller)
//
// Replaces lin_feature_stem in singlehdr_tpu/ops/pallas/lin_stem_pallas.py.
// As there, the 93-channel stack (image 3 | Sobel dy/dx color-major 6 |
// soft histograms at 4/8/16 bins, bin-major 84) never reaches device memory:
// a block computes the features of its stride-2 receptive field in shared
// memory, 16 channels at a time, and runs the stem over them.  Device
// traffic is the 3-channel input plus the 64-channel output.
//
// Border semantics are handled in the kernel, so the TPU wrapper's border
// ring recompute is not needed:
//   * Sobel REFLECT-pads the image (index -1 -> 1, H -> H-2), per axis;
//   * the stack is zero-padded AS FEATURES for the conv: a tap outside the
//     image contributes 0 (a zero pixel would have nonzero histograms);
//   * SAME padding at stride 2 is asymmetric (2 low / 3 high on an even
//     extent); the wrapper passes the low pads.
//
// Bound on this card: 49 * 93 * 64 FMAs per output pixel in f32 — FMA-bound.
// A thread holds 4 output rows x 16 channels (64 accumulators); one warp
// shares one channel group, so its weight reads (packed [93][7][7][64]) are
// broadcasts.  Features are stored split by column parity, so the stride-2
// taps of neighbouring threads hit neighbouring shared-memory words.
#include "common.cuh"

namespace {

constexpr int TO = 16;            // output tile: TO x TO pixels
constexpr int RY = 2 * TO + 5;    // receptive field extent (rows and cols)
constexpr int PWID = (RY + 1) / 2;  // entries per column-parity plane
constexpr int CH = 16;            // feature channels per chunk
constexpr int NF = 93;            // feature channels
constexpr int OUT_F = 64;         // stem output channels
constexpr int IMG = RY + 2;       // raw image extent (+1 Sobel border a side)
constexpr int kThreads = 256;     // 16 cols x 4 row groups x 4 channel groups

__device__ __forceinline__ int reflect_clamp(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

// feature ch of the pixel whose 3x3 neighbourhood centres at img_s[.][a][b]
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
  const float center = (2.0f * static_cast<float>(bin + 1) - 1.0f) / (2.0f * nb);
  const float d = fabsf(img_s[(j % 3) * plane + a * IMG + b] - center);
  return fmaxf(0.0f, 1.0f - d * static_cast<float>(nb));
}

// x: [B, 3, H, W]; wt: [93][7][7][64]; bias: [64]; out: [B, 64, HO, WO]
__global__ void __launch_bounds__(kThreads, 2)
lin_stem_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                const float* __restrict__ bias, float* __restrict__ out, int H, int W,
                int HO, int WO, int pad_t, int pad_l, int tiles_x) {
  extern __shared__ float smem[];
  float* img_s = smem;                  // [3][IMG][IMG]
  float* feat_s = smem + 3 * IMG * IMG;  // [CH][RY][2][PWID]

  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_x) * TO;
  const int ox0 = (blockIdx.x % tiles_x) * TO;
  const int ry0 = 2 * oy0 - pad_t;  // image row of receptive-field row 0
  const int rx0 = 2 * ox0 - pad_l;

  const float* xb = x + static_cast<long long>(b) * 3 * H * W;
  for (int i = threadIdx.x; i < 3 * IMG * IMG; i += kThreads) {
    const int c = i / (IMG * IMG);
    const int r = i % (IMG * IMG);
    const int gy = reflect_clamp(ry0 - 1 + r / IMG, H);
    const int gx = reflect_clamp(rx0 - 1 + r % IMG, W);
    img_s[i] = xb[(static_cast<long long>(c) * H + gy) * W + gx];
  }

  const int col = threadIdx.x % TO;
  const int rg = (threadIdx.x / TO) % 4;
  const int fg = threadIdx.x / (TO * 4);
  float acc[4][16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float bj = __ldg(bias + fg * 16 + j);
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u][j] = bj;
  }

  for (int c0 = 0; c0 < NF; c0 += CH) {
    const int nch = min(CH, NF - c0);
    __syncthreads();  // img_s ready / previous chunk consumed
    for (int i = threadIdx.x; i < nch * RY * RY; i += kThreads) {
      const int cl = i / (RY * RY);
      const int r = i % (RY * RY);
      const int ry = r / RY;
      const int rx = r % RY;
      const int gy = ry0 + ry;
      const int gx = rx0 + rx;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = feature(img_s, c0 + cl, ry + 1, rx + 1);
      }
      feat_s[((cl * RY + ry) * 2 + (rx & 1)) * PWID + (rx >> 1)] = v;
    }
    __syncthreads();

    for (int cl = 0; cl < nch; ++cl) {
      const float* wc = wt + static_cast<long long>(c0 + cl) * 49 * OUT_F + fg * 16;
      for (int ky = 0; ky < 7; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 7; ++kx) {
          float v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int ry = 2 * (rg * 4 + u) + ky;
            v[u] = feat_s[((cl * RY + ry) * 2 + (kx & 1)) * PWID + col + (kx >> 1)];
          }
          const float4* wp = reinterpret_cast<const float4*>(wc + (ky * 7 + kx) * OUT_F);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 w4 = __ldg(wp + q);
            const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                acc[u][q * 4 + e] = fmaf(v[u], w[e], acc[u][q * 4 + e]);
              }
            }
          }
        }
      }
    }
  }

  const int ox = ox0 + col;
  if (ox >= WO) return;
  float* ob = out + static_cast<long long>(b) * OUT_F * HO * WO;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int oy = oy0 + rg * 4 + u;
    if (oy >= HO) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      ob[(static_cast<long long>(fg * 16 + j) * HO + oy) * WO + ox] = fmaxf(acc[u][j], 0.0f);
    }
  }
}

}  // namespace

SHDR_API int shdr_lin_stem_f32(const float* x, const float* wt, const float* bias,
                               float* out, int B, int H, int W, int HO, int WO,
                               int pad_t, int pad_l, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (3 * IMG * IMG + CH * RY * 2 * PWID);
  cudaFuncSetAttribute(lin_stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int tiles_x = shdr_ceil_div(WO, TO);
  dim3 grid(tiles_x * shdr_ceil_div(HO, TO), B);
  lin_stem_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, wt, bias, out, H, W, HO, WO, pad_t, pad_l, tiles_x);
  return static_cast<int>(cudaGetLastError());
}
