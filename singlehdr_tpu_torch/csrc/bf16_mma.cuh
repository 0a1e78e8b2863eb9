// The bf16 tensor-core primitives of the port's implicit-GEMM kernels
// (csrc/conv2_pool.cu: K2 and K4; csrc/lin_stem.cu: K3): wgmma.mma_async
// m64nNk16 bf16 with A from registers and B from shared memory through a
// descriptor, mma.sync m16n8k16 bf16, and the packing of two bf16 into one
// A register.  One product a multiply-add, accumulated in f32: 989 TFLOP/s
// dense.  The descriptor, the wgmma fence/commit/wait and the cp.async
// copies are tf32_mma.cuh's: a bf16 core matrix (8 n x 8 k) is 8 rows of 16
// bytes, the same bytes as a TF32 one (8 n x 4 k), so B's shared-memory
// layout and descriptor strides carry over unchanged.
//
// Register layouts (PTX ISA, wgmma .bf16 A fragment and mma m16n8k16):
//   A: a0 = (row g, k 2t, 2t+1), a1 = (g + 8, 2t, 2t+1), a2 = (g, 2t+8, 2t+9),
//      a3 = (g + 8, 2t+8, 2t+9); the lower k in the low 16 bits
//   B (mma.sync): b0 = (k 2t, 2t+1; n g), b1 = (k 2t+8, 2t+9; n g)
//   D: as in TF32, d[4 nt + i] = (row g + 8 (i >> 1), n 8 nt + 2t + (i & 1))
// with g = lane / 4, t = lane % 4 (and rows + 16 per warp of a warpgroup).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_mma.cuh"

namespace {

// two bf16 bit patterns -> one A/B register, ``lo`` (the lower k) in bits 0-15
__device__ __forceinline__ uint32_t pack_bf16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// wgmma.mma_async m64nNk16 bf16: A (64 x 16) from registers, B (N x 16,
// K-major, no transpose) from shared memory through a descriptor; d += A * B^T.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// mma.sync m16n8k16 bf16, f32 accumulate: d += A (16 x 16) * B (16 x 8)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
