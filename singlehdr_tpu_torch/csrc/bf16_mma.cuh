// The bf16 tensor-core primitives of the port's implicit-GEMM kernels
// (csrc/conv2_pool.cu: K2 and K4; csrc/lin_stem.cu: K3): wgmma.mma_async
// m64nNk16 bf16 with A and B from shared memory through descriptors;
// mma.sync m16n8k16 bf16 with its fragments loaded by ldmatrix; the packing
// of two bf16 into one register; and the 16-byte zero-filling cp.async that
// stages K2/K4's channel-inner tiles.  One product a multiply-add,
// accumulated in f32: 989 TFLOP/s dense.  The wgmma fence/commit/wait, B's descriptor and the other
// cp.async copies are tf32_mma.cuh's: a bf16 core matrix (8 rows x 8 k) is 8
// rows of 16 bytes, the same bytes as a TF32 one (8 rows x 4 k).
//
// Register layouts (PTX ISA, mma m16n8k16 .bf16; wgmma's D is the same a warp):
//   A: a0 = (row g, k 2t, 2t+1), a1 = (g + 8, 2t, 2t+1), a2 = (g, 2t+8, 2t+9),
//      a3 = (g + 8, 2t+8, 2t+9); the lower k in the low 16 bits
//   B (mma.sync): b0 = (k 2t, 2t+1; n g), b1 = (k 2t+8, 2t+9; n g)
//   D: as in TF32, d[4 nt + i] = (row g + 8 (i >> 1), n 8 nt + 2t + (i & 1))
// with g = lane / 4, t = lane % 4 (and rows + 16 per warp of a warpgroup).
// ldmatrix .x4 hands lane (g, t) the 4-byte word (row g, k 2t, 2t+1) of each
// of four 8 x 8 matrices, whose 8 row addresses (16 bytes each) come from
// lanes 8q .. 8q + 7 for matrix q: A's a0..a3 for matrices (rows 0-7, k 0-7),
// (rows 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15), and B's b0, b1
// for (n, k 0-7), (n, k 8-15) with rows = n.
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

// mma.sync m16n8k16 bf16, f32 accumulate: d += A (16 x 16) * B (16 x 8)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix .x4 (no transpose): four 8 x 8 b16 matrices, row addresses from
// lanes 8q .. 8q + 7 for matrix q (``addr``: this lane's row, shared space)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16-byte copy; ``valid`` false writes 16 zero bytes (SAME padding) and reads
// nothing
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// A shared-memory matrix descriptor, no swizzle, K-major: core matrices of 8
// rows x 16 bytes (each row 16 bytes after the one before), the core holding
// k 8..15 ``lead`` bytes after the one holding k 0..7, and the next 8 rows
// ``stride`` bytes on.  Start, lead and stride are multiples of 16 bytes
// below 256 KB (14-bit fields in 16-byte units).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead, uint32_t stride) {
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32);
}

// wgmma.mma_async m64nNk16 bf16, both operands from shared memory through
// descriptors (A 64 x 16 and B N x 16, K-major, no transpose); d += A * B^T
// (K2/K4: N = 32, 64; K3: N = 128, or 64 with pixels as M).
template <int N>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[N / 2], uint64_t a_desc, uint64_t b_desc);

template <>
__device__ __forceinline__ void wgmma_bf16_ss<32>(float (&d)[16], uint64_t a_desc, uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a_desc), "l"(b_desc));
}

template <>
__device__ __forceinline__ void wgmma_bf16_ss<64>(float (&d)[32], uint64_t a_desc, uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc));
}

template <>
__device__ __forceinline__ void wgmma_bf16_ss<128>(float (&d)[64], uint64_t a_desc, uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc));
}

}  // namespace
