// Shared helpers for the port's CUDA kernels (plain C interface, bound with
// ctypes from singlehdr_tpu_torch/ops/cuda/_build.py).
//
// Every entry point launches on the stream it is given, never synchronises,
// allocates nothing, and returns cudaGetLastError() right after its launch so
// that a launch CUDA refused (too many threads, too much shared memory)
// reaches the Python wrapper, which raises.
#pragma once

#include <cuda_runtime.h>

#define SHDR_API extern "C" __attribute__((visibility("default")))

// Largest dynamic shared memory one block may use on sm_90 (227 KB).
constexpr int kMaxSmemBytes = 232448;

inline int shdr_ceil_div(int a, int b) { return (a + b - 1) / b; }
