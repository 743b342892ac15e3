// Shared helpers of the port's kernels (nerfsys_tpu_torch/csrc/*.cu).
//
// Every library is built on its own (one nvcc per .cu, see
// nerfsys_tpu_torch/kernels/__init__.py) with a plain C interface that the
// Python side binds with ctypes. Entry points launch on the caller's stream,
// never synchronise, allocate nothing, and return cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NERF_API extern "C" __attribute__((visibility("default")))

NERF_API const char* nerfsys_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

static inline unsigned int nerf_blocks(long long work, int threads) {
    return static_cast<unsigned int>((work + threads - 1) / threads);
}
