// Shared by every kernel library of tpupose_torch (see ops/_build.py).
// Each .cu file is compiled into its own shared library with a plain C
// interface; entry points return cudaGetLastError() as an int.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

extern "C" const char* tp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
