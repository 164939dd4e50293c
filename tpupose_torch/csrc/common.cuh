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

constexpr int TP_MAX_DEVICES = 64;

// Raise `kernel`'s dynamic shared memory limit on the current device to
// `smem`, once a device. done: TP_MAX_DEVICES flags, false at first.
template <typename K>
cudaError_t smem_limit_once(K kernel, int smem, bool* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < TP_MAX_DEVICES && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && dev < TP_MAX_DEVICES) done[dev] = true;
  return e;
}

// The blocks of `kernel` (`threads` threads, `smem` bytes of dynamic shared
// memory) that the current device holds at once, after raising the kernel's
// dynamic shared memory limit there to `smem`. cache: TP_MAX_DEVICES ints,
// zero at first, one a device, so that both are done once a device.
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, int smem, int* cache, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < TP_MAX_DEVICES && cache[dev]) {
    *blocks = cache[dev];
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  if (dev < TP_MAX_DEVICES) cache[dev] = *blocks;
  return cudaSuccess;
}

// The clusters of `kernel` (compiled with __cluster_dims__ of at most 8
// blocks; `threads` threads and `smem` bytes of dynamic shared memory a
// block) that the current device holds at once, after raising the kernel's
// dynamic shared memory limit there to `smem`; cached a device in `cache`,
// as resident_blocks does.
template <typename K>
cudaError_t resident_clusters(K kernel, int threads, int smem, int* cache, int* clusters) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < TP_MAX_DEVICES && cache[dev]) {
    *clusters = cache[dev];
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(8 * 1024);       // a multiple of any cluster size
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (n < 1) return cudaErrorInvalidConfiguration;
  *clusters = n;
  if (dev < TP_MAX_DEVICES) cache[dev] = n;
  return cudaSuccess;
}
