// Warp-level bf16 tensor-core tiles (wmma m8n32k16, float32 accumulate)
// shared by the kernels of tpupose_torch: fragment types, a k-loop over
// MF x NF fragments, and an epilogue that hands one accumulator to a
// functor through a per-warp shared-memory scratch of 8 x 32 floats.
#pragma once

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

typedef wmma::fragment<wmma::matrix_a, 8, 32, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 8, 32, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 8, 32, 16, float> FragC;

// acc[m][n] += A_m (8 x 16*KS at a + m*a_mstride, row stride lda)
//            @ B (16*KS x 32 at b + n*32, row stride ldb)
template <int MF, int NF, int KS>
__device__ __forceinline__ void warp_gemm(FragC (&acc)[MF][NF], const bf16* a, int lda,
                                          int a_mstride, const bf16* b, int ldb) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    FragA fa[MF];
    FragB fb[NF];
#pragma unroll
    for (int m = 0; m < MF; ++m) wmma::load_matrix_sync(fa[m], a + m * a_mstride + ks * 16, lda);
#pragma unroll
    for (int n = 0; n < NF; ++n) wmma::load_matrix_sync(fb[n], b + ks * 16 * ldb + n * 32, ldb);
#pragma unroll
    for (int m = 0; m < MF; ++m)
#pragma unroll
      for (int n = 0; n < NF; ++n) wmma::mma_sync(acc[m][n], fa[m], fb[n], acc[m][n]);
  }
}

// Hand one 8 x 32 accumulator to f(row, col, v[col], v[col + 1]) through
// the warp's scratch: lane -> column pair 2*(lane%16), rows lane/16 + 2i.
template <typename F>
__device__ __forceinline__ void epilogue(const FragC& acc, float* scr, int lane, F&& f) {
  wmma::store_matrix_sync(scr, acc, 32, wmma::mem_row_major);
  __syncwarp();
  const int c = (lane & 15) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (lane >> 4) + 2 * i;
    f(r, c, scr[r * 32 + c], scr[r * 32 + c + 1]);
  }
  __syncwarp();
}

}  // namespace
