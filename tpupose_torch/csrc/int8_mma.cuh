// Block-wide int8 GEMM building blocks of the int8 deconv kernel
// (int8_deconv.cu, K6): s8 x s8 -> s32 tensor-core products with
// mma.sync.m16n8k32, operands staged through shared memory. (The int8
// bottleneck, K5, runs int8 wgmma from wgmma_tma.cuh instead.)
//
// A GEMM computes C[M][N] = A[M][K] @ W[N][K]^T, with W row-major [N][K]
// (the torch conv layout (O, I), K contiguous) and A given row by row by a
// functor, so the rows may be any pixels (an implicit GEMM: halo pixels,
// the taps of a 3x3, the shifted inputs of a transposed conv). K runs in
// chunks of KC = 64 bytes; each chunk of W (and of A, when A lives in device
// memory) is copied into a double-buffered shared-memory stage with
// cp.async while the previous chunk is multiplied.
//
// Work split: a pass covers up to MG = 128 rows and NB columns. The 8 warps
// form a WM x WN grid (WM = 1, 2 or 4 by the pass's row count, WN = 8 / WM)
// and each warp owns a 32 x 32 tile: 2 m16 x 4 n8 fragments, 32 int32
// accumulators a thread. Fragment registers (PTX ISA, m16n8k32 .s8):
//   A a0: row g, k 4t..4t+3     a1: row g+8, same k
//     a2: row g, k 16+4t..      a3: row g+8, k 16+4t..
//   B b0: col g, k 4t..4t+3     b1: col g, k 16+4t..
//   C c0,c1: row g, cols 2t, 2t+1   c2,c3: row g+8, cols 2t, 2t+1
// with g = lane / 4, t = lane % 4. Shared rows are KC + 16 bytes apart, so
// the 8 rows g of a fragment load hit 32 different banks.
#pragma once

#include "common.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int KC = 64;                   // K bytes per chunk
constexpr int SROW = KC + 16;            // stage row stride, bytes
constexpr int MG = 128;                  // rows per pass, at most
constexpr int NBMAX = 256;               // columns per pass, at most
constexpr int A_STAGE = MG * SROW;       // bytes per A stage buffer
constexpr int W_STAGE = NBMAX * SROW;    // bytes per W stage buffer
constexpr size_t STAGE_BYTES = 2 * (size_t)A_STAGE + 2 * (size_t)W_STAGE;

typedef int Acc[2][4][4];

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;          // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The requantization of the TPU kernels: clip(round(max(v, 0)), 0, 127),
// round half to even.
__device__ __forceinline__ int rq(float v) { return (int)fminf(rintf(fmaxf(v, 0.f)), 127.f); }

// acc * m + b as two rounded float32 operations (no fused multiply-add),
// in the order of the plain version.
__device__ __forceinline__ float affine(int acc, float m, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), m), b);
}

// The shape of one pass: rows [m0, m0 + rows), columns [n0, n0 + nb).
struct Pass {
  int m0, rows, wm_n, nb, n0;
  int wm, wn;         // this warp's place in the WM x WN grid
  bool active;        // the warp's columns lie inside [n0, N)
};

// Calls body(pass) for every pass of an M x N GEMM (N a multiple of 32).
template <class Body>
__device__ __forceinline__ void for_each_pass(int M, int N, Body body) {
  const int warp = threadIdx.x >> 5;
  for (int m0 = 0; m0 < M; m0 += MG) {
    Pass p;
    p.m0 = m0;
    p.rows = min(MG, M - m0);
    p.wm_n = p.rows <= 32 ? 1 : (p.rows <= 64 ? 2 : 4);
    const int wn_n = NWARPS / p.wm_n;
    p.nb = min(wn_n * 32, N);
    p.wm = warp % p.wm_n;
    p.wn = warp / p.wm_n;
    for (int n0 = 0; n0 < N; n0 += p.nb) {
      p.n0 = n0;
      p.active = p.wn * 32 < p.nb && n0 + p.wn * 32 < N;
      body(p);
    }
  }
}

// acc (zeroed here) += A[rows of pass p][0:K] @ W[n0 + warp cols][0:K]^T,
// W of N rows (rows past N read as zeros), K a multiple of KC.
// A_GLOBAL: a_src(row, k0) returns the device address of the row's 64
// bytes at k0, or nullptr for a zero row; the chunk is staged in `sa`.
// Otherwise a_src(row, k0) returns the shared address of those 64 bytes
// (rows past the pass's end must still return a readable address).
// Every thread of the block calls this; it starts and ends with a barrier
// so shared data written before it is visible and its stages are free
// after it.
template <bool A_GLOBAL, class ASrc>
__device__ __forceinline__ void accumulate(Acc& acc, const Pass& p, int N, int K,
                                           const int8_t* __restrict__ W, ASrc a_src,
                                           int8_t* sa, int8_t* sw) {
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int arows = p.wm_n * 32;       // rows staged (zeros past p.rows)
  auto load = [&](int c, int buf) {
    const int k0 = c * KC;
    int8_t* wdst = sw + buf * W_STAGE;
    for (int i = tid; i < p.nb * 4; i += THREADS) {
      const int r = i >> 2, v = i & 3;
      const int n = p.n0 + r;
      cp_async16(wdst + r * SROW + v * 16, n < N ? W + (size_t)n * K + k0 + v * 16 : W, n < N);
    }
    if constexpr (A_GLOBAL) {
      int8_t* adst = sa + buf * A_STAGE;
      for (int i = tid; i < arows * 4; i += THREADS) {
        const int r = i >> 2, v = i & 3;
        const int8_t* src = r < p.rows ? a_src(p.m0 + r, k0) : nullptr;
        cp_async16(adst + r * SROW + v * 16, src ? src + v * 16 : W, src != nullptr);
      }
    }
    cp_async_commit();
  };

  const int nch = K / KC;
  __syncthreads();
  load(0, 0);
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      load(c + 1, (c + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (p.active) {
      const int buf = c & 1;
      const int8_t* arow[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = p.wm * 32 + mi * 16 + h * 8 + g;
          if constexpr (A_GLOBAL)
            arow[mi][h] = sa + buf * A_STAGE + r * SROW;
          else
            arow[mi][h] = a_src(p.m0 + min(r, p.rows - 1), c * KC);
        }
      const int8_t* wbase = sw + buf * W_STAGE + (p.wn * 32 + g) * SROW;
#pragma unroll
      for (int ks = 0; ks < KC / 32; ++ks) {
        const int ko = ks * 32 + t * 4;
        unsigned a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          a[mi][0] = ld32(arow[mi][0] + ko);
          a[mi][1] = ld32(arow[mi][1] + ko);
          a[mi][2] = ld32(arow[mi][0] + ko + 16);
          a[mi][3] = ld32(arow[mi][1] + ko + 16);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int8_t* wb = wbase + ni * 8 * SROW;
          const unsigned b0 = ld32(wb + ko), b1 = ld32(wb + ko + 16);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
        }
      }
    }
    __syncthreads();
  }
}

// Calls f(row, col, mi, ni, h) for the pairs (row, col), (row, col + 1) of
// accumulator entries acc[mi][ni][2h], acc[mi][ni][2h + 1] that this thread
// holds, for rows inside the pass (row and col are GEMM coordinates).
template <class F>
__device__ __forceinline__ void for_each_pair(const Pass& p, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = p.wm * 32 + mi * 16 + h * 8 + g;
      if (r >= p.rows) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) f(p.m0 + r, p.n0 + p.wn * 32 + ni * 8 + 2 * t, mi, ni, h);
    }
}

__device__ __forceinline__ void store2(int8_t* dst, int v0, int v1) {
  *reinterpret_cast<char2*>(dst) = make_char2((signed char)v0, (signed char)v1);
}

}  // namespace
