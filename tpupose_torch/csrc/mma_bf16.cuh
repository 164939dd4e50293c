// bf16 tensor-core helpers shared by the flash-attention kernels
// (flash_attention.cu, K8, and flash_attention_bwd.cu, K8b): cp.async
// copies into shared memory, ldmatrix fragment loads, mma.sync
// m16n8k16 with float32 accumulators, and the 64-row tile load.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, c = lane % 4):
//   A 16x16 row-major: a0 (g, 2c..2c+1), a1 (g+8, ...), a2 (g, 8+2c...),
//                      a3 (g+8, 8+2c...);
//   B 16x8:            b0 (k 2c..2c+1, n g), b1 (k 8+2c..., n g);
//   C 16x8:            c0, c1 (g, 2c..2c+1), c2, c3 (g+8, ...).
// So the C accumulators of two neighbouring 8-column tiles are the A
// fragment of a 16-deep product once packed to bf16 (see pack_bf16).
// Operand loads from a shared tile with rows padded to LDS elements:
//   A from [m][k] storage:  ldmatrix_x4 at row (lane & 15), col (lane >> 4) * 8
//   B pair from [n][k]:     ldmatrix_x4 at row (lane & 7) + (lane >> 4) * 8,
//                           col ((lane >> 3) & 1) * 8 -> {b0, b1} of n 0-7 in
//                           r[0], r[1] and of n 8-15 in r[2], r[3]
//   B pair from [k][n]:     ldmatrix_x4_trans at row (lane & 7) +
//                           ((lane >> 3) & 1) * 8, col (lane >> 4) * 8 -> the same
#pragma once

#include "common.cuh"

namespace fa {

constexpr int D = 64;        // head dim
constexpr int TILE = 64;     // rows per tile (queries or keys)
constexpr int WARPS = 4;     // 16 rows each
constexpr int LDS = D + 8;   // padded shared-memory row, in elements

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;   // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of columns [16 kk, 16 kk + 16) of a 16-row block held
// as C accumulators of 8-column tiles c[0..], rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[N][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// rows [r0, r0 + 64) of a (L, D) slice with row stride `ld` elements into
// a padded shared tile; rows >= L are zero-filled. 128 threads, 4 x 16 B.
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long ld,
                                          int r0, int L) {
#pragma unroll
  for (int i = 0; i < (TILE * D / 8) / (WARPS * 32); ++i) {
    const int c = threadIdx.x + i * WARPS * 32;
    const int row = c >> 3, col = (c & 7) * 8;
    const bool valid = r0 + row < L;
    const bf16* src = valid ? g + (long long)(r0 + row) * ld + col : g;
    cp_async16(s + row * LDS + col, src, valid);
  }
}

// This warp's 16 rows of a shared [m][k] tile as A fragments, k = 0..63.
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[D / 16][4],
                                            const bf16* s, int warp,
                                            int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(a[kk], s + (warp * 16 + (lane & 15)) * LDS + kk * 16 +
                           (lane >> 4) * 8);
}

// c[j] += a (16 x 64 over the head dim) * B, where B's 64 columns are the
// rows of a shared [n][k = head dim] tile: a product with the tile's
// transpose (S = Q K^T, dP = dO V^T), 8 column tiles of 8.
__device__ __forceinline__ void mma_rows_nt(float (&c)[TILE / 8][4],
                                            const uint32_t (&a)[D / 16][4],
                                            const bf16* s, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < TILE / 16; ++np) {
      uint32_t r[4];
      ldmatrix_x4(r, s + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                         kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(c[2 * np], a[kk], r[0], r[1]);
      mma_bf16(c[2 * np + 1], a[kk], r[2], r[3]);
    }
  }
}

// c[j] += P (16 x 64, held as C accumulators p) * the shared [k][n = head
// dim] tile s: a product with the tile as it lies (O += P V, dV += P^T dO,
// dK += dS^T Q, dQ += dS K), 8 head-dim tiles of 8.
__device__ __forceinline__ void mma_acc_nn(float (&c)[D / 8][4],
                                           const float (&p)[TILE / 8][4],
                                           const bf16* s, int lane) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    uint32_t pa[4];
    acc_to_a(pa, p, kk);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, s + (kk * 16 + (lane & 7) +
                                ((lane >> 3) & 1) * 8) * LDS +
                               np * 16 + (lane >> 4) * 8);
      mma_bf16(c[2 * np], pa, r[0], r[1]);
      mma_bf16(c[2 * np + 1], pa, r[2], r[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// Store this warp's 16 rows (C accumulators, 8 head-dim tiles) times
// `mul` as bf16 into a contiguous (B, L, H, 64) tensor at (b, q0 + row, h);
// rows >= L are not stored.
__device__ __forceinline__ void store_rows(bf16* out, const float (&c)[D / 8][4],
                                           float mul0, float mul1, int b,
                                           int h, int H, int L, int r0,
                                           int lane) {
  const long long sl = (long long)H * D;
  bf16* g = out + ((long long)b * L * H + h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + (lane >> 2) + i * 8;
    if (row >= L) continue;
    const float mul = i ? mul1 : mul0;
    bf16* orow = g + row * sl + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<bf162*>(orow + j * 8) = __floats2bfloat162_rn(
          c[j][2 * i] * mul, c[j][2 * i + 1] * mul);
  }
}

}  // namespace fa
