// Flash attention forward for Hopper: o = softmax(scale * q k^T) v per
// (batch, head), q/k/v/o in the (B, L, heads, 64) layout, bf16 in and out,
// float32 softmax and accumulation. Any L >= 1: keys past L are masked,
// queries past L are computed on zero rows and not stored.
//
// Replaces the TPU kernel behind tpupose/ops/attention.py `_flash` (the
// library Pallas `flash_attention`, called at :69, dispatched at :84). The
// TPU version pads L to a multiple of 128, transposes to (B, h, Lp, D),
// masks the pad with segment ids and keeps the whole (Lp, Lp) float32
// score tile of one (batch, head) in VMEM, which is why it stops at
// Lp <= 1792. Here nothing is padded or transposed: q/k/v are read in
// place through their strides (a view of the qkv projection is taken as
// it is), and K/V stream through shared memory 64 keys at a time, so the
// score tile never exceeds 64 x 64 and L has no upper limit.
//
// What bounds it on the H100: at the ViTPose-S shape (B=128, L=197, 6
// heads) the bytes (q, k, v read once, o written once: 77.5 MB, 0.023 ms
// at 3.35 TB/s) outweigh the products (7.6 GFLOP, 0.0077 ms at 989
// TFLOP/s); at the DINOv3 640^2 ViT-B shape (B=16, L=1605, 12 heads) the
// products bound it (126.6 GFLOP, 0.128 ms). Design (FlashAttention-2):
// one block of 4 warps per (64-query tile, head, batch), each warp owning
// 16 query rows whose Q fragments stay in registers; K/V tiles of 64 keys
// double-buffered in shared memory by cp.async (zero-filled past L);
// S = Q K^T and O += P V as bf16 mma.sync.m16n8k16 with float32
// accumulators, V read with ldmatrix.trans; the online softmax works on
// the accumulator registers (row max and sum over the 4 lanes of a row by
// shuffles, exp2f with the scale folded in), and P goes from the S
// accumulators to the A fragments of the PV product without shared
// memory. Rows of shared memory are padded to 72 elements (144 bytes) so
// that the 8 rows an ldmatrix reads fall in distinct banks.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int D = 64;        // head dim
constexpr int BQ = 64;       // queries per block (16 per warp)
constexpr int BK = 64;       // keys per K/V tile
constexpr int WARPS = 4;
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

// rows [r0, r0 + 64) of a (L, D) slice with row stride `ld` elements into
// a padded shared tile; rows >= L are zero-filled. 128 threads, 4 x 16 B.
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long ld,
                                          int r0, int L) {
#pragma unroll
  for (int i = 0; i < (BK * D / 8) / (WARPS * 32); ++i) {
    const int c = threadIdx.x + i * WARPS * 32;
    const int row = c >> 3, col = (c & 7) * 8;
    const bool valid = r0 + row < L;
    const bf16* src = valid ? g + (long long)(r0 + row) * ld + col : g;
    cp_async16(s + row * LDS + col, src, valid);
  }
}

__global__ void __launch_bounds__(WARPS * 32)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int L, int H, long long qsb, long long qsl,
                       long long qsh, long long ksb, long long ksl,
                       long long ksh, long long vsb, long long vsl,
                       long long vsh, float scale_log2) {
  __shared__ __align__(16) bf16 sQ[BQ * LDS];
  __shared__ __align__(16) bf16 sK[2][BK * LDS];
  __shared__ __align__(16) bf16 sV[2][BK * LDS];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qg = q + b * qsb + h * qsh;
  const bf16* kg = k + b * ksb + h * ksh;
  const bf16* vg = v + b * vsb + h * vsh;

  const int n_tiles = (L + BK - 1) / BK;
  load_tile(sQ, qg, qsl, q0, L);
  load_tile(sK[0], kg, ksl, 0, L);
  load_tile(sV[0], vg, vsl, 0, L);
  cp_async_commit();

  uint32_t qf[D / 16][4];          // this warp's 16 rows of Q, A fragments
  float acc_o[D / 8][4];           // O accumulators, 8 dim tiles of 16x8
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_o[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};   // rows lane/4 and lane/4 + 8
  float l_run[2] = {0.f, 0.f};               // this lane's partial sums

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile(sK[buf ^ 1], kg, ksl, (t + 1) * BK, L);
      load_tile(sV[buf ^ 1], vg, vsl, (t + 1) * BK, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LDS + kk * 16 +
                                (lane >> 4) * 8);
    }

    // S = Q K^T: 16 rows x 64 keys per warp, 8 key tiles of 8
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const bf16* kt = sK[buf];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }

    // mask keys >= L (only the last tile can hold any)
    const int k0 = t * BK;
    if (k0 + BK > L) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int c = k0 + j * 8 + (lane & 3) * 2;
        if (c >= L) { s[j][0] = -INFINITY; s[j][2] = -INFINITY; }
        if (c + 1 >= L) { s[j][1] = -INFINITY; s[j][3] = -INFINITY; }
      }
    }

    // online softmax; every tile holds a key < L, so the max is finite
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float alpha[2], moff[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      alpha[i] = exp2f((m_run[i] - mx[i]) * scale_log2);   // 0 on tile 0
      m_run[i] = mx[i];
      moff[i] = mx[i] * scale_log2;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = exp2f(fmaf(s[j][0], scale_log2, -moff[0]));
      s[j][1] = exp2f(fmaf(s[j][1], scale_log2, -moff[0]));
      s[j][2] = exp2f(fmaf(s[j][2], scale_log2, -moff[1]));
      s[j][3] = exp2f(fmaf(s[j][3], scale_log2, -moff[1]));
      l_run[0] += s[j][0] + s[j][1];
      l_run[1] += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc_o[j][0] *= alpha[0];
      acc_o[j][1] *= alpha[0];
      acc_o[j][2] *= alpha[1];
      acc_o[j][3] *= alpha[1];
    }

    // O += P V: P's accumulators become A fragments, 16 keys per step
    const bf16* vt = sV[buf];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vt + (kk * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * LDS +
                                 np * 16 + (lane >> 4) * 8);
        mma_bf16(acc_o[2 * np], pa, r[0], r[1]);
        mma_bf16(acc_o[2 * np + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();   // the next iteration refills the other buffer
  }

  // epilogue: divide by the row sums, store rows < L as bf16
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / l;
  }
  const long long osl = (long long)H * D;
  bf16* og = o + ((long long)b * L * H + h) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + (lane >> 2) + i * 8;
    if (row >= L) continue;
    bf16* orow = og + row * osl + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<bf162*>(orow + j * 8) = __floats2bfloat162_rn(
          acc_o[j][2 * i] * inv[i], acc_o[j][2 * i + 1] * inv[i]);
  }
}

}  // namespace

// q/k/v: bf16 (B, L, H, 64) with unit stride on the last dim, the other
// strides (in elements) given, every row 16-byte aligned; o: contiguous
// bf16 (B, L, H, 64). scale multiplies q k^T.
extern "C" int tp_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int L, int H, long long qsb,
                                  long long qsl, long long qsh, long long ksb,
                                  long long ksl, long long ksh, long long vsb,
                                  long long vsl, long long vsh, float scale,
                                  void* stream) {
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  flash_attention_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, L, H, qsb, qsl,
      qsh, ksb, ksl, ksh, vsb, vsl, vsh, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
