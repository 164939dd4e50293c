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
// that the 8 rows an ldmatrix reads fall in distinct banks. The fragment
// helpers are shared with the backward (mma_bf16.cuh).
//
// For training, the kernel also writes each row's log-sum-exp (float32,
// (B, H, L)), as the library's forward saves l and m for its VJP
// (flash_attention.py:248); the backward (flash_attention_bwd.cu, K8b)
// recomputes P from it. Serving passes a null pointer and nothing else
// changes.
#include <math.h>

#include "mma_bf16.cuh"

namespace {

using namespace fa;

constexpr int BQ = TILE;     // queries per block (16 per warp)
constexpr int BK = TILE;     // keys per K/V tile

template <bool kLse>
__global__ void __launch_bounds__(WARPS * 32)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int L, int H, long long qsb,
                       long long qsl, long long qsh, long long ksb,
                       long long ksl, long long ksh, long long vsb,
                       long long vsl, long long vsh, float scale_log2) {
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
  zero(acc_o);
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
    if (t == 0) load_a_rows(qf, sQ, warp, lane);

    // S = Q K^T: 16 rows x 64 keys per warp, 8 key tiles of 8
    float s[BK / 8][4];
    zero(s);
    mma_rows_nt(s, qf, sK[buf], lane);

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
    mma_acc_nn(acc_o, s, sV[buf], lane);
    __syncthreads();   // the next iteration refills the other buffer
  }

  // epilogue: divide by the row sums, store rows < L as bf16; with kLse,
  // each row's log-sum-exp in the kernel's own domain, log2 with the
  // scale folded in: lse = m * scale_log2 + log2(l), so that the backward
  // recomputes P = exp2(s * scale_log2 - lse)
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / l;
    const int row = q0 + warp * 16 + (lane >> 2) + i * 8;
    if (kLse && (lane & 3) == 0 && row < L)
      lse[((long long)b * H + h) * L + row] =
          fmaf(m_run[i], scale_log2, log2f(l));
  }
  store_rows(o, acc_o, inv[0], inv[1], b, h, H, L, q0 + warp * 16, lane);
}

}  // namespace

// q/k/v: bf16 (B, L, H, 64) with unit stride on the last dim, the other
// strides (in elements) given, every row 16-byte aligned; o: contiguous
// bf16 (B, L, H, 64); lse: null, or contiguous float32 (B, H, L) that
// receives each row's log2-domain log-sum-exp of scale * q k^T
// (log2(sum_j exp2(scale * log2(e) * s_j))). scale multiplies q k^T.
extern "C" int tp_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int L, int H, long long qsb,
                                  long long qsl, long long qsh, long long ksb,
                                  long long ksl, long long ksh, long long vsb,
                                  long long vsl, long long vsh, float scale,
                                  void* lse, void* stream) {
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  // serving (no lse) runs an instantiation without the store
  auto kernel = lse ? flash_attention_kernel<true>
                    : flash_attention_kernel<false>;
  kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      L, H, qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
