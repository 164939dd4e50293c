// Flash attention backward for Hopper (K8b): dq, dk, dv of
// o = softmax(scale * q k^T) v from q, k, v, the forward's o and
// log-sum-exp, and do; (B, L, heads, 64) bf16 in and out, float32 inside.
//
// Replaces the library Pallas flash_attention's custom-VJP backward that
// tpupose/ops/attention.py `_flash` reaches through jax.custom_vjp
// (jax/experimental/pallas/ops/tpu/flash_attention.py: `_flash_attention_bwd`
// :254, which computes di = sum(o * do) in XLA at :273, then the dkv kernel
// `_flash_attention_dkv_kernel` :796, pallas_call :1121, and the dq kernel
// `_flash_attention_dq_kernel` :1146, pallas_call :1456; block sizes set in
// tpupose/ops/attention.py:53-56). As in the forward (flash_attention.cu),
// nothing is padded or transposed: q/k/v are read through their strides,
// tiles past L are zero-filled, and rows >= L are not stored.
//
// What bounds it on the H100: at the ViTPose-S shape (B=128, L=197, 6
// heads) the bytes (q, k, v, o, do read once, dq, dk, dv written once:
// 155 MB, 0.046 ms at 3.35 TB/s) outweigh the products (5 products of
// 2 L^2 64 FLOPs per head: 19.1 GFLOP, 0.019 ms at 989 TFLOP/s); at the
// DINOv3 640^2 ViT-B shape (B=16, L=1605, 12 heads) the products bound it
// (316.5 GFLOP, 0.320 ms). Design: three launches, as the library's
// backward is a preprocess and two kernels.
//   1. delta: Delta_i = sum_d do_id * o_id in float32 on the stored bf16 o,
//      one warp per row, into (B, H, L);
//   2. dkv: one block of 4 warps per (64-key tile, head, batch), each warp
//      owning 16 keys whose K and V fragments stay in registers. It streams
//      the 64-query tiles of Q and dO (cp.async, double-buffered,
//      zero-filled past L) and per tile computes S^T = K Q^T in
//      accumulator layout, P^T = exp2(S^T * scale_log2 - lse) with lse
//      indexed by column (+inf for query rows >= L, so that their P is 0
//      whatever the padded scores are), dV += P^T dO, dP^T = V dO^T,
//      dS^T = P^T * (dP^T - Delta) and dK += dS^T Q; dK times scale at the
//      end;
//   3. dq: one block per (64-query tile, head, batch), Q, dO, lse and
//      Delta of its rows in registers; it streams K and V tiles,
//      recomputes S and P (keys >= L set to P = 0), dP = dO V^T,
//      dS = P * (dP - Delta), dQ += dS K; dQ times scale at the end.
// Splitting dq from dkv costs a second recompute of S and P but needs no
// float atomics, so the gradients are deterministic (activation
// checkpointing recomputes a block and must see the same values). All
// products are bf16 mma.sync m16n8k16 with float32 accumulators; P and
// dS are rounded to bf16 as A fragments straight from the accumulators,
// as the forward does with P. The lse is the forward's: log2 domain with
// the scale folded in, so P = exp2(s * scale * log2(e) - lse), while dS
// multiplies dK and dQ by scale itself.
#include <math.h>

#include "mma_bf16.cuh"

namespace {

using namespace fa;

constexpr int ROWS_PER_BLOCK = 8;   // delta: one warp per row

__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
             float* __restrict__ delta, int rows, int L, int H) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;              // row = (b * L + i) * H + h
  const float2 a = __bfloat1622float2(
      reinterpret_cast<const bf162*>(o + (long long)row * D)[lane]);
  const float2 g = __bfloat1622float2(
      reinterpret_cast<const bf162*>(dout + (long long)row * D)[lane]);
  float s = a.x * g.x + a.y * g.y;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = row % H, bi = row / H;
    const int i = bi % L, b = bi / L;
    delta[((long long)b * H + h) * L + i] = s;
  }
}

// lse and Delta of the 64 queries from q0 into shared memory (threads
// 0..63); rows >= L get lse = +inf (P = 0) and Delta = 0.
__device__ __forceinline__ void load_row_stats(float* sl, float* sd,
                                               const float* lse,
                                               const float* delta, int q0,
                                               int L) {
  const int t = threadIdx.x;
  if (t < TILE) {
    const bool valid = q0 + t < L;
    sl[t] = valid ? lse[q0 + t] : INFINITY;
    sd[t] = valid ? delta[q0 + t] : 0.f;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
flash_attention_dkv_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int L, int H, long long qsb, long long qsl,
                           long long qsh, long long ksb, long long ksl,
                           long long ksh, long long vsb, long long vsl,
                           long long vsh, float scale_log2, float scale) {
  __shared__ __align__(16) bf16 sQ[2][TILE * LDS];
  __shared__ __align__(16) bf16 sdO[2][TILE * LDS];
  __shared__ float sL[2][TILE];
  __shared__ float sD[2][TILE];

  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qg = q + b * qsb + h * qsh;
  const bf16* kg = k + b * ksb + h * ksh;
  const bf16* vg = v + b * vsb + h * vsh;
  const long long dsl = (long long)H * D;
  const bf16* dog = dout + ((long long)b * L * H + h) * D;
  const float* lg = lse + ((long long)b * H + h) * L;
  const float* dg = delta + ((long long)b * H + h) * L;

  // prologue: this block's K and V tiles pass through the second buffers
  // into registers; the first query tile goes to the first buffers
  load_tile(sQ[1], kg, ksl, k0, L);
  load_tile(sdO[1], vg, vsl, k0, L);
  load_tile(sQ[0], qg, qsl, 0, L);
  load_tile(sdO[0], dog, dsl, 0, L);
  cp_async_commit();
  load_row_stats(sL[0], sD[0], lg, dg, 0, L);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];    // this warp's 16 keys
  load_a_rows(kf, sQ[1], warp, lane);
  load_a_rows(vf, sdO[1], warp, lane);
  __syncthreads();                          // the second buffers refill

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
  zero(acc_dk);
  zero(acc_dv);
  const int n_tiles = (L + TILE - 1) / TILE;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile(sQ[buf ^ 1], qg, qsl, (t + 1) * TILE, L);
      load_tile(sdO[buf ^ 1], dog, dsl, (t + 1) * TILE, L);
      cp_async_commit();
      load_row_stats(sL[buf ^ 1], sD[buf ^ 1], lg, dg, (t + 1) * TILE, L);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* tl = sL[buf];
    const float* td = sD[buf];

    // S^T = K Q^T: 16 keys x 64 queries per warp; P^T by column's lse
    float p[TILE / 8][4];
    zero(p);
    mma_rows_nt(p, kf, sQ[buf], lane);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const int c = j * 8 + (lane & 3) * 2;
      p[j][0] = exp2f(fmaf(p[j][0], scale_log2, -tl[c]));
      p[j][1] = exp2f(fmaf(p[j][1], scale_log2, -tl[c + 1]));
      p[j][2] = exp2f(fmaf(p[j][2], scale_log2, -tl[c]));
      p[j][3] = exp2f(fmaf(p[j][3], scale_log2, -tl[c + 1]));
    }

    // dV += P^T dO
    mma_acc_nn(acc_dv, p, sdO[buf], lane);

    // dP^T = V dO^T, then dS^T = P^T (dP^T - Delta) in place
    float ds[TILE / 8][4];
    zero(ds);
    mma_rows_nt(ds, vf, sdO[buf], lane);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const int c = j * 8 + (lane & 3) * 2;
      ds[j][0] = p[j][0] * (ds[j][0] - td[c]);
      ds[j][1] = p[j][1] * (ds[j][1] - td[c + 1]);
      ds[j][2] = p[j][2] * (ds[j][2] - td[c]);
      ds[j][3] = p[j][3] * (ds[j][3] - td[c + 1]);
    }

    // dK += dS^T Q
    mma_acc_nn(acc_dk, ds, sQ[buf], lane);
    __syncthreads();   // the next iteration refills the other buffers
  }

  store_rows(dk, acc_dk, scale, scale, b, h, H, L, k0 + warp * 16, lane);
  store_rows(dv, acc_dv, 1.f, 1.f, b, h, H, L, k0 + warp * 16, lane);
}

__global__ void __launch_bounds__(WARPS * 32)
flash_attention_dq_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int L, int H, long long qsb,
                          long long qsl, long long qsh, long long ksb,
                          long long ksl, long long ksh, long long vsb,
                          long long vsl, long long vsh, float scale_log2,
                          float scale) {
  __shared__ __align__(16) bf16 sK[2][TILE * LDS];
  __shared__ __align__(16) bf16 sV[2][TILE * LDS];

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* qg = q + b * qsb + h * qsh;
  const bf16* kg = k + b * ksb + h * ksh;
  const bf16* vg = v + b * vsb + h * vsh;
  const long long dsl = (long long)H * D;
  const bf16* dog = dout + ((long long)b * L * H + h) * D;
  const float* lg = lse + ((long long)b * H + h) * L;
  const float* dg = delta + ((long long)b * H + h) * L;

  // prologue: this block's Q and dO tiles pass through the second buffers
  // into registers; the first key tile goes to the first buffers
  load_tile(sK[1], qg, qsl, q0, L);
  load_tile(sV[1], dog, dsl, q0, L);
  load_tile(sK[0], kg, ksl, 0, L);
  load_tile(sV[0], vg, vsl, 0, L);
  cp_async_commit();
  float row_lse[2], row_delta[2];           // rows lane/4 and lane/4 + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + (lane >> 2) + i * 8;
    row_lse[i] = row < L ? lg[row] : 0.f;   // rows >= L are not stored
    row_delta[i] = row < L ? dg[row] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];   // this warp's 16 queries
  load_a_rows(qf, sK[1], warp, lane);
  load_a_rows(dof, sV[1], warp, lane);
  __syncthreads();                          // the second buffers refill

  float acc_dq[D / 8][4];
  zero(acc_dq);
  const int n_tiles = (L + TILE - 1) / TILE;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile(sK[buf ^ 1], kg, ksl, (t + 1) * TILE, L);
      load_tile(sV[buf ^ 1], vg, vsl, (t + 1) * TILE, L);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T, P = exp2(S * scale_log2 - lse), keys >= L get P = 0
    float p[TILE / 8][4];
    zero(p);
    mma_rows_nt(p, qf, sK[buf], lane);
    const int kt0 = t * TILE;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const int c = kt0 + j * 8 + (lane & 3) * 2;
      p[j][0] = c < L ? exp2f(fmaf(p[j][0], scale_log2, -row_lse[0])) : 0.f;
      p[j][1] = c + 1 < L ? exp2f(fmaf(p[j][1], scale_log2, -row_lse[0]))
                          : 0.f;
      p[j][2] = c < L ? exp2f(fmaf(p[j][2], scale_log2, -row_lse[1])) : 0.f;
      p[j][3] = c + 1 < L ? exp2f(fmaf(p[j][3], scale_log2, -row_lse[1]))
                          : 0.f;
    }

    // dP = dO V^T, then dS = P (dP - Delta) in place
    float ds[TILE / 8][4];
    zero(ds);
    mma_rows_nt(ds, dof, sV[buf], lane);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      ds[j][0] = p[j][0] * (ds[j][0] - row_delta[0]);
      ds[j][1] = p[j][1] * (ds[j][1] - row_delta[0]);
      ds[j][2] = p[j][2] * (ds[j][2] - row_delta[1]);
      ds[j][3] = p[j][3] * (ds[j][3] - row_delta[1]);
    }

    // dQ += dS K
    mma_acc_nn(acc_dq, ds, sK[buf], lane);
    __syncthreads();   // the next iteration refills the other buffers
  }

  store_rows(dq, acc_dq, scale, scale, b, h, H, L, q0 + warp * 16, lane);
}

}  // namespace

// q/k/v: bf16 (B, L, H, 64) with unit stride on the last dim, the other
// strides (in elements) given, every row 16-byte aligned; o, dout, dq,
// dk, dv: contiguous bf16 (B, L, H, 64); lse: the forward's float32
// (B, H, L) log2-domain log-sum-exp (tp_flash_attention); delta: float32
// (B, H, L) scratch. scale multiplies q k^T.
extern "C" int tp_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, int B, int L, int H, long long qsb, long long qsl,
    long long qsh, long long ksb, long long ksl, long long ksh,
    long long vsb, long long vsl, long long vsh, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = B * L * H;
  delta_kernel<<<(rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK,
                 ROWS_PER_BLOCK * 32, 0, s>>>(
      (const bf16*)o, (const bf16*)dout, (float*)delta, rows, L, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid((L + TILE - 1) / TILE, H, B);
  flash_attention_dkv_kernel<<<grid, WARPS * 32, 0, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, L, H,
      qsb, qsl, qsh, ksb, ksl, ksh, vsb, vsl, vsh, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_attention_dq_kernel<<<grid, WARPS * 32, 0, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, L, H, qsb, qsl, qsh,
      ksb, ksl, ksh, vsb, vsl, vsh, scale_log2, scale);
  return (int)cudaGetLastError();
}
