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
// nothing is padded or transposed: q/k/v are read in place through rank-4
// TMA tensor maps over their strided views, tiles past L arrive
// zero-filled, and the TMA stores of dq, dk, dv skip the rows >= L.
//
// What bounds it on the H100: at the ViTPose-S shape (B=128, L=197, 6
// heads) the bytes (q, k, v, o, do read once, dq, dk, dv written once:
// 155 MB, 0.046 ms at 3.35 TB/s) outweigh the products (5 products of
// 2 L^2 64 FLOPs per head: 19.1 GFLOP, 0.019 ms at 989 TFLOP/s); at the
// DINOv3 640^2 ViT-B shape (B=16, L=1605, 12 heads) the products bound it
// (316.5 GFLOP, 0.320 ms). The first design (mma.sync m16n8k16 from four
// warps of 16 rows, cp.async into a two-deep ring with a __syncthreads a
// tile, a separate Delta launch) ran at a fifth of the tensor cores' rate;
// this one issues every product as a warpgroup wgmma on tiles that TMA
// delivers, and keeps the shared-memory port free for the streamed
// operands: a 64 x 64 x 16 wgmma with both operands in shared memory reads
// 4 KB in 32 cycles, the port's whole 128 bytes a cycle.
//
// Design: two launches (the library's backward is a preprocess and two
// kernels), each a block of 128 rows of one (batch, head) in K8's roles:
// a producer warp keeps TMA loads of the streamed 64-row tiles in flight
// through a 3-stage ring with "full" and "empty" mbarriers, and two
// consumer warpgroups own 64 rows each.
//   1. dq (first): the block's Q, dO and O tiles are loaded once; each
//      warpgroup computes its rows' Delta_i = sum_d do_id * o_id (float32,
//      on the stored bf16 o) from them and writes it for dkv, which is the
//      preprocess folded in. The loop streams K and V: S = Q K^T and
//      dP = dO V^T (wgmma m64n64k16, Q and dO as A fragments held in
//      registers for the whole loop, ldmatrix'd once, K and V K-major from
//      the stage), P = exp2(S scale log2e - lse[row]) computed while dP is
//      still in flight (keys >= L set to 0 on the last tile), dS = P (dP -
//      Delta[row]), dQ += dS K (RS: dS rounded to bf16 straight from the
//      accumulators as the A operand, K read MN-major); dQ times scale.
//   2. dkv: the block's K and V stay in registers as A fragments; the loop
//      streams Q and dO, and the producer's 32 lanes copy each tile's lse
//      and Delta into the stage (+inf and 0 for queries >= L, so that
//      their P is 0 whatever the padded scores are); the stage is full when
//      the TMA bytes and that arrival are in. Per tile S^T = K Q^T and
//      dP^T = V dO^T (RS), P^T = exp2(S^T scale log2e - lse[query]) while
//      dP^T is in flight, dS^T = P^T (dP^T - Delta[query]), dV += P^T dO
//      and dK += dS^T Q (RS, dO and Q read MN-major); dK times scale. Two
//      64 x 64 float32 accumulators, the tile's S^T and dP^T and the K, V
//      fragments need ~200 registers a consumer thread, more than the 168
//      a 3-warpgroup block gets, so the producer's warpgroup hands its
//      registers over (setmaxnreg 40 / 232).
// Splitting dq from dkv recomputes S and dP (7 products where 5 would do)
// but needs no float atomics, so the gradients are deterministic: the
// same inputs give the same bits (activation checkpointing recomputes a
// block and must see the same values). A last streamed tile with at most
// 16 rows below L (5 at L = 197 and at L = 1605) runs as a 16-wide tail
// (m64n16k16 scores, one 16-deep RS step), not as a masked 64-wide tile,
// as in K8. dk, dv and dq leave through the warpgroup's own K, V or Q tile
// (dead after its last product) by TMA stores that skip the rows >= L.
// The lse is the forward's: log2 domain with the scale folded in, so P =
// exp2(s * scale * log2(e) - lse), while dK and dQ are multiplied by scale
// itself. (Leaving a tile's gradient products in flight into the next
// tile's scores gave wrong gradients on the card wherever the loop ran two
// or more full tiles; cause not isolated.)
#include <math.h>

#include "wgmma_tma.cuh"

namespace {

using namespace wg;

constexpr int D = 64;                 // head dim: one 128-byte row a query or key
constexpr int BM = 128;               // rows a block owns, 64 a consumer warpgroup
constexpr int BN = 64;                // streamed rows a tile
constexpr int NSTAGE = 3;             // ring depth
constexpr int TILE_B = 64 * D * 2;    // one 64-row tile, 8 KB
constexpr int THREADS = 2 * 128 + 32; // dq: consumers + producer warp
constexpr int THREADS_KV = 3 * 128;   // dkv: consumers + a producer warpgroup

// dkv: K (2 tiles), V (2 tiles), the ring of Q, dO, lse and Delta
constexpr int KV_OFF_V = 2 * TILE_B;
constexpr int KV_OFF_Q = 4 * TILE_B;
constexpr int KV_OFF_DO = KV_OFF_Q + NSTAGE * TILE_B;
constexpr int KV_OFF_STAT = KV_OFF_DO + NSTAGE * TILE_B;
constexpr int KV_OFF_BAR = KV_OFF_STAT + NSTAGE * 2 * BN * 4;
constexpr int KV_SMEM = KV_OFF_BAR + 8 * (1 + 2 * NSTAGE) + 1024;   // + alignment slack
// dq: Q (2 tiles), dO (2 tiles), O (2 tiles, for Delta), the ring of K and
// V, each warpgroup's 64 Delta values
constexpr int Q_OFF_DO = 2 * TILE_B;
constexpr int Q_OFF_O = 4 * TILE_B;
constexpr int Q_OFF_K = 6 * TILE_B;
constexpr int Q_OFF_V = Q_OFF_K + NSTAGE * TILE_B;
constexpr int Q_OFF_DELTA = Q_OFF_V + NSTAGE * TILE_B;
constexpr int Q_OFF_BAR = Q_OFF_DELTA + 2 * 64 * 4;
constexpr int Q_SMEM = Q_OFF_BAR + 8 * (1 + 2 * NSTAGE) + 1024;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// the streamed tiles that run 64 wide; a last tile with at most 16 rows
// below L takes the 16-wide tail
__device__ __forceinline__ int full_tiles(int L) {
  const int n = (L + BN - 1) / BN;
  return (L % BN != 0 && L % BN <= 16) ? n - 1 : n;
}

// column (within the tile) of accumulator entry i of this lane
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// accumulators of N columns as bf16 A fragments, 16 columns each
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (&a)[N / 8][4], const float (&s)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  fence_regs(a);
}

// a warpgroup's 64 x 64 accumulator times mul, as bf16, into a tile laid
// out as the tensor map stores it (128-byte swizzle)
__device__ __forceinline__ void acc_to_tile(unsigned char* t, const float (&acc)[32], float mul,
                                            int wi, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rt = 16 * wi + (lane >> 2) + 8 * r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(t + rt * 128 + ((j ^ (rt & 7)) << 4) + 4 * (lane & 3)) =
          pack_bf16(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// this warp's A fragments (its 16 rows, four k16 steps over the head
// dim) of a 64-row tile laid out as TMA writes it (128-byte swizzle)
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], const unsigned char* t,
                                             int wi, int lane) {
  const int r = 16 * wi + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = 2 * kk + (lane >> 4);
    ldmatrix_x4(a[kk], smem_u32(t + r * 128 + ((c ^ (r & 7)) << 4)));
  }
}

__device__ __forceinline__ void zero32(float (&a)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) a[i] = 0.f;
}

__global__ void __launch_bounds__(THREADS_KV, 1)
flash_attention_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tdk,
                           const __grid_constant__ CUtensorMap tdv,
                           const float* __restrict__ lse, const float* __restrict__ delta, int L,
                           int H, float scale_log2, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  float* stat = reinterpret_cast<float*>(smem + KV_OFF_STAT);   // stage s: lse, then Delta
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + KV_OFF_BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + NSTAGE;

  const int k0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (L + BN - 1) / BN;

  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      bar_init(&full[s], 2);       // the TMA bytes' arrival + the lse/Delta copy's
      bar_init(&empty[s], 8);      // one arrival per consumer warp
    }
    bar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // producer: K and V once, then Q, dO, lse and Delta tile by tile, from
    // warp 8 of a warpgroup that hands its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp > 8) return;
    const float* lg = lse + ((long long)b * H + h) * L;
    const float* dg = delta + ((long long)b * H + h) * L;
    if (lane == 0) {
      bar_expect_tx(kv_full, 4 * TILE_B);
      tma_load_4d(smem, &tk, kv_full, 0, h, k0, b);
      tma_load_4d(smem + TILE_B, &tk, kv_full, 0, h, k0 + 64, b);
      tma_load_4d(smem + KV_OFF_V, &tv, kv_full, 0, h, k0, b);
      tma_load_4d(smem + KV_OFF_V + TILE_B, &tv, kv_full, 0, h, k0 + 64, b);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % NSTAGE;
      bar_wait(&empty[s], ((t / NSTAGE) & 1) ^ 1);
      if (lane == 0) {
        bar_expect_tx(&full[s], 2 * TILE_B);
        tma_load_4d(smem + KV_OFF_Q + s * TILE_B, &tq, &full[s], 0, h, t * BN, b);
        tma_load_4d(smem + KV_OFF_DO + s * TILE_B, &tdo, &full[s], 0, h, t * BN, b);
      }
      float* st = stat + s * 2 * BN;
      for (int i = lane; i < BN; i += 32) {
        const int q = t * BN + i;
        st[i] = q < L ? lg[q] : INFINITY;
        st[BN + i] = q < L ? dg[q] : 0.f;
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&full[s]);
    }
    return;
  }

  // consumers: warpgroup g owns keys k0 + 64 g .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int g = warp >> 2, wi = warp & 3;
  unsigned char* sk = smem + g * TILE_B;
  unsigned char* sv = smem + KV_OFF_V + g * TILE_B;
  float acc_dk[32], acc_dv[32];
  zero32(acc_dk);
  zero32(acc_dv);

  // P^T and dS^T of a tile's scores s and dP^T dp (N per thread), in place
  auto grads = [&](auto& s, auto& dp, const float* st) {
    constexpr int N = sizeof(s) / sizeof(s[0]);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = acc_col(i, lane);
      const float p = ex2(fmaf(s[i], scale_log2, -st[c]));
      dp[i] = p * (dp[i] - st[BN + c]);
      s[i] = p;
    }
  };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[t % NSTAGE]);
  };

  bar_wait(kv_full, 0);
  uint32_t kf[D / 16][4], vf[D / 16][4];     // this warp's 16 keys, all the loop
  load_a_frags(kf, sk, wi, lane);
  load_a_frags(vf, sv, wi, lane);
  const int n_full = full_tiles(L);
  for (int t = 0; t < n_full; ++t) {
    const int s = t % NSTAGE;
    const unsigned char* sq = smem + KV_OFF_Q + s * TILE_B;
    const unsigned char* sdo = smem + KV_OFF_DO + s * TILE_B;
    float sc[32], dp[32];
    bar_wait(&full[s], (t / NSTAGE) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) mma_rs<0>(sc, kf[kk], desc_k(sq + kk * 32), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) mma_rs<0>(dp, vf[kk], desc_k(sdo + kk * 32), kk);
    wgmma_commit();
    // P^T while dP^T is still being computed, then dS^T
    const float* st = stat + s * 2 * BN;
    uint32_t pa[BN / 16][4], da[BN / 16][4];
    // this lane's columns come in pairs: 8 j + 2 (lane % 4) + {0, 1}
    float2 sl[BN / 8], sd[BN / 8];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      sl[j] = *reinterpret_cast<const float2*>(st + 8 * j + 2 * (lane & 3));
      sd[j] = *reinterpret_cast<const float2*>(st + BN + 8 * j + 2 * (lane & 3));
    }
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      sc[i] = ex2(fmaf(sc[i], scale_log2, (i & 1) ? -sl[i >> 2].y : -sl[i >> 2].x));
    to_frags<BN / 2>(pa, sc);
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = sc[i] * (dp[i] - ((i & 1) ? sd[i >> 2].y : sd[i >> 2].x));
    to_frags<BN / 2>(da, dp);
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) mma_rs<1>(acc_dv, pa[kk], desc_mn(sdo + kk * 2048));
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) mma_rs<1>(acc_dk, da[kk], desc_mn(sq + kk * 2048));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    release(t);
  }
  if (n_full < n_tiles) {                    // the tail: 16 queries
    const int t = n_full, s = t % NSTAGE;
    const unsigned char* sq = smem + KV_OFF_Q + s * TILE_B;
    const unsigned char* sdo = smem + KV_OFF_DO + s * TILE_B;
    float sc[8], dp[8];
    bar_wait(&full[s], (t / NSTAGE) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n16<0>(sc, desc_k(sk + kk * 32), desc_k(sq + kk * 32), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n16<0>(dp, desc_k(sv + kk * 32), desc_k(sdo + kk * 32), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    grads(sc, dp, stat + s * 2 * BN);
    uint32_t pa[1][4], da[1][4];
    to_frags<8>(pa, sc);
    to_frags<8>(da, dp);
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    wgmma_fence();
    mma_rs<1>(acc_dv, pa[0], desc_mn(sdo));
    mma_rs<1>(acc_dk, da[0], desc_mn(sq));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    release(t);
  }

  // dK (times scale) and dV through this warpgroup's K and V tiles, dead
  // since its last product, then TMA stores that skip the keys >= L
  acc_to_tile(sk, acc_dk, scale, wi, lane);
  acc_to_tile(sv, acc_dv, 1.f, wi, lane);
  fence_async_smem();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");   // this warpgroup
  if (wi == 0 && lane == 0) {
    tma_store_4d(&tdk, sk, 0, h, k0 + 64 * g, b);
    tma_store_4d(&tdv, sv, 0, h, k0 + 64 * g, b);
    tma_store_wait_read();
  }
}

__global__ void __launch_bounds__(THREADS, 1)
flash_attention_dq_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap to,
                          const __grid_constant__ CUtensorMap tdq,
                          const float* __restrict__ lse, float* __restrict__ delta, int L,
                          int H, float scale_log2, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + Q_OFF_BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + NSTAGE;

  const int q0 = blockIdx.x * BM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (L + BN - 1) / BN;

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 8);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {
    // producer: Q and dO once, then the K/V ring
    if (lane == 0) {
      bar_expect_tx(q_full, 6 * TILE_B);
      tma_load_4d(smem, &tq, q_full, 0, h, q0, b);
      tma_load_4d(smem + TILE_B, &tq, q_full, 0, h, q0 + 64, b);
      tma_load_4d(smem + Q_OFF_DO, &tdo, q_full, 0, h, q0, b);
      tma_load_4d(smem + Q_OFF_DO + TILE_B, &tdo, q_full, 0, h, q0 + 64, b);
      tma_load_4d(smem + Q_OFF_O, &to, q_full, 0, h, q0, b);
      tma_load_4d(smem + Q_OFF_O + TILE_B, &to, q_full, 0, h, q0 + 64, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % NSTAGE;
        bar_wait(&empty[s], ((t / NSTAGE) & 1) ^ 1);
        bar_expect_tx(&full[s], 2 * TILE_B);
        tma_load_4d(smem + Q_OFF_K + s * TILE_B, &tk, &full[s], 0, h, t * BN, b);
        tma_load_4d(smem + Q_OFF_V + s * TILE_B, &tv, &full[s], 0, h, t * BN, b);
      }
    }
    return;
  }

  // consumers: warpgroup g owns query rows q0 + 64 g .. + 63
  const int g = warp >> 2, wi = warp & 3;
  unsigned char* sq = smem + g * TILE_B;
  const unsigned char* sdo = smem + Q_OFF_DO + g * TILE_B;
  bar_wait(q_full, 0);
  // Delta of the warpgroup's 64 rows from its O and dO tiles (two threads
  // a row, 32 elements each), into shared memory and, for dkv, which runs
  // after this kernel, to device memory
  float* sdelta = reinterpret_cast<float*>(smem + Q_OFF_DELTA) + 64 * g;
  {
    const int t = 32 * wi + lane, r = t >> 1;
    const unsigned char* so = smem + Q_OFF_O + g * TILE_B;
    float acc = 0.f;
#pragma unroll
    for (int c = 4 * (t & 1); c < 4 * (t & 1) + 4; ++c) {
      const int off = r * 128 + ((c ^ (r & 7)) << 4);
      const uint4 x = *reinterpret_cast<const uint4*>(so + off);
      const uint4 y = *reinterpret_cast<const uint4*>(sdo + off);
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const bf162*>(&xs[e]));
        const float2 d = __bfloat1622float2(*reinterpret_cast<const bf162*>(&ys[e]));
        acc = fmaf(a.x, d.x, acc);
        acc = fmaf(a.y, d.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    const int row = q0 + 64 * g + r;
    if ((t & 1) == 0) {
      sdelta[r] = acc;                       // 0 for rows >= L: their o, do are 0
      if (row < L) delta[((long long)b * H + h) * L + row] = acc;
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");   // this warpgroup
  float row_lse[2], row_delta[2];            // rows lane/4 and lane/4 + 8
  {
    const float* lg = lse + ((long long)b * H + h) * L;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rt = 16 * wi + (lane >> 2) + 8 * r, row = q0 + 64 * g + rt;
      row_lse[r] = row < L ? lg[row] : 0.f;   // rows >= L are not stored
      row_delta[r] = sdelta[rt];
    }
  }
  float acc_dq[32];
  zero32(acc_dq);

  // dS of a tile's scores s and dP dp (N per thread, keys from kt0), in
  // place in dp; keys >= L get P = 0
  auto grads = [&](auto& s, auto& dp, int kt0) {
    constexpr int N = sizeof(s) / sizeof(s[0]);
    const int lim = L - kt0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = (i >> 1) & 1;
      const float p =
          acc_col(i, lane) < lim ? ex2(fmaf(s[i], scale_log2, -row_lse[r])) : 0.f;
      dp[i] = p * (dp[i] - row_delta[r]);
    }
  };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[t % NSTAGE]);
  };

  uint32_t qf[D / 16][4], dof[D / 16][4];    // this warp's 16 queries, all the loop
  load_a_frags(qf, sq, wi, lane);
  load_a_frags(dof, sdo, wi, lane);
  const int n_full = full_tiles(L);
  for (int t = 0; t < n_full; ++t) {
    const int s = t % NSTAGE;
    const unsigned char* sk = smem + Q_OFF_K + s * TILE_B;
    const unsigned char* sv = smem + Q_OFF_V + s * TILE_B;
    float sc[32], dp[32];
    bar_wait(&full[s], (t / NSTAGE) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) mma_rs<0>(sc, qf[kk], desc_k(sk + kk * 32), kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) mma_rs<0>(dp, dof[kk], desc_k(sv + kk * 32), kk);
    wgmma_commit();
    // P while dP is still being computed (keys >= L masked on the last
    // tile only), then dS
    wgmma_wait<1>();
    fence_regs(sc);
    if ((t + 1) * BN > L) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sc[i] = acc_col(i, lane) < L - t * BN
                    ? ex2(fmaf(sc[i], scale_log2, -row_lse[(i >> 1) & 1])) : 0.f;
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = ex2(fmaf(sc[i], scale_log2, -row_lse[(i >> 1) & 1]));
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - row_delta[(i >> 1) & 1]);
    uint32_t da[BN / 16][4];
    to_frags<BN / 2>(da, dp);
    fence_regs(acc_dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) mma_rs<1>(acc_dq, da[kk], desc_mn(sk + kk * 2048));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dq);
    release(t);
  }
  if (n_full < n_tiles) {                    // the tail: 16 keys
    const int t = n_full, s = t % NSTAGE;
    const unsigned char* sk = smem + Q_OFF_K + s * TILE_B;
    const unsigned char* sv = smem + Q_OFF_V + s * TILE_B;
    float sc[8], dp[8];
    bar_wait(&full[s], (t / NSTAGE) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n16<0>(sc, desc_k(sq + kk * 32), desc_k(sk + kk * 32), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n16<0>(dp, desc_k(sdo + kk * 32), desc_k(sv + kk * 32), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    grads(sc, dp, t * BN);
    uint32_t da[1][4];
    to_frags<8>(da, dp);
    fence_regs(acc_dq);
    wgmma_fence();
    mma_rs<1>(acc_dq, da[0], desc_mn(sk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dq);
    release(t);
  }

  // dQ (times scale) through this warpgroup's Q tile, then a TMA store
  acc_to_tile(sq, acc_dq, scale, wi, lane);
  fence_async_smem();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
  if (wi == 0 && lane == 0) {
    tma_store_4d(&tdq, sq, 0, h, q0 + 64 * g, b);
    tma_store_wait_read();
  }
}

// rank-4 map over a (B, L, H, 64) view with element strides sb, sl, sh:
// boxes of 64 rows of L for one (batch, head), loaded or stored
int encode_qkv(CUtensorMap* map, const void* p, int B, int L, int H, long long sb, long long sl,
               long long sh) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)L, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)sh * 2, (uint64_t)sl * 2, (uint64_t)sb * 2};
  const uint32_t box[4] = {D, 1, BN, 1};
  return encode_bf16<4>(map, p, dims, strides, box);
}

}  // namespace

// q/k/v: bf16 (B, L, H, 64) with unit stride on the last dim, the other
// strides (in elements) given, multiples of 8, base 16-byte aligned (TMA's
// rules); o, dout, dq, dk, dv: contiguous bf16 (B, L, H, 64), 16-byte
// aligned; lse: the forward's float32 (B, H, L) log2-domain log-sum-exp
// (tp_flash_attention); delta: float32 (B, H, L) scratch. scale multiplies
// q k^T.
extern "C" int tp_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, int B, int L, int H, long long qsb, long long qsl,
    long long qsh, long long ksb, long long ksl, long long ksh,
    long long vsb, long long vsl, long long vsh, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long csb = (long long)L * H * D, csl = (long long)H * D;
  alignas(64) CUtensorMap tq, tk, tv, to, tdo, tdq, tdk, tdv;
  int err = encode_qkv(&tq, q, B, L, H, qsb, qsl, qsh);
  if (!err) err = encode_qkv(&tk, k, B, L, H, ksb, ksl, ksh);
  if (!err) err = encode_qkv(&tv, v, B, L, H, vsb, vsl, vsh);
  if (!err) err = encode_qkv(&to, o, B, L, H, csb, csl, D);
  if (!err) err = encode_qkv(&tdo, dout, B, L, H, csb, csl, D);
  if (!err) err = encode_qkv(&tdq, dq, B, L, H, csb, csl, D);
  if (!err) err = encode_qkv(&tdk, dk, B, L, H, csb, csl, D);
  if (!err) err = encode_qkv(&tdv, dv, B, L, H, csb, csl, D);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_attention_dkv_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, KV_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_attention_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Q_SMEM);
  if (e != cudaSuccess) return (int)e;

  const float scale_log2 = scale * 1.4426950408889634f;
  const dim3 grid((L + BM - 1) / BM, H, B);
  // dq first: it writes Delta, which dkv reads for every query
  flash_attention_dq_kernel<<<grid, THREADS, Q_SMEM, s>>>(
      tq, tk, tv, tdo, to, tdq, (const float*)lse, (float*)delta, L, H, scale_log2, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_attention_dkv_kernel<<<grid, THREADS_KV, KV_SMEM, s>>>(
      tq, tk, tv, tdo, tdk, tdv, (const float*)lse, (const float*)delta, L, H, scale_log2, scale);
  return (int)cudaGetLastError();
}
