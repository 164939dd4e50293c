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
// place through rank-4 TMA tensor maps over their strided views (a view of
// the qkv projection is taken as it is), rows past L arrive zero-filled,
// and K/V stream through shared memory 64 keys at a time, so L has no
// upper limit.
//
// What bounds it on the H100: at the ViTPose-S shape (B=128, L=197, 6
// heads) the bytes (q, k, v read once, o written once: 77.5 MB, 0.023 ms
// at 3.35 TB/s) outweigh the products (7.6 GFLOP, 0.0077 ms at 989
// TFLOP/s); at the DINOv3 640^2 ViT-B shape (B=16, L=1605, 12 heads) the
// products bound it (126.6 GFLOP, 0.128 ms), and at head dim 64 the
// softmax's exp2 (one per score, on the 16-per-clock MUFU unit) costs as
// many cycles as the two products, so the two warpgroups of a block and
// the two blocks of an SM overlap one's softmax with another's products.
//
// Design (FlashAttention-3's shape): a block of 128 queries of one (batch,
// head) with three roles. One producer warp TMA-loads the block's Q (two
// 64-row tiles) and then each 64-key tile of K and of V into a 3-stage
// ring of shared-memory stages, each with its own "full" mbarrier (K and V
// apart, so that the scores start before V lands) and one "empty" mbarrier
// that the consumers release. Two consumer warpgroups own 64 query rows
// each: S = Q K^T is a wgmma m64n64k16 with Q and K read from shared memory
// (both K-major), the online softmax runs on the float32 accumulators (row
// max and sum over the 4 lanes of a row by shuffles, ex2 with the scale
// folded in, O rescaled only where a row maximum moved), and P, rounded to
// bf16, stays in registers as the A operand of O += P V, a wgmma whose B
// operand is the V tile read MN-major through its descriptor: no transpose
// copy and no trip through shared memory. A last tile with at most 16 keys
// below L (5 at L = 197 and at L = 1605) runs as a 16-wide tail (m64n16k16,
// one 16-deep P V step), not as a masked 64-wide tile. O leaves through
// the warpgroup's Q tile (dead after its last product) by one TMA store,
// which skips the rows past L. At L = 197 a (batch, head) takes 2 blocks
// (the mma.sync design took 4, each reading all of K and V), and 2 blocks
// fit on an SM (90 registers, 65 KB of shared memory each): the four
// warpgroups of an SM overlap one's softmax with another's products.
// (FlashAttention-3's intra-warpgroup pipelining, the scores of tile t
// issued before P V of tile t - 1, needs ~110 registers, so 1 block per
// SM; on the H100 that ran slower at both shapes than this loop at 2.)
//
// For training, the kernel also writes each row's log-sum-exp (float32,
// (B, H, L)), as the library's forward saves l and m for its VJP
// (flash_attention.py:248); the backward (flash_attention_bwd.cu, K8b)
// recomputes P from it, in this kernel's log2 domain with the scale folded
// in: lse = m * scale * log2(e) + log2(l). Serving passes a null pointer and
// runs an instantiation without the store.
#include <math.h>

#include "wgmma_tma.cuh"

namespace {

using namespace wg;

constexpr int D = 64;           // head dim: one 128-byte row per query or key
constexpr int BQ = 128;         // queries per block, 64 per consumer warpgroup
constexpr int BK = 64;          // keys per K/V tile
constexpr int NSTAGE = 3;       // K/V ring depth
constexpr int TILE_B = 64 * D * 2;                       // one 64-row tile, 8 KB
constexpr int THREADS = 2 * 128 + 32;                    // consumers + producer warp
constexpr int OFF_K = 2 * TILE_B;                        // Q: two tiles
constexpr int OFF_V = OFF_K + NSTAGE * TILE_B;
constexpr int OFF_BAR = OFF_V + NSTAGE * TILE_B;
constexpr int SMEM = OFF_BAR + 8 * (1 + 3 * NSTAGE) + 1024;   // + alignment slack

template <bool kLse>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to, float* __restrict__ lse, int L,
                       int H, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + NSTAGE;
  uint64_t* empty = v_full + NSTAGE;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (L + BK - 1) / BK;

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      bar_init(&k_full[s], 1);
      bar_init(&v_full[s], 1);
      bar_init(&empty[s], 8);      // one arrival per consumer warp
    }
    bar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {
    // producer: Q, then the K/V ring in the order the consumers read it
    if (lane == 0) {
      bar_expect_tx(q_full, 2 * TILE_B);
      tma_load_4d(smem, &tq, q_full, 0, h, q0, b);
      tma_load_4d(smem + TILE_B, &tq, q_full, 0, h, q0 + 64, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % NSTAGE;
        bar_wait(&empty[s], ((t / NSTAGE) & 1) ^ 1);
        bar_expect_tx(&k_full[s], TILE_B);
        tma_load_4d(smem + OFF_K + s * TILE_B, &tk, &k_full[s], 0, h, t * BK, b);
        bar_expect_tx(&v_full[s], TILE_B);
        tma_load_4d(smem + OFF_V + s * TILE_B, &tv, &v_full[s], 0, h, t * BK, b);
      }
    }
    return;
  }

  // consumers: warpgroup g owns query rows q0 + 64 g .. + 63
  const int g = warp >> 2, wi = warp & 3;
  const unsigned char* sq = smem + g * TILE_B;
  float acc_o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};   // rows lane/4 and lane/4 + 8
  float l_run[2] = {0.f, 0.f};               // this lane's partial sums
  uint32_t pa[BK / 16][4];                   // P of the tile in hand, bf16

  // online softmax of a tile's scores s (N per thread: N / 4 columns of 8
  // keys from key k0), in place: new row maxima, O and l rescaled, s = P
  auto softmax = [&](auto& s, int k0) {
    constexpr int N = sizeof(s) / sizeof(s[0]);
    if (k0 + 2 * N > L) {                    // mask keys >= L (last tile)
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int c = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        if (c >= L) s[i] = -INFINITY;
      }
    }
    // every tile holds a key < L, so the max is finite
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < N; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float moff[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2((m_run[r] - mx[r]) * scale_log2);   // 0 on tile 0
      m_run[r] = mx[r];
      moff[r] = mx[r] * scale_log2;
      l_run[r] *= alpha[r];
    }
    if (alpha[0] != 1.f || alpha[1] != 1.f) {   // a row maximum moved
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_o[i] *= alpha[(i >> 1) & 1];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s[i] = ex2(fmaf(s[i], scale_log2, -moff[(i >> 1) & 1]));
      l_run[(i >> 1) & 1] += s[i];
    }
  };
  // P as bf16 A fragments, 16 keys each
  auto to_p = [&](const auto& s) {
    constexpr int N = sizeof(s) / sizeof(s[0]);
#pragma unroll
    for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    fence_regs(pa);
  };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[t % NSTAGE]);
  };

  bar_wait(q_full, 0);
  // A last tile with at most 16 keys < L (L = 197 and 1605 leave 5) takes
  // the 16-wide tail below instead of a masked 64-wide tile.
  const int n_full = (L % BK != 0 && L % BK <= 16) ? n_tiles - 1 : n_tiles;
  for (int t = 0; t < n_full; ++t) {
    const int s = t % NSTAGE;
    const uint32_t ph = (t / NSTAGE) & 1;
    const unsigned char* sk = smem + OFF_K + s * TILE_B;
    const unsigned char* sv = smem + OFF_V + s * TILE_B;
    // S = Q K_t^T: 64 rows x 64 keys, K = the head dim in 4 steps of 16
    float sc[32];
    bar_wait(&k_full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss<0>(sc, desc_k(sq + kk * 32), desc_k(sk + kk * 32), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(sc, t * BK);
    fence_regs(acc_o);
    to_p(sc);
    // O += P V_t: V's rows are keys (K), its 64 elements the head dim (N)
    bar_wait(&v_full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) mma_rs<1>(acc_o, pa[kk], desc_mn(sv + kk * 2048));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_o);
    release(t);
  }
  if (n_full < n_tiles) {                    // the tail: 16 keys
    const int t = n_full, s = t % NSTAGE;
    const uint32_t ph = (t / NSTAGE) & 1;
    const unsigned char* sk = smem + OFF_K + s * TILE_B;
    const unsigned char* sv = smem + OFF_V + s * TILE_B;
    float sc[8];
    bar_wait(&k_full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_n16<0>(sc, desc_k(sq + kk * 32), desc_k(sk + kk * 32), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(sc, t * BK);
    fence_regs(acc_o);
    to_p(sc);
    bar_wait(&v_full[s], ph);
    wgmma_fence();
    mma_rs<1>(acc_o, pa[0], desc_mn(sv));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_o);
    release(t);
  }

  // epilogue: divide by the row sums; with kLse, each row's log-sum-exp in
  // the kernel's log2 domain; O as bf16 into this warpgroup's Q tile (dead
  // since its last product), swizzled as the tensor map reads it, then one
  // TMA store of the tile, which skips the rows >= L
  unsigned char* so = smem + g * TILE_B;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int rt = 16 * wi + (lane >> 2) + 8 * r, row = q0 + 64 * g + rt;
    if (kLse && (lane & 3) == 0 && row < L)
      lse[((long long)b * H + h) * L + row] = fmaf(m_run[r], scale_log2, log2f(l));
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(so + rt * 128 + ((j ^ (rt & 7)) << 4) + 4 * (lane & 3)) =
          pack_bf16(acc_o[4 * j + 2 * r] * inv, acc_o[4 * j + 2 * r + 1] * inv);
  }
  fence_async_smem();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");   // this warpgroup
  if (wi == 0 && lane == 0) {
    tma_store_4d(&to, so, 0, h, q0 + 64 * g, b);
    tma_store_wait_read();
  }
}

// rank-4 map over a (B, L, H, 64) view with element strides sb, sl, sh:
// boxes of 64 rows of L for one (batch, head), loaded or stored
int encode_qkv(CUtensorMap* map, const void* p, int B, int L, int H, long long sb, long long sl,
               long long sh) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)L, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)sh * 2, (uint64_t)sl * 2, (uint64_t)sb * 2};
  const uint32_t box[4] = {D, 1, BK, 1};
  return encode_bf16<4>(map, p, dims, strides, box);
}

}  // namespace

// q/k/v: bf16 (B, L, H, 64) with unit stride on the last dim, the other
// strides (in elements) given, multiples of 8, base 16-byte aligned (TMA's
// rules); o: contiguous bf16 (B, L, H, 64); lse: null, or contiguous
// float32 (B, H, L) that receives each row's log2-domain log-sum-exp of
// scale * q k^T (log2(sum_j exp2(scale * log2(e) * s_j))). scale
// multiplies q k^T.
extern "C" int tp_flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                                  int L, int H, long long qsb, long long qsl, long long qsh,
                                  long long ksb, long long ksl, long long ksh, long long vsb,
                                  long long vsl, long long vsh, float scale, void* lse,
                                  void* stream) {
  alignas(64) CUtensorMap tq, tk, tv, to;
  int err = encode_qkv(&tq, q, B, L, H, qsb, qsl, qsh);
  if (!err) err = encode_qkv(&tk, k, B, L, H, ksb, ksl, ksh);
  if (!err) err = encode_qkv(&tv, v, B, L, H, vsb, vsl, vsh);
  if (!err) err = encode_qkv(&to, o, B, L, H, (long long)L * H * D, (long long)H * D, D);
  if (err) return err;
  // serving (no lse) runs an instantiation without the store
  auto kernel = lse ? flash_attention_kernel<true> : flash_attention_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(tq, tk, tv, to, (float*)lse, L, H,
                                                        scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
