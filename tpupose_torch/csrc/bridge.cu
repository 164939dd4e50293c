// ResNet-50 block2_0, the bridge from layer1 to layer2, fused, for Hopper:
// conv1 1x1 256->128 + BN + ReLU, conv2 3x3 stride 2 128->128 + BN + ReLU,
// conv3 1x1 128->512 + BN plus the 1x1 stride-2 downsample 256->512 + BN,
// add, ReLU. NHWC bf16 in and out, (B, H, W, 256) -> (B, H/2, W/2, 512),
// BatchNorm folded into the weights (ops/cuda_bridge.fold_bridge_weights),
// float32 accumulation; h1 and h2 round to bf16 where the flax bf16 model
// rounds them, conv3 and the downsample are summed in float32.
//
// Replaces tpupose/ops/pallas_bridge.py `_bridge_kernel` (`bridge_pallas`
// :144, pallas_call :159). The TPU form keeps a whole image in VMEM and
// needs 0/1 selection matmuls for the stride 2 (Mosaic has no strided
// reads); here a block owns an 8 x 8 output tile and its 17 x 17 halo.
//
// What bounds it on the H100: 365 MMAC per 256x192 image over 2.4 MB moved
// (~300 operations per byte, at the bf16 ridge); at B=128, 93.4 GFLOP, 0.094
// ms at 989 TFLOP/s. The earlier design (wmma m8n32k16 on mma.sync, 32-pixel
// tiles, one block per SM) streamed all 736 KB of folded weights from L2
// for every 32 output pixels: 2.3 GB of L2 reads per launch at B=128.
//
// Design: a cluster of 2 blocks, each on one 8 x 8 output tile of one image
// (64 output pixels = one wgmma M tile), each block three roles:
//   - a producer (one thread of a warpgroup that hands its registers to the
//     consumers by setmaxnreg, 40 against 232) issues every load by TMA
//     into two rings of shared-memory stages with "full" and "empty"
//     mbarriers: an activation ring
//     (2 x 40 KB) carrying the 17 x 17 input halo in four 64-channel chunks
//     (zero-filled outside the image by the tensor map) and later the
//     downsample's 8 x 8 centre pixels (a second map over x with doubled
//     pixel strides); and a weight ring (4 x 16 KB) carrying w1, w2, w3 and
//     wds in K-chunks. Each weight stage is multicast to both blocks of the
//     cluster, each block issuing half of it, so every weight byte leaves L2
//     once per 128 output pixels: 736 KB x 768 clusters = 0.57 GB at B=128,
//     a quarter of the earlier design's;
//   - two consumer warpgroups run every product as wgmma m64n64k16, bf16 in,
//     float32 accumulators, weights read MN-major from the stage:
//       conv1: M = 320 (the 289 halo pixels in 5 M tiles), N = 128 split
//         between the warpgroups, K = 256 in 4 chunks; A read K-major from
//         the halo chunk as TMA wrote it. The epilogue (bias, ReLU, zero
//         outside the image: conv2's padding) writes h1 (289 x 128 bf16) to
//         shared memory, 16-byte chunks XOR-swizzled by (pixel / 2) % 8 so
//         that the stride-2 gathers below hit distinct banks;
//       conv2: M = 64, N = 128 split, K = 9 taps x 128 in 18 half-tap
//         stages; A gathered from h1 by ldmatrix (im2col with stride 2: the
//         rows of an M tile are not one strided run, so no descriptor can
//         describe them) and fed from registers. The epilogue writes h2 (64
//         x 128 bf16, in h1's space) swizzled as a K-major wgmma operand;
//       conv3 + downsample: M = 64, N = 512 split (4 x 64 per warpgroup),
//         K = 128 (h2) + 256 (the centre pixels, 4 chunks) in 24 stages of
//         16 rows, one float32 accumulator set, then bias, ReLU and the only
//         write to device memory.
// Shared memory: 80 KB + 64 KB of rings, h1 72 KB: one block per SM.
#include <string.h>

#include "wgmma_tma.cuh"

namespace {

using namespace wg;

constexpr int CIN = 256, CM = 128, COUT = 512;
constexpr int T = 8;                    // output tile T x T
constexpr int HALO = 2 * T + 1;         // 17
constexpr int HP = HALO * HALO;         // 289 halo pixels
constexpr int M1 = 5;                   // conv1 M tiles (320 rows)
constexpr int THREADS = 3 * 128;        // two consumer warpgroups + a producer warpgroup

constexpr int ACT_B = M1 * 64 * 128;    // activation stage: 320 rows of 128 B
constexpr int NACT = 2;
constexpr int HALO_B = HP * 128;        // bytes the halo chunk's TMA writes
constexpr int DS_B = 64 * 128;          // bytes of a centre-pixel chunk
constexpr int W_B = 16384;              // weight stage
constexpr int NW = 4;
constexpr int H1_CHUNK = HP * 128;      // h1: 2 chunks of 64 channels
constexpr int OFF_W = NACT * ACT_B;
constexpr int OFF_H1 = OFF_W + NW * W_B;
constexpr int OFF_BAR = OFF_H1 + 2 * H1_CHUNK;
constexpr int SMEM = OFF_BAR + 8 * 2 * (NACT + NW) + 1024;   // + alignment slack

// weight stages, in the order both rings are consumed
constexpr int NW1 = CIN / 64;           // 4: 64 K-rows x 128
constexpr int NW2 = 9 * CM / 64;        // 18: half a tap, 64 K-rows x 128
constexpr int NW3 = CM / 16;            // 8: 16 K-rows x 512
constexpr int NWD = CIN / 16;           // 16: 16 K-rows x 512

struct Maps {
  CUtensorMap w1, w2, w3, wds;
};

__device__ __forceinline__ void named_sync() {   // the 256 consumer threads
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
bridge_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tds,
              const __grid_constant__ Maps tw, const float* __restrict__ b1,
              const float* __restrict__ b2, const float* __restrict__ b3,
              bf16* __restrict__ out, int H, int W) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* s_act = smem;
  unsigned char* s_w = smem + OFF_W;
  unsigned char* s_h1 = smem + OFF_H1;
  uint64_t* act_full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* act_empty = act_full + NACT;
  uint64_t* w_full = act_empty + NACT;
  uint64_t* w_empty = w_full + NW;

  const int Wo = W / 2, tiles_x = Wo / T;
  const int oy0 = (blockIdx.x / tiles_x) * T, ox0 = (blockIdx.x % tiles_x) * T;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t rank = cluster_rank();

  if (threadIdx.x == 0) {
    for (int s = 0; s < NACT; ++s) {
      bar_init(&act_full[s], 1);
      bar_init(&act_empty[s], 8);          // the 8 consumer warps
    }
    for (int s = 0; s < NW; ++s) {
      bar_init(&w_full[s], 1);
      bar_init(&w_empty[s], 16);           // 8 consumer warps of each block
    }
    bar_init_fence();
  }
  cluster_sync();          // the peer's barriers exist before any multicast

  if (warp >= 8) {
    // ---------------- producer: one thread of warp 8 issues every load ------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      int na = 0, nw = 0;
      auto act_slot = [&](uint32_t bytes) {
        const int s = na % NACT;
        bar_wait(&act_empty[s], ((na / NACT) & 1) ^ 1);
        bar_expect_tx(&act_full[s], bytes);
        ++na;
        return s;
      };
      // one weight stage: `boxes` TMA boxes of (64 N, rows K) from `map`
      // starting at K-row k0, N-block j at offset j * rows * 128; this block
      // issues half of them, multicast to both
      auto w_stage = [&](const CUtensorMap* map, int k0, int rows, int boxes) {
        const int s = nw % NW;
        bar_wait(&w_empty[s], ((nw / NW) & 1) ^ 1);
        bar_expect_tx(&w_full[s], W_B);
        for (int j = rank * boxes / 2; j < (rank + 1) * boxes / 2; ++j)
          tma_load_2d_multicast(s_w + s * W_B + j * rows * 128, map, &w_full[s], 64 * j, k0, 0x3);
        ++nw;
      };
      for (int c = 0; c < NW1; ++c) {
        const int s = act_slot(HALO_B);
        tma_load_4d(s_act + s * ACT_B, &tx, &act_full[s], 64 * c, 2 * ox0 - 1, 2 * oy0 - 1, b);
        w_stage(&tw.w1, 64 * c, 64, 2);
      }
      for (int c = 0; c < NW2; ++c) w_stage(&tw.w2, 64 * c, 64, 2);
      for (int c = 0; c < NW3; ++c) w_stage(&tw.w3, 16 * c, 16, 8);
      for (int c = 0; c < CIN / 64; ++c) {
        const int s = act_slot(DS_B);
        tma_load_4d(s_act + s * ACT_B, &tds, &act_full[s], 64 * c, ox0, oy0, b);
        for (int q = 0; q < 4; ++q) w_stage(&tw.wds, 64 * c + 16 * q, 16, 8);
      }
    }
    __syncwarp();
    cluster_sync();        // no block leaves while its peer may still signal it
    return;
  }

  // ---------------- consumers ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int g = warp >> 2;                 // warpgroup: N half (conv1, conv2, conv3)
  const int wi = warp & 3, r0 = 16 * wi + (lane >> 2), c2 = 2 * (lane & 3);
  int na = 0, nw = 0;
  auto release_w = [&]() {
    __syncwarp();
    if (lane == 0) {
      bar_arrive_cluster(&w_empty[nw % NW], 0);
      bar_arrive_cluster(&w_empty[nw % NW], 1);
    }
    ++nw;
  };
  auto release_act = [&]() {
    __syncwarp();
    if (lane == 0) bar_arrive(&act_empty[na % NACT]);
    ++na;
  };
  auto wait_w = [&]() {
    bar_wait(&w_full[nw % NW], (nw / NW) & 1);
    return s_w + (nw % NW) * W_B;
  };
  auto wait_act = [&]() {
    bar_wait(&act_full[na % NACT], (na / NACT) & 1);
    return s_act + (na % NACT) * ACT_B;
  };

  // conv1: [320 halo rows x 256] @ w1[:, 64 g .. 64 g + 63]
  {
    float acc[M1][32];
#pragma unroll
    for (int i = 0; i < M1; ++i)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
    for (int c = 0; c < NW1; ++c) {
      const unsigned char* a = wait_act();
      const unsigned char* w = wait_w() + g * 8192;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_mn(w + kk * 2048);
#pragma unroll
        for (int i = 0; i < M1; ++i) mma_ss<1>(acc[i], desc_k(a + i * 8192 + kk * 32), db);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < M1; ++i) fence_regs(acc[i]);
      release_act();
      release_w();
    }
    // h1 chunk g: bias, ReLU, zero outside the image; pixel p at row p
    unsigned char* h1 = s_h1 + g * H1_CHUNK;
#pragma unroll
    for (int i = 0; i < M1; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int p = 64 * i + r0 + 8 * hh;
        if (p >= HP) continue;
        const int iy = 2 * oy0 - 1 + p / HALO, ix = 2 * ox0 - 1 + p % HALO;
        const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
        const int sw = (p >> 1) & 7;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * g + 8 * j + c2;
          const float v0 = inside ? fmaxf(acc[i][4 * j + 2 * hh] + b1[col], 0.f) : 0.f;
          const float v1 = inside ? fmaxf(acc[i][4 * j + 2 * hh + 1] + b1[col + 1], 0.f) : 0.f;
          *reinterpret_cast<uint32_t*>(h1 + p * 128 + ((j ^ sw) << 4) + 2 * c2) =
              pack_bf16(v0, v1);
        }
      }
  }
  named_sync();            // both h1 chunks written

  // conv2: [64 out pixels x 9 taps x 128] @ w2[:, 64 g ..]; A by ldmatrix
  {
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    // this lane's ldmatrix row (output pixel) and 8-channel half
    const int m = 16 * wi + (lane & 15), oy = m >> 3, ox = m & 7;
    const int khalf = lane >> 4;
    for (int c = 0; c < NW2; ++c) {
      const int tap = c >> 1, dy = tap / 3, dx = tap % 3;
      const int p = (2 * oy + dy) * HALO + 2 * ox + dx;
      const uint32_t row = smem_u32(s_h1 + (c & 1) * H1_CHUNK + p * 128);
      const int sw = (p >> 1) & 7;
      uint32_t af[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(af[kk], row + (((2 * kk + khalf) ^ sw) << 4));
      const unsigned char* w = wait_w() + g * 8192;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_rs<1>(acc, af[kk], desc_mn(w + kk * 2048));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      release_w();
    }
    named_sync();          // every h1 read done: h2 takes its place
    // h2 chunk g (channels 64 g ..): 64 rows of 128 B, K-major swizzle
    unsigned char* h2 = s_h1 + g * 8192;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * g + 8 * j + c2;
        *reinterpret_cast<uint32_t*>(h2 + r * 128 + ((j ^ (r & 7)) << 4) + 2 * c2) =
            pack_bf16(fmaxf(acc[4 * j + 2 * hh] + b2[col], 0.f),
                      fmaxf(acc[4 * j + 2 * hh + 1] + b2[col + 1], 0.f));
      }
    }
    fence_async_smem();
  }
  named_sync();            // h2 visible to both warpgroups' wgmma

  // conv3 + downsample: [64 x (128 + 256)] @ [w3; wds][:, 256 g .. 256 g + 255]
  float acc[4][32];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[q][e] = 0.f;
  const unsigned char* ds = nullptr;
  for (int c = 0; c < NW3 + NWD; ++c) {    // one 16-deep step per stage
    const unsigned char* a;
    if (c < NW3) {
      a = s_h1 + (c >> 2) * 8192 + (c & 3) * 32;
    } else {
      if (((c - NW3) & 3) == 0) ds = wait_act();
      a = ds + ((c - NW3) & 3) * 32;
    }
    const unsigned char* w = wait_w() + g * 4 * 2048;
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q) mma_ss<1>(acc[q], desc_k(a), desc_mn(w + q * 2048));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < 4; ++q) fence_regs(acc[q]);
    release_w();
    if (c >= NW3 && ((c - NW3) & 3) == 3) release_act();
  }

  // bias (conv3's + the downsample's), ReLU, the block's output
  bf16* ob = out + ((long long)b * (H / 2) + oy0) * Wo * COUT;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    bf16* orow = ob + ((long long)(r >> 3) * Wo + ox0 + (r & 7)) * COUT + 256 * g + c2;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 256 * g + 64 * q + 8 * j + c2;
        *reinterpret_cast<bf162*>(orow + 64 * q + 8 * j) = __floats2bfloat162_rn(
            fmaxf(acc[q][4 * j + 2 * hh] + b3[col], 0.f),
            fmaxf(acc[q][4 * j + 2 * hh + 1] + b3[col + 1], 0.f));
      }
  }
  cluster_sync();
}

int encode_weight(CUtensorMap* map, const void* w, int k, int n, int rows) {
  const uint64_t dims[2] = {(uint64_t)n, (uint64_t)k};
  const uint64_t strides[1] = {(uint64_t)n * 2};
  const uint32_t box[2] = {64, (uint32_t)rows};
  return encode_bf16<2>(map, w, dims, strides, box);
}

}  // namespace

// Tensor maps of the folded weights, encoded once: w1 (256, 128), w2 (3, 3,
// 128, 128) as (1152, 128), w3 (128, 512), wds (256, 512), bf16 row-major
// [K][N], 16-byte aligned; writes sizeof(Maps) = 512 bytes at `maps` (host).
extern "C" int tp_bridge_weight_maps(const void* w1, const void* w2, const void* w3,
                                     const void* wds, void* maps) {
  alignas(64) Maps m;
  int err = encode_weight(&m.w1, w1, CIN, CM, 64);
  if (!err) err = encode_weight(&m.w2, w2, 9 * CM, CM, 64);
  if (!err) err = encode_weight(&m.w3, w3, CM, COUT, 16);
  if (!err) err = encode_weight(&m.wds, wds, CIN, COUT, 16);
  if (!err) memcpy(maps, &m, sizeof(Maps));
  return err;
}

// x (B, H, W, 256) bf16 NHWC, 16-byte aligned; maps from
// tp_bridge_weight_maps; biases float32 (b3 holds the downsample's too);
// out (B, H/2, W/2, 512) bf16. H/2 and W/2 multiples of 8, and the 8 x 8
// tiles of an image an even count (a cluster takes two).
extern "C" int tp_bridge(const void* x, const void* maps, const void* b1, const void* b2,
                         const void* b3, void* out, int B, int H, int W, void* stream) {
  const int Ho = H / 2, Wo = W / 2;
  if (H % 2 || W % 2 || Ho % T || Wo % T || ((Ho / T) * (Wo / T)) % 2)
    return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap tx, tds;
  alignas(64) Maps tw;
  memcpy(&tw, maps, sizeof(Maps));
  const uint64_t dims[4] = {CIN, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t strides[3] = {CIN * 2, (uint64_t)W * CIN * 2, (uint64_t)H * W * CIN * 2};
  const uint32_t box[4] = {64, HALO, HALO, 1};
  int err = encode_bf16<4>(&tx, x, dims, strides, box);
  // the centre pixels x[b, 2i, 2j]: a (B, H/2, W/2, 256) view, doubled strides
  const uint64_t ddims[4] = {CIN, (uint64_t)Wo, (uint64_t)Ho, (uint64_t)B};
  const uint64_t dstrides[3] = {2 * CIN * 2, 2 * (uint64_t)W * CIN * 2,
                                (uint64_t)H * W * CIN * 2};
  const uint32_t dbox[4] = {64, T, T, 1};
  if (!err) err = encode_bf16<4>(&tds, x, ddims, dstrides, dbox);
  if (err) return err;
  cudaError_t e =
      cudaFuncSetAttribute(bridge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Ho / T) * (Wo / T), B);
  bridge_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      tx, tds, tw, (const float*)b1, (const float*)b2, (const float*)b3, (bf16*)out, H, W);
  return (int)cudaGetLastError();
}
