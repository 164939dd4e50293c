// Fused ResNet bottleneck of ResNet-50 layer1 for Hopper: 1x1 -> 3x3 (pad
// 1) -> 1x1, stride 1, BatchNorm folded into weights and biases, ReLU after
// the first two convs, then the residual (identity, or the 1x1 downsample
// conv) added before the last ReLU. NHWC bf16 in and out, float32
// accumulation; h1 and h2 round to bf16 where the flax bf16 model rounds
// them, conv3 and the downsample are summed in float32.
//
// Replaces tpupose/ops/pallas_layer1.py `_layer1_kernel` (`layer1_pallas`
// :193, pallas_call :216): ResNet-50 layer1 = three launches of this kernel
// (variant 0: block 0, 64 -> 64 -> 256 with the downsample; variant 1:
// blocks 1-2, 256 -> 64 -> 256 with identity). The TPU form keeps a whole
// image in VMEM and needs im2col buffers and lane padding; here a block
// owns a 16 x 8 output tile and its 18 x 10 halo.
//
// What bounds it on the H100: layer1 is 654 MMAC per 256x192 image, 1.675e11
// FLOP at B=128 (0.169 ms at 989 TFLOP/s). With three launches each
// 256-channel intermediate makes a round trip through device memory: 50 MB
// read and 5 x 201 MB moved at B=128, 0.315 ms at 3.35 TB/s, the floor of
// this design. The first design (wmma m8n32k16 on mma.sync, 8 x 8 tiles,
// weights staged by cp.async) ran ~60 TFLOP/s and read every weight from L2
// once per 64 output pixels.
//
// Design: persistent clusters of 2 blocks, one cluster per pair of SMs;
// a cluster walks over pairs of 16 x 8 output tiles (128 output pixels =
// two wgmma M tiles a block), so that the loads of the next tile overlap
// the products and the epilogue of this one. Each block has three roles,
// as the bridge kernel (bridge.cu, K3):
//   - a producer (one thread of a warpgroup that hands its registers to the
//     consumers by setmaxnreg) issues every load by TMA into two rings with
//     "full" and "empty" mbarriers, running ahead over the tiles: an
//     activation ring (4 x 23 KB) carrying the 18 x 10 input halo in
//     64-channel chunks (zero-filled outside the image by the tensor map)
//     and, in variant 0, the downsample's 16 x 8 centre pixels; and a
//     weight ring (9 x 8 KB) carrying w1, w2, w3 and wds as 64 (K) x 64 (N)
//     tiles, each multicast to both blocks of the cluster, each block
//     issuing half of it, so every weight byte leaves L2 once per 256
//     output pixels;
//   - two consumer warpgroups run every product as wgmma m64n64k16, bf16
//     in, float32 accumulators, weights read MN-major from the stage, one
//     group kept in flight across stages:
//       conv1: M = 192 (the 180 halo pixels in 3 M tiles: the first
//         warpgroup takes two, the second one; they share the SM's tensor
//         cores, so the split costs no product time), N = 64, K = Cin in
//         64-channel chunks. The epilogue (bias, ReLU, zero outside the
//         image: conv2's padding) writes h1 as three column-shifted copies:
//         copy dx holds halo columns dx .. dx + 7 of every halo row, one
//         1024-byte swizzled atom per halo row;
//       conv2: warpgroup g on output rows 8g .. 8g + 7 (M = 64), K = 9
//         taps x 64. Tap (dy, dx) of those rows is halo rows 8g + dy ..
//         8g + dy + 7 of copy dx: 64 consecutive rows, whole atoms, which
//         one K-major descriptor describes, so A is read straight from
//         shared memory (SS) with no gather. The epilogue writes h2 (128 x
//         64 bf16) as a K-major operand in the place of copy 0;
//       conv3 (+ downsample): M = 64 a warpgroup, N = 256 (4 x 64), K = 64
//         (h2) + 64 (the centre pixels, variant 0), one float32 accumulator
//         set; then bias, the identity (variant 1, read from x), ReLU into
//         the tile's output staged in h1's place (four 128-byte swizzled
//         64-channel boxes), which TMA stores write to device memory: the
//         only write, in whole lines, where 4-byte stores from the
//         accumulator layout left each line to many partial writes.
// Shared memory: 92 KB + 64 KB of rings, h1 (and h2, then the output) 64
// KB: one block per SM.
#include <string.h>

#include <type_traits>

#include "wgmma_tma.cuh"

namespace {

using namespace wg;

constexpr int CM = 64, COUT = 256;
constexpr int TH = 16, TW = 8;              // output tile
constexpr int HH = TH + 2, HW = TW + 2;     // halo 18 x 10
constexpr int HP = HH * HW;                 // 180 halo pixels
constexpr int THREADS = 3 * 128;            // two consumer warpgroups + a producer warpgroup

// an activation slot: the 180 halo rows of 128 B, 1024-aligned; conv1's
// third M tile reads 12 rows past them (garbage rows, never stored)
constexpr int ACT_B = 23 * 1024;
constexpr int NACT = 4;
constexpr int W_B = 64 * 128;               // weight stage: 64 K rows x 64 N bf16
constexpr int NW = 8;
constexpr int H1C = HH * TW * 128;          // one column-shifted copy of h1 (144 rows)
constexpr int OUT_B = TH * TW * COUT * 2;   // the staged output tile, 64 KB
constexpr int OFF_W = NACT * ACT_B;
// h1; h2 (128 rows) takes copy 0's place, then the output tile the whole
constexpr int OFF_H1 = OFF_W + NW * W_B;
constexpr int OFF_BAR = OFF_H1 + (3 * H1C > OUT_B ? 3 * H1C : OUT_B);
constexpr int SMEM = OFF_BAR + 8 * 2 * (NACT + NW) + 1024;   // + alignment slack
static_assert(SMEM <= 232448, "shared memory");

struct Maps {
  CUtensorMap w1, w2, w3, wds;
};

__device__ __forceinline__ void consumer_sync() {   // the 256 consumer threads
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ void warpgroup_sync(int g) {   // one consumer warpgroup
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + g) : "memory");
}

template <int CIN, bool DS>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
bottleneck_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tc,
                  const __grid_constant__ CUtensorMap tout,
                  const __grid_constant__ Maps tw, const float* __restrict__ b1,
                  const float* __restrict__ b2, const float* __restrict__ b3,
                  const bf16* __restrict__ x, int B, int H, int W) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* s_act = smem;
  unsigned char* s_w = smem + OFF_W;
  unsigned char* s_h1 = smem + OFF_H1;
  unsigned char* s_h2 = s_h1;
  unsigned char* s_out = s_h1;
  uint64_t* act_full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* act_empty = act_full + NACT;
  uint64_t* w_full = act_empty + NACT;
  uint64_t* w_empty = w_full + NW;

  // tile pair p of the batch: image p / pairs, tiles 2 (p % pairs) + rank
  const int tiles_x = W / TW, pairs = (H / TH) * tiles_x / 2, npairs = B * pairs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t rank = cluster_rank();
  const int cl = blockIdx.x / 2, ncl = gridDim.x / 2;
  struct Tile {
    int b, oy0, ox0;
  };
  auto tile = [&](int p) {
    const int t = 2 * (p % pairs) + rank;
    return Tile{p / pairs, (t / tiles_x) * TH, (t % tiles_x) * TW};
  };

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
    // ---------------- producer: one thread of warp 8 issues every load, in
    // the order the consumers take them, tile after tile ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      int na = 0, nw = 0;
      auto act = [&](const CUtensorMap* map, uint32_t bytes, int c0, int c1, int c2, int c3) {
        const int s = na % NACT;
        bar_wait(&act_empty[s], ((na / NACT) & 1) ^ 1);
        bar_expect_tx(&act_full[s], bytes);
        tma_load_4d(s_act + s * ACT_B, map, &act_full[s], c0, c1, c2, c3);
        ++na;
      };
      // one 64 x 64 weight tile (N from n0, K rows from k0): this block
      // issues K rows 32 rank .. 32 rank + 31, multicast to both
      auto wtile = [&](const CUtensorMap* map, int n0, int k0) {
        const int s = nw % NW;
        bar_wait(&w_empty[s], ((nw / NW) & 1) ^ 1);
        bar_expect_tx(&w_full[s], W_B);
        tma_load_2d_multicast(s_w + s * W_B + rank * 4096, map, &w_full[s], n0, k0 + 32 * rank,
                              0x3);
        ++nw;
      };
      for (int p = cl; p < npairs; p += ncl) {
        const Tile T = tile(p);
        for (int c = 0; c < CIN / 64; ++c) {
          act(&tx, HP * 128, 64 * c, T.ox0 - 1, T.oy0 - 1, T.b);
          wtile(&tw.w1, 0, 64 * c);
        }
        for (int t = 0; t < 9; ++t) wtile(&tw.w2, 0, 64 * t);
        if (DS) act(&tc, TH * TW * 128, 0, T.ox0, T.oy0, T.b);
        for (int j = 0; j < 4; ++j) {
          wtile(&tw.w3, 64 * j, 0);
          if (DS) wtile(&tw.wds, 64 * j, 0);
        }
      }
    }
    __syncwarp();
    cluster_sync();        // no block leaves while its peer may still signal it
    return;
  }

  // ---------------- consumers ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int g = warp >> 2;
  const int wi = warp & 3, r0 = 16 * wi + (lane >> 2), c2 = 2 * (lane & 3);
  const bool storer = (threadIdx.x & 127) == 0;   // issues the warpgroup's stores
  int na = 0, nw = 0;
  auto wait_w = [&]() {
    bar_wait(&w_full[nw % NW], (nw / NW) & 1);
    return s_w + (nw % NW) * W_B;
  };
  auto release_w = [&](int k) {            // weight stage k, in both blocks
    __syncwarp();
    if (lane == 0) {
      bar_arrive_cluster(&w_empty[k % NW], 0);
      bar_arrive_cluster(&w_empty[k % NW], 1);
    }
  };
  auto wait_act = [&]() {
    bar_wait(&act_full[na % NACT], (na / NACT) & 1);
    return s_act + (na % NACT) * ACT_B;
  };
  auto release_act = [&](int k) {
    __syncwarp();
    if (lane == 0) bar_arrive(&act_empty[k % NACT]);
  };

  for (int p = cl; p < npairs; p += ncl) {
    const Tile T = tile(p);

    // conv1: [192 halo rows x CIN] @ w1 (CIN x 64); warpgroup 0 on M tiles
    // 0 and 1, warpgroup 1 on M tile 2. Each chunk's products stay in
    // flight while the next chunk is waited for.
    auto conv1 = [&](auto nm) {
      constexpr int NM = decltype(nm)::value;
      const int mt0 = g == 0 ? 0 : 2;
      float acc[NM][32];
#pragma unroll
      for (int i = 0; i < NM; ++i)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
      for (int c = 0; c < CIN / 64; ++c, ++na, ++nw) {
        const unsigned char* a = wait_act() + mt0 * 8192;
        const unsigned char* w = wait_w();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = desc_mn(w + kk * 2048);
#pragma unroll
          for (int i = 0; i < NM; ++i) mma_ss<1>(acc[i], desc_k(a + i * 8192 + kk * 32), db);
        }
        wgmma_commit();
        wgmma_wait<1>();
#pragma unroll
        for (int i = 0; i < NM; ++i) fence_regs(acc[i]);
        if (c) {
          release_act(na - 1);
          release_w(nw - 1);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NM; ++i) fence_regs(acc[i]);
      release_act(na - 1);
      release_w(nw - 1);
      if (storer) tma_store_wait_read();
      consumer_sync();     // the last tile's output has left h1's place
      // h1: bias, ReLU, zero outside the image, into every copy that holds
      // the pixel; copy dx row hy * 8 + (hx - dx), 16-byte chunks swizzled
      // by the row's atom position hx - dx
#pragma unroll
      for (int i = 0; i < NM; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int q = 64 * (mt0 + i) + r0 + 8 * hh;
          if (q >= HP) continue;
          const int hy = q / HW, hx = q % HW;
          const int iy = T.oy0 - 1 + hy, ix = T.ox0 - 1 + hx;
          const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 8 * j + c2;
            const float v0 = inside ? fmaxf(acc[i][4 * j + 2 * hh] + b1[col], 0.f) : 0.f;
            const float v1 = inside ? fmaxf(acc[i][4 * j + 2 * hh + 1] + b1[col + 1], 0.f) : 0.f;
            const uint32_t u = pack_bf16(v0, v1);
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const int ox = hx - dx;
              if (ox >= 0 && ox < TW)
                *reinterpret_cast<uint32_t*>(s_h1 + dx * H1C + (hy * TW + ox) * 128 +
                                             ((j ^ ox) << 4) + 2 * c2) = u;
            }
          }
        }
    };
    if (g == 0)
      conv1(std::integral_constant<int, 2>{});
    else
      conv1(std::integral_constant<int, 1>{});
    fence_async_smem();
    consumer_sync();       // h1 complete, visible to wgmma

    // conv2: output rows 8g .. 8g + 7, 9 taps x 64 channels, A straight
    // from the copies
    {
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      for (int t = 0; t < 9; ++t, ++nw) {
        const int dy = t / 3, dx = t % 3;
        const unsigned char* a = s_h1 + dx * H1C + (8 * g + dy) * 1024;
        const unsigned char* w = wait_w();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_ss<1>(acc, desc_k(a + kk * 32), desc_mn(w + kk * 2048));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
        if (t) release_w(nw - 1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release_w(nw - 1);
      consumer_sync();     // every h1 read done: h2 takes copy 0's place
      // h2 rows 64 g .. 64 g + 63 (output pixel oy * 8 + ox), K-major swizzle
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = 64 * g + r0 + 8 * hh;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + c2;
          *reinterpret_cast<uint32_t*>(s_h2 + m * 128 + ((j ^ (m & 7)) << 4) + 2 * c2) =
              pack_bf16(fmaxf(acc[4 * j + 2 * hh] + b2[col], 0.f),
                        fmaxf(acc[4 * j + 2 * hh + 1] + b2[col + 1], 0.f));
        }
      }
      fence_async_smem();
    }
    consumer_sync();       // h2 visible to wgmma

    // conv3 (+ downsample): [64 x (64 + 64)] @ [w3; wds] (N = 256 in 4 x 64)
    float acc[4][32];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[q][e] = 0.f;
    const unsigned char* ctr = nullptr;
    if (DS) ctr = wait_act() + g * 8192;
    const unsigned char* h2 = s_h2 + g * 8192;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int part = 0; part < (DS ? 2 : 1); ++part, ++nw) {
        const unsigned char* a = part ? ctr : h2;
        const unsigned char* w = wait_w();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_ss<1>(acc[q], desc_k(a + kk * 32), desc_mn(w + kk * 2048));
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc[q]);
        if (q || part) release_w(nw - 1);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < 4; ++q) fence_regs(acc[q]);
    release_w(nw - 1);
    if (DS) release_act(na++);

    // bias (conv3's + the downsample's), identity, ReLU -> the staged
    // output: box q (channels 64 q ..) of 128 rows, this warpgroup's 64
    // rows at 8 KB, 128-byte swizzled; h2's rows here are this warpgroup's
    // own, read by its finished products, and the copies are dead
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = 64 * g + r0 + 8 * hh;
      const long long pix = ((long long)T.b * H + T.oy0 + (m >> 3)) * W + T.ox0 + (m & 7);
      const bf16* xrow = x + pix * CIN;   // identity: CIN == COUT
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * q + 8 * j + c2;
          float v0 = acc[q][4 * j + 2 * hh] + b3[col];
          float v1 = acc[q][4 * j + 2 * hh + 1] + b3[col + 1];
          if (!DS) {
            const float2 idn = __bfloat1622float2(*reinterpret_cast<const bf162*>(xrow + col));
            v0 += idn.x;
            v1 += idn.y;
          }
          *reinterpret_cast<uint32_t*>(s_out + q * 16384 + m * 128 + ((j ^ (m & 7)) << 4) +
                                       2 * c2) = pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        }
    }
    fence_async_smem();
    warpgroup_sync(g);
    if (storer)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        tma_store_4d(&tout, s_out + q * 16384 + g * 8192, 64 * q, T.ox0, T.oy0 + 8 * g, T.b);
  }
  if (storer) tma_store_wait_read();
  cluster_sync();
}

// a 2D map over a bf16 [K][N] row-major matrix: boxes of 64 N x 32 K rows
int encode_weight(CUtensorMap* map, const void* w, int k, int n) {
  const uint64_t dims[2] = {(uint64_t)n, (uint64_t)k};
  const uint64_t strides[1] = {(uint64_t)n * 2};
  const uint32_t box[2] = {64, 32};
  return encode_bf16<2>(map, w, dims, strides, box);
}

template <int CIN, bool DS>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           const void* w3, const void* b3, const void* wds, void* out, int B, int H, int W,
           cudaStream_t stream) {
  if (H % TH || W % TW || ((H / TH) * (W / TW)) % 2) return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap tx, tc, tout;
  alignas(64) Maps tw;
  memset(&tw, 0, sizeof(tw));
  // the halo: x as (CIN, W, H, B), boxes of 64 channels x 10 x 18 x 1; the
  // centre pixels (downsample): boxes of 64 channels x 8 x 16 x 1
  const uint64_t dims[4] = {CIN, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t strides[3] = {CIN * 2, (uint64_t)W * CIN * 2, (uint64_t)H * W * CIN * 2};
  const uint32_t hbox[4] = {64, HW, HH, 1};
  const uint32_t cbox[4] = {64, TW, TH, 1};
  int err = encode_bf16<4>(&tx, x, dims, strides, hbox);
  if (!err) err = encode_bf16<4>(&tc, x, dims, strides, cbox);
  // out (COUT, W, H, B): boxes of 64 channels x 8 x 8, a warpgroup's rows
  const uint64_t odims[4] = {COUT, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t ostrides[3] = {COUT * 2, (uint64_t)W * COUT * 2, (uint64_t)H * W * COUT * 2};
  const uint32_t obox[4] = {64, TW, 8, 1};
  if (!err) err = encode_bf16<4>(&tout, out, odims, ostrides, obox);
  if (!err) err = encode_weight(&tw.w1, w1, CIN, CM);
  if (!err) err = encode_weight(&tw.w2, w2, 9 * CM, CM);
  if (!err) err = encode_weight(&tw.w3, w3, CM, COUT);
  if (!err && DS) err = encode_weight(&tw.wds, wds, CIN, COUT);
  if (err) return err;
  auto kernel = bottleneck_kernel<CIN, DS>;
  // one cluster per pair of SMs, as many as can be resident at once
  static int cache[TP_MAX_DEVICES];
  int clusters = 0;
  const cudaError_t e = resident_clusters(kernel, THREADS, SMEM, cache, &clusters);
  if (e != cudaSuccess) return (int)e;
  const int pairs = B * (H / TH) * (W / TW) / 2;
  const dim3 grid(2 * (pairs < clusters ? pairs : clusters));
  kernel<<<grid, THREADS, SMEM, stream>>>(tx, tc, tout, tw, static_cast<const float*>(b1),
                                          static_cast<const float*>(b2),
                                          static_cast<const float*>(b3),
                                          static_cast<const bf16*>(x), B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// variant 0: ResNet-50 layer1 block 0   (64 -> 64 -> 256, downsample)
// variant 1: ResNet-50 layer1 blocks 1-2 (256 -> 64 -> 256, identity)
// Weights bf16 row-major [K][N]: w1 (CIN, 64), w2 (3, 3, 64, 64), w3 (64,
// 256), wds (CIN, 256) (ignored by variant 1); biases float32, b3 already
// holds the downsample's bias. x (B, H, W, CIN), out (B, H, W, 256), bf16
// NHWC. H a multiple of 16, W of 8, with an even count of 16 x 8 tiles per
// image (a cluster takes two). All pointers 16-byte aligned.
extern "C" int tp_bottleneck(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* w3, const void* b3, const void* wds,
                             void* out, int variant, int B, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<64, true>(x, w1, b1, w2, b2, w3, b3, wds, out, B, H, W, s);
    case 1: return launch<256, false>(x, w1, b1, w2, b2, w3, b3, wds, out, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
