// Fused ResNet stem for Hopper: conv 7x7/2 pad 3 (BatchNorm folded into
// the weights and bias) + ReLU + max-pool 3x3/2 pad 1, NHWC bf16 in and
// out, bf16 tensor-core products (wmma m8n32k16) with float32
// accumulation.
//
// Replaces the TPU kernel tpupose/ops/pallas_stem.py `_stem_kernel`
// (called by `stem_pool_pallas`). The TPU form needs a 4x4 space-to-depth
// of the input, phase matmuls and 128-lane padding because Mosaic has no
// strided loads; none of that is needed here.
//
// What bounds it on the H100: 115.6 MMAC per 256x192 image against 0.69 MB
// of bytes moved, i.e. ~335 operations per byte, just above the bf16
// ridge (~295), so the tensor cores bound it in principle.
//
// Design: an implicit GEMM with no im2col copy. The block's input tile
// is stored with 4 channels per pixel (the 4th zero), so for one kernel
// row ky the 7x4 taps (kx, c) of 8 horizontally adjacent conv outputs are
// 8 rows of a matrix with a row stride of 2 pixels = 8 elements: a wmma A
// fragment read straight from the tile (kx = 7 is a zero weight row). The
// weights are [ky][kx*4 + c][64], so the conv is 7 x 2 k-steps per
// fragment. A tile is 4x8 pooled outputs = 9 conv rows x 17 conv columns,
// computed as 9 x 24 (3 fragments per row; the 7 extra columns are
// discarded). Conv outputs get bias + ReLU and are rounded to bf16 in
// shared memory, then max-pooled. The conv's padding is exact zeros; the
// pool's padding is -inf in the reference, but every pooled value is a max
// over at least one post-ReLU value >= 0, so a zero pool pad (and a zero
// start value) gives the same result. Blocks loop over tiles, so each
// block stages the weights once. Only the pooled output is written to
// device memory.
#include "common.cuh"
#include "wmma_tiles.cuh"

namespace {

constexpr int PH = 4, PW = 8;          // pooled outputs per tile
constexpr int CH = 2 * PH + 1;         // conv rows per tile (9)
constexpr int CW = 2 * PW + 1;         // conv columns used per tile (17)
constexpr int CWF = 24;                // conv columns computed (3 fragments)
constexpr int IH = 2 * CH + 5;         // input rows per tile (23)
constexpr int IW = 2 * CWF + 8;        // input columns per tile (56)
constexpr int CI = 4;                  // channels per stored pixel (3 + zero)
constexpr int CO = 64;                 // output channels
constexpr int KR = 32;                 // weight rows per ky: kx * 4 + c, kx < 8
constexpr int LDB = CO + 16;           // weight row stride (padded)
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int MFR = CH * (CWF / 8);    // 27 fragments of 8 conv outputs

constexpr size_t IN_BYTES = ((size_t)IH * IW * CI * 2 + 127) / 128 * 128;
constexpr size_t W_BYTES = (size_t)7 * KR * LDB * 2;
constexpr size_t C_BYTES = ((size_t)CH * CW * CO * 2 + 127) / 128 * 128;
constexpr size_t SCR_BYTES = (size_t)NWARPS * 8 * 32 * 4;
constexpr size_t SMEM = IN_BYTES + W_BYTES + C_BYTES + SCR_BYTES;
static_assert(W_BYTES % 128 == 0 && (IW * CI * 2) % 32 == 0, "align");

__global__ void __launch_bounds__(THREADS, 2)
stem_pool_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ bias, bf16* __restrict__ out,
                 int B, int H, int W, int Hc, int Wc, int Hp, int Wp) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_in = reinterpret_cast<bf16*>(smem);
  bf16* s_w = reinterpret_cast<bf16*>(smem + IN_BYTES);
  bf16* s_c = reinterpret_cast<bf16*>(smem + IN_BYTES + W_BYTES);
  float* s_scr = reinterpret_cast<float*>(smem + IN_BYTES + W_BYTES + C_BYTES);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* scr = s_scr + warp * 8 * 32;
  const bf16 zero = __float2bfloat16(0.f);

  // weights [ky][kx*4 + c][o], zero rows for c = 3 and kx = 7
  for (int i = tid; i < 7 * KR * CO; i += THREADS) {
    const int o = i % CO, r = (i / CO) % KR, ky = i / (CO * KR);
    const int kx = r / CI, c = r % CI;
    s_w[(ky * KR + r) * LDB + o] =
        (kx < 7 && c < 3) ? w[((ky * 7 + kx) * 3 + c) * CO + o] : zero;
  }

  const int tiles_x = (Wp + PW - 1) / PW, tiles_y = (Hp + PH - 1) / PH;
  const int n_tiles = B * tiles_y * tiles_x;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / (tiles_y * tiles_x);
    const int py0 = (tile / tiles_x) % tiles_y * PH, px0 = tile % tiles_x * PW;
    const int cy0 = 2 * py0 - 1, cx0 = 2 * px0 - 1;   // conv tile origin
    const int iy0 = 2 * cy0 - 3, ix0 = 2 * cx0 - 3;   // input tile origin
    const bf16* xb = x + (size_t)b * H * W * 3;

    __syncthreads();                   // previous tile done with s_in, s_c
    for (int p = tid; p < IH * IW; p += THREADS) {
      const int iy = iy0 + p / IW, ix = ix0 + p % IW;
      union {
        uint2 u;
        bf16 h[CI];
      } px;
      px.u = make_uint2(0u, 0u);
      if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
        const bf16* src = xb + ((size_t)iy * W + ix) * 3;
        px.h[0] = src[0];
        px.h[1] = src[1];
        px.h[2] = src[2];
      }
      *reinterpret_cast<uint2*>(s_in + p * CI) = px.u;
    }
    __syncthreads();

    // task = one fragment of 8 conv outputs (row qy, columns qx0..qx0+7)
    // x all 64 channels
    for (int t = warp; t < MFR; t += NWARPS) {
      const int qy = t / (CWF / 8), qx0 = t % (CWF / 8) * 8;
      FragC acc[1][2];
      wmma::fill_fragment(acc[0][0], 0.f);
      wmma::fill_fragment(acc[0][1], 0.f);
#pragma unroll
      for (int ky = 0; ky < 7; ++ky)
        warp_gemm<1, 2, KR / 16>(acc, s_in + ((2 * qy + ky) * IW + 2 * qx0) * CI, 2 * CI, 0,
                                 s_w + ky * KR * LDB, LDB);
#pragma unroll
      for (int n = 0; n < 2; ++n)
        epilogue(acc[0][n], scr, lane, [&](int r, int cc, float a0, float a1) {
          const int qx = qx0 + r, col = n * 32 + cc;
          if (qx >= CW) return;
          const int cy = cy0 + qy, cx = cx0 + qx;
          float v0 = 0.f, v1 = 0.f;      // outside the conv map: the pool's pad
          if (cy >= 0 && cy < Hc && cx >= 0 && cx < Wc) {
            v0 = fmaxf(a0 + bias[col], 0.f);
            v1 = fmaxf(a1 + bias[col + 1], 0.f);
          }
          *reinterpret_cast<bf162*>(s_c + (qy * CW + qx) * CO + col) =
              __floats2bfloat162_rn(v0, v1);
        });
    }
    __syncthreads();

    const int cp = lane, pg = warp;    // channel pair, position group
    for (int i = pg; i < PH * PW; i += NWARPS) {
      const int py = i / PW, px = i % PW;
      const int gy = py0 + py, gx = px0 + px;
      if (gy >= Hp || gx >= Wp) continue;
      float m0 = 0.f, m1 = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const bf162*>(
              s_c + ((2 * py + dy) * CW + 2 * px + dx) * CO + 2 * cp));
          m0 = fmaxf(m0, v.x);
          m1 = fmaxf(m1, v.y);
        }
      *reinterpret_cast<bf162*>(out + (((size_t)b * Hp + gy) * Wp + gx) * CO + 2 * cp) =
          __floats2bfloat162_rn(m0, m1);
    }
  }
}

}  // namespace

// x (B, H, W, 3) bf16 NHWC; w (7, 7, 3, 64) bf16 HWIO with BN folded in;
// bias (64,) float32; out (B, Hp, Wp, 64) bf16 with Hc = (H-1)/2+1,
// Hp = (Hc-1)/2+1 (likewise for widths).
extern "C" int tp_stem_pool(const void* x, const void* w, const void* bias,
                            void* out, int B, int H, int W, void* stream) {
  const int Hc = (H - 1) / 2 + 1, Wc = (W - 1) / 2 + 1;
  const int Hp = (Hc - 1) / 2 + 1, Wp = (Wc - 1) / 2 + 1;
  cudaError_t e = cudaFuncSetAttribute(
      stem_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_pool_kernel, THREADS,
                                                         SMEM)) != cudaSuccess)
    return (int)e;
  const long n_tiles = (long)B * ((Hp + PH - 1) / PH) * ((Wp + PW - 1) / PW);
  const int grid = (int)(n_tiles < (long)sms * per_sm ? n_tiles : (long)sms * per_sm);
  stem_pool_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), B, H, W, Hc, Wc, Hp, Wp);
  return (int)cudaGetLastError();
}
