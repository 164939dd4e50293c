// int8 transposed conv 4x4 / stride 2 / padding 1 (torch ConvTranspose2d)
// with BatchNorm folded, ReLU and requantization, for Hopper; optionally
// with the SimpleBaseline's final 1x1 heatmap conv fused behind it.
//
// Replaces the TPU kernel tpupose/ops/pallas_head.py `_deconv_kernel`
// (called by `run_deconv`). A stride-2 transposed conv splits into four
// output phases (p, q); phase (p, q) at input position (i, j) is one
// (4*Cin)-deep product over the 2x2 shifted inputs (i+my, j+mx), my in
// {p-1, p}, mx in {q-1, q}, with the phase's own int8 weights and requant
// scale vector (ops/cuda_head.py fold_deconv). The TPU interleaves the
// phases with 0/1 selector matmuls because Mosaic has no strided stores;
// here each phase's pixels are stored straight to (2i+p, 2j+q).
//
// What bounds it on the H100: deconv0 (8x6x2048 -> 16x12x256) is 403 MMAC
// per image over 8.4 MB of weights, deconv1 201 MMAC, deconv2 + final
// 819 MMAC; at B=128 all three are bound by the int8 products (0.05, 0.03
// and 0.11 ms at 1979 TOP/s). The first design ran mma.sync m16n8k32 from 8
// warps with every operand staged by cp.async through a per-row address
// computation, ~86 TOP/s. This one issues every product as an int8
// warpgroup wgmma (m64n128k32, and m64n32k32 for the final conv) on
// operands that TMA writes into shared memory.
//
// Design: a work item is 192 GEMM rows, TH whole input rows of NI images
// (TH * w * NI <= 192: deconv0 4 images of 8 x 6, deconv1 one image of
// 16 x 12, deconv2 8 of the 32 rows of 24), one phase and 128 output
// channels; with the final conv, every output channel in two passes.
// Persistent blocks, one per SM, walk over the items, so that the loads
// of the next item overlap the epilogue of this one. The phase varies
// fastest, so the four phases of a tile run together: they read the same
// input, and their output pixels interleave in device memory. Three
// roles, as in the int8 bottleneck (int8_bottleneck.cu):
//   - a producer warpgroup (one thread issues; the warpgroup hands its
//     registers to the consumers by setmaxnreg) fills a ring of 4 stages
//     with "full" and "empty" mbarriers. A stage is 128 K bytes of A and
//     of W. A: one 4D TMA box of x (128 channels x w x TH x NI), offset by
//     the K chunk's shift (my, mx); the tensor map zero-fills outside the
//     image, so the rows arrive in GEMM order, K-major and 128-byte
//     swizzled, with the transposed conv's zero padding. W: a box of the
//     phase's (O, 4 Cin) int8 weights, K-major as 8-bit wgmma needs;
//   - three consumer warpgroups, one 64-row M tile each, issue SS wgmma
//     with one group in flight across stages. The epilogue computes
//     rq(acc * mv + bv) and writes the int8 result, 128-byte swizzled, to
//     a staging tile in shared memory. Without the final conv, one TMA
//     store moves it to the output through a map that views it as (O, q,
//     w, p, B h), which places every pixel at (2i+p, 2j+q). With it, the
//     two passes' tiles are the A operand (K = O) of the final conv, whose
//     int8 weights (KP = 32 rows, K-major) a TMA load brought at the
//     start; only the float32 heatmaps (B, 2h, 2w, KF) reach device memory,
//     as in the TPU kernel.
// Epilogues use __fmul_rn / __fadd_rn / rintf in the order of the plain
// version (ops/cuda_head.py deconv_reference): bit-equal to it. The host's
// tile (TH, NI) comes from ops/cuda_head.py deconv_tile, and
// `_smem_bytes` there mirrors smem_bytes here.
#include <string.h>

#include "wgmma_tma.cuh"

namespace {

using namespace wg;

constexpr int THREADS = 4 * 128;     // three consumer warpgroups + a producer warpgroup
constexpr int BM = 192;              // GEMM rows a block: three 64-row M tiles
constexpr int BN = 128;              // output channels a pass
constexpr int KB = 128;              // K bytes a stage
constexpr int A_B = BM * KB;         // 24 KB
constexpr int W_B = BN * KB;         // 16 KB
constexpr int STAGE_B = A_B + W_B;   // 40 KB
constexpr int NS = 4;                // ring depth
constexpr int Y_B = BM * KB;         // one pass's int8 output tile
constexpr int KPF = 32;              // final conv width (KP)
constexpr int OFF_Y = NS * STAGE_B;
constexpr int SMEM_LIMIT = 232448;

struct Params {
  const float *mv, *bv, *mf, *bf;   // mv (4, O), bv (O,), mf, bf (KP,)
  float* out32;                      // (B, 2h, 2w, KF) with the final conv
  int B, h, w, Cin, O, KF, TH, NI, fin;
};

// Dynamic shared memory (ops/cuda_head.py `_smem_bytes` computes the same):
// the ring, the output tiles (one, or O / 128 with the final conv), the
// final conv's weights, the barriers, 1024 bytes of alignment slack.
size_t smem_bytes(int O, bool fin) {
  const size_t y = (size_t)(fin ? O / BN : 1) * Y_B;
  const size_t wf = fin ? (size_t)KPF * O : 0;
  return OFF_Y + y + wf + 8 * (2 * NS + 1) + 1024;
}

// The requantization of the TPU kernels: clip(round(max(v, 0)), 0, 127),
// round half to even.
__device__ __forceinline__ int rq(float v) { return (int)fminf(rintf(fmaxf(v, 0.f)), 127.f); }

// acc * m + b as two rounded float32 operations (no fused multiply-add),
// in the order of the plain version.
__device__ __forceinline__ float affine(int acc, float m, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), m), b);
}

__device__ __forceinline__ void consumer_sync() {   // the 384 consumer threads
  asm volatile("bar.sync 1, 384;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
int8_deconv_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap twf,
                   const __grid_constant__ CUtensorMap tout, const Params P) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int NT = P.fin ? P.O / BN : 1;          // passes of an item
  unsigned char* s_y = smem + OFF_Y;
  unsigned char* s_wf = s_y + NT * Y_B;
  uint64_t* full = reinterpret_cast<uint64_t*>(s_wf + (P.fin ? KPF * P.O : 0));
  uint64_t* empty = full + NS;
  uint64_t* wf_full = empty + NS;

  // item k: phase k % 4, then the 128-channel block (without the final
  // conv), then the M tile: TH input rows i0.. of NI images b0..
  const int tiles_y = P.h / P.TH, nblk = P.fin ? 1 : P.O / BN;
  const int items = 4 * nblk * tiles_y * ((P.B + P.NI - 1) / P.NI);
  struct Item {
    int ph, p, q, nt0, i0, b0;
  };
  auto item = [&](int k) {
    const int ph = k & 3, nt0 = (k >> 2) % nblk, mt = (k >> 2) / nblk;
    return Item{ph, ph >> 1, ph & 1, nt0, (mt % tiles_y) * P.TH, (mt / tiles_y) * P.NI};
  };
  const int rows = P.TH * P.w * P.NI;           // GEMM rows the A boxes fill
  const int KC = 4 * P.Cin / KB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 12);               // the 12 consumer warps
    }
    bar_init(wf_full, 1);
    bar_init_fence();
  }
  __syncthreads();

  if (warp >= 12) {
    // ---------------- producer: one thread issues every load, item after
    // item ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 12 && lane == 0) {
      if (P.fin) {
        bar_expect_tx(wf_full, KPF * P.O);
        for (int c = 0; c < P.O / KB; ++c)
          tma_load_2d(s_wf + c * KPF * KB, &twf, wf_full, KB * c, 0);
      }
      int n = 0;
      for (int k = blockIdx.x; k < items; k += gridDim.x) {
        const Item I = item(k);
        for (int nt = I.nt0; nt < I.nt0 + NT; ++nt)
          for (int kc = 0; kc < KC; ++kc, ++n) {
            const int s = n % NS;
            bar_wait(&empty[s], ((n / NS) & 1) ^ 1);
            bar_expect_tx(&full[s], rows * KB + W_B);
            const int k0 = KB * kc, bi = k0 / P.Cin, c0 = k0 - bi * P.Cin;
            const int my = I.p - 1 + (bi >> 1), mx = I.q - 1 + (bi & 1);
            unsigned char* st = smem + s * STAGE_B;
            tma_load_4d(st, &tx, &full[s], c0, mx, I.i0 + my, I.b0);
            tma_load_2d(st + A_B, &tw, &full[s], k0, I.ph * P.O + BN * nt);
          }
      }
    }
    return;
  }

  // ---------------- consumers: warpgroup g on GEMM rows 64 g .. 64 g + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n" ::: "memory");
  const int g = warp >> 2, wi = warp & 3;
  const int r0 = 16 * wi + (lane >> 2), c2 = 2 * (lane & 3);   // accumulator rows r0, r0 + 8
  auto release = [&](int n) {
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[n % NS]);
  };

  int n = 0;
  for (int k = blockIdx.x; k < items; k += gridDim.x) {
    const Item I = item(k);
    for (int t = 0; t < NT; ++t) {
      const int nt = I.nt0 + t;
      int acc[BN / 2];
      for (int kc = 0; kc < KC; ++kc, ++n) {
        const int s = n % NS;
        bar_wait(&full[s], (n / NS) & 1);
        const unsigned char* a = smem + s * STAGE_B + g * 8192;
        const unsigned char* w = smem + s * STAGE_B + A_B;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk)
          mma_s8_ss<BN>(acc, desc_k(a + 32 * kk), desc_k(w + 32 * kk), kc | kk);
        wgmma_commit();
        wgmma_wait<1>();               // the previous stage's products are done
        fence_regs(acc);
        if (kc) release(n - 1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(n - 1);
      if (t == 0) {
        // the last item's output tiles have been read (its TMA store, or
        // every warpgroup's final conv)
        if (threadIdx.x == 0) tma_store_wait_read();
        consumer_sync();
      }

      // rq(acc * mv + bv) -> the pass's int8 tile, rows of 128 channels,
      // 128-byte swizzled (what the TMA store and a K-major operand read)
      const float* mv = P.mv + (size_t)I.ph * P.O + BN * nt;
      const float* bv = P.bv + BN * nt;
      unsigned char* y = s_y + t * Y_B;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = 64 * g + r0 + 8 * hh;
        unsigned char* row = y + m * KB;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int c = 8 * j + c2;
          const int v0 = rq(affine(acc[4 * j + 2 * hh], mv[c], bv[c]));
          const int v1 = rq(affine(acc[4 * j + 2 * hh + 1], mv[c + 1], bv[c + 1]));
          *reinterpret_cast<char2*>(row + (((j >> 1) ^ (m & 7)) << 4) + 8 * (j & 1) + c2) =
              make_char2((signed char)v0, (signed char)v1);
        }
      }
    }
    fence_async_smem();
    consumer_sync();                 // every output tile written and visible to TMA / wgmma

    if (!P.fin) {
      // pixel (b, 2i+p, 2j+q): coordinates (channel, q, j, p, b h + i)
      if (threadIdx.x == 0)
        tma_store_5d(&tout, s_y, BN * I.nt0, I.q, 0, I.p, I.b0 * P.h + I.i0);
      continue;
    }

    // the final 1x1 conv: [192 rows x O] @ wf^T (KP x O), float32 out
    bar_wait(wf_full, 0);
    int accf[KPF / 2];
    wgmma_fence();
    for (int c = 0; c < P.O / KB; ++c)
#pragma unroll
      for (int kk = 0; kk < KB / 32; ++kk)
        mma_s8_ss<KPF>(accf, desc_k(s_y + c * Y_B + g * 8192 + 32 * kk),
                       desc_k(s_wf + c * KPF * KB + 32 * kk), c | kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(accf);
    const int per_img = P.TH * P.w;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = 64 * g + r0 + 8 * hh;
      const int b = I.b0 + m / per_img, rem = m % per_img;
      if (m >= rows || b >= P.B) continue;
      const int i = I.i0 + rem / P.w, j = rem % P.w;
      float* o = P.out32 + (((size_t)b * 2 * P.h + 2 * i + I.p) * 2 * P.w + 2 * j + I.q) * P.KF;
#pragma unroll
      for (int jj = 0; jj < KPF / 8; ++jj) {
        const int c = 8 * jj + c2;
        if (c < P.KF) o[c] = affine(accf[4 * jj + 2 * hh], P.mf[c], P.bf[c]);
        if (c + 1 < P.KF) o[c + 1] = affine(accf[4 * jj + 2 * hh + 1], P.mf[c + 1], P.bf[c + 1]);
      }
    }
  }
  if (threadIdx.x == 0) tma_store_wait_read();
}

}  // namespace

// One int8 transposed conv. x (B, h, w, Cin) int8 NHWC; w (4, O, 4*Cin)
// int8, phase ph = 2p+q, k = (2*sy+sx)*Cin + c for shifts (p-1+sy,
// q-1+sx); mv (4, O) and bv (O,) float32. Without the final conv (wf
// null): out (B, 2h, 2w, O) int8. With it: wf (KP, O) int8 with KP = 32
// (rows past KF zero), mf, bf (KP,) float32, out (B, 2h, 2w, KF) float32.
// A work item takes TH whole input rows of NI images: TH | h, NI > 1 only
// where TH == h, TH * w * NI <= 192. Cin and O multiples of 128 (O at most
// 256 with the final conv); pointers 16-byte aligned.
extern "C" int tp_int8_deconv(const void* x, const void* w, const void* mv, const void* bv,
                              const void* wf, const void* mf, const void* bf, void* out,
                              int B, int h, int w_, int Cin, int O, int KF, int KP, int TH,
                              int NI, void* stream) {
  Params P;
  P.mv = static_cast<const float*>(mv);
  P.bv = static_cast<const float*>(bv);
  P.mf = static_cast<const float*>(mf);
  P.bf = static_cast<const float*>(bf);
  P.fin = wf != nullptr;
  P.out32 = P.fin ? static_cast<float*>(out) : nullptr;
  P.B = B;
  P.h = h;
  P.w = w_;
  P.Cin = Cin;
  P.O = O;
  P.KF = KF;
  P.TH = TH;
  P.NI = NI;
  const size_t smem = smem_bytes(O, P.fin);
  if (B < 1 || Cin % KB || O % BN || TH < 1 || NI < 1 || h % TH || w_ > 256 ||
      (NI > 1 && TH != h) || TH * w_ * NI > BM || smem > SMEM_LIMIT ||
      (P.fin && (KP != KPF || KF < 1 || KF > KP)))
    return (int)cudaErrorInvalidValue;

  alignas(64) CUtensorMap tx, tw, twf, tout;
  // x as (Cin, w, h, B): boxes of 128 channels x w x TH x NI
  const uint64_t xd[4] = {(uint64_t)Cin, (uint64_t)w_, (uint64_t)h, (uint64_t)B};
  const uint64_t xs[3] = {(uint64_t)Cin, (uint64_t)w_ * Cin, (uint64_t)h * w_ * Cin};
  const uint32_t xb[4] = {KB, (uint32_t)w_, (uint32_t)TH, (uint32_t)NI};
  int err = encode_s8<4>(&tx, x, xd, xs, xb);
  // the weights as a (4 O, 4 Cin) matrix: boxes of 128 K bytes x 128 rows
  const uint64_t wd[2] = {(uint64_t)4 * Cin, (uint64_t)4 * O};
  const uint64_t ws[1] = {(uint64_t)4 * Cin};
  const uint32_t wb[2] = {KB, BN};
  if (!err) err = encode_s8<2>(&tw, w, wd, ws, wb);
  if (!err && P.fin) {
    const uint64_t fd[2] = {(uint64_t)O, (uint64_t)KPF};
    const uint64_t fs[1] = {(uint64_t)O};
    const uint32_t fb[2] = {KB, KPF};
    err = encode_s8<2>(&twf, wf, fd, fs, fb);
    tout = tx;
  } else if (!err) {
    // out (B, 2h, 2w, O) viewed as (O, q, w, p, B h): element (c, q, j, p,
    // b h + i) is out[b, 2i+p, 2j+q, c]; boxes of 128 channels x 1 x w x 1
    // x TH NI, the block's rows in GEMM order
    const uint64_t od[5] = {(uint64_t)O, 2, (uint64_t)w_, 2, (uint64_t)B * h};
    const uint64_t os[4] = {(uint64_t)O, (uint64_t)2 * O, (uint64_t)2 * w_ * O,
                            (uint64_t)4 * w_ * O};
    const uint32_t ob[5] = {KB, 1, (uint32_t)w_, 1, (uint32_t)(TH * NI)};
    err = encode_s8<5>(&tout, out, od, os, ob);
    twf = tx;
  }
  if (err) return err;
  // one block per SM (the shared memory allows no second)
  static int cache[TP_MAX_DEVICES];
  int sms = 0;
  const cudaError_t e = resident_blocks(int8_deconv_kernel, THREADS, SMEM_LIMIT, cache, &sms);
  if (e != cudaSuccess) return (int)e;
  const long items = 4L * (P.fin ? 1 : O / BN) * (h / TH) * ((B + NI - 1) / NI);
  const dim3 grid((unsigned)(items < sms ? items : sms));
  int8_deconv_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(tx, tw, twf,
                                                                                  tout, P);
  return (int)cudaGetLastError();
}
