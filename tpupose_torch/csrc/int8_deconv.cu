// int8 transposed conv 4x4 / stride 2 / padding 1 (torch ConvTranspose2d)
// with BatchNorm folded, ReLU and requantization, for Hopper; optionally
// with the SimpleBaseline's final 1x1 heatmap conv fused behind it.
//
// Replaces the TPU kernel tpupose/ops/pallas_head.py `_deconv_kernel`
// (called by `run_deconv`). A stride-2 transposed conv splits into four
// output phases (p, q); phase (p, q) at input position (i, j) is one
// (4*Cin)-deep product over the 2x2 shifted inputs (i+my, j+mx), my in
// SHIFT[p], mx in SHIFT[q], with the phase's own int8 weights and requant
// scale vector (ops/cuda_head.py fold_deconv). The TPU interleaves the
// phases with 0/1 selector matmuls because Mosaic has no strided stores;
// here each phase's pixels are stored straight to (2i+p, 2j+q).
//
// What bounds it on the H100: deconv0 (8x6x2048 -> 16x12x256) is 403 MMAC
// per image over 8.4 MB of weights, deconv1 201 MMAC, deconv2 + final
// 819 MMAC; at B=128 all three are bound by the int8 products (0.05, 0.03
// and 0.11 ms at 1979 TOP/s). This first version uses mma.sync from 8
// warps with every operand staged through shared memory (int8_mma.cuh).
//
// Design: a block owns 128 consecutive input positions (b, i, j) of the
// batch: the rows of an implicit GEMM whose A rows are the shifted input
// pixels, streamed from device memory in 64-byte K-chunks (zeros outside
// the image). Without the final conv, grid.y picks the phase and the int8
// result goes to device memory. With it, the block runs all four phases,
// keeps the int8 deconv output of its 4 x 128 output pixels in shared
// memory, and multiplies that by the final conv's int8 weights; only the
// float32 heatmaps (B, 2h, 2w, K) reach device memory, as in the TPU
// kernel. Epilogues use __fmul_rn / __fadd_rn / rintf in the order of the
// plain version (ops/cuda_head.py deconv_reference): bit-equal to it.
#include "int8_mma.cuh"

namespace {

__constant__ int SHIFT[2][2] = {{-1, 0}, {0, 1}};

struct DcParams {
  const int8_t* x;
  const int8_t* wt;      // (4, O, 4*Cin)
  const float* mv;       // (4, O)
  const float* bv;       // (O,)
  const int8_t* wf;      // (KP, O) or null
  const float *mf, *bf;  // (KP,)
  int8_t* out8;          // (B, 2h, 2w, O) without the final conv
  float* out32;          // (B, 2h, 2w, KF) with it
  int B, h, w, Cin, O, KF, KP;
};

size_t smem_bytes(bool final_conv, int O) {
  return (final_conv ? (size_t)4 * MG * (O + 16) : 0) + STAGE_BYTES;
}

__global__ void __launch_bounds__(THREADS, 1) int8_deconv_kernel(const DcParams P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bool fin = P.wf != nullptr;
  const int LDY = P.O + 16;
  int8_t* s_y = reinterpret_cast<int8_t*>(smem);
  int8_t* sa = s_y + (fin ? (size_t)4 * MG * LDY : 0);
  int8_t* sw = sa + 2 * A_STAGE;
  const int total = P.B * P.h * P.w, pos0 = blockIdx.x * MG;
  const int rows = min(MG, total - pos0), K = 4 * P.Cin;
  Acc acc;

  // out pixel (b, 2i+p, 2j+q) of input position pos, as a flat NHWC index
  auto out_pixel = [&](int pos, int p, int q) -> size_t {
    const int j = pos % P.w, i = (pos / P.w) % P.h, b = pos / (P.w * P.h);
    return ((size_t)b * 2 * P.h + 2 * i + p) * 2 * P.w + 2 * j + q;
  };

  const int ph_lo = fin ? 0 : blockIdx.y, ph_hi = fin ? 4 : blockIdx.y + 1;
  for (int ph = ph_lo; ph < ph_hi; ++ph) {
    const int p = ph >> 1, q = ph & 1;
    const float* mv = P.mv + (size_t)ph * P.O;
    for_each_pass(rows, P.O, [&](const Pass& ps) {
      accumulate<true>(acc, ps, P.O, K, P.wt + (size_t)ph * P.O * K,
                       [&](int m, int k0) -> const int8_t* {
                         const int pos = pos0 + m;
                         const int bi = k0 / P.Cin, c0 = k0 - bi * P.Cin;
                         const int j = pos % P.w, i = (pos / P.w) % P.h;
                         const int b = pos / (P.w * P.h);
                         const int ii = i + SHIFT[p][bi >> 1], jj = j + SHIFT[q][bi & 1];
                         if (ii < 0 || ii >= P.h || jj < 0 || jj >= P.w) return nullptr;
                         return P.x + (((size_t)b * P.h + ii) * P.w + jj) * P.Cin + c0;
                       },
                       sa, sw);
      if (ps.active)
        for_each_pair(ps, [&](int m, int c, int mi, int ni, int hh) {
          const int v0 = rq(affine(acc[mi][ni][2 * hh], mv[c], P.bv[c]));
          const int v1 = rq(affine(acc[mi][ni][2 * hh + 1], mv[c + 1], P.bv[c + 1]));
          if (fin)
            store2(s_y + (size_t)(m * 4 + ph) * LDY + c, v0, v1);
          else
            store2(P.out8 + out_pixel(pos0 + m, p, q) * P.O + c, v0, v1);
        });
    });
  }
  if (!fin) return;

  // the final 1x1 conv over the 4 * rows output pixels kept in s_y
  for_each_pass(rows * 4, P.KP, [&](const Pass& ps) {
    accumulate<false>(acc, ps, P.KP, P.O, P.wf,
                      [&](int r, int k0) -> const int8_t* {
                        return s_y + (size_t)r * LDY + k0;
                      },
                      sa, sw);
    if (ps.active)
      for_each_pair(ps, [&](int r, int c, int mi, int ni, int hh) {
        const int ph = r & 3;
        float* o = P.out32 + out_pixel(pos0 + (r >> 2), ph >> 1, ph & 1) * P.KF;
        if (c < P.KF) o[c] = affine(acc[mi][ni][2 * hh], P.mf[c], P.bf[c]);
        if (c + 1 < P.KF) o[c + 1] = affine(acc[mi][ni][2 * hh + 1], P.mf[c + 1], P.bf[c + 1]);
      });
  });
}

}  // namespace

// One int8 transposed conv. x (B, h, w, Cin) int8 NHWC; w (4, O, 4*Cin)
// int8, phase ph = 2p+q, k = (2*sy+sx)*Cin + c for shifts (SHIFT[p][sy],
// SHIFT[q][sx]); mv (4, O) and bv (O,) float32. Without the final conv
// (wf null): out8 (B, 2h, 2w, O) int8. With it: wf (KP, O) int8 with KP a
// multiple of 32 (rows past KF zero), mf, bf (KP,) float32, out32
// (B, 2h, 2w, KF) float32. Cin and O multiples of 64; pointers
// 16-byte aligned.
extern "C" int tp_int8_deconv(const void* x, const void* w, const void* mv, const void* bv,
                              const void* wf, const void* mf, const void* bf, void* out,
                              int B, int h, int w_, int Cin, int O, int KF, int KP,
                              void* stream) {
  DcParams P;
  P.x = static_cast<const int8_t*>(x);
  P.wt = static_cast<const int8_t*>(w);
  P.mv = static_cast<const float*>(mv);
  P.bv = static_cast<const float*>(bv);
  P.wf = static_cast<const int8_t*>(wf);
  P.mf = static_cast<const float*>(mf);
  P.bf = static_cast<const float*>(bf);
  const bool fin = wf != nullptr;
  P.out8 = fin ? nullptr : static_cast<int8_t*>(out);
  P.out32 = fin ? static_cast<float*>(out) : nullptr;
  P.B = B;
  P.h = h;
  P.w = w_;
  P.Cin = Cin;
  P.O = O;
  P.KF = KF;
  P.KP = KP;
  if (Cin % KC || O % KC || (fin && (KP % 32 || KF > KP || KF < 1)))
    return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(int8_deconv_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const long total = (long)B * h * w_;
  if (total == 0) return 0;
  dim3 grid((unsigned)((total + MG - 1) / MG), fin ? 1 : 4);
  int8_deconv_kernel<<<grid, THREADS, smem_bytes(fin, O), static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}
