// Fused ResNet bottleneck for Hopper: 1x1 -> 3x3 (pad 1) -> 1x1, stride 1,
// BatchNorm folded into weights and biases, ReLU after the first two
// convs, then the residual (identity, or a 1x1 downsample conv) added
// before the last ReLU. NHWC bf16 in and out; bf16 tensor-core products
// (wmma m8n32k16) with float32 accumulation.
//
// Replaces tpupose/ops/pallas_layer1.py `_layer1_kernel` (`layer1_pallas`):
// ResNet-50 layer1 = three launches of this kernel (block 0 with the
// downsample, blocks 1-2 with identity). (block2_0, the stride-2 bridge,
// has its own kernel for Hopper: bridge.cu.) The TPU form keeps a whole
// image in VMEM and needs im2col buffers and lane padding; here a block
// owns an output tile and its halo in shared memory.
//
// What bounds it on the H100: layer1 is 654 MMAC per 256x192 image over
// ~2 MB moved (~650 operations per byte), above the bf16 ridge (~295), so
// the tensor cores bound it. This version uses the warp-level wmma API
// (mma.sync, not wgmma) and two blocks per SM, so it stays far from that
// bound; wgmma with TMA-fed tiles (as bridge.cu) is the later step.
//
// Design: one block (8 warps) per (image, 8 x 8 output tile).
//   1. load the input halo 10 x 10 x CIN into shared memory (zeros outside
//      the image);
//   2. conv1 over every halo pixel -> h1 in shared memory (bf16), zero at
//      halo pixels outside the image, which is conv2's zero padding;
//   3. conv2: K runs over the 9 taps; for each tap the A fragment is 8
//      output pixels of one row, read from h1 -> h2 (bf16);
//   4. conv3 (+ downsample: K continues over the halo's centre pixels,
//      into the same float32 accumulators), bias, identity, ReLU -> the
//      only write to device memory.
// Each conv is one block-wide GEMM whose weights stream through a
// double-buffered shared-memory stage in K-chunks (cp.async), so the
// block reads every weight from L2 once; each warp keeps a fixed set of
// accumulator tiles across the chunks. Shared-memory rows are padded by
// 32 bytes so a fragment's rows do not all start in one bank.
// Intermediates round to bf16 where the flax bf16 model rounds them; the
// downsample branch is summed in float32 with conv3.
#include "common.cuh"
#include "wmma_tiles.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int TW = 8;                       // output tile width = fragment M
constexpr int PAD = 16;                     // row padding, elements

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Per-variant shapes. conv1's warp task is MF1 x NF1 fragments of 8 x 32,
// conv2's 2 x 1 and conv3's 2 x 2; KC1 / KC3 = weight rows per K-chunk of
// conv1 / conv3 (conv2's chunk is one tap, CM rows). MINB = blocks per SM
// the register budget is set for.
template <int CIN_, int CM_, int COUT_, int S_, int TH_, bool DS_, int MF1_, int NF1_,
          int KC1_, int KC3_, int MINB_>
struct Cfg {
  static constexpr int CIN = CIN_, CM = CM_, COUT = COUT_, S = S_, TH = TH_;
  static constexpr bool DS = DS_;
  static constexpr int MF1 = MF1_, NF1 = NF1_, KC1 = KC1_, KC3 = KC3_, MINB = MINB_;
  static constexpr int HH = (TH - 1) * S + 3;     // halo rows
  static constexpr int HW = (TW - 1) * S + 3;     // halo cols
  static constexpr int HP = HH * HW;              // halo pixels
  static constexpr int HPP = (HP + 8 * MF1 - 1) / (8 * MF1) * (8 * MF1);
  static constexpr int LDI = CIN + PAD, LD1 = CM + PAD, LD2 = CM + PAD;
  static constexpr int STAGE = cmax(cmax(KC1 * (CM + PAD), CM * (CM + PAD)),
                                    KC3 * (COUT + PAD));        // elements
  static constexpr size_t IN_B = (size_t)HPP * LDI * 2;
  static constexpr size_t H1_B = (size_t)HPP * LD1 * 2;
  static constexpr size_t H2_B = (size_t)TH * TW * LD2 * 2;
  static constexpr size_t W_B = (size_t)2 * STAGE * 2;
  static constexpr size_t SCR_B = (size_t)NWARPS * 8 * 32 * 4;
  static constexpr size_t SMEM = IN_B + H1_B + H2_B + W_B + SCR_B;
  static_assert(CIN % KC1 == 0 && KC1 % 16 == 0 && CM % KC3 == 0 && CIN % KC3 == 0 &&
                KC3 % 16 == 0, "chunks");
  static_assert(CM % 64 == 0 && COUT % 64 == 0 && TH % 2 == 0, "widths");
  static_assert(DS || (S == 1 && CIN == COUT), "identity needs equal shapes");
  static_assert(IN_B % 128 == 0 && H1_B % 128 == 0 && H2_B % 128 == 0 && W_B % 128 == 0,
                "align");
  static_assert(SMEM <= 232448, "shared memory");
};

// variant 0: layer1 block 0; 1: layer1 blocks 1-2
typedef Cfg<64, 64, 256, 1, 8, true, 1, 2, 64, 16, 2> CfgL1B0;
typedef Cfg<256, 64, 256, 1, 8, false, 1, 2, 64, 16, 2> CfgL1B1;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows x N row-major global -> rows x (N + PAD) shared, 16-byte copies
template <int N>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int rows, int tid) {
  constexpr int V = N / 8;
  for (int i = tid; i < rows * V; i += THREADS) {
    const int r = i / V, v = i % V;
    cp_async16(dst + r * (N + PAD) + v * 8, src + (size_t)r * N + v * 8);
  }
}

// Block-wide GEMM: C[MFRAGS*8 x N] = sum over `nchunks` K-chunks of KC
// rows. a_src(chunk, m_frag, &a, &lda, &a_mstride) locates the A rows of
// fragments m_frag.. (MF of them); b_src(chunk) is the chunk's first
// weight row in global memory (row stride N). Task t = warp + 8j owns
// fragments (MF x NF) at (t / (N/32/NF), t % (N/32/NF)); after the last
// chunk, epi(m_frag, col0, fragment) consumes every fragment. Starts and
// ends with a __syncthreads, so shared stores made before it are visible.
template <int MFRAGS, int N, int MF, int NF, int KC, typename ASrc, typename BSrc,
          typename Epi>
__device__ __forceinline__ void block_gemm(int nchunks, bf16* s_w, int stage, ASrc a_src,
                                           BSrc b_src, Epi epi, int warp, int tid) {
  constexpr int TN = N / 32 / NF;
  constexpr int NTASK = (MFRAGS / MF) * TN;
  constexpr int TPW = (NTASK + NWARPS - 1) / NWARPS;
  static_assert(MFRAGS % MF == 0 && (N / 32) % NF == 0, "task tiling");
  FragC acc[TPW][MF][NF];
#pragma unroll
  for (int j = 0; j < TPW; ++j)
#pragma unroll
    for (int m = 0; m < MF; ++m)
#pragma unroll
      for (int n = 0; n < NF; ++n) wmma::fill_fragment(acc[j][m][n], 0.f);

  stage_rows<N>(s_w, b_src(0), KC, tid);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      stage_rows<N>(s_w + ((c + 1) & 1) * stage, b_src(c + 1), KC, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* bs = s_w + (c & 1) * stage;
#pragma unroll
    for (int j = 0; j < TPW; ++j) {
      const int t = warp + NWARPS * j;
      if (t < NTASK) {
        const bf16* a;
        int lda, ams;
        a_src(c, (t / TN) * MF, a, lda, ams);
        warp_gemm<MF, NF, KC / 16>(acc[j], a, lda, ams, bs + (t % TN) * NF * 32, N + PAD);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int t = warp + NWARPS * j;
    if (t < NTASK)
#pragma unroll
      for (int m = 0; m < MF; ++m)
#pragma unroll
        for (int n = 0; n < NF; ++n)
          epi((t / TN) * MF + m, ((t % TN) * NF + n) * 32, acc[j][m][n]);
  }
  __syncthreads();
}

template <class C>
__global__ void __launch_bounds__(THREADS, C::MINB)
bottleneck_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const float* __restrict__ b1, const bf16* __restrict__ w2,
                  const float* __restrict__ b2, const bf16* __restrict__ w3,
                  const float* __restrict__ b3, const bf16* __restrict__ wds,
                  bf16* __restrict__ out, int H, int W, int Ho, int Wo) {
  constexpr int CIN = C::CIN, CM = C::CM, COUT = C::COUT, S = C::S, HW = C::HW;
  constexpr int LDI = C::LDI, LD1 = C::LD1, LD2 = C::LD2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_in = reinterpret_cast<bf16*>(smem);
  bf16* s_h1 = reinterpret_cast<bf16*>(smem + C::IN_B);
  bf16* s_h2 = reinterpret_cast<bf16*>(smem + C::IN_B + C::H1_B);
  bf16* s_w = reinterpret_cast<bf16*>(smem + C::IN_B + C::H1_B + C::H2_B);
  float* s_scr = reinterpret_cast<float*>(smem + C::IN_B + C::H1_B + C::H2_B + C::W_B);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * C::TH, ox0 = blockIdx.x * TW;
  const int hy0 = oy0 * S - 1, hx0 = ox0 * S - 1;        // halo origin
  float* scr = s_scr + warp * 8 * 32;

  // 1. input halo, 16-byte vectors (zero rows beyond HP pad the last task)
  constexpr int VEC = CIN / 8;
  for (int i = tid; i < C::HPP * VEC; i += THREADS) {
    const int p = i / VEC, v = i % VEC;
    const int iy = hy0 + p / HW, ix = hx0 + p % HW;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (p < C::HP && iy >= 0 && iy < H && ix >= 0 && ix < W)
      val = *reinterpret_cast<const uint4*>(x + (((size_t)b * H + iy) * W + ix) * CIN + v * 8);
    *reinterpret_cast<uint4*>(s_in + p * LDI + v * 8) = val;
  }

  // 2. conv1 over the halo: [HPP x CIN] @ [CIN x CM]
  block_gemm<C::HPP / 8, CM, C::MF1, C::NF1, C::KC1>(
      CIN / C::KC1, s_w, C::STAGE,
      [&](int c, int mi, const bf16*& a, int& lda, int& ams) {
        a = s_in + mi * 8 * LDI + c * C::KC1;
        lda = LDI;
        ams = 8 * LDI;
      },
      [&](int c) { return w1 + (size_t)c * C::KC1 * CM; },
      [&](int mi, int n0, const FragC& f) {
        epilogue(f, scr, lane, [&](int r, int cc, float a0, float a1) {
          const int p = mi * 8 + r, col = n0 + cc;
          const int iy = hy0 + p / HW, ix = hx0 + p % HW;
          const bool inside = p < C::HP && iy >= 0 && iy < H && ix >= 0 && ix < W;
          const float v0 = inside ? fmaxf(a0 + b1[col], 0.f) : 0.f;
          const float v1 = inside ? fmaxf(a1 + b1[col + 1], 0.f) : 0.f;
          *reinterpret_cast<bf162*>(s_h1 + p * LD1 + col) = __floats2bfloat162_rn(v0, v1);
        });
      },
      warp, tid);

  // 3. conv2 3x3 stride S; chunk = tap, fragment = one output row
  block_gemm<C::TH, CM, 2, 1, CM>(
      9, s_w, C::STAGE,
      [&](int tap, int oy, const bf16*& a, int& lda, int& ams) {
        a = s_h1 + ((oy * S + tap / 3) * HW + tap % 3) * LD1;
        lda = S * LD1;
        ams = S * HW * LD1;
      },
      [&](int tap) { return w2 + (size_t)tap * CM * CM; },
      [&](int oy, int n0, const FragC& f) {
        epilogue(f, scr, lane, [&](int r, int cc, float a0, float a1) {
          const int col = n0 + cc;
          const float v0 = fmaxf(a0 + b2[col], 0.f), v1 = fmaxf(a1 + b2[col + 1], 0.f);
          *reinterpret_cast<bf162*>(s_h2 + (oy * TW + r) * LD2 + col) =
              __floats2bfloat162_rn(v0, v1);
        });
      },
      warp, tid);

  // 4. conv3 (+ downsample) + bias + residual + ReLU -> out
  constexpr int K3 = CM + (C::DS ? CIN : 0);
  block_gemm<C::TH, COUT, 2, 2, C::KC3>(
      K3 / C::KC3, s_w, C::STAGE,
      [&](int c, int oy, const bf16*& a, int& lda, int& ams) {
        const int k0 = c * C::KC3;
        if (k0 < CM) {
          a = s_h2 + oy * TW * LD2 + k0;
          lda = LD2;
          ams = TW * LD2;
        } else {
          a = s_in + ((oy * S + 1) * HW + 1) * LDI + (k0 - CM);
          lda = S * LDI;
          ams = S * HW * LDI;
        }
      },
      [&](int c) {
        const int k0 = c * C::KC3;
        return k0 < CM ? w3 + (size_t)k0 * COUT : wds + (size_t)(k0 - CM) * COUT;
      },
      [&](int oy, int n0, const FragC& f) {
        epilogue(f, scr, lane, [&](int r, int cc, float a0, float a1) {
          const int col = n0 + cc;
          float v0 = a0 + b3[col], v1 = a1 + b3[col + 1];
          if (!C::DS) {
            const float2 idn = __bfloat1622float2(*reinterpret_cast<const bf162*>(
                s_in + ((oy + 1) * HW + r + 1) * LDI + col));
            v0 += idn.x;
            v1 += idn.y;
          }
          *reinterpret_cast<bf162*>(out + (((size_t)b * Ho + oy0 + oy) * Wo + ox0 + r) * COUT +
                                    col) = __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
        });
      },
      warp, tid);
}

template <class C>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           const void* w3, const void* b3, const void* wds, void* out, int B, int H, int W,
           cudaStream_t stream) {
  const int Ho = (H - 1) / C::S + 1, Wo = (W - 1) / C::S + 1;
  if (Ho % C::TH != 0 || Wo % TW != 0) return (int)cudaErrorInvalidValue;
  auto kernel = bottleneck_kernel<C>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Wo / TW, Ho / C::TH, B);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<const bf16*>(w3),
      static_cast<const float*>(b3), static_cast<const bf16*>(wds), static_cast<bf16*>(out), H,
      W, Ho, Wo);
  return (int)cudaGetLastError();
}

}  // namespace

// variant 0: ResNet-50 layer1 block 0   (64 -> 64 -> 256, stride 1, downsample)
// variant 1: ResNet-50 layer1 blocks 1-2 (256 -> 64 -> 256, stride 1, identity)
// Weights bf16 row-major [K][N]: w1 (CIN, CM), w2 (3, 3, CM, CM), w3 (CM, COUT),
// wds (CIN, COUT) (ignored by variant 1); biases float32, b3 already holds
// the downsample's bias. x (B, H, W, CIN), out (B, Ho, Wo, COUT), bf16 NHWC.
// All pointers 16-byte aligned.
extern "C" int tp_bottleneck(const void* x, const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* w3, const void* b3, const void* wds,
                             void* out, int variant, int B, int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<CfgL1B0>(x, w1, b1, w2, b2, w3, b3, wds, out, B, H, W, s);
    case 1: return launch<CfgL1B1>(x, w1, b1, w2, b2, w3, b3, wds, out, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
