// Fused int8 ResNet bottleneck for Hopper: 1x1 -> 3x3 (stride S, pad 1) ->
// 1x1, every product int8 x int8 -> int32 on the tensor cores, each conv's
// epilogue in float32 (acc * m + b, ReLU, round half to even, clip to
// [0, 127]), then the residual (the input times r, or a 1x1 stride-S
// projection with its own m and b) added in float32 and requantized once.
// NHWC int8 in and out; post-ReLU activations lie in [0, 127], so the s8
// products are exact.
//
// Replaces the TPU kernel tpupose/ops/pallas_stages.py `_chunk_kernel`
// (called by `run_chunk`): one launch per bottleneck, 16 for the ResNet-50
// stages. The TPU packs several blocks into one call ("chunks") only to fit
// its VMEM budget, pads 64-wide layer1 tensors to 128 lanes, and builds the
// stride-2 3x3 from a phase split and 0/1 selector matmuls because Mosaic
// has no strided reads. None of that is needed here: the stride is an
// address computation.
//
// What bounds it on the H100: the 16 blocks do 3888 MMAC per 256x192 image
// and move ~10.9 MB of int8 activations per image (each block's input read
// once, output written once), ~710 operations a byte, above the int8 ridge
// (~590 at 1979 TOP/s and 3.35 TB/s): the tensor cores bound it. The first
// design ran mma.sync m16n8k32 from 8 warps with every operand staged by
// cp.async, ~86 TOP/s (4% of that bound). This one issues every product as
// an int8 warpgroup wgmma (m64nNk32) and brings every weight and every
// operand read from device memory by TMA.
//
// Design: a block owns one TH x TW output tile of NI images (NI > 1 only
// where the tile is the whole image, as in layer4, so that a block's 128
// GEMM rows span images and its weights are read once for them), with
// three roles, as the bridge kernel (bridge.cu, K3):
//   - a producer warpgroup (one thread issues, the warpgroup hands its
//     registers to the consumers by setmaxnreg) keeps two rings full: an
//     activation ring (2 x 16 KB: 128 rows of 128 channels) and a weight
//     ring (3 x 16 KB: 128 output channels x 128 K bytes), each stage with
//     "full" and "empty" mbarriers. Weight stages are boxes of the (O, I)
//     int8 matrices, K-major as 8-bit wgmma needs, 128-byte swizzled by
//     tensor maps encoded once per packed block
//     (tp_int8_bottleneck_weight_maps);
//   - two consumer warpgroups, each on one 64-row M tile:
//     1. conv1 over the tile's input halo ((TH-1)S+3) x ((TW-1)S+3), band
//        by band: a band is as many whole halo rows as fit 128 GEMM rows,
//        loaded by one TMA box per 128 input channels (zero outside the
//        image), read by SS wgmma; the epilogue writes h0 to shared memory
//        (rows of Cmid + 16 bytes), 0 at halo pixels outside the image,
//        which is conv2's zero padding;
//     2. conv2: K = 9 taps x Cmid; its A rows are taps of h0 at stride S,
//        no strided run a descriptor can describe, so ldmatrix gathers
//        them into registers for RS wgmma -> h1 in shared memory;
//     3. conv3 from h1 (RS), and for a projection block a second
//        accumulator over the input pixels (oy S, ox S), which a TMA box of
//        a tensor map with S-fold pixel strides delivers in the block's row
//        order (SS); the epilogue writes the only output.
//   Conv1 and conv2 run 64 columns a pass where Cmid is 64 (layer1), else
//   128; conv3 128. The host chooses (TH, TW, NI) by the padded products
//   a launch costs, within the 227 KB of shared memory
//   (ops/cuda_stages.py pick_tile, whose `_smem_bytes` mirrors
//   smem_bytes here).
// The epilogues use __fmul_rn / __fadd_rn / rintf in the order of the
// plain version (ops/cuda_stages.py chunk_reference), whose int products
// are exact too, so the two agree bit for bit.
#include <string.h>

#include "wgmma_tma.cuh"

namespace {

using namespace wg;

constexpr int THREADS = 3 * 128;     // two consumer warpgroups + a producer warpgroup
constexpr int KB = 128;              // K bytes a stage: one 128-byte swizzled row
constexpr int STAGE_B = 128 * KB;    // 16 KB: 128 rows (A) or 128 output channels (W)
constexpr int NA = 2, NW = 3;        // ring depths
constexpr int NB3 = 128;             // conv3 columns a pass
constexpr int OFF_W = NA * STAGE_B;
constexpr int OFF_H = OFF_W + NW * STAGE_B;   // h0, then h1, then the barriers
constexpr int SMEM_LIMIT = 232448;

struct WMaps {
  CUtensorMap w1, w2, w3, wp;
};

struct Params {
  const int8_t* x;
  const float *m1, *b1, *m2, *b2, *m3, *b3, *mp, *bp;
  float r;
  int8_t* out;
  int B, H, W, Cin, Cmid, Cout, S, TH, TW, NI, Ho, Wo, proj;
};

// The halo of a TH x TW tile at stride S: HC x HR pixels; conv1 takes it
// in NBAND bands of BR whole rows (BR * HC <= 128 GEMM rows); M2 output
// rows a block.
struct Geo {
  int HC, HR, HP, BR, NBAND, M2;
};

__host__ __device__ inline Geo geometry(int TH, int TW, int S, int NI) {
  Geo g;
  g.HC = (TW - 1) * S + 3;
  g.HR = (TH - 1) * S + 3;
  g.HP = g.HC * g.HR;
  g.BR = g.HR < 128 / g.HC ? g.HR : 128 / g.HC;
  g.NBAND = g.BR > 0 ? (g.HR + g.BR - 1) / g.BR : 0;
  g.M2 = NI * TH * TW;
  return g;
}

// Dynamic shared memory (ops/cuda_stages.py `_smem_bytes` computes the
// same to pick the tile): the rings, h0 over NI halos and h1 over M2 rows
// (rows of Cmid + 16 bytes), the barriers, 1024 bytes of alignment slack.
size_t smem_bytes(int TH, int TW, int S, int NI, int Cmid) {
  const Geo g = geometry(TH, TW, S, NI);
  return OFF_H + (size_t)(NI * g.HP + g.M2) * (Cmid + 16) + 8 * 2 * (NA + NW) + 1024;
}

// The requantization of the TPU kernels: clip(round(max(v, 0)), 0, 127),
// round half to even.
__device__ __forceinline__ int rq(float v) { return (int)fminf(rintf(fmaxf(v, 0.f)), 127.f); }

// acc * m + b as two rounded float32 operations (no fused multiply-add),
// in the order of the plain version.
__device__ __forceinline__ float affine(int acc, float m, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), m), b);
}

__device__ __forceinline__ void store2(int8_t* dst, int v0, int v1) {
  *reinterpret_cast<char2*>(dst) = make_char2((signed char)v0, (signed char)v1);
}

__device__ __forceinline__ void named_sync() {   // the 256 consumer threads
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

template <int NB1>   // conv1 / conv2 columns a pass: 64 (Cmid 64) or 128
__global__ void __launch_bounds__(THREADS, 1)
int8_bottleneck_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tpx,
                       const __grid_constant__ WMaps tw, const Params P) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Geo G = geometry(P.TH, P.TW, P.S, P.NI);
  const int LD = P.Cmid + 16;
  int8_t* h0 = reinterpret_cast<int8_t*>(smem + OFF_H);
  int8_t* h1 = h0 + (size_t)P.NI * G.HP * LD;
  uint64_t* a_full = reinterpret_cast<uint64_t*>(h1 + (size_t)G.M2 * LD);
  uint64_t* a_empty = a_full + NA;
  uint64_t* w_full = a_empty + NA;
  uint64_t* w_empty = w_full + NW;

  const int tiles_x = P.Wo / P.TW;
  const int oy0 = (blockIdx.x / tiles_x) * P.TH, ox0 = (blockIdx.x % tiles_x) * P.TW;
  const int b0 = blockIdx.y * P.NI;
  const int hy0 = oy0 * P.S - 1, hx0 = ox0 * P.S - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int KC1 = (P.Cin + KB - 1) / KB, KC2 = (9 * P.Cmid + KB - 1) / KB;
  const int KC3 = (P.Cmid + KB - 1) / KB;
  const int NC1 = P.Cmid / NB1, NC3 = P.Cout / NB3;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NA; ++s) {
      bar_init(&a_full[s], 1);
      bar_init(&a_empty[s], 8);            // the 8 consumer warps
    }
    for (int s = 0; s < NW; ++s) {
      bar_init(&w_full[s], 1);
      bar_init(&w_empty[s], 8);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---------------- producer: one thread issues every load, in the order
    // the consumers take them ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      int na = 0, nw = 0;
      auto a_load = [&](const CUtensorMap* map, uint32_t bytes, int c0, int c1, int c2, int c3) {
        const int s = na % NA;
        bar_wait(&a_empty[s], ((na / NA) & 1) ^ 1);
        bar_expect_tx(&a_full[s], bytes);
        tma_load_4d(smem + s * STAGE_B, map, &a_full[s], c0, c1, c2, c3);
        ++na;
      };
      auto w_load = [&](const CUtensorMap* map, int rows, int k0, int n0) {
        const int s = nw % NW;
        bar_wait(&w_empty[s], ((nw / NW) & 1) ^ 1);
        bar_expect_tx(&w_full[s], rows * KB);
        tma_load_2d(smem + OFF_W + s * STAGE_B, map, &w_full[s], k0, n0);
        ++nw;
      };
      for (int img = 0; img < P.NI; ++img)
        for (int band = 0; band < G.NBAND; ++band)
          for (int nc = 0; nc < NC1; ++nc)
            for (int kc = 0; kc < KC1; ++kc) {
              a_load(&tx, G.BR * G.HC * KB, KB * kc, hx0, hy0 + band * G.BR, b0 + img);
              w_load(&tw.w1, NB1, KB * kc, NB1 * nc);
            }
      for (int nc = 0; nc < NC1; ++nc)
        for (int kc = 0; kc < KC2; ++kc) w_load(&tw.w2, NB1, KB * kc, NB1 * nc);
      for (int nc = 0; nc < NC3; ++nc) {
        for (int kc = 0; kc < KC3; ++kc) w_load(&tw.w3, NB3, KB * kc, NB3 * nc);
        if (P.proj)
          for (int kc = 0; kc < KC1; ++kc) {
            a_load(&tpx, G.M2 * KB, KB * kc, ox0, oy0, b0);
            w_load(&tw.wp, NB3, KB * kc, NB3 * nc);
          }
      }
    }
    return;
  }

  // ---------------- consumers: warpgroup g on GEMM rows 64 g .. 64 g + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int g = warp >> 2, wi = warp & 3;
  const int r0 = 16 * wi + (lane >> 2), c2 = 2 * (lane & 3);   // accumulator rows r0, r0 + 8
  const int TT = P.TH * P.TW;
  int na = 0, nw = 0;
  auto wait_a = [&]() {
    bar_wait(&a_full[na % NA], (na / NA) & 1);
    return smem + (na % NA) * STAGE_B + g * 8192;   // this warpgroup's 64 rows
  };
  auto wait_w = [&]() {
    bar_wait(&w_full[nw % NW], (nw / NW) & 1);
    return smem + OFF_W + (nw % NW) * STAGE_B;
  };
  auto release_a = [&]() {
    __syncwarp();
    if (lane == 0) bar_arrive(&a_empty[na % NA]);
    ++na;
  };
  auto release_w = [&]() {
    __syncwarp();
    if (lane == 0) bar_arrive(&w_empty[nw % NW]);
    ++nw;
  };

  // 1. conv1 over the halo, band by band -> h0
  for (int img = 0; img < P.NI; ++img)
    for (int band = 0; band < G.NBAND; ++band) {
      const int rows = min(G.BR, G.HR - band * G.BR) * G.HC;   // halo pixels of the band
      for (int nc = 0; nc < NC1; ++nc) {
        int acc[NB1 / 2];
        for (int kc = 0; kc < KC1; ++kc) {
          const unsigned char* a = wait_a();
          const unsigned char* w = wait_w();
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KB / 32; ++kk)
            mma_s8_ss<NB1>(acc, desc_k(a + 32 * kk), desc_k(w + 32 * kk), kc | kk);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
          release_a();
          release_w();
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = 64 * g + r0 + 8 * hh;
          if (m >= rows) continue;
          const int hy = band * G.BR + m / G.HC, hx = m % G.HC;
          const int iy = hy0 + hy, ix = hx0 + hx;
          const bool inside = iy >= 0 && iy < P.H && ix >= 0 && ix < P.W;
          int8_t* dst = h0 + (size_t)(img * G.HP + hy * G.HC + hx) * LD;
#pragma unroll
          for (int j = 0; j < NB1 / 8; ++j) {
            const int c = NB1 * nc + 8 * j + c2;
            int v0 = 0, v1 = 0;
            if (inside) {
              v0 = rq(affine(acc[4 * j + 2 * hh], P.m1[c], P.b1[c]));
              v1 = rq(affine(acc[4 * j + 2 * hh + 1], P.m1[c + 1], P.b1[c + 1]));
            }
            store2(dst + c, v0, v1);
          }
        }
      }
    }
  named_sync();            // h0 complete

  // ldmatrix row of this lane: GEMM row mrow (clamped into the block), the
  // 16-byte half of a k32 step that lanes 16-31 read
  const int mrow = min(64 * g + 16 * wi + (lane & 15), G.M2 - 1);
  const int khalf = 16 * (lane >> 4);

  // 2. conv2 3x3 stride S -> h1
  {
    const int img = mrow / TT, p = mrow % TT, oy = p / P.TW, ox = p % P.TW;
    const int8_t* arow = h0 + (size_t)(img * G.HP + oy * P.S * G.HC + ox * P.S) * LD + khalf;
    for (int nc = 0; nc < NC1; ++nc) {
      int acc[NB1 / 2];
      for (int kc = 0; kc < KC2; ++kc) {
        uint32_t af[KB / 32][4];
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk) {
          const int k = KB * kc + 32 * kk;
          int tap = k / P.Cmid, c = k - tap * P.Cmid;
          if (tap > 8) tap = 8, c = 0;   // past K: the weights there are zero
          ldmatrix_x4(af[kk], smem_u32(arow + ((tap / 3) * G.HC + tap % 3) * LD + c));
        }
        const unsigned char* w = wait_w();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk)
          mma_s8_rs<NB1>(acc, af[kk], desc_k(w + 32 * kk), kc | kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        release_w();
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = 64 * g + r0 + 8 * hh;
        if (m >= G.M2) continue;
        int8_t* dst = h1 + (size_t)m * LD;
#pragma unroll
        for (int j = 0; j < NB1 / 8; ++j) {
          const int c = NB1 * nc + 8 * j + c2;
          store2(dst + c, rq(affine(acc[4 * j + 2 * hh], P.m2[c], P.b2[c])),
                 rq(affine(acc[4 * j + 2 * hh + 1], P.m2[c + 1], P.b2[c + 1])));
        }
      }
    }
  }
  named_sync();            // h1 complete

  // 3. conv3 (+ projection) + residual -> out
  {
    const int8_t* arow = h1 + (size_t)mrow * LD + khalf;
    for (int nc = 0; nc < NC3; ++nc) {
      int acc[NB3 / 2], accp[NB3 / 2];
      for (int kc = 0; kc < KC3; ++kc) {
        uint32_t af[KB / 32][4];
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk) {
          int k = KB * kc + 32 * kk;
          if (k >= P.Cmid) k = 0;        // past K: the weights there are zero
          ldmatrix_x4(af[kk], smem_u32(arow + k));
        }
        const unsigned char* w = wait_w();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KB / 32; ++kk)
          mma_s8_rs<NB3>(acc, af[kk], desc_k(w + 32 * kk), kc | kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        release_w();
      }
      if (P.proj) {
        for (int kc = 0; kc < KC1; ++kc) {
          const unsigned char* a = wait_a();
          const unsigned char* w = wait_w();
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KB / 32; ++kk)
            mma_s8_ss<NB3>(accp, desc_k(a + 32 * kk), desc_k(w + 32 * kk), kc | kk);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(accp);
          release_a();
          release_w();
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = 64 * g + r0 + 8 * hh;
        const int img = m / TT, p = m % TT, bi = b0 + img;
        if (m >= G.M2 || bi >= P.B) continue;
        const int oy = oy0 + p / P.TW, ox = ox0 + p % P.TW;
        int8_t* o = P.out + (((size_t)bi * P.Ho + oy) * P.Wo + ox) * P.Cout;
        const int8_t* xi = P.x + (((size_t)bi * P.H + oy) * P.W + ox) * P.Cin;   // identity: S 1
#pragma unroll
        for (int j = 0; j < NB3 / 8; ++j) {
          const int c = NB3 * nc + 8 * j + c2;
          float res0, res1;
          if (P.proj) {
            res0 = affine(accp[4 * j + 2 * hh], P.mp[c], P.bp[c]);
            res1 = affine(accp[4 * j + 2 * hh + 1], P.mp[c + 1], P.bp[c + 1]);
          } else {
            res0 = __fmul_rn((float)xi[c], P.r);
            res1 = __fmul_rn((float)xi[c + 1], P.r);
          }
          const float y0 = affine(acc[4 * j + 2 * hh], P.m3[c], P.b3[c]);
          const float y1 = affine(acc[4 * j + 2 * hh + 1], P.m3[c + 1], P.b3[c + 1]);
          store2(o + c, rq(__fadd_rn(y0, res0)), rq(__fadd_rn(y1, res1)));
        }
      }
    }
  }
}

// a 2D map over an int8 (rows, k) matrix: boxes of 128 K bytes x `box_rows`
int encode_weight(CUtensorMap* map, const void* w, int rows, int k, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)k, (uint64_t)rows};
  const uint64_t strides[1] = {(uint64_t)k};
  const uint32_t box[2] = {KB, (uint32_t)box_rows};
  return encode_s8<2>(map, w, dims, strides, box);
}

int nb1_of(int Cmid) { return Cmid == 64 ? 64 : 128; }

}  // namespace

// Tensor maps of one packed block's int8 weights, encoded once: w1 (Cmid,
// Cin), w2 (Cmid, 9 Cmid), w3 (Cout, Cmid), wp (Cout, Cin) or null,
// row-major [N][K], 16-byte aligned; writes sizeof(WMaps) = 512 bytes at
// `maps` (host).
extern "C" int tp_int8_bottleneck_weight_maps(const void* w1, const void* w2, const void* w3,
                                              const void* wp, int Cin, int Cmid, int Cout,
                                              void* maps) {
  if (Cin % 64 || (Cmid != 64 && Cmid % 128) || Cout % NB3) return (int)cudaErrorInvalidValue;
  alignas(64) WMaps m;
  memset(&m, 0, sizeof(m));
  const int nb1 = nb1_of(Cmid);
  int err = encode_weight(&m.w1, w1, Cmid, Cin, nb1);
  if (!err) err = encode_weight(&m.w2, w2, Cmid, 9 * Cmid, nb1);
  if (!err) err = encode_weight(&m.w3, w3, Cout, Cmid, NB3);
  if (!err && wp) err = encode_weight(&m.wp, wp, Cout, Cin, NB3);
  if (!err) memcpy(maps, &m, sizeof(WMaps));
  return err;
}

// One int8 bottleneck. x (B, H, W, Cin) int8 NHWC -> out (B, Ho, Wo, Cout),
// Ho = (H-1)/S+1; maps from tp_int8_bottleneck_weight_maps; m*, b* float32
// per output channel; mp null for an identity block (then S == 1, Cin ==
// Cout and the residual is x * r). A block computes a TH x TW output tile
// of NI images: TH | Ho, TW | Wo, NI > 1 only where the tile is the whole
// image, NI TH TW <= 128. Cin a multiple of 64, Cmid 64 or a multiple of
// 128, Cout of 128; pointers 16-byte aligned.
extern "C" int tp_int8_bottleneck(const void* x, const void* maps, const void* m1,
                                  const void* b1, const void* m2, const void* b2,
                                  const void* m3, const void* b3, const void* mp,
                                  const void* bp, float r, void* out, int B, int H, int W,
                                  int Cin, int Cmid, int Cout, int S, int TH, int TW, int NI,
                                  void* stream) {
  Params P;
  P.x = static_cast<const int8_t*>(x);
  P.m1 = static_cast<const float*>(m1);
  P.b1 = static_cast<const float*>(b1);
  P.m2 = static_cast<const float*>(m2);
  P.b2 = static_cast<const float*>(b2);
  P.m3 = static_cast<const float*>(m3);
  P.b3 = static_cast<const float*>(b3);
  P.mp = static_cast<const float*>(mp);
  P.bp = static_cast<const float*>(bp);
  P.r = r;
  P.out = static_cast<int8_t*>(out);
  P.B = B;
  P.H = H;
  P.W = W;
  P.Cin = Cin;
  P.Cmid = Cmid;
  P.Cout = Cout;
  P.S = S;
  P.TH = TH;
  P.TW = TW;
  P.NI = NI;
  P.Ho = (H - 1) / S + 1;
  P.Wo = (W - 1) / S + 1;
  P.proj = mp != nullptr;
  const Geo G = geometry(TH, TW, S, NI);
  const size_t smem = smem_bytes(TH, TW, S, NI, Cmid);
  if ((S != 1 && S != 2) || Cin % 64 || (Cmid != 64 && Cmid % 128) || Cout % NB3 || TH < 1 ||
      TW < 1 || NI < 1 || P.Ho % TH || P.Wo % TW || G.M2 > 128 || G.HC > 128 ||
      (NI > 1 && (TH != P.Ho || TW != P.Wo)) || smem > SMEM_LIMIT ||
      (!P.proj && (S != 1 || Cin != Cout)))
    return (int)cudaErrorInvalidValue;

  alignas(64) CUtensorMap tx, tpx;
  alignas(64) WMaps tw;
  memcpy(&tw, maps, sizeof(WMaps));
  // the halo bands: (Cin, W, H, B), boxes of 128 channels x HC x BR x 1
  const uint64_t dims[4] = {(uint64_t)Cin, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)Cin, (uint64_t)W * Cin, (uint64_t)H * W * Cin};
  const uint32_t box[4] = {KB, (uint32_t)G.HC, (uint32_t)G.BR, 1};
  int err = encode_s8<4>(&tx, x, dims, strides, box);
  // the projection's pixels x[b, S oy, S ox]: a (B, Ho, Wo, Cin) view with
  // S-fold pixel strides, boxes of the block's TH x TW x NI output pixels
  const uint64_t pdims[4] = {(uint64_t)Cin, (uint64_t)P.Wo, (uint64_t)P.Ho, (uint64_t)B};
  const uint64_t pstrides[3] = {(uint64_t)S * Cin, (uint64_t)S * W * Cin,
                                (uint64_t)H * W * Cin};
  const uint32_t pbox[4] = {KB, (uint32_t)TW, (uint32_t)TH, (uint32_t)NI};
  if (!err && P.proj) err = encode_s8<4>(&tpx, x, pdims, pstrides, pbox);
  if (!P.proj) tpx = tx;
  if (err) return err;

  auto kernel = nb1_of(Cmid) == 64 ? int8_bottleneck_kernel<64> : int8_bottleneck_kernel<128>;
  static bool smem_set[2][TP_MAX_DEVICES];
  const cudaError_t e = smem_limit_once(kernel, SMEM_LIMIT, smem_set[nb1_of(Cmid) == 64 ? 0 : 1]);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((P.Ho / TH) * (P.Wo / TW), (B + NI - 1) / NI);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(tx, tpx, tw, P);
  return (int)cudaGetLastError();
}
