// Fused ResNet stem for Hopper: conv 7x7/2 pad 3 (BatchNorm folded into
// the weights and bias) + ReLU + max-pool 3x3/2 pad 1, NHWC bf16 in and
// out, bf16 wgmma products with float32 accumulation.
//
// Replaces the TPU kernel tpupose/ops/pallas_stem.py `_stem_kernel`
// (called by `stem_pool_pallas`). The TPU form needs a 4x4 space-to-depth
// of the input, phase matmuls and 128-lane padding because Mosaic has no
// strided loads; none of that is needed here.
//
// What bounds it on the H100: 115.6 MMAC per 256x192 image against 0.69 MB
// moved (0.030 ms of products and 0.026 ms of bytes at B = 128), so the
// tensor cores in principle. PR 1's design reached ~2% of that: legacy
// wmma, ~2.4x the products the conv needs (K padded to 224, 17-column
// strips computed 24 wide, 9 conv rows per 4 pooled rows), the input staged
// by synchronous scalar loads, and two passes of the conv tile through
// shared memory before the pool.
//
// Design: an implicit GEMM per conv row with the roles swapped, M = the 64
// output channels (one wgmma M), N = NT conv columns of one conv row (NT =
// 104 or 152, the wgmma's N), K = (ky, kx, c) with c padded to 4 and kx to
// 8 (7 x 32 = 224, two k16 steps per kernel row).
//   - B straight from a ring of input rows, no im2col. An input row is kept
//     with 4 channels a pixel (8 bytes), so conv column n's K chunk j (kx =
//     2j, 2j + 1, c = 0..3) of kernel row ky is the 16 bytes at 16 n + 16 j
//     of input row 2 cy + ky - 3: an 8 x 16-byte core matrix is 128
//     contiguous bytes, K-major without swizzle, 16 bytes to the next core
//     matrix along K and 128 to the next along N (the core matrices overlap;
//     the wgmma only reads them). The weights (A) stay in registers for
//     the whole persistent block: each warp holds the A fragments of its
//     16 channels for all 14 k16 steps (56 registers), so the products
//     read only B from shared memory.
//   - A block walks a strip of 16 pooled rows of one image top to bottom,
//     so each conv row is computed once (one row of overlap between
//     strips).
//   - The epilogue stays in registers: bias, rounding to bf16 (two
//     channels of a column packed in a bf16x2), then the pool in bf16x2
//     max instructions (a max of bf16 values is exact, and rounding
//     commutes with ReLU and max, so ReLU is one more max with zero). The
//     horizontal pool takes its third column from the neighbouring lane
//     by a shuffle, the vertical pool keeps one half-pooled row, and each
//     pooled row is staged in shared memory (two buffers) and written by
//     one bulk copy (a pooled row of a chunk is contiguous in NHWC).
//   - A producer warp keeps the ring (12 rows) filled: 16-byte cp.async
//     copies of the raw rows (4 in flight; a raw 3-channel row has no
//     16-byte-aligned stride, and TMA cannot widen 3 channels to 4), then
//     expands each into its slot with zeros outside the image (the conv's
//     padding) and signals the consumers through an mbarrier; the
//     consumer warpgroup frees a slot once no later conv row reads it.
//   - Wider images than NT allows go in chunks of (NT - 1) / 2 pooled
//     columns (conv columns 2 p0 - 1 .. 2 p0 + NT - 2, one column of
//     overlap); the chooser is ops/cuda_stem.stem_tile.
// The conv's padding is exact zeros; the pool's padding is -inf in the
// reference, but every pooled value is a max over at least one post-ReLU
// value >= 0, so zeros for conv rows and columns outside the map give the
// same result.
#include "wgmma_tma.cuh"

namespace {

using namespace wg;

constexpr int CO = 64;                 // output channels (the wgmma's M)
constexpr int RING = 12;               // input rows in shared memory
constexpr int LOOK = 4;                // raw rows in flight
constexpr int PS = 16;                 // pooled rows per strip
constexpr int THREADS = 160;           // consumer warpgroup + producer warp

template <int NT>
struct Cfg {
  static constexpr int NJ = NT / 8;              // accumulator column groups
  static constexpr int PC = (NT - 1) / 2;        // pooled columns per chunk
  static constexpr int SPX = 2 * NT + 6;         // pixels of a stored input row
  static constexpr int ROW_B = SPX * 8;
  static constexpr int RAW_B = (SPX * 6 + 30) / 16 * 16;
  static constexpr int OUT_B = PC * CO * 2;
  static constexpr int OFF_RING = 0;
  static constexpr int OFF_RAW = OFF_RING + RING * ROW_B;
  static constexpr int OFF_OUT = OFF_RAW + LOOK * RAW_B;
  static constexpr int OFF_BAR = OFF_OUT + 2 * OUT_B;
  static constexpr int SMEM = OFF_BAR + 2 * RING * 8 + 128;   // + alignment slack
  static_assert(ROW_B % 16 == 0 && OUT_B % 128 == 0 && SMEM <= 232448, "layout");
};

// descriptor of a K-major operand without swizzle: 8 x 16-byte core
// matrices, lbo bytes to the next along K, sbo to the next 8 rows
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

// 16 bytes global -> shared, the last 16 - n zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a contiguous run of shared memory to device memory (16-byte aligned,
// a multiple of 16 bytes)
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_sync() {   // the 128 consumer threads
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// elementwise max of two bf16x2
__device__ __forceinline__ uint32_t hmax2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// d (64 x 104) = A (64 x 16 in registers: per warp the A fragment of
// mma.m16n8k16 over its 16 rows, wgmma_tma.cuh) * B (104 x 16, K-major at
// db) + (accumulate ? d : 0)
__device__ __forceinline__ void mma_rs_n104(float (&d)[52], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, "
      "%51}, {%52, %53, %54, %55}, %56, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// the same with N = 152
__device__ __forceinline__ void mma_rs_n152(float (&d)[76], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %81, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
      "%69, %70, %71, %72, %73, %74, %75}, {%76, %77, %78, %79}, %80, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int NT>
__device__ __forceinline__ void mma_rs(float (&d)[NT / 2], const uint32_t (&a)[4], uint64_t db,
                                       int accumulate) {
  if constexpr (NT == 104)
    mma_rs_n104(d, a, db, accumulate);
  else
    mma_rs_n152(d, a, db, accumulate);
}


// one unit of work: pooled rows [py0, py1) and columns [p0, p0 + npc) of
// image b; conv rows [cya, cyb] are computed, from input rows 2 cya - 3 ..
// 2 cyb + 3
struct Unit {
  int b, py0, py1, p0, npc, cya, cyb;
};

template <int NT>
__global__ void __launch_bounds__(THREADS, 2)
stem_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
            const float* __restrict__ bias, bf16* __restrict__ out, int B, int H, int W, int Hc,
            int Wc, int Hp, int Wp, int strips, int chunks) {
  using C = Cfg<NT>;
  constexpr int NJ = C::NJ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  unsigned char* s_ring = smem + C::OFF_RING;
  unsigned char* s_raw = smem + C::OFF_RAW;
  unsigned char* s_out = smem + C::OFF_OUT;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + RING;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nunits = B * strips * chunks;

  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      bar_init(&full[s], 32);              // every producer lane
      bar_init(&empty[s], 4);              // the 4 consumer warps
    }
    bar_init_fence();
  }
  fence_async_smem();
  __syncthreads();

  auto unit = [&](int u) {
    Unit t;
    t.p0 = (u % chunks) * C::PC;
    t.npc = min(C::PC, Wp - t.p0);
    t.py0 = (u / chunks) % strips * PS;
    t.py1 = min(t.py0 + PS, Hp);
    t.b = u / (chunks * strips);
    t.cya = max(2 * t.py0 - 1, 0);
    t.cyb = min(2 * t.py1 - 1, Hc - 1);
    return t;
  };

  if (warp == 4) {
    // ---------------- producer: input rows 2 cya - 3 .. 2 cyb + 3 of each
    // unit, in order, into the ring ----------------
    const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
    const long long total = (long long)B * H * W * 6;
    uint32_t seq = 0;
    for (int u = blockIdx.x; u < nunits; u += gridDim.x) {
      const Unit t = unit(u);
      const int iy0 = 2 * t.cya - 3, n = 2 * (t.cyb - t.cya) + 7;
      const int ix0 = 4 * t.p0 - 5;          // input column of stored pixel 0
      const int xa = max(ix0, 0), xe = min(ix0 + C::SPX, W);
      auto row_bytes = [&](int iy, int ix) { return (((long long)t.b * H + iy) * W + ix) * 6; };
      // raw row r into buffer r % LOOK: the 16-byte chunks over [xa, xe)
      auto fetch = [&](int r) {
        const int iy = iy0 + r;
        if (r < n && iy >= 0 && iy < H && xa < xe) {
          const long long a16 = row_bytes(iy, xa) & ~15ll, e = row_bytes(iy, xe);
          const int nch = (int)((e - a16 + 15) >> 4);
          unsigned char* dst = s_raw + (r % LOOK) * C::RAW_B;
          for (int k = lane; k < nch; k += 32) {
            const long long g = a16 + 16 * k;
            cp_async16(dst + 16 * k, xb + g, total - g < 16 ? (int)(total - g) : 16);
          }
        }
        cp_async_commit();
      };
      for (int r = 0; r < LOOK; ++r) fetch(r);
      for (int r = 0; r < n; ++r, ++seq) {
        cp_async_wait<LOOK - 1>();           // this lane's copies of row r
        __syncwarp();                        // ... and every other lane's
        const int s = seq % RING;
        bar_wait(&empty[s], ((seq / RING) & 1) ^ 1);
        const int iy = iy0 + r;
        const bool in = iy >= 0 && iy < H && xa < xe;
        // column xa's first byte lies lead bytes into the raw row
        const int lead = in ? (int)(row_bytes(iy, xa) & 15) : 0;
        const unsigned char* raw = s_raw + (r % LOOK) * C::RAW_B + lead;
        uint2* dst = reinterpret_cast<uint2*>(s_ring + s * C::ROW_B);
        constexpr int IT = (C::SPX + 31) / 32;
        uint2 v[IT];                         // every load, then every store
#pragma unroll
        for (int it = 0; it < IT; ++it) {
          const int ix = ix0 + lane + 32 * it;
          v[it] = make_uint2(0u, 0u);
          if (in && ix >= xa && ix < xe) {
            const uint16_t* p = reinterpret_cast<const uint16_t*>(raw + 6 * (ix - xa));
            v[it].x = (uint32_t)p[0] | ((uint32_t)p[1] << 16);
            v[it].y = (uint32_t)p[2];
          }
        }
#pragma unroll
        for (int it = 0; it < IT; ++it)
          if (lane + 32 * it < C::SPX) dst[lane + 32 * it] = v[it];
        fence_async_smem();                  // the slot, visible to wgmma
        __syncwarp();                        // every lane done with the raw row
        bar_arrive(&full[s]);
        fetch(r + LOOK);
      }
    }
    cp_async_wait<0>();
    return;
  }

  // ---------------- consumer warpgroup ----------------
  // accumulator d[4 j + 2 h + e]: channel r0 + 8 h, accumulator column
  // 8 j + 2 l4 + e (wgmma_tma.cuh); the epilogue packs (channel r0, r0 + 8)
  // of one column into a bf16x2 and pools in bf16x2 (a max of bf16 values
  // is exact, and rounding commutes with ReLU and max)
  const int r0 = 16 * warp + (lane >> 2), l4 = lane & 3;
  const bool odd = (lane >> 2) & 1;        // r0 odd
  const float bias0 = bias[r0], bias1 = bias[r0 + 8];
  const uint32_t ring_addr = smem_u32(s_ring);
  // this warp's A fragments of the 14 k16 steps: a[e] holds channel
  // r0 + 8 (e & 1), k = 16 s + 8 (e >> 1) + 2 l4 + {0, 1}
  uint32_t af[14][4];
  auto wk = [&](int o, int k) {
    const int ky = k >> 5, kx = (k >> 2) & 7, c = k & 3;
    return (kx < 7 && c < 3) ? __bfloat162float(w[((ky * 7 + kx) * 3 + c) * CO + o]) : 0.f;
  };
#pragma unroll
  for (int st = 0; st < 14; ++st)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = r0 + 8 * (e & 1), k = 16 * st + 8 * (e >> 1) + 2 * l4;
      af[st][e] = pack_bf16(wk(o, k), wk(o, k + 1));
    }
  uint32_t seq = 0;
  int nout = 0;
  float acc[NT / 2];
  for (int u = blockIdx.x; u < nunits; u += gridDim.x) {
    const Unit t = unit(u);
    const int cx0 = 2 * t.p0 - 1;            // conv column of accumulator column 0
    // bit j: conv columns cx0 + 8 j + 2 l4 (in0) and + 1 (in1) lie in the map
    uint32_t in0 = 0, in1 = 0;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int cx = cx0 + 8 * j + 2 * l4;
      in0 |= (uint32_t)(cx >= 0 && cx < Wc) << j;
      in1 |= (uint32_t)(cx + 1 < Wc) << j;
    }
    const uint32_t base = seq;
    uint32_t waited = seq;
    const int n = t.cyb - t.cya + 1;         // conv rows computed
    uint32_t state[NJ];                      // max so far over the pooled row's conv rows
#pragma unroll
    for (int j = 0; j < NJ; ++j) state[j] = 0u;

    // the products of conv row cya + k into d (the first overwrites it),
    // committed and left in flight (its input rows have arrived)
    auto issue = [&](float (&d)[NT / 2], int k) {
      const uint32_t first = base + 2 * k;   // input row 2 cy - 3
#pragma unroll
      for (int ky = 0; ky < 7; ++ky) {
        const uint32_t brow = ring_addr + ((first + ky) % RING) * C::ROW_B;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          mma_rs<NT>(d, af[2 * ky + ks], desc_plain(brow + 32 * ks, 16, 128), ky | ks);
      }
      wgmma_commit();
    };
    // pooled row py: max(state, hp) into a staging buffer, then one bulk copy
    auto emit = [&](const uint32_t (&hp)[NJ], int py) {
      unsigned char* so = s_out + (nout & 1) * C::OUT_B;
      if (tid == 0) bulk_wait_read<1>();     // the store of two rows ago has read so
      consumer_sync();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int q = 4 * j + l4;
        const uint32_t mine = hmax2(state[j], hp[j]);           // channels r0, r0 + 8
        const uint32_t got = __shfl_xor_sync(0xffffffffu, mine, 4);   // r0 ^ 1
        if (q < t.npc) {
          if (!odd)     // channels r0, r0 + 1
            *reinterpret_cast<uint32_t*>(so + q * 128 + r0 * 2) = __byte_perm(mine, got, 0x5410);
          else          // channels r0 + 7, r0 + 8
            *reinterpret_cast<uint32_t*>(so + q * 128 + (r0 + 7) * 2) =
                __byte_perm(mine, got, 0x3276);
        }
      }
      fence_async_smem();
      consumer_sync();
      if (tid == 0)
        bulk_store(out + (((long long)t.b * Hp + py) * Wp + t.p0) * CO, so, t.npc * CO * 2);
      ++nout;
    };
    // conv row cy (pooled along x in hp) into the vertical pool: rows
    // 2 py - 1, 2 py and 2 py + 1 make pooled row py
    auto feed = [&](const uint32_t (&hp)[NJ], int cy) {
      if (!(cy & 1)) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) state[j] = hmax2(state[j], hp[j]);
        return;
      }
      if (cy > 2 * t.py0 - 1) emit(hp, (cy - 1) >> 1);
#pragma unroll
      for (int j = 0; j < NJ; ++j) state[j] = hp[j];
    };
    // bias, bf16, zero outside the conv map (the pool's padding), then the
    // max over columns 2q, 2q + 1 (this lane) and 2q + 2 (the next lane's
    // first, or lane - 3's next group) and ReLU (a max with +0)
    auto pool_row = [&](const float (&d)[NT / 2], uint32_t (&hp)[NJ]) {
      uint32_t a[NJ], b[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        a[j] = pack_bf16(d[4 * j] + bias0, d[4 * j + 2] + bias1) & (0u - ((in0 >> j) & 1u));
        b[j] = pack_bf16(d[4 * j + 1] + bias0, d[4 * j + 3] + bias1) & (0u - ((in1 >> j) & 1u));
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const uint32_t give = l4 == 0 ? (j + 1 < NJ ? a[j + 1] : 0u) : a[j];
        const uint32_t nb = __shfl_sync(0xffffffffu, give, l4 == 3 ? lane - 3 : lane + 1);
        hp[j] = hmax2(hmax2(a[j], b[j]), hmax2(nb, 0u));
      }
    };

    uint32_t zero[NJ];                       // a conv row outside the map
#pragma unroll
    for (int j = 0; j < NJ; ++j) zero[j] = 0u;
    if (2 * t.py0 - 1 < t.cya) feed(zero, 2 * t.py0 - 1);
    // a conv row at a time: its 14 products, then its epilogue (the other
    // block on the SM overlaps the two)
    for (int k = 0; k < n; ++k) {
      const uint32_t first = base + 2 * k;
      for (; waited <= first + 6; ++waited) bar_wait(&full[waited % RING], (waited / RING) & 1);
      wgmma_fence();
      issue(acc, k);
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0)
        for (int i = 0; i < (k + 1 == n ? 7 : 2); ++i)
          bar_arrive(&empty[(first + i) % RING]);
      uint32_t hp[NJ];
      pool_row(acc, hp);
      feed(hp, t.cya + k);
    }
    if (t.cyb < 2 * t.py1 - 1) feed(zero, 2 * t.py1 - 1);
    seq = base + 2 * n + 5;
  }
  if (tid == 0) bulk_wait_all();
}

template <int NT>
int launch(const void* x, const void* w, const void* bias, void* out, int B, int H, int W,
           cudaStream_t stream) {
  using C = Cfg<NT>;
  const int Hc = (H - 1) / 2 + 1, Wc = (W - 1) / 2 + 1;
  const int Hp = (Hc - 1) / 2 + 1, Wp = (Wc - 1) / 2 + 1;
  const int strips = (Hp + PS - 1) / PS, chunks = (Wp + C::PC - 1) / C::PC;
  const long long units = (long long)B * strips * chunks;
  if (units > 0x7fffffffLL || (long long)B * H * W * 6 > (1ll << 40))
    return (int)cudaErrorInvalidValue;
  auto kernel = stem_kernel<NT>;
  static int cache[TP_MAX_DEVICES];        // blocks that fit each card at once
  int resident = 0;
  const cudaError_t e = resident_blocks(kernel, THREADS, C::SMEM, cache, &resident);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)(units < resident ? units : resident);
  kernel<<<grid, THREADS, C::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<bf16*>(out), B, H, W, Hc, Wc, Hp, Wp, strips, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, H, W, 3) bf16 NHWC; w (7, 7, 3, 64) bf16 HWIO with BN folded in;
// bias (64,) float32; out (B, Hp, Wp, 64) bf16 with Hc = (H-1)/2+1,
// Hp = (Hc-1)/2+1 (likewise for widths). nt: the wgmma's N, 104 or 152
// (ops/cuda_stem.stem_tile). x and out 16-byte aligned.
extern "C" int tp_stem_pool(const void* x, const void* w, const void* bias, void* out, int B,
                            int H, int W, int nt, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 104: return launch<104>(x, w, bias, out, B, H, W, s);
    case 152: return launch<152>(x, w, bias, out, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
