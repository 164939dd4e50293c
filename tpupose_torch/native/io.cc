// The host-IO runtime of tpupose_torch (a copy of the JAX package's
// tpupose/native/io.cc): threaded JPEG decode with libjpeg DCT-domain
// downscaling, a bilinear 2x3 affine crop (COCO / MPII top-down) or a
// bilinear stretch-resize (YOLO-format images), on a std::thread pool,
// writing straight into a caller-provided uint8 NHWC buffer, and the
// YOLO-pose label parser. Loaded through ctypes by
// tpupose_torch/data/native_io.py, which builds it with this directory's
// Makefile into build/tpupose_torch/native/.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// bilinear resize RGB u8 (src HxW -> dst)
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int dh, int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    if (y0 > sh - 2) y0 = sh - 2;
    if (y0 < 0) y0 = 0;  // 1-pixel-tall sources: sh-2 is -1
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    if (wy > 1) wy = 1;  // upscaling: fy can pass sh-1 after the y0 clamp;
                         // an unclamped weight goes negative (UB on the
                         // uint8 cast) — clamp-to-edge instead
    const int y1 = y0 + 1 <= sh - 1 ? y0 + 1 : y0;  // second tap in-bounds
    const uint8_t* r0 = src + static_cast<size_t>(y0) * sw * 3;
    const uint8_t* r1 = src + static_cast<size_t>(y1) * sw * 3;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      if (x0 > sw - 2) x0 = sw - 2;
      if (x0 < 0) x0 = 0;  // 1-pixel-wide sources
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      if (wx > 1) wx = 1;
      const int x1 = x0 + 1 <= sw - 1 ? x0 + 1 : x0;
      const float w00 = (1 - wy) * (1 - wx), w01 = (1 - wy) * wx;
      const float w10 = wy * (1 - wx), w11 = wy * wx;
      for (int c = 0; c < 3; ++c) {
        float v = w00 * r0[x0 * 3 + c] + w01 * r0[x1 * 3 + c] +
                  w10 * r1[x0 * 3 + c] + w11 * r1[x1 * 3 + c];
        out[x * 3 + c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// general 2x3 dst->src affine warp, bilinear, zero fill outside source
void warp_affine(const uint8_t* src, int sh, int sw, const float m[6],
                 uint8_t* dst, int dh, int dw) {
  for (int y = 0; y < dh; ++y) {
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const float fx = m[0] * x + m[1] * y + m[2];
      const float fy = m[3] * x + m[4] * y + m[5];
      const int x0 = static_cast<int>(std::floor(fx));
      const int y0 = static_cast<int>(std::floor(fy));
      float acc[3] = {0, 0, 0};
      const float wx = fx - x0, wy = fy - y0;
      const float w[4] = {(1 - wy) * (1 - wx), (1 - wy) * wx,
                          wy * (1 - wx), wy * wx};
      const int xs[4] = {x0, x0 + 1, x0, x0 + 1};
      const int ys[4] = {y0, y0, y0 + 1, y0 + 1};
      for (int t = 0; t < 4; ++t) {
        if (xs[t] < 0 || xs[t] >= sw || ys[t] < 0 || ys[t] >= sh) continue;
        const uint8_t* p =
            src + (static_cast<size_t>(ys[t]) * sw + xs[t]) * 3;
        acc[0] += w[t] * p[0];
        acc[1] += w[t] * p[1];
        acc[2] += w[t] * p[2];
      }
      out[x * 3 + 0] = static_cast<uint8_t>(acc[0] + 0.5f);
      out[x * 3 + 1] = static_cast<uint8_t>(acc[1] + 0.5f);
      out[x * 3 + 2] = static_cast<uint8_t>(acc[2] + 0.5f);
    }
  }
}

// decode a JPEG to RGB. If shrink > 1, use libjpeg DCT prescale to decode
// at roughly 1/shrink resolution (cheap). Returns 0 on success and fills
// buf/w/h (and the full-resolution dims in fw/fh).
int decode_jpeg(const char* path, float shrink, std::vector<uint8_t>* buf,
                int* w, int* h, int* fw, int* fh) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  *fw = cinfo.image_width;
  *fh = cinfo.image_height;
  int num = 8;
  // largest num with 8/num <= shrink (decode resolution stays >= needed)
  while (num > 1 && 8.0f / (num - 1) <= shrink) --num;
  cinfo.scale_num = num;
  cinfo.scale_denom = 8;
  jpeg_start_decompress(&cinfo);
  const int sw = cinfo.output_width, sh = cinfo.output_height;
  buf->resize(static_cast<size_t>(sw) * sh * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row =
        buf->data() + static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  *w = sw;
  *h = sh;
  return 0;
}

}  // namespace

extern "C" {

// ABI version marker (the library's file name also carries its source's
// hash, so a stale build is never loaded).
int tp_io_version() { return 4; }

// Fused decode + affine crop: for each item, decode paths[i] (DCT-
// prescaled to the crop's scale) and warp with the 2x3 dst->src matrix
// mats[i*6..] (in FULL-RESOLUTION source pixel coords) into
// out[i] (out_h, out_w, 3). The matrix is rescaled internally when the
// DCT prescale kicks in. Threaded; returns failure count (failed slots
// are zero-filled, and ok[i] = 0 when `ok` is non-null so the caller can
// drop the labels too — a black image with live joints would otherwise
// train on garbage). This is the host half of the top-down input
// pipeline: JPEG -> person crop in one pass, no full-size RGB round trip
// in Python.
int tp_decode_warp_batch(const char** paths, const float* mats, int n,
                         int out_h, int out_w, uint8_t* out, int n_threads,
                         uint8_t* ok) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), failures(0);
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
  auto work = [&]() {
    std::vector<uint8_t> buf;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      if (ok) ok[i] = 1;
      const float* m = mats + static_cast<size_t>(i) * 6;
      // source pixels per dst pixel (column norms) -> decode shrink
      const float sx = std::sqrt(m[0] * m[0] + m[3] * m[3]);
      const float sy = std::sqrt(m[1] * m[1] + m[4] * m[4]);
      const float shrink = sx < sy ? sx : sy;
      int w = 0, h = 0, fw = 0, fh = 0;
      if (decode_jpeg(paths[i], shrink > 1.0f ? shrink : 1.0f, &buf, &w, &h,
                      &fw, &fh)) {
        failures.fetch_add(1);
        std::memset(out + stride * i, 0, stride);
        if (ok) ok[i] = 0;
        continue;
      }
      const float rx = static_cast<float>(w) / fw;
      const float ry = static_cast<float>(h) / fh;
      // index mapping between the full-res and DCT-prescaled grids is
      // x_s = (x_f + 0.5) * rx - 0.5 (pixel centers align) — scaling
      // the translation
      // by rx alone would shift every heavily-downscaled crop ~0.4 px
      // against its labels
      const float madj[6] = {m[0] * rx, m[1] * rx,
                             (m[2] + 0.5f) * rx - 0.5f,
                             m[3] * ry, m[4] * ry,
                             (m[5] + 0.5f) * ry - 0.5f};
      warp_affine(buf.data(), h, w, madj, out + stride * i, out_h, out_w);
    }
  };
  std::vector<std::thread> pool;
  const int t = n_threads < n ? n_threads : n;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(work);
  for (auto& th : pool) th.join();
  return failures.load();
}


// Decode one JPEG to RGB and stretch-resize into out (out_h*out_w*3).
// Uses libjpeg's DCT scaling (1/1..1/8) to decode near the target size
// cheaply. Returns 0 on success.
int tp_decode_jpeg_resize(const char* path, int out_h, int out_w,
                          uint8_t* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;

  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  std::vector<uint8_t> decoded;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  // DCT-domain downscale: pick the smallest scale that keeps both dims
  // >= target (quality) — scale_num/8 for scale_num in 1..8
  int num = 8;
  while (num > 1 &&
         (cinfo.image_width * (num - 1)) / 8 >= (unsigned)out_w &&
         (cinfo.image_height * (num - 1)) / 8 >= (unsigned)out_h) {
    --num;
  }
  cinfo.scale_num = num;
  cinfo.scale_denom = 8;
  jpeg_start_decompress(&cinfo);
  const int sw = cinfo.output_width, sh = cinfo.output_height;
  decoded.resize(static_cast<size_t>(sw) * sh * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = decoded.data() +
                   static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);

  if (sw == out_w && sh == out_h) {
    std::memcpy(out, decoded.data(), static_cast<size_t>(out_w) * out_h * 3);
  } else {
    resize_bilinear(decoded.data(), sh, sw, out, out_h, out_w);
  }
  return 0;
}

// Batch decode on a thread pool. paths: array of C strings; out: NHWC
// uint8 buffer of n*out_h*out_w*3. Returns count of failures.
int tp_decode_jpeg_batch(const char** paths, int n, int out_h, int out_w,
                         uint8_t* out, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), failures(0);
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      if (tp_decode_jpeg_resize(paths[i], out_h, out_w, out + stride * i)) {
        failures.fetch_add(1);
        std::memset(out + stride * i, 0, stride);
      }
    }
  };
  std::vector<std::thread> pool;
  const int t = n_threads < n ? n_threads : n;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(work);
  for (auto& th : pool) th.join();
  return failures.load();
}

// Batched threaded DCT-prescaled decode into caller-owned buffers — the
// decode half of the decode-once/warp-per-epoch cache (augmentation
// changes the warp every epoch, but the prescaled SOURCE pixels don't
// change; on few-core hosts the decode dominates the input pipeline,
// measured 187 img/s feed vs 2,226 img/s device in BENCH_r03). outs[i]
// gets the RGB rows of paths[i] decoded at >= 1/shrinks[i] resolution
// (caps[i] bytes available); ws/hs get the decoded dims, fws/fhs the
// full-resolution dims (the warp needs them to rescale its matrix).
// ok[i]=0 and +1 failure when the decode fails or the buffer is small.
int tp_decode_prescaled_batch(const char** paths, const float* shrinks,
                              int n, uint8_t** outs, const long* caps,
                              int* ws, int* hs, int* fws, int* fhs,
                              int n_threads, uint8_t* ok) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0), failures(0);
  auto work = [&]() {
    std::vector<uint8_t> buf;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      ok[i] = 1;
      int w = 0, h = 0, fw = 0, fh = 0;
      const float shrink = shrinks[i] > 1.0f ? shrinks[i] : 1.0f;
      if (decode_jpeg(paths[i], shrink, &buf, &w, &h, &fw, &fh) ||
          static_cast<long>(buf.size()) > caps[i]) {
        failures.fetch_add(1);
        ok[i] = 0;
        ws[i] = hs[i] = fws[i] = fhs[i] = 0;
        continue;
      }
      std::memcpy(outs[i], buf.data(), buf.size());
      ws[i] = w; hs[i] = h; fws[i] = fw; fhs[i] = fh;
    }
  };
  std::vector<std::thread> pool;
  const int t = n_threads < n ? n_threads : n;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(work);
  for (auto& th : pool) th.join();
  return failures.load();
}

// Batched threaded affine warp from already-decoded (possibly DCT-
// prescaled) buffers: srcs[i] is (hs[i], ws[i], 3) RGB decoded from a
// (fws[i], fhs[i]) source; mats[i*6..] is the 2x3 dst->src matrix in
// FULL-RESOLUTION coords (same contract as tp_decode_warp_batch, same
// half-pixel-center rescale). The warp-per-epoch half of the cache.
int tp_warp_batch(const uint8_t** srcs, const int* ws, const int* hs,
                  const int* fws, const int* fhs, const float* mats,
                  int n, int out_h, int out_w, uint8_t* out,
                  int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
  auto work = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      const float* m = mats + static_cast<size_t>(i) * 6;
      const float rx = static_cast<float>(ws[i]) / fws[i];
      const float ry = static_cast<float>(hs[i]) / fhs[i];
      const float madj[6] = {m[0] * rx, m[1] * rx,
                             (m[2] + 0.5f) * rx - 0.5f,
                             m[3] * ry, m[4] * ry,
                             (m[5] + 0.5f) * ry - 0.5f};
      warp_affine(srcs[i], hs[i], ws[i], madj, out + stride * i,
                  out_h, out_w);
    }
  };
  std::vector<std::thread> pool;
  const int t = n_threads < n ? n_threads : n;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) pool.emplace_back(work);
  for (auto& th : pool) th.join();
  return 0;
}

// Parse a YOLO-pose label txt: rows of `cols` floats. Returns row count,
// or -1 on malformed rows / -2 missing file. Rows beyond max_rows are
// skipped (counted).
int tp_parse_yolo_label(const char* path, float* out, int max_rows,
                        int cols) {
  FILE* f = fopen(path, "r");
  if (!f) return -2;
  int rows = 0;
  // 64 KiB line buffer: a 512-float row of full-precision decimals tops
  // out near 12 KiB; a line longer than the buffer would split mid-number
  // and misreport the file as malformed
  static thread_local std::vector<char> linebuf(65536);
  char* line = linebuf.data();
  while (fgets(line, static_cast<int>(linebuf.size()), f)) {
    char* p = line;
    int got = 0;
    float vals[512];
    while (got < cols && got < 512) {
      char* end;
      float v = strtof(p, &end);
      if (end == p) break;
      vals[got++] = v;
      p = end;
    }
    // skip blank lines
    if (got == 0) continue;
    // trailing garbage or wrong count -> malformed
    char* q = p;
    while (*q == ' ' || *q == '\t' || *q == '\n' || *q == '\r') ++q;
    if (got != cols || *q != '\0') {
      fclose(f);
      return -1;
    }
    if (rows < max_rows) {
      std::memcpy(out + static_cast<size_t>(rows) * cols, vals,
                  sizeof(float) * cols);
    }
    ++rows;
  }
  fclose(f);
  return rows;
}

}  // extern "C"
