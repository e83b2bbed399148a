// Native frame loader: JPEG decode (libjpeg) + antialiased bilinear resize
// (PIL's triangle-filter resampling algorithm) + ImageNet normalization,
// multi-threaded across frames.
//
// This is the TPU-framework counterpart of the reference's native layer: the
// reference embeds CUDA kernels for its device-side hot ops
// (core/operators/cupy_*.py); on TPU the device ops are Pallas/XLA, so the
// native win is the HOST-side bottleneck — JPEG decode + resize, which
// otherwise serializes on Python/PIL in the serving path
// (core/preprocessing/frame_loader.py).
//
// Resampling matches PIL Resample.c semantics (triangle filter with support
// scaled by the downscale ratio, computed in float) so outputs agree with
// the PIL reference path to ~1e-2 absolute in normalized units; the PIL path
// stays the parity reference (preprocessing/frame_loader.py).
//
// C ABI:
//   int vct_load_frames(const char* const* paths, int n_frames,
//                       int image_size, const float* mean3, const float* std3,
//                       float* out /* [n,3,S,S] */, int n_threads);
// Returns 0 on success, 1-based index of the first failing file otherwise.

#include <cstdio>  // must precede jpeglib.h (it uses FILE without including stdio)

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode one JPEG into interleaved RGB8. Returns false on failure.
bool decode_jpeg(const char* path, std::vector<unsigned char>& rgb,
                 int& width, int& height) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  width = cinfo.output_width;
  height = cinfo.output_height;
  rgb.resize(static_cast<size_t>(width) * height * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = rgb.data() + static_cast<size_t>(cinfo.output_scanline) * width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  return true;
}

// ---- PIL-bit-exact resampling ---------------------------------------------
// Reproduces Pillow's Resample.c fixed-point pipeline exactly (BILINEAR =
// triangle filter, support 1, antialiased): double-precision normalized
// coefficients quantized to int32 at PRECISION_BITS, int accumulation with a
// rounding bias, clip8 per pass, and a uint8 intermediate between the
// horizontal and vertical passes. Output bytes equal
// PIL.Image.resize((S,S), BILINEAR) bit-for-bit, so the native fast path and
// the PIL parity path produce IDENTICAL pixels (and therefore identical
// captions).

constexpr int kPrecisionBits = 32 - 8 - 2;  // PIL Resample.c PRECISION_BITS

inline unsigned char clip8(int in) {
  if (in >= (1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return static_cast<unsigned char>(in >> kPrecisionBits);
}

// PIL precompute_coeffs + normalize_coeffs_8bpc for one output axis.
void build_coeffs(int in_size, int out_size, std::vector<int>& bounds,
                  std::vector<std::vector<int>>& weights) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = 1.0 * filterscale;  // triangle filter support = 1
  const double ss = 1.0 / filterscale;
  bounds.resize(out_size * 2);
  weights.assign(out_size, {});
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    const int n = xmax - xmin;
    std::vector<double> pre(n);
    double total = 0.0;
    for (int x = 0; x < n; ++x) {
      const double arg = (x + xmin - center + 0.5) * ss;
      const double w = std::fabs(arg) < 1.0 ? 1.0 - std::fabs(arg) : 0.0;
      pre[x] = w;
      total += w;
    }
    std::vector<int>& k = weights[i];
    k.resize(n);
    for (int x = 0; x < n; ++x) {
      const double w = total != 0.0 ? pre[x] / total : pre[x];
      // PIL normalize_coeffs_8bpc rounding
      k[x] = w < 0 ? static_cast<int>(-0.5 + w * (1 << kPrecisionBits))
                   : static_cast<int>(0.5 + w * (1 << kPrecisionBits));
    }
    bounds[i * 2] = xmin;
    bounds[i * 2 + 1] = n;
  }
}

// uint8 [h,w,3] -> uint8 [out,out,3], bit-exact PIL BILINEAR.
void resize_pil_exact(const std::vector<unsigned char>& rgb, int w, int h,
                      int out_size, std::vector<unsigned char>& out) {
  if (w == out_size && h == out_size) {
    // identity: scale=1 triangle weights are exactly {1, 0} (the canonical
    // dataset stores 224x224 frames, so this is the serving hot path)
    out = rgb;
    return;
  }
  std::vector<int> xb, yb;
  std::vector<std::vector<int>> xw, yw;
  build_coeffs(w, out_size, xb, xw);
  build_coeffs(h, out_size, yb, yw);
  const int bias = 1 << (kPrecisionBits - 1);

  // horizontal pass -> uint8 intermediate (PIL quantizes between passes)
  std::vector<unsigned char> tmp(static_cast<size_t>(h) * out_size * 3);
  for (int y = 0; y < h; ++y) {
    const unsigned char* src = rgb.data() + static_cast<size_t>(y) * w * 3;
    unsigned char* dst = tmp.data() + static_cast<size_t>(y) * out_size * 3;
    for (int x = 0; x < out_size; ++x) {
      const int xmin = xb[x * 2], n = xb[x * 2 + 1];
      const std::vector<int>& k = xw[x];
      int acc[3] = {bias, bias, bias};
      for (int j = 0; j < n; ++j) {
        const unsigned char* px = src + static_cast<size_t>(xmin + j) * 3;
        acc[0] += k[j] * px[0];
        acc[1] += k[j] * px[1];
        acc[2] += k[j] * px[2];
      }
      dst[x * 3 + 0] = clip8(acc[0]);
      dst[x * 3 + 1] = clip8(acc[1]);
      dst[x * 3 + 2] = clip8(acc[2]);
    }
  }

  // vertical pass, row-major: accumulate whole input rows into an int32 row
  // buffer (sequential access auto-vectorizes; the per-output-pixel column
  // walk strided badly through the intermediate)
  out.resize(static_cast<size_t>(out_size) * out_size * 3);
  const int row_elems = out_size * 3;
  std::vector<int> acc(row_elems);
  for (int y = 0; y < out_size; ++y) {
    const int ymin = yb[y * 2], n = yb[y * 2 + 1];
    const std::vector<int>& k = yw[y];
    std::fill(acc.begin(), acc.end(), bias);
    for (int j = 0; j < n; ++j) {
      const unsigned char* src =
          tmp.data() + static_cast<size_t>(ymin + j) * row_elems;
      const int kj = k[j];
      for (int i = 0; i < row_elems; ++i) {
        acc[i] += kj * src[i];
      }
    }
    unsigned char* dst = out.data() + static_cast<size_t>(y) * row_elems;
    for (int i = 0; i < row_elems; ++i) {
      dst[i] = clip8(acc[i]);
    }
  }
}

// One frame: decode -> PIL-exact resize -> /255 + ImageNet normalize -> CHW
// float32 (bitwise equal to the PIL fallback path load_image).
bool process_frame(const char* path, int out_size, const float* mean,
                   const float* stdv, float* out) {
  std::vector<unsigned char> rgb;
  int w = 0, h = 0;
  if (!decode_jpeg(path, rgb, w, h)) return false;
  std::vector<unsigned char> resized;
  resize_pil_exact(rgb, w, h, out_size, resized);
  const size_t plane = static_cast<size_t>(out_size) * out_size;
  for (int y = 0; y < out_size; ++y) {
    for (int x = 0; x < out_size; ++x) {
      const unsigned char* px =
          resized.data() + (static_cast<size_t>(y) * out_size + x) * 3;
      for (int c = 0; c < 3; ++c) {
        const float v = static_cast<float>(px[c]) / 255.0f;
        out[c * plane + static_cast<size_t>(y) * out_size + x] =
            (v - mean[c]) / stdv[c];
      }
    }
  }
  return true;
}

// uint8 variant: resized CHW pixels, no normalization — the device program
// normalizes (keeps the host->device transfer at 1 byte per pixel, 4x less
// wire traffic than fp32).
bool process_frame_u8(const char* path, int out_size, unsigned char* out) {
  std::vector<unsigned char> rgb;
  int w = 0, h = 0;
  if (!decode_jpeg(path, rgb, w, h)) return false;
  std::vector<unsigned char> resized;
  resize_pil_exact(rgb, w, h, out_size, resized);
  const size_t plane = static_cast<size_t>(out_size) * out_size;
  for (int y = 0; y < out_size; ++y) {
    for (int x = 0; x < out_size; ++x) {
      const unsigned char* px =
          resized.data() + (static_cast<size_t>(y) * out_size + x) * 3;
      for (int c = 0; c < 3; ++c) {
        out[c * plane + static_cast<size_t>(y) * out_size + x] = px[c];
      }
    }
  }
  return true;
}

// ---- Raw YUV 4:2:0 decode (planes ship to the device; upsample + color
// conversion run there) ------------------------------------------------------
//
// jpeg_read_raw_data returns the post-IDCT component samples BEFORE
// upsampling/color conversion — for a 4:2:0 JPEG that is 1.5 bytes/pixel
// instead of 3 (RGB), halving the host->device wire bytes. The device
// program replicates libjpeg's h2v2 fancy upsample + ycc_rgb fixed-point
// conversion bit-exactly (preprocessing/yuv420.py), so the resulting RGB
// bytes equal the PIL path and captions are unchanged.
//
// Only the identity-resize case qualifies (image dims == requested size —
// the canonical 224x224 processed-dataset frames): a resize would need
// full-resolution RGB on the host anyway. Non-420/non-YCbCr/wrong-size
// frames return "unsupported" and the caller falls back to the RGB path.

// Decode one JPEG's raw 4:2:0 planes. Layout of `out` (packed, per frame):
//   Y  [size*size] | Cb [cs*cs] | Cr [cs*cs]   where cs = (size+1)/2.
// Returns 0 ok, 1 decode error, 2 unsupported (caller falls back).
int decode_jpeg_yuv420(const char* path, int size, unsigned char* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  const bool is_420 =
      cinfo.num_components == 3 && cinfo.jpeg_color_space == JCS_YCbCr &&
      cinfo.comp_info[0].h_samp_factor == 2 && cinfo.comp_info[0].v_samp_factor == 2 &&
      cinfo.comp_info[1].h_samp_factor == 1 && cinfo.comp_info[1].v_samp_factor == 1 &&
      cinfo.comp_info[2].h_samp_factor == 1 && cinfo.comp_info[2].v_samp_factor == 1;
  if (!is_420 || static_cast<int>(cinfo.image_width) != size ||
      static_cast<int>(cinfo.image_height) != size) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return 2;
  }
  cinfo.raw_data_out = TRUE;
  jpeg_start_decompress(&cinfo);

  const int cs = (size + 1) / 2;
  unsigned char* y_out = out;
  unsigned char* cb_out = out + static_cast<size_t>(size) * size;
  unsigned char* cr_out = cb_out + static_cast<size_t>(cs) * cs;

  // libjpeg delivers one iMCU row per call: 16 luma rows + 8 chroma rows for
  // h2v2. Row buffers must be padded to the block grid.
  const int ypadw = cinfo.comp_info[0].width_in_blocks * DCTSIZE;
  const int cpadw = cinfo.comp_info[1].width_in_blocks * DCTSIZE;
  std::vector<unsigned char> ybuf(16ull * ypadw), cbbuf(8ull * cpadw), crbuf(8ull * cpadw);
  JSAMPROW yr[16], cbr[8], crr[8];
  for (int i = 0; i < 16; ++i) yr[i] = ybuf.data() + static_cast<size_t>(i) * ypadw;
  for (int i = 0; i < 8; ++i) {
    cbr[i] = cbbuf.data() + static_cast<size_t>(i) * cpadw;
    crr[i] = crbuf.data() + static_cast<size_t>(i) * cpadw;
  }
  JSAMPARRAY planes[3] = {yr, cbr, crr};
  int yrow = 0, crow = 0;
  while (cinfo.output_scanline < cinfo.output_height) {
    jpeg_read_raw_data(&cinfo, planes, 16);
    for (int i = 0; i < 16 && yrow < size; ++i, ++yrow)
      std::memcpy(y_out + static_cast<size_t>(yrow) * size, yr[i], size);
    for (int i = 0; i < 8 && crow < cs; ++i, ++crow) {
      std::memcpy(cb_out + static_cast<size_t>(crow) * cs, cbr[i], cs);
      std::memcpy(cr_out + static_cast<size_t>(crow) * cs, crr[i], cs);
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  return 0;
}

}  // namespace

// out: [n_frames, size*size + 2*cs*cs] packed raw planes (cs = (size+1)/2).
// Returns 0 ok; i+1 = frame i failed to decode; -(i+1) = frame i unsupported
// (not 4:2:0 YCbCr at exactly [size x size]) — caller falls back to RGB.
extern "C" int vct_load_frames_yuv420(const char* const* paths, int n_frames,
                                      int size, unsigned char* out,
                                      int n_threads) {
  if (n_frames <= 0) return 0;
  if (n_threads <= 0) n_threads = 1;
  n_threads = std::min(n_threads, n_frames);
  const int cs = (size + 1) / 2;
  const size_t frame_elems =
      static_cast<size_t>(size) * size + 2ull * cs * cs;
  std::atomic<int> next(0), failed(0);
  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n_frames || failed.load()) break;
      const int rc = decode_jpeg_yuv420(
          paths[i], size, out + static_cast<size_t>(i) * frame_elems);
      if (rc != 0) {
        int expect = 0;
        failed.compare_exchange_strong(expect, rc == 2 ? -(i + 1) : i + 1);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failed.load();
}

extern "C" int vct_load_frames_u8(const char* const* paths, int n_frames,
                                  int image_size, unsigned char* out,
                                  int n_threads) {
  if (n_frames <= 0) return 0;
  if (n_threads <= 0) n_threads = 1;
  n_threads = std::min(n_threads, n_frames);
  const size_t frame_elems = 3ull * image_size * image_size;
  std::atomic<int> next(0), failed(0);
  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n_frames || failed.load()) break;
      if (!process_frame_u8(paths[i], image_size,
                            out + static_cast<size_t>(i) * frame_elems)) {
        int expect = 0;
        failed.compare_exchange_strong(expect, i + 1);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failed.load();
}

extern "C" int vct_load_frames(const char* const* paths, int n_frames,
                               int image_size, const float* mean3,
                               const float* std3, float* out, int n_threads) {
  if (n_frames <= 0) return 0;
  if (n_threads <= 0) n_threads = 1;
  n_threads = std::min(n_threads, n_frames);
  const size_t frame_elems = 3ull * image_size * image_size;
  std::atomic<int> next(0), failed(0);

  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n_frames || failed.load()) break;
      if (!process_frame(paths[i], image_size, mean3, std3,
                         out + static_cast<size_t>(i) * frame_elems)) {
        int expect = 0;
        failed.compare_exchange_strong(expect, i + 1);
      }
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failed.load();
}
