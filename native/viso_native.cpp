// Native runtime: host-side image decode + prefetch executor.
//
// The reference does all image I/O through OpenCV's synchronous imread inside
// the frame loop (StereoImageGenerator, src/viso.h:81-101) — decode time sits
// on the critical path.  Here the runtime half of the framework is native
// C++ like the reference's, but redesigned for an accelerator host: a pool of decode
// threads runs ahead of the consumer and delivers frames IN ORDER through a
// bounded ring of slots, so PNG inflate/unfilter overlaps device compute and
// the Python layer only memcpy's into the staging buffer it hands to jax.
//
// C ABI (consumed via ctypes from libviso_tpu/native/__init__.py):
//   vn_decode_png_gray   one-shot decode of a PNG file to 8-bit grayscale
//   vn_decode_image_gray one-shot decode with magic-byte format sniffing
//                        (PNG or JPEG -> 8-bit grayscale; the mono driver
//                        reads the reference's img-%04d.jpg contract,
//                        src/calib_sfm.cpp:56-64)
//   vn_png_dims          peek (height, width) without full decode
//   vn_stream_open/next/close
//                        threaded in-order prefetch over a path list
//                        (per-file format sniffing, PNG or JPEG)
//   vn_version           ABI version stamp
//
// Build: g++ -O3 -fPIC -shared -pthread viso_native.cpp -lpng -ljpeg -lz
//        (see libviso_tpu/native/build.py).  Hosts without libpng build
//        with -DVN_NO_LIBPNG -DVN_NO_JPEG -lz: PNGs then decode through
//        the zlib-only decoder below.

#include <cstdio>   // jpeglib.h needs FILE declared before inclusion

#ifndef VN_NO_JPEG
#include <jpeglib.h>
#endif
#ifdef VN_NO_LIBPNG
#include <zlib.h>
#else
#include <png.h>
#endif

#include <csetjmp>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kAbiVersion = 2;

// Error codes (negative; 0 = ok, 1 = end-of-stream for vn_stream_next).
enum VnError {
  VN_OK = 0,
  VN_EOS = 1,
  VN_ERR_OPEN = -1,
  VN_ERR_BAD_FORMAT = -2,  // not a PNG/JPEG
  VN_ERR_DECODE = -3,
  VN_ERR_CAPACITY = -4,
  VN_ERR_BAD_HANDLE = -5,
};

constexpr uint8_t kPngSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n',
                                      0x1a, '\n'};

struct GrayImage {
  int height = 0;
  int width = 0;
  std::vector<uint8_t> pixels;
  int status = VN_OK;
};

#ifdef VN_NO_LIBPNG
// Decode one PNG file to tightly-packed 8-bit grayscale rows without
// libpng: zlib inflate plus the five scanline filters.  Covers 8- and
// 16-bit gray, gray+alpha, RGB and RGBA, non-interlaced; 16-bit keeps the
// high byte, alpha is dropped, and RGB -> luma uses PIL's convert("L")
// fixed point, as libviso_tpu/io/png.py does.  Palette, sub-byte depths
// and interlaced files report VN_ERR_BAD_FORMAT.
uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

int decode_png_gray(const char* path, GrayImage* out) {
  std::FILE* fp = std::fopen(path, "rb");
  if (!fp) return VN_ERR_OPEN;
  std::vector<uint8_t> file;
  uint8_t block[1 << 16];
  size_t got;
  while ((got = std::fread(block, 1, sizeof(block), fp)) > 0)
    file.insert(file.end(), block, block + got);
  std::fclose(fp);
  if (file.size() < 8 || std::memcmp(file.data(), kPngSignature, 8) != 0)
    return VN_ERR_BAD_FORMAT;

  uint32_t width = 0, height = 0;
  int depth = 0, color = -1, interlace = 0;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  while (pos + 12 <= file.size()) {
    const uint32_t len = be32(&file[pos]);
    if (len > file.size() - pos - 12) return VN_ERR_DECODE;
    const uint8_t* type = &file[pos + 4];
    const uint8_t* data = &file[pos + 8];
    const uint32_t crc = be32(data + len);
    if (crc32(crc32(0L, type, 4), data, len) != crc) return VN_ERR_DECODE;
    if (std::memcmp(type, "IHDR", 4) == 0 && len == 13) {
      width = be32(data);
      height = be32(data + 4);
      depth = data[8];
      color = data[9];
      interlace = data[12];
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + static_cast<size_t>(len);
  }
  int channels = 0;
  switch (color) {
    case 0: channels = 1; break;
    case 2: channels = 3; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: return VN_ERR_BAD_FORMAT;
  }
  if ((depth != 8 && depth != 16) || interlace != 0) return VN_ERR_BAD_FORMAT;
  if (width == 0 || height == 0 || idat.empty()) return VN_ERR_DECODE;

  const size_t bpp = static_cast<size_t>(channels) * depth / 8;
  const size_t stride = bpp * width;
  std::vector<uint8_t> raw(height * (stride + 1));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return VN_ERR_DECODE;

  std::vector<uint8_t> zero(stride, 0);
  for (uint32_t y = 0; y < height; ++y) {
    uint8_t* row = &raw[y * (stride + 1)];
    const int filter = row[0];
    uint8_t* cur = row + 1;
    const uint8_t* up = y ? &raw[(y - 1) * (stride + 1) + 1] : zero.data();
    for (size_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = up[i];
      const int c = i >= bpp ? up[i - bpp] : 0;
      int pred;
      switch (filter) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: return VN_ERR_DECODE;
      }
      cur[i] = static_cast<uint8_t>(cur[i] + pred);
    }
  }

  out->height = static_cast<int>(height);
  out->width = static_cast<int>(width);
  out->pixels.resize(static_cast<size_t>(height) * width);
  const size_t sample = depth / 8;  // 16-bit: the high byte comes first
  for (uint32_t y = 0; y < height; ++y) {
    const uint8_t* px = &raw[y * (stride + 1) + 1];
    uint8_t* dst = &out->pixels[static_cast<size_t>(y) * width];
    for (uint32_t x = 0; x < width; ++x, px += bpp) {
      if (channels <= 2) {
        dst[x] = px[0];
      } else {
        const uint32_t r = px[0], g = px[sample], b = px[2 * sample];
        dst[x] = static_cast<uint8_t>(
            (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16);
      }
    }
  }
  return VN_OK;
}

#else
// Decode one PNG file to tightly-packed 8-bit grayscale rows.
// Any input depth/color layout is normalized: palette -> RGB, 16 -> 8 bit,
// <8-bit gray expanded, alpha stripped, RGB -> luma with ITU-R 601
// coefficients (matching PIL's convert("L"), so the Python fallback and the
// native path agree to within rounding).
int decode_png_gray(const char* path, GrayImage* out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return VN_ERR_OPEN;

  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return VN_ERR_BAD_FORMAT;
  }

  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return VN_ERR_DECODE;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(fp);
    return VN_ERR_DECODE;
  }
  if (setjmp(png_jmpbuf(png))) {  // libpng's error path longjmps here
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return VN_ERR_DECODE;
  }

  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  const png_uint_32 width = png_get_image_width(png, info);
  const png_uint_32 height = png_get_image_height(png, info);
  const png_byte color = png_get_color_type(png, info);
  const png_byte depth = png_get_bit_depth(png, info);

  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (depth == 16) png_set_strip_16(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE) {
    // 1/100000-scale fixed-point luma weights: 0.299 R + 0.587 G (+0.114 B).
    png_set_rgb_to_gray_fixed(png, 1 /* silent on non-gray */, 29900, 58700);
  }
  png_read_update_info(png, info);

  out->height = static_cast<int>(height);
  out->width = static_cast<int>(width);
  out->pixels.resize(static_cast<size_t>(height) * width);

  std::vector<png_bytep> rows(height);
  for (png_uint_32 y = 0; y < height; ++y)
    rows[y] = out->pixels.data() + static_cast<size_t>(y) * width;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);

  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return VN_OK;
}
#endif  // VN_NO_LIBPNG

// Decode one JPEG file to tightly-packed 8-bit grayscale rows via libjpeg's
// native JCS_GRAYSCALE output (IJG luma for color inputs — the same ITU-R
// 601 weighting class as the PNG path and PIL's convert("L")).
// Compiled out when the host has no libjpeg (build.py retries with
// -DVN_NO_JPEG so PNG decode + prefetch survive); JPEGs then report
// VN_ERR_BAD_FORMAT and the Python PIL fallback covers them.
#ifdef VN_NO_JPEG
int decode_jpeg_gray(const char*, GrayImage*) { return VN_ERR_BAD_FORMAT; }
#else
struct VnJpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jump;
};

void vn_jpeg_error_exit(j_common_ptr cinfo) {
  VnJpegErr* err = reinterpret_cast<VnJpegErr*>(cinfo->err);
  std::longjmp(err->jump, 1);
}

int decode_jpeg_gray(const char* path, GrayImage* out) {
  std::FILE* fp = std::fopen(path, "rb");
  if (!fp) return VN_ERR_OPEN;

  jpeg_decompress_struct cinfo;
  VnJpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = vn_jpeg_error_exit;
  if (setjmp(jerr.jump)) {  // libjpeg's fatal-error path longjmps here
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return VN_ERR_DECODE;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return VN_ERR_DECODE;
  }
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);

  out->height = static_cast<int>(cinfo.output_height);
  out->width = static_cast<int>(cinfo.output_width);
  out->pixels.resize(static_cast<size_t>(out->height) * out->width);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out->pixels.data() +
                   static_cast<size_t>(cinfo.output_scanline) * out->width;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(fp);
  return VN_OK;
}
#endif  // VN_NO_JPEG

// Magic-byte dispatch: PNG (\x89PNG) or JPEG (\xFF\xD8).
int decode_image_gray(const char* path, GrayImage* out) {
  std::FILE* fp = std::fopen(path, "rb");
  if (!fp) return VN_ERR_OPEN;
  unsigned char magic[2] = {0, 0};
  const size_t got = std::fread(magic, 1, 2, fp);
  std::fclose(fp);
  if (got != 2) return VN_ERR_BAD_FORMAT;  // <2 bytes: not any image
  if (magic[0] == 0xFF && magic[1] == 0xD8) return decode_jpeg_gray(path, out);
  if (magic[0] == 0x89 && magic[1] == 'P') return decode_png_gray(path, out);
  return VN_ERR_BAD_FORMAT;
}

// In-order prefetch executor.  Worker threads claim indices from an atomic
// counter and decode ahead of the consumer, bounded by `depth` outstanding
// items; the consumer blocks on its next index.  Delivery order is exactly
// the path-list order regardless of decode completion order.
class PrefetchStream {
 public:
  PrefetchStream(std::vector<std::string> paths, int threads, int depth)
      : paths_(std::move(paths)),
        depth_(depth < 1 ? 1 : depth),
        next_claim_(0),
        next_deliver_(0),
        stop_(false) {
    int n = threads < 1 ? 1 : threads;
    workers_.reserve(n);
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { worker_loop(); });
  }

  ~PrefetchStream() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_space_.notify_all();
    cv_ready_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Blocks until the next in-order frame is decoded.  Returns VN_EOS when
  // the path list is exhausted, VN_ERR_* on a decode failure (the stream
  // stays usable; subsequent frames still arrive).
  int next(uint8_t* out, int64_t cap, int* h, int* w) {
    std::unique_lock<std::mutex> lock(mu_);
    const size_t want = next_deliver_;
    if (want >= paths_.size()) return VN_EOS;
    cv_ready_.wait(lock, [&] { return done_.count(want) || stop_; });
    if (stop_ && !done_.count(want)) return VN_ERR_BAD_HANDLE;

    GrayImage img = std::move(done_[want]);
    done_.erase(want);
    ++next_deliver_;
    lock.unlock();
    cv_space_.notify_all();

    if (img.status != VN_OK) return img.status;
    const int64_t n = static_cast<int64_t>(img.height) * img.width;
    if (n > cap) return VN_ERR_CAPACITY;
    std::memcpy(out, img.pixels.data(), static_cast<size_t>(n));
    *h = img.height;
    *w = img.width;
    return VN_OK;
  }

 private:
  void worker_loop() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lock(mu_);
        // Bound read-ahead: don't claim more than `depth` past the consumer.
        cv_space_.wait(lock, [&] {
          return stop_ ||
                 (next_claim_ < paths_.size() &&
                  next_claim_ < next_deliver_ + static_cast<size_t>(depth_));
        });
        if (stop_ || next_claim_ >= paths_.size()) return;
        idx = next_claim_++;
      }
      GrayImage img;
      img.status = decode_image_gray(paths_[idx].c_str(), &img);
      {
        std::lock_guard<std::mutex> lock(mu_);
        done_[idx] = std::move(img);
      }
      cv_ready_.notify_all();
    }
  }

  std::vector<std::string> paths_;
  const int depth_;
  size_t next_claim_;
  size_t next_deliver_;
  bool stop_;
  std::map<size_t, GrayImage> done_;
  std::mutex mu_;
  std::condition_variable cv_ready_;
  std::condition_variable cv_space_;
  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

int vn_version() { return kAbiVersion; }

// Decode `path` into caller buffer `out` (capacity `cap` bytes, row-major
// h*w grayscale).  Writes dims to *h/*w.  Returns VN_OK or a VN_ERR_*.
int vn_decode_png_gray(const char* path, uint8_t* out, int64_t cap, int* h,
                       int* w) {
  GrayImage img;
  int rc = decode_png_gray(path, &img);
  if (rc != VN_OK) return rc;
  const int64_t n = static_cast<int64_t>(img.height) * img.width;
  if (n > cap) return VN_ERR_CAPACITY;
  std::memcpy(out, img.pixels.data(), static_cast<size_t>(n));
  *h = img.height;
  *w = img.width;
  return VN_OK;
}

// Decode PNG or JPEG (magic-byte sniffed) into the caller buffer.
int vn_decode_image_gray(const char* path, uint8_t* out, int64_t cap,
                         int* h, int* w) {
  GrayImage img;
  int rc = decode_image_gray(path, &img);
  if (rc != VN_OK) return rc;
  const int64_t n = static_cast<int64_t>(img.height) * img.width;
  if (n > cap) return VN_ERR_CAPACITY;
  std::memcpy(out, img.pixels.data(), static_cast<size_t>(n));
  *h = img.height;
  *w = img.width;
  return VN_OK;
}

// Read only the IHDR to get dimensions (no pixel decode).
int vn_png_dims(const char* path, int* h, int* w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return VN_ERR_OPEN;
  // 8-byte signature + IHDR chunk: length(4) type(4) width(4) height(4)
  uint8_t buf[24];
  if (std::fread(buf, 1, 24, fp) != 24 ||
      std::memcmp(buf, kPngSignature, 8) != 0 ||
      std::memcmp(buf + 12, "IHDR", 4) != 0) {
    std::fclose(fp);
    return VN_ERR_BAD_FORMAT;
  }
  std::fclose(fp);
  *w = (buf[16] << 24) | (buf[17] << 16) | (buf[18] << 8) | buf[19];
  *h = (buf[20] << 24) | (buf[21] << 16) | (buf[22] << 8) | buf[23];
  return VN_OK;
}

// Open a prefetch stream over `n` NUL-terminated paths.  `threads` decode
// workers run up to `depth` frames ahead.  Returns an opaque handle.
void* vn_stream_open(const char** paths, int n, int threads, int depth) {
  if (n < 0) return nullptr;
  std::vector<std::string> v;
  v.reserve(static_cast<size_t>(n));
  for (int i = 0; i < n; ++i) v.emplace_back(paths[i]);
  return new PrefetchStream(std::move(v), threads, depth);
}

int vn_stream_next(void* handle, uint8_t* out, int64_t cap, int* h, int* w) {
  if (!handle) return VN_ERR_BAD_HANDLE;
  return static_cast<PrefetchStream*>(handle)->next(out, cap, h, w);
}

void vn_stream_close(void* handle) {
  delete static_cast<PrefetchStream*>(handle);
}

}  // extern "C"
