// Native JPEG frame decoder of bsvd_tpu_torch (the JPEG half of the JAX
// package's bsvd_tpu/data/_native/decoder.cpp; PNG frames take the port's
// zlib reader, data/png_decode.py): a C++ thread pool decodes JPEG frames
// with libjpeg and crops them straight into the caller's buffer, RGB8.
// Exposed through a minimal C API bound with ctypes
// (bsvd_tpu_torch/data/native_decode.py), which builds it at first use:
//
//   g++ -O3 -shared -fPIC decoder.cpp -o libbsvd_decode.so -ljpeg -pthread

#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

extern "C" {
#include <jpeglib.h>
}

namespace {

// ---------------------------------------------------------------------------
// JPEG decode (RGB8)
// ---------------------------------------------------------------------------

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

bool decode_jpeg(const unsigned char* data, size_t len, std::vector<unsigned char>* out,
                 int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  const int stride = cinfo.output_width * cinfo.output_components;
  out->resize(static_cast<size_t>(*h) * stride);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out->data() + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_any(const unsigned char* data, size_t len, std::vector<unsigned char>* out,
                int* h, int* w) {
  if (len >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF) {
    return decode_jpeg(data, len, out, h, w);
  }
  return false;
}

// ---------------------------------------------------------------------------
// ROI decode: decode ONLY the crop window (training crops are 96x96 from
// 480p+ frames — full-frame decode wastes >95% of the IDCT work).
// JPEG uses libjpeg-turbo's partial-image API (jpeg_crop_scanline restricts
// the column range to iMCU-aligned bounds; jpeg_skip_scanlines skips the
// IDCT + color conversion of rows above/below). Writes (ch, cw, 3) RGB8
// rows at dst (stride cw*3).
// ---------------------------------------------------------------------------

bool decode_jpeg_roi(const unsigned char* data, size_t len, int y0, int x0,
                     int ch, int cw, unsigned char* dst) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  std::vector<unsigned char> rowbuf;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (y0 < 0 || x0 < 0 ||
      static_cast<JDIMENSION>(y0 + ch) > cinfo.output_height ||
      static_cast<JDIMENSION>(x0 + cw) > cinfo.output_width) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  // restrict columns; the library aligns the window outward to iMCU
  // bounds. Widen the request by one iMCU on each side first: the fancy
  // upsampler needs the neighboring chroma column, so the edge columns of
  // a tight window would differ from a full decode on subsampled sources.
  const int imcu_w = cinfo.max_h_samp_factor * DCTSIZE;
  const int wx0 = x0 < imcu_w ? 0 : x0 - imcu_w;
  const int wx1 = (x0 + cw + imcu_w > static_cast<int>(cinfo.output_width))
                      ? static_cast<int>(cinfo.output_width)
                      : x0 + cw + imcu_w;
  JDIMENSION xoff = wx0, xw = wx1 - wx0;
  jpeg_crop_scanline(&cinfo, &xoff, &xw);
  rowbuf.resize(static_cast<size_t>(xw) * cinfo.output_components);
  // jpeg_skip_scanlines drops the fancy-upsampler's cross-row chroma
  // context at the skip boundary (first rows after a skip differ on
  // 4:2:0 sources) — skip only to ONE iMCU row before the target and
  // decode-and-discard the rest, which rebuilds the context exactly.
  const int imcu = cinfo.max_v_samp_factor * DCTSIZE;
  const int skip = y0 <= imcu ? 0 : (y0 / imcu - 1) * imcu;
  if (skip > 0) jpeg_skip_scanlines(&cinfo, skip);
  for (int y = skip; y < y0; ++y) {
    unsigned char* row = rowbuf.data();
    if (jpeg_read_scanlines(&cinfo, &row, 1) != 1) {
      jpeg_abort_decompress(&cinfo);
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
  }
  const size_t col_off = static_cast<size_t>(x0 - xoff) * 3;
  for (int r = 0; r < ch; ++r) {
    unsigned char* row = rowbuf.data();
    if (jpeg_read_scanlines(&cinfo, &row, 1) != 1) {
      jpeg_abort_decompress(&cinfo);
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    memcpy(dst + static_cast<size_t>(r) * cw * 3, rowbuf.data() + col_off,
           static_cast<size_t>(cw) * 3);
  }
  jpeg_abort_decompress(&cinfo);  // rows below the window are never decoded
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_any_roi(const unsigned char* data, size_t len, int y0, int x0,
                    int ch, int cw, unsigned char* dst) {
  if (len >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF) {
    return decode_jpeg_roi(data, len, y0, x0, ch, cw, dst);
  }
  return false;
}

bool read_file(const char* path, std::vector<unsigned char>* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz <= 0) {
    fclose(f);
    return false;
  }
  buf->resize(sz);
  const bool ok = fread(buf->data(), 1, sz, f) == static_cast<size_t>(sz);
  fclose(f);
  return ok;
}

// ---------------------------------------------------------------------------
// thread pool
// ---------------------------------------------------------------------------

class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] { Loop(); });
    }
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void Submit(std::function<void()> job) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

 private:
  void Loop() {
    for (;;) {
      std::function<void()> job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
        if (stop_ && jobs_.empty()) return;
        job = std::move(jobs_.front());
        jobs_.pop();
      }
      job();
    }
  }
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_ = false;
};

struct Latch {
  explicit Latch(int n) : count(n) {}
  void Done() {
    std::lock_guard<std::mutex> lk(mu);
    if (--count == 0) cv.notify_all();
  }
  void Wait() {
    std::unique_lock<std::mutex> lk(mu);
    cv.wait(lk, [this] { return count == 0; });
  }
  int count;
  std::mutex mu;
  std::condition_variable cv;
};

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

struct BsvdLoader {
  ThreadPool* pool;
};

BsvdLoader* bsvd_loader_create(int num_threads) {
  auto* l = new BsvdLoader();
  l->pool = new ThreadPool(num_threads > 0 ? num_threads : 4);
  return l;
}

void bsvd_loader_destroy(BsvdLoader* l) {
  if (!l) return;
  delete l->pool;
  delete l;
}

// Decode one image file to RGB8 HWC. Returns 0 on success. The caller frees
// *out with bsvd_free.
int bsvd_decode_file(const char* path, unsigned char** out, int* h, int* w) {
  std::vector<unsigned char> buf;
  if (!read_file(path, &buf)) return 1;
  std::vector<unsigned char> img;
  if (!decode_any(buf.data(), buf.size(), &img, h, w)) return 2;
  *out = static_cast<unsigned char*>(malloc(img.size()));
  memcpy(*out, img.data(), img.size());
  return 0;
}

void bsvd_free(void* p) { free(p); }

// Decode T image files in parallel, crop each to (ch, cw) at (y0, x0), and
// write a contiguous (T, ch, cw, 3) RGB8 tensor into `out`. Negative y0/x0
// disable cropping (then every image must be exactly (ch, cw)).
// Returns 0 on success, else the 1-based index of the first failing frame.
int bsvd_load_crop_seq(const char** paths, int t, int y0, int x0, int ch,
                       int cw, unsigned char* out, BsvdLoader* l) {
  std::vector<int> status(t, 0);
  Latch latch(t);
  for (int i = 0; i < t; ++i) {
    auto job = [&, i] {
      std::vector<unsigned char> buf, img;
      if (!read_file(paths[i], &buf)) {
        status[i] = 1;
        latch.Done();
        return;
      }
      unsigned char* dst = out + static_cast<size_t>(i) * ch * cw * 3;
      // window decode: only the crop region's rows/columns pass through
      // the IDCT — full-frame decode for a 96x96
      // training crop wastes >95% of the decode work
      if (decode_any_roi(buf.data(), buf.size(), y0 < 0 ? 0 : y0,
                         x0 < 0 ? 0 : x0, ch, cw, dst)) {
        latch.Done();
        return;
      }
      int h = 0, w = 0;
      if (!decode_any(buf.data(), buf.size(), &img, &h, &w)) {
        status[i] = 1;
        latch.Done();
        return;
      }
      int yy = y0 < 0 ? 0 : y0;
      int xx = x0 < 0 ? 0 : x0;
      if (yy + ch > h || xx + cw > w) {
        status[i] = 2;
        latch.Done();
        return;
      }
      for (int r = 0; r < ch; ++r) {
        memcpy(dst + static_cast<size_t>(r) * cw * 3,
               img.data() + (static_cast<size_t>(yy + r) * w + xx) * 3,
               static_cast<size_t>(cw) * 3);
      }
      latch.Done();
    };
    if (l && l->pool) {
      l->pool->Submit(job);
    } else {
      job();
    }
  }
  latch.Wait();
  for (int i = 0; i < t; ++i) {
    if (status[i]) return i + 1;
  }
  return 0;
}

// Probe JPEG dimensions from the header alone.
int bsvd_image_dims(const char* path, int* h, int* w) {
  std::vector<unsigned char> buf;
  if (!read_file(path, &buf)) return 1;
  if (buf.size() < 3 || buf[0] != 0xFF || buf[1] != 0xD8) return 2;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf.data(), buf.size());
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
