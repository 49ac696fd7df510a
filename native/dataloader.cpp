// Native RGB-D sequence loader with threaded prefetch.
//
// Equivalent of the reference's C++ input layer
// (GUI/src/Tools/: RawLogReader for .klg logs, TUM association — expected
// upstream layout, SURVEY.md §3 "Input readers").  The device pipeline
// (JAX) must never stall on host-side PNG/JPEG/zlib decode, so decoding
// runs in a worker-thread pool filling a bounded ring buffer ahead of the
// consumer; the Python side (datasets/native_loader.py, ctypes) pops
// ready frames and ships them to the chip.
//
// Formats:
//  - TUM directories: depth/*.png (16-bit grayscale, 1/5000 m),
//    rgb/*.png (8-bit RGB), association by nearest timestamp.
//  - .klg logs (the reference's capture format): per frame
//    [i64 timestamp][i32 depthSize][i32 imageSize][zlib'd u16 depth]
//    [JPEG rgb], header [i32 numFrames].
//
// C ABI exports (used via ctypes):
//   ifl_open_tum / ifl_open_klg -> handle
//   ifl_frame_count, ifl_width, ifl_height
//   ifl_next(handle, depth_m_out, rgb_out, ts_out) -> frame idx or -1
//   ifl_close

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>
#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <fstream>
#include <memory>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<float> depth_m;   // H*W meters, 0 invalid
  std::vector<uint8_t> rgb;     // H*W*3
  double timestamp = 0.0;
  int index = -1;
  bool ok = false;
};

// ---------------------------------------------------------------- PNG I/O
bool read_png(const std::string& path, std::vector<uint8_t>& out, int& w,
              int& h, int& channels, int& bit_depth) {
  FILE* fp = std::fopen(path.c_str(), "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  w = png_get_image_width(png, info);
  h = png_get_image_height(png, info);
  bit_depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  channels = png_get_channels(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  out.resize(rowbytes * h);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y) rows[y] = out.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

// --------------------------------------------------------------- JPEG I/O
bool decode_jpeg(const uint8_t* data, size_t size, std::vector<uint8_t>& out,
                 int& w, int& h) {
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data),
               static_cast<unsigned long>(size));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  out.resize(static_cast<size_t>(w) * h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ----------------------------------------------------------- source kinds
struct TumEntry {
  double ts;
  std::string depth_path;
  std::string rgb_path;
};

struct KlgEntry {
  int64_t timestamp;
  std::streamoff offset;  // of the depth payload
  int32_t depth_size;
  int32_t image_size;
};

struct Source {
  // TUM
  std::vector<TumEntry> tum;
  // KLG
  std::string klg_path;
  std::vector<KlgEntry> klg;
  float depth_scale = 1.0f / 5000.0f;  // TUM convention
  bool is_klg = false;
  int width = 0, height = 0;
};

bool parse_tum_dir(const std::string& dir, Source& src) {
  auto parse_list = [](const std::string& path)
      -> std::vector<std::pair<double, std::string>> {
    std::vector<std::pair<double, std::string>> out;
    std::ifstream f(path);
    std::string line;
    while (std::getline(f, line)) {
      if (line.empty() || line[0] == '#') continue;
      std::istringstream ss(line);
      double ts;
      std::string rel;
      if (ss >> ts >> rel) out.emplace_back(ts, rel);
    }
    return out;
  };
  auto depth = parse_list(dir + "/depth.txt");
  auto rgb = parse_list(dir + "/rgb.txt");
  if (depth.empty() || rgb.empty()) return false;
  // Associate each depth frame with the nearest rgb timestamp (<= 20 ms),
  // the standard TUM association policy.
  size_t j = 0;
  for (auto& d : depth) {
    while (j + 1 < rgb.size() &&
           std::abs(rgb[j + 1].first - d.first) <= std::abs(rgb[j].first - d.first))
      ++j;
    if (std::abs(rgb[j].first - d.first) > 0.02) continue;
    src.tum.push_back({d.first, dir + "/" + d.second, dir + "/" + rgb[j].second});
  }
  return !src.tum.empty();
}

bool parse_klg(const std::string& path, Source& src) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  int32_t num = 0;
  f.read(reinterpret_cast<char*>(&num), 4);
  for (int32_t i = 0; i < num && f; ++i) {
    KlgEntry e{};
    f.read(reinterpret_cast<char*>(&e.timestamp), 8);
    f.read(reinterpret_cast<char*>(&e.depth_size), 4);
    f.read(reinterpret_cast<char*>(&e.image_size), 4);
    e.offset = f.tellg();
    if (!f || e.depth_size < 0 || e.image_size < 0) break;
    f.seekg(static_cast<std::streamoff>(e.depth_size) + e.image_size,
            std::ios::cur);
    src.klg.push_back(e);
  }
  src.klg_path = path;
  src.is_klg = true;
  src.depth_scale = 1.0f / 1000.0f;  // klg depth is millimeters
  return !src.klg.empty();
}

bool decode_frame(const Source& src, int idx, int want_w, int want_h,
                  Frame& fr) {
  fr.index = idx;
  fr.ok = false;
  if (!src.is_klg) {
    const TumEntry& e = src.tum[idx];
    fr.timestamp = e.ts;
    std::vector<uint8_t> dbuf, cbuf;
    int dw, dh, dch, dbits, cw, ch_, cch, cbits;
    if (!read_png(e.depth_path, dbuf, dw, dh, dch, dbits)) return false;
    if (!read_png(e.rgb_path, cbuf, cw, ch_, cch, cbits)) return false;
    if (dbits != 16 || dch != 1 || cch < 3) return false;
    fr.depth_m.resize(static_cast<size_t>(dw) * dh);
    const uint8_t* p = dbuf.data();  // PNG 16-bit is big-endian
    for (size_t i = 0; i < fr.depth_m.size(); ++i) {
      uint16_t v = static_cast<uint16_t>((p[2 * i] << 8) | p[2 * i + 1]);
      fr.depth_m[i] = v * src.depth_scale;
    }
    fr.rgb.resize(static_cast<size_t>(cw) * ch_ * 3);
    for (size_t i = 0; i < static_cast<size_t>(cw) * ch_; ++i)
      std::memcpy(&fr.rgb[3 * i], &cbuf[cch * i], 3);
    fr.ok = (dw == want_w && dh == want_h && cw == want_w && ch_ == want_h);
    return fr.ok;
  }
  const KlgEntry& e = src.klg[idx];
  fr.timestamp = static_cast<double>(e.timestamp) * 1e-6;
  std::ifstream f(src.klg_path, std::ios::binary);
  f.seekg(e.offset);
  std::vector<uint8_t> dcomp(e.depth_size), jbuf(e.image_size);
  f.read(reinterpret_cast<char*>(dcomp.data()), e.depth_size);
  f.read(reinterpret_cast<char*>(jbuf.data()), e.image_size);
  if (!f) return false;
  std::vector<uint16_t> draw(static_cast<size_t>(want_w) * want_h);
  uLongf dlen = static_cast<uLongf>(draw.size() * 2);
  if (uncompress(reinterpret_cast<Bytef*>(draw.data()), &dlen, dcomp.data(),
                 e.depth_size) != Z_OK ||
      dlen != draw.size() * 2)
    return false;
  fr.depth_m.resize(draw.size());
  for (size_t i = 0; i < draw.size(); ++i)
    fr.depth_m[i] = draw[i] * src.depth_scale;
  int jw, jh;
  if (!decode_jpeg(jbuf.data(), jbuf.size(), fr.rgb, jw, jh)) return false;
  fr.ok = (jw == want_w && jh == want_h);
  return fr.ok;
}

// ------------------------------------------------------ prefetching loader
class Loader {
 public:
  Loader(Source src, int width, int height, int queue_depth, int workers)
      : src_(std::move(src)), width_(width), height_(height),
        capacity_(std::max(queue_depth, 2)) {
    count_ = src_.is_klg ? static_cast<int>(src_.klg.size())
                         : static_cast<int>(src_.tum.size());
    slots_.resize(capacity_);
    for (int t = 0; t < std::max(workers, 1); ++t)
      threads_.emplace_back([this] { worker(); });
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_work_.notify_all();
    cv_ready_.notify_all();
    for (auto& t : threads_) t.join();
  }

  int count() const { return count_; }
  int width() const { return width_; }
  int height() const { return height_; }

  // Blocking pop of the next in-order frame; returns index or -1 at end.
  int next(float* depth_out, uint8_t* rgb_out, double* ts_out) {
    std::unique_lock<std::mutex> lk(mu_);
    if (next_out_ >= count_) return -1;
    int want = next_out_;
    Frame& slot = slots_[want % capacity_];
    cv_ready_.wait(lk, [&] { return stop_ || (slot.index == want); });
    if (stop_ && slot.index != want) return -1;
    ++next_out_;
    Frame fr = std::move(slot);
    slot = Frame{};
    cv_work_.notify_all();
    lk.unlock();
    if (!fr.ok) return -2;  // decode error: caller may skip
    std::memcpy(depth_out, fr.depth_m.data(), fr.depth_m.size() * 4);
    std::memcpy(rgb_out, fr.rgb.data(), fr.rgb.size());
    if (ts_out) *ts_out = fr.timestamp;
    return fr.index;
  }

 private:
  void worker() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_work_.wait(lk, [&] {
          return stop_ ||
                 (next_in_ < count_ && next_in_ - next_out_ < capacity_);
        });
        if (stop_) return;
        idx = next_in_++;
      }
      Frame fr;
      decode_frame(src_, idx, width_, height_, fr);
      {
        std::lock_guard<std::mutex> lk(mu_);
        slots_[idx % capacity_] = std::move(fr);
      }
      cv_ready_.notify_all();
    }
  }

  Source src_;
  int width_, height_, capacity_, count_ = 0;
  std::vector<Frame> slots_;
  std::vector<std::thread> threads_;
  std::mutex mu_;
  std::condition_variable cv_work_, cv_ready_;
  int next_in_ = 0;
  int next_out_ = 0;
  bool stop_ = false;
};

}  // namespace

extern "C" {

void* ifl_open_tum(const char* dir, int width, int height, int queue_depth,
                   int workers) {
  Source src;
  if (!parse_tum_dir(dir, src)) return nullptr;
  return new Loader(std::move(src), width, height, queue_depth, workers);
}

void* ifl_open_klg(const char* path, int width, int height, int queue_depth,
                   int workers) {
  Source src;
  if (!parse_klg(path, src)) return nullptr;
  return new Loader(std::move(src), width, height, queue_depth, workers);
}

int ifl_frame_count(void* h) { return static_cast<Loader*>(h)->count(); }
int ifl_width(void* h) { return static_cast<Loader*>(h)->width(); }
int ifl_height(void* h) { return static_cast<Loader*>(h)->height(); }

int ifl_next(void* h, float* depth_out, uint8_t* rgb_out, double* ts_out) {
  return static_cast<Loader*>(h)->next(depth_out, rgb_out, ts_out);
}

void ifl_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
