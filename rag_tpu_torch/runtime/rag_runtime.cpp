// rag_runtime: the native data plane of rag_tpu_torch's file datasets.
//
// The port's own copy of rag_tpu/runtime/rag_runtime.cpp, with the same
// code: a PNG decoder (zlib inflate + per-scanline unfilter; 8-bit RGB
// images and 16-bit gray disparity maps), the SceneFlow PFM parser, and a
// threaded prefetcher that fills a bounded queue of ready (left, right,
// disparity) float32 samples, ImageNet-normalized, cropped at random
// (training) or zero-padded top/right (evaluation). Each worker i draws
// its crops from std::mt19937(seed + 7919 i) and takes the next entry
// from a shared cursor, so with one worker the samples come in list
// order with one stream of crops; with several, the order is the
// scheduler's. Exposed as a C ABI for ctypes.
//
// Built at first use by rag_tpu_torch/runtime/native.py:
//   g++ -O3 -fPIC -shared -std=c++17 rag_runtime.cpp -o librag_runtime.so -lz -lpthread

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// IO helpers
// ---------------------------------------------------------------------------

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(n);
  size_t got = fread(out.data(), 1, n, f);
  fclose(f);
  return got == (size_t)n;
}

// ---------------------------------------------------------------------------
// PNG decoding (non-interlaced; color types 0,2,4,6; bit depth 8/16)
// ---------------------------------------------------------------------------

struct PngImage {
  int w = 0, h = 0, channels = 0, bitdepth = 0;
  std::vector<uint8_t> raw;  // unfiltered scanline bytes (no filter byte)
};

uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | p[3];
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool png_decode(const char* path, PngImage& img) {
  std::vector<uint8_t> data;
  if (!read_file(path, data) || data.size() < 8) return false;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (memcmp(data.data(), sig, 8) != 0) return false;

  std::vector<uint8_t> idat;
  size_t pos = 8;
  int colortype = -1, interlace = 0;
  while (pos + 8 <= data.size()) {
    uint32_t len = be32(&data[pos]);
    const char* type = (const char*)&data[pos + 4];
    const uint8_t* body = &data[pos + 8];
    if (pos + 12 + len > data.size()) return false;
    if (memcmp(type, "IHDR", 4) == 0) {
      img.w = be32(body);
      img.h = be32(body + 4);
      img.bitdepth = body[8];
      colortype = body[9];
      interlace = body[12];
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (interlace != 0) return false;  // Adam7 unsupported
  switch (colortype) {
    case 0: img.channels = 1; break;
    case 2: img.channels = 3; break;
    case 4: img.channels = 2; break;
    case 6: img.channels = 4; break;
    default: return false;  // palette unsupported
  }
  if (img.bitdepth != 8 && img.bitdepth != 16) return false;

  const int bpp = img.channels * img.bitdepth / 8;       // bytes per pixel
  const size_t stride = (size_t)img.w * bpp;
  const size_t raw_size = ((size_t)stride + 1) * img.h;  // +filter byte
  std::vector<uint8_t> raw(raw_size);

  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = idat.data();
  zs.avail_in = idat.size();
  zs.next_out = raw.data();
  zs.avail_out = raw.size();
  int zr = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (zr != Z_STREAM_END && zr != Z_OK) return false;

  // unfilter in place into img.raw
  img.raw.resize(stride * img.h);
  std::vector<uint8_t> prev(stride, 0);
  for (int y = 0; y < img.h; y++) {
    const uint8_t* src = &raw[(stride + 1) * y];
    uint8_t filter = src[0];
    const uint8_t* line = src + 1;
    uint8_t* dst = &img.raw[stride * y];
    for (size_t x = 0; x < stride; x++) {
      int a = x >= (size_t)bpp ? dst[x - bpp] : 0;
      int b = prev[x];
      int c = x >= (size_t)bpp ? prev[x - bpp] : 0;
      int v = line[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      dst[x] = (uint8_t)v;
    }
    memcpy(prev.data(), dst, stride);
  }
  return true;
}

// ---------------------------------------------------------------------------
// PFM
// ---------------------------------------------------------------------------

struct PfmImage {
  int w = 0, h = 0, channels = 1;
  std::vector<float> data;  // top-down row order
};

bool pfm_decode(const char* path, PfmImage& img) {
  std::vector<uint8_t> data;
  if (!read_file(path, data)) return false;
  size_t pos = 0;
  auto token = [&]() -> std::string {
    while (pos < data.size() && isspace(data[pos])) pos++;
    size_t s = pos;
    while (pos < data.size() && !isspace(data[pos])) pos++;
    return std::string((const char*)&data[s], pos - s);
  };
  std::string hdr = token();
  if (hdr == "PF") img.channels = 3;
  else if (hdr == "Pf") img.channels = 1;
  else return false;
  img.w = atoi(token().c_str());
  img.h = atoi(token().c_str());
  double scale = atof(token().c_str());
  pos++;  // single whitespace after scale line
  size_t n = (size_t)img.w * img.h * img.channels;
  if (pos + n * 4 > data.size()) return false;
  img.data.resize(n);
  memcpy(img.data.data(), &data[pos], n * 4);
  if (scale > 0) {  // big-endian: swap
    for (size_t i = 0; i < n; i++) {
      uint32_t v;
      memcpy(&v, &img.data[i], 4);
      v = __builtin_bswap32(v);
      memcpy(&img.data[i], &v, 4);
    }
  }
  // PFM is bottom-up: flip to top-down
  const size_t stride = (size_t)img.w * img.channels;
  for (int y = 0; y < img.h / 2; y++) {
    for (size_t x = 0; x < stride; x++)
      std::swap(img.data[y * stride + x],
                img.data[(img.h - 1 - y) * stride + x]);
  }
  return true;
}

// ---------------------------------------------------------------------------
// Sample assembly (ImageNet normalization, crop/pad)
// ---------------------------------------------------------------------------

const float kMean[3] = {0.485f, 0.456f, 0.406f};
const float kStd[3] = {0.229f, 0.224f, 0.225f};

// RGB png -> normalized float HWC
bool load_rgb_norm(const char* path, PngImage& img, std::vector<float>& out) {
  if (!png_decode(path, img) || img.bitdepth != 8) return false;
  const int c_in = img.channels;
  out.resize((size_t)img.w * img.h * 3);
  for (int y = 0; y < img.h; y++) {
    for (int x = 0; x < img.w; x++) {
      const uint8_t* px = &img.raw[((size_t)y * img.w + x) * c_in];
      for (int c = 0; c < 3; c++) {
        uint8_t v = c_in >= 3 ? px[c] : px[0];  // gray -> replicate
        out[((size_t)y * img.w + x) * 3 + c] =
            ((float)v / 255.0f - kMean[c]) / kStd[c];
      }
    }
  }
  return true;
}

// disparity: 16-bit gray png / 256, or PFM
bool load_disp(const char* path, int& w, int& h, std::vector<float>& out) {
  size_t len = strlen(path);
  if (len > 4 && strcmp(path + len - 4, ".pfm") == 0) {
    PfmImage p;
    if (!pfm_decode(path, p) || p.channels != 1) return false;
    w = p.w; h = p.h;
    out = std::move(p.data);
    return true;
  }
  PngImage img;
  if (!png_decode(path, img) || img.channels != 1) return false;
  w = img.w; h = img.h;
  out.resize((size_t)w * h);
  if (img.bitdepth == 16) {
    for (size_t i = 0; i < (size_t)w * h; i++) {
      uint16_t v = ((uint16_t)img.raw[2 * i] << 8) | img.raw[2 * i + 1];
      out[i] = (float)v / 256.0f;
    }
  } else {
    for (size_t i = 0; i < (size_t)w * h; i++) out[i] = (float)img.raw[i];
  }
  return true;
}

// ---------------------------------------------------------------------------
// Threaded prefetching loader
// ---------------------------------------------------------------------------

struct Sample {
  std::vector<float> left, right, disp;  // crop_h x crop_w x {3,3,1}
  bool ok = false;
};

struct Loader {
  std::vector<std::string> lefts, rights, disps;
  int crop_w, crop_h, training, pad_w, pad_h;
  std::vector<std::thread> workers;
  std::queue<Sample> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::atomic<bool> stop{false};
  std::atomic<size_t> cursor{0};
  size_t max_queue = 64;
  std::mt19937 rng;
  std::mutex rng_mu;

  int out_w() const { return training ? crop_w : pad_w; }
  int out_h() const { return training ? crop_h : pad_h; }

  void worker(unsigned seed) {
    std::mt19937 local_rng(seed);
    while (!stop.load()) {
      size_t idx = cursor.fetch_add(1) % lefts.size();
      Sample s = make_sample(idx, local_rng);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return ready.size() < max_queue || stop.load(); });
      if (stop.load()) return;
      ready.push(std::move(s));
      cv_ready.notify_one();
    }
  }

  Sample make_sample(size_t idx, std::mt19937& lrng) {
    Sample s;
    PngImage li, ri;
    std::vector<float> lbuf, rbuf, dbuf;
    int dw = 0, dh = 0;
    if (!load_rgb_norm(lefts[idx].c_str(), li, lbuf)) return s;
    if (!load_rgb_norm(rights[idx].c_str(), ri, rbuf)) return s;
    if (!load_disp(disps[idx].c_str(), dw, dh, dbuf)) return s;
    if (li.w != ri.w || li.h != ri.h || dw != li.w || dh != li.h) return s;

    const int ow = out_w(), oh = out_h();
    s.left.assign((size_t)ow * oh * 3, 0.f);
    s.right.assign((size_t)ow * oh * 3, 0.f);
    s.disp.assign((size_t)ow * oh, 0.f);

    if (training) {
      int max_x = li.w - crop_w, max_y = li.h - crop_h;
      if (max_x < 0 || max_y < 0) return s;
      int x1 = max_x ? (int)(lrng() % (max_x + 1)) : 0;
      int y1 = max_y ? (int)(lrng() % (max_y + 1)) : 0;
      for (int y = 0; y < oh; y++) {
        memcpy(&s.left[(size_t)y * ow * 3],
               &lbuf[(((size_t)(y + y1)) * li.w + x1) * 3], ow * 3 * 4);
        memcpy(&s.right[(size_t)y * ow * 3],
               &rbuf[(((size_t)(y + y1)) * li.w + x1) * 3], ow * 3 * 4);
        memcpy(&s.disp[(size_t)y * ow],
               &dbuf[((size_t)(y + y1)) * li.w + x1], ow * 4);
      }
    } else {
      // top/right zero-pad to (pad_h, pad_w) — reference eval protocol
      int top = pad_h - li.h, rightp = pad_w - li.w;
      if (top < 0 || rightp < 0) return s;
      for (int y = 0; y < li.h; y++) {
        memcpy(&s.left[(size_t)(y + top) * ow * 3],
               &lbuf[(size_t)y * li.w * 3], li.w * 3 * 4);
        memcpy(&s.right[(size_t)(y + top) * ow * 3],
               &rbuf[(size_t)y * li.w * 3], li.w * 3 * 4);
        memcpy(&s.disp[(size_t)(y + top) * ow],
               &dbuf[(size_t)y * li.w], li.w * 4);
      }
    }
    s.ok = true;
    return s;
  }
};

}  // namespace

extern "C" {

int rag_png_info(const char* path, int* w, int* h, int* channels,
                 int* bitdepth) {
  PngImage img;
  if (!png_decode(path, img)) return -1;
  *w = img.w; *h = img.h; *channels = img.channels; *bitdepth = img.bitdepth;
  return 0;
}

// out must hold w*h*channels floats; values scaled to [0,1] (8-bit) or
// /256 (16-bit, the disparity convention)
int rag_png_read_f32(const char* path, float* out) {
  PngImage img;
  if (!png_decode(path, img)) return -1;
  size_t n = (size_t)img.w * img.h * img.channels;
  if (img.bitdepth == 8) {
    for (size_t i = 0; i < n; i++) out[i] = (float)img.raw[i] / 255.0f;
  } else {
    for (size_t i = 0; i < n; i++) {
      uint16_t v = ((uint16_t)img.raw[2 * i] << 8) | img.raw[2 * i + 1];
      out[i] = (float)v / 256.0f;
    }
  }
  return 0;
}

int rag_pfm_info(const char* path, int* w, int* h, int* channels) {
  PfmImage img;
  if (!pfm_decode(path, img)) return -1;
  *w = img.w; *h = img.h; *channels = img.channels;
  return 0;
}

int rag_pfm_read(const char* path, float* out) {
  PfmImage img;
  if (!pfm_decode(path, img)) return -1;
  memcpy(out, img.data.data(), img.data.size() * 4);
  return 0;
}

void* rag_loader_create(const char** lefts, const char** rights,
                        const char** disps, int n, int crop_w, int crop_h,
                        int training, int pad_w, int pad_h, int n_threads,
                        unsigned seed) {
  Loader* L = new Loader();
  for (int i = 0; i < n; i++) {
    L->lefts.emplace_back(lefts[i]);
    L->rights.emplace_back(rights[i]);
    L->disps.emplace_back(disps[i]);
  }
  L->crop_w = crop_w; L->crop_h = crop_h; L->training = training;
  L->pad_w = pad_w; L->pad_h = pad_h;
  for (int i = 0; i < n_threads; i++)
    L->workers.emplace_back([L, seed, i] { L->worker(seed + 7919 * i); });
  return L;
}

// Fill batch arrays (batch, H, W, C). Returns number filled (skips
// samples that failed to decode), -1 on shutdown.
int rag_loader_next(void* handle, int batch, float* left, float* right,
                    float* disp) {
  Loader* L = (Loader*)handle;
  const size_t img_sz = (size_t)L->out_w() * L->out_h() * 3;
  const size_t disp_sz = (size_t)L->out_w() * L->out_h();
  int filled = 0;
  while (filled < batch) {
    Sample s;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_ready.wait(lk, [&] { return !L->ready.empty() || L->stop.load(); });
      if (L->stop.load()) return -1;
      s = std::move(L->ready.front());
      L->ready.pop();
      L->cv_space.notify_one();
    }
    if (!s.ok) continue;
    memcpy(left + (size_t)filled * img_sz, s.left.data(), img_sz * 4);
    memcpy(right + (size_t)filled * img_sz, s.right.data(), img_sz * 4);
    memcpy(disp + (size_t)filled * disp_sz, s.disp.data(), disp_sz * 4);
    filled++;
  }
  return filled;
}

void rag_loader_destroy(void* handle) {
  Loader* L = (Loader*)handle;
  L->stop.store(true);
  L->cv_ready.notify_all();
  L->cv_space.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
