// Native image-output tier: gamma/quantize + PPM/PNG encoders.
//
// The port's own copy of raytracinginoneweekend_tpu/native/imagecodec.cpp
// (host code: the port imports nothing of the JAX package). A native
// re-expression of the reference's all-native app layer:
//   - gamma 1/2.2 + *255 u8 quantization (SURVEY #22: app::gamma_correction
//     + normalize_rgb_to_8bit, main.cxx:39-45/77-85; cuda::rgb32_to_rgb8,
//     cuda_impl.cu:85-99). The reference casts WITHOUT clamping (UB on
//     overflow under quirk Q6); `clamp=0` reproduces the raw modular cast,
//     `clamp=1` (default in the Python wrapper) saturates.
//   - binary P6 PPM writer (SURVEY #23: app::save_to_file, main.cxx:87-101).
//   - RGB8 PNG writer (zlib; the reference readme showcases PNGs).
//
// Exposed as a plain C ABI consumed via ctypes.
// Build: native/__init__.py (g++ -O3 -shared -fPIC -std=c++17, -lz), into
// the package's build/ directory.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// Gamma-encode (pow 1/2.2) and quantize n RGB float32 values to uint8.
// clamp=1: saturate to [0,255]; clamp=0: reference-exact raw int cast
// (modular wrap, matching main.cxx:80-84's UB-in-practice behavior).
void rtw_gamma_quantize(const float* rgb, int64_t n, uint8_t* out,
                        int clamp) {
  const float inv_gamma = 1.0f / 2.2f;
  int64_t nthreads = std::max<int64_t>(
      1, std::min<int64_t>(std::thread::hardware_concurrency(),
                           n / (1 << 16) + 1));
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      float v = rgb[i];
      v = std::pow(v > 0.0f ? v : 0.0f, inv_gamma) * 255.0f;
      if (clamp) {
        v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
        out[i] = static_cast<uint8_t>(v);
      } else {
        out[i] = static_cast<uint8_t>(static_cast<int32_t>(v));
      }
    }
  };
  if (nthreads == 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

// Binary P6 PPM, header byte-identical to main.cxx:96-100. Returns 0 on
// success, -1 on IO error.
int rtw_write_ppm(const char* path, const uint8_t* rgb, int width,
                  int height) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fprintf(f, "P6\n%d %d\n255\n", width, height);
  size_t n = static_cast<size_t>(width) * height * 3;
  size_t written = std::fwrite(rgb, 1, n, f);
  return std::fclose(f) == 0 && written == n ? 0 : -1;
}

static void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x >> 24); v.push_back(x >> 16); v.push_back(x >> 8);
  v.push_back(x);
}

static void put_chunk(std::vector<uint8_t>& out, const char tag[4],
                      const uint8_t* data, size_t len) {
  put_be32(out, static_cast<uint32_t>(len));
  size_t start = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0L, out.data() + start, static_cast<uInt>(len + 4));
  put_be32(out, crc);
}

// RGB8 PNG (color type 2, zlib level 6, filter 0 per scanline). Returns 0
// on success, -1 on IO/zlib error.
int rtw_write_png(const char* path, const uint8_t* rgb, int width,
                  int height) {
  // Raw stream: filter byte 0 + scanline, per row.
  size_t stride = static_cast<size_t>(width) * 3;
  std::vector<uint8_t> raw((stride + 1) * height);
  for (int y = 0; y < height; ++y) {
    uint8_t* row = raw.data() + y * (stride + 1);
    row[0] = 0;
    std::memcpy(row + 1, rgb + y * stride, stride);
  }
  uLongf comp_cap = compressBound(static_cast<uLong>(raw.size()));
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(),
                static_cast<uLong>(raw.size()), 6) != Z_OK)
    return -1;

  std::vector<uint8_t> out;
  out.reserve(comp_cap + 128);
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a,
                                 '\n'};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = width >> 24; ihdr[1] = width >> 16; ihdr[2] = width >> 8;
  ihdr[3] = width;
  ihdr[4] = height >> 24; ihdr[5] = height >> 16; ihdr[6] = height >> 8;
  ihdr[7] = height;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);
  put_chunk(out, "IDAT", comp.data(), comp_cap);
  put_chunk(out, "IEND", nullptr, 0);

  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  size_t written = std::fwrite(out.data(), 1, out.size(), f);
  return std::fclose(f) == 0 && written == out.size() ? 0 : -1;
}

}  // extern "C"
