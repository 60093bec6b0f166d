// Native image IO for raytracingpbr_tpu: PNG (via zlib) and Radiance RGBE
// (.hdr) codecs, exposed through a C ABI consumed with ctypes
// (raytracingpbr_tpu/io/image.py).
//
// Role in the framework (SURVEY.md §2.4): the reference delegates image IO to
// the Taichi runtime (`ti.tools.imread`/`imwrite`, src/ibl.py:14,
// src/main.py:55). This build keeps the host-side runtime native: frame
// output (PNG) and HDR envmap input never round-trip through Python pixel
// loops.
//
// Build: tools/build_native.sh -> raytracingpbr_tpu/io/libimage_io.so

#include <zlib.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

uint32_t crc_table[256];
bool crc_ready = false;

void init_crc() {
  if (crc_ready) return;
  for (uint32_t n = 0; n < 256; n++) {
    uint32_t c = n;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
    crc_table[n] = c;
  }
  crc_ready = true;
}

uint32_t crc32_of(const uint8_t* buf, size_t len, uint32_t crc = 0xffffffffu) {
  init_crc();
  for (size_t i = 0; i < len; i++)
    crc = crc_table[(crc ^ buf[i]) & 0xff] ^ (crc >> 8);
  return crc;
}

void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back((x >> 24) & 0xff);
  v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 8) & 0xff);
  v.push_back(x & 0xff);
}

void write_chunk(FILE* f, const char type[4], const uint8_t* data,
                 size_t len) {
  uint8_t hdr[8] = {uint8_t(len >> 24), uint8_t(len >> 16), uint8_t(len >> 8),
                    uint8_t(len), uint8_t(type[0]), uint8_t(type[1]),
                    uint8_t(type[2]), uint8_t(type[3])};
  fwrite(hdr, 1, 8, f);
  if (len) fwrite(data, 1, len, f);
  uint32_t crc = crc32_of(hdr + 4, 4);
  crc = crc32_of(data, len, crc) ^ 0xffffffffu;
  uint8_t cb[4] = {uint8_t(crc >> 24), uint8_t(crc >> 16), uint8_t(crc >> 8),
                   uint8_t(crc)};
  fwrite(cb, 1, 4, f);
}

}  // namespace

extern "C" {

// rgb: 8-bit interleaved, row-major, h rows of w pixels. Returns 0 on
// success.
int rtpbr_write_png(const char* path, const uint8_t* rgb, int w, int h) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  fwrite(sig, 1, 8, f);

  std::vector<uint8_t> ihdr;
  put_be32(ihdr, (uint32_t)w);
  put_be32(ihdr, (uint32_t)h);
  ihdr.push_back(8);   // bit depth
  ihdr.push_back(2);   // color type: truecolor
  ihdr.push_back(0);   // compression
  ihdr.push_back(0);   // filter
  ihdr.push_back(0);   // interlace
  write_chunk(f, "IHDR", ihdr.data(), ihdr.size());

  // raw scanlines with filter byte 0
  std::vector<uint8_t> raw((size_t)h * (1 + (size_t)w * 3));
  for (int y = 0; y < h; y++) {
    uint8_t* row = raw.data() + (size_t)y * (1 + (size_t)w * 3);
    row[0] = 0;
    memcpy(row + 1, rgb + (size_t)y * w * 3, (size_t)w * 3);
  }
  uLongf zlen = compressBound(raw.size());
  std::vector<uint8_t> z(zlen);
  if (compress2(z.data(), &zlen, raw.data(), raw.size(), 6) != Z_OK) {
    fclose(f);
    return 2;
  }
  write_chunk(f, "IDAT", z.data(), zlen);
  write_chunk(f, "IEND", nullptr, 0);
  fclose(f);
  return 0;
}

namespace {

struct PngImage {
  int w = 0, h = 0, channels = 0, bit_depth = 0;
  std::vector<uint8_t> data;  // defiltered, interleaved rows
  bool ok = false;
};

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

PngImage read_png_impl(const char* path) {
  PngImage img;
  FILE* f = fopen(path, "rb");
  if (!f) return img;
  uint8_t sig[8];
  if (fread(sig, 1, 8, f) != 8 || sig[0] != 137 || sig[1] != 'P') {
    fclose(f);
    return img;
  }
  std::vector<uint8_t> idat;
  int color_type = -1;
  for (;;) {
    uint8_t hdr[8];
    if (fread(hdr, 1, 8, f) != 8) break;
    uint32_t len = (hdr[0] << 24) | (hdr[1] << 16) | (hdr[2] << 8) | hdr[3];
    std::string type((char*)hdr + 4, 4);
    std::vector<uint8_t> data(len);
    if (len && fread(data.data(), 1, len, f) != len) break;
    fseek(f, 4, SEEK_CUR);  // skip crc
    if (type == "IHDR") {
      img.w = (data[0] << 24) | (data[1] << 16) | (data[2] << 8) | data[3];
      img.h = (data[4] << 24) | (data[5] << 16) | (data[6] << 8) | data[7];
      img.bit_depth = data[8];
      color_type = data[9];
      if (img.bit_depth != 8 ||
          (color_type != 2 && color_type != 6 && color_type != 0) ||
          data[12] != 0) {
        fclose(f);
        return img;  // unsupported flavor
      }
      img.channels = color_type == 2 ? 3 : (color_type == 6 ? 4 : 1);
    } else if (type == "IDAT") {
      idat.insert(idat.end(), data.begin(), data.end());
    } else if (type == "IEND") {
      break;
    }
  }
  fclose(f);
  if (img.w <= 0 || img.h <= 0 || idat.empty()) return img;

  size_t stride = (size_t)img.w * img.channels;
  std::vector<uint8_t> raw((stride + 1) * img.h);
  uLongf rawlen = raw.size();
  if (uncompress(raw.data(), &rawlen, idat.data(), idat.size()) != Z_OK)
    return img;

  img.data.resize(stride * img.h);
  std::vector<uint8_t> prev(stride, 0);
  for (int y = 0; y < img.h; y++) {
    const uint8_t* src = raw.data() + (size_t)y * (stride + 1);
    uint8_t filter = src[0];
    const uint8_t* line = src + 1;
    uint8_t* dst = img.data.data() + (size_t)y * stride;
    int bpp = img.channels;
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
        default: return img;
      }
      dst[x] = (uint8_t)v;
    }
    memcpy(prev.data(), dst, stride);
  }
  img.ok = true;
  return img;
}

}  // namespace

// Returns 0 on success; fills w/h/channels.
int rtpbr_png_dims(const char* path, int* w, int* h, int* channels) {
  PngImage img = read_png_impl(path);
  if (!img.ok) return 1;
  *w = img.w;
  *h = img.h;
  *channels = img.channels;
  return 0;
}

// out must hold w*h*channels bytes (query via rtpbr_png_dims).
int rtpbr_read_png(const char* path, uint8_t* out) {
  PngImage img = read_png_impl(path);
  if (!img.ok) return 1;
  memcpy(out, img.data.data(), img.data.size());
  return 0;
}

// ---------------------------------------------------------------------------
// Radiance RGBE (.hdr) — the reference's envmap asset format
// ---------------------------------------------------------------------------

int rtpbr_write_hdr(const char* path, const float* rgb, int w, int h) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  fprintf(f, "#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n", h, w);
  // flat (non-RLE) scanlines: 4 bytes per pixel
  std::vector<uint8_t> row((size_t)w * 4);
  for (int y = 0; y < h; y++) {
    const float* src = rgb + (size_t)y * w * 3;
    for (int x = 0; x < w; x++) {
      float r = src[x * 3], g = src[x * 3 + 1], b = src[x * 3 + 2];
      float m = r > g ? (r > b ? r : b) : (g > b ? g : b);
      if (m <= 1e-32f) {
        memset(&row[x * 4], 0, 4);
      } else {
        int e;
        float scale = frexpf(m, &e) * 256.0f / m;
        row[x * 4 + 0] = (uint8_t)(r * scale);
        row[x * 4 + 1] = (uint8_t)(g * scale);
        row[x * 4 + 2] = (uint8_t)(b * scale);
        row[x * 4 + 3] = (uint8_t)(e + 128);
      }
    }
    fwrite(row.data(), 1, row.size(), f);
  }
  fclose(f);
  return 0;
}

namespace {

bool read_hdr_header(FILE* f, int* w, int* h) {
  char line[256];
  if (!fgets(line, sizeof line, f)) return false;
  if (strncmp(line, "#?", 2) != 0) return false;
  bool fmt_ok = false;
  while (fgets(line, sizeof line, f)) {
    if (line[0] == '\n' || line[0] == '\r') break;
    if (strstr(line, "FORMAT=32-bit_rle_rgbe")) fmt_ok = true;
  }
  if (!fmt_ok) return false;
  if (!fgets(line, sizeof line, f)) return false;
  if (sscanf(line, "-Y %d +X %d", h, w) != 2) return false;
  return true;
}

bool read_hdr_scanline(FILE* f, uint8_t* rgbe, int w) {
  if (w < 8 || w > 0x7fff) {
    return fread(rgbe, 4, w, f) == (size_t)w;  // flat
  }
  uint8_t hdr[4];
  if (fread(hdr, 1, 4, f) != 4) return false;
  if (hdr[0] != 2 || hdr[1] != 2 || ((hdr[2] << 8) | hdr[3]) != w) {
    // flat scanline; first pixel already consumed
    memcpy(rgbe, hdr, 4);
    return fread(rgbe + 4, 4, w - 1, f) == (size_t)(w - 1);
  }
  // RLE per component plane
  for (int c = 0; c < 4; c++) {
    int x = 0;
    while (x < w) {
      int code = fgetc(f);
      if (code == EOF) return false;
      if (code > 128) {  // run
        int count = code - 128;
        int v = fgetc(f);
        if (v == EOF || x + count > w) return false;
        for (int i = 0; i < count; i++) rgbe[(x + i) * 4 + c] = (uint8_t)v;
        x += count;
      } else {  // literal
        int count = code;
        if (x + count > w) return false;
        for (int i = 0; i < count; i++) {
          int v = fgetc(f);
          if (v == EOF) return false;
          rgbe[(x + i) * 4 + c] = (uint8_t)v;
        }
        x += count;
      }
    }
  }
  return true;
}

}  // namespace

int rtpbr_hdr_dims(const char* path, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  bool ok = read_hdr_header(f, w, h);
  fclose(f);
  return ok ? 0 : 1;
}

// out must hold w*h*3 floats, row-major from the top scanline.
int rtpbr_read_hdr(const char* path, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  int w, h;
  if (!read_hdr_header(f, &w, &h)) {
    fclose(f);
    return 1;
  }
  std::vector<uint8_t> rgbe((size_t)w * 4);
  for (int y = 0; y < h; y++) {
    if (!read_hdr_scanline(f, rgbe.data(), w)) {
      fclose(f);
      return 2;
    }
    float* dst = out + (size_t)y * w * 3;
    for (int x = 0; x < w; x++) {
      int e = rgbe[x * 4 + 3];
      if (e == 0) {
        dst[x * 3] = dst[x * 3 + 1] = dst[x * 3 + 2] = 0.0f;
      } else {
        float scale = ldexpf(1.0f, e - 136);  // (e-128)-8
        dst[x * 3 + 0] = rgbe[x * 4 + 0] * scale;
        dst[x * 3 + 1] = rgbe[x * 4 + 1] * scale;
        dst[x * 3 + 2] = rgbe[x * 4 + 2] * scale;
      }
    }
  }
  fclose(f);
  return 0;
}

}  // extern "C"
