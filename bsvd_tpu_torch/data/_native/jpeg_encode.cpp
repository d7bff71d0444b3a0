// Baseline JPEG writer of bsvd_tpu_torch, C++ standard library only (bound
// with ctypes by bsvd_tpu_torch/utils/jpeg_encode.py, which builds it at
// first use):
//
//   g++ -O3 -shared -fPIC jpeg_encode.cpp -o libbsvd_jpeg_enc.so
//
// Writes what libjpeg-turbo 3.x writes with the defaults cv2.imwrite gives
// it, so that a decoder reads the same pixels from either file: JFIF APP0,
// the quantization tables of ITU T.81 Annex K.1 scaled by quality as
// jpeg_quality_scaling / jpeg_add_quant_table do (baseline: at most 255),
// the standard Huffman tables of Annex K.3, one interleaved sequential scan
// (SOF0). The coefficients are libjpeg-turbo's: rgb_ycc_convert's
// fixed-point tables (jccolor.c), edge replication to whole blocks and
// h2v1_downsample / h2v2_downsample with their alternating biases, or
// int_downsample for 4:4:0 (jcsample.c), the accurate integer FDCT
// (jfdctint.c), and the reciprocal quantizer (jcdctmgr.c); blocks past the
// component's edge in a partial MCU are zero with the DC of the block
// before them (jccoefct.c).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K.1, natural order
constexpr int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
constexpr int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3: code counts by length 1-16, then the symbols
constexpr uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1,
                                     1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1,
                                       1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                     5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                       7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffCodes {
  uint16_t code[256];
  uint8_t len[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    memset(len, 0, sizeof(len));
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++k, ++c) {
        code[vals[k]] = static_cast<uint16_t>(c);
        len[vals[k]] = static_cast<uint8_t>(l);
      }
      c <<= 1;
    }
  }
};

// jpeg_quality_scaling + jpeg_add_quant_table(force_baseline = TRUE)
void scaled_table(const int* base, int quality, uint16_t* out) {
  quality = std::min(std::max(quality, 1), 100);
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(base[i]) * scale + 50L) / 100L;
    out[i] = static_cast<uint16_t>(std::min(std::max(t, 1L), 255L));
  }
}

// compute_reciprocal (jcdctmgr.c) for a 16-bit DCTELEM: q' = sign(x) *
// ((|x| + corr) * recip >> shift), the divisor being 8 * the table entry
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  Divisor d;
  if (divisor == 1) {
    d.recip = 1;
    d.corr = 0;
    d.shift = 0;
    return d;
  }
  int b = 0;
  while ((divisor >> (b + 1)) != 0) ++b;  // floor(log2(divisor))
  int r = 16 + b;
  uint64_t fq = (uint64_t(1) << r) / divisor;
  const uint64_t fr = (uint64_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2U) {
    ++c;
  } else {
    ++fq;
  }
  d.recip = static_cast<uint32_t>(fq);
  d.corr = c;
  d.shift = r;
  return d;
}

// jpeg_fdct_islow (jfdctint.c), in place, output scaled up by 8
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t F0_298631336 = 2446, F0_390180644 = 3196,
                  F0_541196100 = 4433, F0_765366865 = 6270,
                  F0_899976223 = 7373, F1_175875602 = 9633,
                  F1_501321110 = 12299, F1_847759065 = 15137,
                  F1_961570560 = 16069, F2_053119869 = 16819,
                  F2_562915447 = 20995, F3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

void fdct_islow(int* data) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 8 : 1;   // row pass, then column pass
    const int elem = pass == 0 ? 1 : 8;
    const int shift = pass == 0 ? kConstBits - kPass1Bits
                                : kConstBits + kPass1Bits;
    for (int i = 0; i < 8; ++i) {
      int* d = data + i * step;
      const int64_t tmp0 = d[0] + d[7 * elem], tmp7 = d[0] - d[7 * elem];
      const int64_t tmp1 = d[elem] + d[6 * elem],
                    tmp6 = d[elem] - d[6 * elem];
      const int64_t tmp2 = d[2 * elem] + d[5 * elem],
                    tmp5 = d[2 * elem] - d[5 * elem];
      const int64_t tmp3 = d[3 * elem] + d[4 * elem],
                    tmp4 = d[3 * elem] - d[4 * elem];
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        d[0] = static_cast<int>((tmp10 + tmp11) * (1 << kPass1Bits));
        d[4 * elem] = static_cast<int>((tmp10 - tmp11) * (1 << kPass1Bits));
      } else {
        d[0] = static_cast<int>(descale(tmp10 + tmp11, kPass1Bits));
        d[4 * elem] = static_cast<int>(descale(tmp10 - tmp11, kPass1Bits));
      }
      const int64_t z1 = (tmp12 + tmp13) * F0_541196100;
      d[2 * elem] =
          static_cast<int>(descale(z1 + tmp13 * F0_765366865, shift));
      d[6 * elem] =
          static_cast<int>(descale(z1 + tmp12 * -F1_847759065, shift));
      int64_t a1 = tmp4 + tmp7, a2 = tmp5 + tmp6, a3 = tmp4 + tmp6,
              a4 = tmp5 + tmp7;
      const int64_t z5 = (a3 + a4) * F1_175875602;
      const int64_t t4 = tmp4 * F0_298631336, t5 = tmp5 * F2_053119869,
                    t6 = tmp6 * F3_072711026, t7 = tmp7 * F1_501321110;
      a1 *= -F0_899976223;
      a2 *= -F2_562915447;
      a3 *= -F1_961570560;
      a4 *= -F0_390180644;
      a3 += z5;
      a4 += z5;
      d[7 * elem] = static_cast<int>(descale(t4 + a1 + a3, shift));
      d[5 * elem] = static_cast<int>(descale(t5 + a2 + a4, shift));
      d[3 * elem] = static_cast<int>(descale(t6 + a2 + a3, shift));
      d[1 * elem] = static_cast<int>(descale(t7 + a1 + a4, shift));
    }
  }
}

class Writer {
 public:
  std::vector<uint8_t> out;
  void byte(int b) { out.push_back(static_cast<uint8_t>(b)); }
  void word(int w) {
    byte(w >> 8);
    byte(w & 0xFF);
  }
  // entropy-coded bits, 0xFF stuffed with 0x00
  void bits(uint32_t code, int n) {
    acc_ = (acc_ << n) | (code & ((1u << n) - 1));
    nacc_ += n;
    while (nacc_ >= 8) {
      const int b = static_cast<int>((acc_ >> (nacc_ - 8)) & 0xFF);
      byte(b);
      if (b == 0xFF) byte(0);
      nacc_ -= 8;
    }
  }
  void flush() {  // pad with one-bits to a byte boundary
    if (nacc_ > 0) bits(0x7F, 8 - nacc_);
    acc_ = 0;
    nacc_ = 0;
  }

 private:
  uint64_t acc_ = 0;
  int nacc_ = 0;
};

struct Plane {
  int w = 0, h = 0;            // samples held (padded)
  std::vector<uint8_t> s;
  uint8_t at(int y, int x) const { return s[static_cast<size_t>(y) * w + x]; }
};

int nbits(int v) {
  int n = 0;
  for (v = v < 0 ? -v : v; v; v >>= 1) ++n;
  return n;
}

}  // namespace

extern "C" {

// Encode (h, w) uint8 pixels, 3 channels RGB or 1 gray, interleaved, as a
// baseline JPEG at `quality` with luma sampling factors (hs, vs) in
// {1, 2} (chroma 1x1). *out is malloc'ed (free with bsvd_jpeg_free); returns
// its length, or 0 for bad arguments.
size_t bsvd_jpeg_encode(const uint8_t* px, int h, int w, int channels,
                        int quality, int hs, int vs, uint8_t** out) {
  *out = nullptr;
  if (h < 1 || w < 1 || h > 65535 || w > 65535 ||
      (channels != 1 && channels != 3) || hs < 1 || hs > 2 || vs < 1 ||
      vs > 2) {
    return 0;
  }
  const int ncomp = channels;
  const int hmax = ncomp == 1 ? 1 : hs, vmax = ncomp == 1 ? 1 : vs;
  const int mcux = (w + 8 * hmax - 1) / (8 * hmax);
  const int mcuy = (h + 8 * vmax - 1) / (8 * vmax);
  const int ch[3] = {hmax, 1, 1}, cv[3] = {vmax, 1, 1};

  // colour conversion (jccolor.c rgb_ycc_convert, 16 fraction bits)
  std::vector<uint8_t> full[3];
  for (int c = 0; c < ncomp; ++c) full[c].resize(static_cast<size_t>(h) * w);
  if (ncomp == 1) {
    memcpy(full[0].data(), px, full[0].size());
  } else {
    auto fix = [](double x) {
      return static_cast<int32_t>(x * 65536.0 + 0.5);
    };
    const int32_t half = 1 << 15, cbcr_off = 128 << 16;
    int32_t ry[256], gy[256], by[256], rcb[256], gcb[256], bcb[256],
        gcr[256], bcr[256];
    for (int i = 0; i < 256; ++i) {
      ry[i] = fix(0.29900) * i;
      gy[i] = fix(0.58700) * i;
      by[i] = fix(0.11400) * i + half;
      rcb[i] = -fix(0.16874) * i;
      gcb[i] = -fix(0.33126) * i;
      bcb[i] = fix(0.50000) * i + cbcr_off + half - 1;  // = R => Cr
      gcr[i] = -fix(0.41869) * i;
      bcr[i] = -fix(0.08131) * i;
    }
    for (size_t i = 0; i < full[0].size(); ++i) {
      const int r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
      full[0][i] = static_cast<uint8_t>((ry[r] + gy[g] + by[b]) >> 16);
      full[1][i] = static_cast<uint8_t>((rcb[r] + gcb[g] + bcb[b]) >> 16);
      full[2][i] = static_cast<uint8_t>((bcb[r] + gcr[g] + bcr[b]) >> 16);
    }
  }

  // each component's samples over its blocks: rows and columns past the
  // image replicated (jcprepct.c / expand_right_edge), then downsampled
  // (jcsample.c), then the last downsampled row replicated to whole MCUs
  Plane plane[3];
  int wblocks[3], hblocks[3];
  for (int c = 0; c < ncomp; ++c) {
    const int rh = hmax / ch[c], rv = vmax / cv[c];
    const int dw = (w * ch[c] + hmax - 1) / hmax;
    const int dh = (h * cv[c] + vmax - 1) / vmax;
    wblocks[c] = (dw + 7) / 8;
    hblocks[c] = (dh + 7) / 8;
    Plane& p = plane[c];
    p.w = wblocks[c] * 8;
    p.h = mcuy * cv[c] * 8;
    p.s.resize(static_cast<size_t>(p.w) * p.h);
    const int in_w = p.w * rh;
    const int rows_made = ((h + vmax - 1) / vmax) * cv[c];  // real groups
    std::vector<int> row(in_w * 2);
    for (int y = 0; y < rows_made; ++y) {
      // the rv full-resolution rows of this output row, edge-replicated
      for (int k = 0; k < rv; ++k) {
        const int sy = std::min(y * rv + k, h - 1);
        const uint8_t* src = full[c].data() + static_cast<size_t>(sy) * w;
        for (int x = 0; x < in_w; ++x) {
          row[k * in_w + x] = src[std::min(x, w - 1)];
        }
      }
      uint8_t* dst = p.s.data() + static_cast<size_t>(y) * p.w;
      if (rh == 1 && rv == 1) {
        for (int x = 0; x < p.w; ++x) dst[x] = static_cast<uint8_t>(row[x]);
      } else if (rh == 2 && rv == 1) {  // h2v1_downsample: bias 0, 1, ...
        for (int x = 0; x < p.w; ++x) {
          dst[x] = static_cast<uint8_t>(
              (row[2 * x] + row[2 * x + 1] + (x & 1)) >> 1);
        }
      } else if (rh == 2 && rv == 2) {  // h2v2_downsample: bias 1, 2, ...
        for (int x = 0; x < p.w; ++x) {
          dst[x] = static_cast<uint8_t>(
              (row[2 * x] + row[2 * x + 1] + row[in_w + 2 * x] +
               row[in_w + 2 * x + 1] + ((x & 1) ? 2 : 1)) >> 2);
        }
      } else {  // int_downsample, 1x2: (a + b + 1) / 2
        for (int x = 0; x < p.w; ++x) {
          dst[x] = static_cast<uint8_t>((row[x] + row[in_w + x] + 1) / 2);
        }
      }
    }
    for (int y = rows_made; y < p.h; ++y) {
      memcpy(p.s.data() + static_cast<size_t>(y) * p.w,
             p.s.data() + static_cast<size_t>(rows_made - 1) * p.w, p.w);
    }
  }

  uint16_t qtab[2][64];
  scaled_table(kLumaQuant, quality, qtab[0]);
  scaled_table(kChromaQuant, quality, qtab[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t) {
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(qtab[t][i] * 8u);
  }
  HuffCodes dc[2], ac[2];
  dc[0].build(kDcLumaBits, kDcVals);
  dc[1].build(kDcChromaBits, kDcVals);
  ac[0].build(kAcLumaBits, kAcLumaVals);
  ac[1].build(kAcChromaBits, kAcChromaVals);

  Writer wr;
  wr.out.reserve(static_cast<size_t>(h) * w * channels / 2 + 1024);
  wr.word(0xFFD8);
  // JFIF APP0: version 1.01, no density unit, 1:1, no thumbnail
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  wr.word(0xFFE0);
  wr.word(16);
  for (uint8_t b : jfif) wr.byte(b);
  for (int t = 0; t < (ncomp == 1 ? 1 : 2); ++t) {
    wr.word(0xFFDB);
    wr.word(67);
    wr.byte(t);
    for (int k = 0; k < 64; ++k) wr.byte(qtab[t][kNatural[k]]);
  }
  wr.word(0xFFC0);
  wr.word(8 + 3 * ncomp);
  wr.byte(8);
  wr.word(h);
  wr.word(w);
  wr.byte(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    wr.byte(c + 1);
    wr.byte((ch[c] << 4) | cv[c]);
    wr.byte(c ? 1 : 0);
  }
  for (int t = 0; t < (ncomp == 1 ? 1 : 2); ++t) {
    for (int cls = 0; cls < 2; ++cls) {
      const uint8_t* bits = cls ? (t ? kAcChromaBits : kAcLumaBits)
                                : (t ? kDcChromaBits : kDcLumaBits);
      const uint8_t* vals = cls ? (t ? kAcChromaVals : kAcLumaVals) : kDcVals;
      int n = 0;
      for (int i = 0; i < 16; ++i) n += bits[i];
      wr.word(0xFFC4);
      wr.word(3 + 16 + n);
      wr.byte((cls << 4) | t);
      for (int i = 0; i < 16; ++i) wr.byte(bits[i]);
      for (int i = 0; i < n; ++i) wr.byte(vals[i]);
    }
  }
  wr.word(0xFFDA);
  wr.word(6 + 2 * ncomp);
  wr.byte(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    wr.byte(c + 1);
    wr.byte(c ? 0x11 : 0x00);
  }
  wr.byte(0);
  wr.byte(63);
  wr.byte(0);

  int last_dc[3] = {0, 0, 0};
  int block[64];
  int16_t q[64];
  auto encode_block = [&](int c, const int16_t* coef) {
    const int t = c ? 1 : 0;
    const int diff = coef[0] - last_dc[c];
    last_dc[c] = coef[0];
    int n = nbits(diff);
    wr.bits(dc[t].code[n], dc[t].len[n]);
    if (n) wr.bits(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), n);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      const int v = coef[kNatural[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        wr.bits(ac[t].code[0xF0], ac[t].len[0xF0]);
        run -= 16;
      }
      n = nbits(v);
      const int sym = (run << 4) | n;
      wr.bits(ac[t].code[sym], ac[t].len[sym]);
      wr.bits(static_cast<uint32_t>(v < 0 ? v - 1 : v), n);
      run = 0;
    }
    if (run > 0) wr.bits(ac[t].code[0], ac[t].len[0]);
  };
  auto quantized = [&](int c, int by, int bx, int16_t* coef) {
    const Plane& p = plane[c];
    for (int y = 0; y < 8; ++y) {
      for (int x = 0; x < 8; ++x) {
        block[y * 8 + x] = p.at(by * 8 + y, bx * 8 + x) - 128;
      }
    }
    fdct_islow(block);
    const Divisor* dv = div[c ? 1 : 0];
    for (int i = 0; i < 64; ++i) {
      // the FDCT's output fits DCTELEM (16 bits) for 8-bit samples
      const int v = static_cast<int16_t>(block[i]);
      const uint32_t a = static_cast<uint32_t>(v < 0 ? -v : v);
      const int qv = static_cast<int>(
          (static_cast<uint64_t>(a + dv[i].corr) * dv[i].recip) >>
          dv[i].shift);
      coef[i] = static_cast<int16_t>(v < 0 ? -qv : qv);
    }
  };
  if (ncomp == 1) {  // one component: a non-interleaved scan of its blocks
    for (int by = 0; by < hblocks[0]; ++by) {
      for (int bx = 0; bx < wblocks[0]; ++bx) {
        quantized(0, by, bx, q);
        encode_block(0, q);
      }
    }
  } else {
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        for (int c = 0; c < ncomp; ++c) {
          int prev_dc = 0;
          for (int yy = 0; yy < cv[c]; ++yy) {
            for (int xx = 0; xx < ch[c]; ++xx) {
              const int by = my * cv[c] + yy, bx = mx * ch[c] + xx;
              if (by < hblocks[c] && bx < wblocks[c]) {
                quantized(c, by, bx, q);
              } else {  // a dummy block: zero, the DC of the one before
                memset(q, 0, sizeof(q));
                q[0] = static_cast<int16_t>(prev_dc);
              }
              prev_dc = q[0];
              encode_block(c, q);
            }
          }
        }
      }
    }
  }
  wr.flush();
  wr.word(0xFFD9);
  *out = static_cast<uint8_t*>(malloc(wr.out.size()));
  if (*out == nullptr) return 0;
  memcpy(*out, wr.out.data(), wr.out.size());
  return wr.out.size();
}

void bsvd_jpeg_free(void* p) { free(p); }

}  // extern "C"
