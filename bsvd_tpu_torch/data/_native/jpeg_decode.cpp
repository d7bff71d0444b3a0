// JPEG frame decoder of bsvd_tpu_torch, C++ standard library only (bound
// with ctypes by bsvd_tpu_torch/data/jpeg_decode.py, which builds it at
// first use):
//
//   g++ -O3 -shared -fPIC jpeg_decode.cpp -o libbsvd_jpeg.so -pthread
//
// Reads sequential (SOF0 / SOF1) and progressive (SOF2) Huffman-coded
// 8-bit JPEG, ITU T.81 Annexes F and G: gray or YCbCr, each component
// sampled at the frame's maximum or at half of it in either direction
// (4:4:4, 4:2:2, 4:4:0, 4:2:0), restart intervals, any frame size. Pixels
// equal libjpeg-turbo 3.x's with its defaults (what cv2.imread and the JAX
// package's decoder give): the accurate integer IDCT (jidctint.c) with its
// range limit, "fancy" triangle upsampling of the chroma (jdsample.c: the
// nearer sample 3/4, the further 1/4, alternating rounding biases, edges
// replicated; plain replication where a chroma row is 2 samples or
// fewer wide), and the fixed-point YCbCr -> RGB tables (jdcolor.c,
// 16 fraction bits). Gray frames give R = G = B = Y. In gray mode the
// output is Y alone, as libjpeg's JCS_GRAYSCALE gives it (cv2's
// IMREAD_GRAYSCALE): the chroma is entropy-decoded but never transformed,
// upsampled or converted.
//
// A window (y0, x0, ch, cw) of a frame is decoded as the train loader crops
// it: the entropy decoder walks each scan up to the last MCU row the window
// needs, and the IDCT, upsampling and colour conversion run only on the
// blocks the window touches plus the one chroma row and column the
// upsampling reads around it, so the window equals the crop of the whole
// decode bit for bit.
//
// Errors: kind 2 (UNSUPPORTED) for a valid stream of a kind not read here,
// naming the marker (arithmetic coding, lossless, hierarchical, 12-bit,
// 4 components, other sampling factors, RGB-coded files, progressive files
// that libjpeg would block-smooth); kind 1 (IO) for a truncated or corrupt
// stream, including entropy data that runs into a marker or the end of the
// file, which libjpeg only warns about and fills with zeros.

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Kind { kOk = 0, kIO = 1, kUnsupported = 2 };

struct JpegError {
  int kind;
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& msg) { throw JpegError{kIO, msg}; }
[[noreturn]] void unsupported(const std::string& msg) {
  throw JpegError{kUnsupported, msg};
}

// natural (row-major) position of the k-th coefficient in zigzag order
constexpr int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

std::string hex2(int code) {
  char buf[8];
  snprintf(buf, sizeof(buf), "0x%02X", code & 0xFF);
  return buf;
}

std::string marker_name(int code) {
  if (code >= 0xC0 && code <= 0xCF && code != 0xC4 && code != 0xC8 &&
      code != 0xCC) {
    return "SOF" + std::to_string(code - 0xC0) + " (" + hex2(code) + ")";
  }
  switch (code) {
    case 0xCC: return "DAC (0xCC)";
    case 0xDC: return "DNL (0xDC)";
    case 0xDE: return "DHP (0xDE)";
    case 0xDF: return "EXP (0xDF)";
    default: return "marker " + hex2(code);
  }
}

// ---------------------------------------------------------------------------
// the decoder's fixed tables: IDCT range limit and YCbCr -> RGB
// ---------------------------------------------------------------------------

struct Tables {
  uint8_t idct_limit[1024];  // range_limit[x & 1023] of jidctint.c
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  Tables() {
    // sample_range_limit + CENTERJSAMPLE, as jdmaster.c lays it out:
    // x in [0, 127] -> x + 128; [128, 511] -> 255; [512, 895] -> 0;
    // [896, 1023] (x = -128..-1 masked) -> x + 128
    for (int i = 0; i < 1024; ++i) {
      int v;
      if (i < 128) v = i + 128;
      else if (i < 512) v = 255;
      else if (i < 896) v = 0;
      else v = i - 896;
      idct_limit[i] = static_cast<uint8_t>(v);
    }
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) {
      return static_cast<int64_t>(x * 65536.0 + 0.5);
    };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = static_cast<int32_t>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int32_t>(-fix(0.34414) * x + one_half);
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---------------------------------------------------------------------------
// jpeg_idct_islow (jidctint.c): the accurate integer IDCT, 13-bit
// constants, 2 extra bits between the passes, into 8x8 samples
// ---------------------------------------------------------------------------

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

// coef: 64 coefficients in natural order; q: the multipliers (the
// quantization table, natural order, as libjpeg's 16-bit ISLOW_MULT_TYPE)
void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out,
                int stride) {
  const uint8_t* limit = tables().idct_limit;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int16_t* qq = q + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      const int dc = (int(in[0]) * qq[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = int(in[16]) * qq[16], z3 = int(in[48]) * qq[48];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    z2 = int(in[0]) * qq[0];
    z3 = int(in[32]) * qq[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int(in[56]) * qq[56];
    tmp1 = int(in[40]) * qq[40];
    tmp2 = int(in[24]) * qq[24];
    tmp3 = int(in[8]) * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConstBits - kPass1Bits;
    ws[0 * 8 + c] = static_cast<int>(descale(tmp10 + tmp3, n));
    ws[7 * 8 + c] = static_cast<int>(descale(tmp10 - tmp3, n));
    ws[1 * 8 + c] = static_cast<int>(descale(tmp11 + tmp2, n));
    ws[6 * 8 + c] = static_cast<int>(descale(tmp11 - tmp2, n));
    ws[2 * 8 + c] = static_cast<int>(descale(tmp12 + tmp1, n));
    ws[5 * 8 + c] = static_cast<int>(descale(tmp12 - tmp1, n));
    ws[3 * 8 + c] = static_cast<int>(descale(tmp13 + tmp0, n));
    ws[4 * 8 + c] = static_cast<int>(descale(tmp13 - tmp0, n));
  }
  constexpr int n2 = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      const uint8_t v = limit[descale(w[0], kPass1Bits + 3) & 1023];
      memset(o, v, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065;
    int64_t tmp3 = z1 + z2 * F0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = limit[descale(tmp10 + tmp3, n2) & 1023];
    o[7] = limit[descale(tmp10 - tmp3, n2) & 1023];
    o[1] = limit[descale(tmp11 + tmp2, n2) & 1023];
    o[6] = limit[descale(tmp11 - tmp2, n2) & 1023];
    o[2] = limit[descale(tmp12 + tmp1, n2) & 1023];
    o[5] = limit[descale(tmp12 - tmp1, n2) & 1023];
    o[3] = limit[descale(tmp13 + tmp0, n2) & 1023];
    o[4] = limit[descale(tmp13 - tmp0, n2) & 1023];
  }
}

// ---------------------------------------------------------------------------
// Huffman tables (Annex C) and the entropy-coded bit reader (Annex F.2.2.5)
// ---------------------------------------------------------------------------

constexpr int kLookBits = 10;

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// an AC code and its magnitude bits resolved by one lookup (both fit in
// kLookBits): the run of zeros before the coefficient, its value, and the
// bits the pair takes (0: not resolved here)
struct FastAC {
  int16_t value;
  uint8_t run;
  uint8_t len;
};

struct Huffman {
  bool defined = false;
  uint8_t fast_len[1 << kLookBits];  // 0: the code is longer than kLookBits
  uint8_t fast_sym[1 << kLookBits];
  FastAC fast_ac[1 << kLookBits];
  int32_t maxcode[18];   // largest code of each length, -1 where none
  int32_t valoffset[18];
  uint8_t vals[256];

  void build(const uint8_t* counts, const uint8_t* symbols, int nsym) {
    memcpy(vals, symbols, nsym);
    memset(fast_len, 0, sizeof(fast_len));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      valoffset[len] = k - code;
      for (int i = 0; i < counts[len - 1]; ++i, ++code, ++k) {
        if (code >= (1 << len)) {
          corrupt("corrupt JPEG (bad Huffman table: code overflow)");
        }
        if (len <= kLookBits) {
          const int shift = kLookBits - len;
          for (int j = 0; j < (1 << shift); ++j) {
            fast_len[(code << shift) | j] = static_cast<uint8_t>(len);
            fast_sym[(code << shift) | j] = symbols[k];
          }
        }
      }
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      // no code may be all ones (Annex C; libjpeg refuses such a table)
      if (code >= (1 << len)) {
        corrupt("corrupt JPEG (bad Huffman table: an all-ones code)");
      }
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    for (int i = 0; i < (1 << kLookBits); ++i) {
      FastAC& f = fast_ac[i];
      f.len = 0;
      const int len = fast_len[i], rs = fast_sym[i], sz = rs & 15;
      if (len == 0 || sz == 0 || len + sz > kLookBits) continue;
      const int bits = (i >> (kLookBits - len - sz)) & ((1 << sz) - 1);
      f.value = static_cast<int16_t>(extend(bits, sz));
      f.run = static_cast<uint8_t>(rs >> 4);
      f.len = static_cast<uint8_t>(len + sz);
    }
    defined = true;
  }
};

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos;         // next byte of entropy-coded data (or the marker)
  uint64_t buf = 0;   // MSB-aligned
  int cnt = 0;        // valid bits in buf
  int fake = 0;       // zero bits appended past a marker or the end
  bool at_marker = false;

  BitReader(const uint8_t* d, size_t n, size_t p) : data(d), size(n), pos(p) {}

  void fill() {
    while (cnt <= 56) {
      uint64_t byte = 0;
      if (!at_marker) {
        if (pos >= size) {
          at_marker = true;
        } else if (data[pos] != 0xFF) {
          byte = data[pos++];
        } else {
          size_t p = pos + 1;
          while (p < size && data[p] == 0xFF) ++p;  // fill bytes
          if (p < size && data[p] == 0x00) {        // a stuffed 0xFF
            byte = 0xFF;
            pos = p + 1;
          } else {                                  // a marker
            pos = p - 1;
            at_marker = true;
          }
        }
      }
      if (at_marker) fake += 8;
      buf |= byte << (56 - cnt);
      cnt += 8;
    }
  }

  // decoding consumed bits that the stream does not have
  void check() const {
    if (fake > cnt) {
      corrupt(pos + 1 >= size ? "truncated JPEG (entropy-coded data ends early)"
                          : "corrupt JPEG (entropy-coded data runs into "
                            "marker " + hex2(data[pos + 1]) + ")");
    }
  }

  int decode(const Huffman& h) {
    if (cnt < 16) fill();
    const int look = static_cast<int>(buf >> (64 - kLookBits));
    const int len = h.fast_len[look];
    if (len) {
      buf <<= len;
      cnt -= len;
      return h.fast_sym[look];
    }
    const int code16 = static_cast<int>(buf >> 48);
    for (int l = kLookBits + 1; l <= 16; ++l) {
      const int code = code16 >> (16 - l);
      if (code <= h.maxcode[l]) {
        buf <<= l;
        cnt -= l;
        return h.vals[(h.valoffset[l] + code) & 0xFF];
      }
    }
    corrupt("corrupt JPEG (invalid Huffman code)");
  }

  int bits(int n) {  // n in [0, 16]
    if (n == 0) return 0;
    if (cnt < n) fill();
    const int v = static_cast<int>(buf >> (64 - n));
    buf <<= n;
    cnt -= n;
    return v;
  }

  int bit() { return bits(1); }

  // the restart marker ending an interval: drop the padding bits, then
  // expect RSTn (Annex F.1.2.3; junk bytes before it are skipped, as
  // libjpeg does)
  void restart(int n) {
    check();
    buf = 0;
    cnt = 0;
    fake = 0;
    at_marker = false;
    while (pos + 1 < size &&
           !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
             data[pos + 1] != 0xFF)) {
      ++pos;
    }
    if (pos + 1 >= size) corrupt("truncated JPEG (no restart marker)");
    if (data[pos + 1] != 0xD0 + (n & 7)) {
      corrupt("corrupt JPEG (expected RST" + std::to_string(n & 7) +
              ", found " + marker_name(data[pos + 1]) + ")");
    }
    pos += 2;
  }
};

// ---------------------------------------------------------------------------
// frame, components and the window they serve
// ---------------------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;          // this scan's DC / AC table
  int rh = 1, rv = 1;          // upsampling ratio to the frame (1 or 2)
  int dw = 0, dh = 0;          // samples (downsampled size)
  int wblocks = 0, hblocks = 0;  // blocks that hold samples
  int bw = 0, bh = 0;          // blocks allocated (whole MCUs)
  int pred = 0;
  bool latched = false, seen = false;
  int16_t q[64];               // latched quantization table, natural order
  int coef_bits[64];           // progressive: last Al of each coefficient
  // needed block range [by0, by1) x [bx0, bx1)
  int by0 = 0, by1 = 0, bx0 = 0, bx1 = 0;
  std::unique_ptr<uint8_t[]> plane;       // bh*8 rows of bw*8 samples
  std::unique_ptr<int16_t[]> coef;        // progressive: bh*bw blocks
  int stride() const { return bw * 8; }
  int16_t* block(int by, int bx) {
    return coef.get() + (static_cast<size_t>(by) * bw + bx) * 64;
  }
};

struct Decoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool progressive = false, frame_seen = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  int eobrun = 0;
  Component comp[3];
  Huffman dc[4], ac[4];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  // the window (output pixels)
  int wy0 = 0, wx0 = 0, wh = 0, ww = 0;
  bool gray = false;           // output Y only (JCS_GRAYSCALE)

  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {}

  int byte() {
    if (pos >= size) corrupt("truncated JPEG (ends inside a marker segment)");
    return data[pos++];
  }
  int word() {
    const int hi = byte();
    return (hi << 8) | byte();
  }

  // the next marker's code, skipping fill bytes; garbage before a marker
  // is skipped as libjpeg does (with a warning there)
  int next_marker() {
    for (;;) {
      while (pos < size && data[pos] != 0xFF) ++pos;
      while (pos < size && data[pos] == 0xFF) ++pos;
      if (pos >= size) corrupt("truncated JPEG (no EOI marker)");
      const int code = data[pos++];
      if (code != 0x00) return code;
    }
  }

  // the next marker after entropy-coded data that was not read to its end:
  // stuffed bytes and restart markers are part of the scan
  int next_marker_after_scan() {
    for (;;) {
      const int code = next_marker();
      if (code < 0xD0 || code > 0xD7) return code;
    }
  }

  void skip_segment() {
    const int len = word();
    if (len < 2 || pos + len - 2 > size) {
      corrupt("truncated JPEG (marker segment past the end of the file)");
    }
    pos += len - 2;
  }

  void read_dqt() {
    const size_t end = segment_end();
    while (pos < end) {
      const int pq_tq = byte();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) corrupt("corrupt JPEG (bad DQT)");
      for (int k = 0; k < 64; ++k) {
        qt[tq][kNatural[k]] = static_cast<uint16_t>(pq ? word() : byte());
      }
      qt_defined[tq] = true;
    }
    if (pos != end) corrupt("corrupt JPEG (bad DQT length)");
  }

  void read_dht() {
    const size_t end = segment_end();
    while (pos < end) {
      const int tc_th = byte();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) corrupt("corrupt JPEG (bad DHT)");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) {
        counts[i] = static_cast<uint8_t>(byte());
        total += counts[i];
      }
      if (total > 256 || pos + total > end) {
        corrupt("corrupt JPEG (bad DHT)");
      }
      (tc ? ac : dc)[th].build(counts, data + pos, total);
      pos += total;
    }
    if (pos != end) corrupt("corrupt JPEG (bad DHT length)");
  }

  size_t segment_end() {
    const int len = word();
    if (len < 2 || pos + len - 2 > size) {
      corrupt("truncated JPEG (marker segment past the end of the file)");
    }
    return pos + len - 2;
  }

  void read_app(int code) {
    const size_t end = segment_end();
    const size_t n = end - pos;
    const uint8_t* p = data + pos;
    if (code == 0xE0 && n >= 14 && memcmp(p, "JFIF\0", 5) == 0) jfif = true;
    if (code == 0xEE && n >= 12 && memcmp(p, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = p[11];
    }
    pos = end;
  }

  void read_sof(int code) {
    if (frame_seen) corrupt("corrupt JPEG (a second SOF marker)");
    const size_t end = segment_end();
    const int precision = byte();
    height = word();
    width = word();
    ncomp = byte();
    if (precision != 8) {
      unsupported(std::to_string(precision) + "-bit JPEG (" +
                  marker_name(code) + "): only 8-bit samples are read");
    }
    if (height == 0) {
      unsupported("JPEG with its height in a DNL marker (" +
                  marker_name(code) + ")");
    }
    if (width == 0) corrupt("corrupt JPEG (frame width 0)");
    if (ncomp == 4) {
      unsupported("CMYK / YCCK JPEG (4 components, " + marker_name(code) +
                  ")");
    }
    if (ncomp != 1 && ncomp != 3) {
      unsupported(std::to_string(ncomp) + "-component JPEG (" +
                  marker_name(code) + ")");
    }
    if (end - pos != static_cast<size_t>(3 * ncomp)) {
      corrupt("corrupt JPEG (bad SOF length)");
    }
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) {
        corrupt("corrupt JPEG (bad component in SOF)");
      }
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    std::string factors;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      factors += (i ? "," : "") + std::to_string(c.h) + "x" +
                 std::to_string(c.v);
      c.rh = hmax / c.h;
      c.rv = vmax / c.v;
    }
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      if (ncomp > 1 && (hmax % c.h || vmax % c.v || c.rh > 2 || c.rv > 2)) {
        unsupported("JPEG sampling factors " + factors +
                    " (only 4:4:4, 4:2:2, 4:4:0 and 4:2:0 are read)");
      }
    }
    if (ncomp == 1) {  // one component: a non-interleaved scan, 1 block MCU
      comp[0].rh = comp[0].rv = 1;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.wblocks = (c.dw + 7) / 8;
      c.hblocks = (c.dh + 7) / 8;
      c.bw = ncomp == 1 ? c.wblocks : mcux * c.h;
      c.bh = ncomp == 1 ? c.hblocks : mcuy * c.v;
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    progressive = code == 0xC2;
    frame_seen = true;
  }

  // one marker segment between scans; returns the code of SOS / EOI,
  // which are the caller's, else 0
  int handle_marker(int code) {
    switch (code) {
      case 0xC0: case 0xC1: case 0xC2:
        read_sof(code);
        return 0;
      case 0xC3: case 0xC5: case 0xC6: case 0xC7:
        unsupported("lossless / hierarchical JPEG (" + marker_name(code) +
                    ")");
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
      case 0xCC:
        unsupported("arithmetic-coded JPEG (" + marker_name(code) + ")");
      case 0xDC: case 0xDE: case 0xDF:
        unsupported("JPEG with " + marker_name(code));
      case 0xC4:
        read_dht();
        return 0;
      case 0xDB:
        read_dqt();
        return 0;
      case 0xDD: {
        const size_t end = segment_end();
        if (end - pos != 2) corrupt("corrupt JPEG (bad DRI length)");
        restart_interval = word();
        return 0;
      }
      case 0xDA:
      case 0xD9:
        return code;
      case 0xD8:
        corrupt("corrupt JPEG (a second SOI marker)");
      default:
        if (code >= 0xE0 && code <= 0xEF) {
          read_app(code);
        } else if (code == 0xFE || (code >= 0xF0 && code <= 0xFD)) {
          skip_segment();
        } else {
          corrupt("corrupt JPEG (unexpected " + marker_name(code) + ")");
        }
        return 0;
    }
  }

  // markers from ``code`` on, up to SOS or EOI (or, with stop_at_frame,
  // the frame header); returns the last code
  int read_markers(int code, bool stop_at_frame) {
    for (;;) {
      const int done = handle_marker(code);
      if (done) return done;
      if (frame_seen && stop_at_frame) return code;
      code = next_marker();
    }
  }

  void read_header() {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) {
      corrupt("not a JPEG file (no SOI marker)");
    }
    pos = 2;
  }

  void dims(int* h, int* w) {
    read_header();
    const int code = read_markers(next_marker(), true);
    if (!frame_seen) {
      corrupt(code == 0xD9 ? "corrupt JPEG (EOI before a frame)"
                           : "corrupt JPEG (a scan before the frame header)");
    }
    *h = height;
    *w = width;
  }

  void check_colour() {
    if (ncomp != 3) return;
    // libjpeg's default_decompress_parms for 3 components
    bool rgb = false;
    if (jfif) {
      rgb = false;
    } else if (adobe) {
      rgb = adobe_transform == 0;
    } else {
      rgb = comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
    }
    if (rgb) {
      unsupported(adobe ? "RGB-coded JPEG (Adobe APP14 transform 0)"
                        : "RGB-coded JPEG (component ids 'R', 'G', 'B')");
    }
  }

  // the block ranges each component's window needs: the rows and columns
  // of its samples that the window's pixels read, one more on each side
  // where the component is upsampled (the triangle filter's neighbour);
  // none of the chroma in gray mode
  void plan_window() {
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (gray && i > 0) {
        c.by0 = c.by1 = c.bx0 = c.bx1 = 0;
        if (progressive) {
          c.coef.reset(new int16_t[static_cast<size_t>(c.bh) * c.bw * 64]());
        }
        continue;
      }
      int r0 = wy0, r1 = wy0 + wh - 1, c0 = wx0, c1 = wx0 + ww - 1;
      if (c.rv == 2) {
        r0 = r0 / 2 - 1;
        r1 = r1 / 2 + 1;
      }
      if (c.rh == 2) {
        c0 = c0 / 2 - 1;
        c1 = c1 / 2 + 1;
      }
      r0 = std::max(r0, 0);
      c0 = std::max(c0, 0);
      r1 = std::min(r1, c.dh - 1);
      c1 = std::min(c1, c.dw - 1);
      c.by0 = r0 / 8;
      c.by1 = r1 / 8 + 1;
      c.bx0 = c0 / 8;
      c.bx1 = c1 / 8 + 1;
      c.plane.reset(new uint8_t[static_cast<size_t>(c.bh) * 8 * c.bw * 8]);
      if (progressive) {
        const size_t n = static_cast<size_t>(c.bh) * c.bw * 64;
        c.coef.reset(new int16_t[n]());
      }
    }
  }

  bool needed(const Component& c, int by, int bx) const {
    return by >= c.by0 && by < c.by1 && bx >= c.bx0 && bx < c.bx1;
  }

  void latch(Component& c) {
    if (c.latched) return;
    if (!qt_defined[c.tq]) {
      corrupt("corrupt JPEG (quantization table " + std::to_string(c.tq) +
              " not defined)");
    }
    for (int k = 0; k < 64; ++k) c.q[k] = static_cast<int16_t>(qt[c.tq][k]);
    c.latched = true;
  }

  void idct_block(Component& c, const int16_t* blk, int by, int bx) {
    idct_islow(blk, c.q, c.plane.get() +
                             static_cast<size_t>(by) * 8 * c.stride() + bx * 8,
               c.stride());
  }

  // ---- sequential (Annex F.2.2) ---------------------------------------
  void seq_block(BitReader& br, Component& c, int by, int bx) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int16_t blk[64];
    memset(blk, 0, sizeof(blk));
    const int s = br.decode(hd);
    if (s > 15) corrupt("corrupt JPEG (DC category " + std::to_string(s) + ")");
    if (s) c.pred += extend(br.bits(s), s);
    blk[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64;) {
      if (br.cnt < 16) br.fill();
      const FastAC& f = ha.fast_ac[br.buf >> (64 - kLookBits)];
      if (f.len) {
        k += f.run;
        if (k > 63) corrupt("corrupt JPEG (AC run past the block)");
        blk[kNatural[k++]] = f.value;
        br.buf <<= f.len;
        br.cnt -= f.len;
        continue;
      }
      const int rs = br.decode(ha);
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        if (k > 63) corrupt("corrupt JPEG (AC run past the block)");
        blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(sz), sz));
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
    if (needed(c, by, bx)) idct_block(c, blk, by, bx);
  }

  // ---- progressive (Annex G.1.2) --------------------------------------
  void dc_first(BitReader& br, Component& c, int16_t* blk, int al) {
    const int s = br.decode(dc[c.td]);
    if (s > 15) corrupt("corrupt JPEG (DC category " + std::to_string(s) + ")");
    if (s) c.pred += extend(br.bits(s), s);
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.pred) << al);
  }

  void dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.bit()) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  void ac_first(BitReader& br, const Huffman& h, int16_t* blk, int ss, int se,
                int al) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      const int rs = br.decode(h);
      const int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > se) corrupt("corrupt JPEG (AC run past the band)");
        blk[kNatural[k]] = static_cast<int16_t>(
            static_cast<unsigned>(extend(br.bits(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = (1 << r) - 1;
        if (r) eobrun += br.bits(r);
        break;
      }
    }
  }

  void refine_nonzero(BitReader& br, int16_t* coef, int p1) {
    if (br.bit() && (*coef & p1) == 0) {
      *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef - p1);
    }
  }

  void ac_refine(BitReader& br, const Huffman& h, int16_t* blk, int ss,
                 int se, int al) {
    const int p1 = 1 << al;
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = br.decode(h);
        int r = rs >> 4, s = rs & 15, val = 0;
        if (s) {
          if (s != 1) corrupt("corrupt JPEG (refinement size != 1)");
          val = br.bit() ? p1 : -p1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        // advance over r zero coefficients, refining nonzero ones
        for (; k <= se; ++k) {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            refine_nonzero(br, coef, p1);
          } else {
            if (r == 0) break;
            --r;
          }
        }
        if (val) {
          if (k > se) corrupt("corrupt JPEG (refinement past the band)");
          blk[kNatural[k]] = static_cast<int16_t>(val);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) refine_nonzero(br, coef, p1);
      }
      --eobrun;
    }
  }

  // ---- one scan ---------------------------------------------------------
  // returns after the scan's last needed MCU; pos is left at the next
  // marker's code
  void read_scan() {
    const size_t end = segment_end();
    const int ns = byte();
    if (ns < 1 || ns > ncomp || end - pos != static_cast<size_t>(2 * ns + 3)) {
      corrupt("corrupt JPEG (bad SOS)");
    }
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      const int id = byte();
      const int t = byte();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j) {
        if (comp[j].id == id) c = &comp[j];
      }
      if (c == nullptr) corrupt("corrupt JPEG (SOS names no frame component)");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3) corrupt("corrupt JPEG (bad SOS table)");
      sc[i] = c;
    }
    const int ss = byte(), se = byte(), a = byte();
    const int ah = a >> 4, al = a & 15;
    if (progressive) {
      if (ss > se || se > 63 || (ss == 0 && se != 0) ||
          (ss > 0 && ns != 1) || al > 13 || (ah != 0 && ah - 1 != al)) {
        corrupt("corrupt JPEG (invalid progressive scan parameters)");
      }
    }
    const bool dc_scan = !progressive || ss == 0;
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      latch(c);
      c.seen = true;
      c.pred = 0;
      if (dc_scan && (!progressive || ah == 0) && !dc[c.td].defined) {
        corrupt("corrupt JPEG (DC Huffman table " + std::to_string(c.td) +
                " not defined)");
      }
      if ((!progressive || ss > 0) && !ac[c.ta].defined) {
        corrupt("corrupt JPEG (AC Huffman table " + std::to_string(c.ta) +
                " not defined)");
      }
      if (progressive) {
        for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
      }
    }
    eobrun = 0;
    BitReader br(data, size, pos);
    const int ri = restart_interval;
    int restarts = 0, in_interval = 0;
    auto mcu_done = [&](bool last) {
      br.check();
      if (ri && !last && ++in_interval == ri) {
        br.restart(restarts++);
        in_interval = 0;
        eobrun = 0;
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
      }
    };
    auto block = [&](Component& c, int by, int bx) {
      if (!progressive) {
        seq_block(br, c, by, bx);
        return;
      }
      int16_t* blk = c.block(by, bx);
      if (ss == 0) {
        if (ah == 0) dc_first(br, c, blk, al);
        else dc_refine(br, blk, al);
      } else if (ah == 0) {
        ac_first(br, ac[c.ta], blk, ss, se, al);
      } else {
        ac_refine(br, ac[c.ta], blk, ss, se, al);
      }
    };
    if (ns == 1) {
      Component& c = *sc[0];
      const int rows = std::min(c.hblocks, c.by1);
      for (int by = 0; by < rows; ++by) {
        for (int bx = 0; bx < c.wblocks; ++bx) {
          block(c, by, bx);
          mcu_done(by == c.hblocks - 1 && bx == c.wblocks - 1);
        }
      }
    } else {
      int rows = 0;
      for (int i = 0; i < ns; ++i) {
        rows = std::max(rows, (sc[i]->by1 + sc[i]->v - 1) / sc[i]->v);
      }
      rows = std::min(rows, mcuy);
      for (int my = 0; my < rows; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int yy = 0; yy < c.v; ++yy) {
              for (int xx = 0; xx < c.h; ++xx) {
                block(c, my * c.v + yy, mx * c.h + xx);
              }
            }
          }
          mcu_done(my == mcuy - 1 && mx == mcux - 1);
        }
      }
    }
    pos = br.pos;
  }

  // libjpeg-turbo block-smooths a progressive frame whose first AC
  // coefficients (1-9) are not all fully refined (jdcoefct.c smoothing_ok);
  // that estimate is not ported
  void check_smoothing() {
    static const int kSmoothed[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      if (!c.latched) return;
      for (int k : kSmoothed) {
        if (c.q[k] == 0) return;
      }
      if (c.coef_bits[0] < 0) return;
      for (int k = 1; k < 10; ++k) {
        if (c.coef_bits[k] != 0) useful = true;
      }
    }
    if (useful) {
      unsupported("progressive JPEG whose scans leave the first AC "
                  "coefficients unrefined (libjpeg block-smooths it; not "
                  "ported)");
    }
  }

  // decode up to what the window needs; whole: the window must be the
  // whole frame
  void decode(int y0, int x0, int h, int w, bool whole) {
    read_header();
    int code = read_markers(next_marker(), false);
    if (!frame_seen) {
      corrupt(code == 0xD9 ? "corrupt JPEG (EOI before a frame)"
                           : "corrupt JPEG (a scan before the frame header)");
    }
    if (code != 0xDA) corrupt("corrupt JPEG (no scan)");
    if (whole && (height != h || width != w)) {
      corrupt(std::to_string(height) + "x" + std::to_string(width) +
              " frame, not the " + std::to_string(h) + "x" +
              std::to_string(w) + " of the first");
    }
    if (y0 < 0 || x0 < 0 || h <= 0 || w <= 0 || y0 + h > height ||
        x0 + w > width) {
      corrupt("window (" + std::to_string(y0) + ", " + std::to_string(x0) +
              ", " + std::to_string(h) + ", " + std::to_string(w) +
              ") outside the " + std::to_string(height) + "x" +
              std::to_string(width) + " frame");
    }
    check_colour();
    wy0 = y0;
    wx0 = x0;
    wh = h;
    ww = w;
    plan_window();
    for (;;) {
      read_scan();
      if (!progressive) {
        bool all = true;
        for (int i = 0; i < ncomp; ++i) all = all && comp[i].seen;
        if (all) break;
      }
      code = read_markers(next_marker_after_scan(), false);
      if (code == 0xD9) break;
    }
    for (int i = 0; i < ncomp; ++i) {
      if (!comp[i].seen) {
        corrupt("corrupt JPEG (component " + std::to_string(comp[i].id) +
                " in no scan)");
      }
    }
    if (progressive) {
      check_smoothing();
      for (int i = 0; i < ncomp; ++i) {
        Component& c = comp[i];
        for (int by = c.by0; by < c.by1; ++by) {
          for (int bx = c.bx0; bx < c.bx1; ++bx) {
            idct_block(c, c.block(by, bx), by, bx);
          }
        }
      }
    }
  }

  // ---- upsampling (jdsample.c) and colour (jdcolor.c) ------------------
  // The triangle filters read the neighbouring sample, the edge sample
  // standing in past either end (libjpeg's first / last column cases and
  // its replicated context rows); each output pair (2j, 2j + 1) takes
  // sample j with j - 1 and j + 1, biased 1 / 2 (h2v1) or 8 / 7 (h2v2).

  // pairs[i] for output columns 2 (j0 + i) and 2 (j0 + i) + 1 from
  // v[i + 1] (and v[i], v[i + 2]), i in [0, m)
  static void pairs_h2(const int* v, int m, int lo_bias, int hi_bias,
                       int shift, uint8_t* out) {
    for (int i = 0; i < m; ++i) {
      const int here = 3 * v[i + 1];
      out[2 * i] = static_cast<uint8_t>((here + v[i] + lo_bias) >> shift);
      out[2 * i + 1] =
          static_cast<uint8_t>((here + v[i + 2] + hi_bias) >> shift);
    }
  }

  // component samples for output row y, columns [x0, x0 + n), into out
  void upsample_row(const Component& c, int y, int x0, int n,
                    uint8_t* out) const {
    const int s = c.stride();
    const uint8_t* p = c.plane.get();
    if (c.rh == 1 && c.rv == 1) {
      memcpy(out, p + static_cast<size_t>(y) * s + x0, n);
      return;
    }
    const int r = c.rv == 2 ? y >> 1 : y;
    const uint8_t* near_row = p + static_cast<size_t>(r) * s;
    const uint8_t* far_row = near_row;
    if (c.rv == 2) {
      const int far = (y & 1) ? std::min(r + 1, c.dh - 1) : std::max(r - 1, 0);
      far_row = p + static_cast<size_t>(far) * s;
    }
    if (c.rh == 1) {  // h1v2: always the triangle filter
      const int bias = (y & 1) ? 2 : 1;
      for (int i = 0; i < n; ++i) {
        const int x = x0 + i;
        out[i] = static_cast<uint8_t>(
            (3 * near_row[x] + far_row[x] + bias) >> 2);
      }
      return;
    }
    if (c.dw <= 2) {  // h2v1 / h2v2 by replication (libjpeg's plain path)
      for (int i = 0; i < n; ++i) out[i] = near_row[(x0 + i) >> 1];
      return;
    }
    // the samples (h2v1) or column sums (h2v2) of j0 - 1 .. j1 + 1
    const int j0 = x0 >> 1, j1 = (x0 + n - 1) >> 1, m = j1 - j0 + 1;
    int vbuf[520];
    uint8_t obuf[1040];
    std::vector<int> vbig;
    std::vector<uint8_t> obig;
    int* v = vbuf;
    uint8_t* o = obuf;
    if (m + 2 > 520) {
      vbig.resize(m + 2);
      obig.resize(2 * m);
      v = vbig.data();
      o = obig.data();
    }
    for (int i = 0; i < m + 2; ++i) {
      const int j = std::min(std::max(j0 - 1 + i, 0), c.dw - 1);
      v[i] = c.rv == 2 ? 3 * near_row[j] + far_row[j] : near_row[j];
    }
    if (c.rv == 2) {
      pairs_h2(v, m, 8, 7, 4, o);
    } else {
      pairs_h2(v, m, 1, 2, 2, o);
    }
    memcpy(out, o + (x0 & 1), n);
  }

  // the window as RGB8 rows at dst (stride ww * 3), or as Y rows (stride
  // ww) in gray mode
  void emit(uint8_t* dst) const {
    if (gray) {
      for (int r = 0; r < wh; ++r) {
        upsample_row(comp[0], wy0 + r, wx0, ww,
                     dst + static_cast<size_t>(r) * ww);
      }
      return;
    }
    std::vector<uint8_t> rows(static_cast<size_t>(ww) * 3);
    uint8_t* y_row = rows.data();
    uint8_t* cb_row = y_row + ww;
    uint8_t* cr_row = cb_row + ww;
    const Tables& t = tables();
    for (int r = 0; r < wh; ++r) {
      const int y = wy0 + r;
      uint8_t* o = dst + static_cast<size_t>(r) * ww * 3;
      upsample_row(comp[0], y, wx0, ww, y_row);
      if (ncomp == 1) {
        for (int i = 0; i < ww; ++i) {
          o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = y_row[i];
        }
        continue;
      }
      upsample_row(comp[1], y, wx0, ww, cb_row);
      upsample_row(comp[2], y, wx0, ww, cr_row);
      for (int i = 0; i < ww; ++i) {
        const int yy = y_row[i], cb = cb_row[i], cr = cr_row[i];
        o[3 * i] = clamp255(yy + t.cr_r[cr]);
        o[3 * i + 1] = clamp255(yy + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        o[3 * i + 2] = clamp255(yy + t.cb_b[cb]);
      }
    }
  }
};

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  std::vector<uint8_t> out;
  uint8_t chunk[1 << 16];
  size_t n;
  while ((n = fread(chunk, 1, sizeof(chunk), f)) > 0) {
    out.insert(out.end(), chunk, chunk + n);
  }
  const bool ok = !ferror(f);
  fclose(f);
  buf->swap(out);
  return ok;
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err == nullptr || errlen <= 0) return;
  const size_t n = std::min(msg.size(), static_cast<size_t>(errlen - 1));
  memcpy(err, msg.data(), n);
  err[n] = '\0';
}

// decode one buffer's window into dst (RGB, or Y in gray mode); whole = the
// window must be the frame
int decode_window(const uint8_t* data, size_t len, int y0, int x0, int ch,
                  int cw, bool whole, bool gray, uint8_t* dst,
                  std::string* msg) {
  try {
    Decoder d(data, len);
    d.gray = gray;
    d.decode(y0, x0, ch, cw, whole);
    d.emit(dst);
    return kOk;
  } catch (const JpegError& e) {
    *msg = e.msg;
    return e.kind;
  } catch (const std::bad_alloc&) {
    *msg = "out of memory";
    return kIO;
  }
}

// ---------------------------------------------------------------------------
// thread pool (the shape of the JAX package's native decoder's)
// ---------------------------------------------------------------------------

class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i) workers_.emplace_back([this] { Loop(); });
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

extern "C" {

struct BsvdJpegLoader {
  ThreadPool* pool;
};

BsvdJpegLoader* bsvd_jpeg_loader_create(int num_threads) {
  auto* l = new BsvdJpegLoader();
  l->pool = new ThreadPool(num_threads > 0 ? num_threads : 4);
  return l;
}

// (H, W) of a JPEG file, from its markers up to the frame header. Returns
// 0, or the error kind (1 IO, 2 unsupported) with its message in err.
int bsvd_jpeg_image_dims(const char* path, int* h, int* w, char* err,
                         int errlen) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) {
    set_error(err, errlen, "cannot read the file");
    return kIO;
  }
  try {
    Decoder d(buf.data(), buf.size());
    d.dims(h, w);
    return kOk;
  } catch (const JpegError& e) {
    set_error(err, errlen, e.msg);
    return e.kind;
  }
}

// Decode T files in parallel, each cropped to (ch, cw) at (y0, x0), into a
// contiguous (T, ch, cw, 3) RGB8 array, or (T, ch, cw) Y with gray = 1;
// y0 = x0 = -1 takes whole frames of exactly (ch, cw). Returns 0, else the
// 1-based index of the first frame that failed, with its error kind in
// *kind and its message in err.
int bsvd_jpeg_load_crop_seq(const char** paths, int t, int y0, int x0,
                            int ch, int cw, int gray, uint8_t* out,
                            BsvdJpegLoader* l, int* kind, char* err,
                            int errlen) {
  std::vector<int> status(t, 0);
  std::vector<std::string> msgs(t);
  const bool whole = y0 < 0 && x0 < 0;
  Latch latch(t);
  for (int i = 0; i < t; ++i) {
    auto job = [&, i] {
      std::vector<uint8_t> buf;
      if (!read_file(paths[i], &buf)) {
        status[i] = kIO;
        msgs[i] = "cannot read the file";
      } else {
        uint8_t* dst =
            out + static_cast<size_t>(i) * ch * cw * (gray ? 1 : 3);
        status[i] = decode_window(buf.data(), buf.size(), whole ? 0 : y0,
                                  whole ? 0 : x0, ch, cw, whole, gray != 0,
                                  dst, &msgs[i]);
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
    if (status[i]) {
      *kind = status[i];
      set_error(err, errlen, msgs[i]);
      return i + 1;
    }
  }
  return 0;
}

}  // extern "C"
