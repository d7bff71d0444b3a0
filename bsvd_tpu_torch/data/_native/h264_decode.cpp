// The port's H.264 decoder on the host, for the train loader's mp4 clips
// (bsvd_tpu_torch/data/h264_decode.py binds it with ctypes; the JAX package
// decodes the same clips with cv2's FFmpeg). Standard C++ only, built at
// first use:
//
//   g++ -O2 -shared -fPIC -std=c++20 h264_decode.cpp -o libbsvd_h264.so
//
// What it decodes (ITU-T H.264, clause numbers below): progressive 8-bit
// 4:2:0 CAVLC streams with I and P slices, several slices a picture:
// every SPS / PPS field of profiles 66 / 77 / 100 (scaling matrices with
// fall-back rules A and B, transform_8x8_mode_flag, both chroma QP
// offsets), I_NxN at 4x4 and 8x8 (8.3.1-8.3.2), the 24 I_16x16 types
// (8.3.3), I_PCM, the four chroma modes (8.3.4), constrained_intra_pred,
// P_L0 16x16 / 16x8 / 8x16, P_8x8 and P_8x8ref0 with every sub-partition,
// P_Skip (8.4.1), quarter-pel luma and eighth-pel chroma (8.4.2.2),
// explicit weighted prediction (8.4.2.3), CAVLC residuals (9.2), the
// 4x4 / 8x8 / DC transforms (8.5), the deblocking filter (8.7), reference
// lists with modification (8.2.4) and the marking process with the
// sliding window and MMCO 1-6 (8.2.5). Intra macroblocks in B slices
// decode; B-slice inter prediction does not.
//
// Streams of a kind not decoded raise "unsupported" (code 2) naming the
// syntax element and its value; corrupt or truncated data raises
// "corrupt" (code 1), and so does refused syntax that the stream's
// profile does not allow (Annex A: SP / SI slices and data partitioning
// only in Extended, arbitrary slice order and redundant pictures only in
// Baseline and Extended, B slices not in Baseline), which only damaged
// data holds. Pictures are placed in display order by the
// demuxer's display index of each access unit (one picture a sample), so
// picture order counts are parsed but not needed.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <tuple>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  explicit Corrupt(const std::string& s) : std::runtime_error(s) {}
};
struct Unsupported : std::runtime_error {
  explicit Unsupported(const std::string& s) : std::runtime_error(s) {}
};

std::string vfmt(const char* f, va_list ap) {
  char buf[512];
  vsnprintf(buf, sizeof buf, f, ap);
  return buf;
}

[[noreturn]] void corrupt(const char* f, ...) {
  va_list ap;
  va_start(ap, f);
  std::string s = vfmt(f, ap);
  va_end(ap);
  throw Corrupt(s);
}

// ROADMAP Queue 1 item 5's later slices: B-slice inter prediction (5b),
// CABAC (5c), and H.264 syntax no DAVIS clip uses (5e)
#define ITEM_B "ROADMAP Queue 1 item 5b"
#define ITEM_CABAC "ROADMAP Queue 1 item 5c"
#define ITEM_REST "ROADMAP Queue 1 item 5e"

[[noreturn]] void unsupported(const char* f, ...) {
  va_list ap;
  va_start(ap, f);
  std::string s = vfmt(f, ap);
  va_end(ap);
  throw Unsupported(s);
}

constexpr int BASELINE = 66, EXTENDED = 88;

// corrupt unless the stream's profile allows the refused syntax (Annex A)
void allowed_in(int profile, bool allowed, const char* what) {
  if (!allowed) corrupt("%s in a profile_idc %d stream, which does not allow it", what, profile);
}

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline uint8_t clip1(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// ---------------------------------------------------------------- tables

// 4x4 and 8x8 zig-zag scans: scan index -> raster index (row * n + col)
const uint8_t ZZ4[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t ZZ8[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Default scaling lists (Table 7-3, 7-4), raster order
uint8_t DEF4[2][16];   // intra, inter
uint8_t DEF8[2][64];
const uint8_t DEF4_ZZ[2][16] = {
    {6, 13, 13, 20, 20, 20, 28, 28, 28, 28, 32, 32, 32, 37, 37, 42},
    {10, 14, 14, 20, 20, 20, 24, 24, 24, 24, 27, 27, 27, 30, 30, 34}};
const uint8_t DEF8_ZZ[2][64] = {
    {6,  10, 10, 13, 11, 13, 16, 16, 16, 16, 18, 18, 18, 18, 18, 23,
     23, 23, 23, 23, 23, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27,
     27, 27, 27, 27, 29, 29, 29, 29, 29, 29, 29, 31, 31, 31, 31, 31,
     31, 33, 33, 33, 33, 33, 36, 36, 36, 36, 38, 38, 38, 40, 40, 42},
    {9,  13, 13, 15, 13, 15, 17, 17, 17, 17, 19, 19, 19, 19, 19, 21,
     21, 21, 21, 21, 21, 22, 22, 22, 22, 22, 22, 22, 24, 24, 24, 24,
     24, 24, 24, 24, 25, 25, 25, 25, 25, 25, 25, 27, 27, 27, 27, 27,
     27, 28, 28, 28, 28, 28, 30, 30, 30, 30, 32, 32, 32, 33, 33, 35}};

// normAdjust4x4 by (row & 1) + (col & 1), normAdjust8x8 by NORM8_POS (8.5.9)
const int NORM4[6][3] = {{10, 13, 16}, {11, 14, 18}, {13, 16, 20},
                         {14, 18, 23}, {16, 20, 25}, {18, 23, 29}};
const int NORM8[6][6] = {{20, 18, 32, 19, 25, 24}, {22, 19, 35, 21, 28, 26},
                         {26, 23, 42, 24, 33, 31}, {28, 25, 45, 26, 35, 33},
                         {32, 28, 51, 30, 40, 38}, {36, 32, 58, 34, 46, 43}};
const uint8_t NORM8_POS[16] = {0, 3, 4, 3, 3, 1, 5, 1, 4, 5, 2, 5, 3, 1, 5, 1};

// QPc from qPI >= 30 (Table 8-15)
const uint8_t QPC[22] = {29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36,
                         36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};
inline int chroma_qp(int qp, int offset) {
  int qpi = clip3(0, 51, qp + offset);
  return qpi < 30 ? qpi : QPC[qpi - 30];
}

// deblocking (Tables 8-16, 8-17)
const uint8_t ALPHA[52] = {
    0,  0,  0,  0,  0,  0,  0,  0,   0,   0,   0,   0,   0,   0,
    0,  0,  4,  4,  5,  6,  7,  8,   9,   10,  12,  13,  15,  17,
    20, 22, 25, 28, 32, 36, 40, 45,  50,  56,  63,  71,  80,  90,
    101, 113, 127, 144, 162, 182, 203, 226, 255, 255};
const uint8_t BETA[52] = {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
                          0,  0,  0,  0,  0,  2,  2,  2,  3,  3,  3,
                          3,  4,  4,  4,  6,  6,  7,  7,  8,  8,  9,
                          9,  10, 10, 11, 11, 12, 12, 13, 13, 14, 14,
                          15, 15, 16, 16, 17, 17, 18, 18};
const uint8_t TC0[52][3] = {
    {0, 0, 0},  {0, 0, 0},  {0, 0, 0},  {0, 0, 0},   {0, 0, 0},
    {0, 0, 0},  {0, 0, 0},  {0, 0, 0},  {0, 0, 0},   {0, 0, 0},
    {0, 0, 0},  {0, 0, 0},  {0, 0, 0},  {0, 0, 0},   {0, 0, 0},
    {0, 0, 0},  {0, 0, 0},  {0, 0, 1},  {0, 0, 1},   {0, 0, 1},
    {0, 0, 1},  {0, 1, 1},  {0, 1, 1},  {1, 1, 1},   {1, 1, 1},
    {1, 1, 1},  {1, 1, 1},  {1, 1, 2},  {1, 1, 2},   {1, 1, 2},
    {1, 1, 2},  {1, 2, 3},  {1, 2, 3},  {2, 2, 3},   {2, 2, 4},
    {2, 3, 4},  {2, 3, 4},  {3, 3, 5},  {3, 4, 6},   {3, 4, 6},
    {4, 5, 7},  {4, 5, 8},  {4, 6, 9},  {5, 7, 10},  {6, 8, 11},
    {6, 8, 13}, {7, 10, 14}, {8, 11, 16}, {9, 12, 18}, {10, 13, 20},
    {11, 15, 23}, {13, 17, 25}};

// coded_block_pattern by codeNum (Table 9-4, ChromaArrayType 1 / 2)
const uint8_t CBP_INTRA[48] = {47, 31, 15, 0,  23, 27, 29, 30, 7,  11, 13, 14,
                               39, 43, 45, 46, 16, 3,  5,  10, 12, 19, 21, 26,
                               28, 35, 37, 42, 44, 1,  2,  4,  8,  17, 18, 20,
                               24, 6,  9,  22, 25, 32, 33, 34, 36, 40, 38, 41};
const uint8_t CBP_INTER[48] = {0,  16, 1,  2,  4,  8,  32, 3,  5,  10, 12, 15,
                               47, 7,  11, 13, 14, 6,  9,  31, 35, 37, 42, 44,
                               33, 34, 36, 40, 39, 43, 45, 46, 17, 18, 20, 24,
                               19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41};

// CAVLC code tables (9.2): length and code of each symbol.
// coeff_token for 0 <= nC < 2, 2 <= nC < 4, 4 <= nC < 8, by
// TotalCoeff * 4 + TrailingOnes (Table 9-5)
const uint8_t CT_LEN[3][68] = {
    {1,  0,  0,  0,  6,  2,  0,  0,  8,  6,  3,  0,  9,  8,  7,  5,  10,
     9,  8,  6,  11, 10, 9,  7,  13, 11, 10, 8,  13, 13, 11, 9,  13, 13,
     13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15, 14, 14, 15, 15, 15,
     14, 16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16},
    {2,  0,  0,  0,  6,  2,  0,  0,  6,  5,  3,  0,  7,  6,  6,  4,  8,
     6,  6,  4,  8,  7,  7,  5,  9,  8,  8,  6,  11, 9,  9,  6,  11, 11,
     11, 7,  12, 11, 11, 9,  12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13,
     12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14, 13, 14, 14, 14, 14},
    {4,  0,  0,  0,  6,  4,  0,  0,  6,  5,  4,  0,  6,  5,  5,  4,  7,
     5,  5,  4,  7,  5,  5,  4,  7,  6,  6,  4,  7,  6,  6,  4,  8,  7,
     7,  5,  8,  8,  7,  6,  9,  8,  8,  7,  9,  9,  8,  8,  9,  9,  9,
     8,  10, 9,  9,  9,  10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10}};
const uint8_t CT_BITS[3][68] = {
    {1,  0,  0,  0,  5,  1,  0,  0,  7,  4,  1,  0,  7,  6,  5,  3,  7,
     6,  5,  3,  7,  6,  5,  4,  15, 6,  5,  4,  11, 14, 5,  4,  8,  10,
     13, 4,  15, 14, 9,  4,  11, 10, 13, 12, 15, 14, 9,  12, 11, 10, 13,
     8,  15, 1,  9,  12, 11, 14, 13, 8,  7,  10, 9,  12, 4,  6,  5,  8},
    {3,  0,  0,  0,  11, 2,  0,  0,  7,  7,  3,  0,  7,  10, 9,  5,  7,
     6,  5,  4,  4,  6,  5,  6,  7,  6,  5,  8,  15, 6,  5,  4,  11, 14,
     13, 4,  15, 10, 9,  4,  11, 14, 13, 12, 8,  10, 9,  8,  15, 14, 13,
     12, 11, 10, 9,  12, 7,  11, 6,  8,  9,  8,  10, 1,  7,  6,  5,  4},
    {15, 0,  0,  0,  15, 14, 0,  0,  11, 15, 13, 0,  8,  12, 14, 12, 15,
     10, 11, 11, 11, 8,  9,  10, 9,  14, 13, 9,  8,  10, 9,  8,  15, 14,
     13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9,  12, 8,  10, 13,
     8,  13, 7,  9,  12, 9,  12, 11, 10, 5,  8,  7,  6,  1,  4,  3,  2}};
// coeff_token for the chroma DC (nC == -1), TotalCoeff 0..4
const uint8_t CDC_LEN[20] = {2, 0, 0, 0, 6, 1, 0, 0, 6, 6,
                             3, 0, 6, 7, 7, 6, 6, 8, 8, 7};
const uint8_t CDC_BITS[20] = {1, 0, 0, 0, 7, 1, 0, 0, 4, 6,
                              1, 0, 3, 3, 2, 5, 2, 3, 2, 0};
// total_zeros by TotalCoeff 1..15 (Tables 9-7, 9-8) and for the chroma DC
// by TotalCoeff 1..3 (Table 9-9a)
const uint8_t TZ_LEN[15][16] = {
    {1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9},
    {3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6},
    {4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6},
    {5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5},
    {4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5},
    {6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6},
    {6, 5, 3, 3, 3, 2, 3, 4, 3, 6},
    {6, 4, 5, 3, 2, 2, 3, 3, 6},
    {6, 6, 4, 2, 2, 3, 2, 5},
    {5, 5, 3, 2, 2, 2, 4},
    {4, 4, 3, 3, 1, 3},
    {4, 4, 2, 1, 3},
    {3, 3, 1, 2},
    {2, 2, 1},
    {1, 1}};
const uint8_t TZ_BITS[15][16] = {
    {1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1},
    {7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0},
    {5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0},
    {3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0},
    {5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0},
    {1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0},
    {1, 1, 5, 4, 3, 3, 2, 1, 1, 0},
    {1, 1, 1, 3, 3, 2, 2, 1, 0},
    {1, 0, 1, 3, 2, 1, 1, 1},
    {1, 0, 1, 3, 2, 1, 1},
    {0, 1, 1, 2, 1, 3},
    {0, 1, 1, 1, 1},
    {0, 1, 1, 1},
    {0, 1, 1},
    {0, 1}};
const uint8_t TZC_LEN[3][4] = {{1, 2, 3, 3}, {1, 2, 2}, {1, 1}};
const uint8_t TZC_BITS[3][4] = {{1, 1, 1, 0}, {1, 1, 0}, {1, 0}};
// run_before by zerosLeft 1..6 and > 6 (Table 9-10)
const uint8_t RB_LEN[7][15] = {{1, 1},
                               {1, 2, 2},
                               {2, 2, 2, 2},
                               {2, 2, 2, 3, 3},
                               {2, 2, 3, 3, 3, 3},
                               {2, 3, 3, 3, 3, 3, 3},
                               {3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11}};
const uint8_t RB_BITS[7][15] = {{1, 0},
                                {1, 1, 0},
                                {3, 2, 1, 0},
                                {3, 2, 1, 1, 0},
                                {3, 2, 3, 2, 1, 0},
                                {3, 0, 1, 3, 2, 5, 4},
                                {7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1}};

// 4x4 block index (8.5.3 order) <-> (x, y) in 4x4 units within a macroblock
uint8_t BLK_X[16], BLK_Y[16], BLK_AT[4][4];   // BLK_AT[y][x]

// ----------------------------------------------------------- bit reader

inline uint64_t load_be64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return __builtin_bswap64(v);
}

// MSB-first reads of an RBSP held with 8 zero bytes after its end; reads
// past the end give zeros (the caller's check() raises).
struct Bits {
  const uint8_t* d = nullptr;
  size_t nbits = 0, pos = 0, stop = 0;   // stop: rbsp_stop_one_bit's position

  uint32_t peek(int n) const {
    if (!n || (pos >> 3) >= (nbits >> 3)) return 0;
    uint64_t v = load_be64(d + (pos >> 3)) << (pos & 7);
    return static_cast<uint32_t>(v >> (64 - n));
  }
  void skip(int n) { pos += n; }
  uint32_t u(int n) {
    uint32_t v = peek(n);
    pos += n;
    return v;
  }
  uint32_t ue() {
    uint32_t v = peek(32);
    if (!v) corrupt("exp-Golomb code of more than 32 bits");
    int lz = __builtin_clz(v);
    pos += lz;
    if (lz == 31) {
      pos += 1;
      return (1u << 31) - 1 + u(31);
    }
    return u(lz + 1) - 1;
  }
  int32_t se() {
    uint32_t k = ue();
    return (k & 1) ? static_cast<int32_t>((k >> 1) + 1)
                   : -static_cast<int32_t>(k >> 1);
  }
  bool more_rbsp_data() const { return pos < stop; }
  void check() const {
    if (pos > nbits) corrupt("slice data past the end of its NAL unit");
  }
};

// A prefix code: lookup by the next `bits` bits.
struct Vlc {
  int bits = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  void build(const std::vector<std::tuple<int, int, int>>& codes) {
    bits = 0;
    for (auto& c : codes) bits = std::max(bits, std::get<0>(c));
    sym.assign(size_t(1) << bits, -1);
    len.assign(size_t(1) << bits, 0);
    for (auto& c : codes) {
      int l = std::get<0>(c), code = std::get<1>(c), s = std::get<2>(c);
      if (!l) continue;
      uint32_t first = static_cast<uint32_t>(code) << (bits - l);
      for (uint32_t i = 0; i < (1u << (bits - l)); ++i) {
        sym[first + i] = static_cast<int16_t>(s);
        len[first + i] = static_cast<uint8_t>(l);
      }
    }
  }
  int read(Bits& b, const char* what) const {
    uint32_t v = b.peek(bits);
    int s = sym[v];
    if (s < 0) corrupt("invalid %s code", what);
    b.skip(len[v]);
    return s;
  }
};

Vlc VLC_CT[3], VLC_CDC, VLC_TZ[15], VLC_TZC[3], VLC_RB[7];

struct Init {
  Init() {
    for (int i = 0; i < 16; ++i) {
      int b8 = i >> 2, b4 = i & 3;
      BLK_X[i] = static_cast<uint8_t>((b8 & 1) * 2 + (b4 & 1));
      BLK_Y[i] = static_cast<uint8_t>((b8 >> 1) * 2 + (b4 >> 1));
      BLK_AT[BLK_Y[i]][BLK_X[i]] = static_cast<uint8_t>(i);
    }
    for (int t = 0; t < 2; ++t) {
      for (int i = 0; i < 16; ++i) DEF4[t][ZZ4[i]] = DEF4_ZZ[t][i];
      for (int i = 0; i < 64; ++i) DEF8[t][ZZ8[i]] = DEF8_ZZ[t][i];
    }
    for (int t = 0; t < 3; ++t) {
      std::vector<std::tuple<int, int, int>> c;
      for (int s = 0; s < 68; ++s) c.emplace_back(CT_LEN[t][s], CT_BITS[t][s], s);
      VLC_CT[t].build(c);
    }
    {
      std::vector<std::tuple<int, int, int>> c;
      for (int s = 0; s < 20; ++s) c.emplace_back(CDC_LEN[s], CDC_BITS[s], s);
      VLC_CDC.build(c);
    }
    for (int t = 0; t < 15; ++t) {
      std::vector<std::tuple<int, int, int>> c;
      for (int s = 0; s < 16 - t; ++s) c.emplace_back(TZ_LEN[t][s], TZ_BITS[t][s], s);
      VLC_TZ[t].build(c);
    }
    for (int t = 0; t < 3; ++t) {
      std::vector<std::tuple<int, int, int>> c;
      for (int s = 0; s < 4 - t; ++s) c.emplace_back(TZC_LEN[t][s], TZC_BITS[t][s], s);
      VLC_TZC[t].build(c);
    }
    for (int t = 0; t < 7; ++t) {
      std::vector<std::tuple<int, int, int>> c;
      int n = t < 6 ? t + 2 : 15;
      for (int s = 0; s < n; ++s) c.emplace_back(RB_LEN[t][s], RB_BITS[t][s], s);
      VLC_RB[t].build(c);
    }
  }
};
const Init INIT;

// ------------------------------------------------------ parameter sets

struct Sps {
  bool valid = false;
  int profile = 0, chroma_format = 1;
  bool scaling_present = false;
  uint8_t sl4[6][16], sl8[2][64];   // raster order
  int log2_max_frame_num = 4, poc_type = 0, log2_max_poc_lsb = 4;
  bool delta_poc_always_zero = false;
  int max_num_ref_frames = 0;
  bool gaps_allowed = false;
  int mbw = 0, mbh = 0;
};

struct Pps {
  bool valid = false;
  int sps_id = 0;
  bool bottom_field_pic_order = false;
  int num_ref_idx_default[2] = {1, 1};
  bool weighted_pred = false;
  int weighted_bipred_idc = 0;
  int pic_init_qp = 26;
  int chroma_qp_offset[2] = {0, 0};
  bool deblock_ctrl = false, constrained_intra = false, redundant_present = false;
  bool t8x8 = false;
  uint8_t sl4[6][16], sl8[2][64];
};

// scaling_list() (7.3.2.1.1.1) into raster order; `deflt` where the list
// asks for its default, `fallback` where it is absent
void read_scaling_list(Bits& b, uint8_t* out, int size, const uint8_t* deflt,
                       const uint8_t* fallback) {
  if (!b.u(1)) {
    std::memcpy(out, fallback, size);
    return;
  }
  const uint8_t* scan = size == 16 ? ZZ4 : ZZ8;
  int last = 8, next = 8;
  for (int j = 0; j < size; ++j) {
    if (next) {
      int delta = b.se();
      if (delta < -128 || delta > 127) corrupt("delta_scale %d", delta);
      next = (last + delta + 256) % 256;
      if (j == 0 && next == 0) {
        std::memcpy(out, deflt, size);
        return;
      }
    }
    out[scan[j]] = static_cast<uint8_t>(next ? next : last);
    last = out[scan[j]];
  }
}

// ------------------------------------------------------------- pictures

struct Picture {
  std::vector<uint8_t> y, cb, cr;
  int frame_num = 0, long_idx = -1, serial = 0;
  bool short_ref = false, long_ref = false;
  bool ref() const { return short_ref || long_ref; }
};

enum MbKind : uint8_t { MB_I4, MB_I8, MB_I16, MB_PCM, MB_P, MB_SKIP };

struct MbInfo {
  uint8_t kind = MB_SKIP;
  bool t8 = false;
  int8_t qp = 0;          // QPY for deblocking (0 for I_PCM)
  int8_t qpc[2] = {0, 0};
  int slice = -1;
  bool intra() const { return kind <= MB_PCM; }
};

struct Weight {
  int w = 1, o = 0;
};

struct Slice {
  int type = 0;               // 0 P, 1 B, 2 I
  int idc = 0, alpha_off = 0, beta_off = 0;
  int num_ref = 0;
  Picture* list[33] = {};
  bool weighted = false;
  int luma_log2 = 0, chroma_log2 = 0;
  Weight lw[32], cw[32][2];
};

struct Mmco {
  int op, a, b;
};

// ---------------------------------------------------------------- decoder

struct Decoder {
  Sps sps[32];
  Pps pps[256];
  const Sps* sp = nullptr;
  const Pps* pp = nullptr;
  int mbw = 0, mbh = 0, W = 0, H = 0;
  std::vector<std::unique_ptr<Picture>> pool;
  Picture* cur = nullptr;
  int serial = 0;
  int prev_ref_frame_num = -1;   // -1: no reference decoded yet
  int max_long_idx = -1;         // -1: no long-term frame indices

  // per picture
  std::vector<MbInfo> mb;
  std::vector<int8_t> ipred;     // per luma 4x4: Intra4x4/8x8 mode, -1 other
  std::vector<uint8_t> nz;       // per luma 4x4: TotalCoeff
  std::vector<uint8_t> nzc[2];   // per chroma 4x4: TotalCoeff of AC
  std::vector<uint8_t> nzdb;     // per luma 4x4: coefficients for the filter
  std::vector<int16_t> mv;       // per luma 4x4: x, y
  std::vector<int8_t> refi;      // per luma 4x4: refIdxL0, -1 intra
  std::vector<int32_t> refpic;   // per luma 4x4: the reference's serial
  std::vector<Slice> slices;
  int next_mb = 0, mbs_decoded = 0;
  bool pic_idr = false, pic_ref = false, pic_started = false;
  int pic_frame_num = 0;
  bool long_term_reference_flag = false, adaptive = false;
  std::vector<Mmco> mmcos;

  // per slice
  Slice* sl = nullptr;
  int slice_num = 0;
  int qp = 0;
  int mbx = 0, mby = 0, cur_mb = 0;
  int s4 = 0;   // luma 4x4 stride of the per-picture arrays

  // per macroblock
  int levels[16][16];         // luma 4x4 levels by scan index
  int levels8[4][64];         // CAVLC 8x8: interleaved levels by 8x8 scan
  int dcl[16];                // Intra16x16DCLevel
  int cdc[2][4];              // chroma DC
  int cac[2][4][16];          // chroma AC by scan index (index 0 unused)

  // ----------------------------------------------------- NAL units
  void parse_sps(Bits& b) {
    Sps s;
    s.profile = b.u(8);
    b.u(8);   // constraint flags
    b.u(8);   // level_idc
    uint32_t id = b.ue();
    if (id > 31) corrupt("seq_parameter_set_id %u", id);
    static const int high[] = {100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135};
    bool is_high = std::find(std::begin(high), std::end(high), s.profile) != std::end(high);
    for (int i = 0; i < 6; ++i) std::memset(s.sl4[i], 16, 16);
    for (int i = 0; i < 2; ++i) std::memset(s.sl8[i], 16, 64);
    if (is_high) {
      s.chroma_format = b.ue();
      if (s.chroma_format == 3) b.u(1);
      int dy = b.ue() + 8, dc = b.ue() + 8;
      if (s.chroma_format != 1)
        unsupported("H.264 chroma_format_idc %d: the host decoder reads 4:2:0 only (" ITEM_REST ")",
                    s.chroma_format);
      if (dy != 8 || dc != 8)
        unsupported("H.264 bit_depth_luma %d / bit_depth_chroma %d: the host decoder reads "
                    "8-bit streams only (" ITEM_REST ")", dy, dc);
      if (b.u(1))
        unsupported("H.264 qpprime_y_zero_transform_bypass_flag 1 (lossless macroblocks): "
                    "the host decoder does not read it (" ITEM_REST ")");
      s.scaling_present = b.u(1);
      if (s.scaling_present) {
        for (int i = 0; i < 6; ++i) {
          const uint8_t* fb = i == 0 ? DEF4[0] : i == 3 ? DEF4[1] : s.sl4[i - 1];
          read_scaling_list(b, s.sl4[i], 16, DEF4[i >= 3], fb);
        }
        for (int i = 0; i < 2; ++i) read_scaling_list(b, s.sl8[i], 64, DEF8[i], DEF8[i]);
      }
    }
    s.log2_max_frame_num = b.ue() + 4;
    if (s.log2_max_frame_num > 16) corrupt("log2_max_frame_num %d", s.log2_max_frame_num);
    s.poc_type = b.ue();
    if (s.poc_type == 0) {
      s.log2_max_poc_lsb = b.ue() + 4;
      if (s.log2_max_poc_lsb > 16) corrupt("log2_max_pic_order_cnt_lsb %d", s.log2_max_poc_lsb);
    } else if (s.poc_type == 1) {
      s.delta_poc_always_zero = b.u(1);
      b.se();
      b.se();
      uint32_t n = b.ue();
      if (n > 255) corrupt("num_ref_frames_in_pic_order_cnt_cycle %u", n);
      for (uint32_t i = 0; i < n; ++i) b.se();
    } else if (s.poc_type != 2) {
      corrupt("pic_order_cnt_type %d", s.poc_type);
    }
    s.max_num_ref_frames = b.ue();
    if (s.max_num_ref_frames > 16) corrupt("max_num_ref_frames %d", s.max_num_ref_frames);
    s.gaps_allowed = b.u(1);
    s.mbw = b.ue() + 1;
    s.mbh = b.ue() + 1;
    if (!b.u(1))
      unsupported("H.264 frame_mbs_only_flag 0 (interlaced coding): the host decoder reads "
                  "progressive streams only (" ITEM_REST ")");
    // Level 6.2's largest frame
    if (s.mbw * s.mbh > 139264) corrupt("picture of %d x %d macroblocks", s.mbw, s.mbh);
    // direct_8x8_inference, cropping and VUI: the demuxer's SPS reader
    if (b.pos > b.nbits) corrupt("SPS truncated");
    s.valid = true;
    sps[id] = s;
  }

  void parse_pps(Bits& b) {
    Pps p;
    uint32_t id = b.ue();
    if (id > 255) corrupt("pic_parameter_set_id %u", id);
    p.sps_id = b.ue();
    if (p.sps_id > 31 || !sps[p.sps_id].valid) corrupt("PPS of a missing SPS %d", p.sps_id);
    const Sps& s = sps[p.sps_id];
    if (b.u(1))
      unsupported("H.264 entropy_coding_mode_flag 1 (CABAC): the host decoder reads CAVLC "
                  "streams only (" ITEM_CABAC ")");
    p.bottom_field_pic_order = b.u(1);
    uint32_t groups = b.ue();
    if (groups)
      unsupported("H.264 num_slice_groups_minus1 %u (slice groups, FMO): the host decoder "
                  "does not read them (" ITEM_REST ")", groups);
    for (int l = 0; l < 2; ++l) {
      p.num_ref_idx_default[l] = b.ue() + 1;
      if (p.num_ref_idx_default[l] > 32)
        corrupt("num_ref_idx_default %d", p.num_ref_idx_default[l]);
    }
    p.weighted_pred = b.u(1);
    p.weighted_bipred_idc = b.u(2);
    p.pic_init_qp = 26 + b.se();
    if (p.pic_init_qp < 0 || p.pic_init_qp > 51) corrupt("pic_init_qp %d", p.pic_init_qp);
    b.se();   // pic_init_qs
    p.chroma_qp_offset[0] = p.chroma_qp_offset[1] = b.se();
    if (std::abs(p.chroma_qp_offset[0]) > 12)
      corrupt("chroma_qp_index_offset %d", p.chroma_qp_offset[0]);
    p.deblock_ctrl = b.u(1);
    p.constrained_intra = b.u(1);
    p.redundant_present = b.u(1);
    std::memcpy(p.sl4, s.sl4, sizeof p.sl4);
    std::memcpy(p.sl8, s.sl8, sizeof p.sl8);
    if (b.more_rbsp_data()) {
      p.t8x8 = b.u(1);
      if (b.u(1)) {   // pic_scaling_matrix_present_flag: fall-back A or B
        const uint8_t* f4[2] = {s.scaling_present ? s.sl4[0] : DEF4[0],
                                s.scaling_present ? s.sl4[3] : DEF4[1]};
        const uint8_t* f8[2] = {s.scaling_present ? s.sl8[0] : DEF8[0],
                                s.scaling_present ? s.sl8[1] : DEF8[1]};
        for (int i = 0; i < 6; ++i) {
          const uint8_t* fb = i == 0 ? f4[0] : i == 3 ? f4[1] : p.sl4[i - 1];
          read_scaling_list(b, p.sl4[i], 16, DEF4[i >= 3], fb);
        }
        if (p.t8x8)
          for (int i = 0; i < 2; ++i) read_scaling_list(b, p.sl8[i], 64, DEF8[i], f8[i]);
      }
      p.chroma_qp_offset[1] = b.se();
      if (std::abs(p.chroma_qp_offset[1]) > 12)
        corrupt("second_chroma_qp_index_offset %d", p.chroma_qp_offset[1]);
    }
    if (b.pos > b.nbits) corrupt("PPS truncated");
    p.valid = true;
    pps[id] = p;
  }

  // ------------------------------------------------------- pictures
  Picture* new_picture() {
    for (auto& p : pool)
      if (!p->ref() && p.get() != cur) return p.get();
    pool.emplace_back(new Picture());
    return pool.back().get();
  }

  void start_picture(int frame_num, bool idr, bool ref) {
    cur = nullptr;
    Picture* p = new_picture();
    size_t ny = size_t(W) * H, nc = ny / 4;
    p->y.resize(ny);
    p->cb.resize(nc);
    p->cr.resize(nc);
    p->frame_num = frame_num;
    p->long_idx = -1;
    p->short_ref = p->long_ref = false;
    p->serial = ++serial;
    cur = p;
    int n = mbw * mbh;
    s4 = mbw * 4;
    mb.assign(n, MbInfo());
    ipred.assign(size_t(n) * 16, -1);
    nz.assign(size_t(n) * 16, 0);
    nzc[0].assign(size_t(n) * 4, 0);
    nzc[1].assign(size_t(n) * 4, 0);
    nzdb.assign(size_t(n) * 16, 0);
    mv.assign(size_t(n) * 32, 0);
    refi.assign(size_t(n) * 16, -1);
    refpic.assign(size_t(n) * 16, -1);
    slices.clear();
    next_mb = mbs_decoded = 0;
    pic_idr = idr;
    pic_ref = ref;
    pic_frame_num = frame_num;
    pic_started = true;
  }

  // FrameNumWrap of a short-term reference (8.2.4.1)
  int pic_num(const Picture* p) const {
    int max = 1 << sp->log2_max_frame_num;
    return p->frame_num > pic_frame_num ? p->frame_num - max : p->frame_num;
  }

  void finish_picture() {
    if (mbs_decoded != mbw * mbh)
      corrupt("picture with %d of %d macroblocks", mbs_decoded, mbw * mbh);
    deblock_picture();
    if (pic_ref) mark_references();
    pic_started = false;
  }

  // 8.2.5: the marking process after a reference picture
  void mark_references() {
    if (pic_idr) {
      for (auto& p : pool)
        if (p.get() != cur) p->short_ref = p->long_ref = false;
      if (long_term_reference_flag) {
        cur->long_ref = true;
        cur->long_idx = 0;
        max_long_idx = 0;
      } else {
        cur->short_ref = true;
        max_long_idx = -1;
      }
      prev_ref_frame_num = 0;
      return;
    }
    bool cur_long = false, mmco5 = false;
    if (adaptive) {
      for (const Mmco& m : mmcos) {
        if (m.op == 1 || m.op == 3) {
          int pn = pic_frame_num - (m.a + 1);
          Picture* hit = nullptr;
          for (auto& p : pool)
            if (p.get() != cur && p->short_ref && pic_num(p.get()) == pn) hit = p.get();
          if (!hit) corrupt("memory_management_control_operation %d of a missing picture", m.op);
          if (m.op == 1) {
            hit->short_ref = false;
          } else {
            if (m.b > max_long_idx) corrupt("long_term_frame_idx %d over its maximum", m.b);
            for (auto& p : pool)
              if (p->long_ref && p->long_idx == m.b && p.get() != hit) p->long_ref = false;
            hit->short_ref = false;
            hit->long_ref = true;
            hit->long_idx = m.b;
          }
        } else if (m.op == 2) {
          Picture* hit = nullptr;
          for (auto& p : pool)
            if (p.get() != cur && p->long_ref && p->long_idx == m.a) hit = p.get();
          if (!hit) corrupt("memory_management_control_operation 2 of a missing picture");
          hit->long_ref = false;
        } else if (m.op == 4) {
          max_long_idx = m.a - 1;
          for (auto& p : pool)
            if (p->long_ref && p->long_idx > max_long_idx) p->long_ref = false;
        } else if (m.op == 5) {
          for (auto& p : pool)
            if (p.get() != cur) p->short_ref = p->long_ref = false;
          max_long_idx = -1;
          mmco5 = true;
        } else if (m.op == 6) {
          if (m.a > max_long_idx) corrupt("long_term_frame_idx %d over its maximum", m.a);
          for (auto& p : pool)
            if (p.get() != cur && p->long_ref && p->long_idx == m.a) p->long_ref = false;
          cur->long_ref = true;
          cur->long_idx = m.a;
          cur_long = true;
        }
      }
    } else {   // the sliding window (8.2.5.3)
      int n_short = 0, n_long = 0;
      Picture* oldest = nullptr;
      for (auto& p : pool) {
        if (p.get() == cur) continue;
        if (p->short_ref) {
          ++n_short;
          if (!oldest || pic_num(p.get()) < pic_num(oldest)) oldest = p.get();
        }
        if (p->long_ref) ++n_long;
      }
      if (n_short + n_long >= std::max(sp->max_num_ref_frames, 1)) {
        if (!n_short) corrupt("sliding window with no short-term reference");
        oldest->short_ref = false;
      }
    }
    if (!cur_long) cur->short_ref = true;
    if (mmco5) cur->frame_num = 0;
    prev_ref_frame_num = mmco5 ? 0 : pic_frame_num;
    int refs = 0;
    for (auto& p : pool) refs += p->ref();
    if (refs > std::max(sp->max_num_ref_frames, 1))
      corrupt("%d reference frames over max_num_ref_frames %d", refs, sp->max_num_ref_frames);
  }

  // ------------------------------------------------------- slice header
  void slice_header(Bits& b, int nal_type, int ref_idc, Slice& s, int& first_mb) {
    first_mb = b.ue();
    uint32_t st = b.ue();
    if (st > 9) corrupt("slice_type %u", st);
    st %= 5;
    uint32_t pid = b.ue();
    if (pid > 255 || !pps[pid].valid) corrupt("slice of a missing PPS %u", pid);
    const Pps& p = pps[pid];
    const Sps& q = sps[p.sps_id];
    if (st == 3 || st == 4) {
      allowed_in(q.profile, q.profile == EXTENDED, st == 3 ? "an SP slice" : "an SI slice");
      unsupported("H.264 slice_type %u (%s): the host decoder does not read SP / SI slices ("
                  ITEM_REST ")", st, st == 3 ? "SP" : "SI");
    }
    if (st == 1) allowed_in(q.profile, q.profile != BASELINE, "a B slice");
    s.type = static_cast<int>(st);
    if (pic_started && (sp != &q)) corrupt("slices of one picture on two SPSs");
    pp = &p;
    sp = &q;
    bool idr = nal_type == 5;
    int frame_num = b.u(q.log2_max_frame_num);
    if (idr) b.ue();   // idr_pic_id
    if (q.poc_type == 0) {
      b.u(q.log2_max_poc_lsb);
      if (p.bottom_field_pic_order) b.se();
    } else if (q.poc_type == 1 && !q.delta_poc_always_zero) {
      b.se();
      if (p.bottom_field_pic_order) b.se();
    }
    if (p.redundant_present) {
      uint32_t r = b.ue();
      if (r) {
        allowed_in(q.profile, q.profile == BASELINE || q.profile == EXTENDED,
                   "a redundant picture");
        unsupported("H.264 redundant_pic_cnt %u: the host decoder does not read redundant "
                    "pictures (" ITEM_REST ")", r);
      }
    }
    if (s.type == 1) b.u(1);   // direct_spatial_mv_pred_flag
    int num_ref[2] = {p.num_ref_idx_default[0], p.num_ref_idx_default[1]};
    if (s.type != 2) {
      if (b.u(1)) {
        num_ref[0] = b.ue() + 1;
        if (s.type == 1) num_ref[1] = b.ue() + 1;
      }
      if (num_ref[0] > 16 || num_ref[1] > 16)
        corrupt("num_ref_idx_active %d / %d", num_ref[0], num_ref[1]);
    }
    s.num_ref = s.type == 0 ? num_ref[0] : 0;
    // the picture starts with its first slice: its frame_num and the
    // references the lists are made of
    if (!pic_started) {
      if (!idr && (q.mbw != mbw || q.mbh != mbh)) {
        for (auto& r : pool)
          if (r->ref()) corrupt("picture size changed without an IDR");
      }
      mbw = q.mbw;
      mbh = q.mbh;
      W = mbw * 16;
      H = mbh * 16;
      if (!idr && prev_ref_frame_num >= 0) {
        int max = 1 << q.log2_max_frame_num;
        if (frame_num != prev_ref_frame_num && frame_num != (prev_ref_frame_num + 1) % max) {
          if (q.gaps_allowed)
            unsupported("H.264 gaps_in_frame_num_value_allowed_flag 1 with a gap in frame_num "
                        "(%d after %d): the host decoder does not read it (" ITEM_REST ")",
                        frame_num, prev_ref_frame_num);
          corrupt("frame_num %d after %d: frames missing", frame_num, prev_ref_frame_num);
        }
      }
      start_picture(frame_num, idr, ref_idc != 0);
    } else if (frame_num != pic_frame_num || idr != pic_idr || (ref_idc != 0) != pic_ref) {
      corrupt("two pictures in one access unit");
    }
    if (s.type == 0) {
      // 8.2.4.2.1: short-term by descending PicNum, long-term by ascending
      // LongTermPicNum
      std::vector<Picture*> st_refs, lt_refs;
      for (auto& r : pool) {
        if (r.get() == cur) continue;
        if (r->short_ref) st_refs.push_back(r.get());
        else if (r->long_ref) lt_refs.push_back(r.get());
      }
      std::sort(st_refs.begin(), st_refs.end(),
                [this](Picture* a, Picture* c) { return pic_num(a) > pic_num(c); });
      std::sort(lt_refs.begin(), lt_refs.end(),
                [](Picture* a, Picture* c) { return a->long_idx < c->long_idx; });
      std::vector<Picture*> init = st_refs;
      init.insert(init.end(), lt_refs.begin(), lt_refs.end());
      for (int i = 0; i < 33; ++i)
        s.list[i] = i < s.num_ref && i < static_cast<int>(init.size()) ? init[i] : nullptr;
    }
    for (int l = 0; l < (s.type == 1 ? 2 : s.type == 0 ? 1 : 0); ++l) {
      if (!b.u(1)) continue;   // ref_pic_list_modification_flag
      int n = num_ref[l], max = 1 << q.log2_max_frame_num;
      int pred = frame_num, idx = 0;
      for (;;) {
        uint32_t op = b.ue();
        if (op == 3) break;
        if (op > 2) corrupt("modification_of_pic_nums_idc %u", op);
        if (idx > n) corrupt("ref_pic_list_modification longer than its list");
        uint32_t v = b.ue();
        if (s.type != 0) continue;   // B slices: intra macroblocks only
        Picture* hit = nullptr;
        if (op < 2) {
          int d = static_cast<int>(v) + 1;
          if (d > max) corrupt("abs_diff_pic_num_minus1 %u", v);
          int nowrap = op == 0 ? pred - d : pred + d;
          if (nowrap < 0) nowrap += max;
          if (nowrap >= max) nowrap -= max;
          pred = nowrap;
          int pn = nowrap > frame_num ? nowrap - max : nowrap;
          for (auto& r : pool)
            if (r.get() != cur && r->short_ref && pic_num(r.get()) == pn) hit = r.get();
        } else {
          for (auto& r : pool)
            if (r.get() != cur && r->long_ref && r->long_idx == static_cast<int>(v)) hit = r.get();
        }
        if (!hit) corrupt("ref_pic_list_modification of a missing picture");
        for (int c = n; c > idx; --c) s.list[c] = s.list[c - 1];
        s.list[idx++] = hit;
        int k = idx;
        for (int c = idx; c <= n; ++c)
          if (s.list[c] != hit) s.list[k++] = s.list[c];
      }
      if (s.type == 0)
        for (int i = n; i < 33; ++i) s.list[i] = nullptr;
    }
    s.weighted = false;
    if ((p.weighted_pred && s.type == 0) || (p.weighted_bipred_idc == 1 && s.type == 1)) {
      s.weighted = s.type == 0;
      s.luma_log2 = b.ue();
      s.chroma_log2 = b.ue();
      if (s.luma_log2 > 7 || s.chroma_log2 > 7)
        corrupt("weight denominators %d / %d", s.luma_log2, s.chroma_log2);
      for (int l = 0; l < (s.type == 1 ? 2 : 1); ++l) {
        for (int i = 0; i < num_ref[l]; ++i) {
          Weight lw{1 << s.luma_log2, 0};
          Weight cw[2] = {{1 << s.chroma_log2, 0}, {1 << s.chroma_log2, 0}};
          auto coded = [&b]() {
            int v = b.se();
            if (v < -128 || v > 127) corrupt("prediction weight or offset %d", v);
            return v;
          };
          if (b.u(1)) {
            lw.w = coded();
            lw.o = coded();
          }
          if (b.u(1))
            for (int c = 0; c < 2; ++c) {
              cw[c].w = coded();
              cw[c].o = coded();
            }
          if (l == 0) {
            s.lw[i] = lw;
            s.cw[i][0] = cw[0];
            s.cw[i][1] = cw[1];
          }
        }
      }
    }
    if (ref_idc) {   // dec_ref_pic_marking: the first slice's is applied
      bool first = slices.empty();
      if (idr) {
        b.u(1);   // no_output_of_prior_pics_flag
        bool lt = b.u(1);
        if (first) long_term_reference_flag = lt;
      } else {
        bool ad = b.u(1);
        std::vector<Mmco> ops;
        if (ad)
          for (;;) {
            uint32_t op = b.ue();
            if (op == 0) break;
            if (op > 6 || ops.size() > 64) corrupt("memory_management_control_operation %u", op);
            Mmco m{static_cast<int>(op), 0, 0};
            if (op == 1 || op == 3) m.a = b.ue();
            if (op == 2) m.a = b.ue();
            if (op == 3 || op == 6) (op == 3 ? m.b : m.a) = b.ue();
            if (op == 4) m.a = b.ue();
            ops.push_back(m);
          }
        if (first) {
          adaptive = ad;
          mmcos = ops;
        }
      }
    }
    int qp0 = p.pic_init_qp + b.se();
    if (qp0 < 0 || qp0 > 51) corrupt("slice QP %d", qp0);
    qp = qp0;
    s.idc = 0;
    s.alpha_off = s.beta_off = 0;
    if (p.deblock_ctrl) {
      s.idc = b.ue();
      if (s.idc > 2) corrupt("disable_deblocking_filter_idc %d", s.idc);
      if (s.idc != 1) {
        int a = b.se(), c = b.se();
        if (a < -6 || a > 6 || c < -6 || c > 6) corrupt("deblocking offsets %d / %d", a, c);
        s.alpha_off = a * 2;
        s.beta_off = c * 2;
      }
    }
    b.check();
  }

  // --------------------------------------------------- neighbours
  // The luma 4x4 (picture index) at (x, y) relative to the current
  // macroblock, or -1 where not available: outside the picture, another
  // slice, or a block of this macroblock not decoded before `limit` (the
  // block index of the partition asking). *mb_out: its macroblock.
  int nb4(int x, int y, int limit, int* mb_out) const {
    int mx = mbx, my = mby;
    if (y < 0) {
      --my;
      if (x < 0) --mx;
      else if (x >= 16) ++mx;
    } else if (x < 0) {
      --mx;
    } else if (x >= 16) {
      return -1;
    } else {
      if (BLK_AT[y >> 2][x >> 2] >= limit) return -1;
      if (mb_out) *mb_out = cur_mb;
      return (my * 4 + (y >> 2)) * s4 + mx * 4 + (x >> 2);
    }
    if (y > 15 || mx < 0 || mx >= mbw || my < 0) return -1;
    int addr = my * mbw + mx;
    if (mb[addr].slice != slice_num) return -1;
    if (mb_out) *mb_out = addr;
    return (my * 4 + (((y + 16) & 15) >> 2)) * s4 + mx * 4 + (((x + 16) & 15) >> 2);
  }

  bool mb_avail(int dx, int dy) const {
    int mx = mbx + dx, my = mby + dy;
    if (mx < 0 || mx >= mbw || my < 0) return false;
    return mb[my * mbw + mx].slice == slice_num;
  }
  // available for intra prediction (constrained_intra_pred)
  bool mb_intra_avail(int dx, int dy) const {
    if (!mb_avail(dx, dy)) return false;
    return !pp->constrained_intra || mb[(mby + dy) * mbw + mbx + dx].intra();
  }
  int blk4(int b) const { return (mby * 4 + BLK_Y[b]) * s4 + mbx * 4 + BLK_X[b]; }

  // nC of luma block b (9.2.1)
  int nc_luma(int b) {
    int x = BLK_X[b] * 4, y = BLK_Y[b] * 4;
    int a = nb4(x - 1, y, 16, nullptr), c = nb4(x, y - 1, 16, nullptr);
    if (a >= 0 && c >= 0) return (nz[a] + nz[c] + 1) >> 1;
    if (a >= 0) return nz[a];
    if (c >= 0) return nz[c];
    return 0;
  }
  int nc_chroma(int comp, int b) {
    int bx = b & 1, by = b >> 1, s2 = mbw * 2;
    int na = -1, nb = -1;
    if (bx) na = nzc[comp][(mby * 2 + by) * s2 + mbx * 2];
    else if (mb_avail(-1, 0)) na = nzc[comp][(mby * 2 + by) * s2 + mbx * 2 - 1];
    if (by) nb = nzc[comp][(mby * 2) * s2 + mbx * 2 + bx];
    else if (mb_avail(0, -1)) nb = nzc[comp][(mby * 2 - 1) * s2 + mbx * 2 + bx];
    if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
    if (na >= 0) return na;
    if (nb >= 0) return nb;
    return 0;
  }

  // ----------------------------------------------------- residual
  // residual_block_cavlc (7.3.5.3.2): coefficients into out[0..max-1] by
  // scan index; returns TotalCoeff
  int residual_block(Bits& b, int nc, int max, int* out) {
    for (int i = 0; i < max; ++i) out[i] = 0;
    int sym;
    if (nc < 0) {
      sym = VLC_CDC.read(b, "coeff_token");
    } else if (nc < 8) {
      sym = VLC_CT[nc < 2 ? 0 : nc < 4 ? 1 : 2].read(b, "coeff_token");
    } else {
      int v = b.u(6);
      if (v == 3) sym = 0;
      else {
        sym = ((v >> 2) + 1) * 4 + (v & 3);
        if ((v & 3) > (v >> 2) + 1) corrupt("invalid coeff_token code");
      }
    }
    int tc = sym >> 2, t1 = sym & 3;
    if (tc > max) corrupt("TotalCoeff %d of a block of %d", tc, max);
    if (!tc) return 0;
    int level[16];
    int suffix_len = tc > 10 && t1 < 3 ? 1 : 0;
    for (int i = 0; i < tc; ++i) {
      if (i < t1) {
        level[i] = b.u(1) ? -1 : 1;
        continue;
      }
      int prefix = 0;
      while (!b.u(1)) {
        if (++prefix > 32) corrupt("level_prefix over 32");
      }
      int code = std::min(15, prefix) << suffix_len;
      if (suffix_len > 0 || prefix >= 14) {
        int size = prefix == 14 && suffix_len == 0 ? 4 : prefix >= 15 ? prefix - 3 : suffix_len;
        if (size > 28) corrupt("level_prefix %d", prefix);
        if (size) code += b.u(size);
      }
      if (prefix >= 15 && suffix_len == 0) code += 15;
      if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
      if (i == t1 && t1 < 3) code += 2;
      level[i] = code % 2 == 0 ? (code + 2) >> 1 : (-code - 1) >> 1;
      if (suffix_len == 0) suffix_len = 1;
      if (std::abs(level[i]) > (3 << (suffix_len - 1)) && suffix_len < 6) ++suffix_len;
    }
    int zeros = 0;
    if (tc < max) {
      if (max == 4) zeros = VLC_TZC[tc - 1].read(b, "total_zeros");
      else zeros = VLC_TZ[tc - 1].read(b, "total_zeros");
    }
    if (tc + zeros > max) corrupt("total_zeros %d past a block of %d", zeros, max);
    int run[16];
    for (int i = 0; i < tc - 1; ++i) {
      if (zeros > 0) {
        run[i] = VLC_RB[std::min(zeros, 7) - 1].read(b, "run_before");
        if (run[i] > zeros) corrupt("run_before past total_zeros");
      } else {
        run[i] = 0;
      }
      zeros -= run[i];
    }
    run[tc - 1] = zeros;
    int at = -1;
    for (int i = tc - 1; i >= 0; --i) {
      at += run[i] + 1;
      out[at] = level[i];
    }
    return tc;
  }

  void parse_residual(Bits& b, int cbp, bool i16, bool t8) {
    int cbp_l = cbp & 15, cbp_c = cbp >> 4;
    if (i16) residual_block(b, nc_luma(0), 16, dcl);
    for (int b8 = 0; b8 < 4; ++b8) {
      for (int k = 0; k < 4; ++k) {
        int blk = b8 * 4 + k, at = blk4(blk);
        if (!((cbp_l >> b8) & 1)) {
          nz[at] = 0;
          std::memset(levels[blk], 0, sizeof levels[blk]);
          continue;
        }
        int nc = nc_luma(blk);
        if (i16) {
          int ac[15];
          nz[at] = static_cast<uint8_t>(residual_block(b, nc, 15, ac));
          levels[blk][0] = 0;
          for (int i = 0; i < 15; ++i) levels[blk][i + 1] = ac[i];
        } else {
          nz[at] = static_cast<uint8_t>(residual_block(b, nc, 16, levels[blk]));
          if (t8)
            for (int i = 0; i < 16; ++i) levels8[b8][4 * i + k] = levels[blk][i];
        }
      }
    }
    for (int c = 0; c < 2; ++c) {
      if (cbp_c) residual_block(b, -1, 4, cdc[c]);
      else std::memset(cdc[c], 0, sizeof cdc[c]);
    }
    int s2 = mbw * 2;
    for (int c = 0; c < 2; ++c)
      for (int k = 0; k < 4; ++k) {
        int at = (mby * 2 + (k >> 1)) * s2 + mbx * 2 + (k & 1);
        if (cbp_c & 2) {
          int ac[15];
          nzc[c][at] = static_cast<uint8_t>(residual_block(b, nc_chroma(c, k), 15, ac));
          cac[c][k][0] = 0;
          for (int i = 0; i < 15; ++i) cac[c][k][i + 1] = ac[i];
        } else {
          nzc[c][at] = 0;
          std::memset(cac[c][k], 0, sizeof cac[c][k]);
        }
      }
  }

  // ------------------------------------------------ transforms (8.5)
  static void idct4_add(int* d, uint8_t* dst, int stride) {
    int t[16];
    for (int i = 0; i < 4; ++i) {   // rows
      const int* r = d + 4 * i;
      int e = r[0] + r[2], f = r[0] - r[2], g = (r[1] >> 1) - r[3], h = r[1] + (r[3] >> 1);
      t[4 * i] = e + h;
      t[4 * i + 1] = f + g;
      t[4 * i + 2] = f - g;
      t[4 * i + 3] = e - h;
    }
    for (int j = 0; j < 4; ++j) {   // columns
      int e = t[j] + t[8 + j], f = t[j] - t[8 + j];
      int g = (t[4 + j] >> 1) - t[12 + j], h = t[4 + j] + (t[12 + j] >> 1);
      int r[4] = {e + h, f + g, f - g, e - h};
      for (int i = 0; i < 4; ++i)
        dst[i * stride + j] = clip1(dst[i * stride + j] + ((r[i] + 32) >> 6));
    }
  }

  static void idct8_1d(const int* in, int step, int* out, int ostep) {
    int d[8];
    for (int i = 0; i < 8; ++i) d[i] = in[i * step];
    int e0 = d[0] + d[4], e1 = -d[3] + d[5] - d[7] - (d[7] >> 1);
    int e2 = d[0] - d[4], e3 = d[1] + d[7] - d[3] - (d[3] >> 1);
    int e4 = (d[2] >> 1) - d[6], e5 = -d[1] + d[7] + d[5] + (d[5] >> 1);
    int e6 = d[2] + (d[6] >> 1), e7 = d[3] + d[5] + d[1] + (d[1] >> 1);
    int f0 = e0 + e6, f1 = e1 + (e7 >> 2), f2 = e2 + e4, f3 = e3 + (e5 >> 2);
    int f4 = e2 - e4, f5 = (e3 >> 2) - e5, f6 = e0 - e6, f7 = e7 - (e1 >> 2);
    int g[8] = {f0 + f7, f2 + f5, f4 + f3, f6 + f1, f6 - f1, f4 - f3, f2 - f5, f0 - f7};
    for (int i = 0; i < 8; ++i) out[i * ostep] = g[i];
  }

  static void idct8_add(int* d, uint8_t* dst, int stride) {
    int t[64], u[64];
    for (int i = 0; i < 8; ++i) idct8_1d(d + 8 * i, 1, t + 8 * i, 1);   // rows
    for (int j = 0; j < 8; ++j) idct8_1d(t + j, 8, u + j, 8);           // columns
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 8; ++j)
        dst[i * stride + j] = clip1(dst[i * stride + j] + ((u[8 * i + j] + 32) >> 6));
  }

  // LevelScale4x4 of list `li` at raster position pos, qp % 6 = m
  int ls4(int li, int m, int pos) const {
    int r = pos >> 2, c = pos & 3;
    return pp->sl4[li][pos] * NORM4[m][(r & 1) + (c & 1)];
  }
  int ls8(int li, int m, int pos) const {
    int r = pos >> 3, c = pos & 7;
    return pp->sl8[li][pos] * NORM8[m][NORM8_POS[(r & 3) * 4 + (c & 3)]];
  }

  // dequantise a 4x4 block's AC (scan index from `from`) into raster d
  void dequant4(const int* lv, int from, int li, int q, int* d) const {
    int m = q % 6, s = q / 6;
    for (int k = from; k < 16; ++k) {
      int pos = ZZ4[k], c = lv[k];
      if (!c) {
        d[pos] = 0;
        continue;
      }
      int v = c * ls4(li, m, pos);
      d[pos] = q >= 24 ? v << (s - 4) : (v + (1 << (3 - s))) >> (4 - s);
    }
  }

  // ------------------------------------------------ intra prediction
  // Directional / DC prediction of an N x N block (8.3.1.2, 8.3.2.2):
  // T[-1..2N-1] the row above (T[-1] the corner), L[-1..N-1] the column
  // to the left (L[-1] the corner)
  static void pred_nxn(int n, int mode, const int* T, const int* L, bool has_t, bool has_l,
                       uint8_t* dst, int stride) {
    auto P = [&](int x, int y) -> int {   // p[x, y] with y == -1 or x == -1
      return y < 0 ? T[x] : L[y];
    };
    for (int y = 0; y < n; ++y)
      for (int x = 0; x < n; ++x) {
        int v = 0;
        switch (mode) {
          case 0: v = T[x]; break;
          case 1: v = L[y]; break;
          case 2: {
            int sum = 0, sh = n == 4 ? 2 : 3;
            if (has_t && has_l) {
              for (int i = 0; i < n; ++i) sum += T[i] + L[i];
              v = (sum + n) >> (sh + 1);
            } else if (has_l) {
              for (int i = 0; i < n; ++i) sum += L[i];
              v = (sum + n / 2) >> sh;
            } else if (has_t) {
              for (int i = 0; i < n; ++i) sum += T[i];
              v = (sum + n / 2) >> sh;
            } else {
              v = 128;
            }
            break;
          }
          case 3:
            if (x == n - 1 && y == n - 1) v = (T[2 * n - 2] + 3 * T[2 * n - 1] + 2) >> 2;
            else v = (T[x + y] + 2 * T[x + y + 1] + T[x + y + 2] + 2) >> 2;
            break;
          case 4:
            if (x > y) v = (P(x - y - 2, -1) + 2 * P(x - y - 1, -1) + P(x - y, -1) + 2) >> 2;
            else if (x < y) v = (P(-1, y - x - 2) + 2 * P(-1, y - x - 1) + P(-1, y - x) + 2) >> 2;
            else v = (T[0] + 2 * T[-1] + L[0] + 2) >> 2;
            break;
          case 5: {
            int z = 2 * x - y;
            if (z >= 0 && !(z & 1)) v = (P(x - (y >> 1) - 1, -1) + P(x - (y >> 1), -1) + 1) >> 1;
            else if (z >= 0)
              v = (P(x - (y >> 1) - 2, -1) + 2 * P(x - (y >> 1) - 1, -1) + P(x - (y >> 1), -1) + 2)
                  >> 2;
            else if (z == -1) v = (L[0] + 2 * T[-1] + T[0] + 2) >> 2;
            else
              v = (P(-1, y - 2 * x - 1) + 2 * P(-1, y - 2 * x - 2) + P(-1, y - 2 * x - 3) + 2) >> 2;
            break;
          }
          case 6: {
            int z = 2 * y - x;
            if (z >= 0 && !(z & 1)) v = (P(-1, y - (x >> 1) - 1) + P(-1, y - (x >> 1)) + 1) >> 1;
            else if (z >= 0)
              v = (P(-1, y - (x >> 1) - 2) + 2 * P(-1, y - (x >> 1) - 1) + P(-1, y - (x >> 1)) + 2)
                  >> 2;
            else if (z == -1) v = (L[0] + 2 * T[-1] + T[0] + 2) >> 2;
            else
              v = (P(x - 2 * y - 1, -1) + 2 * P(x - 2 * y - 2, -1) + P(x - 2 * y - 3, -1) + 2) >> 2;
            break;
          }
          case 7:
            if (!(y & 1)) v = (T[x + (y >> 1)] + T[x + (y >> 1) + 1] + 1) >> 1;
            else v = (T[x + (y >> 1)] + 2 * T[x + (y >> 1) + 1] + T[x + (y >> 1) + 2] + 2) >> 2;
            break;
          case 8: {
            int z = x + 2 * y;
            if (z > 2 * n - 3) v = L[n - 1];
            else if (z == 2 * n - 3) v = (L[n - 2] + 3 * L[n - 1] + 2) >> 2;
            else if (!(z & 1)) v = (L[y + (x >> 1)] + L[y + (x >> 1) + 1] + 1) >> 1;
            else v = (L[y + (x >> 1)] + 2 * L[y + (x >> 1) + 1] + L[y + (x >> 1) + 2] + 2) >> 2;
            break;
          }
        }
        dst[y * stride + x] = static_cast<uint8_t>(v);
      }
  }

  // availability of the samples at (x, y) relative to the macroblock for
  // intra prediction of block `limit`
  bool intra_avail(int x, int y, int limit) const {
    int m = -1;
    if (nb4(x, y, limit, &m) < 0) return false;
    return !pp->constrained_intra || mb[m].intra();
  }

  void intra_nxn(int n, int blk, int mode) {
    int x0 = BLK_X[blk] * 4, y0 = BLK_Y[blk] * 4;
    int stride = W;
    uint8_t* dst = cur->y.data() + size_t(mby * 16 + y0) * W + mbx * 16 + x0;
    bool ha = intra_avail(x0 - 1, y0, blk), hb = intra_avail(x0, y0 - 1, blk);
    bool hc = intra_avail(x0 + n, y0 - 1, blk), hd = intra_avail(x0 - 1, y0 - 1, blk);
    int tb[17], lb[9];
    int* T = tb + 1;
    int* L = lb + 1;
    for (int i = 0; i < 2 * n + 1; ++i) tb[i] = 0;
    for (int i = 0; i < n + 1; ++i) lb[i] = 0;
    if (hb) {
      for (int i = 0; i < n; ++i) T[i] = dst[-stride + i];
      for (int i = n; i < 2 * n; ++i) T[i] = hc ? dst[-stride + i] : T[n - 1];
    }
    if (ha)
      for (int i = 0; i < n; ++i) L[i] = dst[i * stride - 1];
    if (hd) T[-1] = L[-1] = dst[-stride - 1];
    static const bool need_t[9] = {1, 0, 0, 1, 1, 1, 1, 1, 0};
    static const bool need_l[9] = {0, 1, 0, 0, 1, 1, 1, 0, 1};
    static const bool need_d[9] = {0, 0, 0, 0, 1, 1, 1, 0, 0};
    if ((need_t[mode] && !hb) || (need_l[mode] && !ha) || (need_d[mode] && !hd))
      corrupt("Intra%dx%d mode %d without its neighbouring samples", n, n, mode);
    if (n == 8) {   // reference sample filtering (8.3.2.2.1)
      int t2[17], l2[9];
      int* T2 = t2 + 1;
      int* L2 = l2 + 1;
      std::memcpy(t2, tb, sizeof tb);
      std::memcpy(l2, lb, sizeof lb);
      if (hb) {
        T2[0] = hd ? (T[-1] + 2 * T[0] + T[1] + 2) >> 2 : (3 * T[0] + T[1] + 2) >> 2;
        for (int x = 1; x < 15; ++x) T2[x] = (T[x - 1] + 2 * T[x] + T[x + 1] + 2) >> 2;
        T2[15] = (T[14] + 3 * T[15] + 2) >> 2;
      }
      if (hd) {
        int c;
        if (!hb || !ha) {
          if (hb) c = (3 * T[-1] + T[0] + 2) >> 2;
          else if (ha) c = (3 * T[-1] + L[0] + 2) >> 2;
          else c = T[-1];
        } else {
          c = (T[0] + 2 * T[-1] + L[0] + 2) >> 2;
        }
        T2[-1] = L2[-1] = c;
      }
      if (ha) {
        L2[0] = hd ? (L[-1] + 2 * L[0] + L[1] + 2) >> 2 : (3 * L[0] + L[1] + 2) >> 2;
        for (int y = 1; y < 7; ++y) L2[y] = (L[y - 1] + 2 * L[y] + L[y + 1] + 2) >> 2;
        L2[7] = (L[6] + 3 * L[7] + 2) >> 2;
      }
      pred_nxn(8, mode, T2, L2, hb, ha, dst, stride);
    } else {
      pred_nxn(4, mode, T, L, hb, ha, dst, stride);
    }
  }

  // predIntraNxNPredMode (8.3.1.1, 8.3.2.1) of block blk (4x4 index)
  int pred_intra_mode(int blk) {
    int x = BLK_X[blk] * 4, y = BLK_Y[blk] * 4;
    int ma = -1, mb_ = -1;
    int a = nb4(x - 1, y, 16, &ma), c = nb4(x, y - 1, 16, &mb_);
    if (a < 0 || c < 0) return 2;
    if (pp->constrained_intra && (!mb[ma].intra() || !mb[mb_].intra())) return 2;
    int pa = ipred[a] >= 0 ? ipred[a] : 2, pb = ipred[c] >= 0 ? ipred[c] : 2;
    return std::min(pa, pb);
  }

  void intra16(int mode) {
    uint8_t* dst = cur->y.data() + size_t(mby * 16) * W + mbx * 16;
    bool ha = mb_intra_avail(-1, 0), hb = mb_intra_avail(0, -1), hd = mb_intra_avail(-1, -1);
    if ((mode == 0 && !hb) || (mode == 1 && !ha) || (mode == 3 && !(ha && hb && hd)))
      corrupt("Intra16x16 mode %d without its neighbouring samples", mode);
    static const int as_chroma[4] = {2, 1, 0, 3};   // the chroma modes' numbering
    pred_plane_block(dst, W, 16, 16, as_chroma[mode], ha, hb, false);
  }

  // 16x16 luma or 8x8 chroma prediction; cmode in the chroma numbering:
  // 0 DC, 1 horizontal, 2 vertical, 3 plane; chroma: the DC per 4x4
  void pred_plane_block(uint8_t* dst, int stride, int w, int h, int cmode, bool ha, bool hb,
                        bool chroma) {
    const uint8_t* top = dst - stride;
    if (cmode == 2) {
      for (int y = 0; y < h; ++y) std::memcpy(dst + y * stride, top, w);
    } else if (cmode == 1) {
      for (int y = 0; y < h; ++y) std::memset(dst + y * stride, dst[y * stride - 1], w);
    } else if (cmode == 3) {
      int xcf = w == 16 ? 4 : 0, ycf = h == 16 ? 4 : 0;
      int hh = 0, vv = 0;
      for (int i = 0; i <= 3 + xcf; ++i)
        hh += (i + 1) * (top[4 + xcf + i] - (2 + xcf - i >= 0 ? top[2 + xcf - i] : top[-1]));
      for (int i = 0; i <= 3 + ycf; ++i)
        vv += (i + 1) * (dst[(4 + ycf + i) * stride - 1] -
                         (2 + ycf - i >= 0 ? dst[(2 + ycf - i) * stride - 1] : top[-1]));
      int a = 16 * (dst[(h - 1) * stride - 1] + top[w - 1]);
      int b, c;
      if (w == 16) {
        b = (5 * hh + 32) >> 6;
        c = (5 * vv + 32) >> 6;
      } else {
        b = (34 * hh + 32) >> 6;
        c = (34 * vv + 32) >> 6;
      }
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
          dst[y * stride + x] = clip1((a + b * (x - 3 - xcf) + c * (y - 3 - ycf) + 16) >> 5);
    } else if (!chroma) {
      int sum = 0, v;
      if (ha && hb) {
        for (int i = 0; i < 16; ++i) sum += top[i] + dst[i * stride - 1];
        v = (sum + 16) >> 5;
      } else if (ha) {
        for (int i = 0; i < 16; ++i) sum += dst[i * stride - 1];
        v = (sum + 8) >> 4;
      } else if (hb) {
        for (int i = 0; i < 16; ++i) sum += top[i];
        v = (sum + 8) >> 4;
      } else {
        v = 128;
      }
      for (int y = 0; y < 16; ++y) std::memset(dst + y * stride, v, 16);
    } else {   // chroma DC per 4x4 block (8.3.4.1-3)
      for (int by = 0; by < 2; ++by)
        for (int bx = 0; bx < 2; ++bx) {
          int st = 0, sl = 0, v;
          uint8_t* d = dst + by * 4 * stride + bx * 4;
          if (hb)
            for (int i = 0; i < 4; ++i) st += d[-stride + i - by * 4 * stride];
          if (ha)
            for (int i = 0; i < 4; ++i) sl += d[i * stride - 1 - bx * 4];
          if ((bx == 0 && by == 0) || (bx && by)) {
            v = ha && hb ? (st + sl + 4) >> 3 : ha ? (sl + 2) >> 2 : hb ? (st + 2) >> 2 : 128;
          } else if (bx) {
            v = hb ? (st + 2) >> 2 : ha ? (sl + 2) >> 2 : 128;
          } else {
            v = ha ? (sl + 2) >> 2 : hb ? (st + 2) >> 2 : 128;
          }
          for (int y = 0; y < 4; ++y) std::memset(d + y * stride, v, 4);
        }
    }
  }

  void intra_chroma(int mode) {
    bool ha = mb_intra_avail(-1, 0), hb = mb_intra_avail(0, -1), hd = mb_intra_avail(-1, -1);
    if ((mode == 1 && !ha) || (mode == 2 && !hb) || (mode == 3 && !(ha && hb && hd)))
      corrupt("intra chroma mode %d without its neighbouring samples", mode);
    int cw = W / 2;
    for (int c = 0; c < 2; ++c) {
      uint8_t* plane = c ? cur->cr.data() : cur->cb.data();
      pred_plane_block(plane + size_t(mby * 8) * cw + mbx * 8, cw, 8, 8, mode, ha, hb, true);
    }
  }

  // --------------------------------------------- residual reconstruct
  void add_luma_residual(bool intra, bool t8, bool i16, int blk_only = -1) {
    int li = intra ? 0 : 3, q = qp;
    uint8_t* base = cur->y.data() + size_t(mby * 16) * W + mbx * 16;
    if (t8) {
      for (int b8 = 0; b8 < 4; ++b8) {
        if (blk_only >= 0 && b8 != blk_only) continue;
        bool any = false;
        for (int k = 0; k < 4; ++k) any |= nz[blk4(b8 * 4 + k)] != 0;
        if (!any) continue;
        int d[64];
        int m = q % 6, s = q / 6;
        for (int k = 0; k < 64; ++k) {
          int pos = ZZ8[k], c = levels8[b8][k];
          if (!c) {
            d[pos] = 0;
            continue;
          }
          int v = c * ls8(intra ? 0 : 1, m, pos);
          d[pos] = q >= 36 ? v << (s - 6) : (v + (1 << (5 - s))) >> (6 - s);
        }
        idct8_add(d, base + (b8 >> 1) * 8 * W + (b8 & 1) * 8, W);
      }
      return;
    }
    int dc[16];
    if (i16) {   // 8.5.10: the luma DC
      int c[16], f[16], t[16];
      for (int k = 0; k < 16; ++k) c[ZZ4[k]] = dcl[k];
      for (int i = 0; i < 4; ++i) {
        const int* r = c + 4 * i;
        t[4 * i] = r[0] + r[1] + r[2] + r[3];
        t[4 * i + 1] = r[0] + r[1] - r[2] - r[3];
        t[4 * i + 2] = r[0] - r[1] - r[2] + r[3];
        t[4 * i + 3] = r[0] - r[1] + r[2] - r[3];
      }
      for (int j = 0; j < 4; ++j) {
        f[j] = t[j] + t[4 + j] + t[8 + j] + t[12 + j];
        f[4 + j] = t[j] + t[4 + j] - t[8 + j] - t[12 + j];
        f[8 + j] = t[j] - t[4 + j] - t[8 + j] + t[12 + j];
        f[12 + j] = t[j] - t[4 + j] + t[8 + j] - t[12 + j];
      }
      int ls = ls4(0, q % 6, 0), s = q / 6;
      for (int k = 0; k < 16; ++k)
        dc[k] = q >= 36 ? (f[k] * ls) << (s - 6) : (f[k] * ls + (1 << (5 - s))) >> (6 - s);
    }
    for (int blk = 0; blk < 16; ++blk) {
      if (blk_only >= 0 && blk != blk_only) continue;
      int bx = BLK_X[blk], by = BLK_Y[blk];
      int d[16];
      bool any = nz[blk4(blk)] != 0;
      if (i16) {
        any |= dc[by * 4 + bx] != 0;
        if (!any) continue;
        dequant4(levels[blk], 1, li, q, d);
        d[0] = dc[by * 4 + bx];
      } else {
        if (!any) continue;
        dequant4(levels[blk], 0, li, q, d);
      }
      idct4_add(d, base + by * 4 * W + bx * 4, W);
    }
  }

  void add_chroma_residual(bool intra) {
    int cw = W / 2;
    for (int c = 0; c < 2; ++c) {
      int q = chroma_qp(qp, pp->chroma_qp_offset[c]);
      int li = (intra ? 0 : 3) + 1 + c;
      // 8.5.11: the 2x2 chroma DC
      int* v = cdc[c];
      int f[4] = {v[0] + v[1] + v[2] + v[3], v[0] - v[1] + v[2] - v[3],
                  v[0] + v[1] - v[2] - v[3], v[0] - v[1] - v[2] + v[3]};
      int ls = ls4(li, q % 6, 0);
      int dc[4];
      for (int k = 0; k < 4; ++k) dc[k] = ((f[k] * ls) << (q / 6)) >> 5;
      uint8_t* base = (c ? cur->cr.data() : cur->cb.data()) + size_t(mby * 8) * cw + mbx * 8;
      int s2 = mbw * 2;
      for (int k = 0; k < 4; ++k) {
        int at = (mby * 2 + (k >> 1)) * s2 + mbx * 2 + (k & 1);
        if (!dc[k] && !nzc[c][at]) continue;
        int d[16];
        dequant4(cac[c][k], 1, li, q, d);
        d[0] = dc[k];
        idct4_add(d, base + (k >> 1) * 4 * cw + (k & 1) * 4, cw);
      }
    }
  }

  // -------------------------------------------- inter prediction (8.4)
  struct Nb {
    bool avail;
    int ref;
    int mvx, mvy;
  };

  Nb nb_motion(int x, int y, int limit) const {
    int m = -1;
    int at = nb4(x, y, limit, &m);
    if (at < 0) return {false, -1, 0, 0};
    if (refi[at] < 0) return {true, -1, 0, 0};
    return {true, refi[at], mv[2 * at], mv[2 * at + 1]};
  }

  static int median(int a, int b, int c) {
    return std::max(std::min(a, b), std::min(std::max(a, b), c));
  }

  // mvpLX (8.4.1.3) of the partition at (x, y), w x h; shape 1: 16x8,
  // 2: 8x16, 0 other
  void mvp(int x, int y, int w, int ref, int shape, int part, int& px, int& py) const {
    int limit = BLK_AT[y >> 2][x >> 2];
    Nb a = nb_motion(x - 1, y, limit), b = nb_motion(x, y - 1, limit);
    Nb c = nb_motion(x + w, y - 1, limit);
    if (!c.avail) c = nb_motion(x - 1, y - 1, limit);
    if (shape == 1) {
      if (part == 0 && b.ref == ref) { px = b.mvx; py = b.mvy; return; }
      if (part == 1 && a.ref == ref) { px = a.mvx; py = a.mvy; return; }
    } else if (shape == 2) {
      if (part == 0 && a.ref == ref) { px = a.mvx; py = a.mvy; return; }
      if (part == 1 && c.ref == ref) { px = c.mvx; py = c.mvy; return; }
    }
    if (!b.avail && !c.avail && a.avail) {
      b = a;
      c = a;
    }
    int hits = (a.ref == ref) + (b.ref == ref) + (c.ref == ref);
    if (hits == 1) {
      const Nb& n = a.ref == ref ? a : b.ref == ref ? b : c;
      px = n.mvx;
      py = n.mvy;
      return;
    }
    px = median(a.mvx, b.mvx, c.mvx);
    py = median(a.mvy, b.mvy, c.mvy);
  }

  void set_motion(int x, int y, int w, int h, int ref, int mx, int my) {
    int rp = sl->list[ref] ? sl->list[ref]->serial : -1;
    for (int j = y >> 2; j < (y + h) >> 2; ++j)
      for (int i = x >> 2; i < (x + w) >> 2; ++i) {
        int at = (mby * 4 + j) * s4 + mbx * 4 + i;
        refi[at] = static_cast<int8_t>(ref);
        refpic[at] = rp;
        mv[2 * at] = static_cast<int16_t>(mx);
        mv[2 * at + 1] = static_cast<int16_t>(my);
      }
  }

  static void fetch(const uint8_t* plane, int pw, int ph, int x, int y, int w, int h,
                    uint8_t* out) {
    if (x >= 0 && y >= 0 && x + w <= pw && y + h <= ph) {
      for (int j = 0; j < h; ++j) std::memcpy(out + j * w, plane + size_t(y + j) * pw + x, w);
      return;
    }
    for (int j = 0; j < h; ++j) {
      const uint8_t* row = plane + size_t(clip3(0, ph - 1, y + j)) * pw;
      for (int i = 0; i < w; ++i) out[j * w + i] = row[clip3(0, pw - 1, x + i)];
    }
  }

  // 8.4.2.2.1: luma sample interpolation into pred (w x h)
  void luma_mc(const Picture* ref, int x, int y, int w, int h, int mx, int my, uint8_t* pred) {
    int xi = x + (mx >> 2), yi = y + (my >> 2), xf = mx & 3, yf = my & 3;
    const int bw = w + 5;
    uint8_t win[21 * 21];
    fetch(ref->y.data(), W, H, xi - 2, yi - 2, bw, h + 5, win);
    auto G = [&](int i, int j) -> int { return win[(j + 2) * bw + i + 2]; };
    if (!xf && !yf) {
      for (int j = 0; j < h; ++j)
        for (int i = 0; i < w; ++i) pred[j * 16 + i] = static_cast<uint8_t>(G(i, j));
      return;
    }
    auto tap = [](int e, int f, int g, int hh, int ii, int jj) {
      return e - 5 * f + 20 * g + 20 * hh - 5 * ii + jj;
    };
    // b1 at rows -2..h+2 (half-pel right of (i, j)); h1 at columns 0..w
    int b1[21][16], h1[16][17];
    for (int j = -2; j < h + 3; ++j)
      for (int i = 0; i < w; ++i)
        b1[j + 2][i] =
            tap(G(i - 2, j), G(i - 1, j), G(i, j), G(i + 1, j), G(i + 2, j), G(i + 3, j));
    for (int j = 0; j < h; ++j)
      for (int i = 0; i < w + 1; ++i)
        h1[j][i] = tap(G(i, j - 2), G(i, j - 1), G(i, j), G(i, j + 1), G(i, j + 2), G(i, j + 3));
    auto B = [&](int i, int j) { return static_cast<int>(clip1((b1[j + 2][i] + 16) >> 5)); };
    auto Hh = [&](int i, int j) { return static_cast<int>(clip1((h1[j][i] + 16) >> 5)); };
    auto J = [&](int i, int j) {
      int v = tap(b1[j][i], b1[j + 1][i], b1[j + 2][i], b1[j + 3][i], b1[j + 4][i], b1[j + 5][i]);
      return static_cast<int>(clip1((v + 512) >> 10));
    };
    for (int j = 0; j < h; ++j)
      for (int i = 0; i < w; ++i) {
        int v;
        switch (yf * 4 + xf) {
          case 1: v = (G(i, j) + B(i, j) + 1) >> 1; break;                 // a
          case 2: v = B(i, j); break;                                       // b
          case 3: v = (G(i + 1, j) + B(i, j) + 1) >> 1; break;             // c
          case 4: v = (G(i, j) + Hh(i, j) + 1) >> 1; break;                // d
          case 5: v = (B(i, j) + Hh(i, j) + 1) >> 1; break;                // e
          case 6: v = (B(i, j) + J(i, j) + 1) >> 1; break;                 // f
          case 7: v = (B(i, j) + Hh(i + 1, j) + 1) >> 1; break;            // g
          case 8: v = Hh(i, j); break;                                      // h
          case 9: v = (Hh(i, j) + J(i, j) + 1) >> 1; break;                // i
          case 10: v = J(i, j); break;                                      // j
          case 11: v = (J(i, j) + Hh(i + 1, j) + 1) >> 1; break;           // k
          case 12: v = (G(i, j + 1) + Hh(i, j) + 1) >> 1; break;           // n
          case 13: v = (Hh(i, j) + B(i, j + 1) + 1) >> 1; break;           // p
          case 14: v = (J(i, j) + B(i, j + 1) + 1) >> 1; break;            // q
          default: v = (Hh(i + 1, j) + B(i, j + 1) + 1) >> 1; break;       // r
        }
        pred[j * 16 + i] = static_cast<uint8_t>(v);
      }
  }

  // 8.4.2.2.2: chroma sample interpolation (4:2:0), w x h chroma samples
  void chroma_mc(const uint8_t* plane, int x, int y, int w, int h, int mx, int my, uint8_t* pred) {
    int xi = x + (mx >> 3), yi = y + (my >> 3), xf = mx & 7, yf = my & 7;
    uint8_t win[9 * 9];
    fetch(plane, W / 2, H / 2, xi, yi, w + 1, h + 1, win);
    int bw = w + 1;
    for (int j = 0; j < h; ++j)
      for (int i = 0; i < w; ++i) {
        int a = win[j * bw + i], b = win[j * bw + i + 1];
        int c = win[(j + 1) * bw + i], d = win[(j + 1) * bw + i + 1];
        pred[j * 8 + i] = static_cast<uint8_t>(
            ((8 - xf) * (8 - yf) * a + xf * (8 - yf) * b + (8 - xf) * yf * c + xf * yf * d + 32)
            >> 6);
      }
  }

  static void weigh(uint8_t* p, int stride, int w, int h, int log2, Weight wt) {
    for (int j = 0; j < h; ++j)
      for (int i = 0; i < w; ++i) {
        int v = p[j * stride + i];
        v = log2 >= 1 ? ((v * wt.w + (1 << (log2 - 1))) >> log2) + wt.o : v * wt.w + wt.o;
        p[j * stride + i] = clip1(v);
      }
  }

  void inter_pred(int x, int y, int w, int h, int ref, int mx, int my) {
    const Picture* r = sl->list[ref];
    if (!r) corrupt("reference index %d of a missing picture", ref);
    uint8_t p[16 * 16], pc[8 * 8];
    luma_mc(r, mbx * 16 + x, mby * 16 + y, w, h, mx, my, p);
    if (sl->weighted) weigh(p, 16, w, h, sl->luma_log2, sl->lw[ref]);
    uint8_t* dst = cur->y.data() + size_t(mby * 16 + y) * W + mbx * 16 + x;
    for (int j = 0; j < h; ++j) std::memcpy(dst + j * W, p + j * 16, w);
    int cw = W / 2;
    for (int c = 0; c < 2; ++c) {
      const uint8_t* plane = c ? r->cr.data() : r->cb.data();
      chroma_mc(plane, mbx * 8 + x / 2, mby * 8 + y / 2, w / 2, h / 2, mx, my, pc);
      if (sl->weighted) weigh(pc, 8, w / 2, h / 2, sl->chroma_log2, sl->cw[ref][c]);
      uint8_t* d = (c ? cur->cr.data() : cur->cb.data()) + size_t(mby * 8 + y / 2) * cw +
                   mbx * 8 + x / 2;
      for (int j = 0; j < h / 2; ++j) std::memcpy(d + j * cw, pc + j * 8, w / 2);
    }
  }

  int read_ref(Bits& b) {
    int n = sl->num_ref;
    if (n <= 1) return 0;
    if (n == 2) return !b.u(1);
    uint32_t v = b.ue();
    if (static_cast<int>(v) >= n) corrupt("ref_idx_l0 %u of %d", v, n);
    return static_cast<int>(v);
  }

  static int16_t mv16(int v) {
    if (v < -32768 || v > 32767) corrupt("motion vector %d out of range", v);
    return static_cast<int16_t>(v);
  }

  // ------------------------------------------------------ macroblocks
  void finish_mb(MbKind kind, bool t8, int qp_db) {
    MbInfo& m = mb[cur_mb];
    m.kind = kind;
    m.t8 = t8;
    m.qp = static_cast<int8_t>(qp_db);
    m.qpc[0] = static_cast<int8_t>(chroma_qp(qp_db, pp->chroma_qp_offset[0]));
    m.qpc[1] = static_cast<int8_t>(chroma_qp(qp_db, pp->chroma_qp_offset[1]));
  }

  void begin_mb(int addr) {
    ++mbs_decoded;
    cur_mb = addr;
    mbx = addr % mbw;
    mby = addr / mbw;
    mb[addr].slice = slice_num;
  }

  void mb_skip(int addr) {
    begin_mb(addr);
    mb[addr].kind = MB_SKIP;
    int mx = 0, my = 0;
    Nb a = nb_motion(-1, 0, 0), b = nb_motion(0, -1, 0);
    bool zero = !a.avail || !b.avail || (a.ref == 0 && !a.mvx && !a.mvy) ||
                (b.ref == 0 && !b.mvx && !b.mvy);
    if (!zero) mvp(0, 0, 16, 0, 0, 0, mx, my);
    set_motion(0, 0, 16, 16, 0, mv16(mx), mv16(my));
    inter_pred(0, 0, 16, 16, 0, mx, my);
    for (int k = 0; k < 16; ++k) {
      int at = blk4(k);
      nz[at] = 0;
      nzdb[at] = 0;
      ipred[at] = -1;
    }
    int s2 = mbw * 2;
    for (int c = 0; c < 2; ++c)
      for (int k = 0; k < 4; ++k) nzc[c][(mby * 2 + (k >> 1)) * s2 + mbx * 2 + (k & 1)] = 0;
    finish_mb(MB_SKIP, false, qp);
  }

  void read_qp_delta(Bits& b) {
    int d = b.se();
    if (d < -26 || d > 25) corrupt("mb_qp_delta %d", d);
    qp = (qp + d + 52) % 52;
  }

  void mb_layer(Bits& b, int addr) {
    begin_mb(addr);
    uint32_t t = b.ue();
    if (sl->type == 0) {
      if (t < 5) {
        mb_inter(b, static_cast<int>(t));
        return;
      }
      t -= 5;
    } else if (sl->type == 1) {
      if (t < 23)
        unsupported("H.264 mb_type %u in a B slice (inter prediction in B slices): the host "
                    "decoder reads intra macroblocks of B slices only (" ITEM_B ")", t);
      t -= 23;
    }
    if (t > 25) corrupt("mb_type %u", t);
    if (t == 25) {
      mb_pcm(b);
      return;
    }
    for (int k = 0; k < 16; ++k) {
      int at = blk4(k);
      refi[at] = -1;
      refpic[at] = -1;
      mv[2 * at] = mv[2 * at + 1] = 0;
    }
    mb[cur_mb].kind = t == 0 ? MB_I4 : MB_I16;   // intra for its own neighbours
    if (t == 0) mb_inxn(b);
    else mb_i16(b, static_cast<int>(t) - 1);
  }

  void mb_pcm(Bits& b) {
    b.pos = (b.pos + 7) & ~size_t(7);
    if (b.pos + 384 * 8 > b.nbits) corrupt("I_PCM past the end of its NAL unit");
    const uint8_t* s = b.d + (b.pos >> 3);
    uint8_t* y = cur->y.data() + size_t(mby * 16) * W + mbx * 16;
    for (int j = 0; j < 16; ++j) std::memcpy(y + j * W, s + 16 * j, 16);
    int cw = W / 2;
    for (int c = 0; c < 2; ++c) {
      uint8_t* d = (c ? cur->cr.data() : cur->cb.data()) + size_t(mby * 8) * cw + mbx * 8;
      for (int j = 0; j < 8; ++j) std::memcpy(d + j * cw, s + 256 + 64 * c + 8 * j, 8);
    }
    b.pos += 384 * 8;
    for (int k = 0; k < 16; ++k) {
      int at = blk4(k);
      nz[at] = 16;
      ipred[at] = -1;
      refi[at] = -1;
      refpic[at] = -1;
      mv[2 * at] = mv[2 * at + 1] = 0;
    }
    int s2 = mbw * 2;
    for (int c = 0; c < 2; ++c)
      for (int k = 0; k < 4; ++k) nzc[c][(mby * 2 + (k >> 1)) * s2 + mbx * 2 + (k & 1)] = 16;
    finish_mb(MB_PCM, false, 0);
  }

  uint8_t read_cbp(Bits& b, bool intra) {
    uint32_t v = b.ue();
    if (v > 47) corrupt("coded_block_pattern code %u", v);
    return intra ? CBP_INTRA[v] : CBP_INTER[v];
  }

  void mb_inxn(Bits& b) {
    bool t8 = pp->t8x8 && b.u(1);
    mb[cur_mb].kind = t8 ? MB_I8 : MB_I4;
    int modes[16];
    for (int k = 0; k < (t8 ? 4 : 16); ++k) {
      int blk = t8 ? 4 * k : k;
      int pred = pred_intra_mode(blk);
      int m = pred;
      if (!b.u(1)) {
        int rem = b.u(3);
        m = rem < pred ? rem : rem + 1;
      }
      modes[k] = m;
      if (t8) {
        for (int i = 0; i < 4; ++i) ipred[blk4(blk + i)] = static_cast<int8_t>(m);
      } else {
        ipred[blk4(blk)] = static_cast<int8_t>(m);
      }
    }
    uint32_t cmode = b.ue();
    if (cmode > 3) corrupt("intra_chroma_pred_mode %u", cmode);
    uint8_t cbp = read_cbp(b, true);
    if (cbp) read_qp_delta(b);
    parse_residual(b, cbp, false, t8);
    b.check();
    for (int k = 0; k < (t8 ? 4 : 16); ++k) {
      intra_nxn(t8 ? 8 : 4, t8 ? 4 * k : k, modes[k]);
      add_luma_residual(true, t8, false, k);
    }
    intra_chroma(static_cast<int>(cmode));
    add_chroma_residual(true);
    finish_mb(t8 ? MB_I8 : MB_I4, t8, qp);
  }

  void mb_i16(Bits& b, int v) {
    int mode = v % 4, cbp = ((v / 4) % 3) << 4 | (v >= 12 ? 15 : 0);
    for (int k = 0; k < 16; ++k) ipred[blk4(k)] = -1;
    uint32_t cmode = b.ue();
    if (cmode > 3) corrupt("intra_chroma_pred_mode %u", cmode);
    read_qp_delta(b);
    parse_residual(b, cbp, true, false);
    b.check();
    intra16(mode);
    add_luma_residual(true, false, true);
    intra_chroma(static_cast<int>(cmode));
    add_chroma_residual(true);
    finish_mb(MB_I16, false, qp);
  }

  void mb_inter(Bits& b, int t) {
    for (int k = 0; k < 16; ++k) ipred[blk4(k)] = -1;
    mb[cur_mb].kind = MB_P;
    int sub[4] = {0, 0, 0, 0};
    bool small = false;
    int ref[4] = {0, 0, 0, 0};
    struct Part {
      int x, y, w, h, ref, dx, dy;
    };
    std::vector<Part> parts;
    parts.reserve(16);
    if (t < 3) {
      int n = t == 0 ? 1 : 2;
      for (int i = 0; i < n; ++i) ref[i] = read_ref(b);
      for (int i = 0; i < n; ++i) {
        int dx = b.se(), dy = b.se();
        if (t == 0) parts.push_back({0, 0, 16, 16, ref[0], dx, dy});
        else if (t == 1) parts.push_back({0, 8 * i, 16, 8, ref[i], dx, dy});
        else parts.push_back({8 * i, 0, 8, 16, ref[i], dx, dy});
      }
    } else {
      for (int i = 0; i < 4; ++i) {
        uint32_t s = b.ue();
        if (s > 3) corrupt("sub_mb_type %u", s);
        sub[i] = static_cast<int>(s);
        small |= s != 0;
      }
      if (t == 3)
        for (int i = 0; i < 4; ++i) ref[i] = read_ref(b);
      for (int i = 0; i < 4; ++i) {
        int x0 = (i & 1) * 8, y0 = (i >> 1) * 8;
        int sw = sub[i] == 0 || sub[i] == 1 ? 8 : 4, sh = sub[i] == 0 || sub[i] == 2 ? 8 : 4;
        for (int y = 0; y < 8; y += sh)
          for (int x = 0; x < 8; x += sw) {
            int dx = b.se(), dy = b.se();
            parts.push_back({x0 + x, y0 + y, sw, sh, ref[i], dx, dy});
          }
      }
    }
    for (size_t i = 0; i < parts.size(); ++i) {
      Part& p = parts[i];
      if (!sl->list[p.ref]) corrupt("reference index %d of a missing picture", p.ref);
      int px, py;
      int shape = t == 1 ? 1 : t == 2 ? 2 : 0;
      mvp(p.x, p.y, p.w, p.ref, shape, static_cast<int>(i), px, py);
      int mx = mv16(px + p.dx), my = mv16(py + p.dy);
      set_motion(p.x, p.y, p.w, p.h, p.ref, mx, my);
      inter_pred(p.x, p.y, p.w, p.h, p.ref, mx, my);
    }
    uint8_t cbp = read_cbp(b, false);
    bool t8 = false;
    if ((cbp & 15) && pp->t8x8 && !small) t8 = b.u(1);
    if (cbp) read_qp_delta(b);
    parse_residual(b, cbp, false, t8);
    b.check();
    add_luma_residual(false, t8, false);
    add_chroma_residual(false);
    for (int k = 0; k < 16; ++k) {
      int at = blk4(k);
      if (t8) {
        int b8 = k >> 2, any = 0;
        for (int i = 0; i < 4; ++i) any |= nz[blk4(b8 * 4 + i)];
        nzdb[at] = any != 0;
      } else {
        nzdb[at] = nz[at] != 0;
      }
    }
    finish_mb(MB_P, t8, qp);
  }

  void slice_data(Bits& b, int first_mb) {
    int total = mbw * mbh;
    if (first_mb < next_mb) {
      allowed_in(sp->profile, sp->profile == BASELINE || sp->profile == EXTENDED,
                 "arbitrary slice order");
      unsupported("H.264 first_mb_in_slice %d before macroblock %d (arbitrary slice order): "
                  "the host decoder does not read it (" ITEM_REST ")", first_mb, next_mb);
    }
    if (first_mb >= total) corrupt("first_mb_in_slice %d of %d", first_mb, total);
    int addr = first_mb;
    for (;;) {
      bool more = true;
      if (sl->type != 2) {
        uint32_t run = b.ue();
        if (run > static_cast<uint32_t>(total - addr))
          corrupt("mb_skip_run %u past the picture", run);
        if (run && sl->type == 1)
          unsupported("H.264 mb_skip_run %u in a B slice (B_Skip, inter prediction in B "
                      "slices): the host decoder reads intra macroblocks of B slices only ("
                      ITEM_B ")", run);
        if (run && !sl->list[0]) corrupt("P_Skip with no reference picture");
        for (uint32_t i = 0; i < run; ++i) mb_skip(addr++);
        if (run) more = b.more_rbsp_data();
      }
      if (more) {
        if (addr >= total) corrupt("slice data past the last macroblock");
        mb_layer(b, addr++);
        more = b.more_rbsp_data();
      }
      b.check();
      if (!more) break;
    }
    next_mb = addr;
  }

  // --------------------------------------------------- deblocking (8.7)
  static void filter_line(uint8_t* p, int step, int bs, int alpha, int beta, int index_a,
                          bool chroma) {
    int p0 = p[-step], p1 = p[-2 * step], q0 = p[0], q1 = p[step];
    if (!(std::abs(p0 - q0) < alpha && std::abs(p1 - p0) < beta && std::abs(q1 - q0) < beta))
      return;
    if (bs < 4) {
      int tc0 = TC0[index_a][bs - 1];
      if (chroma) {
        int tc = tc0 + 1;
        int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
        p[-step] = clip1(p0 + delta);
        p[0] = clip1(q0 - delta);
        return;
      }
      int p2 = p[-3 * step], q2 = p[2 * step];
      int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
      int tc = tc0 + (ap < beta) + (aq < beta);
      int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
      p[-step] = clip1(p0 + delta);
      p[0] = clip1(q0 - delta);
      int avg = (p0 + q0 + 1) >> 1;
      if (ap < beta)
        p[-2 * step] = static_cast<uint8_t>(p1 + clip3(-tc0, tc0, (p2 + avg - (p1 << 1)) >> 1));
      if (aq < beta)
        p[step] = static_cast<uint8_t>(q1 + clip3(-tc0, tc0, (q2 + avg - (q1 << 1)) >> 1));
      return;
    }
    if (chroma) {
      p[-step] = static_cast<uint8_t>((2 * p1 + p0 + q1 + 2) >> 2);
      p[0] = static_cast<uint8_t>((2 * q1 + q0 + p1 + 2) >> 2);
      return;
    }
    int p2 = p[-3 * step], q2 = p[2 * step];
    int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
    bool small = std::abs(p0 - q0) < ((alpha >> 2) + 2);
    if (ap < beta && small) {
      int p3 = p[-4 * step];
      p[-step] = static_cast<uint8_t>((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
      p[-2 * step] = static_cast<uint8_t>((p2 + p1 + p0 + q0 + 2) >> 2);
      p[-3 * step] = static_cast<uint8_t>((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
    } else {
      p[-step] = static_cast<uint8_t>((2 * p1 + p0 + q1 + 2) >> 2);
    }
    if (aq < beta && small) {
      int q3 = p[3 * step];
      p[0] = static_cast<uint8_t>((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
      p[step] = static_cast<uint8_t>((p0 + q0 + q1 + q2 + 2) >> 2);
      p[2 * step] = static_cast<uint8_t>((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
    } else {
      p[0] = static_cast<uint8_t>((2 * q1 + q0 + p1 + 2) >> 2);
    }
  }

  // bS (8.7.2.1) between luma 4x4 blocks bp (in macroblock mp) and bq
  int bs_of(int mp, int mq, int bp, int bq, bool mb_edge) const {
    if (mb[mp].intra() || mb[mq].intra()) return mb_edge ? 4 : 3;
    if (nzdb[bp] || nzdb[bq]) return 2;
    if (refpic[bp] != refpic[bq]) return 1;
    if (std::abs(mv[2 * bp] - mv[2 * bq]) >= 4 || std::abs(mv[2 * bp + 1] - mv[2 * bq + 1]) >= 4)
      return 1;
    return 0;
  }

  void filter_edge(int addr, int mp, bool vertical, int e, const int* bs) {
    const Slice& s = slices[mb[addr].slice];
    int x = addr % mbw, y = addr / mbw;
    // luma
    {
      int qpav = (mb[mp].qp + mb[addr].qp + 1) >> 1;
      int ia = clip3(0, 51, qpav + s.alpha_off), ib = clip3(0, 51, qpav + s.beta_off);
      int alpha = ALPHA[ia], beta = BETA[ib];
      uint8_t* base = cur->y.data() + size_t(y * 16) * W + x * 16;
      for (int k = 0; k < 16; ++k) {
        int b = bs[k >> 2];
        if (!b) continue;
        if (vertical) filter_line(base + k * W + e * 4, 1, b, alpha, beta, ia, false);
        else filter_line(base + (e * 4) * W + k, W, b, alpha, beta, ia, false);
      }
    }
    if (e & 1) return;
    int cw = W / 2;
    for (int c = 0; c < 2; ++c) {
      int qpav = (mb[mp].qpc[c] + mb[addr].qpc[c] + 1) >> 1;
      int ia = clip3(0, 51, qpav + s.alpha_off), ib = clip3(0, 51, qpav + s.beta_off);
      int alpha = ALPHA[ia], beta = BETA[ib];
      uint8_t* base = (c ? cur->cr.data() : cur->cb.data()) + size_t(y * 8) * cw + x * 8;
      for (int k = 0; k < 8; ++k) {
        int b = bs[k >> 1];
        if (!b) continue;
        if (vertical) filter_line(base + k * cw + e * 2, 1, b, alpha, beta, ia, true);
        else filter_line(base + (e * 2) * cw + k, cw, b, alpha, beta, ia, true);
      }
    }
  }

  void deblock_picture() {
    for (int addr = 0; addr < mbw * mbh; ++addr) {
      const MbInfo& q = mb[addr];
      const Slice& s = slices[q.slice];
      if (s.idc == 1) continue;
      int x = addr % mbw, y = addr / mbw;
      bool left = x > 0 && (s.idc != 2 || mb[addr - 1].slice == q.slice);
      bool top = y > 0 && (s.idc != 2 || mb[addr - mbw].slice == q.slice);
      for (int dir = 0; dir < 2; ++dir) {
        bool vertical = dir == 0;
        for (int e = 0; e < 4; ++e) {
          if (e == 0 && !(vertical ? left : top)) continue;
          if ((e & 1) && q.t8) continue;
          int mp = e ? addr : vertical ? addr - 1 : addr - mbw;
          int bs[4], any = 0;
          for (int k = 0; k < 4; ++k) {
            int bq, bp;
            if (vertical) {
              bq = (y * 4 + k) * s4 + x * 4 + e;
              bp = e ? bq - 1 : (y * 4 + k) * s4 + x * 4 - 1;
            } else {
              bq = (y * 4 + e) * s4 + x * 4 + k;
              bp = e ? bq - s4 : (y * 4 - 1) * s4 + x * 4 + k;
            }
            bs[k] = bs_of(mp, addr, bp, bq, e == 0);
            any |= bs[k];
          }
          if (any) filter_edge(addr, mp, vertical, e, bs);
        }
      }
    }
  }

  // ----------------------------------------------------- access units
  void decode_nal(const uint8_t* nal, size_t n, std::vector<uint8_t>& rbsp) {
    if (!n) return;
    if (nal[0] & 0x80) corrupt("forbidden_zero_bit set");
    int type = nal[0] & 0x1F, ref_idc = (nal[0] >> 5) & 3;
    if (type != 1 && type != 5 && type != 7 && type != 8) {
      if (type >= 2 && type <= 4) {
        if (sp) allowed_in(sp->profile, sp->profile == EXTENDED, "data partitioning");
        unsupported("H.264 nal_unit_type %d (data partitioning): the host decoder does not "
                    "read it (" ITEM_REST ")", type);
      }
      return;   // SEI, AUD, end of sequence / stream, filler, extensions
    }
    rbsp.clear();
    int zeros = 0;
    for (size_t i = 1; i < n; ++i) {
      uint8_t c = nal[i];
      if (zeros >= 2 && c == 3) {
        zeros = 0;
        continue;
      }
      rbsp.push_back(c);
      zeros = c ? 0 : zeros + 1;
    }
    size_t len = rbsp.size();
    while (len && !rbsp[len - 1]) --len;
    if (!len) corrupt("empty NAL unit of type %d", type);
    Bits b;
    b.nbits = len * 8;
    b.stop = (len - 1) * 8 + 7 - __builtin_ctz(rbsp[len - 1]);
    rbsp.resize(len + 8, 0);
    b.d = rbsp.data();
    if (type == 7) {
      parse_sps(b);
      return;
    }
    if (type == 8) {
      parse_pps(b);
      return;
    }
    if (type == 5 && pic_started && !pic_idr) corrupt("IDR slice in a non-IDR picture");
    Slice s;
    int first_mb = 0;
    slice_header(b, type, ref_idc, s, first_mb);
    slices.push_back(s);
    slice_num = static_cast<int>(slices.size()) - 1;
    sl = &slices.back();
    slice_data(b, first_mb);
  }
};

}  // namespace

extern "C" {

void* bsvd_h264_open() { return new Decoder(); }

void bsvd_h264_close(void* h) { delete static_cast<Decoder*>(h); }

// Decodes the Annex-B access units data[offsets[i], offsets[i + 1]), i <
// n (one picture each, the first an IDR), and writes each picture whose
// display index disp[i] lies in [start, start + count) to
// out[disp[i] - start] as NV12 of the displayed size H x W, cropped from
// (left, top) of the coded picture; got[k] = 1 for each frame written.
// *decoded: pictures decoded. Returns 0, 1 (corrupt data) or 2 (a stream
// of a kind not decoded), the message in err.
int bsvd_h264_decode(void* handle, const uint8_t* data, const int64_t* offsets,
                     const int64_t* disp, int n, int start, int count, uint8_t* out,
                     int h, int w, int left, int top, uint8_t* got, int64_t* decoded,
                     char* err, int errlen) {
  Decoder& d = *static_cast<Decoder*>(handle);
  *decoded = 0;
  std::vector<uint8_t> rbsp;
  try {
    for (auto& p : d.pool) p->short_ref = p->long_ref = false;
    d.prev_ref_frame_num = -1;
    d.max_long_idx = -1;
    d.pic_started = false;
    for (int i = 0; i < n; ++i) {
      const uint8_t* au = data + offsets[i];
      size_t len = static_cast<size_t>(offsets[i + 1] - offsets[i]);
      // NAL units after 3- or 4-byte start codes
      size_t at = 0;
      std::vector<std::pair<size_t, size_t>> nals;
      while (at + 3 <= len) {
        if (au[at] == 0 && au[at + 1] == 0 && au[at + 2] == 1) {
          at += 3;
          size_t s = at;
          while (at + 3 <= len &&
                 !(au[at] == 0 && au[at + 1] == 0 && (au[at + 2] == 1 || au[at + 2] == 0)))
            ++at;
          if (at + 3 > len) at = len;
          size_t e = at;
          while (e > s && au[e - 1] == 0) --e;
          nals.emplace_back(s, e - s);
        } else {
          ++at;
        }
      }
      d.pic_started = false;
      for (auto& nl : nals) d.decode_nal(au + nl.first, nl.second, rbsp);
      if (!d.pic_started) corrupt("access unit %d holds no picture", i);
      d.finish_picture();
      ++*decoded;
      int k = static_cast<int>(disp[i]) - start;
      if (k < 0 || k >= count) continue;
      if (left + w > d.W || top + h > d.H) corrupt("cropped size past the coded picture");
      uint8_t* o = out + size_t(k) * (h * 3 / 2) * w;
      for (int y = 0; y < h; ++y)
        std::memcpy(o + size_t(y) * w, d.cur->y.data() + size_t(top + y) * d.W + left, w);
      int cw = d.W / 2;
      uint8_t* uv = o + size_t(h) * w;
      for (int y = 0; y < h / 2; ++y) {
        const uint8_t* cb = d.cur->cb.data() + size_t(top / 2 + y) * cw + left / 2;
        const uint8_t* cr = d.cur->cr.data() + size_t(top / 2 + y) * cw + left / 2;
        uint8_t* row = uv + size_t(y) * w;
        for (int x = 0; x < w / 2; ++x) {
          row[2 * x] = cb[x];
          row[2 * x + 1] = cr[x];
        }
      }
      got[k] = 1;
    }
  } catch (const Unsupported& e) {
    std::snprintf(err, errlen, "%s", e.what());
    d.pic_started = false;
    return 2;
  } catch (const std::exception& e) {
    std::snprintf(err, errlen, "%s", e.what());
    d.pic_started = false;
    return 1;
  }
  return 0;
}

}  // extern "C"
