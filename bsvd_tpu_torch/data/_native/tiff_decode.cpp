// TIFF strip / tile codecs for bsvd_tpu_torch/data/tiff_decode.py (the
// port's TIFF reader) and the `.tif` writer of utils/img_util.py: LZW
// (TIFF 6.0 section 13, as libtiff decodes it, the old "compat" bit order
// too) and PackBits (section 9). Deflate stays in Python (zlib), as do the
// predictor and the sample conversions (numpy). Standard library only;
// bound with ctypes and built at first use:
//
//   g++ -O3 -shared -fPIC tiff_decode.cpp -o libbsvd_tiff.so
//
// LZW as libtiff reads it (tif_lzw.c): codes 256 Clear and 257 EOI, the
// first free code 258; new-style codes are MSB first and the code width
// grows one code early (at 511, 1023, 2047 decoded entries), old-style
// ("compat", found by the stream starting with bytes 0x00, 0x?1) codes
// are LSB first and grow at 512, 1024, 2048. Widths stop at 12 bits. A
// stream that runs out before the chunk is full is an error ("not enough
// data"); one that holds more stops at the chunk's size.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMaxBits = 12;
constexpr int kTable = 1 << kMaxBits;

struct Entry {
  int16_t prefix;   // -1 for a root
  uint8_t suffix;
  uint8_t first;
  uint16_t len;
};

// Bits from a byte stream, MSB first (new style) or LSB first (compat).
struct BitReader {
  const uint8_t* p;
  int64_t n, pos = 0;
  uint64_t acc = 0;
  int nacc = 0;
  bool lsb;

  // The next ``bits``-bit code, or -1 when the stream is spent.
  int get(int bits) {
    while (nacc < bits) {
      if (pos >= n) return -1;
      if (lsb) {
        acc |= static_cast<uint64_t>(p[pos++]) << nacc;
      } else {
        acc = (acc << 8) | p[pos++];
      }
      nacc += 8;
    }
    int code;
    if (lsb) {
      code = static_cast<int>(acc & ((1u << bits) - 1));
      acc >>= bits;
    } else {
      code = static_cast<int>((acc >> (nacc - bits)) & ((1u << bits) - 1));
    }
    nacc -= bits;
    if (!lsb) acc &= (nacc ? ((uint64_t(1) << nacc) - 1) : 0);
    return code;
  }
};

// Decodes one LZW chunk into dst (cap bytes). Returns the bytes written
// (cap when the chunk is full), or -1 for a corrupt table.
int64_t lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  const bool compat = n >= 2 && src[0] == 0 && (src[1] & 1);
  std::vector<Entry> tab(kTable);
  for (int i = 0; i < 256; ++i) {
    tab[i] = Entry{-1, static_cast<uint8_t>(i), static_cast<uint8_t>(i), 1};
  }
  BitReader br{src, n};
  br.lsb = compat;
  int nbits = 9, free_ent = kFirst, old = -1;
  int64_t out = 0;
  // the code width grows at free_ent == limit
  auto limit = [&]() { return compat ? (1 << nbits) : (1 << nbits) - 1; };
  while (out < cap) {
    int code = br.get(nbits);
    if (code < 0 || code == kEoi) break;
    if (code == kClear) {
      nbits = 9;
      free_ent = kFirst;
      code = br.get(nbits);
      if (code < 0 || code == kEoi) break;
      if (code > 255) return -1;
      dst[out++] = static_cast<uint8_t>(code);
      old = code;
      continue;
    }
    if (code > free_ent || (old < 0 && code >= 256)) return -1;
    if (old >= 0 && free_ent < kTable) {
      const int src_code = code == free_ent ? old : code;
      Entry& e = tab[free_ent];
      e.prefix = static_cast<int16_t>(old);
      e.suffix = tab[src_code].first;
      e.first = tab[old].first;
      e.len = static_cast<uint16_t>(tab[old].len + 1);
      if (++free_ent >= limit() && nbits < kMaxBits) ++nbits;
    } else if (old >= 0 && code == free_ent) {
      return -1;                      // KwKwK past a full table
    }
    // write the string of ``code`` backwards, clipped to the chunk
    const Entry* e = &tab[code];
    const int len = e->len;
    int64_t end = out + len;
    int c = code;
    for (int64_t i = end - 1; i >= out; --i) {
      if (i < cap) dst[i] = tab[c].suffix;
      c = tab[c].prefix;
    }
    out = end < cap ? end : cap;
    old = code;
  }
  return out;
}

// PackBits (libtiff's PackBitsDecode): a header n of 0-127 copies n + 1
// bytes, -1 to -127 repeats the next byte 1 - n times, -128 is skipped.
int64_t packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                        int64_t cap) {
  int64_t i = 0, out = 0;
  while (i < n && out < cap) {
    const int h = static_cast<int8_t>(src[i++]);
    if (h >= 0) {
      int64_t k = h + 1;
      if (k > n - i) k = n - i;
      if (k > cap - out) k = cap - out;
      std::memcpy(dst + out, src + i, static_cast<size_t>(k));
      out += k;
      i += h + 1;
    } else if (h != -128) {
      if (i >= n) break;
      int64_t k = 1 - h;
      if (k > cap - out) k = cap - out;
      std::memset(dst + out, src[i++], static_cast<size_t>(k));
      out += k;
    }
  }
  return out;
}

// LZW encoder (new style), the inverse of lzw_decode: Clear first, the
// table reset with a Clear at 4094 entries, EOI last.
struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int nacc = 0;
  void put(int code, int bits) {
    acc = (acc << bits) | static_cast<uint64_t>(code);
    nacc += bits;
    while (nacc >= 8) {
      out.push_back(static_cast<uint8_t>(acc >> (nacc - 8)));
      nacc -= 8;
    }
    acc &= nacc ? ((uint64_t(1) << nacc) - 1) : 0;
  }
  void flush() {
    if (nacc) out.push_back(static_cast<uint8_t>(acc << (8 - nacc)));
    nacc = 0;
  }
};

constexpr int kHash = 9001;           // libtiff's HSIZE, a prime

void lzw_encode(const uint8_t* src, int64_t n, std::vector<uint8_t>& out) {
  std::vector<int32_t> key(kHash, -1);  // (prefix << 8 | byte), -1 free
  std::vector<int16_t> val(kHash);
  BitWriter bw{out};
  int nbits = 9, next = kFirst;
  bw.put(kClear, nbits);
  if (n == 0) {
    bw.put(kEoi, nbits);
    bw.flush();
    return;
  }
  int w = src[0];
  auto grow = [&]() {
    if (next + 1 > (1 << nbits) && nbits < kMaxBits) ++nbits;
  };
  for (int64_t i = 1; i < n; ++i) {
    const int c = src[i];
    const int32_t k = (w << 8) | c;
    int h = static_cast<int>((static_cast<uint32_t>(k) * 2654435761u) %
                             kHash);
    while (key[h] != -1 && key[h] != k) h = (h + 1) % kHash;
    if (key[h] == k) {
      w = val[h];
      continue;
    }
    bw.put(w, nbits);
    key[h] = k;
    val[h] = static_cast<int16_t>(next++);
    if (next + 1 >= 4095) {
      bw.put(kClear, nbits);
      std::fill(key.begin(), key.end(), -1);
      next = kFirst;
      nbits = 9;
    } else {
      grow();
    }
    w = c;
  }
  bw.put(w, nbits);
  ++next;
  grow();
  bw.put(kEoi, nbits);
  bw.flush();
}

}  // namespace

extern "C" {

// Decodes ``nchunks`` chunks of codec 5 (LZW) or 32773 (PackBits) of the
// file's bytes: chunk i is file[offs[i], offs[i] + lens[i]) and fills
// dst[dst_offs[i], dst_offs[i] + dst_lens[i]). Returns 0, or -(i + 1) where
// chunk i is corrupt or ends before its bytes are filled.
int bsvd_tiff_decode(int codec, const uint8_t* file, int nchunks,
                     const int64_t* offs, const int64_t* lens, uint8_t* dst,
                     const int64_t* dst_offs, const int64_t* dst_lens) {
  for (int i = 0; i < nchunks; ++i) {
    const uint8_t* s = file + offs[i];
    uint8_t* d = dst + dst_offs[i];
    const int64_t got = codec == 5 ? lzw_decode(s, lens[i], d, dst_lens[i])
                                   : packbits_decode(s, lens[i], d,
                                                     dst_lens[i]);
    if (got != dst_lens[i]) return -(i + 1);
  }
  return 0;
}

// LZW-encodes src into dst (cap bytes). Returns the encoded size, or -1
// when it exceeds cap.
int64_t bsvd_tiff_lzw_encode(const uint8_t* src, int64_t n, uint8_t* dst,
                             int64_t cap) {
  std::vector<uint8_t> out;
  out.reserve(static_cast<size_t>(n / 2 + 64));
  lzw_encode(src, n, out);
  if (static_cast<int64_t>(out.size()) > cap) return -1;
  std::memcpy(dst, out.data(), out.size());
  return static_cast<int64_t>(out.size());
}

}  // extern "C"
