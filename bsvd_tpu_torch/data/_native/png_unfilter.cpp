// PNG row unfiltering for bsvd_tpu_torch/data/png_decode.py (the zlib-only
// PNG reader): undoes filter types 0-4 (None, Sub, Up, Average, Paeth) of
// the PNG specification, section 9, row after row. Average and Paeth
// depend on the byte just undone to their left, so a row is sequential;
// zlib's inflate stays in Python. Standard library only; bound with ctypes
// and built at first use:
//
//   g++ -O3 -shared -fPIC png_unfilter.cpp -o libbsvd_png.so

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

// Branch-free Paeth predictor (the specification's tie order: a, b, c):
// with the usual if / else chain a photograph's rows mispredict often.
inline int paeth(int a, int b, int c) {
  const int pa = std::abs(b - c);
  const int pb = std::abs(a - c);
  const int pc = std::abs(a + b - 2 * c);
  const int ab = pa <= pb ? a : b;
  const int pab = pa <= pb ? pa : pb;
  return pab <= pc ? ab : c;
}

// Paeth on a row below another, BPP bytes a pixel known at compile time so
// the pixel's channels run as independent chains.
template <int BPP>
void paeth_row(const uint8_t* src, const uint8_t* prev, uint8_t* cur,
               int rowbytes) {
  for (int i = 0; i < BPP && i < rowbytes; ++i) {
    cur[i] = static_cast<uint8_t>(src[i] + prev[i]);
  }
  for (int i = BPP; i + BPP <= rowbytes; i += BPP) {
    for (int k = 0; k < BPP; ++k) {
      cur[i + k] = static_cast<uint8_t>(
          src[i + k] + paeth(cur[i + k - BPP], prev[i + k],
                             prev[i + k - BPP]));
    }
  }
}

void paeth_row_any(const uint8_t* src, const uint8_t* prev, uint8_t* cur,
                   int rowbytes, int bpp) {
  for (int i = 0; i < bpp && i < rowbytes; ++i) {
    cur[i] = static_cast<uint8_t>(src[i] + prev[i]);
  }
  for (int i = bpp; i < rowbytes; ++i) {
    cur[i] = static_cast<uint8_t>(
        src[i] + paeth(cur[i - bpp], prev[i], prev[i - bpp]));
  }
}

}  // namespace

extern "C" {

// raw: `rows` filtered rows of 1 + rowbytes bytes (the filter type, then
// the row); out: rows * rowbytes bytes. bpp: bytes per complete pixel,
// rounded up to 1. The row above the first is zero. Returns 0, or 1 + the
// index of the first row with a filter type above 4.
int bsvd_png_unfilter(const uint8_t* raw, int rows, int rowbytes, int bpp,
                      uint8_t* out) {
  const uint8_t* prev = nullptr;
  for (int y = 0; y < rows; ++y) {
    const uint8_t* src = raw + static_cast<size_t>(y) * (rowbytes + 1);
    const int type = *src++;
    uint8_t* cur = out + static_cast<size_t>(y) * rowbytes;
    const int lead = bpp < rowbytes ? bpp : rowbytes;
    switch (type) {
      case 0:
        memcpy(cur, src, rowbytes);
        break;
      case 1:
        memcpy(cur, src, lead);
        for (int i = bpp; i < rowbytes; ++i) cur[i] = src[i] + cur[i - bpp];
        break;
      case 2:
        if (prev == nullptr) {
          memcpy(cur, src, rowbytes);
        } else {
          for (int i = 0; i < rowbytes; ++i) cur[i] = src[i] + prev[i];
        }
        break;
      case 3:
        if (prev == nullptr) {
          memcpy(cur, src, lead);
          for (int i = bpp; i < rowbytes; ++i) {
            cur[i] = src[i] + (cur[i - bpp] >> 1);
          }
        } else {
          for (int i = 0; i < lead; ++i) cur[i] = src[i] + (prev[i] >> 1);
          for (int i = bpp; i < rowbytes; ++i) {
            cur[i] = src[i] + ((cur[i - bpp] + prev[i]) >> 1);
          }
        }
        break;
      case 4:
        if (prev == nullptr) {  // b = c = 0: Paeth is Sub
          memcpy(cur, src, lead);
          for (int i = bpp; i < rowbytes; ++i) cur[i] = src[i] + cur[i - bpp];
        } else {
          switch (bpp) {  // rowbytes is a multiple of bpp when bpp > 1
            case 3: paeth_row<3>(src, prev, cur, rowbytes); break;
            case 4: paeth_row<4>(src, prev, cur, rowbytes); break;
            default: paeth_row_any(src, prev, cur, rowbytes, bpp);
          }
        }
        break;
      default:
        return y + 1;
    }
    prev = cur;
  }
  return 0;
}

}  // extern "C"
