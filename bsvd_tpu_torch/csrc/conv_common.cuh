// Shared tile machinery of the port's 3x3 conv kernels (sm_90a).
//
// Counterpart of bsvd_tpu/ops/_tile.py (the Pallas kernels' halo DMAs and
// 9-tap MXU contraction). The TPU kernels walk a sequential grid and carry
// frame tiles in a VMEM ring; here every block is independent: it loads its
// own input patch (tile + 1-pixel halo, zero outside the image) into shared
// memory, one 16-channel slice at a time, and runs the 9 taps as an
// implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate). The fp32 instantiation runs the same tile walk with FMAs and
// exists for exact parity checks.
//
// Who walks it (conv_region): every fp32 kernel (the exactness references
// of the card checks). The bf16 paths of K1 conv3x3, K2 conv_chain, K3
// conv_s2, K4 conv_ps, K5 bibuffer_conv / bibuffer_multi and K6
// bibuffer_chain run the pipelined loop of conv_pipe.cuh instead (cp.async
// ring, ldmatrix fragments); K7 conv3x3_dw has its own (conv3x3_dw.cu).
//
// Layouts: activations NHWC (channels-last), weights packed once per
// device/dtype as (CoutP, 3, 3, CinP) with CinP a multiple of 16 and CoutP
// a multiple of 64, zero padded; bias fp32 (CoutP,).
//
// Block: 256 threads = 8 warps laid out 4 (pixels) x 2 (output channels).
// A block owns 64 output channels; warp (wm, wn) owns MT m16 tiles of pixels
// and 32 channels (four n8 tiles). Accumulators use the mma.sync C layout:
// acc[i][nt][h*2+j] is pixel row (wm*MT+i)*16 + g + 8h, channel
// wn*32 + nt*8 + 2*tg + j, with g = lane/4, tg = lane%4.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bsvd {

constexpr int kThreads = 256;
constexpr int kBN = 64;        // output channels per block
constexpr int kKC = 16;        // input channels per K slice
constexpr int kKS = 24;        // smem pixel stride of a K slice (bank spread)
constexpr int kTH = 8;         // output tile rows
constexpr int kTW = 16;        // output tile cols
constexpr int kWTile = 9 * kBN * kKS;   // smem elements of one weight slice

enum Shift { kShiftNone = 0, kShiftTsm = 1, kShiftCausal = 2 };
enum Act { kActNone = 0, kActRelu = 1, kActRelu6 = 2 };

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == kActRelu) return fmaxf(v, 0.f);
  if (act == kActRelu6) return fminf(fmaxf(v, 0.f), 6.f);
  return v;
}

// ---- element I/O ---------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// 8 consecutive elements (16 B of bf16, 32 B of fp32), 16-byte aligned.
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 u;
  bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(v[j]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void copy8(bf16* d, const bf16* s) {
  *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
}
__device__ __forceinline__ void copy8(float* d, const float* s) {
  reinterpret_cast<float4*>(d)[0] = reinterpret_cast<const float4*>(s)[0];
  reinterpret_cast<float4*>(d)[1] = reinterpret_cast<const float4*>(s)[1];
}

// Two adjacent output channels c, c+1 of one pixel; `two` says c+1 exists.
__device__ __forceinline__ void store2(bf16* p, float a, float b, bool two,
                                       bool pair_ok) {
  if (two && pair_ok) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16(a);
    if (two) p[1] = __float2bfloat16(b);
  }
}
__device__ __forceinline__ void store2(float* p, float a, float b, bool two,
                                       bool pair_ok) {
  if (two && pair_ok) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (two) p[1] = b;
  }
}

// ---- input source: x (+ x2), with the temporal shift folded into the load

template <typename T>
struct Src {
  const T* x;
  const T* x2;      // optional second addend (nullptr)
  int H, W, C;      // image size and channels of x / x2
  int t_len, fold, shift;
  int vec;          // C % 8 == 0 and 16-byte aligned pointers
};

// Shift region of channel c: TSM reads [0, fold) from t+1 (region 0) and
// [fold, 2 fold) from t-1 (region 1); causal reads [0, 2 fold) from t-1;
// the rest (region 2) from t (bsvd_tpu/nn/shift.py temporal_shift).
__device__ __forceinline__ int region_of(int c, int shift, int fold) {
  if (shift == kShiftNone) return 0;
  int lim = shift == kShiftTsm ? fold : 0;
  return c < lim ? 0 : (c < 2 * fold ? 1 : 2);
}

// Frame that region r of frame n is read from, or -1 for a zero (clip edge).
__device__ __forceinline__ int region_frame(int r, int n, int shift,
                                            int t_len) {
  if (shift == kShiftNone) return n;
  const int t = n % t_len;
  if (r == 0) return t < t_len - 1 ? n + 1 : -1;
  if (r == 1) return t > 0 ? n - 1 : -1;
  return n;
}

// Frame that channel c of frame n is read from, or -1.
__device__ __forceinline__ int src_frame(int c, int n, int shift, int t_len,
                                         int fold) {
  return region_frame(region_of(c, shift, fold), n, shift, t_len);
}

// Eight channels c0..c0+7 of pixel (y, x) of frame n, summed over x and x2
// in fp32 (one rounding when stored as T, as the TPU kernel's add).
template <typename T>
__device__ __forceinline__ void read_group(const Src<T>& s, int n, int y,
                                           int x, int c0, float* v) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = 0.f;
  bool uniform = s.vec && c0 + 8 <= s.C &&
                 region_of(c0, s.shift, s.fold) ==
                     region_of(c0 + 7, s.shift, s.fold);
  if (uniform) {
    int f = src_frame(c0, n, s.shift, s.t_len, s.fold);
    if (f < 0) return;
    long long off = (((long long)f * s.H + y) * s.W + x) * s.C + c0;
    load8(s.x + off, v);
    if (s.x2) {
      float u[8];
      load8(s.x2 + off, u);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += u[j];
    }
    return;
  }
  for (int j = 0; j < 8; ++j) {
    int c = c0 + j;
    if (c >= s.C) break;
    int f = src_frame(c, n, s.shift, s.t_len, s.fold);
    if (f < 0) continue;
    long long off = (((long long)f * s.H + y) * s.W + x) * s.C + c;
    float a = to_f(s.x[off]);
    if (s.x2) a += to_f(s.x2[off]);
    v[j] = a;
  }
}

// Patch of PH x PW pixels whose (0, 0) is image pixel (iy0, ix0), channels
// k0..k0+15, into smem [PH*PW][kKS]; zeros outside the image / channels.
// ``Source`` is Src<T> or any type with H, W, C and a read_group overload
// (found by argument-dependent lookup), e.g. bibuffer_conv.cu's BiSrc.
template <typename T, typename Source>
__device__ void load_patch(T* sm, const Source& s, int n, int iy0, int ix0,
                           int PH, int PW, int k0) {
  int units = PH * PW * 2;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    int pix = u >> 1, g = u & 1;
    int py = pix / PW, px = pix - py * PW;
    int y = iy0 + py, x = ix0 + px, c0 = k0 + g * 8;
    float v[8];
    if (y >= 0 && y < s.H && x >= 0 && x < s.W && c0 < s.C) {
      read_group(s, n, y, x, c0, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
    store8(sm + pix * kKS + g * 8, v);
  }
}

// Weight slice: output channels n0..n0+63, input channels k0..k0+15, all 9
// taps, from packed (CoutP, 3, 3, CinP) into smem [tap][n][kKS].
template <typename T>
__device__ void load_weights(T* sm, const T* w, int CinP, int n0, int k0) {
  for (int u = threadIdx.x; u < 9 * kBN * 2; u += kThreads) {
    int g = u & 1, tn = u >> 1;          // tn = n * 9 + tap
    int n = tn / 9, tap = tn - n * 9;
    const T* src = w + ((long long)(n0 + n) * 9 + tap) * CinP + k0 + g * 8;
    copy8(sm + (tap * kBN + n) * kKS + g * 8, src);
  }
}

// ---- the 9-tap contraction of one K slice --------------------------------
//
// A: smem pixels with stride `as` elements, channel offset `koff`;
// abase[i][h]: pixel index of the thread's A row (tile i, half h) at tap
// (0, 0); tap (dy, dx) adds dy * PW + dx. Wsm: [tap][n][kKS].

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int MT>
__device__ __forceinline__ void mma_slice(float (&acc)[MT][4][4],
                                          const bf16* A, int as, int koff,
                                          const int (&abase)[MT][2], int PW,
                                          const bf16* Wsm, int wn, int lane) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int d = (tap / 3) * PW + (tap % 3);
    uint32_t b[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const bf16* wp = Wsm + (tap * kBN + wn * 32 + nt * 8 + g) * kKS + tg * 2;
      b[nt][0] = ld32(wp);
      b[nt][1] = ld32(wp + 8);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const bf16* p0 = A + (long long)(abase[i][0] + d) * as + koff + tg * 2;
      const bf16* p1 = A + (long long)(abase[i][1] + d) * as + koff + tg * 2;
      uint32_t a[4] = {ld32(p0), ld32(p1), ld32(p0 + 8), ld32(p1 + 8)};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[i][nt], a, b[nt]);
    }
  }
}

template <int MT>
__device__ __forceinline__ void mma_slice(float (&acc)[MT][4][4],
                                          const float* A, int as, int koff,
                                          const int (&abase)[MT][2], int PW,
                                          const float* Wsm, int wn, int lane) {
  const int tg = lane & 3;
  for (int tap = 0; tap < 9; ++tap) {
    const int d = (tap / 3) * PW + (tap % 3);
#pragma unroll 4
    for (int k = 0; k < kKC; ++k) {
      float bv[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          bv[nt][j] = Wsm[(tap * kBN + wn * 32 + nt * 8 + tg * 2 + j) * kKS + k];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float a0 = A[(long long)(abase[i][0] + d) * as + koff + k];
        float a1 = A[(long long)(abase[i][1] + d) * as + koff + k];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          acc[i][nt][0] += a0 * bv[nt][0];
          acc[i][nt][1] += a0 * bv[nt][1];
          acc[i][nt][2] += a1 * bv[nt][0];
          acc[i][nt][3] += a1 * bv[nt][1];
        }
      }
    }
  }
}

// Pixel rows of this thread for a region RW pixels wide, M pixels in all,
// read at stride S from a patch PW wide. Rows past M read pixel 0 and are
// dropped by the epilogue.
template <int MT>
__device__ __forceinline__ void row_bases(int (&abase)[MT][2], int wm, int lane,
                                          int M, int RW, int S, int PW) {
  const int g = lane >> 2;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int r = (wm * MT + i) * 16 + g + 8 * h;
      if (r >= M) r = 0;
      int ry = r / RW, rx = r - ry * RW;
      abase[i][h] = ry * S * PW + rx * S;
    }
}

template <int MT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][4][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
}

// Full conv of one block tile over all K slices: output channels
// n0..n0+63 of an RH x RW region whose input patch starts at image pixel
// (iy0, ix0) of frame n, stride S.
template <typename T, int S, int MT, typename Source>
__device__ void conv_region(float (&acc)[MT][4][4], const Source& s,
                            const T* w, int CinP, int n0, int n, int iy0,
                            int ix0, int RH, int RW, T* patch, T* wsm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int PH = (RH - 1) * S + 3, PW = (RW - 1) * S + 3;
  int abase[MT][2];
  row_bases(abase, wm, lane, RH * RW, RW, S, PW);
  zero_acc(acc);
  for (int k0 = 0; k0 < CinP; k0 += kKC) {
    __syncthreads();                       // previous slice consumed
    load_patch(patch, s, n, iy0, ix0, PH, PW, k0);
    load_weights(wsm, w, CinP, n0, k0);
    __syncthreads();
    mma_slice(acc, patch, kKS, 0, abase, PW, wsm, wn, lane);
  }
}

// Visit every accumulator element the thread owns:
// f(row r in the region, channel c relative to n0, value, e-index pair).
// Elements come in channel pairs (c, c+1) so stores can be paired.
template <int MT, typename F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[MT][4][4],
                                              F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int r = (wm * MT + i) * 16 + g + 8 * h;
        int c = wn * 32 + nt * 8 + tg * 2;
        f(r, c, acc[i][nt][h * 2], acc[i][nt][h * 2 + 1]);
      }
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Opt in to > 48 KB of dynamic shared memory for one kernel instantiation.
// A refusal is returned, and cleared from the runtime's last-error slot so
// that the next launch's cudaGetLastError() does not report it again.
template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

}  // namespace bsvd
