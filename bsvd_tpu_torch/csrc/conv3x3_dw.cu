// K7 conv3x3_dw: weight gradient of a stride-1 pad-1 3x3 conv, NHWC.
//
//   dw[co, ci, ky, kx] = sum_{n, y, x} v[n, y + ky - 1, x + kx - 1, ci]
//                                      * dz[n, y, x, co]
//
// with v = shift(x [+ x2]) zero outside the image: the temporal shift and
// the second addend are read in the loader (conv_common.cuh's Src), as K1
// reads them, so the shifted input of a shift-conv site never exists in
// device memory.
//
// Replaces bsvd_tpu/ops/conv3x3.py conv3x3_dw_pallas -> _kernel_dw. The TPU
// kernel walks row blocks in order and keeps the (9, Ci, Co) fp32 sum in a
// VMEM block that is the output. Blocks here run in parallel: block
// (co block, ci block, split) sums its share of the pixel tiles (tile s,
// s + splits, ...) into registers and writes one fp32 partial; a second
// kernel adds the partials of a weight element in split order, so two runs
// give the same bits (no atomics).
//
// Per 8 x 16 pixel tile the block holds dz^T (64 output channels x 128
// pixels) and v^T (32 input channels x the 10 x 18 halo patch) in shared
// memory, channel-major, so that the GEMM's reduction axis (pixels) is
// contiguous: per tap it is dz^T (64 x 128) . v_tap (128 x 32), one m16n8k16
// mma.sync per (16 pixels, 16 channels, 8 channels). The dz fragment of a
// 16-pixel step serves all 9 taps; tap (ky, kx) reads the patch at a row
// and column offset (two 16-bit loads where kx is odd). Warps: 4 (16
// output channels each) x 2 (16 input channels each), all 9 taps, 72 fp32
// accumulators a thread. The fp32 instantiation runs the same walk with
// FMAs, for exact parity checks.
//
// What bounds it on the H100: tensor-core FLOPs (2 * 9 * Ci * Co per pixel;
// 128 -> 128 at 48 x 48 x 88 frames is 53 GFLOP) fed from shared memory by
// scalar-width loads. Not yet done: cp.async / TMA pipelining of the tile
// loads and wgmma, which later speed PRs add.

#include "conv_common.cuh"

namespace bsvd {

constexpr int kDwCO = 64;                    // output channels (GEMM M)
constexpr int kDwCI = 32;                    // input channels (GEMM N)
constexpr int kDwPix = kTH * kTW;            // 128 pixels a tile
constexpr int kDwPH = kTH + 2, kDwPW = kTW + 2;
constexpr int kDwZS = kDwPix + 8;            // smem stride of a dz^T row
constexpr int kDwXS = 200;                   // smem stride of a v^T row (>= 180)

struct DwArgs {
  const void* x;
  const void* x2;
  const void* dz;
  float* part;       // (splits, CoutP, CinP, 9)
  float* out;        // (Cout, Cin, 3, 3)
  int N, H, W, Cin, Cout, CinP, CoutP;
  int t_len, fold, shift, vec_x, vec_dz, splits;
};

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  return (uint32_t)q[0] | ((uint32_t)q[1] << 16);
}

// One tile's contribution for bf16: tensor cores.
__device__ __forceinline__ void dw_tile_mma(float (&acc)[9][2][4],
                                            const bf16* zt, const bf16* xt,
                                            int wm, int wn, int lane) {
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll 1
  for (int r = 0; r < kTH; ++r) {
    const bf16* z0 = zt + (wm * 16 + g) * kDwZS + r * kTW + 2 * tg;
    const bf16* z1 = z0 + 8 * kDwZS;
    uint32_t a[4] = {ld32(z0), ld32(z1), ld32(z0 + 8), ld32(z1 + 8)};
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const bf16* p = xt + (wn * 16 + nt * 8 + g) * kDwXS +
                        (r + ky) * kDwPW + kx + 2 * tg;
        uint32_t b[2];
        if (kx & 1) {
          b[0] = ld_pair(p);
          b[1] = ld_pair(p + 8);
        } else {
          b[0] = ld32(p);
          b[1] = ld32(p + 8);
        }
        mma_bf16(acc[tap][nt], a, b);
      }
    }
  }
}

// The same sums for fp32 with FMAs, in the mma accumulator layout.
__device__ __forceinline__ void dw_tile_mma(float (&acc)[9][2][4],
                                            const float* zt, const float* xt,
                                            int wm, int wn, int lane) {
  const int g = lane >> 2, tg = lane & 3;
  for (int r = 0; r < kTH; ++r) {
#pragma unroll 2
    for (int k = 0; k < kTW; ++k) {
      const float a0 = zt[(wm * 16 + g) * kDwZS + r * kTW + k];
      const float a1 = zt[(wm * 16 + g + 8) * kDwZS + r * kTW + k];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int pp = (r + tap / 3) * kDwPW + k + tap % 3;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float bv = xt[(wn * 16 + nt * 8 + 2 * tg + j) * kDwXS + pp];
            acc[tap][nt][j] += a0 * bv;
            acc[tap][nt][2 + j] += a1 * bv;
          }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) conv3x3_dw_kernel(DwArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* zt = reinterpret_cast<T*>(smem_raw);          // [kDwCO][kDwZS]
  T* xt = zt + kDwCO * kDwZS;                        // [kDwCI][kDwXS]

  const int co0 = blockIdx.x * kDwCO, ci0 = blockIdx.y * kDwCI;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int tiles_x = (a.W + kTW - 1) / kTW, tiles_y = (a.H + kTH - 1) / kTH;
  const int ntiles = a.N * tiles_y * tiles_x;

  Src<T> sx;
  sx.x = static_cast<const T*>(a.x);
  sx.x2 = static_cast<const T*>(a.x2);
  sx.H = a.H; sx.W = a.W; sx.C = a.Cin;
  sx.t_len = a.t_len; sx.fold = a.fold; sx.shift = a.shift; sx.vec = a.vec_x;
  Src<T> sz;
  sz.x = static_cast<const T*>(a.dz);
  sz.x2 = nullptr;
  sz.H = a.H; sz.W = a.W; sz.C = a.Cout;
  sz.t_len = 1; sz.fold = 0; sz.shift = kShiftNone; sz.vec = a.vec_dz;

  float acc[9][2][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][i][e] = 0.f;

  for (int tile = blockIdx.z; tile < ntiles; tile += a.splits) {
    const int n = tile / (tiles_y * tiles_x);
    const int rem = tile - n * tiles_y * tiles_x;
    const int oy0 = (rem / tiles_x) * kTH, ox0 = (rem % tiles_x) * kTW;
    __syncthreads();                               // previous tile consumed
    // dz^T: 128 pixels x 8 groups of 8 output channels
    for (int u = threadIdx.x; u < kDwPix * (kDwCO / 8); u += kThreads) {
      const int pix = u >> 3, grp = u & 7;
      const int y = oy0 + pix / kTW, x = ox0 + pix % kTW;
      const int c0 = co0 + grp * 8;
      float v[8];
      if (y < a.H && x < a.W && c0 < a.Cout) {
        read_group(sz, n, y, x, c0, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) zt[(grp * 8 + j) * kDwZS + pix] = from_f<T>(v[j]);
    }
    // v^T: the 10 x 18 halo patch x 4 groups of 8 input channels
    for (int u = threadIdx.x; u < kDwPH * kDwPW * (kDwCI / 8); u += kThreads) {
      const int pix = u >> 2, grp = u & 3;
      const int y = oy0 - 1 + pix / kDwPW, x = ox0 - 1 + pix % kDwPW;
      const int c0 = ci0 + grp * 8;
      float v[8];
      if (y >= 0 && y < a.H && x >= 0 && x < a.W && c0 < a.Cin) {
        read_group(sx, n, y, x, c0, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) xt[(grp * 8 + j) * kDwXS + pix] = from_f<T>(v[j]);
    }
    __syncthreads();
    dw_tile_mma(acc, zt, xt, wm, wn, lane);
  }

  // partial sums of this split: element (co, ci, tap) of the mma C layout
  const int g = lane >> 2, tg = lane & 3;
  float* part = a.part + (long long)blockIdx.z * a.CoutP * a.CinP * 9;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = co0 + wm * 16 + g + (e >> 1) * 8;
        const int ci = ci0 + wn * 16 + nt * 8 + 2 * tg + (e & 1);
        part[((long long)co * a.CinP + ci) * 9 + tap] = acc[tap][nt][e];
      }
}

// out[co, ci, tap] = sum over splits in order (deterministic).
__global__ void conv3x3_dw_reduce(DwArgs a) {
  const long long total = (long long)a.Cout * a.Cin * 9;
  const long long stride = (long long)a.CoutP * a.CinP * 9;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int co = (int)(i / (a.Cin * 9));
    const int r = (int)(i - (long long)co * a.Cin * 9);
    const int ci = r / 9, tap = r - ci * 9;
    const float* p = a.part + ((long long)co * a.CinP + ci) * 9 + tap;
    float s = 0.f;
    for (int k = 0; k < a.splits; ++k) s += p[k * stride];
    a.out[i] = s;
  }
}

template <typename T>
static int launch_dw(const DwArgs& a, cudaStream_t stream) {
  size_t smem = (kDwCO * kDwZS + kDwCI * kDwXS) * sizeof(T);
  auto kern = conv3x3_dw_kernel<T>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.CoutP / kDwCO, a.CinP / kDwCI, a.splits);
  kern<<<grid, kThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  long long total = (long long)a.Cout * a.Cin * 9;
  int blocks = (int)((total + 255) / 256);
  conv3x3_dw_reduce<<<blocks, 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bsvd

// dtype: 0 = float32, 1 = bfloat16. ``part`` holds splits * CoutP * CinP * 9
// floats (CinP % 32 == 0, CoutP % 64 == 0); ``out`` Cout * Cin * 9 floats.
// Returns a cudaError_t code.
extern "C" int bsvd_conv3x3_dw(int dtype, const void* x, const void* x2,
                               const void* dz, void* part, void* out, int N,
                               int H, int W, int Cin, int Cout, int CinP,
                               int CoutP, int t_len, int fold, int shift,
                               int vec_x, int vec_dz, int splits,
                               void* stream) {
  bsvd::DwArgs a{x, x2, dz, static_cast<float*>(part),
                 static_cast<float*>(out), N, H, W, Cin, Cout, CinP, CoutP,
                 t_len, fold, shift, vec_x, vec_dz, splits};
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? bsvd::launch_dw<bsvd::bf16>(a, s)
                    : bsvd::launch_dw<float>(a, s);
}
