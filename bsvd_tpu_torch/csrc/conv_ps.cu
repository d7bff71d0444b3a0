// K4 conv_ps: 3x3 conv (stride 1, pad 1) + bias + r=2 pixel shuffle, NHWC.
//
// Replaces bsvd_tpu/ops/conv3x3.py conv_ps_natural_pallas and
// conv_ps_fold_pallas (the _kernel with the ps_nat / ps_half epilogues).
// The width-folded write of ps_fold is TPU layout and is dropped: the
// output is the natural (N, 2H, 2W, Cout / 4).
//
// Weights come packed in sub-pixel-major order (ops/_pack.py, order 'ps'):
// packed row o' = s * c4 + k holds torch output channel k * 4 + s, with
// s = di * 2 + dj the sub-pixel and c4 = Cout / 4, so that a run of packed
// channels is a run of output channels k of ONE sub-pixel, which lands at
// out[n, 2i + di, 2j + dj, k..]: contiguous in the output.
//
// What bounds it on the H100: tensor-core FLOPs (2 * 9 * Cin * Cout per
// input pixel: 3.06 TFLOP per 10-frame 540p forward against 1.6 GB of
// input and output, far above the ~295 FLOP/byte ridge). The first design
// (conv_common.cuh's conv_region) lost to loads that never overlapped the
// math (a synchronous 16-channel slice, two barriers, every 128-pixel block
// reloading 18 KB of weights a slice) and to an epilogue of scattered 2-byte
// stores. This one (conv_pipe.cuh pipe_conv_tile):
// - a 16 x 16 output tile x 128 channels a block, so one weight slice
//   serves 256 pixels (200 FLOP per byte filled, from 97);
// - cp.async copies of patch and weights into a 4-stage ring, three K
//   slices in flight while one is multiplied, one barrier a slice;
// - ldmatrix.x4 fragments from XOR-swizzled tiles (no bank conflicts, the
//   tap shift a per-lane row address);
// - the epilogue adds the bias, rounds to bf16 once, stages the tile in
//   shared memory and writes each pixel's run of channels of a sub-pixel
//   with 16-byte stores;
// - the output-channel block is the fastest grid index, so the 2 or 4
//   blocks that read one input tile run together.
// The fp32 instantiation keeps the simple FMA walk of conv_common.cuh
// (conv_region): it is the exactness reference of the card's parity
// checks, not a speed path.

#include "conv_pipe.cuh"

namespace bsvd {

struct PsArgs {
  const void* x;
  const void* w;
  const float* b;    // packed (CoutP,) fp32, sub-pixel-major
  void* y;           // (N, 2H, 2W, Cout / 4)
  int N, H, W, Cin, CinP, Cout, CoutP, vec;
};

// Offset in y of packed channel o of output pixel (oy, ox) of frame n.
__device__ __forceinline__ long long ps_offset(const PsArgs& a, int n, int oy,
                                               int ox, int o) {
  const int c4 = a.Cout / 4, s = o / c4, k = o - s * c4;
  return (((long long)n * 2 * a.H + 2 * oy + (s >> 1)) * 2 * a.W + 2 * ox +
          (s & 1)) * c4 + k;
}

using PsCfg = PipeCfg<1, 16, 128, 1, 4>;

__global__ void __launch_bounds__(kThreads, PsCfg::MIN_BLOCKS)
conv_ps_bf16_kernel(PsArgs a) {
  PipeSrc s{static_cast<const bf16*>(a.x), nullptr,
            static_cast<const bf16*>(a.w), a.H, a.W, a.Cin, a.CinP,
            1, 0, kShiftNone, a.vec};
  pipe_conv_block<PsCfg>(s, a.b, kActNone, static_cast<bf16*>(a.y), a.H, a.W,
                         a.CoutP, a.Cout, (a.Cout / 4) % 8 == 0,
                         [&](int n, int oy, int ox, int o) {
                           return ps_offset(a, n, oy, ox, o);
                         });
}

// fp32: conv_common.cuh's FMA walk (8 x 16 tile, 64 channels a block).
__global__ void __launch_bounds__(kThreads) conv_ps_fma_kernel(PsArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* patch = reinterpret_cast<float*>(smem_raw);
  float* wsm = patch + (kTH + 2) * (kTW + 2) * kKS;
  const int tiles_x = cdiv(a.W, kTW);
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int n0 = blockIdx.y * kBN, n = blockIdx.z;
  const int oy0 = ty * kTH, ox0 = tx * kTW;

  Src<float> s;
  s.x = static_cast<const float*>(a.x);
  s.x2 = nullptr;
  s.H = a.H; s.W = a.W; s.C = a.Cin;
  s.t_len = 1; s.fold = 0; s.shift = kShiftNone; s.vec = a.vec;
  float acc[2][4][4];
  conv_region<float, 1, 2>(acc, s, static_cast<const float*>(a.w), a.CinP,
                           n0, n, oy0 - 1, ox0 - 1, kTH, kTW, patch, wsm);
  float* y = static_cast<float*>(a.y);
  for_each_pair(acc, [&](int r, int c, float v0, float v1) {
    const int oy = oy0 + r / kTW, ox = ox0 + r % kTW, o = n0 + c;
    if (r >= kTH * kTW || oy >= a.H || ox >= a.W || o >= a.Cout) return;
    y[ps_offset(a, n, oy, ox, o)] = v0 + a.b[o];
    if (o + 1 < a.Cout) y[ps_offset(a, n, oy, ox, o + 1)] = v1 + a.b[o + 1];
  });
}

static int launch_ps(const PsArgs& a, int bf16_path, cudaStream_t stream) {
  if (bf16_path)
    return pipe_launch<PsCfg>(conv_ps_bf16_kernel, a, a.H, a.W, a.CoutP, a.N,
                              stream);
  size_t smem = ((kTH + 2) * (kTW + 2) * kKS + kWTile) * sizeof(float);
  auto kern = conv_ps_fma_kernel;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(cdiv(a.H, kTH) * cdiv(a.W, kTW), a.CoutP / kBN, a.N);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bsvd

// dtype: 0 = float32, 1 = bfloat16. ``w``/``b`` packed sub-pixel-major,
// CinP % 16 == 0, CoutP % 128 == 0. Returns a cudaError_t code.
extern "C" int bsvd_conv_ps(int dtype, const void* x, const void* w,
                            const void* b, void* y, int N, int H, int W,
                            int Cin, int CinP, int Cout, int CoutP, int vec,
                            void* stream) {
  bsvd::PsArgs a{x, w, static_cast<const float*>(b), y, N, H, W, Cin, CinP,
                 Cout, CoutP, vec};
  return bsvd::launch_ps(a, dtype == 1, static_cast<cudaStream_t>(stream));
}
