// K3 conv_s2: stride-2 3x3 conv (torch padding 1) + bias + act, NHWC.
//
// Replaces bsvd_tpu/ops/conv_s2.py conv_s2_pallas -> _kernel_s2 (and
// _kernel_s2_nt1 at one frame). The TPU kernel runs on the width-folded
// (H, W/2, 2C) view with (3, 2, 2C, Cout) weights because Mosaic has no
// strided reads or sub-128-lane copies; none of that applies here. This
// kernel is the natural stride-2 conv.
//
// What bounds it on the H100: its two BSVD-c64 sites sit near the ~295
// FLOP/byte ridge. 540x960, 64 -> 128 does 2 * 9 * 64 * 128 / 4 operations
// per input pixel against 128 + 64 bytes of input and output: 0.297 ms a
// frame by bytes against 0.193 by operations, so it is bounded by bytes;
// 270x480, 128 -> 256 is 0.149 by bytes against 0.193 by operations,
// bounded by operations. The first design (conv_common.cuh's conv_region,
// a grid whose slowest index was the 64-channel output group) read every
// 66 MB input frame from HBM once per output group, through a synchronous
// tile walk. The bf16 path now runs K4's pipelined main loop
// (conv_pipe.cuh pipe_conv_tile at stride 2):
// - for the bytes: all 128 output channels of the first site in one block,
//   and the channel block as the fastest grid index at the second (2
//   blocks a tile run together), so each input frame is read from HBM
//   once; 16-byte stores of whole channel runs from a staged tile;
// - for the operations: cp.async into a ring of stages (an 8 x 16 output
//   tile, its 17 x 33 input patch and 9 x 128 weight rows a 16-channel
//   slice, 55,360 bytes: 2 stages), ldmatrix fragments and mma.sync; the
//   110,720-byte ring lets two blocks share an SM, so one block's fill and
//   epilogue run under the other's MMAs;
// - the patch is stored split by column parity: a tap's 16 output pixels
//   read 16 consecutive rows of one sub-tile, so ldmatrix reads 8 distinct
//   bank groups (8 rows at stride 2 of the unsplit patch fall on 4).
// The layout was chosen by timing it against 16 x 16 tiles with 3 stages
// (one block an SM), 8 x 16 tiles with 4 and the unsplit patch
// (tools/torch_kernel_variants.py): level per 10-frame forward, faster at
// one frame.
// CoutP is a multiple of 128 (ops/conv_s2.py packs it so).
// The fp32 instantiation keeps the FMA walk of conv_region: it is the
// exactness reference of the card's parity checks, not a speed path.

#include "conv_pipe.cuh"

namespace bsvd {

struct S2Args {
  const void* x;
  const void* w;
  const float* b;
  void* y;
  int N, H, W, Cin, CinP, Cout, CoutP, Ho, Wo, act, vec;
};

using S2Cfg = PipeCfg<2, 8, 128, 1, 2>;

__global__ void __launch_bounds__(kThreads, S2Cfg::MIN_BLOCKS)
conv_s2_bf16_kernel(S2Args a) {
  PipeSrc s{static_cast<const bf16*>(a.x), nullptr,
            static_cast<const bf16*>(a.w), a.H, a.W, a.Cin, a.CinP,
            1, 0, kShiftNone, a.vec};
  pipe_conv_block<S2Cfg>(s, a.b, a.act, static_cast<bf16*>(a.y), a.Ho, a.Wo,
                         a.CoutP, a.Cout, a.Cout % 8 == 0,
                         [&](int n, int oy, int ox, int o) {
                           return (((long long)n * a.Ho + oy) * a.Wo + ox) *
                                      a.Cout + o;
                         });
}

constexpr int kS2PH = (kTH - 1) * 2 + 3;
constexpr int kS2PW = (kTW - 1) * 2 + 3;

// fp32: conv_common.cuh's FMA walk (8 x 16 tile, 64 channels a block).
__global__ void __launch_bounds__(kThreads) conv_s2_fma_kernel(S2Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* patch = reinterpret_cast<float*>(smem_raw);
  float* wsm = patch + kS2PH * kS2PW * kKS;

  const int tiles_x = (a.Wo + kTW - 1) / kTW;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int n0 = blockIdx.y * kBN, n = blockIdx.z;
  const int oy0 = ty * kTH, ox0 = tx * kTW;

  Src<float> s;
  s.x = static_cast<const float*>(a.x);
  s.x2 = nullptr;
  s.H = a.H; s.W = a.W; s.C = a.Cin;
  s.t_len = 1; s.fold = 0; s.shift = kShiftNone; s.vec = a.vec;

  float acc[2][4][4];
  conv_region<float, 2, 2>(acc, s, static_cast<const float*>(a.w), a.CinP,
                           n0, n, 2 * oy0 - 1, 2 * ox0 - 1, kTH, kTW, patch,
                           wsm);

  float* y = static_cast<float*>(a.y);
  const bool pair_ok = (a.Cout % 2) == 0;
  for_each_pair(acc, [&](int r, int c, float v0, float v1) {
    int oy = oy0 + r / kTW, ox = ox0 + r % kTW;
    int co = n0 + c;
    if (r >= kTH * kTW || oy >= a.Ho || ox >= a.Wo || co >= a.Cout) return;
    v0 = apply_act(v0 + a.b[co], a.act);
    v1 = apply_act(v1 + a.b[co + 1], a.act);
    long long off = (((long long)n * a.Ho + oy) * a.Wo + ox) * a.Cout + co;
    store2(y + off, v0, v1, co + 1 < a.Cout, pair_ok);
  });
}

static int launch_s2(const S2Args& a, int bf16_path, cudaStream_t stream) {
  if (bf16_path) {
    if (a.CoutP % S2Cfg::BN) return (int)cudaErrorInvalidValue;
    return pipe_launch<S2Cfg>(conv_s2_bf16_kernel, a, a.Ho, a.Wo, a.CoutP,
                              a.N, stream);
  }
  size_t smem = (kS2PH * kS2PW * kKS + kWTile) * sizeof(float);
  auto kern = conv_s2_fma_kernel;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(cdiv(a.Ho, kTH) * cdiv(a.Wo, kTW), a.CoutP / kBN, a.N);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bsvd

// dtype: 0 = float32, 1 = bfloat16. ``w``/``b`` packed, CinP % 16 == 0,
// CoutP % 128 == 0. Returns a cudaError_t code.
extern "C" int bsvd_conv_s2(int dtype, const void* x, const void* w,
                            const void* b, void* y, int N, int H, int W,
                            int Cin, int CinP, int Cout, int CoutP, int act,
                            int vec, void* stream) {
  bsvd::S2Args a{x, w, static_cast<const float*>(b), y, N, H, W, Cin, CinP,
                 Cout, CoutP, (H - 1) / 2 + 1, (W - 1) / 2 + 1, act, vec};
  return bsvd::launch_s2(a, dtype == 1, static_cast<cudaStream_t>(stream));
}
