// K1 conv3x3: stride-1 3x3 conv + bias (+ act), NHWC.
//
// Replaces bsvd_tpu/ops/conv3x3.py conv3x3_pallas -> _kernel (and
// _kernel_nt1 at one frame; reached through ops/shift_conv.py shift_conv /
// shift_conv_add2; the same function as the generation-1
// _shift_conv_fused_v1). The temporal shift happens in the tile loader:
// each input channel is read from frame t+1, t-1 or t, or is zero at a clip
// edge (t % t_len), so the shifted tensor never exists in device memory; an
// optional second input is summed before the shift.
//
// What bounds it on the H100: tensor-core FLOPs. The BSVD-c64 sites (C =
// 128 / 256 at 270x480 / 135x240) do 2 * 9 * C operations per byte of
// input and output, 4-9x the ~295 FLOP/byte ridge. The first design
// (conv_common.cuh's conv_region: 8 x 16 pixels x 64 channels a block, a
// synchronous 16-channel slice with two barriers, 4-byte fragment loads,
// 4-byte stores) fed the tensor cores at ~175 TFLOP/s. The bf16 path now
// runs K4's pipelined main loop (conv_pipe.cuh pipe_conv_tile):
// - 16 x 16 pixels x 128 output channels a block at the 128- and
//   256-channel sites, so one weight slice serves 256 pixels; the channel
//   block is the fastest grid index, so the blocks sharing an input tile
//   run together;
// - a 4-stage cp.async ring with one barrier a slice; the loader takes
//   each 16-byte chunk from its shifted frame (src-size 0 at a clip edge);
//   a chunk straddling two shift regions (fold % 8 != 0) and inputs
//   without 16-byte rows (Cin = 4) are read element by element;
// - x2 is staged beside x (a stage of 57,600 bytes: the 4-stage ring takes
//   230,400 of the 232,448 bytes a block may have) and the two ldmatrix A
//   fragments are added in registers (__hadd2: the exact sum rounded once
//   to bf16, as the TPU kernel and the plain version compute it), not run
//   as a second GEMM;
// - the epilogue adds the bias and applies the act in fp32, rounds once,
//   stages the tile in the ring and writes 16-byte runs of channels.
// Cout <= 64 (the train step's chain intermediates at 96x96, Cin 4 or 64)
// takes a 64-channel block (BN = 64) rather than padding CoutP to 128,
// which would double its MMAs: its ring fits twice in an SM without x2.
// The fp32 instantiation keeps the FMA walk of conv_region: it is the
// exactness reference of the card's parity checks, not a speed path.

#include "conv_pipe.cuh"

namespace bsvd {

struct ConvArgs {
  const void* x;
  const void* x2;
  const void* w;
  const float* b;
  void* y;
  int N, H, W, Cin, CinP, Cout, CoutP;
  int t_len, fold, shift, act, vec;
};

template <class C>
__global__ void __launch_bounds__(kThreads, C::MIN_BLOCKS)
conv3x3_bf16_kernel(ConvArgs a) {
  PipeSrc s{static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.x2),
            static_cast<const bf16*>(a.w), a.H, a.W, a.Cin, a.CinP,
            a.t_len, a.fold, a.shift, a.vec};
  pipe_conv_block<C>(s, a.b, a.act, static_cast<bf16*>(a.y), a.H, a.W,
                     a.CoutP, a.Cout, a.Cout % 8 == 0,
                     [&](int n, int oy, int ox, int o) {
                       return (((long long)n * a.H + oy) * a.W + ox) *
                                  a.Cout + o;
                     });
}

// fp32: conv_common.cuh's FMA walk (8 x 16 tile, 64 channels a block).
__global__ void __launch_bounds__(kThreads) conv3x3_fma_kernel(ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* patch = reinterpret_cast<float*>(smem_raw);
  float* wsm = patch + (kTH + 2) * (kTW + 2) * kKS;

  const int tiles_x = (a.W + kTW - 1) / kTW;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int n0 = blockIdx.y * kBN, n = blockIdx.z;
  const int oy0 = ty * kTH, ox0 = tx * kTW;

  Src<float> s;
  s.x = static_cast<const float*>(a.x);
  s.x2 = static_cast<const float*>(a.x2);
  s.H = a.H; s.W = a.W; s.C = a.Cin;
  s.t_len = a.t_len; s.fold = a.fold; s.shift = a.shift; s.vec = a.vec;
  float acc[2][4][4];
  conv_region<float, 1, 2>(acc, s, static_cast<const float*>(a.w), a.CinP,
                           n0, n, oy0 - 1, ox0 - 1, kTH, kTW, patch, wsm);

  float* y = static_cast<float*>(a.y);
  const bool pair_ok = (a.Cout % 2) == 0;
  for_each_pair(acc, [&](int r, int c, float v0, float v1) {
    int oy = oy0 + r / kTW, ox = ox0 + r % kTW;
    int co = n0 + c;
    if (r >= kTH * kTW || oy >= a.H || ox >= a.W || co >= a.Cout) return;
    v0 = apply_act(v0 + a.b[co], a.act);
    v1 = apply_act(v1 + a.b[co + 1], a.act);
    long long off = (((long long)n * a.H + oy) * a.W + ox) * a.Cout + co;
    store2(y + off, v0, v1, co + 1 < a.Cout, pair_ok);
  });
}

template <class C>
static int launch_bf16(const ConvArgs& a, cudaStream_t stream) {
  return pipe_launch<C>(conv3x3_bf16_kernel<C>, a, a.H, a.W, a.CoutP, a.N,
                        stream);
}

static int launch(const ConvArgs& a, int bf16_path, cudaStream_t stream) {
  if (bf16_path) {
    const bool wide = a.CoutP % 128 == 0;
    if (a.x2)
      return wide ? launch_bf16<PipeCfg<1, 16, 128, 2, 4>>(a, stream)
                  : launch_bf16<PipeCfg<1, 16, 64, 2, 4>>(a, stream);
    return wide ? launch_bf16<PipeCfg<1, 16, 128, 1, 4>>(a, stream)
                : launch_bf16<PipeCfg<1, 16, 64, 1, 4>>(a, stream);
  }
  size_t smem = ((kTH + 2) * (kTW + 2) * kKS + kWTile) * sizeof(float);
  auto kern = conv3x3_fma_kernel;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(cdiv(a.H, kTH) * cdiv(a.W, kTW), a.CoutP / kBN, a.N);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bsvd

using bsvd::ConvArgs;

// dtype: 0 = float32, 1 = bfloat16. ``w``/``b`` packed, CinP % 16 == 0,
// CoutP % 64 == 0. Returns a cudaError_t code.
extern "C" int bsvd_conv3x3(int dtype, const void* x, const void* x2,
                            const void* w, const void* b, void* y, int N,
                            int H, int W, int Cin, int CinP, int Cout,
                            int CoutP, int t_len, int fold, int shift, int act,
                            int vec, void* stream) {
  ConvArgs a{x, x2, w, static_cast<const float*>(b), y, N, H, W, Cin, CinP,
             Cout, CoutP, t_len, fold, shift, act, vec};
  return bsvd::launch(a, dtype == 1, static_cast<cudaStream_t>(stream));
}

// Message of a cudaError_t code that an entry point above returned.
extern "C" const char* bsvd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
