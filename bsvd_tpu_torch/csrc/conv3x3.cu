// K1 conv3x3 and K4 conv_ps: stride-1 3x3 conv + bias (+ act), NHWC.
//
// K1 replaces bsvd_tpu/ops/conv3x3.py conv3x3_pallas -> _kernel (reached
// through ops/shift_conv.py shift_conv / shift_conv_add2; the same function
// as the generation-1 _shift_conv_fused_v1). The temporal shift happens in
// the tile loader: each input channel is read from frame t+1, t-1 or t, or
// is zero at a clip edge (t % t_len), so the shifted tensor never exists in
// device memory; an optional second input is summed as it is loaded.
//
// K4 replaces conv3x3.py conv_ps_natural_pallas and conv_ps_fold_pallas
// (the same _kernel with the ps_nat / ps_half epilogues): conv + bias, then
// an r=2 pixel shuffle written by the epilogue, output channel
// o = k*4 + di*2 + dj going to out[n, 2i+di, 2j+dj, k] (torch PixelShuffle
// order). The width-folded write of ps_fold is TPU layout and is dropped.
//
// What bounds it on the H100: tensor-core FLOPs. At the BSVD-c64 sites
// (C = 128/256 at 270x480 / 135x240) a block does 9 * 16 * 64 MACs per
// input element it loads from L2 / HBM for each 16-channel slice, far
// above the ~295 FLOP/byte ridge. The design feeds mma.sync from shared
// memory and keeps the whole output tile's fp32 accumulators in registers;
// weights are reloaded per 16-channel slice (from L2) and input patches
// per 64-channel output group. Not yet done: multi-stage cp.async / TMA
// pipelining and wgmma, which the later speed PRs add.

#include "conv_common.cuh"

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

template <typename T>
__device__ __forceinline__ Src<T> make_src(const ConvArgs& a) {
  Src<T> s;
  s.x = static_cast<const T*>(a.x);
  s.x2 = static_cast<const T*>(a.x2);
  s.H = a.H; s.W = a.W; s.C = a.Cin;
  s.t_len = a.t_len; s.fold = a.fold; s.shift = a.shift; s.vec = a.vec;
  return s;
}

// PS = false: K1 (plain NHWC output); PS = true: K4 (pixel-shuffled).
template <typename T, bool PS>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* patch = reinterpret_cast<T*>(smem_raw);
  T* wsm = patch + (kTH + 2) * (kTW + 2) * kKS;

  const int tiles_x = (a.W + kTW - 1) / kTW;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int n0 = blockIdx.y * kBN, n = blockIdx.z;
  const int oy0 = ty * kTH, ox0 = tx * kTW;

  float acc[2][4][4];
  conv_region<T, 1, 2>(acc, make_src<T>(a), static_cast<const T*>(a.w),
                       a.CinP, n0, n, oy0 - 1, ox0 - 1, kTH, kTW, patch, wsm);

  T* y = static_cast<T*>(a.y);
  const bool pair_ok = (a.Cout % 2) == 0;
  for_each_pair(acc, [&](int r, int c, float v0, float v1) {
    int oy = oy0 + r / kTW, ox = ox0 + r % kTW;
    int co = n0 + c;
    if (r >= kTH * kTW || oy >= a.H || ox >= a.W || co >= a.Cout) return;
    v0 = apply_act(v0 + a.b[co], a.act);
    v1 = apply_act(v1 + a.b[co + 1], a.act);
    if (!PS) {
      long long off = (((long long)n * a.H + oy) * a.W + ox) * a.Cout + co;
      store2(y + off, v0, v1, co + 1 < a.Cout, pair_ok);
    } else {
      // channels co, co+1 (co even) share k = co/4 and di, and are dj = 0, 1
      const int c4 = a.Cout / 4;
      int k = co >> 2, di = (co >> 1) & 1;
      long long base = (((long long)n * 2 * a.H + 2 * oy + di) * 2 * a.W +
                        2 * ox) * c4 + k;
      y[base] = from_f<T>(v0);
      y[base + c4] = from_f<T>(v1);
    }
  });
}

template <typename T, bool PS>
static int launch(const ConvArgs& a, cudaStream_t stream) {
  size_t smem = ((kTH + 2) * (kTW + 2) * kKS + kWTile) * sizeof(T);
  auto kern = conv3x3_kernel<T, PS>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(cdiv(a.H, kTH) * cdiv(a.W, kTW), a.CoutP / kBN, a.N);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bsvd

using bsvd::ConvArgs;

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code.
extern "C" int bsvd_conv3x3(int dtype, const void* x, const void* x2,
                            const void* w, const void* b, void* y, int N,
                            int H, int W, int Cin, int CinP, int Cout,
                            int CoutP, int t_len, int fold, int shift, int act,
                            int vec, void* stream) {
  ConvArgs a{x, x2, w, static_cast<const float*>(b), y, N, H, W, Cin, CinP,
             Cout, CoutP, t_len, fold, shift, act, vec};
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? bsvd::launch<bsvd::bf16, false>(a, s)
                    : bsvd::launch<float, false>(a, s);
}

extern "C" int bsvd_conv_ps(int dtype, const void* x, const void* w,
                            const void* b, void* y, int N, int H, int W,
                            int Cin, int CinP, int Cout, int CoutP, int vec,
                            void* stream) {
  ConvArgs a{x, nullptr, w, static_cast<const float*>(b), y, N, H, W, Cin,
             CinP, Cout, CoutP, 1, 0, bsvd::kShiftNone, bsvd::kActNone, vec};
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? bsvd::launch<bsvd::bf16, true>(a, s)
                    : bsvd::launch<float, true>(a, s);
}

// Message of a cudaError_t code that an entry point above returned.
extern "C" const char* bsvd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
