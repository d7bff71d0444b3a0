// K3 conv_s2: stride-2 3x3 conv (torch padding 1) + bias + act, NHWC.
//
// Replaces bsvd_tpu/ops/conv_s2.py conv_s2_pallas -> _kernel_s2. The TPU
// kernel runs on the width-folded (H, W/2, 2C) view with (3, 2, 2C, Cout)
// weights because Mosaic has no strided reads or sub-128-lane copies; none
// of that applies here. This kernel is the natural stride-2 conv: a block
// computes an 8 x 16 output tile from a 17 x 33 input patch in shared
// memory, reading the patch at stride 2 in the tap loop.
//
// What bounds it on the H100: tensor-core FLOPs (the BSVD-c64 sites are
// 64 -> 128 at 540x960 and 128 -> 256 at 270x480). A quarter of the patch
// pixels are reused by neighbouring taps, the rest once per tap, so the
// shared-memory reads per MAC are the same as K1's. Output rows of the tile
// are independent, so nothing is recomputed.

#include "conv_common.cuh"

namespace bsvd {

struct S2Args {
  const void* x;
  const void* w;
  const float* b;
  void* y;
  int N, H, W, Cin, CinP, Cout, CoutP, Ho, Wo, act, vec;
};

constexpr int kS2PH = (kTH - 1) * 2 + 3;
constexpr int kS2PW = (kTW - 1) * 2 + 3;

template <typename T>
__global__ void __launch_bounds__(kThreads) conv_s2_kernel(S2Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* patch = reinterpret_cast<T*>(smem_raw);
  T* wsm = patch + kS2PH * kS2PW * kKS;

  const int tiles_x = (a.Wo + kTW - 1) / kTW;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int n0 = blockIdx.y * kBN, n = blockIdx.z;
  const int oy0 = ty * kTH, ox0 = tx * kTW;

  Src<T> s;
  s.x = static_cast<const T*>(a.x);
  s.x2 = nullptr;
  s.H = a.H; s.W = a.W; s.C = a.Cin;
  s.t_len = 1; s.fold = 0; s.shift = kShiftNone; s.vec = a.vec;

  float acc[2][4][4];
  conv_region<T, 2, 2>(acc, s, static_cast<const T*>(a.w), a.CinP, n0, n,
                       2 * oy0 - 1, 2 * ox0 - 1, kTH, kTW, patch, wsm);

  T* y = static_cast<T*>(a.y);
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

template <typename T>
static int launch_s2(const S2Args& a, cudaStream_t stream) {
  size_t smem = (kS2PH * kS2PW * kKS + kWTile) * sizeof(T);
  auto kern = conv_s2_kernel<T>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(cdiv(a.Ho, kTH) * cdiv(a.Wo, kTW), a.CoutP / kBN, a.N);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bsvd

extern "C" int bsvd_conv_s2(int dtype, const void* x, const void* w,
                            const void* b, void* y, int N, int H, int W,
                            int Cin, int CinP, int Cout, int CoutP, int act,
                            int vec, void* stream) {
  bsvd::S2Args a{x, w, static_cast<const float*>(b), y, N, H, W, Cin, CinP,
                 Cout, CoutP, (H - 1) / 2 + 1, (W - 1) / 2 + 1, act, vec};
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? bsvd::launch_s2<bsvd::bf16>(a, s)
                    : bsvd::launch_s2<float>(a, s);
}
