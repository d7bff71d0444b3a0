// K2 conv_chain: act2(conv2(act1(conv1(x [+ x2])))) in one kernel, with an
// optional residual epilogue out[..., c] = x_res[..., c] - y[..., c] for
// c < rc. NHWC, both convs 3x3 stride 1 pad 1.
//
// Replaces bsvd_tpu/ops/conv_chain.py conv_chain_pallas -> _kernel_chain
// (the WNet inc pair and the outc pair with its skip-add and the per-stage
// residual). The TPU kernel walks row blocks in order and keeps a rolling
// 3-slot ring of the intermediate; blocks here run in parallel, so each
// block recomputes conv1 on its tile plus a 1-pixel ring (10 x 18 pixels
// for an 8 x 16 output tile) and keeps that intermediate in shared memory,
// rounded to the input type as the TPU kernel does. The intermediate never
// reaches device memory. The ring costs (10*18)/(8*16) = 1.41x conv1's
// FLOPs (conv1 runs as 12 m16 tiles for 180 pixels: 1.5x issued).
// Intermediate pixels outside the image are zero: conv2 pads with zeros.
//
// The residual is the natural-layout rule: the first rc channels of the
// output are x_res[..., c] - y[..., c], x_res being the stage input with
// its own channel count. Small channel counts (Cin = 4, Cout = 3) are zero
// padded in shared memory / in the packed weights.
//
// What bounds it on the H100: tensor-core FLOPs (64 -> 64 -> 64 at
// 540x960); the halo recompute is the price of keeping the intermediate
// out of device memory, which would otherwise be written and read back
// once (2 x 66 MB per 540p frame group).

#include "conv_common.cuh"

namespace bsvd {

struct ChainArgs {
  const void* x;
  const void* x2;
  const void* xres;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  void* y;
  int N, H, W, Cin, CinP, C1, C1P, Cout, CoutP, Cres, rc, act1, act2, vec;
};

constexpr int kRH = kTH + 2, kRW = kTW + 2;      // conv1 region
constexpr int kPH = kRH + 2, kPW = kRW + 2;      // conv1 input patch
constexpr int kMT1 = 3;                          // 4 * 3 * 16 = 192 >= 180

template <typename T>
__global__ void __launch_bounds__(kThreads) conv_chain_kernel(ChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* patch = reinterpret_cast<T*>(smem_raw);
  T* wsm = patch + kPH * kPW * kKS;
  T* interm = wsm + kWTile;
  const int IS = a.C1P + 8;          // intermediate pixel stride

  const int tiles_x = (a.W + kTW - 1) / kTW;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int n = blockIdx.z;
  const int oy0 = ty * kTH, ox0 = tx * kTW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;

  Src<T> s;
  s.x = static_cast<const T*>(a.x);
  s.x2 = static_cast<const T*>(a.x2);
  s.H = a.H; s.W = a.W; s.C = a.Cin;
  s.t_len = 1; s.fold = 0; s.shift = kShiftNone; s.vec = a.vec;

  // ---- conv1 on the 10 x 18 region at image (oy0 - 1, ox0 - 1) ----
  for (int n1 = 0; n1 < a.C1P; n1 += kBN) {
    float acc[kMT1][4][4];
    conv_region<T, 1, kMT1>(acc, s, static_cast<const T*>(a.w1), a.CinP, n1,
                            n, oy0 - 2, ox0 - 2, kRH, kRW, patch, wsm);
    for_each_pair(acc, [&](int r, int c, float v0, float v1) {
      if (r >= kRH * kRW) return;
      int gy = oy0 - 1 + r / kRW, gx = ox0 - 1 + r % kRW;
      int ch = n1 + c;
      bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      v0 = inside ? apply_act(v0 + a.b1[ch], a.act1) : 0.f;
      v1 = inside ? apply_act(v1 + a.b1[ch + 1], a.act1) : 0.f;
      interm[r * IS + ch] = from_f<T>(v0);
      interm[r * IS + ch + 1] = from_f<T>(v1);
    });
  }

  // ---- conv2 on the 8 x 16 tile, reading the intermediate ----
  int abase[2][2];
  row_bases(abase, wm, lane, kTH * kTW, kTW, 1, kRW);
  const int C2inP = a.C1P;   // w2 is packed with CinP = C1P
  T* y = static_cast<T*>(a.y);
  const T* xres = static_cast<const T*>(a.xres);
  const bool pair_ok = (a.Cout % 2) == 0;
  for (int n2 = 0; n2 < a.CoutP; n2 += kBN) {
    float acc[2][4][4];
    zero_acc(acc);
    for (int k0 = 0; k0 < C2inP; k0 += kKC) {
      __syncthreads();      // interm written / previous weights consumed
      load_weights(wsm, static_cast<const T*>(a.w2), C2inP, n2, k0);
      __syncthreads();
      mma_slice(acc, interm, IS, k0, abase, kRW, wsm, wn, lane);
    }
    for_each_pair(acc, [&](int r, int c, float v0, float v1) {
      int oy = oy0 + r / kTW, ox = ox0 + r % kTW;
      int co = n2 + c;
      if (oy >= a.H || ox >= a.W || co >= a.Cout) return;
      v0 = apply_act(v0 + a.b2[co], a.act2);
      v1 = apply_act(v1 + a.b2[co + 1], a.act2);
      long long pix = ((long long)n * a.H + oy) * a.W + ox;
      if (co < a.rc) v0 = to_f(xres[pix * a.Cres + co]) - v0;
      if (co + 1 < a.rc) v1 = to_f(xres[pix * a.Cres + co + 1]) - v1;
      store2(y + pix * a.Cout + co, v0, v1, co + 1 < a.Cout, pair_ok);
    });
  }
}

template <typename T>
static size_t chain_smem(int C1P) {
  return ((size_t)kPH * kPW * kKS + kWTile + (size_t)kRH * kRW * (C1P + 8)) *
         sizeof(T);
}

template <typename T>
static int launch_chain(const ChainArgs& a, cudaStream_t stream) {
  size_t smem = chain_smem<T>(a.C1P);
  auto kern = conv_chain_kernel<T>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(cdiv(a.H, kTH) * cdiv(a.W, kTW), 1, a.N);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bsvd

// dtype: 0 = float32, 1 = bfloat16. x2 / xres may be null (rc = 0 then).
extern "C" int bsvd_conv_chain(int dtype, const void* x, const void* x2,
                               const void* xres, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               void* y, int N, int H, int W, int Cin, int CinP,
                               int C1, int C1P, int Cout, int CoutP, int Cres,
                               int rc, int act1, int act2, int vec,
                               void* stream) {
  bsvd::ChainArgs a{x, x2, xres, w1, static_cast<const float*>(b1), w2,
                    static_cast<const float*>(b2), y, N, H, W, Cin, CinP, C1,
                    C1P, Cout, CoutP, Cres, rc, act1, act2, vec};
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? bsvd::launch_chain<bsvd::bf16>(a, s)
                    : bsvd::launch_chain<float>(a, s);
}
