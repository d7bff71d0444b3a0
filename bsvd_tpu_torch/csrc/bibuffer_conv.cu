// K5 bibuffer_multi and K6 bibuffer_chain: the streaming BiBufferConv steps.
//
// Every temporal conv of the streaming net carries one packed frame B per
// stream (bsvd_tpu/archs/streaming.py _bibuffer_init). Bidirectional:
// B = [left, center[f:]], f = C / fold_div; causal: the previous frame. One
// step's conv input and next state are pure channel slices of (x, B):
//
//   bidirectional  in = [x[:f], B[:f], B[2f:]]   B' = [B[f:2f], x[f:]]
//   causal         in = [B[:2f], x[2f:]]         B' = x
//
// K5 replaces bsvd_tpu/ops/bibuffer_conv.py bibuffer_conv_pallas ->
// _kernel_bibuf (F = 1) and bibuffer_multi_pallas -> _kernel_bibuf_multi
// (F >= 1 frames with the weights loaded once). Advanced F frames, frame i
// reads [x_i[:f], x_{i-2}[f:2f], x_{i-1}[2f:]]; frames 0 and 1 read the
// state: i = 0 -> [x_0[:f], B[:f], B[2f:]] (the past slice sits at B's
// lanes [:f], not [f:2f]), i = 1 -> [x_1[:f], B[f:2f], x_0[2f:]]. Causal:
// [x_{i-1}[:2f], x_i[2f:]] with x_{-1} = B. The next state is
// [x_{F-2}[f:2f], x_{F-1}[f:]] (F = 1: [B[f:2f], x_0[f:]]); causal x_{F-1}.
// The channel rule lives in the tile loader, so the assembled input never
// exists in device memory. bf16: K1's pipelined loop (conv_pipe.cuh
// pipe_conv_block) with its own loader source (BiPipeSrc: for frame z = i
// * N + stream and chunk c0, the base pointer of x_i, x_{i-1}, x_{i-2} or
// B, B's channel offset c0 - f in region 1 at i = 0; a chunk that
// straddles two regions, and every chunk without ``vec``, is read element
// by element). The tile follows the grid: 16 x 16 x 128 with a 4-stage
// ring (one block an SM) where it holds at least kBigTileWaves waves of
// those blocks on the device's SMs (push_block's F = 8: 16-31 waves), else
// K3's 8 x 16 x 128 with 2 stages (two blocks an SM: the one-frame sites
// of a push are 2-4 waves, and the second block hides each block's fill
// and epilogue); 64-channel blocks where CoutP is not a multiple of 128.
// fp32: conv_common.cuh's FMA walk (read_group below). Blocks run over
// (tile, channel block, frame x stream) in any order, so none may write B:
// the next state goes to a separate tensor, copied by the blocks of the
// first channel block of the last frame, each its own tile (a pure copy,
// bit-exact).
//
// K6 replaces bibuffer_chain_pallas -> _kernel_bibuf_chain: both buffered
// convs of a MemCvBlock. As K2 (conv_chain.cu), a block recomputes conv1
// on its tile plus a 1-pixel ring (10 x 18) from (x, s1) and keeps it in
// shared memory, rounded to the input type and zero outside the image.
// One pass then emits s2' = [s2[f2:2f2], y1[f2:]] (causal: y1) for the
// tile and overwrites the lanes conv2 takes from s2 ([f2:2f2] <- s2[:f2],
// [2f2:] <- s2[2f2:]; causal [:2f2] <- s2[:2f2]), so conv2 reads one
// assembled patch. s1' is K5's next-state copy.
//
// What bounds them on the H100: tensor-core FLOPs, as K1 / K2 (per frame
// 135x240x256 and 270x480x128 at the BSVD-c64 sites); the state copy adds
// one read and one write of a frame. K6 (still the synchronous
// conv_region, bf16 too) pays a halo recompute of conv1 (1.41x conv1's
// FLOPs, 1.5x as issued) to keep the intermediate out of device memory.

#include "conv_pipe.cuh"

namespace bsvd {

// Loader source of a buffered conv: frames x (F, N, H, W, C), state b
// (N, H, W, C). The loader's frame index n is i * N + stream.
template <typename T>
struct BiSrc {
  const T* x;
  const T* b;
  int N, H, W, C, fold, causal;
  int vec;          // C % 8 == 0, fold % 8 == 0, 16-byte aligned pointers
};

template <typename T>
__device__ __forceinline__ const T* frame_ptr(const BiSrc<T>& s, int j,
                                              int st, long long p) {
  return s.x + ((long long)j * s.N + st) * ((long long)s.H * s.W * s.C) + p;
}

// Channel c of pixel pix (y * W + x) of conv input frame i, stream st.
template <typename T>
__device__ __forceinline__ const T* bi_elem(const BiSrc<T>& s, int i, int st,
                                            long long pix, int c) {
  const long long p = pix * s.C;
  const T* b = s.b + (long long)st * s.H * s.W * s.C + p;
  const int f = s.fold;
  if (s.causal) {
    if (c < 2 * f) return i == 0 ? b + c : frame_ptr(s, i - 1, st, p) + c;
    return frame_ptr(s, i, st, p) + c;
  }
  if (c < f) return frame_ptr(s, i, st, p) + c;
  if (c < 2 * f) {
    if (i == 0) return b + (c - f);
    if (i == 1) return b + c;
    return frame_ptr(s, i - 2, st, p) + c;
  }
  return i == 0 ? b + c : frame_ptr(s, i - 1, st, p) + c;
}

// Channel c of the next packed state after F frames.
template <typename T>
__device__ __forceinline__ const T* bi_next(const BiSrc<T>& s, int F, int st,
                                            long long pix, int c) {
  const long long p = pix * s.C;
  if (s.causal || c >= s.fold) return frame_ptr(s, F - 1, st, p) + c;
  if (F == 1)
    return s.b + (long long)st * s.H * s.W * s.C + p + c + s.fold;
  return frame_ptr(s, F - 2, st, p) + c + s.fold;
}

__device__ __forceinline__ int bi_region(int c, int fold) {
  return c < fold ? 0 : (c < 2 * fold ? 1 : 2);
}

// Found by argument-dependent lookup from conv_common.cuh's load_patch.
template <typename T>
__device__ __forceinline__ void read_group(const BiSrc<T>& s, int n, int y,
                                           int x, int c0, float* v) {
  const int i = n / s.N, st = n - i * s.N;
  const long long pix = (long long)y * s.W + x;
  if (s.vec && c0 + 8 <= s.C &&
      bi_region(c0, s.fold) == bi_region(c0 + 7, s.fold)) {
    load8(bi_elem(s, i, st, pix, c0), v);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int c = c0 + j;
    v[j] = c < s.C ? to_f(*bi_elem(s, i, st, pix, c)) : 0.f;
  }
}

// Next packed state of stream st for the block's th x tw tile.
template <typename T>
__device__ void copy_next_state(T* bn, const BiSrc<T>& s, int F, int st,
                                int oy0, int ox0, int th, int tw) {
  const long long base = (long long)st * s.H * s.W * s.C;
  const int G = s.vec ? s.C / 8 : s.C;     // units per pixel
  for (int u = threadIdx.x; u < th * tw * G; u += kThreads) {
    int r = u / G, g = u - r * G;
    int oy = oy0 + r / tw, ox = ox0 + r % tw;
    if (oy >= s.H || ox >= s.W) continue;
    long long pix = (long long)oy * s.W + ox;
    if (s.vec) {
      copy8(bn + base + pix * s.C + g * 8, bi_next(s, F, st, pix, g * 8));
    } else {
      bn[base + pix * s.C + g] = *bi_next(s, F, st, pix, g);
    }
  }
}

// K5's loader source on the pipelined loop (conv_pipe.cuh pipe_load).
struct BiPipeSrc : BiSrc<bf16> {
  const bf16* w;     // packed (CoutP, 3, 3, CinP)
  int CinP;

  // Channels c0..c0+7 of conv input frame z = i * N + stream, by bi_elem's
  // rule: one tensor frame and channel offset for the whole slice.
  __device__ __forceinline__ PipeChunk chunk(int z, int c0) const {
    const int i = z / N, st = z - i * N, f = fold;
    const long long fr = (long long)H * W * C;
    const bf16* bst = b + st * fr;
    const bf16* xi = x + ((long long)i * N + st) * fr;     // x_i
    const bf16* p;
    int c = c0;
    if (causal) {
      p = c0 >= 2 * f ? xi : (i == 0 ? bst : xi - N * fr);
    } else if (c0 < f) {
      p = xi;
    } else if (c0 < 2 * f) {
      p = i <= 1 ? bst : xi - 2 * N * fr;
      if (i == 0) c = c0 - f;
    } else {
      p = i == 0 ? bst : xi - N * fr;
    }
    return {p, nullptr, c, c0 < C,
            vec && bi_region(c0, f) == bi_region(c0 + 7, f)};
  }

  // Element by element (a chunk that straddles two regions, or no vec):
  // each channel by chunk()'s rule.
  template <int NX, int P>
  __device__ __forceinline__ void elems8(bf16* dst, int z, int y, int xx,
                                         int c0, bool in) const {
    const long long pix = ((long long)y * W + xx) * C;
#pragma unroll 1
    for (int j = 0; j < 8; ++j) {
      const PipeChunk e = chunk(z, c0 + j);
      dst[j] = in && e.live ? e.x[e.base + pix] : __float2bfloat16(0.f);
    }
  }
};

// ---- K5 -------------------------------------------------------------------

struct BiArgs {
  const void* x;
  const void* b;
  const void* w;
  const float* bias;
  void* y;
  void* bn;
  int F, N, H, W, C, CinP, Cout, CoutP, fold, causal, act, vec;
};

template <typename T>
__device__ __forceinline__ BiSrc<T> bi_src(const void* x, const void* b,
                                           int N, int H, int W, int C,
                                           int fold, int causal, int vec) {
  BiSrc<T> s;
  s.x = static_cast<const T*>(x);
  s.b = static_cast<const T*>(b);
  s.N = N; s.H = H; s.W = W; s.C = C;
  s.fold = fold; s.causal = causal; s.vec = vec;
  return s;
}

template <class C>
__global__ void __launch_bounds__(kThreads, C::MIN_BLOCKS)
bibuf_bf16_kernel(BiArgs a) {
  BiPipeSrc s;
  static_cast<BiSrc<bf16>&>(s) = bi_src<bf16>(a.x, a.b, a.N, a.H, a.W, a.C,
                                              a.fold, a.causal, a.vec);
  s.w = static_cast<const bf16*>(a.w);
  s.CinP = a.CinP;
  pipe_conv_block<C>(s, a.bias, a.act, static_cast<bf16*>(a.y), a.H, a.W,
                     a.CoutP, a.Cout, a.Cout % 8 == 0,
                     [&](int z, int oy, int ox, int o) {
                       return (((long long)z * a.H + oy) * a.W + ox) *
                                  a.Cout + o;
                     });
  const PipeBlock blk = pipe_block<C>(a.W, a.CoutP);
  const int i = blk.n / a.N;
  if (blk.n0 == 0 && i == a.F - 1)
    copy_next_state(static_cast<bf16*>(a.bn), s, a.F, blk.n - i * a.N,
                    blk.oy0, blk.ox0, C::TH, C::TW);
}

// fp32: conv_common.cuh's FMA walk (8 x 16 tile, 64 channels a block).
__global__ void __launch_bounds__(kThreads) bibuf_fma_kernel(BiArgs a) {
  using T = float;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* patch = reinterpret_cast<T*>(smem_raw);
  T* wsm = patch + (kTH + 2) * (kTW + 2) * kKS;

  const int tiles_x = (a.W + kTW - 1) / kTW;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int n0 = blockIdx.y * kBN, z = blockIdx.z;   // z = i * N + stream
  const int oy0 = ty * kTH, ox0 = tx * kTW;
  const BiSrc<T> s = bi_src<T>(a.x, a.b, a.N, a.H, a.W, a.C, a.fold,
                               a.causal, a.vec);

  float acc[2][4][4];
  conv_region<T, 1, 2>(acc, s, static_cast<const T*>(a.w), a.CinP, n0, z,
                       oy0 - 1, ox0 - 1, kTH, kTW, patch, wsm);

  T* y = static_cast<T*>(a.y);
  const bool pair_ok = (a.Cout % 2) == 0;
  for_each_pair(acc, [&](int r, int c, float v0, float v1) {
    int oy = oy0 + r / kTW, ox = ox0 + r % kTW;
    int co = n0 + c;
    if (r >= kTH * kTW || oy >= a.H || ox >= a.W || co >= a.Cout) return;
    v0 = apply_act(v0 + a.bias[co], a.act);
    v1 = apply_act(v1 + a.bias[co + 1], a.act);
    long long off = (((long long)z * a.H + oy) * a.W + ox) * a.Cout + co;
    store2(y + off, v0, v1, co + 1 < a.Cout, pair_ok);
  });

  const int i = z / a.N;
  if (blockIdx.y == 0 && i == a.F - 1)
    copy_next_state(static_cast<T*>(a.bn), s, a.F, z - i * a.N, oy0, ox0,
                    kTH, kTW);
}

template <class C>
static int launch_bibuf_pipe(const BiArgs& a, cudaStream_t stream) {
  return pipe_launch<C>(bibuf_bf16_kernel<C>, a, a.H, a.W, a.CoutP,
                        a.F * a.N, stream);
}

// The grid, in waves of 16 x 16 x 128 blocks one an SM, from which that
// tile beats 8 x 16 x 128 at two an SM (tools/torch_kernel_variants.py
// --group k5; PERF.md).
constexpr int kBigTileWaves = 8;

static int launch_bibuf(const BiArgs& a, int bf16_path, cudaStream_t stream) {
  if (bf16_path) {
    if (a.CoutP % 128 != 0)
      return launch_bibuf_pipe<PipeCfg<1, 16, 64, 1, 4>>(a, stream);
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const long long blocks = (long long)cdiv(a.H, 16) * cdiv(a.W, 16) *
                             (a.CoutP / 128) * a.F * a.N;
    return blocks >= (long long)kBigTileWaves * sms
               ? launch_bibuf_pipe<PipeCfg<1, 16, 128, 1, 4>>(a, stream)
               : launch_bibuf_pipe<PipeCfg<1, 8, 128, 1, 2>>(a, stream);
  }
  using T = float;
  size_t smem = ((kTH + 2) * (kTW + 2) * kKS + kWTile) * sizeof(T);
  auto kern = bibuf_fma_kernel;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(cdiv(a.H, kTH) * cdiv(a.W, kTW), a.CoutP / kBN, a.F * a.N);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- K6 -------------------------------------------------------------------

struct BiChainArgs {
  const void* x;
  const void* s1;
  const void* s2;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  void* y;
  void* s1n;
  void* s2n;
  int N, H, W, C, CinP, C1, C1P, Cout, CoutP, fold1, fold2, causal, act1,
      act2, vec;
};

constexpr int kBRH = kTH + 2, kBRW = kTW + 2;      // conv1 region
constexpr int kBPH = kBRH + 2, kBPW = kBRW + 2;    // conv1 input patch
constexpr int kBMT1 = 3;                           // 4 * 3 * 16 = 192 >= 180

template <typename T>
__global__ void __launch_bounds__(kThreads) bibuf_chain_kernel(BiChainArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* patch = reinterpret_cast<T*>(smem_raw);
  T* wsm = patch + kBPH * kBPW * kKS;
  T* interm = wsm + kWTile;
  const int IS = a.C1P + 8;          // intermediate pixel stride

  const int tiles_x = (a.W + kTW - 1) / kTW;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int st = blockIdx.z;
  const int oy0 = ty * kTH, ox0 = tx * kTW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const BiSrc<T> s = bi_src<T>(a.x, a.s1, a.N, a.H, a.W, a.C, a.fold1,
                               a.causal, a.vec);

  // ---- conv1 on the 10 x 18 region at image (oy0 - 1, ox0 - 1) ----
  for (int n1 = 0; n1 < a.C1P; n1 += kBN) {
    float acc[kBMT1][4][4];
    conv_region<T, 1, kBMT1>(acc, s, static_cast<const T*>(a.w1), a.CinP,
                             n1, st, oy0 - 2, ox0 - 2, kBRH, kBRW, patch,
                             wsm);
    for_each_pair(acc, [&](int r, int c, float v0, float v1) {
      if (r >= kBRH * kBRW) return;
      int gy = oy0 - 1 + r / kBRW, gx = ox0 - 1 + r % kBRW;
      int ch = n1 + c;
      bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
      v0 = inside ? apply_act(v0 + a.b1[ch], a.act1) : 0.f;
      v1 = inside ? apply_act(v1 + a.b1[ch + 1], a.act1) : 0.f;
      interm[r * IS + ch] = from_f<T>(v0);
      interm[r * IS + ch + 1] = from_f<T>(v1);
    });
  }
  __syncthreads();

  // ---- s2' for the tile, then conv2's input lanes from s2 ----
  const T* s2 = static_cast<const T*>(a.s2);
  T* s2n = static_cast<T*>(a.s2n);
  const int f2 = a.fold2;
  for (int e = threadIdx.x; e < kBRH * kBRW * a.C1; e += kThreads) {
    int r = e / a.C1, c = e - r * a.C1;
    int ry = r / kBRW, rx = r - ry * kBRW;
    int gy = oy0 - 1 + ry, gx = ox0 - 1 + rx;
    bool inside = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
    long long pix = ((long long)st * a.H + gy) * a.W + gx;
    T* ip = interm + r * IS + c;
    if (inside && ry >= 1 && ry <= kTH && rx >= 1 && rx <= kTW)
      s2n[pix * a.C1 + c] =
          (a.causal || c >= f2) ? *ip : s2[pix * a.C1 + c + f2];
    int src = a.causal ? (c < 2 * f2 ? c : -1)
                       : (c < f2 ? -1 : (c < 2 * f2 ? c - f2 : c));
    if (src >= 0) *ip = inside ? s2[pix * a.C1 + src] : from_f<T>(0.f);
  }

  // ---- conv2 on the 8 x 16 tile, reading the assembled patch ----
  int abase[2][2];
  row_bases(abase, wm, lane, kTH * kTW, kTW, 1, kBRW);
  T* y = static_cast<T*>(a.y);
  const bool pair_ok = (a.Cout % 2) == 0;
  for (int n2 = 0; n2 < a.CoutP; n2 += kBN) {
    float acc[2][4][4];
    zero_acc(acc);
    for (int k0 = 0; k0 < a.C1P; k0 += kKC) {
      __syncthreads();      // patch assembled / previous weights consumed
      load_weights(wsm, static_cast<const T*>(a.w2), a.C1P, n2, k0);
      __syncthreads();
      mma_slice(acc, interm, IS, k0, abase, kBRW, wsm, wn, lane);
    }
    for_each_pair(acc, [&](int r, int c, float v0, float v1) {
      int oy = oy0 + r / kTW, ox = ox0 + r % kTW;
      int co = n2 + c;
      if (oy >= a.H || ox >= a.W || co >= a.Cout) return;
      v0 = apply_act(v0 + a.b2[co], a.act2);
      v1 = apply_act(v1 + a.b2[co + 1], a.act2);
      long long pix = ((long long)st * a.H + oy) * a.W + ox;
      store2(y + pix * a.Cout + co, v0, v1, co + 1 < a.Cout, pair_ok);
    });
  }

  copy_next_state(static_cast<T*>(a.s1n), s, 1, st, oy0, ox0, kTH, kTW);
}

template <typename T>
static size_t bichain_smem(int C1P) {
  return ((size_t)kBPH * kBPW * kKS + kWTile +
          (size_t)kBRH * kBRW * (C1P + 8)) * sizeof(T);
}

template <typename T>
static int launch_bichain(const BiChainArgs& a, cudaStream_t stream) {
  size_t smem = bichain_smem<T>(a.C1P);
  auto kern = bibuf_chain_kernel<T>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(cdiv(a.H, kTH) * cdiv(a.W, kTW), 1, a.N);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bsvd

// dtype: 0 = float32, 1 = bfloat16. x (F, N, H, W, C), b / bn (N, H, W, C),
// y (F, N, H, W, Cout). Returns a cudaError_t code.
extern "C" int bsvd_bibuffer(int dtype, const void* x, const void* b,
                             const void* w, const void* bias, void* y,
                             void* bn, int F, int N, int H, int W, int C,
                             int CinP, int Cout, int CoutP, int fold,
                             int causal, int act, int vec, void* stream) {
  bsvd::BiArgs a{x, b, w, static_cast<const float*>(bias), y, bn, F, N, H,
                 W, C, CinP, Cout, CoutP, fold, causal, act, vec};
  return bsvd::launch_bibuf(a, dtype == 1, static_cast<cudaStream_t>(stream));
}

// x / s1 / s1n (N, H, W, C), s2 / s2n (N, H, W, C1), y (N, H, W, Cout).
extern "C" int bsvd_bibuffer_chain(int dtype, const void* x, const void* s1,
                                   const void* s2, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* y, void* s1n,
                                   void* s2n, int N, int H, int W, int C,
                                   int CinP, int C1, int C1P, int Cout,
                                   int CoutP, int fold1, int fold2,
                                   int causal, int act1, int act2, int vec,
                                   void* stream) {
  bsvd::BiChainArgs a{x, s1, s2, w1, static_cast<const float*>(b1), w2,
                      static_cast<const float*>(b2), y, s1n, s2n, N, H, W, C,
                      CinP, C1, C1P, Cout, CoutP, fold1, fold2, causal, act1,
                      act2, vec};
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? bsvd::launch_bichain<bsvd::bf16>(a, s)
                    : bsvd::launch_bichain<float>(a, s);
}
