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
// bit-exact). What bounds K5 on the H100: tensor-core FLOPs, as K1's (per
// frame 135x240x256 and 270x480x128 at the BSVD-c64 sites); the state copy
// adds one read and one write of a frame.
//
// K6 replaces bibuffer_chain_pallas -> _kernel_bibuf_chain: both buffered
// convs of a MemCvBlock, y1, s1' = bibuf(x, s1, w1); y, s2' = bibuf(y1, s2,
// w2), y1 kept out of device memory as a conv input. Blocks run in
// parallel, so a block recomputes conv1 on its tile's 1-pixel ring; the TPU
// kernel's row walk (a rolling 3-row ring of y1, no recompute) is not
// taken: it needs the grid to run in order, and filling 132 SMs at one
// frame leaves each strip a few rows, whose first rows it pays again.
//
// The lane rule: conv2 reads only some lanes of y1. Bidirectional, its
// input is [y1[:f2], s2[:f2], s2[2f2:]] (f2 = C1 / fold): 16 of 128 or 32
// of 256 lanes; causal [s2[:2f2], y1[2f2:]], 3/4 of them. The other lanes
// of y1 are needed on the tile alone, where they become s2' = [s2[f2:2f2],
// y1[f2:]] (causal y1). So only conv1's 64-channel blocks holding conv2's
// lanes ("halo blocks") run on the (TH + 2) x 32 region and stay in shared
// memory (bidirectional one block; causal all at 128 channels, 3 of 4 at
// 256); the others run on the TH x 32 tile rows and go straight to s2'.
// conv2 reads y1 from shared memory and s2's lanes through the ring by the
// s2 rule; a 16-channel slice straddling y1 and s2 lanes (fold 5, ragged
// C1) is assembled in the stage chunk by chunk or element by element.
// s1' is K5's copy, s2''s lanes from s2 a copy of s2[f2:2f2]: bit-exact.
// bf16 y1 and y are rounded where K5 rounds them and summed in K5's slice
// and tap order, so bf16 K6 is bit-equal to two K5 steps.
//
// What bounds it: tensor-core FLOPs, 76.4 GFLOP a site (270x480x128 and
// 135x240x256 alike), 0.077 ms at 989 TFLOP/s. With the lane rule the
// 6 x 30 tiles issue 2.31 (128) and 2.22 (256) conv units bidirectional,
// 2.49 / 2.40 causal (a halo block 8 x 32 pixels for 6 x 30, a tile block
// or conv2 6 x 32), against two K5 steps' 2.0 and the first K6's 2.5
// (conv_region's synchronous walk, every channel on a 10 x 18 ring, the s2
// lanes copied over the intermediate element by element). Tiles of 6 x 30
// (720 / 184 blocks at the two sites), a 2-stage ring, two blocks an SM
// where the intermediate fits (bidirectional). Timed on an NVIDIA H100
// 80GB HBM3 at 700.00 W (tools/torch_kernel_variants.py --group k6, ms a
// bidirectional site at 270x480x128 / 135x240x256, min-max of 6 runs;
// PERF.md): 6 x 30 0.53-0.59 / 0.55-0.65. Dropped: 8 x 30 0.71-0.75 /
// 0.73-0.77 (544 / 136 blocks; 1796 bytes of spill loads at two blocks an
// SM); 4 x 30 0.57-0.68 / 0.72-0.77 (272 blocks at 135x240: 1.03 waves);
// every block of conv1 on the ring (no lane rule) 0.75-0.78 / 0.79-0.80;
// one block an SM, no register cap 0.85-0.87 / 0.80; a 3-stage ring
// 0.88-0.90 / 0.80-0.82. Two K5 steps take 0.35-0.41 / 0.33-0.35, so the
// streaming route (archs/streaming.py chain_route) keeps K6 off the push.

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
      act2, vec, vec2;
};

// The lane rule. Channel c of conv2's input is y1[c] (region 0), s2[c - f2]
// (1), s2[c] (2) or padding past C1 (3); y1 lane c is s2' lane c where
// to_s2n. conv1's 64-channel blocks hb0 .. hb0 + nh - 1 hold every y1 lane
// that conv2 reads: only these "halo blocks" run on the tile's 1-pixel ring
// and stay in shared memory; the others run on the tile alone.
struct ChainLanes {
  int C1, f2, causal, hb0, nh;

  __device__ __forceinline__ int region(int c) const {
    if (c >= C1) return 3;
    if (causal) return c < 2 * f2 ? 2 : 0;
    return c < f2 ? 0 : (c < 2 * f2 ? 1 : 2);
  }
  __device__ __forceinline__ bool to_s2n(int c) const {
    return c < C1 && (causal || c >= f2);
  }
  __device__ __forceinline__ bool halo(int b1) const {
    return b1 >= hb0 && b1 < hb0 + nh;
  }
  // conv2's 16-channel K slice at k0 holds y1 lanes only (or y1 and the
  // zero padding that conv1 computed beside them): A from the intermediate
  __device__ __forceinline__ bool mid_slice(int k0) const {
    return causal ? k0 >= 2 * f2 : k0 + 16 <= f2;
  }
};

// The halo blocks of conv1's blk-channel blocks: bidirectional, those of
// y1[:f2]; causal, those of y1[2f2:].
static ChainLanes chain_lanes(const BiChainArgs& a, int blk) {
  const int nb1 = a.C1P / blk;
  const int lo = 2 * a.fold2 / blk, hi = cdiv(a.fold2, blk);
  ChainLanes ln;
  ln.C1 = a.C1;
  ln.f2 = a.fold2;
  ln.causal = a.causal;
  ln.hb0 = a.causal ? (lo < nb1 ? lo : nb1) : 0;
  ln.nh = a.causal ? nb1 - ln.hb0 : (hi < nb1 ? hi : nb1);
  return ln;
}

// Bidirectional s2' lanes [0, f2) = s2[f2:2f2] of the th x tw tile at
// (oy0, ox0): a bit-exact copy, 16 bytes at a time where vec2.
template <typename T>
__device__ void copy_s2_lanes(T* s2n, const T* s2, const BiChainArgs& a,
                              int st, int oy0, int ox0, int th, int tw) {
  const int f2 = a.fold2, G = a.vec2 ? f2 / 8 : f2;
  for (int u = threadIdx.x; u < th * tw * G; u += kThreads) {
    const int r = u / G, g = u - r * G;
    const int oy = oy0 + r / tw, ox = ox0 + r % tw;
    if (oy >= a.H || ox >= a.W) continue;
    const long long p = (((long long)st * a.H + oy) * a.W + ox) * a.C1;
    if (a.vec2) {
      copy8(s2n + p + g * 8, s2 + p + f2 + g * 8);
    } else {
      s2n[p + g] = s2[p + f2 + g];
    }
  }
}

// bf16 on conv_pipe.cuh's ring. A block owns a TH x 30 output tile of one
// stream and every channel; its conv1 region (the intermediate's shape) is
// the tile and its 1-pixel ring, (TH + 2) x 32. One ring carries every
// step: conv1's slices (input patch + w1 rows; K5's loader source over (x,
// s1)) for each 64-channel block of y1, a halo block's on the region and
// any other's on the tile's TH rows x 32, then conv2's (w2 rows, and s2's
// patch where the slice is not read from the intermediate) for each
// 64-channel block of y in turn.
template <int TH_, int STAGES_>
struct BiChainCfg {
  static constexpr int TH = TH_, TW = 30, M = TH * TW;      // output tile
  static constexpr int MW = 32, MPIX = (TH + 2) * MW;       // conv1 region
  using C1H = PipeCfg<1, TH + 2, 64, 1, STAGES_, 32>;       // halo block
  using C1T = PipeCfg<1, TH, 64, 1, STAGES_, 32>;           // tile block
  static constexpr int STAGES = STAGES_;
  static constexpr int BLK = MPIX * 64;     // one halo block's intermediate
  // conv2: 4 x 2 warps over a 64-channel block, MT m16 tiles x 4 n8 (the
  // last tiles may hold no pixels)
  static constexpr int BN = 64, WM = 4, NT = 4;
  static constexpr int MT = ((M + 15) / 16 + WM - 1) / WM;
  static constexpr int P2 = MPIX * 16;      // s2's patch of one slice
  static constexpr int STAGE2 = P2 + 9 * BN * 16;
  static constexpr int STAGE = C1H::STAGE > STAGE2 ? C1H::STAGE : STAGE2;
  static constexpr size_t RING = (size_t)STAGES * STAGE;
  static size_t smem(int nh) {
    return (RING + (size_t)nh * BLK) * sizeof(bf16);
  }
  static_assert(WM * MT * 16 >= M, "conv2 tiles cover the output tile");
  static_assert(C1T::STAGE <= STAGE, "a tile block's stage fits");

  // Chunk k (of 8) of intermediate pixel q (row * 32 + column) in a halo
  // block's tile, and chunk k (of 2) of pixel q of s2's patch: 8
  // consecutive pixels at one chunk hit 8 bank groups.
  static __device__ __forceinline__ int mid_off(int q, int k) {
    return (q * 8 + (k ^ (q & 7))) * 8;
  }
  static __device__ __forceinline__ int p2_off(int q, int k) {
    return (q * 2 + (k ^ ((q >> 2) & 1))) * 8;
  }
};

// conv2 on one staged K slice: A from the intermediate (MID: a halo
// block's tile at abase, chunks kc and kc + 1) or from s2's patch in the
// stage, at qb[mt] + the tap's pixel offset; B from the stage's w2 rows,
// held for the tap as in bichain_mma1.
template <class K, bool MID>
__device__ __forceinline__ void bichain_mma2(float (&acc)[K::MT][K::NT][4],
                                             uint32_t abase, int kc,
                                             uint32_t wbase,
                                             const int (&qb)[K::MT], int wm,
                                             int a_c, int b_off) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int d = (tap / 3) * K::MW + tap % 3;
    uint32_t bfr[K::NT / 2][4];
#pragma unroll
    for (int jj = 0; jj < K::NT / 2; ++jj)
      ldsm_x4(bfr[jj], wbase + 2 * ((tap * K::BN + jj * 16) * 16 + b_off));
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt) {
      if ((wm * K::MT + mt) * 16 >= K::M) continue;      // no pixels
      const int q = qb[mt] + d;
      uint32_t af[4];
      ldsm_x4(af, abase + 2 * (MID ? K::mid_off(q, kc + a_c)
                                   : K::p2_off(q, a_c)));
#pragma unroll
      for (int jj = 0; jj < K::NT / 2; ++jj) {
        mma_bf16(acc[mt][2 * jj], af, bfr[jj]);
        mma_bf16(acc[mt][2 * jj + 1], af, bfr[jj] + 2);
      }
    }
  }
}

// conv1's epilogue for 64-channel block b1 (C: C1H on the region, C1T on
// the tile's rows): bias, act1 and one rounding, as K5's; a halo block's
// values go to its intermediate tile (zero outside the image), the tile's
// s2' lanes to s2n.
template <class K, class C, bool HALO>
__device__ __forceinline__ void bichain_epi1(
    const float (&acc)[C::MT][C::NT][4], int b1, const BiChainArgs& a,
    const ChainLanes& ln, bf16* mid, bf16* s2n, int st, int oy0, int ox0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, tg = lane & 3;
  const float* bias = a.b1 + b1 * 64;
  bf16* tile = mid + (b1 - ln.hb0) * K::BLK;
  const bool pair = a.C1 % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = (wm * C::MT + mt) * 16 + g + 8 * h;
      const int ry = q / K::MW + (HALO ? 0 : 1), rx = q % K::MW;
      const int y = oy0 - 1 + ry, x = ox0 - 1 + rx;
      const bool in =
          (unsigned)y < (unsigned)a.H && (unsigned)x < (unsigned)a.W;
      const bool own = in && ry >= 1 && ry <= K::TH && rx >= 1 && rx <= K::TW;
      bf16* out = s2n + (((long long)st * a.H + y) * a.W + x) * a.C1;
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const int cl = wn * 32 + nt * 8 + 2 * tg, c = b1 * 64 + cl;
        const float v0 =
            in ? apply_act(acc[mt][nt][2 * h] + bias[cl], a.act1) : 0.f;
        const float v1 =
            in ? apply_act(acc[mt][nt][2 * h + 1] + bias[cl + 1], a.act1)
               : 0.f;
        const __nv_bfloat162 r = __floats2bfloat162_rn(v0, v1);
        if (HALO)
          *reinterpret_cast<__nv_bfloat162*>(
              tile + K::mid_off(ry * K::MW + rx, cl >> 3) + 2 * tg) = r;
        if (own) {
          const bool t0 = ln.to_s2n(c), t1 = ln.to_s2n(c + 1);
          if (t0 && t1 && pair) {
            *reinterpret_cast<__nv_bfloat162*>(out + c) = r;
          } else {
            if (t0) out[c] = r.x;
            if (t1) out[c + 1] = r.y;
          }
        }
      }
    }
}

// conv1 on one staged K slice: pipe_mma_stage's products in its order (the
// same sums, bit for bit, as K5's), with the tap's B fragments held and
// the A fragments streamed, which keeps fewer registers live beside the
// accumulators.
template <class C>
__device__ __forceinline__ void bichain_mma1(float (&acc)[C::MT][C::NT][4],
                                             uint32_t pbase, uint32_t wbase,
                                             int wm, int a_px, int a_c,
                                             int b_off) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    uint32_t bfr[C::NT / 2][4];
#pragma unroll
    for (int jj = 0; jj < C::NT / 2; ++jj)
      ldsm_x4(bfr[jj], wbase + 2 * ((tap * C::BN + jj * 16) * C::KC + b_off));
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt) {
      uint32_t af[4];
      pipe_a_frag<C>(af, pbase, wm * C::MT + mt, ky, kx, a_px, a_c);
#pragma unroll
      for (int jj = 0; jj < C::NT / 2; ++jj) {
        mma_bf16(acc[mt][2 * jj], af, bfr[jj]);
        mma_bf16(acc[mt][2 * jj + 1], af, bfr[jj] + 2);
      }
    }
  }
}

// conv1's K loop of one 64-channel block (ring steps kt0 .. kt0 + nk - 1);
// loads run STAGES - 1 steps ahead but stop at conv1's n1 steps (conv2's
// slices may read the intermediate, complete only after conv1).
template <class K, class C, class Load>
__device__ __forceinline__ void bichain_pass1(
    float (&acc)[C::MT][C::NT][4], bf16* ring, int kt0, int nk, int n1,
    const Load& load, int wm, const PipeLane& pl, int b_off) {
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int kt = kt0; kt < kt0 + nk; ++kt) {
    cp_async_wait<K::STAGES - 2>();
    __syncthreads();                 // stage kt landed; stage kt-1 consumed
    if (kt + K::STAGES - 1 < n1) load(kt + K::STAGES - 1);
    cp_async_commit();
    const bf16* sg = ring + (kt % K::STAGES) * K::STAGE;
    bichain_mma1<C>(acc, smem_u32(sg), smem_u32(sg + C::PATCH), wm, pl.a_px,
                    pl.a_c, b_off);
  }
}

template <class K, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
bibuf_chain_bf16_kernel(BiChainArgs a, ChainLanes ln) {
  using C1H = typename K::C1H;
  using C1T = typename K::C1T;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* mid = ring + K::RING;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_x = cdiv(a.W, K::TW);
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int st = blockIdx.y, oy0 = ty * K::TH, ox0 = tx * K::TW;
  BiPipeSrc s;
  static_cast<BiSrc<bf16>&>(s) = bi_src<bf16>(a.x, a.s1, a.N, a.H, a.W, a.C,
                                              a.fold1, a.causal, a.vec);
  s.w = static_cast<const bf16*>(a.w1);
  s.CinP = a.CinP;
  const bf16* s2 = static_cast<const bf16*>(a.s2);
  const bf16* w2 = static_cast<const bf16*>(a.w2);
  bf16* s2n = static_cast<bf16*>(a.s2n);
  // conv1: nk1 slices for each of its nb1 64-channel blocks (n1 steps);
  // conv2: ks2 slices (to C1: w2's padding is zero) for each of its nb2
  // blocks
  const int nk1 = a.CinP / 16, nb1 = a.C1P / 64, n1 = nb1 * nk1;
  const int ks2 = cdiv(a.C1, 16), nb2 = a.CoutP / K::BN;
  const int total = n1 + nb2 * ks2;

  // conv2's input slice k0 on the region into the stage's patch: a 16-byte
  // chunk of one s2 region by cp.async, of y1 lanes by a copy from the
  // intermediate, padding as zeros, any other element by element
  auto load_s2 = [&](bf16* sg, int k0) {
    const int c = threadIdx.x & 1, c0 = k0 + c * 8;
    const int r0 = ln.region(c0);
    const bool whole = r0 == ln.region(c0 + 7);
    const int cs = r0 == 1 ? c0 - a.fold2 : c0;
    for (int q = threadIdx.x >> 1; q < K::MPIX; q += kThreads / 2) {
      const int y = oy0 - 1 + q / K::MW, x = ox0 - 1 + q % K::MW;
      const bool in =
          (unsigned)y < (unsigned)a.H && (unsigned)x < (unsigned)a.W;
      const long long pix = (((long long)st * a.H + y) * a.W + x) * a.C1;
      bf16* dst = sg + K::p2_off(q, c);
      if (whole && r0 == 3) {
        cp_async16(dst, s2, false);
      } else if (whole && r0 == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(
            mid + (c0 / 64 - ln.hb0) * K::BLK +
            K::mid_off(q, (c0 & 63) >> 3));
      } else if (whole && a.vec2) {
        cp_async16(dst, in ? s2 + pix + cs : s2, in);
      } else {
#pragma unroll 1
        for (int j = 0; j < 8; ++j) {
          const int cj = c0 + j, rj = ln.region(cj);
          bf16 v = __float2bfloat16(0.f);
          if (rj == 0)
            v = mid[(cj / 64 - ln.hb0) * K::BLK +
                    K::mid_off(q, (cj & 63) >> 3) + (cj & 7)];
          else if (rj != 3 && in)
            v = s2[pix + (rj == 1 ? cj - a.fold2 : cj)];
          dst[j] = v;
        }
      }
    }
  };
  // ring step kt < n1: a slice of conv1; kt >= n1: of conv2 (a loader
  // each, so that conv1's loop holds none of conv2's state)
  auto load1 = [&](int kt) {
    bf16* sg = ring + (kt % K::STAGES) * K::STAGE;
    const int b1 = kt / nk1, k0 = (kt - b1 * nk1) * 16;
    if (ln.halo(b1))
      pipe_load<C1H>(sg, s, st, oy0 - 2, ox0 - 2, b1 * 64, k0);
    else
      pipe_load<C1T>(sg, s, st, oy0 - 1, ox0 - 2, b1 * 64, k0);
  };
  auto load2 = [&](int kt) {
    if (kt >= total) return;
    bf16* sg = ring + (kt % K::STAGES) * K::STAGE;
    const int b2 = (kt - n1) / ks2, k0 = (kt - n1 - b2 * ks2) * 16;
    pipe_load_weights<K::BN>(sg + K::P2, w2, a.C1P, b2 * K::BN, k0);
    if (!ln.mid_slice(k0)) load_s2(sg, k0);
  };
  const PipeLane pl(lane);
  const int wm = warp >> 1, wn = warp & 1;
  const int b_off = pl.b_off(wn * 32);

  // ---- conv1: y1 into the intermediate (halo blocks) and into s2' ----
#pragma unroll
  for (int i = 0; i < K::STAGES - 1; ++i) {
    if (i < n1) load1(i);
    cp_async_commit();
  }
  for (int b1 = 0; b1 < nb1; ++b1) {
    if (ln.halo(b1)) {
      float acc[C1H::MT][C1H::NT][4];
      bichain_pass1<K, C1H>(acc, ring, b1 * nk1, nk1, n1, load1, wm, pl,
                            b_off);
      bichain_epi1<K, C1H, true>(acc, b1, a, ln, mid, s2n, st, oy0, ox0);
    } else {
      float acc[C1T::MT][C1T::NT][4];
      bichain_pass1<K, C1T>(acc, ring, b1 * nk1, nk1, n1, load1, wm, pl,
                            b_off);
      bichain_epi1<K, C1T, false>(acc, b1, a, ln, mid, s2n, st, oy0, ox0);
    }
  }
  __syncthreads();                   // the intermediate is complete
#pragma unroll
  for (int i = 0; i < K::STAGES - 1; ++i) {
    load2(n1 + i);
    cp_async_commit();
  }

  // ---- conv2: a 64-channel block of y at a time ----
  int qb[K::MT];
#pragma unroll
  for (int mt = 0; mt < K::MT; ++mt) {
    int p = (wm * K::MT + mt) * 16 + pl.a_px;
    if (p >= K::M) p = 0;
    qb[mt] = (p / K::TW) * K::MW + p % K::TW;
  }
  bf16* y = static_cast<bf16*>(a.y);
  const bool pair = a.Cout % 2 == 0;
  const int g = lane >> 2, tg = lane & 3;
  int kt = n1;
  for (int b2 = 0; b2 < nb2; ++b2) {
    float acc[K::MT][K::NT][4];
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < K::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    for (int j = 0; j < ks2; ++j, ++kt) {
      cp_async_wait<K::STAGES - 2>();
      __syncthreads();               // stage kt landed; stage kt-1 consumed
      load2(kt + K::STAGES - 1);
      cp_async_commit();
      const bf16* sg = ring + (kt % K::STAGES) * K::STAGE;
      const int k0 = j * 16;
      if (ln.mid_slice(k0))
        bichain_mma2<K, true>(acc,
                              smem_u32(mid + (k0 / 64 - ln.hb0) * K::BLK),
                              (k0 & 63) >> 3, smem_u32(sg + K::P2), qb, wm,
                              pl.a_c, b_off);
      else
        bichain_mma2<K, false>(acc, smem_u32(sg), 0, smem_u32(sg + K::P2),
                               qb, wm, pl.a_c, b_off);
    }
    // bias and act2 in fp32, one rounding, as K5's
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm * K::MT + mt) * 16 + g + 8 * h;
        const int oy = oy0 + r / K::TW, ox = ox0 + r % K::TW;
        if (r >= K::M || oy >= a.H || ox >= a.W) continue;
        bf16* out = y + (((long long)st * a.H + oy) * a.W + ox) * a.Cout;
#pragma unroll
        for (int nt = 0; nt < K::NT; ++nt) {
          const int o = b2 * K::BN + wn * 32 + nt * 8 + 2 * tg;
          if (o >= a.Cout) continue;
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              apply_act(acc[mt][nt][2 * h] + a.b2[o], a.act2),
              apply_act(acc[mt][nt][2 * h + 1] + a.b2[o + 1], a.act2));
          if (o + 1 < a.Cout && pair) {
            *reinterpret_cast<__nv_bfloat162*>(out + o) = v;
          } else {
            out[o] = v.x;
            if (o + 1 < a.Cout) out[o + 1] = v.y;
          }
        }
      }
  }
  cp_async_wait<0>();

  // ---- the states' copied lanes ----
  if (!a.causal) copy_s2_lanes(s2n, s2, a, st, oy0, ox0, K::TH, K::TW);
  copy_next_state(static_cast<bf16*>(a.s1n), s, 1, st, oy0, ox0, K::TH,
                  K::TW);
}

template <class K>
static int launch_bichain_bf16(const BiChainArgs& a, cudaStream_t stream) {
  const ChainLanes ln = chain_lanes(a, 64);
  const size_t smem = K::smem(ln.nh);     // refused past a block's limit
  // two blocks an SM where two fit (228 KB an SM, 1 KB a block)
  auto kern = 2 * (smem + 1024) <= 233472 ? bibuf_chain_bf16_kernel<K, 2>
                                          : bibuf_chain_bf16_kernel<K, 1>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(cdiv(a.H, K::TH) * cdiv(a.W, K::TW), a.N);
  kern<<<grid, kThreads, smem, stream>>>(a, ln);
  return (int)cudaGetLastError();
}

// fp32: conv_common.cuh's FMA walk on 8 x 16 tiles by the same lane rule;
// the intermediate holds the halo blocks (10 x 18 pixels of ms floats).
// conv2's source: y1 lanes from the intermediate, whose (0, 0) is image
// pixel (oy0 - 1, ox0 - 1), the others from s2.
struct Chain2Src {
  const float* s2;
  const float* mid;
  ChainLanes ln;
  int H, W, C, st, oy0, ox0, ms;
};

__device__ __forceinline__ void read_group(const Chain2Src& s, int n, int y,
                                           int x, int c0, float* v) {
  const int r = (y - s.oy0 + 1) * (kTW + 2) + (x - s.ox0 + 1);
  const long long pix = (((long long)s.st * s.H + y) * s.W + x) * s.C;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c0 + j, rg = s.ln.region(c);
    v[j] = rg == 3   ? 0.f
           : rg == 0 ? s.mid[r * s.ms + c - s.ln.hb0 * kBN]
                     : s.s2[pix + (rg == 1 ? c - s.ln.f2 : c)];
  }
}

constexpr int kBRH = kTH + 2, kBRW = kTW + 2;      // conv1 region
constexpr int kBPH = kBRH + 2, kBPW = kBRW + 2;    // its input patch
constexpr int kBMT1 = 3;                           // 4 * 3 * 16 = 192 >= 180

__host__ __device__ __forceinline__ int bichain_fma_ms(const ChainLanes& ln) {
  return ln.nh * kBN + 4;
}

__global__ void __launch_bounds__(kThreads)
bibuf_chain_fma_kernel(BiChainArgs a, ChainLanes ln) {
  using T = float;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* patch = reinterpret_cast<T*>(smem_raw);
  T* wsm = patch + kBPH * kBPW * kKS;
  T* mid = wsm + kWTile;
  const int ms = bichain_fma_ms(ln);
  const int tiles_x = (a.W + kTW - 1) / kTW;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int st = blockIdx.z;
  const int oy0 = ty * kTH, ox0 = tx * kTW;
  const BiSrc<T> s = bi_src<T>(a.x, a.s1, a.N, a.H, a.W, a.C, a.fold1,
                               a.causal, a.vec);
  const T* s2 = static_cast<const T*>(a.s2);
  T* s2n = static_cast<T*>(a.s2n);
  auto s2n_at = [&](int y, int x, int c, float v) {
    if (y >= 0 && y < a.H && x >= 0 && x < a.W && ln.to_s2n(c))
      s2n[(((long long)st * a.H + y) * a.W + x) * a.C1 + c] = v;
  };

  // ---- conv1: halo blocks on the 10 x 18 region, the others on the tile
  for (int b1 = 0; b1 < a.C1P / kBN; ++b1) {
    const int n1 = b1 * kBN;
    if (ln.halo(b1)) {
      float acc[kBMT1][4][4];
      conv_region<T, 1, kBMT1>(acc, s, static_cast<const T*>(a.w1), a.CinP,
                               n1, st, oy0 - 2, ox0 - 2, kBRH, kBRW, patch,
                               wsm);
      for_each_pair(acc, [&](int r, int c, float v0, float v1) {
        if (r >= kBRH * kBRW) return;
        const int ry = r / kBRW, rx = r - ry * kBRW;
        const int gy = oy0 - 1 + ry, gx = ox0 - 1 + rx, ch = n1 + c;
        const bool in = gy >= 0 && gy < a.H && gx >= 0 && gx < a.W;
        v0 = in ? apply_act(v0 + a.b1[ch], a.act1) : 0.f;
        v1 = in ? apply_act(v1 + a.b1[ch + 1], a.act1) : 0.f;
        T* m = mid + r * ms + ch - ln.hb0 * kBN;
        m[0] = v0;
        m[1] = v1;
        if (ry >= 1 && ry <= kTH && rx >= 1 && rx <= kTW) {
          s2n_at(gy, gx, ch, v0);
          s2n_at(gy, gx, ch + 1, v1);
        }
      });
    } else {
      float acc[2][4][4];
      conv_region<T, 1, 2>(acc, s, static_cast<const T*>(a.w1), a.CinP, n1,
                           st, oy0 - 1, ox0 - 1, kTH, kTW, patch, wsm);
      for_each_pair(acc, [&](int r, int c, float v0, float v1) {
        const int gy = oy0 + r / kTW, gx = ox0 + r % kTW, ch = n1 + c;
        s2n_at(gy, gx, ch, apply_act(v0 + a.b1[ch], a.act1));
        s2n_at(gy, gx, ch + 1, apply_act(v1 + a.b1[ch + 1], a.act1));
      });
    }
  }

  // ---- conv2 on the 8 x 16 tile (conv_region's first barrier orders the
  // intermediate's writes before its reads) ----
  const Chain2Src src{s2, mid, ln, a.H, a.W, a.C1, st, oy0, ox0, ms};
  T* y = static_cast<T*>(a.y);
  const bool pair_ok = (a.Cout % 2) == 0;
  for (int n2 = 0; n2 < a.CoutP; n2 += kBN) {
    float acc[2][4][4];
    conv_region<T, 1, 2>(acc, src, static_cast<const T*>(a.w2), a.C1P, n2,
                         st, oy0 - 1, ox0 - 1, kTH, kTW, patch, wsm);
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

  if (!a.causal) copy_s2_lanes(s2n, s2, a, st, oy0, ox0, kTH, kTW);
  copy_next_state(static_cast<T*>(a.s1n), s, 1, st, oy0, ox0, kTH, kTW);
}

static int launch_bichain(const BiChainArgs& a, int bf16_path,
                          cudaStream_t stream) {
  if (bf16_path) {
    if (a.C1P % 64 != 0 || a.CoutP % 64 != 0)
      return (int)cudaErrorInvalidValue;
    // 6 x 30 tiles: 720 blocks at 270x480, 184 at 135x240 (2.7 and 0.7
    // waves of two blocks an SM; 8 x 30: 2.06 and 1.03)
    return launch_bichain_bf16<BiChainCfg<6, 2>>(a, stream);
  }
  const ChainLanes ln = chain_lanes(a, kBN);
  const size_t smem = ((size_t)kBPH * kBPW * kKS + kWTile +
                       (size_t)kBRH * kBRW * bichain_fma_ms(ln)) *
                      sizeof(float);
  auto kern = bibuf_chain_fma_kernel;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(cdiv(a.H, kTH) * cdiv(a.W, kTW), 1, a.N);
  kern<<<grid, kThreads, smem, stream>>>(a, ln);
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
// vec: x / s1 as K5's; vec2: C1 % 8 == 0, fold2 % 8 == 0 and s2 / s2n 16-byte
// aligned. bf16: C1P and CoutP multiples of 64, else cudaErrorInvalidValue;
// an intermediate too wide for a block (the causal step's y1[2f2:] past
// 256 channels) fails set_smem's cudaErrorInvalidValue.
extern "C" int bsvd_bibuffer_chain(int dtype, const void* x, const void* s1,
                                   const void* s2, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, void* y, void* s1n,
                                   void* s2n, int N, int H, int W, int C,
                                   int CinP, int C1, int C1P, int Cout,
                                   int CoutP, int fold1, int fold2,
                                   int causal, int act1, int act2, int vec,
                                   int vec2, void* stream) {
  bsvd::BiChainArgs a{x, s1, s2, w1, static_cast<const float*>(b1), w2,
                      static_cast<const float*>(b2), y, s1n, s2n, N, H, W, C,
                      CinP, C1, C1P, Cout, CoutP, fold1, fold2, causal, act1,
                      act2, vec, vec2};
  return bsvd::launch_bichain(a, dtype == 1, static_cast<cudaStream_t>(stream));
}
