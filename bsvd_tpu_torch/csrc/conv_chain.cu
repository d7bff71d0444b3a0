// K2 conv_chain: act2(conv2(act1(conv1(x [+ x2])))) in one kernel, with an
// optional residual epilogue out[..., c] = x_res[..., c] - y[..., c] for
// c < rc. NHWC, both convs 3x3 stride 1 pad 1.
//
// Replaces bsvd_tpu/ops/conv_chain.py conv_chain_pallas -> _kernel_chain
// (the WNet inc pair and the outc pair with its skip-add and the per-stage
// residual). The TPU kernel walks row blocks in order and keeps a rolling
// 3-slot ring of the intermediate; blocks here run in parallel, so each
// block recomputes conv1 on its output tile plus a 1-pixel ring and keeps
// that intermediate in shared memory, rounded to the input type as the TPU
// kernel does. The intermediate never reaches device memory; its pixels
// outside the image are zero (conv2 pads with zeros).
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
//
// bf16 (the first design walked conv_common.cuh's synchronous conv_region
// on an 8 x 16 tile: a 10 x 18 intermediate, 1.41x conv1, 1.5x as issued,
// w2 staged a slice behind two barriers): output tiles 30 pixels wide, the
// intermediate 32 wide, so an m16 tile of conv1 is half an intermediate
// row. One cp.async ring carries conv1's slices (input patch + w1 rows,
// conv_pipe.cuh pipe_load: the element loader for Cin = 4, x2 staged
// beside x and added on the A fragments) and then conv2's (w2 rows), so
// conv2's first weight slices arrive while conv1 runs. conv1 is
// pipe_mma_stage on the (TH + 2) x 32 tile; its epilogue writes the
// intermediate (bias, act1, zero outside the image, one rounding) into
// swizzled [pixel][64] tiles beside the ring, one a 64-channel block of
// conv1 (C1P / 64 of them, conv1's K loop run once a block); conv2's A
// fragments come from them by ldmatrix at per-lane pixel addresses (a
// 30-wide output row is no whole number of m16 tiles). conv2's N block is
// 64 channels, or 16 for Cout <= 16 (the 3-channel head: 8 warps x 2 m16
// tiles x 16 channels), not 64 channels for 3; a wider CoutP runs its
// 64-channel blocks in turn over the same intermediate, the ring refilled
// after each block's epilogue. The epilogue adds the bias, act2 and the
// residual in fp32, rounds once, stages the tile in the ring and stores
// 16-byte runs where Cout % 8 == 0. The fp32 instantiation keeps the
// conv_region walk: the exactness reference of the card checks.
//
// The tile height is a trade of conv1's halo rows against blocks an SM:
// - without x2, 8 x 30 (a 10 x 32 intermediate, conv1 1.33x) with a
//   2-stage ring, 104 KB: two blocks an SM, each hiding the other's fill
//   and epilogues (11-28% faster than 14 x 30 at one block an SM);
// - with x2 the patch is staged twice, so two blocks an SM need the
//   intermediate inside the ring; 14 x 30 (conv1 1.14x, 181 KB, one block
//   an SM) was 2-13% faster than that at 10 frames, 11-25% at one.
// 16 x 30 (conv1 1.2x) held 144 fp32 accumulators a thread at 255
// registers and ran 5-39% slower than 14 x 30 (128). (NVIDIA H100 80GB
// HBM3, 700.00 W; tools/torch_kernel_variants.py, PERF.md.) Each 64
// intermediate channels take 40 KB of a block's shared memory at 8 x 30,
// 64 KB at 14 x 30: past 64, x + x2 takes 8 x 30 too, and C1P reaches 256
// without x2, 192 with it (the WNet chains hold 64).
//
// Not done: the TPU kernel's row walk (a block walks the bands of a column
// strip and keeps a rolling ring of intermediate rows, conv1 recomputing
// only the strip's halo columns). Filling 132 SMs at one 540p frame needs
// ~8 bands a block, so each strip segment pays its first rows again: ~1.1x
// conv1 against these tiles' 1.14-1.33x, at one block an SM.

#include "conv_pipe.cuh"

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

// ---- fp32: conv_common.cuh's FMA walk -------------------------------------

constexpr int kRH = kTH + 2, kRW = kTW + 2;      // conv1 region
constexpr int kPH = kRH + 2, kPW = kRW + 2;      // conv1 input patch
constexpr int kMT1 = 3;                          // 4 * 3 * 16 = 192 >= 180

template <typename T>
__global__ void __launch_bounds__(kThreads) conv_chain_kernel(ChainArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
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

// ---- bf16: conv_pipe.cuh's loop ---------------------------------------------

// NX: 2 where conv1 reads x + x2; BN2: conv2's N block (CoutP, 64 or 16);
// TH: output rows of the tile (30 columns), the intermediate TH + 2 rows of
// 32 beside the ring; STAGES: ring stages.
template <int NX, int BN2, int TH_, int STAGES>
struct ChainCfg {
  // conv1 on the (TH + 2) x 32 intermediate tile: 4 x 2 warps of (TH + 2)
  // / 2 m16 tiles x 32 channels of one 64-channel block (C1B)
  using C1 = PipeCfg<1, TH_ + 2, 64, NX, STAGES, 32>;
  static constexpr int TH = TH_, TW = 30, M = TH * TW;  // output tile
  static constexpr int MW = 32, MPIX = (TH + 2) * MW;   // intermediate
  static constexpr int C1B = 64, BLK = MPIX * C1B;      // one block's tile
  // conv2: WM x WN warps, MT m16 tiles x NT n8 (the last tiles may hold
  // no pixels)
  static constexpr int BN = BN2, WN = BN2 == 64 ? 2 : 1, WM = 8 / WN;
  static constexpr int MT = ((M + 15) / 16 + WM - 1) / WM, NT = BN2 / WN / 8;
  static constexpr int OS = BN2 + 8;                   // staging row stride
  static constexpr size_t RING = (size_t)C1::STAGES * C1::STAGE;
  static constexpr size_t SMEM = (RING + (size_t)BLK) * sizeof(bf16);
  // the ring and an intermediate of C1P channels
  static size_t smem(int c1p) {
    return (RING + (size_t)MPIX * c1p) * sizeof(bf16);
  }
  // two blocks an SM where two fit at 64 channels (228 KB an SM, 1 KB a
  // block)
  static constexpr int MIN_BLOCKS = 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
  static_assert(BN2 == 64 || BN2 == 16, "conv2 block");
  static_assert(WM * MT * 16 >= M, "conv2 tiles cover the output tile");
  static_assert(9 * BN2 * 16 <= C1::STAGE, "w2 slice must fit a stage");
  static_assert((size_t)M * OS <= RING, "staging tile must fit in the ring");
  static_assert(SMEM <= 232448, "ring + intermediate exceed a block");

  // Element offset of 8-channel chunk k (of 8) of intermediate pixel q (row
  // * 32 + column) in a block's tile: 8 consecutive pixels at one chunk hit
  // 8 bank groups.
  static __device__ __forceinline__ int mid_off(int q, int k) {
    return (q * 8 + (k ^ (q & 7))) * 8;
  }
};

// conv1's epilogue for one 64-channel block: bias, act1, zero outside the
// image, one rounding, into the block's tile ``mid`` of the intermediate
// (``b1``: the block's biases); its (0, 0) is image pixel (oy0 - 1, ox0 - 1).
template <class K>
__device__ __forceinline__ void chain_write_mid(
    const float (&acc)[K::C1::MT][K::C1::NT][4], bf16* mid, const float* b1,
    int act, int oy0, int ox0, int H, int W) {
  using C1 = typename K::C1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mt = 0; mt < C1::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = (wm * C1::MT + mt) * 16 + g + 8 * h;
      const int y = oy0 - 1 + q / K::MW, x = ox0 - 1 + q % K::MW;
      const bool in = (unsigned)y < (unsigned)H && (unsigned)x < (unsigned)W;
#pragma unroll
      for (int nt = 0; nt < C1::NT; ++nt) {
        const int c = wn * 32 + nt * 8 + 2 * tg;
        const float v0 = in ? apply_act(acc[mt][nt][2 * h] + b1[c], act) : 0.f;
        const float v1 =
            in ? apply_act(acc[mt][nt][2 * h + 1] + b1[c + 1], act) : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(mid + K::mid_off(q, c >> 3) +
                                           2 * tg) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
}

// conv2 on one staged K slice ks (16 channels of the intermediate block at
// mbase): A from the intermediate at qb[mt] + the tap's pixel offset (the
// warp's A fragments of a tap held, as K1 holds its own), B from the
// stage's w2 rows. Tiles past the output tile's pixels are skipped
// (warp-uniform).
template <class K>
__device__ __forceinline__ void chain_mma2(float (&acc)[K::MT][K::NT][4],
                                           uint32_t mbase, uint32_t wbase,
                                           int ks, const int (&qb)[K::MT],
                                           int wm, int a_c, int b_off) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int d = (tap / 3) * K::MW + tap % 3;
    uint32_t af[K::MT][4];
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt)
      if ((wm * K::MT + mt) * 16 < K::M)
        ldsm_x4(af[mt], mbase + 2 * K::mid_off(qb[mt] + d, ks * 2 + a_c));
#pragma unroll
    for (int jj = 0; jj < K::NT / 2; ++jj) {
      uint32_t bfr[4];
      ldsm_x4(bfr, wbase + 2 * ((tap * K::BN + jj * 16) * 16 + b_off));
#pragma unroll
      for (int mt = 0; mt < K::MT; ++mt) {
        if ((wm * K::MT + mt) * 16 >= K::M) continue;    // no pixels
        mma_bf16(acc[mt][2 * jj], af[mt], bfr);
        mma_bf16(acc[mt][2 * jj + 1], af[mt], bfr + 2);
      }
    }
  }
}

// WIDE: an intermediate or output of more than one 64-channel block (the
// loops below run over C1P / 64 and CoutP / 64 blocks). Without it both
// are one block and the loops fold away: run-time loops in the WNet's
// instantiations had 2.7x the spill stores at 8 x 30 (ptxas).
template <class K, bool WIDE>
__global__ void __launch_bounds__(kThreads, WIDE ? 1 : K::MIN_BLOCKS)
conv_chain_bf16_kernel(ChainArgs a) {
  using C1 = typename K::C1;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  bf16* mid = ring + K::RING;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_x = cdiv(a.W, K::TW);
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
  const int n = blockIdx.y, oy0 = ty * K::TH, ox0 = tx * K::TW;
  const PipeSrc s{static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.x2),
                  static_cast<const bf16*>(a.w1), a.H, a.W, a.Cin, a.CinP,
                  1, 0, kShiftNone, a.vec};
  const bf16* w2 = static_cast<const bf16*>(a.w2);
  // conv1: nk1 slices for each 64-channel block of the intermediate (n1
  // steps in all); conv2: ks2 slices for each of its nb2 channel blocks
  const int nk1 = a.CinP / 16, nb1 = WIDE ? a.C1P / K::C1B : 1;
  const int n1 = nb1 * nk1, ks2 = nb1 * (K::C1B / 16);
  const int nb2 = WIDE ? a.CoutP / K::BN : 1;
  // ring step kt, w2 slice j of the conv2 block at channel o0
  auto load_w2 = [&](int kt, int j, int o0) {
    if (j < ks2)
      pipe_load_weights<K::BN>(ring + (kt % C1::STAGES) * C1::STAGE, w2,
                               a.C1P, o0, j * 16);
  };
  // step kt of the first pass: conv1's slices (patch + w1 rows), then
  // conv2's first block (w2 rows)
  auto load = [&](int kt) {
    if (kt < n1) {
      const int b1 = WIDE ? kt / nk1 : 0;
      pipe_load<C1>(ring + (kt % C1::STAGES) * C1::STAGE, s, n, oy0 - 2,
                    ox0 - 2, b1 * K::C1B, (kt - b1 * nk1) * 16);
    } else {
      load_w2(kt, kt - n1, 0);
    }
  };
  const PipeLane pl(lane);

  // ---- conv1 into the intermediate, a 64-channel block at a time ----
#pragma unroll
  for (int st = 0; st < C1::STAGES - 1; ++st) {
    load(st);
    cp_async_commit();
  }
  {
    const int wm = warp >> 1, wn = warp & 1;
    const int b_off = pl.b_off(wn * 32);
    for (int b1 = 0; b1 < nb1; ++b1) {
      float acc1[C1::MT][C1::NT][4];
#pragma unroll
      for (int mt = 0; mt < C1::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < C1::NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc1[mt][nt][e] = 0.f;
      for (int kt = b1 * nk1; kt < (b1 + 1) * nk1; ++kt) {
        cp_async_wait<C1::STAGES - 2>();
        __syncthreads();             // stage kt landed; stage kt-1 consumed
        load(kt + C1::STAGES - 1);
        cp_async_commit();
        const bf16* st = ring + (kt % C1::STAGES) * C1::STAGE;
        pipe_mma_stage<C1>(acc1, smem_u32(st),
                           smem_u32(st + C1::NX * C1::PATCH), wm, pl.a_px,
                           pl.a_c, b_off);
      }
      chain_write_mid<K>(acc1, mid + b1 * K::BLK, a.b1 + b1 * K::C1B, a.act1,
                         oy0, ox0, a.H, a.W);
    }
  }

  // ---- conv2 from the intermediate, a channel block at a time ----
  const int wm = warp / K::WN, wn = warp % K::WN;
  const int b_off = pl.b_off(wn * (K::BN / K::WN));
  int qb[K::MT];
#pragma unroll
  for (int mt = 0; mt < K::MT; ++mt) {
    int p = (wm * K::MT + mt) * 16 + pl.a_px;
    if (p >= K::M) p = 0;
    qb[mt] = (p / K::TW) * K::MW + p % K::TW;
  }
  const uint32_t mbase = smem_u32(mid);
  bf16* os = ring;
  const bf16* xres = static_cast<const bf16*>(a.xres);
  bf16* y = static_cast<bf16*>(a.y);
  const bool vec_out = a.Cout % 8 == 0;
  const int g = lane >> 2, tg = lane & 3;
  for (int b2 = 0; b2 < nb2; ++b2) {
    const int o0 = b2 * K::BN;
    // block 0's slices follow conv1's through the ring; a later block
    // refills the ring once the previous one's tile is stored
    const int kt0 = b2 == 0 ? n1 : 0;
    if (b2 > 0) {
      __syncthreads();
#pragma unroll
      for (int st = 0; st < C1::STAGES - 1; ++st) {
        load_w2(st, st, o0);
        cp_async_commit();
      }
    }
    float acc[K::MT][K::NT][4];
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < K::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    for (int kt = kt0; kt < kt0 + ks2; ++kt) {
      const int j = kt - kt0;
      cp_async_wait<C1::STAGES - 2>();
      __syncthreads();               // intermediate written; stage landed
      load_w2(kt + C1::STAGES - 1, j + C1::STAGES - 1, o0);
      cp_async_commit();
      chain_mma2<K>(acc, mbase + (WIDE ? 2 * (j >> 2) * K::BLK : 0),
                    smem_u32(ring + (kt % C1::STAGES) * C1::STAGE),
                    WIDE ? j & 3 : j, qb, wm, pl.a_c, b_off);
    }
    cp_async_wait<0>();
    __syncthreads();                 // the ring becomes the staging tile

    // ---- epilogue: bias, act2, residual in fp32, one rounding ----
#pragma unroll
    for (int mt = 0; mt < K::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm * K::MT + mt) * 16 + g + 8 * h;
        if (r >= K::M) continue;
        const int oy = oy0 + r / K::TW, ox = ox0 + r % K::TW;
        const bool in = oy < a.H && ox < a.W;
        const long long pix = ((long long)n * a.H + oy) * a.W + ox;
#pragma unroll
        for (int nt = 0; nt < K::NT; ++nt) {
          const int c = wn * (K::BN / K::WN) + nt * 8 + 2 * tg, o = o0 + c;
          float v0 = apply_act(acc[mt][nt][2 * h] + a.b2[o], a.act2);
          float v1 = apply_act(acc[mt][nt][2 * h + 1] + a.b2[o + 1], a.act2);
          if (in && o < a.rc)
            v0 = __bfloat162float(xres[pix * a.Cres + o]) - v0;
          if (in && o + 1 < a.rc)
            v1 = __bfloat162float(xres[pix * a.Cres + o + 1]) - v1;
          *reinterpret_cast<__nv_bfloat162*>(os + r * K::OS + c) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    __syncthreads();
    constexpr int kChunks = K::BN / 8;
    for (int q = threadIdx.x; q < K::M * kChunks; q += kThreads) {
      const int r = q / kChunks, ch = q - r * kChunks;
      const int oy = oy0 + r / K::TW, ox = ox0 + r % K::TW, o = o0 + ch * 8;
      if (oy >= a.H || ox >= a.W || o >= a.Cout) continue;
      const bf16* src = os + r * K::OS + ch * 8;
      bf16* dst = y + (((long long)n * a.H + oy) * a.W + ox) * a.Cout + o;
      if (vec_out) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && o + e < a.Cout; ++e) dst[e] = src[e];
      }
    }
  }
}

template <class K, bool WIDE = false>
static int launch_chain_bf16(const ChainArgs& a, cudaStream_t stream) {
  auto kern = conv_chain_bf16_kernel<K, WIDE>;
  const size_t smem = K::smem(a.C1P);     // refused past a block's limit
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(cdiv(a.H, K::TH) * cdiv(a.W, K::TW), a.N);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- launch -----------------------------------------------------------------

template <typename T>
static size_t chain_smem(int C1P) {
  return ((size_t)kPH * kPW * kKS + kWTile + (size_t)kRH * kRW * (C1P + 8)) *
         sizeof(T);
}

static int launch_chain(const ChainArgs& a, int bf16_path,
                        cudaStream_t stream) {
  if (bf16_path) {
    // conv2's block: 16 channels where CoutP is 16 (w2 packed to 16 for
    // Cout <= 16), else 64; conv1's blocks are 64 channels
    if (a.C1P % 64 != 0 || (a.CoutP != 16 && a.CoutP % 64 != 0))
      return (int)cudaErrorInvalidValue;
    // wider than one block: 8 x 30 tiles, one block an SM
    if (a.C1P > 64 || a.CoutP > 64) {
      if (a.x2)
        return a.CoutP == 16
                   ? launch_chain_bf16<ChainCfg<2, 16, 8, 2>, true>(a, stream)
                   : launch_chain_bf16<ChainCfg<2, 64, 8, 2>, true>(a, stream);
      return a.CoutP == 16
                 ? launch_chain_bf16<ChainCfg<1, 16, 8, 2>, true>(a, stream)
                 : launch_chain_bf16<ChainCfg<1, 64, 8, 2>, true>(a, stream);
    }
    // x: 8 x 30 tiles, two blocks an SM (104 KB); x + x2: the doubled patch
    // keeps one block an SM (181 KB), so 14 x 30 (conv1 1.14x)
    if (a.x2)
      return a.CoutP == 16
                 ? launch_chain_bf16<ChainCfg<2, 16, 14, 2>>(a, stream)
                 : launch_chain_bf16<ChainCfg<2, 64, 14, 2>>(a, stream);
    return a.CoutP == 16 ? launch_chain_bf16<ChainCfg<1, 16, 8, 2>>(a, stream)
                         : launch_chain_bf16<ChainCfg<1, 64, 8, 2>>(a, stream);
  }
  using T = float;
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
// bf16: C1P % 64 == 0 and CoutP 16 (w2 packed to 16 for Cout <= 16) or a
// multiple of 64, else cudaErrorInvalidValue; fp32: CoutP % 64 == 0. An
// intermediate too wide for a block's shared memory (bf16: C1P > 256, 192
// with x2; fp32: > 192) fails set_smem's cudaErrorInvalidValue.
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
  return bsvd::launch_chain(a, dtype == 1, static_cast<cudaStream_t>(stream));
}
