// Pipelined tile machinery for the port's bf16 conv kernels (sm_90a):
// cp.async copies into a ring of shared-memory stages, XOR-swizzled
// channels-last tiles, and ldmatrix fragment loads for mma.sync.
//
// Who walks it: K1 conv3x3, K3 conv_s2, K4 conv_ps and K5 bibuffer_conv /
// bibuffer_multi through pipe_conv_block (K5 with its own loader source,
// BiPipeSrc in bibuffer_conv.cu), and K2 conv_chain and K6 bibuffer_chain,
// whose conv1 is pipe_load + pipe_mma_stage on tiles 32 pixels wide and
// whose conv2 reads the intermediate from shared memory (conv_chain.cu,
// bibuffer_conv.cu). Every fp32 kernel still walks conv_common.cuh's
// conv_region; K7 has its own wgmma loop (conv3x3_dw.cu).
//
// A tile row is one pixel of 8 * CH channels (CH 16-byte chunks). Chunk c of
// row r sits at chunk position c ^ f(r), so that any 8 consecutive rows read
// at one logical chunk hit 8 distinct 16-byte bank groups: ldmatrix reads 8
// rows of 16 bytes at once, and a tap's shifted window starts at any row.
// (f is taken from the row index, or for a conv's input patch from the
// pixel's column: PipeCfg::patch_off.)
//
// The operands of a 3x3 conv (or of its weight gradient) at one tap are the
// tile shifted by a pixel offset. ldmatrix takes one row address per lane,
// so the shift is free, and a tile row need not be 16 pixels wide: the
// main loop below, K2's conv2 (output tiles 30 wide) and K7's narrow
// blocks use it. wgmma reads its shared-memory
// operand through a descriptor of 8-row x 16-byte core matrices at fixed
// strides: K7's 64 x 64 block stores its patch chunk-major ([8-channel
// chunk][pixel][8]) so that 8 consecutive pixels are one core matrix at any
// pixel offset, and the shift becomes the descriptor's start address
// (conv3x3_dw.cu). K1 and K4 on wgmma the same way is the next step.

#pragma once

#include "conv_common.cuh"

namespace bsvd {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; ``valid`` false writes 16 zero bytes (src-size
// 0: nothing is read, ``src`` must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ldmatrix: four (or two) 8x8 b16 matrices; lane l gives the row address of
// matrix l / 8, row l % 8. ``_t``: transposed (rows of the stored matrix
// become columns of the fragment).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// Element offset of logical chunk c of row r in a swizzled tile whose rows
// hold CH chunks (CH = 2 or 8: 32- or 128-byte rows).
template <int CH>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(CH == 2 || CH == 4 || CH == 8, "rows of 2, 4 or 8 chunks");
  return (r * CH + (c ^ ((r / (8 / CH)) & (CH - 1)))) * 8;
}

// Two bf16 pairs added, each sum rounded once (an A fragment of x + x2).
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  __nv_bfloat162 s = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&s);
}

// ---- the pipelined implicit GEMM of a 3x3 conv ------------------------------
//
// One block: a TH x TW output tile (GEMM M = TH TW pixels; TW = 16, or 32
// for K2's conv1) times BN output channels (N), K = 9 taps x CinP, in
// slices of 16 input channels. A stage
// holds NX input patches of the slice (x, and x2 where a second input is
// summed; rows: pixels, 2 chunks) and its 9 x BN weight rows (rows
// tap * BN + n, 2 chunks); STAGES - 1 slices are in flight while one is
// multiplied, with one barrier a slice. Stride S = 2 reads the patch at
// every other column, so its even and odd columns are stored as two
// sub-tiles ((py * 2 + px % 2) * SW + px / 2): a tap's 16 output pixels
// read 16 consecutive rows and ldmatrix stays conflict-free (8 rows at
// stride 2 of a patch stored py * PW + px fall on 4 bank groups).
// Warps: 4 (MT = TH TW / 64 m16 tiles of pixels each) x 2 (BN / 2
// channels each); acc[mt][nt][e] is tile pixel (wm * MT + mt) * 16 + g +
// 8 * (e / 2) (row-major, TW a row), channel wn * BN / 2 + nt * 8 + 2 * tg
// + e % 2. With TW = 16 an m16 tile is one output row.
//
// Blocks: a grid (tiles * CoutP / BN, N) whose fastest index is the output
// channel block, so the blocks that read one input tile run together and
// the tile comes from HBM once (pipe_block).

template <int S_, int TH_, int BN_, int NX_, int STAGES_, int TW_ = 16>
struct PipeCfg {
  static constexpr int S = S_, TH = TH_, TW = TW_, BN = BN_, NX = NX_;
  static constexpr int STAGES = STAGES_;
  static constexpr int KC = 16;                 // input channels a slice
  static constexpr int MT = TH * TW / 64, NT = BN / 16;
  static constexpr int PH = (TH - 1) * S + 3, PW = (TW - 1) * S + 3;
  static constexpr int SW = TW + 1;             // columns of one parity
  static constexpr int PROWS = S == 2 ? PH * 2 * SW : PH * PW;
  static constexpr int PATCH = PROWS * KC;      // elements
  static constexpr int WTS = 9 * BN * KC;
  static constexpr int STAGE = NX * PATCH + WTS;
  static constexpr int OS = BN + 8;             // staging row stride
  static constexpr size_t SMEM = (size_t)STAGES * STAGE * sizeof(bf16);
  // two blocks an SM where two rings fit (228 KB an SM, 1 KB a block)
  static constexpr int MIN_BLOCKS = 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
  static_assert(TH * TW % 64 == 0 && TW % 16 == 0 && BN % 32 == 0 &&
                    (S == 1 || S == 2) && (S == 1 || TW == 16),
                "tile shape");
  static_assert(SMEM <= 232448, "ring exceeds a block's shared memory");
  static_assert((size_t)TH * TW * OS * sizeof(bf16) <= SMEM,
                "staging tile must fit in the ring");

  // Element offset of chunk c of patch pixel (py, px). The chunk's swizzle
  // is keyed on the pixel's column within its (sub-)row: 8 consecutive
  // columns of one row at one logical chunk fall on 8 distinct 16-byte bank
  // groups, and the offset is linear in py, so a tap's fragment addresses
  // are one per-lane base for each kx plus constants.
  static __device__ __forceinline__ int patch_off(int py, int px, int c) {
    const int col = S == 2 ? px >> 1 : px;
    const int r = S == 2 ? (py * 2 + (px & 1)) * SW + col : py * PW + px;
    return (r * 2 + (c ^ ((col >> 2) & 1))) * 8;
  }
};

// What pipe_load copies for one thread's 16-byte chunk of a slice: the
// chunk's channels c0..c0+7 of every patch pixel sit at x[base + (y * W +
// x) * C] (and x2[...] where NX == 2); ``live`` false zero-fills them;
// ``whole`` false reads them element by element (the source's elems8).
struct PipeChunk {
  const bf16* x;
  const bf16* x2;
  long long base;
  bool live, whole;
};

// The loader source of K1, K3, K4 and K2's conv1: x (+ x2), the temporal
// shift folded in. A source gives pipe_load its weights (w, CinP), its
// image (H, W, C), chunk() and elems8(); K5's is BiPipeSrc.
struct PipeSrc {
  const bf16* x;     // (N, H, W, C)
  const bf16* x2;    // (N, H, W, C), summed with x where NX == 2
  const bf16* w;     // packed (CoutP, 3, 3, CinP)
  int H, W, C, CinP;
  int t_len, fold, shift;   // temporal shift (conv_common.cuh src_frame)
  int vec;           // C % 8 == 0 and 16-byte aligned: cp.async the patch

  // The frame that the temporal shift assigns to channels c0..c0+7 of
  // frame n is fixed for the slice; a chunk straddling two shift regions
  // (fold % 8 != 0), and every chunk without ``vec``, is not whole.
  __device__ __forceinline__ PipeChunk chunk(int n, int c0) const {
    const int f = src_frame(c0, n, shift, t_len, fold);
    const bool live = c0 < C && f >= 0;
    return {x, x2, (long long)(live ? f : 0) * H * W * C + c0, live,
            vec && region_of(c0, shift, fold) ==
                       region_of(c0 + 7, shift, fold)};
  }

  // Channels c0..c0+7 of pixel (y, xx) of frame n into dst[0..7] (and x2's
  // into dst[P..P+7] where NX == 2), zero outside the image (``in``), past
  // C and at a clip edge.
  template <int NX, int P>
  __device__ __forceinline__ void elems8(bf16* dst, int n, int y, int xx,
                                         int c0, bool in) const {
    const bf16 zero = __float2bfloat16(0.f);
    for (int j = 0; j < 8; ++j) {
      const int cj = c0 + j;
      const int fj = src_frame(cj, n, shift, t_len, fold);
      const bool ok = in && cj < C && fj >= 0;
      const long long off = (((long long)fj * H + y) * W + xx) * C + cj;
      dst[j] = ok ? x[off] : zero;
      if (NX == 2) dst[P + j] = ok ? x2[off] : zero;
    }
  }
};

// Weight rows n0..n0+BN-1 of K slice k0 (channels k0..k0+15, all 9 taps)
// of w packed (CoutP, 3, 3, CinP) into ``wsm``: row tap * BN + nn, 2
// chunks, swizzled. Thread t copies chunk t % 2 of every 128th row.
template <int BN>
__device__ __forceinline__ void pipe_load_weights(bf16* wsm, const bf16* w,
                                                  int CinP, int n0, int k0) {
  const int tid = threadIdx.x, c = tid & 1, c0 = k0 + c * 8;
  constexpr int kWRows = 9 * BN, kPass = kThreads / 2;
#pragma unroll
  for (int i = 0; i < (kWRows + kPass - 1) / kPass; ++i) {
    const int r = (tid >> 1) + i * kPass;
    if (kWRows % kPass == 0 || r < kWRows) {
      const int tap = r / BN, nn = r % BN;
      cp_async16(wsm + swz<2>(r, c),
                 w + ((long long)(n0 + nn) * 9 + tap) * CinP + c0, true);
    }
  }
}

// Start the copies of K slice k0 into stage ``st``; the patch's (0, 0) is
// image pixel (iy0, ix0) of frame n (before K1's shift). Thread t copies
// chunk t % 2 (channels c0..c0+7) of every other row, so the source's
// chunk() is worked out once a slice; the chunk is zero-filled outside the
// image and where the source says it is not live. A chunk that is not
// whole is read element by element and stored synchronously (visible
// after the barrier that precedes its use, like the copies).
template <class C, class Src>
__device__ __forceinline__ void pipe_load(bf16* st, const Src& s, int n,
                                          int iy0, int ix0, int n0, int k0) {
  const int tid = threadIdx.x, c = tid & 1, c0 = k0 + c * 8;
  constexpr int kPass = kThreads / 2;
  pipe_load_weights<C::BN>(st + C::NX * C::PATCH, s.w, s.CinP, n0, k0);
  const PipeChunk ch = s.chunk(n, c0);
  for (int pix = tid >> 1; pix < C::PH * C::PW; pix += kPass) {
    const int py = pix / C::PW, px = pix - py * C::PW;
    const int y = iy0 + py, x = ix0 + px;
    const bool in = (unsigned)y < (unsigned)s.H && (unsigned)x < (unsigned)s.W;
    bf16* dst = st + C::patch_off(py, px, c);
    if (ch.whole) {
      const bool ok = in && ch.live;
      const long long off = ok ? ch.base + ((long long)y * s.W + x) * s.C : 0;
      cp_async16(dst, ch.x + off, ok);
      if (C::NX == 2) cp_async16(dst + C::PATCH, ch.x2 + off, ok);
    } else {
      s.template elems8<C::NX, C::PATCH>(dst, n, y, x, c0, in);
    }
  }
}

// A fragment (x4) of m16 tile t of the tile's pixels at tap (ky, kx); the
// lane's row is pixel a_px of the tile, its chunk a_c. Where NX == 2 the
// fragment of x2 is added (one rounding, as the plain x + x2).
template <class C>
__device__ __forceinline__ void pipe_a_frag(uint32_t (&af)[4],
                                            uint32_t pbase, int t, int ky,
                                            int kx, int a_px, int a_c) {
  const int py = C::TW == 16 ? t : t / (C::TW / 16);
  const int px0 = C::TW == 16 ? 0 : (t % (C::TW / 16)) * 16;
  const int off = C::patch_off(py * C::S + ky, (px0 + a_px) * C::S + kx, a_c);
  ldsm_x4(af, pbase + 2 * off);
  if constexpr (C::NX == 2) {
    uint32_t a2[4];
    ldsm_x4(a2, pbase + 2 * (C::PATCH + off));
#pragma unroll
    for (int i = 0; i < 4; ++i) af[i] = add_bf16x2(af[i], a2[i]);
  }
}

// The 9 taps of one staged K slice into acc (pbase: the stage's patch,
// wbase: its weight rows): a tap's A fragments are held, the B fragments
// streamed.
template <class C>
__device__ __forceinline__ void pipe_mma_stage(
    float (&acc)[C::MT][C::NT][4], uint32_t pbase, uint32_t wbase, int wm,
    int a_px, int a_c, int b_off) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    uint32_t af[C::MT][4];
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
      pipe_a_frag<C>(af[mt], pbase, wm * C::MT + mt, ky, kx, a_px, a_c);
#pragma unroll
    for (int jj = 0; jj < C::NT / 2; ++jj) {
      uint32_t bfr[4];
      ldsm_x4(bfr, wbase + 2 * ((tap * C::BN + jj * 16) * C::KC + b_off));
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        mma_bf16(acc[mt][2 * jj], af[mt], bfr);
        mma_bf16(acc[mt][2 * jj + 1], af[mt], bfr + 2);
      }
    }
  }
}

// Lane constants of the fragment loads. A (x4): matrices (px 0-7, k 0-7),
// (px 8-15, k 0-7), (px 0-7, k 8-15), (px 8-15, k 8-15); B (x4, per 16
// channels): (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k
// 8-15). b_off: the lane's B row in a weight stage of BN rows a tap, for
// the warp's channels from n_w; rows 16 apart keep the swizzle, so channel
// group jj is at + jj * 16 rows.
struct PipeLane {
  int a_px, a_c, b_n, b_c;
  __device__ __forceinline__ PipeLane(int lane)
      : a_px((lane & 7) + ((lane >> 3) & 1) * 8), a_c(lane >> 4),
        b_n(((lane >> 4) << 3) + (lane & 7)), b_c((lane >> 3) & 1) {}
  __device__ __forceinline__ int b_off(int n_w) const {
    return swz<2>(n_w + b_n, b_c);
  }
};

// The whole K loop of one block tile into acc (zeroed here). Leaves every
// copy complete and the ring free (the caller may reuse the shared memory
// after a __syncthreads).
template <class C, class Src>
__device__ __forceinline__ void pipe_conv_tile(
    float (&acc)[C::MT][C::NT][4], const Src& s, bf16* sm, int n,
    int oy0, int ox0, int n0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int iy0 = oy0 * C::S - 1, ix0 = ox0 * C::S - 1;
  const int nk = s.CinP / C::KC;
#pragma unroll
  for (int st = 0; st < C::STAGES - 1; ++st) {
    if (st < nk)
      pipe_load<C>(sm + st * C::STAGE, s, n, iy0, ix0, n0, st * C::KC);
    cp_async_commit();
  }
  const PipeLane pl(lane);
  const int b_off = pl.b_off(wn * (C::BN / 2));

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();                 // stage kt landed; stage kt-1 consumed
    const int nxt = kt + C::STAGES - 1;
    if (nxt < nk)
      pipe_load<C>(sm + (nxt % C::STAGES) * C::STAGE, s, n, iy0, ix0, n0,
                   nxt * C::KC);
    cp_async_commit();
    const bf16* st = sm + (kt % C::STAGES) * C::STAGE;
    pipe_mma_stage<C>(acc, smem_u32(st), smem_u32(st + C::NX * C::PATCH), wm,
                      pl.a_px, pl.a_c, b_off);
  }
  cp_async_wait<0>();
}

// The block's output tile and channel block (see the grid above).
struct PipeBlock {
  int n, oy0, ox0, n0;
};

template <class C>
__device__ __forceinline__ PipeBlock pipe_block(int Wo, int CoutP) {
  const int nb = CoutP / C::BN;
  const int tile = blockIdx.x / nb, cb = blockIdx.x - tile * nb;
  const int tiles_x = cdiv(Wo, C::TW);
  const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
  return {static_cast<int>(blockIdx.y), ty * C::TH, tx * C::TW, cb * C::BN};
}

// Epilogue, first half: bias (packed, CoutP entries) and act in fp32, one
// rounding to bf16, into the staging tile ``os`` [TH * TW][OS] (the ring,
// after a barrier). The row stride OS = BN + 8 spreads a warp's pair stores
// over the banks.
template <class C>
__device__ __forceinline__ void pipe_stage_out(
    const float (&acc)[C::MT][C::NT][4], const float* bias, int n0, int act,
    bf16* os) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      const int c = wn * (C::BN / 2) + nt * 8 + 2 * tg;
      const float b0 = bias[n0 + c], b1 = bias[n0 + c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm * C::MT + mt) * 16 + g + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(os + r * C::OS + c) =
            __floats2bfloat162_rn(apply_act(acc[mt][nt][2 * h] + b0, act),
                                  apply_act(acc[mt][nt][2 * h + 1] + b1, act));
      }
    }
}

// Epilogue, second half (after a barrier): each output pixel's run of the
// block's channels, 16 bytes a store where ``vec_out`` (every 8-channel run
// lands 16-byte aligned), else element by element. ``off(n, oy, ox, o)`` is
// the element offset of channel o of output pixel (oy, ox) of frame n in y.
template <class C, class Off>
__device__ __forceinline__ void pipe_store(const bf16* os, bf16* y,
                                           const PipeBlock& blk, int Ho,
                                           int Wo, int Cout, bool vec_out,
                                           Off off) {
  constexpr int kChunks = C::BN / 8;
  for (int q = threadIdx.x; q < C::TH * C::TW * kChunks; q += kThreads) {
    const int r = q / kChunks, ch = q - r * kChunks;
    const int oy = blk.oy0 + r / C::TW, ox = blk.ox0 + r % C::TW;
    const int o = blk.n0 + ch * 8;
    if (oy >= Ho || ox >= Wo || o >= Cout) continue;
    const bf16* src = os + r * C::OS + ch * 8;
    if (vec_out) {
      *reinterpret_cast<uint4*>(y + off(blk.n, oy, ox, o)) =
          *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && o + e < Cout; ++e)
        y[off(blk.n, oy, ox, o + e)] = src[e];
    }
  }
}

// The body of a pipelined conv kernel (grid of pipe_launch): this block's
// K loop, then the epilogue through the freed ring into y (Ho x Wo output
// frames, ``off`` as in pipe_store).
template <class C, class Src, class Off>
__device__ __forceinline__ void pipe_conv_block(const Src& s,
                                                const float* bias, int act,
                                                bf16* y, int Ho, int Wo,
                                                int CoutP, int Cout,
                                                bool vec_out, Off off) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const PipeBlock blk = pipe_block<C>(Wo, CoutP);
  float acc[C::MT][C::NT][4];
  pipe_conv_tile<C>(acc, s, sm, blk.n, blk.oy0, blk.ox0, blk.n0);
  __syncthreads();                   // the ring becomes the staging tile
  pipe_stage_out<C>(acc, bias, blk.n0, act, sm);
  __syncthreads();
  pipe_store<C>(sm, y, blk, Ho, Wo, Cout, vec_out, off);
}

// Launch a pipelined kernel over an Ho x Wo output of N frames.
template <class C, class Args>
inline int pipe_launch(void (*kern)(Args), const Args& a, int Ho, int Wo,
                       int CoutP, int N, cudaStream_t stream) {
  cudaError_t e = set_smem(kern, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(cdiv(Ho, C::TH) * cdiv(Wo, C::TW) * (CoutP / C::BN), N);
  kern<<<grid, kThreads, C::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bsvd
