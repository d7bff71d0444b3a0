// Pipelined tile machinery for the port's bf16 conv kernels (sm_90a):
// cp.async copies into a ring of shared-memory stages, XOR-swizzled
// channels-last tiles, and ldmatrix fragment loads for mma.sync.
//
// A tile row is one pixel of 8 * CH channels (CH 16-byte chunks). Chunk c of
// row r sits at chunk position c ^ f(r), so that any 8 consecutive rows read
// at one logical chunk hit 8 distinct 16-byte bank groups: ldmatrix reads 8
// rows of 16 bytes at once, and a tap's shifted window starts at any row.
//
// The operands of a 3x3 conv (or of its weight gradient) at one tap are the
// tile shifted by a pixel offset. ldmatrix takes one row address per lane,
// so the shift is free (K4 here, and K7's narrow blocks). wgmma reads its
// shared-memory operand through a descriptor of 8-row x 16-byte core
// matrices at fixed strides: K7's 64 x 64 block stores its patch
// chunk-major ([8-channel chunk][pixel][8]) so that 8 consecutive pixels
// are one core matrix at any pixel offset, and the shift becomes the
// descriptor's start address (conv3x3_dw.cu). K4 on wgmma the same way is
// the next step.

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

// ---- K4's pipelined implicit GEMM ------------------------------------------
//
// One block: a 16 x 16 output tile (GEMM M = 256 pixels) times 128 output
// channels (N), K = 9 taps x CinP, in stages of 16 input channels. A stage
// holds the 18 x 18 halo patch (rows: pixels, 2 chunks) and the 9 x 128
// weight rows of its 16 channels (rows: tap * 128 + n, 2 chunks); kPipeStages
// stages are in flight. Warps: 4 (4 output rows each) x 2 (64 channels
// each); acc[mt][nt][e] is output row wm * 4 + mt, column g + 8 * (e / 2),
// channel wn * 64 + nt * 8 + 2 * tg + e % 2.

constexpr int kPipeTH = 16, kPipeTW = 16;
constexpr int kPipePH = kPipeTH + 2, kPipePW = kPipeTW + 2;
constexpr int kPipeBN = 128;
constexpr int kPipeKC = 16;
constexpr int kPipeStages = 4;
constexpr int kPipePatch = kPipePH * kPipePW * kPipeKC;   // elements
constexpr int kPipeWts = 9 * kPipeBN * kPipeKC;
constexpr int kPipeStage = kPipePatch + kPipeWts;
constexpr size_t kPipeSmem = (size_t)kPipeStages * kPipeStage * sizeof(bf16);

struct PipeSrc {
  const bf16* x;     // (N, H, W, C)
  const bf16* w;     // packed (CoutP, 3, 3, CinP)
  int H, W, C, CinP;
  int vec;           // C % 8 == 0 and 16-byte aligned: cp.async the patch
};

// Start the copies of K slice k0 into stage ``st``. Patch chunks outside the
// image or past C are zero-filled; without ``vec`` the patch is read
// element by element and stored synchronously (visible after the barrier
// that precedes its use, like the copies).
__device__ __forceinline__ void pipe_load(bf16* st, const PipeSrc& s, int n,
                                          int oy0, int ox0, int n0, int k0) {
  bf16* patch = st;
  bf16* wsm = st + kPipePatch;
  const int tid = threadIdx.x;
  const bf16* wb = s.w + (long long)n0 * 9 * s.CinP + k0;
#pragma unroll
  for (int i = 0; i < 9 * kPipeBN * 2 / kThreads; ++i) {
    const int q = tid + i * kThreads;
    const int row = q >> 1, c = q & 1;          // row = n * 9 + tap
    const int nn = row / 9, tap = row - nn * 9;
    cp_async16(wsm + swz<2>(tap * kPipeBN + nn, c),
               wb + (long long)row * s.CinP + c * 8, true);
  }
  for (int q = tid; q < kPipePH * kPipePW * 2; q += kThreads) {
    const int pix = q >> 1, c = q & 1;
    const int py = pix / kPipePW, px = pix - py * kPipePW;
    const int y = oy0 - 1 + py, x = ox0 - 1 + px, c0 = k0 + c * 8;
    const bool in = y >= 0 && y < s.H && x >= 0 && x < s.W && c0 < s.C;
    bf16* dst = patch + swz<2>(pix, c);
    const long long off = (((long long)n * s.H + y) * s.W + x) * s.C + c0;
    if (s.vec) {
      cp_async16(dst, in ? s.x + off : s.x, in);
    } else {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = in && c0 + j < s.C ? __bfloat162float(s.x[off + j]) : 0.f;
      store8(dst, v);
    }
  }
}

// The whole K loop of one block tile into acc (zeroed here). Leaves every
// copy complete and the ring free (the caller may reuse the shared memory
// after a __syncthreads).
__device__ __forceinline__ void pipe_conv_tile(float (&acc)[4][8][4],
                                               const PipeSrc& s, bf16* sm,
                                               int n, int oy0, int ox0,
                                               int n0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int nk = s.CinP / kPipeKC;
#pragma unroll
  for (int st = 0; st < kPipeStages - 1; ++st) {
    if (st < nk) pipe_load(sm + st * kPipeStage, s, n, oy0, ox0, n0,
                           st * kPipeKC);
    cp_async_commit();
  }
  // A (x4): matrices (px 0-7, k 0-7), (px 8-15, k 0-7), (px 0-7, k 8-15),
  // (px 8-15, k 8-15); B (x4, per 16 channels): (n 0-7, k 0-7),
  // (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15).
  const int a_px = (lane & 7) + ((lane >> 3) & 1) * 8, a_c = lane >> 4;
  const int b_n = ((lane >> 4) << 3) + (lane & 7), b_c = (lane >> 3) & 1;
  int b_off[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) b_off[jj] = swz<2>(wn * 64 + jj * 16 + b_n, b_c);

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kPipeStages - 2>();
    __syncthreads();                 // stage kt landed; stage kt-1 consumed
    const int nxt = kt + kPipeStages - 1;
    if (nxt < nk)
      pipe_load(sm + (nxt % kPipeStages) * kPipeStage, s, n, oy0, ox0, n0,
                nxt * kPipeKC);
    cp_async_commit();
    const bf16* st = sm + (kt % kPipeStages) * kPipeStage;
    const uint32_t pbase = smem_u32(st), wbase = smem_u32(st + kPipePatch);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int pix = (wm * 4 + mt + ky) * kPipePW + a_px + kx;
        ldsm_x4(af[mt], pbase + 2 * swz<2>(pix, a_c));
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bfr[4];
        ldsm_x4(bfr, wbase + 2 * (tap * kPipeBN * kPipeKC + b_off[jj]));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][2 * jj], af[mt], bfr);
          mma_bf16(acc[mt][2 * jj + 1], af[mt], bfr + 2);
        }
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace bsvd
