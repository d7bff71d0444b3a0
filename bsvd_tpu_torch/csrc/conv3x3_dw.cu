// K7 conv3x3_dw: weight gradient of a stride-1 pad-1 3x3 conv, NHWC.
//
//   dw[co, ci, ky, kx] = sum_{n, y, x} v[n, y + ky - 1, x + kx - 1, ci]
//                                      * dz[n, y, x, co]
//
// with v = shift(x [+ x2]) zero outside the image: the temporal shift and
// the second addend are read in the loader, as K1 reads them, so the
// shifted input of a shift-conv site never exists in device memory.
//
// Replaces bsvd_tpu/ops/conv3x3.py conv3x3_dw_pallas -> _kernel_dw. The TPU
// kernel walks row blocks in order and keeps the (9, Ci, Co) fp32 sum in a
// VMEM block that is the output. Blocks here run in parallel: block
// (co block, ci block, split) sums its share of the pixel tiles (tile s,
// s + splits, ...) into registers and writes one fp32 partial
// (splits, 9, CoutP, CinP); a second kernel adds the partials of a weight
// element in a fixed order, so two runs give the same bits (no atomics).
//
// What bounds it on the H100: tensor-core FLOPs (2 * 9 * Ci * Co per pixel;
// 1.80 TFLOP over the 28 sites of a c64 train step at batch 8, against
// ~0.5 GB of dz and inputs: far above the ridge). The 9-tap fp32
// accumulator caps a block at 64 x 64 channels (96-144 registers a thread),
// so the reduction (pixels) has to stream: the first design moved each
// 8 x 16 pixel tile into shared memory transposed, with scalar 2-byte stores
// between two barriers, then multiplied with mma.sync, and never overlapped
// the two. The bf16 design:
// - 8 x 8 pixel tiles (the 24-, 48- and 96-pixel train frames divide
//   evenly): dz (64 pixels x COB) and the 10 x 10 halo patch (100 pixels x
//   CIB) copied in their natural channels-last rows by cp.async into a
//   4-stage ring, three tiles in flight while one is multiplied;
// - 64 x 64 blocks on wgmma: three warpgroups, one per kernel row ky, each
//   m64n64k16 per tap (ky, kx) and 16 pixels. A = dz^T from registers
//   (ldmatrix.trans of the channels-last dz rows: the transpose happens in
//   the fragment load, and one fragment serves the row's three taps); B =
//   the patch at the tap, by descriptor. The patch is stored chunk-major
//   ([8-channel chunk][pixel][8], conv_pipe.cuh's note), so 8 consecutive
//   patch pixels are one 128-byte core matrix and the tap's shift is a
//   16-byte step of the descriptor's start address;
// - blocks for 4 input channels (64 x 16) and 3 output channels (16 x 64)
//   on mma.sync with ldmatrix.trans fragments (swizzled rows), instead of
//   padding them to 64; their 4- and 3-channel rows take the scalar loader;
// - the temporal shift is a per-8-channel source frame in the loader; a
//   clip edge or the image halo is a zero-filled copy; with an addend both
//   tensors are copied and summed once per stage in fp32 and rounded once,
//   as read_group does; groups that straddle a shift region or have
//   C % 8 != 0 take the synchronous scalar loader;
// - one block per SM over all its tiles (splits x channel blocks <= the
//   SM count, from the wrapper), so the ring's prologue runs once a block.
// Still short of the card: a 64-wide wgmma (N = the 64 input channels that
// the 9-tap accumulator leaves room for) and one barrier per 64 pixels.
// The fp32 instantiation keeps the first design's FMA walk (transposing
// loader, 8 x 16 tiles): it is the exactness reference of the card's
// parity checks, not a speed path.

#include "conv_pipe.cuh"

namespace bsvd {

struct DwArgs {
  const void* x;
  const void* x2;
  const void* dz;
  float* part;       // (splits, 9, CoutP, CinP)
  float* out;        // (Cout, Cin, 3, 3)
  int N, H, W, Cin, Cout, CinP, CoutP;
  int t_len, fold, shift, vec_x, vec_dz, splits, cfg;
};

__device__ __forceinline__ Src<bf16> dw_src_x(const DwArgs& a) {
  Src<bf16> s;
  s.x = static_cast<const bf16*>(a.x);
  s.x2 = static_cast<const bf16*>(a.x2);
  s.H = a.H; s.W = a.W; s.C = a.Cin;
  s.t_len = a.t_len; s.fold = a.fold; s.shift = a.shift; s.vec = a.vec_x;
  return s;
}

__device__ __forceinline__ Src<bf16> dw_src_dz(const DwArgs& a) {
  Src<bf16> s;
  s.x = static_cast<const bf16*>(a.dz);
  s.x2 = nullptr;
  s.H = a.H; s.W = a.W; s.C = a.Cout;
  s.t_len = 1; s.fold = 0; s.shift = kShiftNone; s.vec = a.vec_dz;
  return s;
}

// ---- bf16: pipelined, ldmatrix.trans + mma.sync ----------------------------

constexpr int kDwT = 8;                          // pixel tile: 8 x 8
constexpr int kDwTP = kDwT * kDwT;
constexpr int kDwP = kDwT + 2;                   // halo patch: 10 x 10
constexpr int kDwPP = kDwP * kDwP;
constexpr int kDwStages = 4;

// mma.sync blocks (the narrow sites): WARPS_M x WARPS_N warps; a warp owns
// MT m16 tiles of output channels, NT n8 tiles of input channels, all 9
// taps. Patch rows swizzled for ldmatrix.
template <int WARPS_M, int WARPS_N, int MT, int NT>
struct DwCfg {
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int COB = WARPS_M * MT * 16;  // output channels a block
  static constexpr int CIB = WARPS_N * NT * 8;   // input channels a block
  static constexpr int ZCH = COB / 8, XCH = CIB / 8;
  static constexpr int Z = kDwTP * COB;          // elements of a dz tile
  static constexpr int X = kDwPP * CIB;          // of a patch
  static constexpr bool XCM = false;             // patch chunk-major
};

// The wgmma block (64 x 64 channels): three warpgroups, one per kernel row
// ky; warp q of a warpgroup holds output channels 16q..16q+15 of dz^T. The
// patch is chunk-major, [8-channel chunk][pixel][8], unswizzled, so that 8
// consecutive patch pixels of a chunk are one 128-byte core matrix and a
// tap's shifted window is a descriptor at any pixel offset.
struct DwWg {
  static constexpr int THREADS = 384;
  static constexpr int COB = 64, CIB = 64;
  static constexpr int ZCH = COB / 8, XCH = CIB / 8;
  static constexpr int Z = kDwTP * COB;
  static constexpr int X = kDwPP * CIB;
  static constexpr bool XCM = true;
};

// Copy (or, where the layout forbids cp.async, load and store) pixel tile
// ``tile`` into stage (zs, xs[, x2s]).
template <class C>
__device__ void dw_load(bf16* zs, bf16* xs, bf16* x2s, const DwArgs& a,
                        const Src<bf16>& sx, const Src<bf16>& sz, int tile,
                        int co0, int ci0) {
  const int tiles_x = cdiv(a.W, kDwT), per_frame = tiles_x * cdiv(a.H, kDwT);
  const int n = tile / per_frame, rem = tile - n * per_frame;
  const int oy0 = (rem / tiles_x) * kDwT, ox0 = (rem % tiles_x) * kDwT;
  const long long plane = (long long)a.H * a.W;
  const bf16* dzf = sz.x + n * plane * a.Cout;
  for (int q = threadIdx.x; q < kDwTP * C::ZCH; q += C::THREADS) {
    const int pix = q / C::ZCH, c = q - pix * C::ZCH;
    const int y = oy0 + pix / kDwT, x = ox0 + pix % kDwT, c0 = co0 + c * 8;
    const bool in = y < a.H && x < a.W && c0 < a.Cout;
    bf16* dst = zs + swz<C::ZCH>(pix, c);
    if (a.vec_dz) {
      cp_async16(dst, in ? dzf + (y * a.W + x) * a.Cout + c0 : sz.x, in);
    } else {
      float v[8];
      if (in) {
        read_group(sz, n, y, x, c0, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
      store8(dst, v);
    }
  }
  // the source frame of each shift region, once a tile
  const int f0 = region_frame(0, n, a.shift, a.t_len);
  const int f1 = region_frame(1, n, a.shift, a.t_len);
  const int f2 = region_frame(2, n, a.shift, a.t_len);
  const float zero8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int q = threadIdx.x; q < kDwPP * C::XCH; q += C::THREADS) {
    const int pix = q / C::XCH, c = q - pix * C::XCH;
    const int y = oy0 - 1 + pix / kDwP, x = ox0 - 1 + pix % kDwP;
    const int c0 = ci0 + c * 8;
    const bool in = y >= 0 && y < a.H && x >= 0 && x < a.W && c0 < a.Cin;
    const int off_s = C::XCM ? (c * kDwPP + pix) * 8 : swz<C::XCH>(pix, c);
    const int r = region_of(c0, a.shift, a.fold);
    if (a.vec_x && (!in || r == region_of(c0 + 7, a.shift, a.fold))) {
      const int f = !in ? -1 : r == 0 ? f0 : r == 1 ? f1 : f2;
      const long long off = f * plane * a.Cin + (y * a.W + x) * a.Cin + c0;
      cp_async16(xs + off_s, f >= 0 ? sx.x + off : sx.x, f >= 0);
      if (x2s) cp_async16(x2s + off_s, f >= 0 ? sx.x2 + off : sx.x2, f >= 0);
    } else {
      float v[8];
      if (in) {
        read_group(sx, n, y, x, c0, v);  // x + x2 summed, one rounding
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
      store8(xs + off_s, v);
      if (x2s) store8(x2s + off_s, zero8);
    }
  }
}

template <int WARPS_M, int WARPS_N, int MT, int NT>
__global__ void __launch_bounds__(DwCfg<WARPS_M, WARPS_N, MT, NT>::THREADS, 1)
conv3x3_dw_bf16_kernel(DwArgs a) {
  using C = DwCfg<WARPS_M, WARPS_N, MT, NT>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const bool has_x2 = a.x2 != nullptr;
  const int stage = C::Z + C::X * (has_x2 ? 2 : 1);

  const int co0 = blockIdx.x * C::COB, ci0 = blockIdx.y * C::CIB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int ntiles = a.N * cdiv(a.H, kDwT) * cdiv(a.W, kDwT);
  const int mine = (ntiles - (int)blockIdx.z + a.splits - 1) / a.splits;
  const Src<bf16> sx = dw_src_x(a), sz = dw_src_dz(a);

  float acc[9][MT][NT][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][i][j][e] = 0.f;

  auto load = [&](int i) {
    bf16* st = sm + (i % kDwStages) * stage;
    dw_load<C>(st, st + C::Z, has_x2 ? st + C::Z + C::X : nullptr, a, sx, sz,
               (int)blockIdx.z + i * a.splits, co0, ci0);
  };
#pragma unroll
  for (int i = 0; i < kDwStages - 1; ++i) {
    if (i < mine) load(i);
    cp_async_commit();
  }

  // A = dz^T (x4.trans): matrices (co 0-7, px 0-7), (co 8-15, px 0-7),
  // (co 0-7, px 8-15), (co 8-15, px 8-15). B = v at a tap (x4.trans per 16
  // input channels): (px 0-7, ci 0-7), (px 8-15, ci 0-7), (px 0-7, ci 8-15),
  // (px 8-15, ci 8-15); x2.trans for one n8 tile. The B rows of tap t start
  // at patch pixel b_pix + (2s + t / 3) * kDwP + t % 3.
  const int m = lane >> 3, r8 = lane & 7;
  const int a_px = ((m >> 1) << 3) + r8;
  const int a_c = (wm * MT * 16 + ((m & 1) << 3)) >> 3;
  const int b_pix = (m & 1) * kDwP + r8;
  const int b_c = (wn * NT * 8 + ((m >> 1) << 3)) >> 3;

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();                 // tile i landed; tile i-1 consumed
    if (i + kDwStages - 1 < mine) load(i + kDwStages - 1);
    cp_async_commit();
    bf16* zs = sm + (i % kDwStages) * stage;
    bf16* xs = zs + C::Z;
    if (has_x2) {                    // v = x + x2, fp32 sum, one rounding
      const bf16* x2s = xs + C::X;
      for (int q = threadIdx.x; q < C::X / 8; q += C::THREADS) {
        float u[8], w[8];
        load8(xs + q * 8, u);
        load8(x2s + q * 8, w);
#pragma unroll
        for (int j = 0; j < 8; ++j) u[j] += w[j];
        store8(xs + q * 8, u);
      }
      __syncthreads();
    }
    const uint32_t zb = smem_u32(zs), xb = smem_u32(xs);
#pragma unroll
    for (int s = 0; s < kDwTP / 16; ++s) {   // tile rows 2s, 2s + 1
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4_t(af[mt],
                  zb + 2 * swz<C::ZCH>(16 * s + a_px, a_c + mt * 2));
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int pix = b_pix + (2 * s + t / 3) * kDwP + t % 3;
        if constexpr (NT % 2 == 0) {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bfr[4];
            ldsm_x4_t(bfr, xb + 2 * swz<C::XCH>(pix, b_c + np * 2));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(acc[t][mt][2 * np], af[mt], bfr);
              mma_bf16(acc[t][mt][2 * np + 1], af[mt], bfr + 2);
            }
          }
        } else {
          uint32_t bfr[2];
          ldsm_x2_t(bfr, xb + 2 * swz<C::XCH>(pix, wn * NT));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[t][mt][0], af[mt], bfr);
        }
      }
    }
  }
  cp_async_wait<0>();

  // partial sums of this split, float2 per (co, ci pair)
  const int g = lane >> 2, tg = lane & 3;
  float* part = a.part + (long long)blockIdx.z * 9 * a.CoutP * a.CinP;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tap = t;
          const int co = co0 + (wm * MT + mt) * 16 + g + 8 * h;
          const int ci = ci0 + (wn * NT + nt) * 8 + 2 * tg;
          *reinterpret_cast<float2*>(
              part + ((long long)tap * a.CoutP + co) * a.CinP + ci) =
              make_float2(acc[t][mt][nt][2 * h], acc[t][mt][nt][2 * h + 1]);
        }
}

// ---- bf16, 64 x 64 blocks: wgmma -------------------------------------------

// Shared-memory matrix descriptor, no swizzle: core matrices of 8 rows x 16
// bytes; for an MN-major operand ``lbo`` is the byte step between core
// matrices along K, ``sbo`` along M / N.
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Generic-proxy writes to shared memory (stores, cp.async) made visible to
// the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 fp32 over the warpgroup) += A (64 x 16 bf16 from registers,
// the mma.sync m16k16 fragment of each warp's 16 rows) * B (16 x 64 bf16,
// MN-major in shared memory).
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__global__ void __launch_bounds__(DwWg::THREADS, 1)
conv3x3_dw_wgmma_kernel(DwArgs a) {
  using C = DwWg;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const bool has_x2 = a.x2 != nullptr;
  const int stage = C::Z + C::X * (has_x2 ? 2 : 1);

  const int co0 = blockIdx.x * C::COB, ci0 = blockIdx.y * C::CIB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ky = warp >> 2, wq = warp & 3;
  const int ntiles = a.N * cdiv(a.H, kDwT) * cdiv(a.W, kDwT);
  const int mine = (ntiles - (int)blockIdx.z + a.splits - 1) / a.splits;
  const Src<bf16> sx = dw_src_x(a), sz = dw_src_dz(a);

  float acc[3][32];                  // taps (ky, kx = 0..2)
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[t][e] = 0.f;

  auto load = [&](int i) {
    bf16* st = sm + (i % kDwStages) * stage;
    dw_load<C>(st, st + C::Z, has_x2 ? st + C::Z + C::X : nullptr, a, sx, sz,
               (int)blockIdx.z + i * a.splits, co0, ci0);
  };
#pragma unroll
  for (int i = 0; i < kDwStages - 1; ++i) {
    if (i < mine) load(i);
    cp_async_commit();
  }
  // A = dz^T rows 16 wq.. (x4.trans): (co 0-7, px 0-7), (co 8-15, px 0-7),
  // (co 0-7, px 8-15), (co 8-15, px 8-15)
  const int m = lane >> 3;
  const int a_px = ((m >> 1) << 3) + (lane & 7);
  const int a_c = wq * 2 + (m & 1);

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kDwStages - 2>();
    fence_async_smem();
    __syncthreads();                 // tile i landed; tile i-1 consumed
    if (i + kDwStages - 1 < mine) load(i + kDwStages - 1);
    cp_async_commit();
    bf16* zs = sm + (i % kDwStages) * stage;
    bf16* xs = zs + C::Z;
    if (has_x2) {                    // v = x + x2, fp32 sum, one rounding
      const bf16* x2s = xs + C::X;
      for (int q = threadIdx.x; q < C::X / 8; q += C::THREADS) {
        float u[8], w[8];
        load8(xs + q * 8, u);
        load8(x2s + q * 8, w);
#pragma unroll
        for (int j = 0; j < 8; ++j) u[j] += w[j];
        store8(xs + q * 8, u);
      }
      fence_async_smem();
      __syncthreads();
    }
    const uint32_t zb = smem_u32(zs), xb = smem_u32(xs);
    uint32_t af[kDwTP / 16][4];
#pragma unroll
    for (int s = 0; s < kDwTP / 16; ++s)
      ldsm_x4_t(af[s], zb + 2 * swz<C::ZCH>(16 * s + a_px, a_c));
    wg_fence();
#pragma unroll
    for (int s = 0; s < kDwTP / 16; ++s)     // tile rows 2s, 2s + 1
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        // B rows k = 0-7: patch pixels (2s + ky) * kDwP + kx + 0..7; rows
        // 8-15 one patch row on; 8-channel chunks kDwPP pixels apart
        const uint32_t addr = xb + 16 * ((2 * s + ky) * kDwP + kx);
        wgmma_64x64x16(acc[kx], af[s], wg_desc(addr, 16 * kDwP, 16 * kDwPP));
      }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) pin(acc[kx]);
  }
  cp_async_wait<0>();

  // partial sums: acc[kx][4j + e] is output channel 16 wq + g + 8 (e / 2),
  // input channel 8 j + 2 tg + e % 2
  const int g = lane >> 2, tg = lane & 3;
  float* part = a.part + (long long)blockIdx.z * 9 * a.CoutP * a.CinP;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = co0 + wq * 16 + g + 8 * h;
        const int ci = ci0 + j * 8 + 2 * tg;
        *reinterpret_cast<float2*>(
            part + ((long long)(ky * 3 + kx) * a.CoutP + co) * a.CinP + ci) =
            make_float2(acc[kx][4 * j + 2 * h], acc[kx][4 * j + 2 * h + 1]);
      }
}

// ---- fp32: the simple FMA walk, an exactness reference ----------------------

constexpr int kDwCO = 64;                    // output channels (GEMM M)
constexpr int kDwCI = 32;                    // input channels (GEMM N)
constexpr int kDwPix = kTH * kTW;            // 128 pixels a tile
constexpr int kDwPH = kTH + 2, kDwPW = kTW + 2;
constexpr int kDwZS = kDwPix + 8;            // smem stride of a dz^T row
constexpr int kDwXS = 200;                   // smem stride of a v^T row (>= 180)

// One tile's contribution, in the mma accumulator layout.
__device__ __forceinline__ void dw_tile_fma(float (&acc)[9][2][4],
                                            const float* zt, const float* xt,
                                            int wm, int wn, int lane) {
  const int g = lane >> 2, tg = lane & 3;
  for (int r = 0; r < kTH; ++r) {
#pragma unroll 2
    for (int k = 0; k < kTW; ++k) {
      const float a0 = zt[(wm * 16 + g) * kDwZS + r * kTW + k];
      const float a1 = zt[(wm * 16 + g + 8) * kDwZS + r * kTW + k];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int pp = (r + tap / 3) * kDwPW + k + tap % 3;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float bv = xt[(wn * 16 + nt * 8 + 2 * tg + j) * kDwXS + pp];
            acc[tap][nt][j] += a0 * bv;
            acc[tap][nt][2 + j] += a1 * bv;
          }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) conv3x3_dw_fma_kernel(DwArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* zt = reinterpret_cast<float*>(smem_raw);   // [kDwCO][kDwZS]
  float* xt = zt + kDwCO * kDwZS;                     // [kDwCI][kDwXS]

  const int co0 = blockIdx.x * kDwCO, ci0 = blockIdx.y * kDwCI;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int tiles_x = (a.W + kTW - 1) / kTW, tiles_y = (a.H + kTH - 1) / kTH;
  const int ntiles = a.N * tiles_y * tiles_x;

  Src<float> sx;
  sx.x = static_cast<const float*>(a.x);
  sx.x2 = static_cast<const float*>(a.x2);
  sx.H = a.H; sx.W = a.W; sx.C = a.Cin;
  sx.t_len = a.t_len; sx.fold = a.fold; sx.shift = a.shift; sx.vec = a.vec_x;
  Src<float> sz;
  sz.x = static_cast<const float*>(a.dz);
  sz.x2 = nullptr;
  sz.H = a.H; sz.W = a.W; sz.C = a.Cout;
  sz.t_len = 1; sz.fold = 0; sz.shift = kShiftNone; sz.vec = a.vec_dz;

  float acc[9][2][4];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][i][e] = 0.f;

  for (int tile = blockIdx.z; tile < ntiles; tile += a.splits) {
    const int n = tile / (tiles_y * tiles_x);
    const int rem = tile - n * tiles_y * tiles_x;
    const int oy0 = (rem / tiles_x) * kTH, ox0 = (rem % tiles_x) * kTW;
    __syncthreads();                               // previous tile consumed
    // dz^T: 128 pixels x 8 groups of 8 output channels
    for (int u = threadIdx.x; u < kDwPix * (kDwCO / 8); u += kThreads) {
      const int pix = u >> 3, grp = u & 7;
      const int y = oy0 + pix / kTW, x = ox0 + pix % kTW;
      const int c0 = co0 + grp * 8;
      float v[8];
      if (y < a.H && x < a.W && c0 < a.Cout) {
        read_group(sz, n, y, x, c0, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) zt[(grp * 8 + j) * kDwZS + pix] = v[j];
    }
    // v^T: the 10 x 18 halo patch x 4 groups of 8 input channels
    for (int u = threadIdx.x; u < kDwPH * kDwPW * (kDwCI / 8); u += kThreads) {
      const int pix = u >> 2, grp = u & 3;
      const int y = oy0 - 1 + pix / kDwPW, x = ox0 - 1 + pix % kDwPW;
      const int c0 = ci0 + grp * 8;
      float v[8];
      if (y >= 0 && y < a.H && x >= 0 && x < a.W && c0 < a.Cin) {
        read_group(sx, n, y, x, c0, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) xt[(grp * 8 + j) * kDwXS + pix] = v[j];
    }
    __syncthreads();
    dw_tile_fma(acc, zt, xt, wm, wn, lane);
  }

  const int g = lane >> 2, tg = lane & 3;
  float* part = a.part + (long long)blockIdx.z * 9 * a.CoutP * a.CinP;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = co0 + wm * 16 + g + (e >> 1) * 8;
        const int ci = ci0 + wn * 16 + nt * 8 + 2 * tg + (e & 1);
        part[((long long)tap * a.CoutP + co) * a.CinP + ci] = acc[tap][nt][e];
      }
}

// out[co, ci, tap] = the sum of the splits' partials in a fixed order, so
// two runs give the same bits. Block: 32 consecutive elements (tap, co, ci)
// x 8 warps; warp j adds splits j, j + 8, ... in order, then warp 0 adds
// the 8 sums in order. Many blocks and short chains: a split count of 132
// is summed at the latency of 17 loads, not 132.
constexpr int kRedWarps = 8;

__global__ void __launch_bounds__(32 * kRedWarps) conv3x3_dw_reduce(DwArgs a) {
  __shared__ float sums[kRedWarps][32];
  const long long plane = (long long)a.Cout * a.Cin;
  const long long e = blockIdx.x * 32LL + (threadIdx.x & 31);
  const int j = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int tap = 0, co = 0, ci = 0;
  float s = 0.f;
  if (e < 9 * plane) {
    tap = (int)(e / plane);
    const int rem = (int)(e - tap * plane);
    co = rem / a.Cin;
    ci = rem - co * a.Cin;
    const float* p = a.part + ((long long)tap * a.CoutP + co) * a.CinP + ci;
    const long long stride = 9LL * a.CoutP * a.CinP;
#pragma unroll 4
    for (int k = j; k < a.splits; k += kRedWarps) s += p[k * stride];
  }
  sums[j][lane] = s;
  __syncthreads();
  if (j == 0 && e < 9 * plane) {
    float t = sums[0][lane];
#pragma unroll
    for (int i = 1; i < kRedWarps; ++i) t += sums[i][lane];
    a.out[((long long)co * a.Cin + ci) * 9 + tap] = t;
  }
}

template <class C, class K>
static int launch_dw_bf16(K kern, const DwArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)kDwStages *
                      (C::Z + C::X * (a.x2 ? 2 : 1)) * sizeof(bf16);
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.CoutP / C::COB, a.CinP / C::CIB, a.splits);
  kern<<<grid, C::THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

static int launch_dw_fma(const DwArgs& a, cudaStream_t stream) {
  size_t smem = (kDwCO * kDwZS + kDwCI * kDwXS) * sizeof(float);
  auto kern = conv3x3_dw_fma_kernel;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.CoutP / kDwCO, a.CinP / kDwCI, a.splits);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

static int launch_dw(const DwArgs& a, int bf16_path, cudaStream_t stream) {
  int e;
  if (!bf16_path) {
    e = launch_dw_fma(a, stream);
  } else if (a.cfg == 1) {           // Cin <= 16: 64 x 16 block
    e = launch_dw_bf16<DwCfg<4, 2, 1, 1>>(
        conv3x3_dw_bf16_kernel<4, 2, 1, 1>, a, stream);
  } else if (a.cfg == 2) {           // Cout <= 16: 16 x 64 block
    e = launch_dw_bf16<DwCfg<1, 8, 1, 1>>(
        conv3x3_dw_bf16_kernel<1, 8, 1, 1>, a, stream);
  } else {                           // 64 x 64 block
    e = launch_dw_bf16<DwWg>(conv3x3_dw_wgmma_kernel, a, stream);
  }
  if (e != cudaSuccess) return e;
  const long long total = 9LL * a.Cout * a.Cin;
  conv3x3_dw_reduce<<<(int)((total + 31) / 32), 32 * kRedWarps, 0, stream>>>(
      a);
  return (int)cudaGetLastError();
}

}  // namespace bsvd

// dtype: 0 = float32, 1 = bfloat16. ``part`` holds splits * 9 * CoutP *
// CinP floats; ``out`` Cout * Cin * 9. fp32: CinP % 32 == 0, CoutP % 64 ==
// 0. bf16: ``cfg`` 0 (CinP, CoutP % 64 == 0), 1 (CinP % 16, CoutP % 64) or
// 2 (CinP % 64, CoutP % 16). Returns a cudaError_t code.
extern "C" int bsvd_conv3x3_dw(int dtype, const void* x, const void* x2,
                               const void* dz, void* part, void* out, int N,
                               int H, int W, int Cin, int Cout, int CinP,
                               int CoutP, int t_len, int fold, int shift,
                               int vec_x, int vec_dz, int splits, int cfg,
                               void* stream) {
  bsvd::DwArgs a{x, x2, dz, static_cast<float*>(part),
                 static_cast<float*>(out), N, H, W, Cin, Cout, CinP, CoutP,
                 t_len, fold, shift, vec_x, vec_dz, splits, cfg};
  return bsvd::launch_dw(a, dtype == 1, static_cast<cudaStream_t>(stream));
}
