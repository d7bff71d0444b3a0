// nv12_rgb: a window of NV12 frames -> RGB uint8, as cv2's FFmpeg backend
// gives an H.264 4:2:0 frame after cvtColor(BGR2RGB).
//
// Replaces no TPU kernel: the JAX package decodes mp4 clips on the host
// (cv2, bsvd_tpu/data/video_train_loader.py:114-127), where swscale
// converts each whole frame to BGR. The port decodes on NVDEC
// (data/nvdec.py), keeps the NV12 frames on the card, and this kernel
// converts only the train window: (T, H*3/2, W) NV12 (luma rows, then the
// Cb Cr interleaved rows) and (y0, x0, ch, cw) -> (T, ch, cw, 3) RGB.
//
// The rule is swscale's unscaled yuv420p -> bgr24 path on x86 (the
// SSSE3 / AVX2 yuv2rgb code cv2 runs for BT.601 limited range, FFmpeg's
// default matrix): 16-bit fixed point with pmulhw, each product floored,
//   y  = ((8 Y - 128) * 9539) >> 16
//   B  = clip(y + ((8 (U - 128) * 16525) >> 16))
//   G  = clip(y + ((8 (U - 128) * -3209) >> 16)
//              + ((8 (V - 128) * -6660) >> 16))
//   R  = clip(y + ((8 (V - 128) * 13075) >> 16))
// with clip to [0, 255], and chroma taken from the sample of the pixel's
// 2 x 2 block (no interpolation): Cb Cr at chroma row y / 2, column x / 2
// of the whole frame, so an odd y0 or x0 picks the right sample. The
// coefficients are roundToInt16(c * 2^13) of swscale's BT.601 table
// (crv 104597, cbu 132201, cgu 25675, cgv 53279, over 2^16) with the luma
// gain 255/219. Found against cv2 5.0 (libswscale 9.5) on frames decoded
// from the port's fixture writer (tools/make_video_fixtures.py): equal on
// every one of the 2^24 (Y, Cb, Cr) triples, and at widths 120, 128, 136
// and 854 (tests/test_torch_video.py holds data/yuv.py's plain version to
// cv2). Integer arithmetic only: the kernel equals the plain version bit
// for bit.
//
// What bounds it: bytes. Each output pixel reads 1 luma byte and a share
// of 2 chroma bytes and writes 3 bytes, with a handful of integer
// operations: at 3.35 TB/s one 11 x 96 x 96 window of the c64 train
// yml (1.5 bytes read and 3 written a pixel) takes ~0.14 us of memory
// time, far under its launch. One thread a pixel, the threads of a warp
// on neighbouring pixels of a row, so the luma reads and the 3-byte
// stores of a warp fall on one or two 128-byte lines.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint8_t clip8(int v) {
  return static_cast<uint8_t>(min(max(v, 0), 255));
}

__global__ void nv12_rgb_kernel(const uint8_t* __restrict__ nv12,
                                uint8_t* __restrict__ rgb, int T, int H,
                                int W, int y0, int x0, int ch, int cw) {
  const long long n = static_cast<long long>(T) * ch * cw;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % cw);
    const long long tr = i / cw;
    const int r = static_cast<int>(tr % ch);
    const int t = static_cast<int>(tr / ch);
    const int y = y0 + r, x = x0 + c;
    const uint8_t* frame = nv12 + static_cast<long long>(t) * (H + H / 2) * W;
    const int Y = frame[static_cast<long long>(y) * W + x];
    const uint8_t* uv =
        frame + static_cast<long long>(H + y / 2) * W + (x & ~1);
    const int U = 8 * (uv[0] - 128), V = 8 * (uv[1] - 128);
    const int yy = ((8 * Y - 128) * 9539) >> 16;
    uint8_t* out = rgb + i * 3;
    out[0] = clip8(yy + ((V * 13075) >> 16));
    out[1] = clip8(yy + ((U * -3209) >> 16) + ((V * -6660) >> 16));
    out[2] = clip8(yy + ((U * 16525) >> 16));
  }
}

}  // namespace

extern "C" int bsvd_nv12_rgb(const void* nv12, void* rgb, int T, int H,
                             int W, int y0, int x0, int ch, int cw,
                             void* stream) {
  const long long n = static_cast<long long>(T) * ch * cw;
  if (n == 0) return cudaGetLastError();
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  nv12_rgb_kernel<<<static_cast<int>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(nv12), static_cast<uint8_t*>(rgb), T, H,
      W, y0, x0, ch, cw);
  return cudaGetLastError();
}
