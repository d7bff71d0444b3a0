// H.264 decoding on the card's NVDEC through NVIDIA's libnvcuvid, for
// the train loader's mp4 clips (data/nvdec.py; no counterpart in the JAX
// package, which decodes with cv2's FFmpeg on the host).
//
// The Video Codec SDK's headers are not on the machines this runs on, so
// the CUVID structs and calls below are declared here, with the layout of
// nvcuvid.h / cuviddec.h (SDK 9-12, 64-bit Linux: `unsigned long` is 64
// bits). Both libraries are dlopen()ed at first use: libnvcuvid.so.1 for
// the parser and the decoder, libcuda.so.1 for the context and the copies.
// Nothing links against CUDA, so this file builds with g++ alone.
//
// A wrong layout shows as an error or as planes that differ: the sequence
// callback checks NVDEC's coded size and display area against the SPS the
// caller read (data/h264_headers.py), the picture parameters pass from the
// parser to cuvidDecodePicture untouched (opaque), and the callers hold
// the decoded planes to the writer's bit for bit (tests, chip_smoke).
//
// One handle is one decoder kept by one thread for one clip. A decode
// call makes a parser, feeds the window's access units (Annex-B, SPS/PPS
// before each IDR, the display index as the timestamp), flushes it with an
// end-of-stream packet and destroys it; the decoder lives on while the
// stream's format stays. Each displayed frame whose index falls in the
// window is mapped and copied, cropped to the display size, into the
// caller's NV12 buffer (count, H * 3 / 2, W) on the caller's stream; the
// stream is synchronised before the frame is unmapped. bsvd_nvdec_parse
// runs the same parser with no decoder (the parser is host code): it
// reports the sequence, the pictures and the display order, so the
// parser's structs can be held to libnvcuvid where the video engine is
// not exposed to the process.

#include <dlfcn.h>

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>

namespace {

// ---- CUDA's low-level API (libcuda.so.1) -------------------------------
typedef int CUresult;
typedef void* CUcontext;
typedef void* CUstream;
typedef unsigned long long CUdeviceptr;

enum { CU_MEMORYTYPE_DEVICE = 2 };

struct CUDA_MEMCPY2D {
  size_t srcXInBytes, srcY;
  int srcMemoryType;
  const void* srcHost;
  CUdeviceptr srcDevice;
  void* srcArray;
  size_t srcPitch;
  size_t dstXInBytes, dstY;
  int dstMemoryType;
  void* dstHost;
  CUdeviceptr dstDevice;
  void* dstArray;
  size_t dstPitch;
  size_t WidthInBytes, Height;
};

// ---- CUVID (libnvcuvid.so.1) -------------------------------------------
enum { kCodecH264 = 4 };            // cudaVideoCodec_H264
enum { kChroma420 = 1 };            // cudaVideoChromaFormat_420
enum { kSurfaceNV12 = 0 };          // cudaVideoSurfaceFormat_NV12
enum { kDeinterlaceWeave = 0 };     // cudaVideoDeinterlaceMode_Weave
enum { kCreatePreferCUVID = 4 };    // cudaVideoCreate_PreferCUVID
enum {                              // CUvideopacketflags
  kPktEndOfStream = 0x01,
  kPktTimestamp = 0x02,
  kPktEndOfPicture = 0x08,
};

struct CUVIDDECODECAPS {
  int eCodecType;
  int eChromaFormat;
  unsigned int nBitDepthMinus8;
  unsigned int reserved1[3];
  unsigned char bIsSupported;
  unsigned char nNumNVDECs;
  unsigned short nOutputFormatMask;
  unsigned int nMaxWidth;
  unsigned int nMaxHeight;
  unsigned int nMaxMBCount;
  unsigned short nMinWidth;
  unsigned short nMinHeight;
  unsigned char bIsHistogramSupported;
  unsigned char nCounterBitDepth;
  unsigned short nMaxHistogramBins;
  unsigned int reserved3[10];
  unsigned int pad[16];             // room for later SDKs' fields
};

struct Rect16 { short left, top, right, bottom; };

struct CUVIDDECODECREATEINFO {
  unsigned long ulWidth;
  unsigned long ulHeight;
  unsigned long ulNumDecodeSurfaces;
  int CodecType;
  int ChromaFormat;
  unsigned long ulCreationFlags;
  unsigned long bitDepthMinus8;
  unsigned long ulIntraDecodeOnly;
  unsigned long ulMaxWidth;
  unsigned long ulMaxHeight;
  unsigned long Reserved1;
  Rect16 display_area;
  int OutputFormat;
  int DeinterlaceMode;
  unsigned long ulTargetWidth;
  unsigned long ulTargetHeight;
  unsigned long ulNumOutputSurfaces;
  void* vidLock;
  Rect16 target_rect;
  unsigned long enableHistogram;
  unsigned long Reserved2[4];
};

struct CUVIDEOFORMAT {
  int codec;
  struct { unsigned int numerator, denominator; } frame_rate;
  unsigned char progressive_sequence;
  unsigned char bit_depth_luma_minus8;
  unsigned char bit_depth_chroma_minus8;
  unsigned char min_num_decode_surfaces;
  unsigned int coded_width;
  unsigned int coded_height;
  struct { int left, top, right, bottom; } display_area;
  int chroma_format;
  unsigned int bitrate;
  struct { int x, y; } display_aspect_ratio;
  unsigned char video_signal_description[4];
  unsigned int seqhdr_data_length;
};

struct CUVIDPARSERDISPINFO {
  int picture_index;
  int progressive_frame;
  int top_field_first;
  int repeat_first_field;
  long long timestamp;
};

struct CUVIDSOURCEDATAPACKET {
  unsigned long flags;
  unsigned long payload_size;
  const unsigned char* payload;
  long long timestamp;
};

typedef int (*SeqFn)(void*, CUVIDEOFORMAT*);
typedef int (*DecodeFn)(void*, void*);          // CUVIDPICPARAMS*: opaque
typedef int (*DisplayFn)(void*, CUVIDPARSERDISPINFO*);

struct CUVIDPARSERPARAMS {
  int CodecType;
  unsigned int ulMaxNumDecodeSurfaces;
  unsigned int ulClockRate;
  unsigned int ulErrorThreshold;
  unsigned int ulMaxDisplayDelay;
  unsigned int flags_bits;          // bAnnexb : 1, bMemoryOptimize : 1, ...
  unsigned int uReserved1[4];
  void* pUserData;
  SeqFn pfnSequenceCallback;
  DecodeFn pfnDecodePicture;
  DisplayFn pfnDisplayPicture;
  void* pfnGetOperatingPoint;
  void* pfnGetSEIMsg;
  void* pvReserved2[5];
  void* pExtVideoInfo;
};

struct CUVIDPROCPARAMS {
  int progressive_frame;
  int second_field;
  int top_field_first;
  int unpaired_field;
  unsigned int reserved_flags;
  unsigned int reserved_zero;
  unsigned long long raw_input_dptr;
  unsigned int raw_input_pitch;
  unsigned int raw_input_format;
  unsigned long long raw_output_dptr;
  unsigned int raw_output_pitch;
  unsigned int Reserved1;
  CUstream output_stream;
  unsigned int Reserved[46];
  unsigned long long* histogram_dptr;
  void* Reserved2[1];
};

// the offsets nvcuvid.h / cuviddec.h give these fields on 64-bit Linux
static_assert(sizeof(CUVIDEOFORMAT) == 64, "CUVIDEOFORMAT");
static_assert(offsetof(CUVIDEOFORMAT, coded_width) == 16, "coded_width");
static_assert(offsetof(CUVIDEOFORMAT, chroma_format) == 40, "chroma");
static_assert(sizeof(CUVIDPARSERDISPINFO) == 24, "CUVIDPARSERDISPINFO");
static_assert(sizeof(CUVIDSOURCEDATAPACKET) == 32, "CUVIDSOURCEDATAPACKET");
static_assert(offsetof(CUVIDPARSERPARAMS, pUserData) == 40, "pUserData");
static_assert(sizeof(CUVIDPARSERPARAMS) == 136, "CUVIDPARSERPARAMS");
static_assert(offsetof(CUVIDDECODECREATEINFO, display_area) == 80, "area");
static_assert(offsetof(CUVIDDECODECREATEINFO, vidLock) == 120, "vidLock");
static_assert(sizeof(CUVIDDECODECREATEINFO) == 176, "CREATEINFO");
static_assert(offsetof(CUVIDPROCPARAMS, output_stream) == 56, "stream");
static_assert(sizeof(CUVIDPROCPARAMS) == 264, "CUVIDPROCPARAMS");
static_assert(offsetof(CUVIDDECODECAPS, bIsSupported) == 24, "caps");
static_assert(offsetof(CUVIDDECODECAPS, nMaxMBCount) == 36, "caps MBs");

struct Api {
  CUresult (*cuCtxGetCurrent)(CUcontext*);
  CUresult (*cuCtxPushCurrent)(CUcontext);
  CUresult (*cuCtxPopCurrent)(CUcontext*);
  CUresult (*cuMemcpy2DAsync)(const CUDA_MEMCPY2D*, CUstream);
  CUresult (*cuStreamSynchronize)(CUstream);
  CUresult (*cuGetErrorName)(CUresult, const char**);
  CUresult (*cuvidGetDecoderCaps)(CUVIDDECODECAPS*);
  CUresult (*cuvidCreateVideoParser)(void**, CUVIDPARSERPARAMS*);
  CUresult (*cuvidParseVideoData)(void*, CUVIDSOURCEDATAPACKET*);
  CUresult (*cuvidDestroyVideoParser)(void*);
  CUresult (*cuvidCreateDecoder)(void**, CUVIDDECODECREATEINFO*);
  CUresult (*cuvidDestroyDecoder)(void*);
  CUresult (*cuvidDecodePicture)(void*, void*);
  CUresult (*cuvidMapVideoFrame64)(void*, int, unsigned long long*,
                                   unsigned int*, CUVIDPROCPARAMS*);
  CUresult (*cuvidUnmapVideoFrame64)(void*, unsigned long long);
  CUresult (*cuvidCtxLockCreate)(void**, CUcontext);
  CUresult (*cuvidCtxLockDestroy)(void*);
};

Api g_api;
bool g_loaded = false;
std::mutex g_load_mutex;

void put(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", msg.c_str());
}

std::string cu_name(CUresult r) {
  const char* name = nullptr;
  if (g_api.cuGetErrorName && g_api.cuGetErrorName(r, &name) == 0 && name)
    return std::string(name) + " (" + std::to_string(r) + ")";
  return "CUresult " + std::to_string(r);
}

template <typename F>
bool sym(void* lib, const char* lib_name, const char* name, F* out,
         std::string* msg) {
  *out = reinterpret_cast<F>(dlsym(lib, name));
  if (!*out) *msg = std::string(lib_name) + " has no " + name;
  return *out != nullptr;
}

// dlopen both libraries and resolve every call (once; a failure is not
// kept, so a later call may find the library)
bool load(const char* nvcuvid_name, std::string* msg) {
  std::lock_guard<std::mutex> guard(g_load_mutex);
  if (g_loaded) return true;
  void* cuvid = dlopen(nvcuvid_name, RTLD_NOW | RTLD_GLOBAL);
  if (!cuvid) {
    *msg = std::string(nvcuvid_name) + " not found (NVDEC needs NVIDIA's "
           "video decode library): " + dlerror();
    return false;
  }
  void* cuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
  if (!cuda) {
    *msg = std::string("libcuda.so.1 not found (NVIDIA's CUDA "
                       "library): ") + dlerror();
    return false;
  }
  Api a{};
  const char* c = "libcuda.so.1";
  bool ok = sym(cuda, c, "cuCtxGetCurrent", &a.cuCtxGetCurrent, msg) &&
            sym(cuda, c, "cuCtxPushCurrent_v2", &a.cuCtxPushCurrent, msg) &&
            sym(cuda, c, "cuCtxPopCurrent_v2", &a.cuCtxPopCurrent, msg) &&
            sym(cuda, c, "cuMemcpy2DAsync_v2", &a.cuMemcpy2DAsync, msg) &&
            sym(cuda, c, "cuStreamSynchronize", &a.cuStreamSynchronize,
                msg) &&
            sym(cuda, c, "cuGetErrorName", &a.cuGetErrorName, msg) &&
            sym(cuvid, nvcuvid_name, "cuvidGetDecoderCaps",
                &a.cuvidGetDecoderCaps, msg) &&
            sym(cuvid, nvcuvid_name, "cuvidCreateVideoParser",
                &a.cuvidCreateVideoParser, msg) &&
            sym(cuvid, nvcuvid_name, "cuvidParseVideoData",
                &a.cuvidParseVideoData, msg) &&
            sym(cuvid, nvcuvid_name, "cuvidDestroyVideoParser",
                &a.cuvidDestroyVideoParser, msg) &&
            sym(cuvid, nvcuvid_name, "cuvidCreateDecoder",
                &a.cuvidCreateDecoder, msg) &&
            sym(cuvid, nvcuvid_name, "cuvidDestroyDecoder",
                &a.cuvidDestroyDecoder, msg) &&
            sym(cuvid, nvcuvid_name, "cuvidDecodePicture",
                &a.cuvidDecodePicture, msg) &&
            sym(cuvid, nvcuvid_name, "cuvidMapVideoFrame64",
                &a.cuvidMapVideoFrame64, msg) &&
            sym(cuvid, nvcuvid_name, "cuvidUnmapVideoFrame64",
                &a.cuvidUnmapVideoFrame64, msg) &&
            sym(cuvid, nvcuvid_name, "cuvidCtxLockCreate",
                &a.cuvidCtxLockCreate, msg) &&
            sym(cuvid, nvcuvid_name, "cuvidCtxLockDestroy",
                &a.cuvidCtxLockDestroy, msg);
  if (!ok) return false;
  g_api = a;
  g_loaded = true;
  return true;
}

struct Handle {
  CUcontext ctx = nullptr;
  void* lock = nullptr;
  void* decoder = nullptr;
  unsigned int coded_w = 0, coded_h = 0, surfaces = 0;
};

// one decode (or parse) call: the window and where its frames go
struct DecodeCall {
  Handle* h = nullptr;
  long long start = 0;
  int count = 0;
  CUdeviceptr dst = 0;
  int H = 0, W = 0, crop_left = 0, crop_top = 0, coded_w = 0, coded_h = 0;
  CUstream stream = nullptr;
  unsigned char* got = nullptr;
  long long decoded = 0;
  // parse only (no decoder): the display order the parser gives
  bool parse_only = false;
  long long* shown = nullptr;
  int max_shown = 0, n_shown = 0;
  unsigned int min_surfaces = 0;
  CUresult code = 0;                // first error: a CUresult, or -1
  std::string msg;

  int fail(CUresult r, const std::string& what) {
    if (code == 0) {
      code = r ? r : -1;
      msg = r ? what + ": " + cu_name(r) : what;
    }
    return 0;
  }
};

// cuvidGetDecoderCaps for H.264 at this chroma format and bit depth; "" if
// NVDEC decodes it at coded_w x coded_h (0: any size), else why not
std::string check_caps(int chroma, int depth_minus8, unsigned int coded_w,
                       unsigned int coded_h, CUresult* code,
                       CUVIDDECODECAPS* out) {
  CUVIDDECODECAPS caps{};
  caps.eCodecType = kCodecH264;
  caps.eChromaFormat = chroma;
  caps.nBitDepthMinus8 = depth_minus8;
  *code = g_api.cuvidGetDecoderCaps(&caps);
  if (out) *out = caps;
  if (*code) return "cuvidGetDecoderCaps: " + cu_name(*code);
  std::string what = "H.264 chroma_format " + std::to_string(chroma) +
                     ", bit depth " + std::to_string(depth_minus8 + 8);
  if (!caps.bIsSupported)
    return "cuvidGetDecoderCaps: NVDEC on this card does not decode " + what;
  if (!(caps.nOutputFormatMask & (1u << kSurfaceNV12)))
    return "cuvidGetDecoderCaps: no NV12 output for " + what;
  if (coded_w && (coded_w > caps.nMaxWidth || coded_h > caps.nMaxHeight ||
                  coded_w < caps.nMinWidth || coded_h < caps.nMinHeight ||
                  (coded_w / 16) * (coded_h / 16) > caps.nMaxMBCount))
    return "cuvidGetDecoderCaps: coded size " + std::to_string(coded_w) +
           "x" + std::to_string(coded_h) + " outside NVDEC's " +
           std::to_string(caps.nMinWidth) + "x" +
           std::to_string(caps.nMinHeight) + " .. " +
           std::to_string(caps.nMaxWidth) + "x" +
           std::to_string(caps.nMaxHeight);
  return "";
}

int on_sequence(void* user, CUVIDEOFORMAT* fmt) {
  DecodeCall* s = static_cast<DecodeCall*>(user);
  Handle* h = s->h;
  if (fmt->codec != kCodecH264 || fmt->chroma_format != kChroma420 ||
      fmt->bit_depth_luma_minus8 || fmt->bit_depth_chroma_minus8 ||
      !fmt->progressive_sequence)
    return s->fail(0, "NVDEC sequence: codec " + std::to_string(fmt->codec) +
                          ", chroma " + std::to_string(fmt->chroma_format) +
                          ", bit depth " +
                          std::to_string(fmt->bit_depth_luma_minus8 + 8) +
                          ", progressive " +
                          std::to_string(fmt->progressive_sequence) +
                          " (expected H.264 4:2:0 8-bit progressive)");
  const auto& d = fmt->display_area;
  if (fmt->coded_width != static_cast<unsigned>(s->coded_w) ||
      fmt->coded_height != static_cast<unsigned>(s->coded_h) ||
      d.left != s->crop_left || d.top != s->crop_top ||
      d.right != s->crop_left + s->W || d.bottom != s->crop_top + s->H)
    return s->fail(0, "NVDEC sequence: coded " +
                          std::to_string(fmt->coded_width) + "x" +
                          std::to_string(fmt->coded_height) + ", display (" +
                          std::to_string(d.left) + "," +
                          std::to_string(d.top) + ")-(" +
                          std::to_string(d.right) + "," +
                          std::to_string(d.bottom) + ") differ from the SPS");
  unsigned int need = fmt->min_num_decode_surfaces;
  if (need < 2) need = 2;
  if (s->parse_only) {
    s->min_surfaces = fmt->min_num_decode_surfaces;
    return static_cast<int>(need);
  }
  if (h->decoder && h->coded_w == fmt->coded_width &&
      h->coded_h == fmt->coded_height && h->surfaces >= need)
    return static_cast<int>(h->surfaces);
  if (h->decoder) {
    g_api.cuvidDestroyDecoder(h->decoder);
    h->decoder = nullptr;
  }
  CUresult r = 0;
  std::string why = check_caps(kChroma420, 0, fmt->coded_width,
                               fmt->coded_height, &r, nullptr);
  if (!why.empty()) {
    s->code = r ? r : -1;
    s->msg = why;
    return 0;
  }
  CUVIDDECODECREATEINFO ci{};
  ci.ulWidth = fmt->coded_width;
  ci.ulHeight = fmt->coded_height;
  ci.ulNumDecodeSurfaces = need;
  ci.CodecType = kCodecH264;
  ci.ChromaFormat = kChroma420;
  ci.ulCreationFlags = kCreatePreferCUVID;
  ci.ulMaxWidth = fmt->coded_width;
  ci.ulMaxHeight = fmt->coded_height;
  // the whole coded frame, unscaled: the copy crops it
  ci.display_area = {0, 0, static_cast<short>(fmt->coded_width),
                     static_cast<short>(fmt->coded_height)};
  ci.OutputFormat = kSurfaceNV12;
  ci.DeinterlaceMode = kDeinterlaceWeave;
  ci.ulTargetWidth = fmt->coded_width;
  ci.ulTargetHeight = fmt->coded_height;
  ci.ulNumOutputSurfaces = 2;
  ci.vidLock = h->lock;
  r = g_api.cuvidCreateDecoder(&h->decoder, &ci);
  if (r) {
    h->decoder = nullptr;
    return s->fail(r, "cuvidCreateDecoder");
  }
  h->coded_w = fmt->coded_width;
  h->coded_h = fmt->coded_height;
  h->surfaces = need;
  return static_cast<int>(need);
}

int on_decode(void* user, void* pic) {
  DecodeCall* s = static_cast<DecodeCall*>(user);
  if (s->code) return 0;
  if (s->parse_only) {
    ++s->decoded;
    return 1;
  }
  if (!s->h->decoder) return s->fail(0, "NVDEC: a picture before its SPS");
  CUresult r = g_api.cuvidDecodePicture(s->h->decoder, pic);
  if (r) return s->fail(r, "cuvidDecodePicture");
  ++s->decoded;
  return 1;
}

int on_display(void* user, CUVIDPARSERDISPINFO* info) {
  DecodeCall* s = static_cast<DecodeCall*>(user);
  if (s->code) return 0;
  if (!info) return 1;
  long long slot = info->timestamp - s->start;
  if (s->parse_only) {
    if (s->n_shown < s->max_shown) s->shown[s->n_shown] = info->timestamp;
    ++s->n_shown;
    if (slot >= 0 && slot < s->count) s->got[slot] = 1;
    return 1;
  }
  if (slot < 0 || slot >= s->count) return 1;    // outside the window
  CUVIDPROCPARAMS pp{};
  pp.progressive_frame = info->progressive_frame;
  pp.second_field = info->repeat_first_field + 1;
  pp.top_field_first = info->top_field_first;
  pp.unpaired_field = info->repeat_first_field < 0;
  pp.output_stream = s->stream;
  unsigned long long src = 0;
  unsigned int pitch = 0;
  CUresult r = g_api.cuvidMapVideoFrame64(s->h->decoder, info->picture_index,
                                          &src, &pitch, &pp);
  if (r) return s->fail(r, "cuvidMapVideoFrame64");
  const size_t frame = static_cast<size_t>(s->H) * 3 / 2 * s->W;
  CUDA_MEMCPY2D m{};
  m.srcMemoryType = CU_MEMORYTYPE_DEVICE;
  m.srcDevice = src + static_cast<size_t>(s->crop_top) * pitch + s->crop_left;
  m.srcPitch = pitch;
  m.dstMemoryType = CU_MEMORYTYPE_DEVICE;
  m.dstDevice = s->dst + static_cast<size_t>(slot) * frame;
  m.dstPitch = s->W;
  m.WidthInBytes = s->W;
  m.Height = s->H;
  r = g_api.cuMemcpy2DAsync(&m, s->stream);
  if (!r) {
    // the chroma plane (Cb Cr interleaved) follows the luma's surface
    // height, rounded up to even; a 2 x 2 luma block has one sample pair
    m.srcDevice = src + static_cast<size_t>((s->h->coded_h + 1) & ~1u) *
                            pitch +
                  static_cast<size_t>(s->crop_top / 2) * pitch + s->crop_left;
    m.dstDevice += static_cast<size_t>(s->H) * s->W;
    m.Height = s->H / 2;
    r = g_api.cuMemcpy2DAsync(&m, s->stream);
  }
  CUresult rs = g_api.cuStreamSynchronize(s->stream);
  CUresult ru = g_api.cuvidUnmapVideoFrame64(s->h->decoder, src);
  if (r) return s->fail(r, "cuMemcpy2DAsync");
  if (rs) return s->fail(rs, "cuStreamSynchronize");
  if (ru) return s->fail(ru, "cuvidUnmapVideoFrame64");
  s->got[slot] = 1;
  return 1;
}

// Feed access units data[offsets[i]:offsets[i+1]] (display index ts[i])
// to a new parser with the call's callbacks, then end of stream.
void run_parser(DecodeCall* sp, const unsigned char* data,
                const long long* offsets, const long long* ts, int n) {
  DecodeCall& s = *sp;
  CUVIDPARSERPARAMS pp{};
  pp.CodecType = kCodecH264;
  pp.ulMaxNumDecodeSurfaces = s.h && s.h->surfaces ? s.h->surfaces : 1;
  pp.ulMaxDisplayDelay = 0;
  pp.pUserData = sp;
  pp.pfnSequenceCallback = on_sequence;
  pp.pfnDecodePicture = on_decode;
  pp.pfnDisplayPicture = on_display;
  void* parser = nullptr;
  CUresult r = g_api.cuvidCreateVideoParser(&parser, &pp);
  if (r) {
    s.fail(r, "cuvidCreateVideoParser");
  } else {
    for (int i = 0; i <= n && !s.code; ++i) {
      CUVIDSOURCEDATAPACKET pkt{};
      if (i < n) {
        pkt.flags = kPktTimestamp | kPktEndOfPicture;
        pkt.payload_size = offsets[i + 1] - offsets[i];
        pkt.payload = data + offsets[i];
        pkt.timestamp = ts[i];
      } else {
        pkt.flags = kPktEndOfStream;          // flush the display queue
      }
      r = g_api.cuvidParseVideoData(parser, &pkt);
      if (r) s.fail(r, "cuvidParseVideoData");
    }
    g_api.cuvidDestroyVideoParser(parser);
  }
}

}  // namespace

extern "C" {

// Load both libraries (nvcuvid_name: the video library's file name).
// 0, or -1 with the reason in err.
int bsvd_nvdec_load(const char* nvcuvid_name, char* err, int errlen) {
  std::string msg;
  if (!load(nvcuvid_name, &msg)) {
    put(err, errlen, msg);
    return -1;
  }
  return 0;
}

// What NVDEC decodes of H.264 at this chroma format and bit depth: out =
// {supported, max width, max height, max macroblocks, NVDEC engines,
// output format mask}. Returns the CUresult (or -1), the reason in
// err when it is not decoded. Needs a current context.
int bsvd_nvdec_caps(int chroma, int depth_minus8, unsigned int* out,
                    char* err, int errlen) {
  std::string msg;
  if (!load("libnvcuvid.so.1", &msg)) {
    put(err, errlen, msg);
    return -1;
  }
  CUVIDDECODECAPS caps{};
  CUresult r = 0;
  std::string why = check_caps(chroma, depth_minus8, 0, 0, &r, &caps);
  out[0] = caps.bIsSupported;
  out[1] = caps.nMaxWidth;
  out[2] = caps.nMaxHeight;
  out[3] = caps.nMaxMBCount;
  out[4] = caps.nNumNVDECs;
  out[5] = caps.nOutputFormatMask;
  put(err, errlen, why);
  return why.empty() ? 0 : (r ? r : -1);
}

// A handle on the calling thread's current context (PyTorch's primary
// context); nullptr with the reason in err.
void* bsvd_nvdec_open(char* err, int errlen) {
  if (!g_loaded) {
    put(err, errlen, "bsvd_nvdec_load was not called");
    return nullptr;
  }
  CUcontext ctx = nullptr;
  CUresult r = g_api.cuCtxGetCurrent(&ctx);
  if (r || !ctx) {
    put(err, errlen, "cuCtxGetCurrent: no current CUDA context (" +
                         cu_name(r) + "); initialise the device first");
    return nullptr;
  }
  Handle* h = new Handle();
  h->ctx = ctx;
  r = g_api.cuvidCtxLockCreate(&h->lock, ctx);
  if (r) {
    put(err, errlen, "cuvidCtxLockCreate: " + cu_name(r));
    delete h;
    return nullptr;
  }
  return h;
}

void bsvd_nvdec_close(void* handle) {
  Handle* h = static_cast<Handle*>(handle);
  if (!h) return;
  g_api.cuCtxPushCurrent(h->ctx);
  if (h->decoder) g_api.cuvidDestroyDecoder(h->decoder);
  if (h->lock) g_api.cuvidCtxLockDestroy(h->lock);
  CUcontext popped;
  g_api.cuCtxPopCurrent(&popped);
  delete h;
}

// Decode access units data[offsets[i]:offsets[i+1]] (Annex-B, decode
// order, display index ts[i]; -1 for a frame not displayed) and copy the
// display frames start .. start + count - 1 into dst (count, H*3/2, W)
// uint8 NV12, cropped at (crop_left, crop_top) of the coded_w x coded_h
// frame. got[k] = 1 for each frame copied; *decoded = pictures decoded.
// Returns 0, the CUresult, or -1; the reason in err.
int bsvd_nvdec_decode(void* handle, const unsigned char* data,
                      const long long* offsets, const long long* ts, int n,
                      long long start, int count, unsigned long long dst,
                      int H, int W, int crop_left, int crop_top, int coded_w,
                      int coded_h, void* stream, unsigned char* got,
                      long long* decoded, char* err, int errlen) {
  Handle* h = static_cast<Handle*>(handle);
  DecodeCall s;
  s.h = h;
  s.start = start;
  s.count = count;
  s.dst = dst;
  s.H = H;
  s.W = W;
  s.crop_left = crop_left;
  s.crop_top = crop_top;
  s.coded_w = coded_w;
  s.coded_h = coded_h;
  s.stream = static_cast<CUstream>(stream);
  s.got = got;
  CUresult r = g_api.cuCtxPushCurrent(h->ctx);
  if (r) {
    put(err, errlen, "cuCtxPushCurrent: " + cu_name(r));
    return r;
  }
  run_parser(&s, data, offsets, ts, n);
  CUcontext popped;
  g_api.cuCtxPopCurrent(&popped);
  *decoded = s.decoded;
  put(err, errlen, s.msg);
  return s.code;
}

// Parse only, on the CPU (no decoder, no context): feed the access units
// as bsvd_nvdec_decode does and report what libnvcuvid's parser gives:
// the sequence checked against the SPS, the pictures it hands to decode
// (*decoded), the display order (shown[0 .. *n_shown - 1], the timestamps
// of each displayed picture), got[k] for the window's frames and the
// stream's min_num_decode_surfaces. Returns 0, the CUresult or -1.
int bsvd_nvdec_parse(const unsigned char* data, const long long* offsets,
                     const long long* ts, int n, long long start, int count,
                     int H, int W, int crop_left, int crop_top, int coded_w,
                     int coded_h, unsigned char* got, long long* shown,
                     int max_shown, int* n_shown, long long* decoded,
                     unsigned int* min_surfaces, char* err, int errlen) {
  if (!g_loaded) {
    put(err, errlen, "bsvd_nvdec_load was not called");
    return -1;
  }
  DecodeCall s;
  s.parse_only = true;
  s.start = start;
  s.count = count;
  s.H = H;
  s.W = W;
  s.crop_left = crop_left;
  s.crop_top = crop_top;
  s.coded_w = coded_w;
  s.coded_h = coded_h;
  s.got = got;
  s.shown = shown;
  s.max_shown = max_shown;
  run_parser(&s, data, offsets, ts, n);
  *n_shown = s.n_shown;
  *decoded = s.decoded;
  *min_surfaces = s.min_surfaces;
  put(err, errlen, s.msg);
  return s.code;
}

}  // extern "C"
