// K3 — the output epilogue on Hopper: ROI crop, nearest chroma upsampling,
// BT.709 YUV -> RGB and the packed output layouts, in one pass.
//
// Replaces the XLA device program rocjpeg_tpu/ops/postprocess.py
// render_output (with ops/color.py yuv_to_rgb and ops/layout.py
// upsample_to_luma / interleave_rgb / pack_yuyv / interleave_uv): the JAX
// package leaves this stage to XLA fusion; on the GPU it is a kernel written
// by hand. It computes the channels that are not plain crops of K2's planes:
// interleaved RGB, planar RGB, packed YUYV (4:2:2 NATIVE) and interleaved UV
// (the second plane of NV12). Crop-only channels stay views and never come
// here.
//
// What bounds it on the card: DRAM bytes — 1.5 bytes read and 3 written per
// RGB pixel of a 4:2:0 frame, against some 20 integer operations.
//
// Design: one thread block renders one row segment of up to kTile source
// elements of one image into shared memory, then the block copies the
// segment to the destination row. Destination rows start at any byte (3 *
// width is rarely a multiple of 4, an ROI starts anywhere, and a caller's
// pitch is arbitrary), so the segment is staged at the same offset modulo 16
// as its destination address: the bytes up to the first 16-byte boundary and
// after the last go out one by one, everything between as 16-byte stores.
// Only the bytes of the row are written, so a caller's slack past each row
// stays as it was. Destinations are a table of per-image pointers and
// pitches passed by value (kMaxImages images a launch; the wrapper splits a
// wider batch).
//
// The chroma phase follows the ROI, as the plain version's does: the chroma
// planes are cropped at (top / vf, left / hf) to (h / vf, w / hf) samples
// and the cropped plane is upsampled, its last row and column replicated
// where the ROI's extent is odd. Arithmetic is ops/color.py's, in int32:
// nothing overflows (|sum| < 2^26), and >> on a negative int is an
// arithmetic shift under nvcc.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;       // source elements per block (even)
constexpr int kMaxImages = 32;    // images per launch
constexpr int kMaxChannels = 3;

constexpr int kFixBits = 16;
constexpr int kFixRound = 1 << (kFixBits - 1);
constexpr int kCrV = 103206;
constexpr int kCgU = -12275;
constexpr int kCgV = -30677;
constexpr int kCbU = 121609;

enum Mode { kRgb = 0, kRgbPlanar = 1, kYuyv = 2, kUv = 3 };

struct DestTab {
  uint8_t* ptr[kMaxImages][kMaxChannels];   // null: channel not wanted
  int64_t pitch[kMaxImages][kMaxChannels];  // bytes between rows
};

struct Geom {
  const uint8_t* y;   // (B, y_h, y_w) padded planes; u and v null for 4:0:0
  const uint8_t* u;
  const uint8_t* v;
  int64_t y_img;      // samples per image of the luma plane / a chroma plane
  int64_t c_img;
  int y_w, c_w;       // row widths of the padded planes
  int top, left;      // ROI origin in the luma plane
  int c_top, c_left;  // ROI origin in the chroma planes
  int rows, cols;     // what the grid walks: the luma ROI, or for kUv the
                      // chroma ROI
  int ch_w, ch_h;     // extent of the cropped chroma planes
  int hshift, vshift; // log2 of the chroma subsampling factors (0 or 1)
  int image0;         // first image of this launch within the batch
};

__device__ __forceinline__ uint8_t clamp255(int x) {
  return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
}

// Copy n staged bytes to dst; stage[mis + i] holds byte i and
// mis == dst % 16, so 16-byte chunks line up on both sides.
__device__ __forceinline__ void flush_row(uint8_t* dst, const uint8_t* stage,
                                          int mis, int n) {
  const int head = min((16 - mis) & 15, n);
  const int body = (n - head) >> 4;
  const int tail = head + (body << 4);
  for (int i = threadIdx.x; i < head; i += kThreads) dst[i] = stage[mis + i];
  const uint4* s4 = reinterpret_cast<const uint4*>(stage + mis + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < body; i += kThreads) d4[i] = s4[i];
  for (int i = tail + threadIdx.x; i < n; i += kThreads)
    dst[i] = stage[mis + i];
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) epilogue_kernel(Geom g,
                                                            DestTab dt) {
  // Bytes each source element puts into each destination channel.
  constexpr int kBytes = MODE == kRgb ? 3 : (MODE == kRgbPlanar ? 1 : 2);
  constexpr int kChannels = MODE == kRgbPlanar ? 3 : 1;
  constexpr int kStage = kTile * kBytes + 16;  // a multiple of 16
  __shared__ __align__(16) uint8_t stage[kChannels][kStage];

  const int img = blockIdx.z;
  const int row = blockIdx.y;
  const int x0 = blockIdx.x * kTile;
  const int n = min(kTile, g.cols - x0);
  const int64_t b = static_cast<int64_t>(g.image0) + img;

  uint8_t* dst[kChannels];
  int mis[kChannels];
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    uint8_t* base = dt.ptr[img][c];
    dst[c] = base == nullptr
                 ? nullptr
                 : base + static_cast<int64_t>(row) * dt.pitch[img][c] +
                       static_cast<int64_t>(x0) * kBytes;
    mis[c] = static_cast<int>(reinterpret_cast<uintptr_t>(dst[c]) & 15);
  }

  if constexpr (MODE == kUv) {
    const int64_t off = b * g.c_img +
                        static_cast<int64_t>(g.c_top + row) * g.c_w +
                        g.c_left + x0;
    const uint8_t* up = g.u + off;
    const uint8_t* vp = g.v + off;
    uint8_t* st = stage[0] + mis[0];
    for (int i = threadIdx.x; i < n; i += kThreads) {
      st[2 * i] = up[i];
      st[2 * i + 1] = vp[i];
    }
  } else {
    const uint8_t* yp = g.y + b * g.y_img +
                        static_cast<int64_t>(g.top + row) * g.y_w + g.left +
                        x0;
    const bool chroma = g.u != nullptr;
    const uint8_t* up = nullptr;
    const uint8_t* vp = nullptr;
    if (chroma) {
      const int cy = g.c_top + min(row >> g.vshift, g.ch_h - 1);
      const int64_t off = b * g.c_img + static_cast<int64_t>(cy) * g.c_w +
                          g.c_left;
      up = g.u + off;
      vp = g.v + off;
    }
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int x = x0 + i;
      const int yv = yp[i];
      int uv = 128, vv = 128;
      if (chroma) {
        const int cx = min(x >> g.hshift, g.ch_w - 1);
        uv = up[cx];
        vv = vp[cx];
      }
      if constexpr (MODE == kYuyv) {
        uint8_t* st = stage[0] + mis[0];
        st[2 * i] = static_cast<uint8_t>(yv);
        st[2 * i + 1] = static_cast<uint8_t>((x & 1) ? vv : uv);
      } else {
        const int yi = yv << kFixBits;
        const int ui = uv - 128;
        const int vi = vv - 128;
        const uint8_t r = clamp255((yi + kCrV * vi + kFixRound) >> kFixBits);
        const uint8_t gg =
            clamp255((yi + kCgU * ui + kCgV * vi + kFixRound) >> kFixBits);
        const uint8_t bb = clamp255((yi + kCbU * ui + kFixRound) >> kFixBits);
        if constexpr (MODE == kRgbPlanar) {
          stage[0][mis[0] + i] = r;
          stage[1][mis[1] + i] = gg;
          stage[2][mis[2] + i] = bb;
        } else {
          uint8_t* st = stage[0] + mis[0] + 3 * i;
          st[0] = r;
          st[1] = gg;
          st[2] = bb;
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kChannels; ++c)
    if (dst[c] != nullptr) flush_row(dst[c], stage[c], mis[c], n * kBytes);
}

template <int MODE>
void launch(const Geom& g, const DestTab& dt, int n_images,
            cudaStream_t stream) {
  const dim3 grid((g.cols + kTile - 1) / kTile, g.rows, n_images);
  epilogue_kernel<MODE><<<grid, kThreads, 0, stream>>>(g, dt);
}

}  // namespace

// Images one launch takes: the wrapper splits a wider batch.
extern "C" int rjt_epilogue_table_images() { return kMaxImages; }

// One launch over images [image0, image0 + n_images) of the batch.
// mode: 0 interleaved RGB, 1 planar RGB, 2 packed YUYV, 3 interleaved UV.
// y/u/v: device planes (u, v null for 4:0:0, RGB modes only). dst_ptrs and
// dst_pitches: host int64 [n_images][3], one entry per kernel channel (RGB
// planar has 3, the others 1); a zero pointer skips the channel. rows/cols:
// the luma ROI, or the chroma ROI for mode 3. Returns cudaGetLastError().
extern "C" int rjt_epilogue(int mode, const void* y, const void* u,
                            const void* v, int64_t y_img, int64_t c_img,
                            int y_w, int c_w, int top, int left, int c_top,
                            int c_left, int rows, int cols, int ch_w, int ch_h,
                            int hshift, int vshift, int image0, int n_images,
                            const void* dst_ptrs, const void* dst_pitches,
                            void* stream) {
  const bool chroma = u != nullptr && v != nullptr;
  if (mode < kRgb || mode > kUv || y == nullptr || n_images < 1 ||
      n_images > kMaxImages || rows < 1 || rows > 65535 || cols < 1 ||
      hshift < 0 || hshift > 1 || vshift < 0 || vshift > 1 ||
      (u == nullptr) != (v == nullptr) ||
      (chroma && (ch_w < 1 || ch_h < 1)) ||
      (!chroma && (mode == kYuyv || mode == kUv)))
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g = {};
  g.y = static_cast<const uint8_t*>(y);
  g.u = static_cast<const uint8_t*>(u);
  g.v = static_cast<const uint8_t*>(v);
  g.y_img = y_img;
  g.c_img = c_img;
  g.y_w = y_w;
  g.c_w = c_w;
  g.top = top;
  g.left = left;
  g.c_top = c_top;
  g.c_left = c_left;
  g.rows = rows;
  g.cols = cols;
  g.ch_w = ch_w;
  g.ch_h = ch_h;
  g.hshift = hshift;
  g.vshift = vshift;
  g.image0 = image0;
  DestTab dt = {};
  const int64_t* ptrs = static_cast<const int64_t*>(dst_ptrs);
  const int64_t* pitches = static_cast<const int64_t*>(dst_pitches);
  for (int i = 0; i < n_images; ++i)
    for (int c = 0; c < kMaxChannels; ++c) {
      dt.ptr[i][c] = reinterpret_cast<uint8_t*>(ptrs[i * kMaxChannels + c]);
      dt.pitch[i][c] = pitches[i * kMaxChannels + c];
    }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kRgb: launch<kRgb>(g, dt, n_images, s); break;
    case kRgbPlanar: launch<kRgbPlanar>(g, dt, n_images, s); break;
    case kYuyv: launch<kYuyv>(g, dt, n_images, s); break;
    default: launch<kUv>(g, dt, n_images, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
