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
// here, unless the caller gave destinations: then the same launch copies
// them, plane rows to pitched rows, through the same destination table.
//
// What bounds it on the card: DRAM bytes — 1.5 bytes read and 3 written per
// RGB pixel of a 4:2:0 frame. The first version of this kernel (one pixel a
// thread, byte loads, byte stores into shared memory; still here under
// RJT_EPI_BASELINE) spent some 40 instructions a pixel and was bound by
// instruction issue instead. What this design does about it:
//
//  * A thread takes a group of 8 neighbouring samples of a row as one
//    8-byte load and the 4 (or 8) chroma samples under them as one 4-byte
//    (8-byte) load, converts in registers and stages whole 32-bit words (4
//    RGB pixels are 3 words). K2's planes are MCU-padded, so rows start on
//    multiples of 8 bytes; an ROI whose left edge is not a multiple of 8
//    breaks that, and the part then loads the aligned words that hold the
//    group and shifts them (planes are made of whole words, so no load
//    leaves the plane); planes that are not go byte by byte. The host
//    decides per launch and per plane (rjt_epilogue_load_levels). The last
//    group of a row, where the ROI may end mid-group and the chroma column
//    is replicated, always goes byte by byte, with the clamp.
//  * With vertical subsampling a thread takes the two luma rows over one
//    chroma row: the three chroma terms, rounding constant folded in, are
//    computed once per chroma sample and serve up to four pixels. Integer
//    addition is associative and nothing overflows (|sum| < 2^26), so the
//    bytes are those of ops/color.py. Clamping the sum to [0, 2^24) leaves
//    the result in byte 2: no shift, and the byte permute that packs the
//    words picks it from there.
//  * A block renders a strip: the units (a unit is one row, or a row
//    pair) of 4 rows of one tile of up to 2048 columns (4096 for planar
//    RGB and for launches of copies only) of one image, so one prologue
//    and one read of the destination table serve tens of KB; longer strips
//    leave too few blocks for the last wave of a 4K batch. Two staging
//    buffers and one barrier a unit (planar RGB: one buffer, two
//    barriers): the loads of the next unit are in flight while the staged
//    bytes of the last one leave. Registers are capped for 6 blocks a SM
//    (8 for YUYV): loads in flight are what the kernel needs, and uncapped
//    the compiler takes 110 registers a thread.
//  * Destination rows start at any byte. A row is staged at a word-aligned
//    offset chosen so that every 16-byte store to the destination reads one
//    aligned 16-byte chunk of shared memory plus the word after it, shifted
//    by the 0-3 bytes that remain (a funnel shift). Bytes before the first
//    and after the last 16-byte boundary go out one by one; only the bytes
//    of the row are written, so a caller's slack past each row stays as it
//    was. The staged rows of a unit are dealt out to two groups of 128
//    threads, so a row of 1,920 bytes does not leave half the block idle.
//  * The grid is one-dimensional: any number of rows (the first version
//    refused more than 65,535).
//
// Destinations are a table of per-image pointers and pitches passed by
// value (kMaxImages images a launch; the wrapper splits a wider batch),
// indexed by the output format's channel.
//
// The chroma phase follows the ROI, as the plain version's does: the chroma
// planes are cropped at (top / vf, left / hf) to (h / vf, w / hf) samples
// and the cropped plane is upsampled, its last row and column replicated
// where the ROI's extent is odd: ROI rows (0, 1), (2, 3), ... share a
// chroma row whatever the parity of top. Arithmetic is ops/color.py's, in
// int32.
//
// No thread reads what another holds in registers (no warp shuffle), and
// every loop over a block's work strides by the thread count, so the source
// also runs with one thread a block: tests/test_torch_epilogue.py compiles
// it for the host that way.
//
// Measurement variants (kernels/k3_steps.py): RJT_EPI_BASELINE=1 the first
// version; RJT_EPI_WORDS=1 shifted words even where 8-byte loads would do,
// =0 bytes everywhere; RJT_EPI_PAIR=0 one row a unit even under vertical
// subsampling; RJT_EPI_STRIP=n rows a block, RJT_EPI_COPY_STRIP=n rows a
// block of a copy part; RJT_EPI_BUFFERS=1 one staging buffer, two barriers a
// unit, =2 two; RJT_EPI_TILE=n columns a tile; RJT_EPI_MIN_BLOCKS=n
// registers capped for n blocks a SM (1: not capped).

#include <cstdint>
#include <cuda_runtime.h>

#ifndef RJT_EPI_BASELINE
#define RJT_EPI_BASELINE 0
#endif
#ifndef RJT_EPI_WORDS
#define RJT_EPI_WORDS 2
#endif
#ifndef RJT_EPI_PAIR
#define RJT_EPI_PAIR 1
#endif
#ifndef RJT_EPI_STRIP
#define RJT_EPI_STRIP 4
#endif
#ifndef RJT_EPI_BUFFERS
#define RJT_EPI_BUFFERS 0
#endif
#ifndef RJT_EPI_TILE
#define RJT_EPI_TILE 0
#endif
#ifndef RJT_EPI_MIN_BLOCKS
#define RJT_EPI_MIN_BLOCKS 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kBaselineTile = 1024;  // source elements per block (even)
constexpr int kMaxImages = 32;    // images per launch
constexpr int kMaxChannels = 3;
constexpr int kStripRows = RJT_EPI_STRIP;   // rows per block
#ifndef RJT_EPI_COPY_STRIP
#define RJT_EPI_COPY_STRIP (2 * RJT_EPI_STRIP)
#endif
constexpr int kCopyStrip = RJT_EPI_COPY_STRIP;  // rows per block of a copy part
static_assert(kCopyStrip >= 2 && kCopyStrip % 2 == 0, "whole copy units");
constexpr bool kPair = RJT_EPI_PAIR != 0;
static_assert(kStripRows >= 1, "rows per block");

constexpr int kFixBits = 16;
constexpr int kFixRound = 1 << (kFixBits - 1);
constexpr int kCrV = 103206;
constexpr int kCgU = -12275;
constexpr int kCgV = -30677;
constexpr int kCbU = 121609;

enum Mode { kRgb = 0, kRgbPlanar = 1, kYuyv = 2, kUv = 3, kCopy = 4 };

struct DestTab {
  uint8_t* ptr[kMaxImages][kMaxChannels];   // null: channel not wanted
  int64_t pitch[kMaxImages][kMaxChannels];  // bytes between rows
};

// One part of the grid: the computed channels (part 0), or the copy into
// table channel c (part 1 + c). A part's blocks are (image, strip, tile).
struct Part {
  int blocks;  // n_images * strips * tiles; 0: no such part
  int strips;
  int tiles;
  int tile_w;  // columns per tile, a multiple of 16
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
  int rows, cols;     // extent of the luma ROI
  int ch_w, ch_h;     // extent of the cropped chroma planes
  int hshift, vshift; // log2 of the chroma subsampling factors (0 or 1)
  int image0;         // first image of this launch within the batch
  int main_chan;      // table channel of the first computed channel
  int level;          // how each part loads full groups, 2 bits a part
                      // (part 0 lowest): 2 aligned 8-byte (4-byte) loads,
                      // 1 aligned words shifted, 0 bytes
  int copy_plane[kMaxChannels];  // table channel -> plane it copies (0 y, 1
                                 // u, 2 v), or -1
  Part part[1 + kMaxChannels];
};

#if RJT_EPI_BASELINE

__device__ __forceinline__ uint8_t clamp255(int x) {
  return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
}

// The first version: one block renders one row segment of up to kBaselineTile
// source elements into shared memory at the destination's offset modulo 16,
// then copies it out.
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
__global__ void __launch_bounds__(kThreads) baseline_kernel(Geom g,
                                                            DestTab dt) {
  constexpr int kBytes = MODE == kRgb ? 3 : (MODE == kRgbPlanar ? 1 : 2);
  constexpr int kChannels = MODE == kRgbPlanar ? 3 : 1;
  constexpr int kStage = kBaselineTile * kBytes + 16;  // a multiple of 16
  __shared__ __align__(16) uint8_t stage[kChannels][kStage];

  const int img = blockIdx.z;
  const int row = blockIdx.y;
  const int x0 = blockIdx.x * kBaselineTile;
  const int n = min(kBaselineTile, g.cols - x0);
  const int64_t b = static_cast<int64_t>(g.image0) + img;

  uint8_t* dst[kChannels];
  int mis[kChannels];
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    const int ch = g.main_chan + c;
    uint8_t* base = dt.ptr[img][ch];
    dst[c] = base == nullptr
                 ? nullptr
                 : base + static_cast<int64_t>(row) * dt.pitch[img][ch] +
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

// Walks the luma ROI, or for kUv the chroma ROI, one row a block row.
template <int MODE>
int launch(Geom g, const DestTab& dt, int n_images, cudaStream_t stream) {
  if (MODE == kUv) {
    g.rows = g.ch_h;
    g.cols = g.ch_w;
  }
  if (g.rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((g.cols + kBaselineTile - 1) / kBaselineTile, g.rows,
                  n_images);
  baseline_kernel<MODE><<<grid, kThreads, 0, stream>>>(g, dt);
  return static_cast<int>(cudaGetLastError());
}

#else  // the design for this card

constexpr int kMaxLevel = RJT_EPI_WORDS;  // how a part may load, see Geom
// Threads that store one staged row together; the rows of a unit are dealt
// out to kThreads / kFlushThreads such groups.
constexpr int kFlushThreads = kThreads < 128 ? kThreads : 128;
constexpr int kCopyRows = 2;  // rows a unit of a copy part

// Bytes each source element puts into each destination channel, channels
// the mode computes; ROWS: rows a unit holds.
template <int MODE, int ROWS>
struct Shape {
  static constexpr int kBytes =
      MODE == kRgb ? 3 : (MODE == kYuyv || MODE == kUv ? 2 : 1);
  static constexpr int kChannels = MODE == kRgbPlanar ? 3 : 1;
  // Columns per tile, and staging buffers. Planar RGB and the copies stage
  // one byte a column: a tile that spans a 3840-wide row keeps more of the
  // block busy in each staged row, and for planar RGB one buffer is then
  // what fits in 48 KB. Timed, a second buffer buys nothing in any mode
  // (kernels/k3_steps.py): other blocks of the SM load while this one
  // stores.
  static constexpr int kTile =
      RJT_EPI_TILE ? RJT_EPI_TILE
                   : (MODE == kRgbPlanar || MODE == kCopy ? 4096 : 2048);
  static constexpr int kBuffers =
      RJT_EPI_BUFFERS ? RJT_EPI_BUFFERS : (MODE == kRgbPlanar ? 1 : 2);
  static constexpr int kStrip =  // units per block
      kStripRows > ROWS ? kStripRows / ROWS : 1;
  static_assert(kBuffers == 1 || kBuffers == 2, "one or two staging buffers");
  static_assert(kTile % 16 == 0, "tiles start on multiples of 16 columns");
  // One staged row: the tile's bytes, up to 12 bytes of offset in front
  // and the word the last funnel shift reads behind; a multiple of 16.
  static constexpr int kSlot = kTile * kBytes + 32;
  static constexpr int kCopySlot = kTile + 32;
  static constexpr int kMain = ROWS * kChannels * kSlot;
  static constexpr int kBuffer =
      kMain > kCopyRows * kCopySlot ? kMain : kCopyRows * kCopySlot;
};

// Bytes from dst to the next 16-byte boundary (0 to 15).
__device__ __forceinline__ int head_bytes(const uint8_t* dst) {
  return (16 - static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15)) & 15;
}

// Where byte 0 of a row for dst is staged within its slot: a multiple of
// 4, such that the row's first 16-byte boundary of the destination falls 0
// to 3 bytes past a 16-byte boundary of the slot.
__device__ __forceinline__ int stage_offset(const uint8_t* dst) {
  const int h0 = head_bytes(dst);
  return ((h0 & 3) - h0) & 15;
}

// Copy the n staged bytes of a row to dst (see stage_offset), as thread
// `lane` of the kFlushThreads that do.
__device__ __forceinline__ void flush_row(uint8_t* dst, const uint8_t* slot,
                                          int n, int lane) {
  const int h0 = head_bytes(dst);
  const int sh = h0 & 3;
  const int base = (sh - h0) & 15;
  const int head = min(h0, n);
  const int body = (n - head) >> 4;
  const int tail = head + (body << 4);
  for (int i = lane; i < head; i += kFlushThreads) dst[i] = slot[base + i];
  const uint8_t* q = slot + base + h0 - sh;  // 16-byte aligned
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  const int shift = 8 * sh;
  for (int i = lane; i < body; i += kFlushThreads) {
    uint4 c = *reinterpret_cast<const uint4*>(q + 16 * i);
    if (sh != 0) {
      const uint32_t next = *reinterpret_cast<const uint32_t*>(q + 16 * i + 16);
      c.x = __funnelshift_r(c.x, c.y, shift);
      c.y = __funnelshift_r(c.y, c.z, shift);
      c.z = __funnelshift_r(c.z, c.w, shift);
      c.w = __funnelshift_r(c.w, next, shift);
    }
    d4[i] = c;
  }
  for (int i = tail + lane; i < n; i += kFlushThreads)
    dst[i] = slot[base + i];
}

// Bytes row[min(i0 + k, last)], k < count <= 4, into one word (the rest 0).
__device__ __forceinline__ uint32_t gather4(const uint8_t* row, int i0,
                                            int last, int count) {
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < count)
      w |= static_cast<uint32_t>(row[min(i0 + k, last)]) << (8 * k);
  return w;
}

// The WORDS whole words from p on, p at any byte: the aligned words that
// hold them, shifted. Reads no word that holds none of the bytes.
template <int WORDS>
__device__ __forceinline__ void load_shifted(const uint8_t* p, uint32_t* out) {
  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
  const uint32_t* a = reinterpret_cast<const uint32_t*>(p - s);
  uint32_t w[WORDS + 1];
#pragma unroll
  for (int k = 0; k < WORDS; ++k) w[k] = __ldg(a + k);
  w[WORDS] = s != 0 ? __ldg(a + WORDS) : 0;
#pragma unroll
  for (int k = 0; k < WORDS; ++k)
    out[k] = __funnelshift_r(w[k], w[k + 1], 8 * s);
}

// count <= 8 samples row[min(i0 + k, last)] into two words. A full group
// (count 8, no sample past last) is one 8-byte load at level 2, shifted
// words at level 1; anything else goes byte by byte.
__device__ __forceinline__ void load8(const uint8_t* row, int i0, int last,
                                      int count, int level, uint32_t& lo,
                                      uint32_t& hi) {
  if (level == 2) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(row + i0));
    lo = t.x;
    hi = t.y;
  } else if (level == 1) {
    uint32_t w[2];
    load_shifted<2>(row + i0, w);
    lo = w[0];
    hi = w[1];
  } else {
    lo = gather4(row, i0, last, count);
    hi = gather4(row, i0 + 4, last, count - 4);
  }
}

// The same for count <= 4 samples and one word.
__device__ __forceinline__ uint32_t load4(const uint8_t* row, int i0, int last,
                                          int count, int level) {
  if (level == 2) return __ldg(reinterpret_cast<const uint32_t*>(row + i0));
  if (level == 1) {
    uint32_t w;
    load_shifted<1>(row + i0, &w);
    return w;
  }
  return gather4(row, i0, last, count);
}

// Bytes of a and b in turn: a0 b0 a1 b1 | a2 b2 a3 b3.
__device__ __forceinline__ uint32_t zip_lo(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5140);
}
__device__ __forceinline__ uint32_t zip_hi(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7362);
}

__device__ __forceinline__ void store_word(uint8_t* p, uint32_t w) {
  *reinterpret_cast<uint32_t*>(p) = w;
}

// The three chroma terms of one chroma sample, rounding constant and the
// -128 offsets folded in.
struct Terms {
  int r, g, b;
};
__device__ __forceinline__ Terms chroma_terms(int u, int v) {
  Terms t;
  t.r = kCrV * v + (kFixRound - 128 * kCrV);
  t.g = kCgU * u + kCgV * v + (kFixRound - 128 * (kCgU + kCgV));
  t.b = kCbU * u + (kFixRound - 128 * kCbU);
  return t;
}

// (sum >> 16) clamped to a byte, left in byte 2 of the result.
__device__ __forceinline__ uint32_t clamp24(int sum) {
  return static_cast<uint32_t>(max(min(sum, 0xFFFFFF), 0));
}

// Byte 2 of a, b, c, d into one word.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x4462), __byte_perm(c, d, 0x4462),
                     0x5410);
}

// Four pixels of one row: luma bytes of yw (a word), chroma terms t[j >> HS],
// to 3 interleaved words or one word a planar channel.
template <int MODE, int HS>
__device__ __forceinline__ void rgb_quad(uint32_t yw, const Terms* t,
                                         uint8_t* const* out, int at) {
  uint32_t r[4], gg[4], b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // Byte j of yw into byte 2: the luma in 16.16 fixed point.
    const int yi = static_cast<int>(__byte_perm(yw, 0, 0x4044 | (j << 8)));
    const Terms& tj = t[j >> HS];
    r[j] = clamp24(yi + tj.r);
    gg[j] = clamp24(yi + tj.g);
    b[j] = clamp24(yi + tj.b);
  }
  if constexpr (MODE == kRgbPlanar) {
    store_word(out[0] + at, pack4(r[0], r[1], r[2], r[3]));
    store_word(out[1] + at, pack4(gg[0], gg[1], gg[2], gg[3]));
    store_word(out[2] + at, pack4(b[0], b[1], b[2], b[3]));
  } else {
    store_word(out[0] + 3 * at, pack4(r[0], gg[0], b[0], r[1]));
    store_word(out[0] + 3 * at + 4, pack4(gg[1], b[1], r[2], gg[2]));
    store_word(out[0] + 3 * at + 8, pack4(b[2], r[3], gg[3], b[3]));
  }
}

// One group of 8 columns of a unit of the RGB modes. yw[rr]: the luma words
// of row rr; uw, vw: the chroma bytes under them (4 with HS = 1, 8 without).
// out[rr][c] is where byte 0 of the tile's row is staged; at: first column
// of the group within the tile.
template <int MODE, int HS, int ROWS>
__device__ __forceinline__ void rgb_group(uint32_t (*yw)[2],
                                          const uint32_t* uw,
                                          const uint32_t* vw, bool chroma,
                                          int nrows, uint8_t* (*out)[3],
                                          int at) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    Terms t[4 >> HS];
#pragma unroll
    for (int k = 0; k < (4 >> HS); ++k) {
      // Chroma sample (4 >> HS) * half + k of the group.
      const int word = HS ? 0 : half;
      const int byte = HS ? 2 * half + k : k;
      const int u = chroma ? (uw[word] >> (8 * byte)) & 0xFF : 128;
      const int v = chroma ? (vw[word] >> (8 * byte)) & 0xFF : 128;
      t[k] = chroma_terms(u, v);
    }
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr)
      if (rr < nrows)
        rgb_quad<MODE, HS>(yw[rr][half], t, out[rr], at + 4 * half);
  }
}

__device__ __forceinline__ uint8_t* row_dst(const DestTab& dt, int img,
                                            int chan, int row, int64_t xbytes) {
  uint8_t* base = dt.ptr[img][chan];
  return base == nullptr
             ? nullptr
             : base + static_cast<int64_t>(row) * dt.pitch[img][chan] + xbytes;
}

// The strip of the computed channels; a unit is ROWS rows.
template <int MODE, int ROWS>
__device__ __forceinline__ void main_strip(const Geom& g, const DestTab& dt,
                                           int img, int strip, int tile,
                                           uint8_t* stage) {
  using S = Shape<MODE, ROWS>;
  const Part& part = g.part[0];
  // What the part walks: the luma ROI, or for kUv the cropped chroma plane.
  const int rows = MODE == kUv ? g.ch_h : g.rows;
  const int cols = MODE == kUv ? g.ch_w : g.cols;
  const int units = (rows + ROWS - 1) / ROWS;
  const int x0 = tile * part.tile_w;
  const int n = min(part.tile_w, cols - x0);
  if (n <= 0) return;
  bool wanted = false;
#pragma unroll
  for (int c = 0; c < S::kChannels; ++c)
    wanted |= dt.ptr[img][g.main_chan + c] != nullptr;
  if (!wanted) return;
  const int groups = (n + 7) >> 3;
  const int64_t b = static_cast<int64_t>(g.image0) + img;
  const int64_t xbytes = static_cast<int64_t>(x0) * S::kBytes;
  const bool chroma = g.u != nullptr;
  const int level = g.level & 3;
  const int u_end = min((strip + 1) * S::kStrip, units);
  for (int unit = strip * S::kStrip; unit < u_end; ++unit) {
    uint8_t* buf = stage + (unit & (S::kBuffers - 1)) * S::kBuffer;
    const int r0 = unit * ROWS;
    const int nrows = min(ROWS, rows - r0);
    // Where each row of the unit is staged.
    uint8_t* out[ROWS][3];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
      for (int c = 0; c < S::kChannels; ++c)
        out[rr][c] = buf + (rr * S::kChannels + c) * S::kSlot +
                     stage_offset(row_dst(dt, img, g.main_chan + c, r0 + rr,
                                          xbytes));
    if constexpr (MODE == kUv) {
      const int64_t off = b * g.c_img +
                          static_cast<int64_t>(g.c_top + r0) * g.c_w + g.c_left;
      const uint8_t* up = g.u + off;
      const uint8_t* vp = g.v + off;
      for (int gi = threadIdx.x; gi < groups; gi += kThreads) {
        const int x = x0 + 8 * gi;
        const int count = min(8, cols - x);
        const int lv = count == 8 ? level : 0;
        uint32_t u0, u1, v0, v1;
        load8(up, x, cols - 1, count, lv, u0, u1);
        load8(vp, x, cols - 1, count, lv, v0, v1);
        uint8_t* o = out[0][0] + 16 * gi;
        store_word(o, zip_lo(u0, v0));
        store_word(o + 4, zip_hi(u0, v0));
        store_word(o + 8, zip_lo(u1, v1));
        store_word(o + 12, zip_hi(u1, v1));
      }
    } else {
      const uint8_t* yp = g.y + b * g.y_img +
                          static_cast<int64_t>(g.top + r0) * g.y_w + g.left;
      const uint8_t* up = nullptr;
      const uint8_t* vp = nullptr;
      if (chroma) {
        // Rows (0, 1), (2, 3), ... of the ROI share a chroma row.
        const int cy = g.c_top + min(r0 >> g.vshift, g.ch_h - 1);
        const int64_t off = b * g.c_img + static_cast<int64_t>(cy) * g.c_w +
                            g.c_left;
        up = g.u + off;
        vp = g.v + off;
      }
      for (int gi = threadIdx.x; gi < groups; gi += kThreads) {
        const int x = x0 + 8 * gi;
        const int count = min(8, cols - x);
        const int lv = count == 8 ? level : 0;
        // Chroma samples under the group's valid columns.
        const int cx = x >> g.hshift;
        const int ccount = ((count - 1) >> g.hshift) + 1;
        uint32_t yw[ROWS][2];
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) {
          yw[rr][0] = yw[rr][1] = 0;
          if (rr < nrows)
            load8(yp + static_cast<int64_t>(rr) * g.y_w, x, cols - 1, count,
                  lv, yw[rr][0], yw[rr][1]);
        }
        uint32_t uw[2] = {0, 0}, vw[2] = {0, 0};
        if (chroma) {
          if (g.hshift) {
            uw[0] = load4(up, cx, g.ch_w - 1, ccount, lv);
            vw[0] = load4(vp, cx, g.ch_w - 1, ccount, lv);
          } else {
            load8(up, cx, g.ch_w - 1, ccount, lv, uw[0], uw[1]);
            load8(vp, cx, g.ch_w - 1, ccount, lv, vw[0], vw[1]);
          }
        }
        if constexpr (MODE == kYuyv) {
          // Y0 U0 Y1 V0 | Y2 U1 Y3 V1 | ...: the luma zipped with the
          // zipped chroma. hshift is 1 here.
          const uint32_t c0 = zip_lo(uw[0], vw[0]);
          const uint32_t c1 = zip_hi(uw[0], vw[0]);
          uint8_t* o = out[0][0] + 16 * gi;
          store_word(o, zip_lo(yw[0][0], c0));
          store_word(o + 4, zip_hi(yw[0][0], c0));
          store_word(o + 8, zip_lo(yw[0][1], c1));
          store_word(o + 12, zip_hi(yw[0][1], c1));
        } else if (g.hshift) {
          rgb_group<MODE, 1, ROWS>(yw, uw, vw, chroma, nrows, out, 8 * gi);
        } else {
          rgb_group<MODE, 0, ROWS>(yw, uw, vw, chroma, nrows, out, 8 * gi);
        }
      }
    }
    __syncthreads();
    // The staged rows, dealt out to the groups of kFlushThreads threads.
    for (int s = threadIdx.x / kFlushThreads; s < nrows * S::kChannels;
         s += kThreads / kFlushThreads) {
      uint8_t* dst = row_dst(dt, img, g.main_chan + s % S::kChannels,
                             r0 + s / S::kChannels, xbytes);
      if (dst != nullptr)
        flush_row(dst, buf + s * S::kSlot, n * S::kBytes,
                  threadIdx.x % kFlushThreads);
    }
    if (S::kBuffers == 1) __syncthreads();
  }
}

// The strip of a copy part: kCopyStrip rows of one tile of plane
// g.copy_plane[chan] to the rows of table channel chan, kCopyRows a unit.
template <typename S>
__device__ __forceinline__ void copy_strip(const Geom& g, const DestTab& dt,
                                           int chan, int img, int strip,
                                           int tile, uint8_t* stage) {
  const Part& part = g.part[1 + chan];
  const int plane = g.copy_plane[chan];
  const bool luma = plane == 0;
  const int rows = luma ? g.rows : g.ch_h;
  const int cols = luma ? g.cols : g.ch_w;
  const int x0 = tile * part.tile_w;
  const int n = min(part.tile_w, cols - x0);
  if (n <= 0 || dt.ptr[img][chan] == nullptr) return;
  const int groups = (n + 7) >> 3;
  const int64_t b = static_cast<int64_t>(g.image0) + img;
  const int pitch = luma ? g.y_w : g.c_w;
  const uint8_t* src = (luma ? g.y : (plane == 1 ? g.u : g.v)) +
                       b * (luma ? g.y_img : g.c_img) +
                       static_cast<int64_t>(luma ? g.top : g.c_top) * pitch +
                       (luma ? g.left : g.c_left);
  const int level = (g.level >> (2 + 2 * chan)) & 3;
  const int r_end = min((strip + 1) * kCopyStrip, rows);
  for (int r0 = strip * kCopyStrip; r0 < r_end; r0 += kCopyRows) {
    uint8_t* buf = stage + ((r0 / kCopyRows) & (S::kBuffers - 1)) * S::kBuffer;
    const int nrows = min(kCopyRows, r_end - r0);
    for (int i = threadIdx.x; i < nrows * groups; i += kThreads) {
      const int rr = i / groups;
      const int gi = i - rr * groups;
      const int x = x0 + 8 * gi;
      const int count = min(8, cols - x);
      uint32_t lo, hi;
      load8(src + static_cast<int64_t>(r0 + rr) * pitch, x, cols - 1, count,
            count == 8 ? level : 0, lo, hi);
      uint8_t* o = buf + rr * S::kCopySlot +
                   stage_offset(row_dst(dt, img, chan, r0 + rr, x0)) + 8 * gi;
      store_word(o, lo);
      store_word(o + 4, hi);
    }
    __syncthreads();
    for (int s = threadIdx.x / kFlushThreads; s < nrows;
         s += kThreads / kFlushThreads)
      flush_row(row_dst(dt, img, chan, r0 + s, x0), buf + s * S::kCopySlot, n,
                threadIdx.x % kFlushThreads);
    if (S::kBuffers == 1) __syncthreads();
  }
}

// Blocks a SM the compiler is to leave registers for. Left alone it takes
// 110 a thread and two blocks fit; what the kernel needs is loads in flight.
constexpr int min_blocks(int mode) {
  return RJT_EPI_MIN_BLOCKS ? RJT_EPI_MIN_BLOCKS : (mode == kYuyv ? 8 : 6);
}

template <int MODE, int ROWS>
__global__ void __launch_bounds__(kThreads, min_blocks(MODE))
    epilogue_kernel(Geom g, DestTab dt) {
  using S = Shape<MODE, ROWS>;
  __shared__ __align__(16) uint8_t stage[S::kBuffers * S::kBuffer];
  // Which part this block belongs to, then (image, strip, tile) within it.
  int id = blockIdx.x;
  int p = 0;
  while (id >= g.part[p].blocks) id -= g.part[p++].blocks;
  const int tile = id % g.part[p].tiles;
  id /= g.part[p].tiles;
  const int strip = id % g.part[p].strips;
  const int img = id / g.part[p].strips;
  if (p == 0) {
    if constexpr (MODE != kCopy)
      main_strip<MODE, ROWS>(g, dt, img, strip, tile, stage);
  } else {
    copy_strip<S>(g, dt, p - 1, img, strip, tile, stage);
  }
}

// Tiles of equal width (a multiple of 16, at most max_tile) over cols, and
// strips of per_strip units over units.
Part make_part(int n_images, int units, int per_strip, int cols,
               int max_tile) {
  Part p;
  p.tiles = (cols + max_tile - 1) / max_tile;
  p.tile_w = ((cols + p.tiles - 1) / p.tiles + 15) / 16 * 16;
  p.strips = (units + per_strip - 1) / per_strip;
  p.blocks = n_images * p.strips * p.tiles;
  return p;
}

template <int MODE, int ROWS>
int launch_rows(Geom g, const DestTab& dt, int n_images, cudaStream_t stream) {
  constexpr int kTile = Shape<MODE, ROWS>::kTile;
  int64_t blocks = 0;
  if (MODE != kCopy) {
    const int rows = MODE == kUv ? g.ch_h : g.rows;
    g.part[0] = make_part(n_images, (rows + ROWS - 1) / ROWS,
                          Shape<MODE, ROWS>::kStrip,
                          MODE == kUv ? g.ch_w : g.cols, kTile);
    blocks += g.part[0].blocks;
  }
  for (int c = 0; c < kMaxChannels; ++c) {
    if (g.copy_plane[c] < 0) continue;
    const bool luma = g.copy_plane[c] == 0;
    g.part[1 + c] = make_part(n_images, luma ? g.rows : g.ch_h, kCopyStrip,
                              luma ? g.cols : g.ch_w, kTile);
    blocks += g.part[1 + c].blocks;
  }
  if (blocks < 1 || blocks > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), 1, 1);
  epilogue_kernel<MODE, ROWS><<<grid, kThreads, 0, stream>>>(g, dt);
  return static_cast<int>(cudaGetLastError());
}

// The RGB modes take a row pair a unit under vertical subsampling.
template <int MODE>
int launch(const Geom& g, const DestTab& dt, int n_images,
           cudaStream_t stream) {
  if constexpr ((MODE == kRgb || MODE == kRgbPlanar) && kPair) {
    if (g.vshift) return launch_rows<MODE, 2>(g, dt, n_images, stream);
  }
  return launch_rows<MODE, 1>(g, dt, n_images, stream);
}

#endif  // RJT_EPI_BASELINE

bool multiple_of(int unit, const void* p, int64_t img, int pitch, int first) {
  return ((reinterpret_cast<uintptr_t>(p) | static_cast<uint64_t>(img) |
           static_cast<uint64_t>(pitch) | static_cast<uint64_t>(first)) &
          static_cast<uint64_t>(unit - 1)) == 0;
}

// How full groups of a plane can be loaded. 2: every group starts on a
// multiple of unit bytes (the plane's address, image stride and row width
// and the ROI's first column are multiples of it). 1: the plane is made of
// whole aligned words, so the words that hold a group can be loaded and
// shifted. 0: bytes.
int plane_level(int unit, const void* p, int64_t img, int pitch, int first) {
#if RJT_EPI_BASELINE
  return 0;
#else
  const int level = multiple_of(unit, p, img, pitch, first)
                        ? 2
                        : (multiple_of(4, p, img, 0, 0) ? 1 : 0);
  return level < kMaxLevel ? level : kMaxLevel;
#endif
}

}  // namespace

// Images one launch takes: the wrapper splits a wider batch.
extern "C" int rjt_epilogue_table_images() { return kMaxImages; }

// How each part of a launch may load its source (the `levels` rjt_epilogue
// takes, 2 bits a part: bits 0-1 the computed channels, bits 2 + 2c the copy
// into table channel c; see plane_level). A group of 8 samples is 8 bytes,
// 4 for the chroma of a horizontally subsampled RGB or YUYV render.
// copy_planes: host int32 [3], see rjt_epilogue.
extern "C" int rjt_epilogue_load_levels(int mode, const void* y, const void* u,
                                        const void* v, int64_t y_img,
                                        int64_t c_img, int y_w, int c_w,
                                        int left, int c_left, int hshift,
                                        const void* copy_planes) {
  const int luma = plane_level(8, y, y_img, y_w, left);
  const bool has_chroma = u != nullptr && v != nullptr;
  int levels = 0;
  if (mode != kCopy) {
    const int unit = mode != kUv && hshift ? 4 : 8;
    levels = mode == kUv ? 2 : luma;
    if (has_chroma)
      levels = min(levels, min(plane_level(unit, u, c_img, c_w, c_left),
                               plane_level(unit, v, c_img, c_w, c_left)));
  }
  const int32_t* planes = static_cast<const int32_t*>(copy_planes);
  for (int c = 0; planes != nullptr && c < kMaxChannels; ++c) {
    const int pl = planes[c];
    if (pl == 0)
      levels |= luma << (2 + 2 * c);
    else if (pl == 1 || pl == 2)
      levels |= plane_level(8, pl == 1 ? u : v, c_img, c_w, c_left)
                << (2 + 2 * c);
  }
  return levels;
}

// One launch over images [image0, image0 + n_images) of the batch.
// mode: 0 interleaved RGB, 1 planar RGB, 2 packed YUYV, 3 interleaved UV,
// 4 copies only. y/u/v: device planes (u, v null for 4:0:0, RGB modes and
// copies of y only). rows/cols: the luma ROI; ch_h/ch_w: the cropped chroma
// planes (what mode 3 walks). dst_ptrs and dst_pitches: host int64
// [n_images][3], one entry per channel of the output format; a zero pointer
// skips the channel for that image. The computed channels are main_chan
// (and the next two for planar RGB). copy_planes: host int32 [3], for each
// table channel the plane it is a crop of (0 y, 1 u, 2 v) when this launch
// is to copy it, else -1; null for none. levels: how each part loads, none
// above what rjt_epilogue_load_levels allows. Returns cudaGetLastError().
extern "C" int rjt_epilogue(int mode, const void* y, const void* u,
                            const void* v, int64_t y_img, int64_t c_img,
                            int y_w, int c_w, int top, int left, int c_top,
                            int c_left, int rows, int cols, int ch_w, int ch_h,
                            int hshift, int vshift, int image0, int n_images,
                            int main_chan, int levels, const void* copy_planes,
                            const void* dst_ptrs, const void* dst_pitches,
                            void* stream) {
  const bool chroma = u != nullptr && v != nullptr;
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (mode < kRgb || mode > kCopy || y == nullptr || n_images < 1 ||
      n_images > kMaxImages || rows < 1 || cols < 1 || hshift < 0 ||
      hshift > 1 || vshift < 0 || vshift > 1 ||
      (u == nullptr) != (v == nullptr) ||
      (chroma && mode != kCopy && (ch_w < 1 || ch_h < 1)) ||
      (!chroma && (mode == kYuyv || mode == kUv)) ||
      (mode == kYuyv && (hshift != 1 || vshift != 0 || cols % 2 != 0)))
    return invalid;
  const int n_main = mode == kCopy ? 0 : (mode == kRgbPlanar ? 3 : 1);
  if (main_chan < 0 || main_chan + n_main > kMaxChannels) return invalid;
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
  g.main_chan = main_chan;
  g.level = levels;
  const int32_t* planes = static_cast<const int32_t*>(copy_planes);
  int n_copy = 0;
  for (int c = 0; c < kMaxChannels; ++c) {
    const int pl = planes == nullptr ? -1 : planes[c];
    g.copy_plane[c] = pl < 0 ? -1 : pl;
    if (pl < 0) continue;
    ++n_copy;
    // A copy of a plane this launch has, into a channel it does not compute.
    if (RJT_EPI_BASELINE || pl > 2 ||
        (pl > 0 && (!chroma || ch_w < 1 || ch_h < 1)) ||
        (c >= main_chan && c < main_chan + n_main))
      return invalid;
  }
  if (mode == kCopy && n_copy == 0) return invalid;
  const int allowed = rjt_epilogue_load_levels(
      mode, y, u, v, y_img, c_img, y_w, c_w, left, c_left, hshift, copy_planes);
  if (levels < 0 || levels >> (2 + 2 * kMaxChannels)) return invalid;
  for (int p = 0; p <= kMaxChannels; ++p)
    if (((levels >> (2 * p)) & 3) > ((allowed >> (2 * p)) & 3)) return invalid;
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
    case kRgb: return launch<kRgb>(g, dt, n_images, s);
    case kRgbPlanar: return launch<kRgbPlanar>(g, dt, n_images, s);
    case kYuyv: return launch<kYuyv>(g, dt, n_images, s);
    case kUv: return launch<kUv>(g, dt, n_images, s);
#if !RJT_EPI_BASELINE
    case kCopy: return launch<kCopy>(g, dt, n_images, s);
#endif
    default: return invalid;
  }
}
